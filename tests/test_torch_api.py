"""The port's public call signatures against the JAX package's, and the
options of the JAX signatures.

* Each public entry takes JAX's parameters, by name, in JAX's order; the
  port may add its own after them (``device``). Checked on
  ``inspect.signature``, exactly.
* ``quantization`` ('8bit', '4bit'), by keyword and in JAX's positional
  slot, loads the quantized params JAX's ``from_pretrained`` gives, bit
  for bit (``tests/test_torch_quant.py`` holds the rest of the
  quantization). ``lora_names`` (ported with the LoRA adapters) selects
  adapters: on a model without any it changes nothing, as in JAX
  (``tests/test_torch_lora.py`` holds the adapters to JAX's).
* ``from_pretrained(path, checkpointing=True)`` loads the checkpoint bit
  for bit with the flag set.
* ``MaskedPLM(remat='attn')`` without checkpointing is ``remat='full'``
  (JAX ignores ``remat`` there): the same loss and gradients, bit for
  bit; with checkpointing on it runs (the memory slice,
  ``tests/test_torch_memory.py`` holds it to ``'full'`` and to JAX).
"""

import inspect

import jax
import numpy as np
import pytest
import torch

from esme_tpu.models import esm as jesm
from esme_tpu.models.config import esm2_config as jesm2_config

from esme_tpu_torch import (ESM, ESM1b, ESM1v, ESM2, ESMC,
                            MaskedFastaTokenDataset)
from esme_tpu_torch.models import esm as tesm
from esme_tpu_torch.models import modules as tmod
from esme_tpu_torch.models.config import esm2_config
from esme_tpu_torch.models.io import params_from_jax
from esme_tpu_torch.train import MaskedPLM

ENTRIES = {
    'ESM.from_pretrained': (jesm.ESM.from_pretrained, ESM.from_pretrained),
    'ESM2.from_pretrained': (jesm.ESM2.from_pretrained,
                             ESM2.from_pretrained),
    '_ESMBase.from_pretrained': (jesm._ESMBase.from_pretrained,
                                 tesm._ESMBase.from_pretrained),
    'forward': (jesm._ESMBase.forward, tesm._ESMBase.forward),
    'forward_representation': (jesm._ESMBase.forward_representation,
                                tesm._ESMBase.forward_representation),
    'predict_log_prob': (jesm._ESMBase.predict_log_prob,
                         tesm._ESMBase.predict_log_prob),
    'predict_prob': (jesm._ESMBase.predict_prob,
                     tesm._ESMBase.predict_prob),
    'ESM2.__init__': (jesm.ESM2.__init__, ESM2.__init__),
    'ESM1b.__init__': (jesm.ESM1b.__init__, ESM1b.__init__),
    'ESM1v.__init__': (jesm.ESM1v.__init__, ESM1v.__init__),
    'ESMC.__init__': (jesm.ESMC.__init__, ESMC.__init__),
    'ESM1b.from_pretrained': (jesm.ESM1b.from_pretrained,
                              ESM1b.from_pretrained),
    'ESM1v.from_pretrained': (jesm.ESM1v.from_pretrained,
                              ESM1v.from_pretrained),
    'ESMC.from_pretrained': (jesm.ESMC.from_pretrained,
                             ESMC.from_pretrained),
}


def _names(fn):
    return list(inspect.signature(fn).parameters)


@pytest.mark.parametrize('entry', sorted(ENTRIES))
def test_public_signature_starts_with_jax_parameters(entry):
    jfn, tfn = ENTRIES[entry]
    jnames, tnames = _names(jfn), _names(tfn)
    assert tnames[:len(jnames)] == jnames, (jnames, tnames)
    assert set(tnames[len(jnames):]) <= {'device'}, tnames


def _model(checkpointing=False):
    cfg = jesm2_config(2, 64, 4, dtype='float32')
    jm = jesm.ESM2(config=cfg, rng=0)
    tcfg = esm2_config(2, 64, 4, dtype='float32')
    return ESM2(config=tcfg, params=params_from_jax(
        jax.tree.map(np.asarray, jm.params), tcfg), device='cpu',
        checkpointing=checkpointing)


def test_quantization_and_lora_names_options(tmp_path):
    path = str(tmp_path / 'esm2_t.safetensors')
    model = _model().save_pretrained(path)
    for mode in ('8bit', '4bit'):
        ref = jesm.ESM.from_pretrained(path, quantization=mode,
                                       dtype='float32').params
        for load in (ESM.from_pretrained, ESM2.from_pretrained):
            for got in (load(path, quantization=mode, dtype='float32',
                             device='cpu'),
                        load(path, mode, dtype='float32', device='cpu')):
                assert type(got) is ESM2
                names = dict(_flat(got.params))
                assert sorted(names) == sorted(
                    n for n, _ in _flat(ref))
                for name, r in _flat(ref):
                    r = np.asarray(r)
                    a = names[name].numpy()
                    assert a.dtype == r.dtype and np.array_equal(
                        a.view(np.uint8), r.view(np.uint8)), name
    tok = np.array([0, 5, 6, 7, 2], dtype=np.int32)
    pad_args = (np.array([0, 5], np.int32), 5)
    # lora_names on a model without adapters: the call runs, and gives
    # the output without it, bit for bit
    for fn in (model.forward, model.forward_representation,
               model.predict_log_prob, model.predict_prob):
        assert torch.equal(fn(tok, pad_args=pad_args, lora_names=['a']),
                           fn(tok, pad_args=pad_args))
    # None is the default: the same call runs
    assert model.predict_prob(tok, pad_args=pad_args,
                              lora_names=None).shape == (5, 33)


def test_from_pretrained_passes_checkpointing(tmp_path):
    path = str(tmp_path / 'esm2_t.safetensors')
    model = _model().save_pretrained(path)
    for load in (ESM.from_pretrained, ESM2.from_pretrained):
        got = load(path, checkpointing=True, dtype='float32', device='cpu')
        assert type(got) is ESM2 and got.checkpointing is True
        for (name, a), (_, b) in zip(sorted(_flat(got.params)),
                                     sorted(_flat(model.params))):
            assert torch.equal(a, b), name
        assert load(path, device='cpu').checkpointing is False
    # ESM2's fourth positional slot is checkpointing, as in JAX
    assert ESM2(2, 64, 4, True, 'float32', device='cpu').checkpointing


def _flat(tree, prefix=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f'{prefix}{k}.')
        else:
            yield f'{prefix}{k}', v


@pytest.fixture(scope='module')
def batch(fasta_path):
    return MaskedFastaTokenDataset(fasta_path, token_per_batch=1024,
                                   shuffle=False, random_state=0)[0]


def test_remat_attn_without_checkpointing_is_full(batch):
    model = _model()
    loss_f, grads_f = MaskedPLM(model, remat='full')._grad_step(batch)
    loss_a, grads_a = MaskedPLM(model, remat='attn')._grad_step(batch)
    assert torch.equal(loss_f, loss_a)
    pairs = list(zip(sorted(_flat(grads_a)), sorted(_flat(grads_f))))
    assert len(pairs) == len(list(_flat(model.params)))
    for (name, a), (_, b) in pairs:
        assert torch.equal(a, b), name
    # with checkpointing on, 'attn' runs and gives 'full''s loss
    ckpt = _model(checkpointing=True)
    loss_c, _ = MaskedPLM(ckpt, remat='attn')._grad_step(batch)
    assert torch.equal(loss_c, loss_f)
    # switched on after construction too
    plm = MaskedPLM(model, remat='attn')
    model.checkpointing = True
    loss_s, grads_s = plm._grad_step(batch)
    assert torch.equal(loss_s, loss_f)
    for (name, a), (_, b) in zip(sorted(_flat(grads_s)),
                                 sorted(_flat(grads_f))):
        assert torch.equal(a, b), name
    with pytest.raises(ValueError, match='unknown remat'):
        tmod.check_remat('some')
