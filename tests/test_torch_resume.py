"""Checkpoint and resume of masked-LM training: ``MaskedPLM.state``
through ``CheckpointManager`` into a fresh trainer, against the run that
was never interrupted; and a witness that JAX's ``MaskedPLM`` cannot
resume under ``offload_optimizer=True`` (ROADMAP.md Queue 3, item 25)
while the port's does.

The model is ESM2 with 2 layers of width 64 and 4 heads, fp32, its
weights from seed 0; the batches are ``tests/test_torch_cp_train.py``'s
packed 1,024-token masked-LM batches. Each case trains 4 steps without a
break, then again from the same weights with a checkpoint after 2 or 3
steps restored into a fresh trainer on a fresh model, which takes the
rest. The sharded trainer's round trip runs in a gloo world of
``tests/test_torch_sharded_lora.py``.

Gates (each with its reason):
* the resumed run: every loss after the cut and every param at the end
  bit-equal to the run without a break (the same arithmetic on the same
  state: Adam's moments and step, ``adam8bit``'s codes and scales, the
  running mean of an open ``grad_accum`` cycle, the offloaded fp32
  masters, the LoRA dropout's step-folded keys).
* the witness: JAX's offloaded trainer, its state copied into a fresh
  one after 3 steps at learning rate 1e-2, differs from the trainer it
  was copied from after one more step by more than the learning rate in
  the token embedding (it restarts from its own masters; the same copy
  without offload differs by 0.0), while the loss of that step is the
  same (the working params were copied); the port's offloaded trainer
  resumed through ``CheckpointManager`` differs by 0.0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from esme_tpu.models import config as jconfig
from esme_tpu.models import esm as jesm
from esme_tpu.train import MaskedPLM as JMaskedPLM

from esme_tpu_torch import ESM2
from esme_tpu_torch.models.config import esm2_config
from esme_tpu_torch.train import CheckpointManager, MaskedPLM, adam8bit

from test_torch_cp_train import _batch

LR = 1e-2
STEPS = 4


def _model(lora=False):
    model = ESM2(config=esm2_config(2, 64, 4, dtype='float32'), rng=0,
                 device='cpu')
    if lora:
        model.add_lora(rank=4, alpha=8, dropout_p=0.1, rng=1)
        gen = torch.Generator().manual_seed(2)
        for p in model.params['layers']['attn'].values():
            for ad in p.get('lora', {}).values():
                ad['b'].copy_(torch.randn(ad['b'].shape, generator=gen) * 0.1)
    return model


CASES = {
    'adam': (dict(learning_rate=LR), False, 2),
    'adamw_accum': (dict(learning_rate=LR, weight_decay=0.05, grad_accum=2),
                    False, 3),
    'adam8bit': (dict(optimizer=adam8bit(LR)), False, 2),
    'offload': (dict(learning_rate=LR, offload_optimizer=True, grad_accum=2),
                False, 3),
    'lora': (dict(learning_rate=LR, lora_only=True), True, 2),
}


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield '.'.join(path + (k,)), v


def _resumed(kw, lora, cut, batches, directory):
    """The losses of steps ``cut``.. and the params of a run cut after
    ``cut`` steps, saved, and restored into a fresh trainer."""
    first = MaskedPLM(_model(lora), **kw)
    for b in batches[:cut]:
        first.training_step(b)
    mgr = CheckpointManager(str(directory), monitor=None)
    mgr.save(first.step, first.state)
    assert mgr.all_steps() == [cut]
    model = _model(lora)
    plm = MaskedPLM(model, **kw)
    plm.state = mgr.restore(plm.state)
    assert plm.step == cut
    return [plm.training_step(b) for b in batches[cut:]], model.params


@pytest.mark.parametrize('case', list(CASES))
def test_masked_plm_resumes_bit_for_bit(case, tmp_path):
    """A run cut after ``cut`` steps (for ``grad_accum=2``, inside an
    accumulation cycle), saved with ``CheckpointManager`` and restored into
    a fresh ``MaskedPLM`` gives the losses and the params of the run
    without a break, bit for bit."""
    kw, lora, cut = CASES[case]
    batches = [_batch(70 + i, ESM2.alphabet) for i in range(STEPS)]
    model = _model(lora)
    plm = MaskedPLM(model, **kw)
    losses = [plm.training_step(b) for b in batches]
    got, params = _resumed(kw, lora, cut, batches, tmp_path / 'ckpt')
    assert got == losses[cut:]
    for name, ref in _leaves(model.params):
        assert torch.equal(dict(_leaves(params))[name], ref), name
    start = dict(_leaves(_model(lora).params))
    assert any(not torch.equal(start[name], ref)
               for name, ref in _leaves(model.params))


def _jax_copy_differs(offload):
    """JAX's ``MaskedPLM`` (ESM2, 2 layers of width 64, fp32, einsum
    attention) 3 steps at ``LR``, its state copied into a fresh trainer,
    one more step on each: the largest difference of their token
    embeddings, and both losses of that step."""
    cfg = jconfig.esm2_config(num_layers=2, embed_dim=64, attention_heads=4,
                              dtype='float32')
    batches = [_batch(80 + i, ESM2.alphabet) for i in range(4)]

    def trainer():
        return JMaskedPLM(jesm.ESM2(config=cfg, rng=0), learning_rate=LR,
                          attn_impl='reference', offload_optimizer=offload)
    a = trainer()
    for b in batches[:3]:
        a.training_step(b)
    fresh = trainer()
    fresh.state = jax.tree.map(jnp.copy, a.state)
    la, lb = a.training_step(batches[3]), fresh.training_step(batches[3])
    diff = np.abs(np.asarray(a.state.params['embed_tokens'])
                  - np.asarray(fresh.state.params['embed_tokens'])).max()
    return float(diff), la, lb


def test_jax_offloaded_resume_differs_the_port_does_not(tmp_path):
    """JAX's offloaded state holds no fp32 masters, so a copy of it
    resumes from the fresh trainer's own masters: its next update differs
    by more than the learning rate, where a copy without offload differs
    by nothing; the port's offloaded ``MaskedPLM.state`` holds them, and
    the same protocol through ``CheckpointManager`` differs by 0.0."""
    off, la, lb = _jax_copy_differs(True)
    on, _, _ = _jax_copy_differs(False)
    assert off > LR and la == lb
    assert on == 0.0
    kw = dict(learning_rate=LR, offload_optimizer=True)
    batches = [_batch(80 + i, ESM2.alphabet) for i in range(4)]
    model = _model()
    plm = MaskedPLM(model, **kw)
    losses = [plm.training_step(b) for b in batches]
    got, params = _resumed(kw, False, 3, batches, tmp_path / 'ckpt')
    assert got == losses[3:]
    assert float((params['embed_tokens']
                  - model.params['embed_tokens']).abs().max()) == 0.0


def test_state_refuses_another_model(tmp_path):
    """A saved state restores only into a trainer whose params have its
    leaves' shapes and dtypes; a state inside a ``grad_accum`` cycle only
    with its running mean."""
    plm = MaskedPLM(_model(), learning_rate=LR, grad_accum=2)
    plm.training_step(_batch(90, ESM2.alphabet))
    state = plm.state
    assert state.step == 1 and state.accum is not None
    other = MaskedPLM(ESM2(config=esm2_config(2, 32, 4, dtype='float32'),
                           rng=0, device='cpu'), learning_rate=LR)
    with pytest.raises(ValueError, match='saved leaf'):
        other.state = state
    fresh = MaskedPLM(_model(), learning_rate=LR, grad_accum=2)
    with pytest.raises(ValueError, match='accumulated'):
        fresh.state = state._replace(accum=None)
