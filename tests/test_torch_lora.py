"""LoRA in the port against the JAX package: the adapter branch of
``linear``, adapters on every family's forward and their gradients,
``trainable_mask``, adapter dropout, the LoRA files in both directions,
and the task artefacts checked into the repo (``task_gb1/``, ``task_aav/``,
``task_meltome/``, ``task_tf/``; GB1's also over an int8 trunk).

Models are built tiny (2 layers, width 64, 4 heads) from JAX's init, with
adapters added by JAX and every ``b`` set non-zero (with ``b = 0``, ``a``'s
gradient is exactly 0 and checks nothing: ROADMAP.md Queue 3, rule 15),
then carried over with ``params_from_jax``. The JAX side runs its einsum
attention (``attn_impl='auto'`` on the CPU); the port runs the kernels'
plain versions.

Gates (each with its reason):
* ``linear`` with adapters: fp32 1e-5 of the output's scale (the same
  fp32 products summed in another order; measured 3.4e-7); bf16 one bf16
  ulp of the output's scale, 2^-8·max|ref| (each product is rounded to
  bf16 on both sides after fp32 sums in another order, which can flip a
  rounding; measured 0).
* every family's log-probabilities with adapters: fp32 5e-5 absolute
  (``test_torch_families.py``'s gate); the adapters' gradients of the
  masked-LM loss: loss 1e-5 relative, per leaf max|Δ| ≤ 1e-4·max|g|
  (``test_torch_train.py``'s fp32 gradient gate).
* ``trainable_mask``, the LoRA files and their metadata: exact, bit for
  bit.
* dropout (the mask cannot match JAX's random bits): the keep rate within
  5 standard deviations of 1 - p over 2^18 draws, kept values scaled by
  exactly 1/(1 - p); none in evaluation; gradients with and without
  checkpointing bit-equal (the recompute draws the forward's masks).
* the checked-in ESM2-8M artefacts (``benchmarks/tasks.py`` made them from
  ``config_for('esm2_8m')`` at seed 0, bf16): the full 6-layer model at
  width 320 with ``task_<task>/lora.safetensors`` and ``head.safetensors``
  (GB1 in fp32 and bf16, the other three in bf16; GB1 over the int8
  trunk in fp32, its adapters bf16 on both sides).
  fp32 (the same bf16 weights in fp32 on both sides): representations
  5e-5 absolute, predictions 1e-5 of their scale (measured 3.2e-6 and
  5.1e-7); bf16, as the task ran: representations within 2^-5 of their
  largest and each token's cosine at least 0.999, the head's predictions
  within 2^-5 of their scale (bf16 rounding at other points through 6
  layers and the pooled head; measured 2^-6 and 0.0056).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import numpy as stnp

from esme_tpu import loss as jloss
from esme_tpu import lora as jlora
from esme_tpu.data import LabeledDataset as JLabeledDataset
from esme_tpu.models import config as jconfig
from esme_tpu.models import esm as jesm
from esme_tpu.ops import linear as jlinear
from esme_tpu.train import ClassificationTrainer as JClassificationTrainer
from esme_tpu.train import RegressionTrainer as JRegressionTrainer

from esme_tpu_torch import ESM2, LabeledDataset, tokenize_unpad
from esme_tpu_torch import lora as tlora
from esme_tpu_torch.models import config as tconfig
from esme_tpu_torch.models import io as tio
from esme_tpu_torch.ops import linear as tlinear
from esme_tpu_torch.train import (ClassificationTrainer, MaskedPLM,
                                  RegressionTrainer)

from test_torch_families import FAMILIES, JCLASSES, _batch, _configs, \
    _jax_params, _leaves, _seqs

TCLASSES = {'esm2': ESM2, **FAMILIES}
JMODELS = {'esm2': jesm.ESM2, **JCLASSES}

FP32_ATOL = 5e-5


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.array(jnp.asarray(x).astype(jnp.float32))


def _lift_b(params, seed):
    """``params`` with every adapter's ``b`` drawn from 0.1·N(0, 1)."""
    rng = np.random.default_rng(seed)
    attn = dict(params['layers']['attn'])
    for t, p in sorted(attn.items()):
        if 'lora' not in p:
            continue
        lora = {}
        for name, ad in sorted(p['lora'].items()):
            lora[name] = {**ad, 'b': jnp.asarray(
                rng.standard_normal(ad['b'].shape) * 0.1, ad['b'].dtype)}
        attn[t] = {**p, 'lora': lora}
    return {**params, 'layers': {**params['layers'], 'attn': attn}}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_lora_linear_matches_jax(dtype):
    rng = np.random.default_rng(0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    D, O, r = 96, 80, 8

    def arr(shape, sc):
        return jnp.asarray(rng.standard_normal(shape) * sc, jdt)
    jp = {'kernel': arr((D, O), D ** -0.5), 'bias': arr((O,), 0.1),
          'lora': {n: {'a': arr((D, r), D ** -0.5), 'b': arr((r, O), 0.2),
                       'scale': jnp.asarray(s, jnp.float32)}
                   for n, s in (('zeta', 2.0), ('alpha', 0.5),
                                ('mid', 1.0))}}
    tp = jax.tree.map(lambda a: tio.params_from_jax({'x': np.asarray(a)},
                                                    None)['x'], jp)
    x = arr((130, D), 1.0)
    tx = tio.params_from_jax({'x': np.asarray(x)}, None)['x']
    outs = []
    for names in (None, ('zeta',), ('mid', 'alpha'), ()):
        ref = _np(jlinear.linear(x, jp, names))
        got = tlinear.linear(tx, tp, names)
        assert got.dtype == tdt
        tol = 1e-5 if dtype == "float32" else 2.0 ** -8
        assert np.abs(_np(got) - ref).max() <= tol * np.abs(ref).max(), names
        outs.append(ref)
    # the adapters change the output; none selected is the dense layer
    assert np.abs(outs[0] - outs[3]).max() > 0.1
    np.testing.assert_array_equal(
        _np(tlinear.linear(tx, tp, ())),
        _np(tlinear.linear(tx, {k: v for k, v in tp.items()
                                if k != 'lora'})))


@functools.lru_cache(maxsize=None)
def _jax_lora_model(family):
    """JAX's tiny fp32 model of ``family`` (seed 3, every leaf lifted off
    its init as ``test_torch_families.py`` does), with two adapters on all
    four projections and every ``b`` non-zero."""
    jcfg, _ = _configs(family, 'float32')
    jm = JMODELS[family](config=jcfg,
                          params=_jax_params(family, 'float32', 'all'))
    jm.add_lora(rank=4, alpha=8, layers=('query', 'key', 'value', 'output'),
                adapter_names=['p', 'q'], rng=5)
    jm.params = _lift_b(jm.params, 6)
    return jm


def _port_of(jm, family):
    _, tcfg = _configs(family, jm.config.dtype)
    tm = TCLASSES[family](config=tcfg, params=tio.params_from_jax(
        jax.tree.map(np.asarray, jm.params), tcfg), device='cpu')
    tm.lora_kwargs = jm.lora_kwargs and dict(jm.lora_kwargs)
    return tm


ALL_FAMILIES = ['esm2', 'esmc', 'esm1b', 'esm1v']


@pytest.mark.parametrize('family', ALL_FAMILIES)
def test_add_lora_forward_and_grads_match_jax(family):
    """Log-probabilities with both adapters, with one (``lora_names``),
    and the gradient of every adapter leaf of the masked-LM loss."""
    jm = _jax_lora_model(family)
    tm = _port_of(jm, family)
    tok, _, cu, ml = tokenize_unpad(_seqs([90, 7, 150, 40], 2),
                                    alphabet=tm.alphabet)
    for names in (None, ['q']):
        got = tm.predict_log_prob(tok, pad_args=(cu, ml), lora_names=names)
        ref = jm.predict_log_prob(tok, pad_args=(cu, ml), lora_names=names)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=FP32_ATOL, rtol=0)
    base = tm.predict_log_prob(tok, pad_args=(cu, ml), lora_names=[])
    assert (got - base).abs().max() > 1e-3        # the adapters act

    batch = _batch(300, 512, seed=3, alphabet=tm.alphabet)
    seg, pos = jesm.packed_meta(jnp.asarray(batch.cu_lens), 512)

    def loss(p):
        logits = jesm.forward_flat(p, jm.config,
                                   jnp.asarray(batch.masked_tokens),
                                   seg, pos)
        return jloss.cross_entropy(logits, jnp.asarray(batch.tokens),
                                   jnp.asarray(batch.mask))
    jval, jgrads = jax.value_and_grad(loss)(jm.params)
    tloss, grads = MaskedPLM(tm, lora_only=True)._grad_step(batch)
    np.testing.assert_allclose(tloss.item(), float(jval), rtol=1e-5)
    got = dict(_leaves(grads))
    want = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    n = 0
    for name, r in want.items():
        g = got[name]
        if '.lora.' not in name or name.endswith('.scale'):
            assert g is None, name          # frozen: no gradient
            continue
        err = np.abs(g.numpy() - r).max()
        assert err <= 1e-4 * np.abs(r).max(), (name, err, np.abs(r).max())
        assert np.abs(r).max() > 0, name
        n += 1
    assert n == 4 * 2 * 2                   # q, k, v, out; p, q; a, b


@pytest.mark.parametrize('adapters', [False, True], ids=['dense', 'lora'])
def test_trainable_mask_matches_jax(adapters):
    jm = _jax_lora_model('esm2') if adapters else jesm.ESM2(
        config=jconfig.esm2_config(2, 64, 4, dtype='float32'), rng=0)
    tm = _port_of(jm, 'esm2')
    for lora_only in (None, True, False, ['q'], ('p', 'q')):
        for lmhead in (False, True):
            got = jax.tree.leaves(tm.trainable_filter(lora_only, lmhead))
            ref = jax.tree.leaves(jm.trainable_filter(lora_only, lmhead))
            assert got == [bool(r) for r in ref], (lora_only, lmhead)
    full = jax.tree.leaves(tm.trainable_filter())
    assert all(full) != adapters


def test_dropout_keep_rate_and_scale():
    x = torch.ones(2 ** 18)
    for rate in (0.1, 0.5):
        y = tlinear.dropout(x, rate, key=tlinear.fold_in(7, 1))
        kept = y != 0
        n, p = x.numel(), 1.0 - rate
        assert abs(kept.float().mean().item() - p) \
            <= 5 * (p * (1 - p) / n) ** 0.5
        assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / p))
        # the key fixes the mask; another key draws another
        assert torch.equal(y, tlinear.dropout(x, rate, tlinear.fold_in(7, 1)))
        assert not torch.equal(y, tlinear.dropout(x, rate,
                                                  tlinear.fold_in(7, 2)))
    assert len({tlinear.fold_in(k, d) for k in range(50)
                for d in range(50)}) == 2500


def _dropout_model(checkpointing):
    jm = _jax_lora_model('esm2')
    tm = _port_of(jm, 'esm2')
    tm.checkpointing = checkpointing
    tm.lora_kwargs['dropout_p'] = 0.3
    return tm


def test_dropout_is_training_only_and_recomputed_alike():
    batch = _batch(300, 512, seed=4, alphabet=ESM2.alphabet)
    grads = {}
    for ckpt in (False, True):
        plm = MaskedPLM(_dropout_model(ckpt))
        assert plm._lora_dropout == 0.3
        grads[ckpt] = plm._grad_step(batch)
    assert torch.equal(grads[False][0], grads[True][0])
    for (name, a), (_, b) in zip(_leaves(grads[False][1]),
                                 _leaves(grads[True][1])):
        assert (a is None and b is None) or torch.equal(a, b), name
    # the masks act, and the step count draws new ones
    plm = MaskedPLM(_port_of(_jax_lora_model('esm2'), 'esm2'))
    assert plm._lora_dropout == 0.0
    assert plm._grad_step(batch)[0] != grads[False][0]
    plm = MaskedPLM(_dropout_model(False))
    plm.step = 1
    assert plm._grad_step(batch)[0] != grads[False][0]
    # evaluation draws none: the forward equals the model's without it
    tok, _, cu, ml = tokenize_unpad(_seqs([50, 80], 5))
    a = _dropout_model(False).forward(tok, pad_args=(cu, ml))
    b = _port_of(_jax_lora_model('esm2'), 'esm2').forward(tok,
                                                          pad_args=(cu, ml))
    assert torch.equal(a, b)
    assert plm.validation_step(batch) == plm.validation_step(batch)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_lora_files_load_across_packages(dtype, tmp_path):
    """A file the port writes loads in JAX, and one JAX writes loads in
    the port: every adapter leaf bit-equal, the metadata equal."""
    jcfg = jconfig.esm2_config(2, 64, 4, dtype=dtype)
    jm = jesm.ESM2(config=jcfg, rng=0)
    jm.add_lora(rank=4, alpha=8, adapter_names=['u', 'w'], dropout_p=0.1)
    jm.params = _lift_b(jm.params, 1)
    tcfg = tconfig.esm2_config(2, 64, 4, dtype=dtype)
    tm = ESM2(config=tcfg, rng=1, device='cpu')
    tm.add_lora(rank=4, alpha=8, adapter_names=['u', 'w'], dropout_p=0.1,
                rng=2)
    for ad in (ad for p in tm.params['layers']['attn'].values()
               for ad in p.get('lora', {}).values()):
        ad['b'] = torch.randn(ad['b'].shape, generator=torch.Generator()
                              .manual_seed(3)).to(ad['b'].dtype)
    tm.save_lora(str(tmp_path / 'port.safetensors'))
    jm.save_lora(str(tmp_path / 'jax.safetensors'))
    tmeta = tio.read_metadata(str(tmp_path / 'port.safetensors'))
    assert tmeta == tio.read_metadata(str(tmp_path / 'jax.safetensors')) \
        == {'rank': '4', 'alpha': '8', 'dropout_p': '0.1',
            'layers': 'output,query,value', 'names': 'u,w', 'format': 'pt'}

    jm2 = jesm.ESM2(config=jcfg, rng=0).load_lora(
        str(tmp_path / 'port.safetensors'))
    tm2 = ESM2(config=tcfg, rng=1, device='cpu').load_lora(
        str(tmp_path / 'jax.safetensors'))
    for src, dst in ((tm, jm2), (jm, tm2)):
        assert src.lora_kwargs == dst.lora_kwargs
        s, d = src.lora_state_dict(), dst.lora_state_dict()
        assert sorted(s) == sorted(d) and len(s) == 2 * 2 * 3 * 2
        for k in s:
            a, b = np.asarray(_np(s[k])), np.asarray(_np(d[k]))
            assert a.dtype == b.dtype and np.array_equal(
                a.view(np.uint32), b.view(np.uint32)), k
        for t in ('q', 'v', 'out'):
            for n in ('u', 'w'):
                for leaf in ('a', 'b'):
                    x = dst.params['layers']['attn'][t]['lora'][n][leaf]
                    assert str(x.dtype).endswith(dtype), (t, n, leaf)
    # one adapter by name; a file without adapters is refused
    tm.save_lora(str(tmp_path / 'w.safetensors'), adapter_names=['w'])
    got = ESM2(config=tcfg, device='cpu').load_lora(
        str(tmp_path / 'w.safetensors'))
    assert got.lora_kwargs['names'] == ['w']
    with pytest.raises(ValueError, match='no LoRA adapters'):
        ESM2(config=tcfg, device='cpu').save_lora(
            str(tmp_path / 'none.safetensors'))


def _nest(flat):
    out = {}
    for key, v in flat.items():
        parts = key.split('.')[1:]          # drop 'head.'
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def _check_task(task, dtype, quantization=None):
    """ESM2-8M from seed 0 (bf16, as ``benchmarks/tasks.py`` built it),
    optionally quantized, with ``task_<task>/``'s adapters and head:
    representations and the head's predictions on seeded GB1-like
    sequences against JAX's (the classification head for ``tf``)."""
    jm = jesm.ESM2(config=jconfig.config_for('esm2_8m'), rng=0)
    jp = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)).astype(
        dtype if dtype == 'float32' else jnp.bfloat16), jm.params)
    jcfg = jconfig.config_for('esm2_8m', dtype=dtype)
    tcfg = tconfig.config_for('esm2_8m', dtype=dtype)
    jm = jesm.ESM2(config=jcfg, params=jax.tree.map(jnp.asarray, jp))
    tm = ESM2(config=tcfg, params=tio.params_from_jax(jp, tcfg), device='cpu')
    if quantization:
        jm.quantize(quantization)
        tm.quantize(quantization)
    jm.load_lora(f'task_{task}/lora.safetensors')
    tm.load_lora(f'task_{task}/lora.safetensors')
    assert tm.lora_kwargs == jm.lora_kwargs
    assert tm.lora_kwargs['names'] == [task] and tm.config.num_layers == 6
    for t in ('q', 'v', 'out'):
        for leaf in ('a', 'b'):
            x = tm.params['layers']['attn'][t]['lora'][task][leaf]
            y = jm.params['layers']['attn'][t]['lora'][task][leaf]
            assert str(x.dtype).split('.')[-1] == y.dtype.name, (t, leaf)
    raw = stnp.load_file(f'task_{task}/head.safetensors')
    jhead = jax.tree.map(lambda a: jnp.asarray(a.astype(np.float32)).astype(
        jcfg.jnp_dtype), _nest(raw))
    thead = tio.params_from_jax(jax.tree.map(np.asarray, jhead), tcfg)

    rng = np.random.default_rng(22)
    seqs = [''.join(rng.choice(list('LAGVSERTIDPKQNFYMHWC'),
                               rng.integers(20, 60))) for _ in range(12)]
    tok, _, cu, ml = tokenize_unpad(seqs)
    got = tm.forward_representation(tok, pad_args=(cu, ml))
    ref = np.asarray(jm.forward_representation(tok, pad_args=(cu, ml))
                     .astype(jnp.float32))
    got = _np(got)
    if dtype == 'float32':
        np.testing.assert_allclose(got, ref, atol=FP32_ATOL, rtol=0)
    else:
        err = np.abs(got - ref).max()
        cos = (got * ref).sum(-1) / np.linalg.norm(got, axis=-1) \
            / np.linalg.norm(ref, axis=-1)
        assert err <= 2.0 ** -5 * np.abs(ref).max() and cos.min() >= 0.999, \
            (err, cos.min())
    binary = task == 'tf'
    labels = [float(len(s) > 40) if binary else len(s) / 60.0
              for s in seqs]
    jds = JLabeledDataset(seqs, labels, token_per_batch=512, shuffle=False)
    tds = LabeledDataset(seqs, labels, token_per_batch=512, shuffle=False)
    jcls, tcls = ((JClassificationTrainer, ClassificationTrainer) if binary
                  else (JRegressionTrainer, RegressionTrainer))
    jpred = np.concatenate([np.asarray(jcls(jm, jhead).predict(
        b)).astype(np.float32) for b in jds])
    tpred = np.concatenate([tcls(tm, thead).predict(b) for b in tds])
    assert tpred.shape == (12,) and tpred.dtype == np.float32
    tol = 1e-5 if dtype == 'float32' else 2.0 ** -5
    assert np.abs(tpred - jpred).max() <= tol * np.abs(jpred).max(), \
        (np.abs(tpred - jpred).max(), np.abs(jpred).max())
    return tm


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_task_gb1_artefacts_match_jax(dtype):
    """``task_gb1/`` on the dense trunk in fp32 and bf16."""
    _check_task('gb1', dtype)


@pytest.mark.parametrize('task', ['aav', 'meltome', 'tf'])
def test_task_artefacts_match_jax(task):
    """The other three task artefacts in bf16, as the tasks ran; ``tf``
    holds ``ClassificationTrainer``'s head."""
    _check_task(task, 'bfloat16')


def test_task_artefact_over_int8_base_matches_jax():
    """``task_gb1/`` loaded over an int8 trunk in fp32: JAX's
    ``load_lora`` makes bf16 adapters where the projection has no kernel,
    and so does the port's; fp32 gates (the bf16 adapters are exact in the
    fp32 products on both sides)."""
    tm = _check_task('gb1', 'float32', quantization='8bit')
    assert tm.params['layers']['attn']['q']['lora']['gb1']['a'].dtype == \
        torch.bfloat16
    assert tm.params['layers']['attn']['q']['qvalue'].dtype == torch.int8
