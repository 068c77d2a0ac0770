"""ESMC, ESM1b and ESM1v in the port against the JAX package: configs,
the init tree, ``swiglu_linear`` and its gradient, the scaled residual,
the RoPE-free attention route, the position-table guard, the
safetensors round trip, the whole model on both entry routes, and every
leaf's gradient of the masked-LM loss.

Each family is built tiny: 2 layers, width 64, 4 heads of 16 (ESMC then
has ``ffn_dim`` 256 and residue scaling sqrt(2/36); ESM1b and ESM1v keep
their 4,096-position table). Weights come from JAX's ``init_params`` and
travel with ``params_from_jax`` or a safetensors file. The JAX side runs
its Pallas kernels in interpret mode (``attn_impl='flash'``: the
token-minor path) or its einsum attention (``'reference'``); on the CPU
the port runs the kernels' plain versions.

Gates (each with its reason):
* log-probabilities, as in ``test_torch_esm.py`` (slice 1), at T = 512
  (486 real tokens): fp32 5e-5 absolute (the same fp32 math in another
  summation order; measured under 6e-6 with every leaf moved off its
  init); bf16 largest error at most 0.1, mean at most 0.01, per-token
  centred cosine at least 0.999 (bf16 rounding at other points in each
  layer, on slice 1's weights: the embedding lifted to N(0, 1); measured
  largest 0.058, mean 0.0072, cosine 0.99962 or more, against the JAX
  package's own flash-vs-einsum spread of 0.049, 0.0066, 0.99975).
* ``swiglu_linear``: the port's ``F.silu`` rounds SiLU once to the
  activation dtype, where XLA:CPU expands ``jax.nn.silu`` into exp, add,
  divide and multiply and rounds each to bf16 (each op within half an
  ulp). SiLU alone, on 20,000 seeded values: each bf16 element within 2
  ulps of JAX's (measured: 2 at most; in fp32 1e-6 of each value).
  fp32: 1e-5 of each output's scale (the exp and the division differ by
  an fp32 ulp between the libraries, and the matmuls sum in another
  order; measured 2.1e-7). bf16, the GELU gate of ROADMAP Queue 3 item
  2 (``test_torch_modules.py``) with the mean taken at the top of its
  binade: largest error at most 8 bf16 ulps of the largest output
  (2^-5·max|ref|), mean error at most 2^-7·mean|ref| (measured: largest
  0.0070·max|ref|, mean 0.0043·mean|ref|, for y, dh and the three
  kernel gradients; the one-rounding SiLU moves about 60% of the
  elements by an ulp, and the matmuls after it carry that on).
* every leaf's gradient, fp32, through the Pallas kernels in interpret
  mode: loss 1e-5 relative, per leaf max|Δ| <= 1e-4 · max|g| (the same
  fp32 function summed in another order; ``test_torch_train.py``'s gate).
  One leaf has no scale of its own: without RoPE (ESM1b) the gradient of
  k's bias is 0 in exact arithmetic, and both sides' rounding noise there
  is held under 1e-6 of the largest gradient of k's kernel.
* the scaled residual in bf16, the safetensors round trip, the init tree
  and the configs: exact.
"""

import functools
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esme_tpu import loss as jloss
from esme_tpu.models import config as jconfig
from esme_tpu.models import esm as jesm
from esme_tpu.models import io as jio
from esme_tpu.models import modules as jmod
from esme_tpu.models.init import init_params as jinit

from esme_tpu_torch import (ESM, ESM1b, ESM1v, ESMC, mask_tokens,
                            tokenize, tokenize_unpad)
from esme_tpu_torch.models import config as tconfig
from esme_tpu_torch.models import io as tio
from esme_tpu_torch.models import modules as tmod
from esme_tpu_torch.models.esm import forward_flat, packed_meta
from esme_tpu_torch.models.init import init_params as tinit
from esme_tpu_torch.ops import flash as tflash
from esme_tpu_torch.ops import fused_attn, headsplit
from esme_tpu_torch.train import MaskedPLM

AA = list('LAGVSERTIDPKQNFYMHWC')
FAMILIES = {'esmc': ESMC, 'esm1b': ESM1b, 'esm1v': ESM1v}
JCLASSES = {'esmc': jesm.ESMC, 'esm1b': jesm.ESM1b, 'esm1v': jesm.ESM1v}
TINY = dict(num_layers=2, embed_dim=64, attention_heads=4)
FP32_ATOL = 5e-5


def _seqs(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [''.join(rng.choice(AA, n)) for n in lengths]


SEQS = _seqs([150, 7, 233, 60, 31])          # 486 tokens, T = 512 padded


def _configs(family, dtype):
    """The tiny config of ``family`` in both packages."""
    if family == 'esmc':
        return (jconfig.esmc_config(**TINY, dtype=dtype),
                tconfig.esmc_config(**TINY, dtype=dtype))
    return (replace(getattr(jconfig, f'{family}_config')(dtype=dtype),
                    **TINY),
            replace(getattr(tconfig, f'{family}_config')(dtype=dtype),
                    **TINY))


@functools.lru_cache(maxsize=None)
def _jax_params(family, dtype, lift='embed'):
    """JAX's init from seed 3; ``lift='embed'`` sets the embedding to
    N(0, 1) (slice 1's recipe), ``'all'`` moves every leaf by 0.1·N(0, 1)
    so each norm, bias and table takes part."""
    jcfg, _ = _configs(family, dtype)
    jp = jinit(jcfg, jax.random.key(3))
    rng = np.random.default_rng(4)
    if lift == 'embed':
        return {**jp, 'embed_tokens': jnp.asarray(
            rng.standard_normal(jp['embed_tokens'].shape),
            jp['embed_tokens'].dtype)}
    return jax.tree.map(lambda a: a + jnp.asarray(
        rng.standard_normal(a.shape) * 0.1, a.dtype), jp)


def _port_model(family, dtype, lift='embed', **kw):
    jcfg, tcfg = _configs(family, dtype)
    jp = _jax_params(family, dtype, lift)
    return FAMILIES[family](config=tcfg, params=tio.params_from_jax(
        jax.tree.map(np.asarray, jp), tcfg), device='cpu', **kw)


def _leaves(tree, prefix=''):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f'{prefix}{k}.')
        else:
            yield f'{prefix}{k}', v


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.array(jnp.asarray(x).astype(jnp.float32))


def _gate(got, ref, dtype):
    if dtype == 'float32':
        np.testing.assert_allclose(got, ref, atol=FP32_ATOL, rtol=0)
        return
    err = np.abs(got - ref)
    assert err.max() <= 0.1 and err.mean() <= 0.01, (err.max(), err.mean())
    a = got - got.mean(-1, keepdims=True)
    b = ref - ref.mean(-1, keepdims=True)
    cos = (a * b).sum(-1) / np.linalg.norm(a, axis=-1) \
        / np.linalg.norm(b, axis=-1)
    assert cos.min() >= 0.999, cos.min()


@pytest.mark.parametrize('name', ['esmc_300m', 'esmc_600m', 'esmc',
                                  'esm1b', 'esm1v', 'esm1v_t33_650m_ur90s_1'])
def test_config_matches_jax(name):
    j, t = jconfig.config_for(name), tconfig.config_for(name)
    assert asdict(t) == asdict(j)
    assert (t.ffn_dim, t.head_dim) == (j.ffn_dim, j.head_dim)
    assert t.residue_scaling == j.residue_scaling
    if name.startswith('esmc'):
        assert t.ffn_dim == {'esmc_600m': 3072}.get(name, 2560)
        assert t.head_dim == 64


@pytest.mark.parametrize('family', list(FAMILIES))
def test_init_params_tree_matches_jax(family):
    for dtype in ('bfloat16', 'float32'):
        jcfg, tcfg = _configs(family, dtype)
        want = {k: (a.shape, a.dtype.name) for k, a in
                _leaves(jax.tree.map(np.asarray, jinit(
                    jcfg, jax.random.key(0))))}
        tp = tinit(tcfg, seed=0)
        got = {k: (tuple(t.shape), str(t.dtype).removeprefix('torch.'))
               for k, t in _leaves(tp)}
        assert got == want
        if cfg_rows := tcfg.learned_positions:
            pos = tp['embed_positions']
            assert pos.shape[0] == cfg_rows + 2
            assert not pos[tcfg.padding_idx].any()
        assert not tp['embed_tokens'][tcfg.padding_idx].any()
    # the seed decides the draw
    assert torch.equal(tinit(tcfg, 5)['embed_tokens'],
                       tinit(tcfg, 5)['embed_tokens'])


@pytest.mark.parametrize('family', list(FAMILIES))
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_predict_log_prob_matches_jax(family, dtype):
    """The ``pad_args`` route against JAX's ``forward_flat`` on its
    token-minor Pallas path and its einsum path; the port's own einsum
    path against its flash path."""
    lift = 'all' if dtype == 'float32' else 'embed'
    model = _port_model(family, dtype, lift)
    jcfg, _ = _configs(family, dtype)
    jp = _jax_params(family, dtype, lift)
    tok, _, cu, ml = tokenize_unpad(SEQS, alphabet=model.alphabet)
    got = model.predict_log_prob(tok, pad_args=(cu, ml))
    V = model.config.vocab_size
    assert got.dtype == torch.float32 and got.shape == (tok.shape[0], V)
    got = got.numpy()
    seg, pos = jesm.packed_meta(jnp.asarray(cu), tok.shape[0])
    for impl in ('flash', 'reference'):
        ref = jesm.forward_flat(jp, jcfg, jnp.asarray(tok), seg, pos,
                                log_prob=True, attn_impl=impl)
        _gate(got, np.asarray(ref, np.float32), dtype)
    ref_t = model.predict_log_prob(tok, pad_args=(cu, ml),
                                   attn_impl='reference').numpy()
    _gate(got, ref_t, dtype)


@pytest.mark.parametrize('family', list(FAMILIES))
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_padded_route_matches_jax(family, dtype):
    """The padded ``(B, L)`` route agrees with the packed route with
    ``pad_output`` and with the JAX class's padded route (its einsum path
    on the CPU) under the gates above; pads hold ``lm_head(0)`` over the
    family's vocabulary."""
    lift = 'all' if dtype == 'float32' else 'embed'
    model = _port_model(family, dtype, lift)
    jcfg, _ = _configs(family, dtype)
    jm = JCLASSES[family](config=jcfg,
                          params=_jax_params(family, dtype, lift))
    padded = tokenize(SEQS, alphabet=model.alphabet)
    tok, _, cu, ml = tokenize_unpad(SEQS, alphabet=model.alphabet)
    lp_pad = model.predict_log_prob(padded).numpy()
    V = model.config.vocab_size
    assert lp_pad.shape == (len(SEQS), ml, V)
    lp_po = model.predict_log_prob(tok, pad_args=(cu, ml),
                                   pad_output=True).numpy()
    valid = padded != model.alphabet.padding_idx
    _gate(lp_pad[valid], lp_po[valid], dtype)
    np.testing.assert_array_equal(lp_pad[~valid], lp_po[~valid])
    ref = np.asarray(jm.predict_log_prob(padded), np.float32)
    _gate(lp_pad[valid], ref[valid], dtype)
    # the pad row lm_head(0), uniform in the bf16 weights: no cosine
    np.testing.assert_allclose(lp_pad[~valid], ref[~valid], rtol=0,
                               atol=FP32_ATOL if dtype == 'float32' else 0.1)
    pads = lp_pad[~valid]                       # SEQS[1] is 7 aa
    assert len(pads) and (pads == pads[0]).all()


@pytest.mark.parametrize('family', ['esmc', 'esm1b'])
@pytest.mark.parametrize('impl', ['flash', 'reference'])
def test_attention_block_matches_jax(family, impl):
    """ESMC's block (q/k LayerNorm over the full width, then RoPE) and
    ESM1b's (no RoPE) against JAX's block on its einsum path, fp32, with
    every leaf moved off its init: 1e-5 absolute and relative (the same
    fp32 math in another order)."""
    from esme_tpu_torch.ops.rotary import rotary_cos_sin
    jcfg, tcfg = _configs(family, 'float32')
    jp = _jax_params(family, 'float32', 'all')
    lens = [100, 37, 200, 175]
    seg = np.repeat(np.arange(4, dtype=np.int32), lens)
    pos = np.concatenate([np.arange(n) for n in lens]).astype(np.int32)
    x = np.random.default_rng(2).standard_normal((512, 64)).astype(
        np.float32)
    jl = jax.tree.map(lambda a: a[1], jp['layers']['attn'])
    ref = jmod.attention_block(jnp.asarray(x), jl, jcfg, jnp.asarray(seg),
                               jnp.asarray(pos), attn_impl='reference')
    tl = tio.params_from_jax(jax.tree.map(np.asarray, jl), tcfg)
    tseg, tpos = torch.from_numpy(seg), torch.from_numpy(pos)
    rope = rotary_cos_sin(tpos, tcfg.head_dim, dtype=torch.float32) \
        if tcfg.rotary else None
    for kw in ({}, {'rope': rope, 'spans': tflash.flash_spans(tseg)}):
        got = tmod.attention_block(torch.from_numpy(x), tl, tcfg, tseg, tpos,
                                   attn_impl=impl, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_swiglu_linear_matches_jax(dtype):
    rng = np.random.default_rng(0)
    jdt = getattr(jnp, dtype)
    h, gk, uk, dk, dy = (jnp.asarray(rng.standard_normal(s) * sc, jdt)
                         for s, sc in (((96, 64), 1.0), ((64, 256), 0.15),
                                       ((64, 256), 0.15), ((256, 64), 0.06),
                                       ((96, 64), 1.0)))
    y_ref, vjp = jax.vjp(jmod.swiglu_linear, h, gk, uk, dk)
    ref = vjp(dy)
    tdt = getattr(torch, dtype)
    th, tg, tu, td = (torch.from_numpy(_np(a)).to(tdt).requires_grad_()
                      for a in (h, gk, uk, dk))
    saved = []

    def pack(t):
        saved.append(t)
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = tmod.swiglu_linear(th, tg, tu, td)
    # only h and the three kernels are kept for the backward
    assert len(saved) == 4
    assert all(a is b for a, b in zip(saved, (th, tg, tu, td)))
    y.backward(torch.from_numpy(_np(dy)).to(tdt))
    for got, r in zip((y, th.grad, tg.grad, tu.grad, td.grad),
                      (y_ref, *ref)):
        assert got.dtype == tdt
        r = _np(r)
        err = np.abs(_np(got) - r)
        if dtype == 'float32':
            assert err.max() <= 1e-5 * np.abs(r).max()
        else:
            assert err.max() <= 2.0 ** -5 * np.abs(r).max()
            assert err.mean() <= 2.0 ** -7 * np.abs(r).mean()
    # SiLU itself, against XLA's expansion of it
    g = jnp.asarray(rng.standard_normal(20000) * 4, jdt)
    got = _np(torch.nn.functional.silu(torch.from_numpy(_np(g)).to(tdt)))
    r = _np(jax.nn.silu(g))
    if dtype == 'float32':
        np.testing.assert_allclose(got, r, rtol=1e-6, atol=0)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(r), 2.0 ** -126)))
                      - 7)
        assert (np.abs(got - r) <= 2 * ulp).all()


def test_mlp_block_routes_swiglu():
    """ESMC's bias-free MLP runs ``swiglu_linear``; with biases it falls
    back to the linears, as in JAX (``esme_tpu/models/modules.py:291-303``),
    and both match JAX's ``mlp_block``."""
    jcfg, tcfg = _configs('esmc', 'float32')
    jp = _jax_params('esmc', 'float32', 'all')
    rng = np.random.default_rng(1)
    x = rng.standard_normal((100, 64)).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp['layers']['mlp'])
    with_bias = {**jl, **{k: {**jl[k], 'bias': jnp.asarray(
        rng.standard_normal(jl[k]['kernel'].shape[1]) * 0.1, jnp.float32)}
        for k in ('gate', 'up', 'down')}}
    for layer in (jl, with_bias):
        tl = tio.params_from_jax(jax.tree.map(np.asarray, layer), tcfg)
        out = tmod.mlp_block(torch.from_numpy(x).requires_grad_(), tl, tcfg)
        fused = type(out.grad_fn).__name__ == '_SwigluLinearBackward'
        assert fused == (layer is jl)
        np.testing.assert_allclose(
            out.detach().numpy(),
            np.asarray(jmod.mlp_block(jnp.asarray(x), layer, jcfg)),
            atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('family', ['esmc', 'esm1b'])
def test_model_grads_match_jax_fp32(family):
    """Every leaf's gradient of the masked-LM loss, fp32, against
    ``jax.grad`` through JAX's Pallas kernels in interpret mode."""
    model = _port_model(family, 'float32', 'all')
    jcfg, _ = _configs(family, 'float32')
    jp = _jax_params(family, 'float32', 'all')
    batch = _batch(430, 512, seed=0, alphabet=model.alphabet)
    seg, pos = jesm.packed_meta(jnp.asarray(batch.cu_lens), 512)

    def loss(p):
        logits = jesm.forward_flat(p, jcfg, jnp.asarray(batch.masked_tokens),
                                   seg, pos, attn_impl='flash')
        return jloss.cross_entropy(logits, jnp.asarray(batch.tokens),
                                   jnp.asarray(batch.mask))
    jval, jgrads = jax.value_and_grad(loss)(jp)
    tloss, grads = MaskedPLM(model)._grad_step(batch)
    np.testing.assert_allclose(tloss.item(), float(jval), rtol=1e-5)
    got = dict(_leaves(grads))
    want = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    assert got.keys() == want.keys()
    for name, r in want.items():
        g = got[name]
        assert g is not None and g.dtype == torch.float32, name
        if name == 'layers.attn.k.bias' and not model.config.rotary:
            # without RoPE k's bias adds one constant to each row of
            # scores, which the softmax removes: its gradient is 0 in
            # exact arithmetic and rounding noise on both sides
            scale = np.abs(want['layers.attn.k.kernel']).max()
            assert max(np.abs(g.numpy()).max(), np.abs(r).max()) \
                <= 1e-6 * scale, name
            continue
        err = np.abs(g.numpy() - r).max()
        assert err <= 1e-4 * np.abs(r).max(), (name, err, np.abs(r).max())


def _batch(T_real, budget, seed, alphabet):
    """A packed masked-LM batch in the data plane's layout."""
    rng = np.random.default_rng(seed)
    lens, total = [], 0
    while total < T_real - 22:
        n = int(rng.integers(20, min(200, T_real - total - 2)))
        lens.append(n)
        total += n + 2
    tok, _, cu, ml = tokenize_unpad(_seqs(lens, seed), alphabet=alphabet)
    masked, mask = mask_tokens(tok, alphabet=alphabet,
                               rng=np.random.default_rng(seed + 1))
    pad = budget - tok.shape[0]

    class B:
        pass
    b = B()
    b.tokens = np.pad(tok, (0, pad), constant_values=alphabet.padding_idx)
    b.masked_tokens = np.pad(masked, (0, pad),
                             constant_values=alphabet.padding_idx)
    b.mask = np.pad(mask, (0, pad), constant_values=False)
    b.cu_lens, b.max_len = cu, ml
    return b


def test_scaled_residual_bf16_is_jax_bit_for_bit(monkeypatch):
    """ESMC-300M's residual scale 1/sqrt(30/36) is rounded to bf16
    (1.09375) before the product, as JAX rounds a Python scalar; the
    whole ``transformer_layer`` over fixed branch outputs is bit-equal."""
    rng = np.random.default_rng(2)
    x, ya, ym = (jnp.asarray(rng.standard_normal((4000, 64)) * s,
                             jnp.bfloat16) for s in (1.0, 3.0, 3.0))
    for family in ('esmc', 'esm2'):
        jcfg = jconfig.config_for('esmc_300m' if family == 'esmc'
                                  else 'esm2_8m')
        tcfg = tconfig.config_for('esmc_300m' if family == 'esmc'
                                  else 'esm2_8m')
        monkeypatch.setattr(jmod, 'attention_block', lambda *a, **k: ya)
        monkeypatch.setattr(jmod, 'mlp_block', lambda *a, **k: ym)
        ref = jmod.transformer_layer(x, {'attn': {}, 'mlp': {}}, jcfg,
                                     None, None)
        tya, tym = (torch.from_numpy(_np(a)).bfloat16() for a in (ya, ym))
        monkeypatch.setattr(tmod, 'attention_block', lambda *a, **k: tya)
        monkeypatch.setattr(tmod, 'mlp_block', lambda *a, **k: tym)
        got = tmod.transformer_layer(torch.from_numpy(_np(x)).bfloat16(),
                                     {'attn': {}, 'mlp': {}}, tcfg, None,
                                     None)
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(ref).view(np.int16))


@pytest.mark.parametrize('family', ['esm1b', 'esm1v'])
def test_rope_free_families_run_no_rotary(family, monkeypatch):
    """ESM1b and ESM1v call no RoPE, forward or backward: ``rotary_qk``
    (H3's wrapper) is called 0 times and H1 once per layer, H2 once per
    layer in a train step; ESMC rotates in every layer."""
    calls = {'rotary_qk': 0, 'fwd': 0, 'bwd': 0, 'cos_sin': 0}

    def counted(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper
    rot = counted('rotary_qk', headsplit.rotary_qk)
    monkeypatch.setattr(fused_attn, 'rotary_qk', rot)
    monkeypatch.setattr(headsplit, 'rotary_qk', rot)
    fwd = counted('fwd', tflash.segment_flash_fwd)
    bwd = counted('bwd', tflash.segment_flash_bwd)
    for m in (tflash, fused_attn):    # where each route looks them up
        monkeypatch.setattr(m, 'segment_flash_fwd', fwd)
        monkeypatch.setattr(m, 'segment_flash_bwd', bwd)
    from esme_tpu_torch.models import esm as tesm
    monkeypatch.setattr(tesm, 'rotary_cos_sin',
                        counted('cos_sin', tesm.rotary_cos_sin))
    L = TINY['num_layers']
    for fam, rotary in ((family, 0), ('esmc', 1)):
        calls.update(dict.fromkeys(calls, 0))
        model = _port_model(fam, 'float32')
        tok, _, cu, ml = tokenize_unpad(SEQS, alphabet=model.alphabet)
        model.predict_log_prob(tok, pad_args=(cu, ml))
        assert calls == {'rotary_qk': rotary * L, 'fwd': L, 'bwd': 0,
                         'cos_sin': rotary}, (fam, calls)
        calls.update(dict.fromkeys(calls, 0))
        batch = _batch(430, 512, seed=3, alphabet=model.alphabet)
        MaskedPLM(model).training_step(batch)
        assert calls == {'rotary_qk': 2 * rotary * L, 'fwd': L, 'bwd': L,
                         'cos_sin': rotary}, (fam, calls)


def test_position_table_overflow_raises(monkeypatch):
    """A sequence wider than the learned position table raises
    ``ValueError`` on both routes before any attention call; one at the
    table's width runs."""
    model = _port_model('esm1b', 'float32')
    n = model.config.learned_positions
    launches = []
    monkeypatch.setattr(tflash, 'segment_flash_fwd',
                        lambda *a, **k: launches.append(1))
    over = _seqs([n - 1])                   # n + 1 tokens with cls/eos
    tok, _, cu, ml = tokenize_unpad(over, alphabet=model.alphabet)
    with pytest.raises(ValueError, match='position table'):
        model.predict_log_prob(tok, pad_args=(cu, ml))
    with pytest.raises(ValueError, match='position table'):
        model.predict_log_prob(tokenize(over, alphabet=model.alphabet))
    assert launches == []
    # JAX's guard agrees
    jm = jesm.ESM1b(config=_configs('esm1b', 'float32')[0],
                    params=_jax_params('esm1b', 'float32'))
    with pytest.raises(ValueError, match='position table'):
        jm.predict_log_prob(tok, pad_args=(cu, ml))
    monkeypatch.undo()
    fits = tokenize(_seqs([n - 2]), alphabet=model.alphabet)
    assert np.isfinite(model.predict_log_prob(fits).numpy()).all()


@pytest.mark.parametrize('family', list(FAMILIES))
def test_safetensors_round_trip(family, tmp_path, monkeypatch):
    """A JAX-written file loads through ``ESM.from_pretrained`` as the
    family's class with the same bits, and the port's file loads in JAX
    with the same bits. ESM1b and ESM1v take their fixed published size
    from the metadata's name (checked first); for the tiny file both
    packages' size functions are pointed at the tiny config."""
    jcfg, tcfg = _configs(family, 'bfloat16')
    jp = _jax_params(family, 'bfloat16', 'all')
    name = {'esmc': 'esmc_t', 'esm1b': 'esm1b', 'esm1v': 'esm1v_t'}[family]
    path = str(tmp_path / 'j.safetensors')
    jio.save_pretrained(path, jp, jcfg, name)
    if family != 'esmc':
        meta = tio.read_metadata(path)
        assert tio.config_from_metadata(meta)[0] == \
            tconfig.config_for(family)
        monkeypatch.setattr(tio, f'{family}_config',
                            lambda dtype: replace(tcfg, dtype=dtype))
        monkeypatch.setattr(jio, f'{family}_config',
                            lambda dtype: replace(jcfg, dtype=dtype))
    model = ESM.from_pretrained(path, device='cpu')
    assert type(model) is FAMILIES[family] and model.name == name
    assert model.config == tcfg
    want = dict(_leaves(jax.tree.map(np.asarray, jp)))
    got = dict(_leaves(model.params))
    assert got.keys() == want.keys()
    for k, a in want.items():
        np.testing.assert_array_equal(got[k].view(torch.int16).numpy(),
                                      a.view(np.int16), err_msg=k)
    out = str(tmp_path / 't.safetensors')
    model.save_pretrained(out)
    assert tio.read_safetensors(out)[0].keys() == \
        set(jio.params_to_flat(jp, jcfg))
    jcfg2, back, name2 = jio.load_pretrained(out)
    assert name2 == name and jcfg2 == jcfg
    for (ka, a), (kb, b) in zip(jax.tree_util.tree_leaves_with_path(jp),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert ka == kb
        np.testing.assert_array_equal(np.asarray(a).view(np.int16),
                                      np.asarray(b).view(np.int16))
    with pytest.raises(ValueError, match='unknown model family'):
        tio.config_from_metadata({**tio.read_metadata(out),
                                  'name': 'esm3_t'})


def test_forward_flat_reference_route_skips_rope():
    """``attn_impl='reference'`` of a RoPE-free family rotates nothing:
    it equals the flash route (fp32) without the position tables."""
    model = _port_model('esm1v', 'float32', 'all')
    tok, _, cu, _ = tokenize_unpad(SEQS, alphabet=model.alphabet)
    seg, pos = packed_meta(torch.from_numpy(cu), tok.shape[0])
    t = torch.from_numpy(tok)
    ref = forward_flat(model.params, model.config, t, seg, pos,
                       attn_impl='reference')
    fl = forward_flat(model.params, model.config, t, seg, pos,
                      attn_impl='flash')
    np.testing.assert_allclose(ref.numpy(), fl.numpy(), atol=FP32_ATOL,
                               rtol=0)
