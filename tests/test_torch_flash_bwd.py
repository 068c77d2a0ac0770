"""Port's segment-flash backward (kernel H2's wrapper and its plain
version) and the gradient of ``fused_rotary_flash`` vs the JAX package:
the Pallas backward kernels in interpret mode — K4 (``_dq_kernel`` +
``_dkv_kernel``, static spans), K5 (``_dq_jobs_kernel`` +
``_dkv_jobs_kernel``, job lists) and K3 (``_dkvq_jobs_kernel``, fused
with banded dq partials) — reached through ``jax.grad`` of
``flash_segment_attention`` and ``fused_rotary_flash``, and the
transposed block spans vs JAX's ``block_spans``.

On the CPU the wrapper runs its plain version. Gates:
* spans: exact (integer arithmetic).
* fp32: the JAX suite's own gradient gates — atol 5e-5 / rtol 1e-3 for
  ``flash_segment_attention`` (``tests/test_flash.py:85-86``) and
  atol 1e-4 / rtol 1e-4 for the fused path (``:197-198``); both sides
  compute the same fp32 function in another summation order.
* bf16: both sides round q·k's softmax p and ds to bf16 before their
  products and each gradient once at the end, but the forward's o (and
  so delta) and the rounding points of XLA's fused elementwise chains
  differ, so a few bf16 ulps of each gradient's scale are expected:
  |Δ| ≤ 2^-5 · max|ref| per tensor and mean |Δ| ≤ 2^-8 · mean|ref|
  (measured: at most 0.18 and 0.26 of these gates; the largest mean is
  dq through K3, which rounds its dq partials to bf16 before their sum,
  where H2 and K4/K5 round dq once). In fp32 the largest error was
  0.005 of the gate.
The kernel itself is held against the plain version on the card in
``tests/test_torch_kernels_cuda.py``.
"""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from esme_tpu.ops import flash as jflash
from esme_tpu.ops import fused_attn as jfused
from esme_tpu.ops import rotary as jrot
from esme_tpu.ops import segment as jseg

from esme_tpu_torch.ops import flash as tflash
from esme_tpu_torch.ops import fused_attn as tfused
from esme_tpu_torch.ops import rotary as trot

F32 = dict(atol=5e-5, rtol=1e-3)
F32_FUSED = dict(atol=1e-4, rtol=1e-4)
BF16_MAX, BF16_MEAN = 2.0 ** -5, 2.0 ** -8


def _seg(lens, total):
    cu = np.cumsum([0, *lens]).astype(np.int32)
    return np.array(jseg.segment_ids_from_cu_lens(jnp.asarray(cu), total))


def _lens(total, lo, hi, seed):
    """Segment lengths from ``[lo, hi)`` that leave a tail of 10-300
    tokens (chunked fake segments) up to ``total``."""
    rng = np.random.default_rng(seed)
    lens, tot = [], 0
    while tot < total - 300 - hi:
        n = int(rng.integers(lo, hi))
        lens.append(n)
        tot += n
    lens.append(int(rng.integers(lo, min(hi, total - 10 - tot))))
    return lens


def _close(got, ref, dtype, gate):
    got = got.float().numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref, dtype=np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, **gate)
        return
    d = np.abs(got - ref)
    assert d.max() <= BF16_MAX * np.abs(ref).max()
    assert d.mean() <= BF16_MEAN * np.abs(ref).mean()


def _to_torch(x, dtype):
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(dtype)


@pytest.mark.parametrize('bq,bk', [(128, 64), (64, 64), (256, 256),
                                   (64, 128)])
def test_transposed_spans_match_jax(bq, bk):
    seg = _seg(_lens(6144, 20, 900, seed=1), 6144)
    got = tflash.transposed_spans(torch.from_numpy(seg), bq, bk)
    ref = jflash.block_spans(jnp.asarray(seg), bq, bk)[2:]
    for a, b in zip(ref, got):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    spans = tflash.flash_spans(torch.from_numpy(seg))
    ref = jflash.block_spans(jnp.asarray(seg), tflash.BLOCK_Q,
                             tflash.BLOCK_K)[:2] + \
        jflash.block_spans(jnp.asarray(seg), tflash.BLOCK_QT,
                           tflash.BLOCK_KV)[2:]
    for a, b in zip(ref, spans):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('D', [16, 32, 64, 128])
def test_flash_bwd_matches_jax_grad(D, dtype):
    """H2's wrapper (plain version on the CPU) vs ``jax.vjp`` of
    ``flash_segment_attention`` (K4 in interpret mode) on a packed batch
    with a chunked fake tail."""
    T, H = 1024, 2
    seg = _seg(_lens(T, 30, 400, seed=D), T)
    rng = np.random.default_rng(D)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    q, k, v, do = (jnp.asarray(rng.standard_normal((T, H, D)), jdt)
                   for _ in range(4))
    segj = jnp.asarray(seg)
    _, vjp = jax.vjp(lambda q, k, v: jflash.flash_segment_attention(
        q, k, v, segj, block_q=256, block_k=256), q, k, v)
    ref = vjp(do)

    tq, tk, tv, tdo = (_to_torch(x, dtype).reshape(T, H * D)
                       for x in (q, k, v, do))
    segt = torch.from_numpy(seg)
    spans = tflash.flash_spans(segt)
    o, lse = tflash.segment_flash_fwd(tq, tk, tv, segt, *spans[:2], H)
    delta = tflash.attention_delta(o, tdo, H)
    before = tflash.segment_flash_bwd.launches
    got = tflash.segment_flash_bwd(tq, tk, tv, tdo, lse, delta, segt,
                                   *spans, H)
    assert tflash.segment_flash_bwd.launches == before   # no kernel here
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.shape == (T, H * D)
        _close(g, np.asarray(r.astype(jnp.float32)).reshape(T, H * D),
               dtype, F32)


def _fused_inputs(T, H, D, dtype, seed):
    rng = np.random.default_rng(seed)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    q2, k2, v2, w = (jnp.asarray(rng.standard_normal((T, H * D)), jdt)
                     for _ in range(4))
    pos = jnp.asarray(rng.integers(0, 1000, T).astype(np.int32))
    cos, sin = jrot.rotary_cos_sin(pos, D, dtype=jdt)
    return q2, k2, v2, w, cos, sin


# (max_seqlen, job list?) -> the JAX backward kernel it reaches at
# T = 1536 with 256 x 256 tiles (esme_tpu/ops/flash.py:778-797)
MODES = {'K4': (False, None), 'K5': (False, True), 'K3': (250, True)}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('mode', sorted(MODES))
def test_fused_rotary_flash_grad_matches_jax(mode, dtype):
    """The gradient of the port's ``fused_rotary_flash`` (H3, H1, H2 and
    H3 inverse, plain versions on the CPU) vs ``jax.value_and_grad`` of
    the JAX function through K4, K5 or K3."""
    T, H, D = 1536, 2, 64
    max_seqlen, jobs = MODES[mode]
    lens = _lens(T, 50, 250, seed=3)
    seg = _seg(lens, T)
    q2, k2, v2, w, cos, sin = _fused_inputs(T, H, D, dtype, seed=5)
    num_jobs = jflash.host_num_jobs(seg, 256, 256) if jobs else None
    if mode == 'K3':
        assert max(lens) <= max_seqlen and \
            jflash._span_cap(T, 256, 256, max_seqlen) < T // 256
    segj = jnp.asarray(seg)

    def loss(q2, k2, v2):
        o = jfused.fused_rotary_flash(q2, k2, v2, cos, sin, segj, H, 256,
                                      256, max_seqlen or None, True,
                                      num_jobs)
        return jnp.sum(o.astype(jnp.float32) * w.astype(jnp.float32))

    val, ref = jax.value_and_grad(loss, argnums=(0, 1, 2))(q2, k2, v2)

    tq, tk, tv = (_to_torch(x, dtype).requires_grad_() for x in (q2, k2, v2))
    tw, tc, ts = (_to_torch(x, dtype) for x in (w, cos, sin))
    o = tfused.fused_rotary_flash(tq, tk, tv, tc, ts, torch.from_numpy(seg),
                                  H)
    tval = (o.float() * tw.float()).sum()
    tval.backward()
    gate = F32_FUSED
    if dtype == torch.float32:
        np.testing.assert_allclose(tval.item(), float(val), rtol=1e-5)
    for g, r in zip((tq.grad, tk.grad, tv.grad), ref):
        assert g.dtype == dtype
        _close(g, r, dtype, gate)


def _mask_layout(layout, T, rng):
    """Segment ids that exercise H2's per-tile mask test: ``one`` segment
    over all T (every tile unmasked) or ``interleaved``, non-monotonic
    ids (every tile masked, spans over the whole batch)."""
    if layout == 'one':
        return np.zeros(T, np.int32)
    return rng.integers(0, 3, T).astype(np.int32)


@pytest.mark.parametrize('path', ['K4', 'K5'])
@pytest.mark.parametrize('layout', ['one', 'interleaved'])
def test_flash_bwd_plain_matches_jax_on_mask_layouts(layout, path):
    """H2's plain version (the oracle of the Hopper kernel's masked and
    unmasked tiles) vs JAX in fp32 on the two segment layouts that
    decide the mask test: K4 through ``jax.vjp`` of
    ``flash_segment_attention``, K5 through the gradient of
    ``fused_rotary_flash`` with a job list (the port's side runs H3, H1,
    H2 and H3 inverse as plain versions)."""
    T, H, D = 1024, 2, 64
    rng = np.random.default_rng(11)
    seg = _mask_layout(layout, T, rng)
    segj, segt = jnp.asarray(seg), torch.from_numpy(seg)
    if path == 'K4':
        q, k, v, do = (jnp.asarray(rng.standard_normal((T, H, D)),
                                   jnp.float32) for _ in range(4))
        _, vjp = jax.vjp(lambda q, k, v: jflash.flash_segment_attention(
            q, k, v, segj, block_q=256, block_k=256), q, k, v)
        ref = [np.asarray(r).reshape(T, H * D) for r in vjp(do)]
        tq, tk, tv, tdo = (_to_torch(x, torch.float32).reshape(T, H * D)
                           for x in (q, k, v, do))
        spans = tflash.flash_spans(segt)
        o, lse = tflash.segment_flash_fwd(tq, tk, tv, segt, *spans[:2], H)
        delta = tflash.attention_delta(o, tdo, H)
        got = tflash.segment_flash_bwd_plain(tq, tk, tv, tdo, lse, delta,
                                             segt, *spans, H)
        gate = F32
    else:
        q2, k2, v2, w, cos, sin = _fused_inputs(T, H, D, torch.float32, 13)
        num_jobs = jflash.host_num_jobs(seg, 256, 256)

        def loss(q2, k2, v2):
            o = jfused.fused_rotary_flash(q2, k2, v2, cos, sin, segj, H, 256,
                                          256, None, True, num_jobs)
            return jnp.sum(o * w)

        ref = jax.grad(loss, argnums=(0, 1, 2))(q2, k2, v2)
        xs = [_to_torch(x, torch.float32).requires_grad_()
              for x in (q2, k2, v2)]
        tw, tc, ts = (_to_torch(x, torch.float32) for x in (w, cos, sin))
        (tfused.fused_rotary_flash(*xs, tc, ts, segt, H) * tw).sum() \
            .backward()
        got = [x.grad for x in xs]
        gate = F32_FUSED
    for g, r in zip(got, ref):
        _close(g, r, torch.float32, gate)


def test_fused_grad_spans_and_constants():
    """Spans computed inside or passed in give the same gradient, and
    cos, sin and seg_ids get none."""
    T, H, D = 512, 2, 32
    seg = torch.from_numpy(_seg([100, 300, 60], T))
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((T, H * D))
                                .astype(np.float32)) for _ in range(3))
    cos, sin = trot.rotary_cos_sin(torch.arange(T), D, dtype=torch.float32)
    cos.requires_grad_()
    grads = []
    for spans in (None, tflash.flash_spans(seg)):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        o = tfused.fused_rotary_flash(*xs, cos, sin, seg, H, spans=spans)
        o.square().sum().backward()
        grads.append([x.grad for x in xs])
        assert cos.grad is None
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_flash_bwd_wrapper_takes_the_plain_version_only_on_cpu():
    """A tensor on another device than the CPU goes to the kernel or
    raises; the plain version is never taken for it."""
    q = torch.empty((64, 32), dtype=torch.bfloat16, device='meta')
    seg = torch.empty(64, dtype=torch.int32, device='meta')
    lse = torch.empty((2, 64), device='meta')
    spans = [torch.empty(1, dtype=torch.int32, device='meta')] * 4
    with pytest.raises(ValueError, match='unsupported device'):
        tflash.segment_flash_bwd(q, q, q, q, lse, lse, seg, *spans, 2)
