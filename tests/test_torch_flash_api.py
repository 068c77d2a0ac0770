"""Port's attention op API vs the JAX package: ``flash_segment_attention``
(``'thd'`` and ``'htd'``), ``flash_tm``, ``segment_attention`` (both
impls, both layouts) with their gradients against ``jax.vjp`` through
the Pallas kernels in interpret mode; ``fwd_v2`` against JAX's
``fwd_v2(interpret=True)`` (K6); and the steps of JAX's
``ESME_FLASH_IMPL=v2`` route, ``_split_call_t`` -> ``fwd_v2`` ->
``_merge_call``, against ``fused_rotary_flash``'s forward.

On the CPU the kernels' wrappers run their plain versions (H1, H2, H4).
Gates, those of ``tests/test_torch_flash.py`` and
``tests/test_torch_flash_bwd.py``: fp32 o and lse atol 2e-5 / rtol 1e-4
(both sides compute the same fp32 online softmax; only summation order
differs), fp32 gradients atol 5e-5 / rtol 1e-3 (the JAX suite's own
gate, ``tests/test_flash.py:85-86``); bf16 |Δ| ≤ 2^-5·max|ref| and mean
|Δ| ≤ 2^-8·mean|ref| per tensor (both sides round p and ds to bf16
before their products, but the rounding points of XLA's fused chains
differ). Relayouts are copies and add nothing to the error.
"""

import math

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

# ``pltpu.emit_pipeline`` (used by flash_v2) queries the TPU hardware
# registry even in interpret mode; on the CPU test backend the device
# kind 'cpu' is unknown. Register v5e parameters for it — the interpret
# path only reads tiling/VMEM constants. (A copy of the shim in
# tests/test_flash_v2.py.)
from jax._src.pallas.mosaic import tpu_info as _tpu_info

if 'cpu' not in _tpu_info.registry:
    _tpu_info.registry['cpu'] = lambda: _tpu_info.TpuInfo(
        chip_version=_tpu_info.ChipVersion.TPU_V5E,
        generation=5, num_cores=1, num_lanes=128, num_sublanes=8,
        mxu_column_size=128, vmem_capacity_bytes=128 * 1024 * 1024,
        cmem_capacity_bytes=0, smem_capacity_bytes=1024 * 1024,
        hbm_capacity_bytes=17_200_000_000,
        mem_bw_bytes_per_second=int(8.20e11),
        bf16_ops_per_second=int(1.97e14),
        int8_ops_per_second=int(3.94e14),
        fp8_ops_per_second=0, int4_ops_per_second=int(7.88e14))

from esme_tpu.ops import attention as jattn
from esme_tpu.ops import flash as jflash
from esme_tpu.ops import rotary as jrot
from esme_tpu.ops import segment as jseg
from esme_tpu.ops.flash_v2 import fwd_v2 as jfwd_v2

from esme_tpu_torch.ops import attention as tattn
from esme_tpu_torch.ops import flash as tflash
from esme_tpu_torch.ops import fused_attn as tfused
from esme_tpu_torch.ops import headsplit as ths
from esme_tpu_torch.ops.flash_v2 import fwd_v2 as tfwd_v2

F32_O = dict(atol=2e-5, rtol=1e-4)
F32_G = dict(atol=5e-5, rtol=1e-3)
BF16_MAX, BF16_MEAN = 2.0 ** -5, 2.0 ** -8


def _seg(lens, T):
    cu = np.cumsum([0, *lens]).astype(np.int32)
    return np.array(jseg.segment_ids_from_cu_lens(jnp.asarray(cu), T))


def _arrays(shape, n, dtype, seed):
    rng = np.random.default_rng(seed)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xs = [jnp.asarray(rng.standard_normal(shape), jdt) for _ in range(n)]
    return xs, [torch.from_numpy(np.array(x.astype(jnp.float32))).to(dtype)
                for x in xs]


def _close(got, ref, dtype, gate):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, **gate)
        return
    d = np.abs(got - ref)
    assert d.max() <= BF16_MAX * np.abs(ref).max()
    assert d.mean() <= BF16_MEAN * np.abs(ref).mean()


def _grads(fn, xs, w):
    """o and the gradients of ``sum(o * w)`` of the port's ``fn``."""
    xs = [x.clone().requires_grad_() for x in xs]
    o = fn(*xs)
    (o.float() * w.float()).sum().backward()
    return o, [x.grad for x in xs]


# T = 700 is not a multiple of 256 (JAX pads it with a segment of its
# own); T = 768 is
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('layout', ['thd', 'htd'])
@pytest.mark.parametrize('T,lens', [(700, [100, 250, 134, 200]),
                                    (768, [100, 150, 134, 300])])
def test_flash_segment_attention_matches_jax(T, lens, layout, dtype):
    H, D = 2, 32
    seg = _seg(lens, T)
    shape = (T, H, D) if layout == 'thd' else (H, T, D)
    (q, k, v, w), (tq, tk, tv, tw) = _arrays(shape, 4, dtype, T)
    segj = jnp.asarray(seg)
    o, vjp = jax.vjp(lambda q, k, v: jflash.flash_segment_attention(
        q, k, v, segj, layout=layout), q, k, v)
    ref = vjp(w)

    before = (tflash.segment_flash_fwd.launches,
              ths.relayout_heads.launches)
    got_o, got = _grads(lambda q, k, v: tflash.flash_segment_attention(
        q, k, v, torch.from_numpy(seg), layout=layout), (tq, tk, tv), tw)
    assert (tflash.segment_flash_fwd.launches,
            ths.relayout_heads.launches) == before    # no kernel here
    _close(got_o, np.asarray(o.astype(jnp.float32)), dtype, F32_O)
    for g, r in zip(got, ref):
        assert g.dtype == dtype
        _close(g, np.asarray(r.astype(jnp.float32)), dtype, F32_G)


def test_flash_tm_matches_jax():
    T, H, D = 768, 2, 64
    seg = _seg([300, 41, 250, 60], T)
    (q, k, v, w), (tq, tk, tv, tw) = _arrays((H, D, T), 4, torch.float32, 3)
    segj = jnp.asarray(seg)
    o, vjp = jax.vjp(lambda q, k, v: jflash.flash_tm(
        q, k, v, segj, 256, 256, None, True), q, k, v)
    ref = vjp(w)
    got_o, got = _grads(lambda q, k, v: tflash.flash_tm(
        q, k, v, torch.from_numpy(seg), tflash.BLOCK_Q, tflash.BLOCK_K,
        None, None), (tq, tk, tv), tw)
    assert got_o.shape == (H, D, T)
    _close(got_o, o, torch.float32, F32_O)
    for g, r in zip(got, ref):
        _close(g, r, torch.float32, F32_G)


@pytest.mark.parametrize('impl', ['reference', 'flash'])
@pytest.mark.parametrize('layout', ['thd', 'htd'])
def test_segment_attention_matches_jax(impl, layout):
    """The repaired dispatch: both impls and both layouts, with a
    gradient, against JAX's ``segment_attention`` (which runs the einsum
    reference, or K1 and K4 in interpret mode)."""
    T, H, D = 512, 2, 16
    seg = _seg([100, 300, 60], T)
    shape = (T, H, D) if layout == 'thd' else (H, T, D)
    (q, k, v, w), (tq, tk, tv, tw) = _arrays(shape, 4, torch.float32, 9)
    segj = jnp.asarray(seg)
    o, vjp = jax.vjp(lambda q, k, v: jattn.segment_attention(
        q, k, v, segj, impl=impl, layout=layout), q, k, v)
    ref = vjp(w)
    got_o, got = _grads(lambda q, k, v: tattn.segment_attention(
        q, k, v, torch.from_numpy(seg), impl=impl, layout=layout),
        (tq, tk, tv), tw)
    _close(got_o, o, torch.float32, F32_O)
    for g, r in zip(got, ref):
        _close(g, r, torch.float32, F32_G)


def test_flash_api_takes_only_the_kernel_tiles():
    q = torch.zeros(256, 2, 16)
    seg = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match='128x64, not 256x256'):
        tflash.flash_segment_attention(q, q, q, seg, block_q=256,
                                       block_k=256)
    with pytest.raises(ValueError, match='128x64, not 256x256'):
        tattn.segment_attention(q, q, q, seg, impl='flash', block_q=256,
                                block_k=256)
    with pytest.raises(ValueError, match='128x64, not 256x256'):
        tflash.flash_tm(q, q, q, seg, 256, 256, None, None)
    with pytest.raises(ValueError, match='unknown layout'):
        tflash.flash_segment_attention(q, q, q, seg, layout='hdt')


@pytest.mark.parametrize('block_k', [256, 512])
def test_fwd_v2_matches_jax(block_k):
    """The port's ``fwd_v2`` (H4, H1 at its own tiles, H4) against JAX's
    K6 in interpret mode, with JAX's spans at JAX's tiles (which the port
    accepts and does not use) and a scale that is not 1/sqrt(D)."""
    T, H, D, bq = 1024, 4, 64, 256
    seg = _seg([200, 57, 380, 150, 111], T)
    (q, k, v), (tq, tk, tv) = _arrays((H, T, D), 3, torch.float32, block_k)
    segj = jnp.asarray(seg)
    kstart, kend, _, _ = jflash.block_spans(segj, bq, block_k)
    kw = dict(block_q=bq, block_k=block_k, head_block=2, scale=0.1)
    o, lse = jfwd_v2(q, jnp.swapaxes(k, 1, 2), jnp.swapaxes(v, 1, 2),
                     segj.reshape(T, 1), segj.reshape(1, T), kstart, kend,
                     interpret=True, **kw)
    segt = torch.from_numpy(seg)
    got_o, got_lse = tfwd_v2(tq, tk.transpose(1, 2).contiguous(),
                             tv.transpose(1, 2).contiguous(),
                             segt.reshape(T, 1), segt.reshape(1, T),
                             torch.from_numpy(np.array(kstart)),
                             torch.from_numpy(np.array(kend)),
                             interpret=None, **kw)
    assert got_o.shape == (H, T, D) and got_lse.shape == (H, T, 1)
    assert got_lse.dtype == torch.float32
    _close(got_o, o, torch.float32, F32_O)
    _close(got_lse, lse, torch.float32, F32_O)


def _v2_steps_and_default(dtype, seed):
    """o and lse of ``fused_rotary_flash``'s forward and of JAX's v2 steps
    composed, on the same inputs."""
    T, H, D = 512, 2, 32
    seg = torch.from_numpy(_seg([100, 300, 60], T))
    _, (q, k, v) = _arrays((T, H * D), 3, dtype, seed)
    cos, sin = (torch.from_numpy(np.array(x)).to(dtype)
                for x in jrot.rotary_cos_sin(jnp.arange(T) % 300, D,
                                             dtype=jnp.float32))
    spans = tflash.flash_spans(seg)
    _, _, o, lse = tfused._forward(q, k, v, cos, sin, seg, H, spans)
    qh, kT, vT = ths._split_call_t(q, k, v, cos, sin, H)
    o2, lse2 = tfwd_v2(qh, kT, vT, seg.reshape(T, 1), seg.reshape(1, T),
                       spans[0], spans[1], block_q=tflash.BLOCK_Q,
                       block_k=tflash.BLOCK_K, head_block=H,
                       scale=1.0 / math.sqrt(D), interpret=None)
    o2 = ths._merge_call(o2, None, None, False, False)
    return (o, lse), (o2, lse2[..., 0])


def test_v2_route_pieces_match_the_default_route():
    """JAX's v2 route, ``_split_call_t`` -> ``fwd_v2`` -> ``_merge_call``,
    composed, gives ``fused_rotary_flash``'s o and lse (fp32 gates)."""
    (o, lse), (o2, lse2) = _v2_steps_and_default(torch.float32, 22)
    np.testing.assert_allclose(o2.numpy(), o.numpy(), **F32_O)
    np.testing.assert_allclose(lse2.numpy(), lse.numpy(), **F32_O)


def test_v2_route_pieces_in_bf16_are_the_default_route_bit_for_bit():
    """In bf16 the split's rotation rounds as ``rotary_qk``'s does and the
    relayouts copy bits, so the flash forward sees the same q, k and v:
    o and lse are equal bit for bit."""
    (o, lse), (o2, lse2) = _v2_steps_and_default(torch.bfloat16, 23)
    assert o2.dtype == torch.bfloat16
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
