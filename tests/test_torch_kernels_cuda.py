"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA card and skips without one.

This file imports no JAX, so it also runs on a machine without it:
``python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q``.

Gates:
* H1 (segment-flash forward), bf16 inputs: |o - o_plain| within
  2^-6 * max(|o_plain|, 1/4), two to four bf16 ulps of |o| for
  |o| >= 1/4 and 3.9e-3 below it (each output is rounded to bf16, and
  the kernel rounds p to bf16 against the running row max where the
  plain version uses the final one: up to one ulp of the larger value
  apart, plus a small absolute part); lse within 1e-4 (both fp32,
  summed in another order).
* H2 (segment-flash backward), bf16 inputs: |g - g_plain| within
  2^-4 * max(|g_plain|, rms(g_plain)) for each of dq, dk, dv: p and ds
  are rounded to bf16 before their products, and where the kernel's
  fp32 ds and the plain version's differ in their last bits the two
  roundings can land on neighbouring bf16 values; one such flip of a
  large ds term moves one gradient element by up to ~2^-8·|ds|·|k|
  (measured up to 0.019·rms(g) at 8k tokens, see ``chip_smoke.py``).
* H3 (RoPE): bit equality; the kernel rounds each product and each sum
  to bf16 as the plain version does.
"""

import numpy as np
import pytest
import torch

from esme_tpu_torch.ops import flash, fused_attn, headsplit
from esme_tpu_torch.ops.rotary import rotary_cos_sin
from esme_tpu_torch.ops.segment import segment_ids_from_cu_lens

O_REL, O_FLOOR, LSE_ATOL = 2.0 ** -6, 0.25, 1e-4
G_REL = 2.0 ** -4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (the kernel has no CPU mode)')
    return torch.device('cuda')


def _packed(lens, total, H, D, dev, seed=0):
    rng = np.random.default_rng(seed)
    cu = torch.from_numpy(np.cumsum([0, *lens]).astype(np.int32))
    seg = segment_ids_from_cu_lens(cu, total).to(dev)
    q, k, v = (torch.from_numpy(rng.standard_normal((total, H * D))
                                .astype(np.float32)).to(dev)
               .to(torch.bfloat16) for _ in range(3))
    return q, k, v, seg


@pytest.mark.cuda
@pytest.mark.parametrize('D', [16, 24, 32, 64, 128])
@pytest.mark.parametrize('lens,total', [
    ([30, 7, 250, 900, 2, 400, 1000], 3072),   # ALIGN multiple, a tail
    ([1000, 513, 77], 1700),                   # ragged last tile
])
def test_flash_kernel_matches_plain(cuda, D, lens, total):
    H = 4
    q, k, v, seg = _packed(lens, total, H, D, cuda, seed=D)
    ks, ke = flash.block_spans(seg, flash.BLOCK_Q, flash.BLOCK_K)
    before = flash.segment_flash_fwd.launches
    o, lse = flash.segment_flash_fwd(q, k, v, seg, ks, ke, H)
    o_p, lse_p = flash.segment_flash_fwd_plain(q, k, v, seg, ks, ke, H)
    torch.cuda.synchronize()
    assert flash.segment_flash_fwd.launches == before + 1
    assert o.dtype == torch.bfloat16 and lse.shape == (H, total)
    gate = O_REL * o_p.float().abs().clamp_min(O_FLOOR)
    assert ((o.float() - o_p.float()).abs() <= gate).all()
    assert (lse - lse_p).abs().max().item() <= LSE_ATOL


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, seg = _packed([100, 28], 128, 2, 64, cuda)
    ks, ke = flash.block_spans(seg, flash.BLOCK_Q, flash.BLOCK_K)
    with pytest.raises(TypeError, match='bf16'):
        flash.segment_flash_fwd(q.float(), k.float(), v.float(), seg, ks,
                                ke, 2)
    q48, k48, v48, _ = _packed([100, 28], 128, 2, 48, cuda)
    with pytest.raises(ValueError, match='head dim 48'):
        flash.segment_flash_fwd(q48, k48, v48, seg, ks, ke, 2)


@pytest.mark.cuda
@pytest.mark.parametrize('D', [16, 24, 32, 64, 128])
@pytest.mark.parametrize('lens,total', [
    ([30, 7, 250, 900, 2, 400, 1000], 3072),   # ALIGN multiple, a tail
    ([1000, 513, 77], 1700),                   # ragged last tiles
])
def test_flash_bwd_kernel_matches_plain(cuda, D, lens, total):
    H = 4
    q, k, v, seg = _packed(lens, total, H, D, cuda, seed=D)
    spans = flash.flash_spans(seg)
    o, lse = flash.segment_flash_fwd(q, k, v, seg, *spans[:2], H)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(D + 1)
    do = torch.randn(q.shape, generator=gen, device=cuda).to(torch.bfloat16)
    delta = flash.attention_delta(o, do, H)
    before = flash.segment_flash_bwd.launches
    got = flash.segment_flash_bwd(q, k, v, do, lse, delta, seg, *spans, H)
    ref = flash.segment_flash_bwd_plain(q, k, v, do, lse, delta, seg,
                                        *spans, H)
    torch.cuda.synchronize()
    assert flash.segment_flash_bwd.launches == before + 1
    for a, b in zip(got, ref):
        assert a.dtype == torch.bfloat16 and a.shape == q.shape
        b = b.float()
        gate = G_REL * b.abs().clamp_min(b.square().mean().sqrt())
        assert torch.isfinite(a.float()).all()
        assert ((a.float() - b).abs() <= gate).all()


@pytest.mark.cuda
def test_flash_bwd_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, seg = _packed([100, 28], 128, 2, 64, cuda)
    spans = flash.flash_spans(seg)
    lse = torch.zeros((2, 128), device=cuda)
    with pytest.raises(TypeError, match='bf16'):
        flash.segment_flash_bwd(q.float(), k.float(), v.float(), q.float(),
                                lse, lse, seg, *spans, 2)
    with pytest.raises(ValueError, match='qstart'):
        flash.segment_flash_bwd(q, k, v, q, lse, lse, seg, *spans[:2],
                                spans[2][:-1], spans[3], 2)


@pytest.mark.cuda
def test_fused_rotary_flash_grad_kernels_match_plain(cuda, monkeypatch):
    """The autograd boundary on the card: forward H3 + H1, backward H2 +
    H3 inverse (one launch each), against the same function through the
    plain versions, under the H2 gate."""
    T, H, D = 3072, 4, 64
    q, k, v, seg = _packed([30, 7, 250, 900, 2, 400, 1000], T, H, D, cuda)
    cos, sin = rotary_cos_sin(torch.arange(T, device=cuda) % 1000, D)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    w = torch.randn(q.shape, generator=gen, device=cuda).to(torch.bfloat16)
    spans = flash.flash_spans(seg)

    def grads():
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        o = fused_attn.fused_rotary_flash(*xs, cos, sin, seg, H, spans=spans)
        (o.float() * w.float()).sum().backward()
        return [x.grad for x in xs]

    before = (flash.segment_flash_fwd.launches,
              flash.segment_flash_bwd.launches,
              headsplit.rotary_qk.launches,
              headsplit.rotary_qk.inverse_launches)
    got = grads()
    torch.cuda.synchronize()
    after = (flash.segment_flash_fwd.launches,
             flash.segment_flash_bwd.launches,
             headsplit.rotary_qk.launches,
             headsplit.rotary_qk.inverse_launches)
    assert [b - a for a, b in zip(before, after)] == [1, 1, 2, 1]
    monkeypatch.setattr(fused_attn, 'rotary_qk', headsplit.rotary_qk_plain)
    monkeypatch.setattr(fused_attn, 'segment_flash_fwd',
                        flash.segment_flash_fwd_plain)
    monkeypatch.setattr(fused_attn, 'segment_flash_bwd',
                        flash.segment_flash_bwd_plain)
    ref = grads()
    for a, b in zip(got, ref):
        b = b.float()
        gate = G_REL * b.abs().clamp_min(b.square().mean().sqrt())
        assert ((a.float() - b).abs() <= gate).all()


@pytest.mark.cuda
@pytest.mark.parametrize('D', [16, 24, 64, 128])
@pytest.mark.parametrize('inverse', [False, True])
def test_rope_kernel_matches_plain(cuda, D, inverse):
    T, H = 4096, 20
    gen = torch.Generator(device=cuda)
    gen.manual_seed(D)
    q, k = (torch.randn((T, H * D), generator=gen, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    q0, k0 = q.clone(), k.clone()
    pos = torch.randint(0, 1024, (T,), generator=gen, device=cuda)
    cos, sin = rotary_cos_sin(pos, D)
    got = headsplit.rotary_qk(q, k, cos, sin, H, inverse=inverse)
    ref = headsplit.rotary_qk_plain(q, k, cos, sin, H, inverse=inverse)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert torch.equal(q, q0) and torch.equal(k, k0)   # not in place
