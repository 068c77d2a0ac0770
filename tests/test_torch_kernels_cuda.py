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
* H4 (head relayout with optional RoPE): bit equality, for the same
  reason; a move without rotation copies the bits.
* ``segment_attention`` on the card: o under H1's gate, each gradient
  under H2's, against the same function through the plain versions.
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


# H4's moves as the ops make them: (sources, destinations, rotations) of
# the tensors of one launch. R = RoPE, RT = its transpose, N = none.
N, R, RT = headsplit.ROT_NONE, headsplit.ROT_R, headsplit.ROT_RT
RELAYOUTS = {
    'split (K11)': ('thd', 'htd', (R, R, N)),
    'split, R^T (K11)': ('thd', 'htd', (RT, RT, N)),
    'merge (K12, K13 back)': ('htd', 'thd', (N,)),
    'merge, R (K12)': ('htd', 'thd', (R,)),
    'merge, R^T (split back)': ('htd', 'thd', (RT, RT, N)),
    'split one (K13)': ('thd', 'htd', (N,)),
    'split_t (K7)': ('thd', ('htd', 'hdt', 'hdt'), (R, R, N)),
    'split_t q_minor (K8, K9)': ('thd', 'hdt', (R, R, N)),
    'merge_t, R^T (K10)': ('hdt', 'thd', (RT,)),
    'to thd (fwd_v2, flash_tm)': (('htd', 'hdt', 'hdt'), 'thd', (N, N, N)),
    'to hdt (flash_tm)': ('thd', 'hdt', (N,)),
}


def _relayout_inputs(src, n, T, H, D, dev, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    srcs = (src,) * n if isinstance(src, str) else src
    shapes = {'thd': (T, H * D), 'htd': (H, T, D), 'hdt': (H, D, T)}
    xs = [torch.randn(shapes[s], generator=gen, device=dev)
          .to(torch.bfloat16) for s in srcs]
    pos = torch.randint(0, 1024, (T,), generator=gen, device=dev)
    return xs, rotary_cos_sin(pos, D)


@pytest.mark.cuda
@pytest.mark.parametrize('T', [1000, 1001])     # ragged tile; T % 8 != 0
@pytest.mark.parametrize('D', [16, 24, 32, 64, 128])
@pytest.mark.parametrize('mode', sorted(RELAYOUTS))
def test_relayout_kernel_matches_plain(cuda, mode, D, T):
    """H4 is bit-equal to its plain version in every mode the ops use
    (the rotation rounds each product and each sum to bf16 as the plain
    version does; a move without rotation copies the bits)."""
    src, dst, rot = RELAYOUTS[mode]
    H = 3
    xs, (cos, sin) = _relayout_inputs(src, len(rot), T, H, D, cuda, D + T)
    x0 = [x.clone() for x in xs]
    before = headsplit.relayout_heads.launches
    got = headsplit.relayout_heads(xs, src, dst, H, rot, cos, sin)
    ref = headsplit.relayout_heads_plain(xs, src, dst, H, rot, cos, sin)
    torch.cuda.synchronize()
    assert headsplit.relayout_heads.launches == before + 1
    for a, b in zip(got, ref):
        assert a.shape == b.shape and torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(xs, x0))  # not in place


@pytest.mark.cuda
def test_relayout_kernel_refuses_what_it_does_not_take(cuda):
    xs, (cos, sin) = _relayout_inputs('thd', 1, 256, 2, 64, cuda, 0)
    with pytest.raises(TypeError, match='bf16'):
        headsplit.relayout_heads([xs[0].float()], 'thd', 'htd', 2)
    x48 = torch.zeros((256, 2 * 48), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match='head dim 48'):
        headsplit.relayout_heads([x48], 'thd', 'htd', 2)
    with pytest.raises(ValueError, match='cos must be'):
        headsplit.relayout_heads(xs, 'thd', 'htd', 2, R, cos[:-1], sin)
    with pytest.raises(ValueError, match='contiguous'):
        headsplit.relayout_heads([xs[0].T.contiguous().T], 'thd', 'htd', 2)


@pytest.mark.cuda
@pytest.mark.parametrize('layout', ['thd', 'htd'])
def test_segment_attention_grad_on_card(cuda, layout, monkeypatch):
    """``segment_attention(impl='flash')`` has a gradient on the card (H1
    forward, H2 backward, H4 around them for 'htd'), equal to the same
    function through the plain versions under the H1 and H2 gates."""
    from esme_tpu_torch.ops.attention import segment_attention
    T, H, D = 1700, 4, 64
    q, k, v, seg = _packed([1000, 513, 77], T, H, D, cuda, seed=5)
    shape = (T, H, D) if layout == 'thd' else (H, T, D)
    q, k, v = (x.view(T, H, D) if layout == 'thd'
               else x.view(T, H, D).transpose(0, 1).contiguous()
               for x in (q, k, v))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(6)
    w = torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)

    def run():
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        o = segment_attention(*xs, seg, impl='flash', layout=layout)
        assert o.shape == shape and o.grad_fn is not None
        (o.float() * w.float()).sum().backward()
        return o.detach(), [x.grad for x in xs]

    counters = (flash.segment_flash_fwd, flash.segment_flash_bwd,
                headsplit.relayout_heads)
    before = [f.launches for f in counters]
    o, got = run()
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == \
        ([1, 1, 0] if layout == 'thd' else [1, 1, 4])
    monkeypatch.setattr(flash, 'segment_flash_fwd',
                        flash.segment_flash_fwd_plain)
    monkeypatch.setattr(flash, 'segment_flash_bwd',
                        flash.segment_flash_bwd_plain)
    monkeypatch.setattr(headsplit, 'relayout_heads',
                        headsplit.relayout_heads_plain)
    o_p, ref = run()
    gate = O_REL * o_p.float().abs().clamp_min(O_FLOOR)
    assert ((o.float() - o_p.float()).abs() <= gate).all()
    for a, b in zip(got, ref):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all()
        b = b.float()
        gate = G_REL * b.abs().clamp_min(b.square().mean().sqrt())
        assert ((a.float() - b).abs() <= gate).all()
