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
  Held on both of H1's routes (the Hopper form at D = 32, 64, 128, the
  mma.sync form at 16, 24) and on one segment, 1-70-token segments and
  interleaved ids, so on masked and unmasked tiles; the Hopper form is
  also bit-equal from call to call.
* H2 (segment-flash backward), bf16 inputs: |g - g_plain| within
  2^-4 * max(|g_plain|, rms(g_plain)) for each of dq, dk, dv: p and ds
  are rounded to bf16 before their products, and where the kernel's
  fp32 ds and the plain version's differ in their last bits the two
  roundings can land on neighbouring bf16 values; one such flip of a
  large ds term moves one gradient element by up to ~2^-8·|ds|·|k|
  (measured up to 0.019·rms(g) at 8k tokens, see ``chip_smoke.py``).
  Held on both of H2's routes (the Hopper form at D = 32, 64, 128, the
  mma.sync form at 16, 24) and on one segment, 1-70-token segments and
  interleaved ids, so on masked and unmasked tiles; the Hopper form is
  also bit-equal from call to call and pass by pass.
* H3 (RoPE): bit equality; the kernel rounds each product and each sum
  to bf16 as the plain version does.
* H4 (head relayout with optional RoPE): bit equality, for the same
  reason; a move without rotation copies the bits. Held on the kernel
  its rule picks (rows, vec or tile, shown by its counter) and on the
  tile and vec kernels by name.
* ``segment_attention`` on the card: o under H1's gate, each gradient
  under H2's, against the same function through the plain versions.
* The probe tools' kernels (``esme_tpu_torch/tools``): H5 on each route
  under H1's gates against its plain version and against H1, its Hopper
  form (H1's kernel on token-minor operands) also on the segment layouts
  of H1's tests, bit-equal to H1 there and from call to call; each
  ablation mode of both forms of H1 (H6) and of H2 (H7), and each ceiling
  probe (H8), under the gate its tool's ``check`` states; H6 ``baseline``
  and H7 ``real`` bit-equal to H1 and H2 (the same instantiations); the
  2^x that H6 ``bf16exp``'s plain version takes bit-equal to the
  instruction the kernel uses.
"""

import numpy as np
import pytest
import torch

from esme_tpu_torch.ops import flash, fused_attn, headsplit
from esme_tpu_torch.ops.rotary import rotary_cos_sin
from esme_tpu_torch.ops.segment import segment_ids_from_cu_lens
from esme_tpu_torch.tools import decompose_bwd as tdb
from esme_tpu_torch.tools import flash_variants as tfv
from esme_tpu_torch.tools import fwd_T_experiment as tft
from esme_tpu_torch.tools import profile_attn as tpa

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


def _fwd_args(seg, H, D, dev, seed):
    """Random q, k, v over ``seg`` and H1's spans."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((seg.shape[0], H * D))
                                .astype(np.float32)).to(dev)
               .to(torch.bfloat16) for _ in range(3))
    return (q, k, v, seg, *flash.flash_spans(seg)[:2], H)


@pytest.mark.cuda
@pytest.mark.parametrize('layout', ['one', 'short', 'interleaved'])
@pytest.mark.parametrize('T', [1000, 1001, 8192])
@pytest.mark.parametrize('D', [16, 24, 32, 64, 128])
def test_flash_fwd_routes_match_plain_on_mask_layouts(cuda, D, T, layout):
    """H1 (the Hopper form at D = 32, 64, 128; the mma.sync form at 16, 24)
    against its plain version on masked and unmasked tiles (segment
    layouts of ``_bwd_seg``), under H1's gates."""
    args = _fwd_args(_bwd_seg(layout, T, cuda, T), 2, D, cuda, D + T)
    before = flash.segment_flash_fwd.launches
    o, lse = flash.segment_flash_fwd(*args)
    o_p, lse_p = flash.segment_flash_fwd_plain(*args)
    torch.cuda.synchronize()
    assert flash.segment_flash_fwd.launches == before + 1
    assert o.dtype == torch.bfloat16 and torch.isfinite(o.float()).all()
    gate = O_REL * o_p.float().abs().clamp_min(O_FLOOR)
    assert ((o.float() - o_p.float()).abs() <= gate).all()
    assert (lse - lse_p).abs().max().item() <= LSE_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize('D', [32, 64, 128])
def test_flash_fwd_sm90_is_deterministic(cuda, D):
    """Two calls of H1's Hopper form give bit-equal o and lse (no atomics),
    the same bits as its C entry called directly, and its outputs stay
    under H1's gates against the mma.sync form."""
    seg = _bwd_seg('short', 4096, cuda, 1)
    seg = torch.cat([seg[:2048], 100 + torch.arange(2048, device=cuda) // 500]
                    ).to(torch.int32)
    args = _fwd_args(seg, 2, D, cuda, D)
    first = flash.segment_flash_fwd(*args)
    assert all(map(torch.equal, first, flash.segment_flash_fwd(*args)))
    assert all(map(torch.equal, first,
                   flash.launch_fwd('flash_fwd_sm90', *args)))
    o_m, lse_m = flash.launch_fwd('flash_fwd', *args)
    torch.cuda.synchronize()
    gate = O_REL * o_m.float().abs().clamp_min(O_FLOOR)
    assert ((first[0].float() - o_m.float()).abs() <= gate).all()
    assert (first[1] - lse_m).abs().max().item() <= LSE_ATOL


@pytest.mark.cuda
def test_flash_fwd_sm90_refuses_what_it_does_not_take(cuda):
    """The wrapper's checks hold on the Hopper route (dtype, shape,
    alignment, device), and its C entry refuses a head dim it was not
    built for."""
    import ctypes
    from esme_tpu_torch import _build
    args = list(_fwd_args(_bwd_seg('one', 256, cuda, 0), 2, 64, cuda, 0))
    assert flash.fwd_route(64) == 'flash_fwd_sm90'
    with pytest.raises(TypeError, match='bf16'):
        flash.segment_flash_fwd(*(x.float() for x in args[:3]), *args[3:])
    with pytest.raises(ValueError, match='16-byte aligned'):
        q = torch.empty(256 * 128 + 4, dtype=torch.bfloat16,
                        device=cuda)[4:].view(256, 128)
        flash.segment_flash_fwd(q, *args[1:])
    with pytest.raises(ValueError, match='must be a contiguous'):
        flash.segment_flash_fwd(args[0], args[1][:, :64].contiguous(),
                                *args[2:])
    with pytest.raises(ValueError, match='must be a contiguous'):
        flash.segment_flash_fwd(args[0], args[1].cpu(), *args[2:])
    with pytest.raises(ValueError, match='kstart'):
        flash.segment_flash_fwd(*args[:4], args[4][:-1], args[5], 2)
    lib = _build.library('flash_fwd_sm90')
    o, lse = torch.empty_like(args[0]), torch.empty((2, 256), device=cuda)
    ptrs = [x.data_ptr() for x in (*args[:6], o, lse)]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for D in (16, 24, 48):
        assert lib.esme_segment_flash_fwd_sm90(*ptrs, 256, 2, D, 0.1,
                                               stream) != 0


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


# Segment layouts that decide H1's and H2's per-tile mask test: one segment over
# all T (every tile unmasked), 1-70-token segments (every tile masked) and
# interleaved, non-monotonic ids (every tile masked, spans over the batch)
def _bwd_seg(layout, T, dev, seed):
    rng = np.random.default_rng(seed)
    if layout == 'one':
        ids = np.zeros(T, np.int32)
    elif layout == 'short':
        lens = rng.integers(1, 71, T)
        ids = np.repeat(np.arange(T), lens)[:T]
    else:
        ids = rng.integers(0, 3, T)
    return torch.from_numpy(ids.astype(np.int32)).to(dev)


def _bwd_inputs(seg, H, D, dev, seed):
    """Random q, k, v, do, lse and delta from H1's plain version."""
    T = seg.shape[0]
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((T, H * D))
                                    .astype(np.float32)).to(dev)
                   .to(torch.bfloat16) for _ in range(4))
    spans = flash.flash_spans(seg)
    o, lse = flash.segment_flash_fwd_plain(q, k, v, seg, *spans[:2], H)
    return (q, k, v, do, lse, flash.attention_delta(o, do, H), seg, *spans,
            H)


@pytest.mark.cuda
@pytest.mark.parametrize('layout', ['one', 'short', 'interleaved'])
@pytest.mark.parametrize('T', [1000, 1001, 8192])
@pytest.mark.parametrize('D', [16, 24, 32, 64, 128])
def test_flash_bwd_routes_match_plain_on_mask_layouts(cuda, D, T, layout):
    """H2 (the Hopper form at D = 32, 64, 128; the mma.sync form at 16, 24)
    against its plain version on masked and unmasked tiles, under the H2
    gate."""
    args = _bwd_inputs(_bwd_seg(layout, T, cuda, T), 2, D, cuda, D + T)
    before = flash.segment_flash_bwd.launches
    got = flash.segment_flash_bwd(*args)
    ref = flash.segment_flash_bwd_plain(*args)
    torch.cuda.synchronize()
    assert flash.segment_flash_bwd.launches == before + 1
    for a, b in zip(got, ref):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all()
        b = b.float()
        gate = G_REL * b.abs().clamp_min(b.square().mean().sqrt())
        assert ((a.float() - b).abs() <= gate).all()


@pytest.mark.cuda
@pytest.mark.parametrize('D', [32, 64, 128])
def test_flash_bwd_sm90_is_deterministic(cuda, D):
    """Two calls of the Hopper form give bit-equal dq, dk and dv (no
    atomics), and each of its passes alone (dk/dv, dq) gives the same bits
    as the pair."""
    import ctypes
    from esme_tpu_torch import _build
    seg = _bwd_seg('short', 4096, cuda, 1)
    seg = torch.cat([seg[:2048], 100 + torch.arange(2048, device=cuda) // 500]
                    ).to(torch.int32)
    args = _bwd_inputs(seg, 2, D, cuda, D)
    first = flash.segment_flash_bwd(*args)
    again = flash.segment_flash_bwd(*args)
    assert all(map(torch.equal, first, again))
    lib = _build.library('flash_bwd_sm90')
    for which in (0, 1):
        outs = [torch.zeros_like(args[0]) for _ in range(3)]
        ptrs = [x.data_ptr() for x in (*args[:11], *outs)]
        rc = lib.esme_flash_bwd_sm90_pass(
            which, 0, *ptrs, 4096, 2, D, D ** -0.5,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        assert rc == 0
        torch.cuda.synchronize()
        for i in ((1, 2) if which == 0 else (0,)):
            assert torch.equal(outs[i], first[i])


@pytest.mark.cuda
def test_flash_bwd_sm90_refuses_what_it_does_not_take(cuda):
    """The wrapper's checks hold on the Hopper route, and its C entries
    refuse a head dim or pass they were not built for."""
    import ctypes
    from esme_tpu_torch import _build
    args = list(_bwd_inputs(_bwd_seg('one', 256, cuda, 0), 2, 64, cuda, 0))
    assert flash.bwd_route(64) == 'flash_bwd_sm90'
    with pytest.raises(ValueError, match='16-byte aligned'):
        q = torch.empty(256 * 128 + 4, dtype=torch.bfloat16,
                        device=cuda)[4:].view(256, 128)
        flash.segment_flash_bwd(q, *args[1:])
    with pytest.raises(ValueError, match='lse'):
        flash.segment_flash_bwd(*args[:4], args[4][:, :-1].contiguous(),
                                *args[5:])
    with pytest.raises(TypeError, match='bf16'):
        flash.segment_flash_bwd(*(x.float() for x in args[:4]), *args[4:])
    lib = _build.library('flash_bwd_sm90')
    outs = [torch.empty_like(args[0]) for _ in range(3)]
    ptrs = [x.data_ptr() for x in (*args[:11], *outs)]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for D in (16, 24, 48):
        assert lib.esme_segment_flash_bwd_sm90(*ptrs, 256, 2, D, 0.1,
                                               stream) != 0
    assert lib.esme_flash_bwd_sm90_pass(2, 0, *ptrs, 256, 2, 64, 0.1,
                                        stream) != 0
    assert lib.esme_flash_bwd_sm90_pass(0, 0, *ptrs, 256, 2, 48, 0.1,
                                        stream) != 0
    # the ablation modes are built at D = 64 only, and there are eight
    assert lib.esme_flash_bwd_sm90_pass(0, 1, *ptrs, 256, 2, 128, 0.1,
                                        stream) != 0
    assert lib.esme_flash_bwd_sm90_pass(1, len(tdb.MODES), *ptrs, 256, 2,
                                        64, 0.1, stream) != 0


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
@pytest.mark.parametrize('T', [1000, 1001])     # T % 64 != 0; T % 8 != 0
@pytest.mark.parametrize('D', [16, 24, 32, 64, 128])
@pytest.mark.parametrize('mode', sorted(RELAYOUTS))
def test_relayout_kernel_matches_plain(cuda, mode, D, T):
    """H4 is bit-equal to its plain version in every mode the ops use
    (the rotation rounds each product and each sum to bf16 as the plain
    version does; a move without rotation copies the bits), on the route
    its rule picks (a move with an hdt side: the vec kernel at T = 1000,
    the tile kernel at 1001), as the route counter shows."""
    src, dst, rot = RELAYOUTS[mode]
    H = 3
    xs, (cos, sin) = _relayout_inputs(src, len(rot), T, H, D, cuda, D + T)
    x0 = [x.clone() for x in xs]
    route = headsplit.relayout_route(src, dst, T)
    sides = [x for side in (src, dst)
             for x in ((side,) if isinstance(side, str) else side)]
    assert route == ('rows' if 'hdt' not in sides
                     else 'vec' if T % 8 == 0 else 'tile')
    before = headsplit.relayout_heads.launches
    on_route = dict(headsplit.relayout_heads.routes)
    got = headsplit.relayout_heads(xs, src, dst, H, rot, cos, sin)
    ref = headsplit.relayout_heads_plain(xs, src, dst, H, rot, cos, sin)
    torch.cuda.synchronize()
    assert headsplit.relayout_heads.launches == before + 1
    assert {n: c - on_route[n] for n, c in
            headsplit.relayout_heads.routes.items()} == \
        {n: int(n == route) for n in headsplit.RELAYOUT_ROUTES}
    for a, b in zip(got, ref):
        assert a.shape == b.shape and torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(xs, x0))  # not in place


@pytest.mark.cuda
@pytest.mark.parametrize('T', [1000, 2048])     # a ragged last tile; none
@pytest.mark.parametrize('D', [16, 24, 32, 64, 128])
@pytest.mark.parametrize('mode', sorted(RELAYOUTS))
def test_relayout_kernels_by_name_match_plain(cuda, mode, D, T):
    """Launched by name at T % 8 == 0, the tile kernel (the vec kernel's
    yardstick) and the vec kernel are both bit-equal to the plain version
    in every mode, with a ragged last 64-token tile (T = 1000) and
    without; the C entry refuses vec at T % 8 != 0 and rows where a move
    has an hdt side."""
    src, dst, rot = RELAYOUTS[mode]
    H = 3
    xs, (cos, sin) = _relayout_inputs(src, len(rot), T, H, D, cuda, D + T)
    ref = headsplit.relayout_heads_plain(xs, src, dst, H, rot, cos, sin)
    before = headsplit.relayout_heads.launches
    for route in ('tile', 'vec'):
        got = headsplit.launch_relayout(route, xs, src, dst, H, rot, cos,
                                        sin)
        torch.cuda.synchronize()
        assert all(map(torch.equal, got, ref)), route
    assert headsplit.relayout_heads.launches == before
    ragged, (c1, s1) = _relayout_inputs(src, len(rot), T - 1, H, D, cuda, 1)
    with pytest.raises(RuntimeError, match='CUDA error'):
        headsplit.launch_relayout('vec', ragged, src, dst, H, rot, c1, s1)
    if headsplit.relayout_route(src, dst, T) != 'rows':
        with pytest.raises(RuntimeError, match='CUDA error'):
            headsplit.launch_relayout('rows', xs, src, dst, H, rot, cos,
                                      sin)


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


# ---------------------------------------------------------------------------
# The probe tools' kernels: H5 (transposed-score forward), H6 and H7 (H1's
# and H2's ablation modes), H8 (ceiling probes). Each mode is held to its
# plain version under the gate its tool states (`check`); H6 `baseline`
# and H7 `real` are H1's and H2's own instantiations, so bit-equal.
# ---------------------------------------------------------------------------

H5_LENS = [300, 7, 500, 193]                   # 1,000 tokens


def _tm(x2, H):
    T = x2.shape[0]
    return x2.view(T, H, -1).permute(1, 2, 0).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize('T', [1000, 1001])     # T % 8 != 0 too
@pytest.mark.parametrize('D', [16, 24, 32, 64, 128])
def test_fwd_t_kernel_matches_plain(cuda, D, T):
    """H5 on its route, and its mma.sync form at every shape, against its
    plain version and against H1, under H1's gates."""
    H = 3
    q, k, v, seg = _packed(H5_LENS, T, H, D, cuda, seed=D + T)
    ks, ke = flash.block_spans(seg, flash.BLOCK_Q, flash.BLOCK_K)
    qT, kT, vT = (_tm(x, H) for x in (q, k, v))
    route = tft.fwd_T_route(D, T)
    assert route == ('flash_fwd_t' if D < 32 or T % 8 else 'flash_fwd_sm90')
    before, on_route = tft.fwd_T.launches, tft.fwd_T.routes[route]
    oT, lse = tft.fwd_T(qT, kT, vT, seg, ks, ke)
    oT_p, lse_p = tft.fwd_T_plain(qT, kT, vT, seg, ks, ke)
    o1, lse1 = flash.segment_flash_fwd(q, k, v, seg, ks, ke, H)
    torch.cuda.synchronize()
    assert tft.fwd_T.launches == before + 1
    assert tft.fwd_T.routes[route] == on_route + 1
    assert oT.shape == (H, D, T) and lse.shape == (H, T)
    # the mma.sync form, also where the route is the Hopper form
    oT_m, lse_m = tft.launch_fwd_T('flash_fwd_t', qT, kT, vT, seg, ks, ke)
    torch.cuda.synchronize()
    for got in ((oT, lse), (oT_m, lse_m)):
        for o_ref, l_ref in ((oT_p, lse_p), (_tm(o1, H), lse1)):
            assert tft.flash_errors(*got, o_ref, l_ref)[3]


@pytest.mark.cuda
@pytest.mark.parametrize('layout', ['packed', 'one', 'short', 'interleaved'])
@pytest.mark.parametrize('D', [32, 64, 128])
def test_fwd_t_sm90_matches_plain_and_h1_on_mask_layouts(cuda, D, layout):
    """H5's Hopper form against its plain version under H1's gates and
    bit-equal to H1's Hopper form on the same values, on the packed batch
    and on the segment layouts of ``_bwd_seg`` (every tile unmasked, every
    tile masked, non-monotonic ids), T = 8192 and 1000 (a part-box
    tail)."""
    H = 3
    for T in (8192, 1000):
        seg = _packed(H5_LENS, T, 1, 8, cuda)[3] if layout == 'packed' \
            else _bwd_seg(layout, T, cuda, T)
        q, k, v, seg, ks, ke, _ = _fwd_args(seg, H, D, cuda, D + T)
        qT, kT, vT = (_tm(x, H) for x in (q, k, v))
        on_route = tft.fwd_T.routes['flash_fwd_sm90']
        oT, lse = tft.fwd_T(qT, kT, vT, seg, ks, ke)
        oT_p, lse_p = tft.fwd_T_plain(qT, kT, vT, seg, ks, ke)
        o1, lse1 = flash.segment_flash_fwd(q, k, v, seg, ks, ke, H)
        torch.cuda.synchronize()
        assert tft.fwd_T.routes['flash_fwd_sm90'] == on_route + 1
        assert torch.isfinite(oT.float()).all()
        assert tft.flash_errors(oT, lse, oT_p, lse_p)[3]
        # H1's kernel: the same products in the same order, bit for bit
        assert torch.equal(oT, _tm(o1, H)) and torch.equal(lse, lse1)


@pytest.mark.cuda
@pytest.mark.parametrize('D', [32, 64, 128])
def test_fwd_t_sm90_is_deterministic(cuda, D):
    """Two calls of H5's Hopper form on the same inputs give the same
    bits (no atomics; each output token is written by one CTA)."""
    H, T = 4, 3072
    q, k, v, seg = _packed([30, 7, 250, 900, 2, 400, 1000], T, H, D, cuda,
                           seed=D)
    ks, ke = flash.block_spans(seg, flash.BLOCK_Q, flash.BLOCK_K)
    args = (*(_tm(x, H) for x in (q, k, v)), seg, ks, ke)
    a, b = tft.fwd_T(*args), tft.fwd_T(*args)
    torch.cuda.synchronize()
    assert all(map(torch.equal, a, b))


@pytest.mark.cuda
@pytest.mark.parametrize('library', list(flash.FWD_ROUTES))
@pytest.mark.parametrize('mode', list(tfv.MODES))
def test_flash_variant_kernel_matches_plain(cuda, mode, library):
    """Each mode of both of H1's forms against its plain version at the
    form's walk; ``baseline`` bit-equal to the form's production launch,
    and on the Hopper form (H1's route at D = 64) to H1 itself."""
    H, D, T = 4, 64, 3072
    q, k, v, seg = _packed([30, 7, 250, 900, 2, 400, 1000], T, H, D, cuda,
                           seed=7)
    ks, ke = flash.block_spans(seg, flash.BLOCK_Q, flash.BLOCK_K)
    before = tfv.variant_fwd.launches
    got = tfv.variant_fwd(mode, q, k, v, seg, ks, ke, H, library=library)
    ref = tfv.variant_fwd_plain(mode, q, k, v, seg, ks, ke, H,
                                library=library)
    torch.cuda.synchronize()
    assert tfv.variant_fwd.launches == before + 1
    c = tfv.check(mode, got, ref, library)
    assert c['ok'], c
    if mode == 'baseline':
        args = (q, k, v, seg, ks, ke, H)
        assert all(map(torch.equal, got, flash.launch_fwd(library, *args)))
        o, lse = flash.segment_flash_fwd(*args)
        torch.cuda.synchronize()
        if library == flash.fwd_route(D):
            assert torch.equal(o, got[0]) and torch.equal(lse, got[1])
        else:
            # H1's Hopper form under H1's gates against the mma.sync form
            gate = O_REL * got[0].float().abs().clamp_min(O_FLOOR)
            assert ((o.float() - got[0].float()).abs() <= gate).all()
            assert (lse - got[1]).abs().max().item() <= LSE_ATOL


_EX2_BF16 = r'''
#include <stdint.h>
__global__ void ex2(const uint32_t* x, uint32_t* y, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) asm("ex2.approx.ftz.bf16x2 %0, %1;" : "=r"(y[i]) : "r"(x[i]));
}
extern "C" int run(const void* x, void* y, int n) {
  ex2<<<(n + 255) / 256, 256>>>((const uint32_t*)x, (uint32_t*)y, n);
  return (int)cudaDeviceSynchronize();
}
'''


@pytest.mark.cuda
def test_ex2_bf16_is_the_sfu_instruction(cuda, tmp_path):
    """H6 ``bf16exp``'s plain 2^x equals ``ex2.approx.ftz.bf16x2`` (the
    instruction alone, built here) at every bf16 x <= 0."""
    import ctypes
    import subprocess
    from esme_tpu_torch import _build
    src, lib = tmp_path / 'ex2.cu', tmp_path / 'libex2.so'
    src.write_text(_EX2_BF16)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-o', str(lib),
                    str(src)], check=True)
    run = ctypes.CDLL(str(lib)).run
    run.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    x = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16) \
        .view(torch.bfloat16).to(cuda)
    y = torch.empty_like(x)
    assert run(x.data_ptr(), y.data_ptr(), x.numel() // 2) == 0
    keep = torch.isfinite(x.float()) & (x.float() <= 0)
    assert int(keep.sum()) == 32641           # -0, 0 and 32,639 negatives
    assert torch.equal(tfv.ex2_bf16(x.float()[keep]), y.float()[keep])


@pytest.mark.cuda
@pytest.mark.parametrize('library', list(flash.BWD_ROUTES))
@pytest.mark.parametrize('kernel', tdb.KERNELS)
@pytest.mark.parametrize('mode', list(tdb.MODES))
def test_bwd_variant_kernel_matches_plain(cuda, mode, kernel, library):
    """Each mode of each pass of both of H2's forms against its plain
    version at the form's walk; ``real`` bit-equal to the form's
    production launch."""
    H, D, T = 4, 64, 3072
    q, k, v, seg = _packed([30, 7, 250, 900, 2, 400, 1000], T, H, D, cuda,
                           seed=8)
    spans = flash.flash_spans(seg)
    o, lse = flash.segment_flash_fwd(q, k, v, seg, *spans[:2], H)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(9)
    do = torch.randn(q.shape, generator=gen, device=cuda).to(torch.bfloat16)
    delta = flash.attention_delta(o, do, H)
    args = (q, k, v, do, lse, delta, seg, *spans, H)
    before = tdb.bwd_variant.launches
    got = tdb.bwd_variant(kernel, mode, *args, library=library)
    ref = tdb.bwd_variant_plain(kernel, mode, *args, library=library)
    torch.cuda.synchronize()
    assert tdb.bwd_variant.launches == before + 1
    assert tdb.check(mode, got, ref)['ok']
    if mode == 'real':
        # bit-equal to H2 as routed (the Hopper form at D = 64) and to
        # the form's own launch
        got = got if isinstance(got, tuple) else (got,)
        for dq, dk, dv in (flash.segment_flash_bwd(*args),
                           flash.launch_bwd(library, *args)):
            h2 = (dq,) if kernel == 'dq' else (dk, dv)
            assert all(map(torch.equal, got, h2))


@pytest.mark.cuda
@pytest.mark.parametrize('probe', list(tpa.RUNS))
def test_probe_kernel_matches_plain(cuda, probe):
    """Each H8 run (the streaming probes in both forms, dma alone and in
    pairs) under its gate against its plain version; the Hopper forms and
    the pairs bit-equal to the cp.async form."""
    from types import SimpleNamespace
    H, D, T = 4, 64, 3072
    q, k, v, seg = _packed([30, 7, 250, 900, 2, 400, 1000], T, H, D, cuda,
                           seed=10)
    b = SimpleNamespace(q=q, k=k, v=v, seg=seg, H=H, D=D, T=T, device=cuda,
                        spans=flash.flash_spans(seg))
    counter = getattr(tpa, tpa.RUNS[probe][0])
    before = counter.launches
    runs = tpa.calls(b, tpa.probe_inputs(b))
    kernel, plain = runs[probe]
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert tpa.check(probe, got, ref)['ok']
    if probe in tpa.SAME_AS:
        assert torch.equal(got, runs[tpa.SAME_AS[probe]][0]())


def _stream_case(case, dev):
    """H8's streaming probes' edge cases: (q, k, v, kstart, kend, H)."""
    H, D = 4, 64
    T = {'ragged': 3048, 'wrap': 3072, 'zero': 3072, 'odd_nqb': 2944}[case]
    q, k, v, seg = _packed([30, 7, 250, 900, 2, 400, 1000], T, H, D, dev,
                           seed=12)
    ks, ke = flash.flash_spans(seg)[:2]
    nqb, nkb = -(-T // 128), -(-T // 64)
    i = torch.arange(nqb, dtype=torch.int32, device=dev)
    if case == 'wrap':        # late blocks walk past the last tile
        ks, ke = torch.zeros_like(i), ((i * 7) % 17 + nkb - nqb).int()
    elif case == 'zero':      # no steps: a whole pair, each half of others
        ke = torch.where((i % 6 == 2) | (i % 6 == 3) | (i % 5 == 0), ks, ke)
    return q, k, v, ks.contiguous(), ke.contiguous(), H


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['ragged', 'wrap', 'zero', 'odd_nqb'])
def test_streaming_probes_edge_cases(cuda, case):
    """dma (alone and in pairs) and dma_t on both forms at a T that is not
    a multiple of 64, on walks past the last tile, with blocks of no steps
    and with an odd number of q blocks (a pair's second CTA without a
    block): each under its gate against its plain version, the Hopper
    forms bit-equal to the cp.async form."""
    q, k, v, ks, ke, H = _stream_case(case, cuda)
    T = q.shape[0]
    if case == 'wrap':
        assert bool(((torch.arange(ks.numel(), device=cuda) + ke - ks)
                     > -(-T // 64)).any())
    if case == 'odd_nqb':
        assert ks.numel() % 2 == 1
    kT, vT = _tm(k, H), _tm(v, H)
    n = ke - ks
    ref = tpa.dma_plain(q, k, v, n, H)
    ref_t = tpa.dma_t_plain(kT, vT, n)
    base = tpa.dma(q, k, v, ks, ke, H, library='probes')
    base_t = tpa.dma_t(kT, vT, ks, ke, library='probes')
    assert tpa.check('dma', base, ref)['ok']
    assert tpa.check('dma_t', base_t, ref_t)['ok']
    for cluster in (1, 2):
        got = tpa.dma(q, k, v, ks, ke, H, cluster=cluster)
        assert tpa.check('dma', got, ref)['ok'] and torch.equal(got, base)
    got_t = tpa.dma_t(kT, vT, ks, ke)
    assert tpa.check('dma_t', got_t, ref_t)['ok'] and torch.equal(got_t,
                                                                  base_t)


@pytest.mark.cuda
def test_probe_tool_kernels_refuse_what_they_do_not_take(cuda):
    H = 2
    q, k, v, seg = _packed([100, 28], 128, H, 64, cuda)
    ks, ke = flash.block_spans(seg, flash.BLOCK_Q, flash.BLOCK_K)
    qT = _tm(q, H)
    with pytest.raises(TypeError, match='bfloat16'):
        tft.fwd_T(qT.float(), qT.float(), qT.float(), seg, ks, ke)
    q48 = _tm(_packed([100, 28], 128, H, 48, cuda)[0], H)
    with pytest.raises(ValueError, match='head dim 48'):
        tft.fwd_T(q48, q48, q48, seg, ks, ke)
    with pytest.raises(ValueError, match='unknown mode'):
        tfv.variant_fwd('noqv', q, k, v, seg, ks, ke, H)
    q32, k32, v32, _ = _packed([100, 28], 128, H, 32, cuda)
    with pytest.raises(ValueError, match='head dim 32'):
        tfv.variant_fwd('nomax', q32, k32, v32, seg, ks, ke, H)
    spans = flash.flash_spans(seg)
    lse = torch.zeros((H, 128), device=cuda)
    with pytest.raises(ValueError, match='unknown mode'):
        tdb.bwd_variant('dq', 'no_q', q, k, v, q, lse, lse, seg, *spans, H)
    with pytest.raises(TypeError, match='bfloat16'):
        tdb.bwd_variant('dkv', 'dma', q.float(), k.float(), v.float(),
                        q.float(), lse, lse, seg, *spans, H)
    with pytest.raises(TypeError, match='float32'):
        tpa.vpu(q[:128, :64].contiguous(), ks, ke, H)
    for library in tpa.FORMS:
        with pytest.raises(ValueError, match='T a multiple of 8'):
            kT = torch.zeros((H, 64, 124), dtype=torch.bfloat16, device=cuda)
            tpa.dma_t(kT, kT, ks, ke, library=library)
        with pytest.raises(TypeError, match='bfloat16'):
            tpa.dma(q.float(), k.float(), v.float(), ks, ke, H, library)
    with pytest.raises(ValueError, match='unknown library'):
        tpa.dma(q, k, v, ks, ke, H, library='flash_fwd_sm90')
    with pytest.raises(ValueError, match='cluster 2: the probes form'):
        tpa.dma(q, k, v, ks, ke, H, library='probes', cluster=2)
    with pytest.raises(ValueError, match='cluster 4'):
        tpa.dma(q, k, v, ks, ke, H, cluster=4)
    with pytest.raises(ValueError, match='head dim 32'):
        tpa.dma(q32, k32, v32, ks, ke, H, cluster=2)
