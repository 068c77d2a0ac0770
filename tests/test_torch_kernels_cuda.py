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
  Held on H1's route (the Hopper form at every head dim, 16 and 24 on
  32-column tiles; the mma.sync form checked beside it) and on one segment, 1-70-token segments and
  interleaved ids, so on masked and unmasked tiles; the Hopper form is
  also bit-equal from call to call.
* H2 (segment-flash backward), bf16 inputs: |g - g_plain| within
  2^-4 * max(|g_plain|, rms(g_plain)) for each of dq, dk, dv: p and ds
  are rounded to bf16 before their products, and where the kernel's
  fp32 ds and the plain version's differ in their last bits the two
  roundings can land on neighbouring bf16 values; one such flip of a
  large ds term moves one gradient element by up to ~2^-8·|ds|·|k|
  (measured up to 0.019·rms(g) at 8k tokens, see ``chip_smoke.py``).
  Held on H2's route (the Hopper form at every head dim, 16 and 24 on
  32-column tiles; the mma.sync form checked beside it) and on one segment, 1-70-token segments and
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
* ESMC's head counts (H = 15, 18 at D = 64): H1, H2 and H3 under the
  gates above; the RoPE-free route of ESM1b and ESM1v
  (``flash.segment_flash``): H1 and H2 under theirs, no H3.
* H9 (the rectangular forward, ``seg_k``): under H1's gates against its
  plain version on every rank of a packed batch split over 2 and 4 ranks
  and on a ragged split, on both of H1's routes; o and lse bit-equal to
  H1's rows on the whole batch where the rank's first row is a multiple of
  ``BLOCK_Q`` (each q block walks the same span in the same order), and
  from call to call; a q block whose ids match no key writes o = 0 and
  lse = ``EMPTY_LSE``, as the plain version does.
* Quantization (plain PyTorch on the card): ``quantize_int8``,
  ``quantize_nf4`` and ``dequantize`` bit-equal to the CPU's; a quantized
  model's forward against its plain versions under ``chip_smoke.py``'s
  phase-4 gates (per-token centred cosine 0.99, max|Δ| 0.25).
* H10 (the rectangular backward, ``seg_k``): under H2's gate against its
  plain version on every rank of a packed batch split over 2 and 4 ranks
  and on a ragged split, on both of H2's routes, and bit-equal from call
  to call; dq bit-equal to H2's rows where the rank's first row is a
  multiple of ``BLOCK_Q``, and dk, dv summed over the ranks under H2's
  gate against H2's on the whole batch (each rank rounds its share to
  bf16); key rows no query shares an id with get dk = dv = 0, and a q
  block whose ids match no key dq = 0.
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


def _rect_check(q, k, v, seg, lo, hi, H):
    """H9 on rows [lo, hi) of q over all of k, v: against its plain
    version under H1's gates, bit-equal from call to call; returns o,
    lse."""
    sq = seg[lo:hi].contiguous()
    ks, ke = flash.rect_spans(sq, seg)
    args = (q[lo:hi].contiguous(), k, v, sq, ks, ke, H)
    before = flash.segment_flash_fwd.rect_launches
    o, lse = flash.segment_flash_fwd(*args, seg_k=seg)
    again = flash.segment_flash_fwd(*args, seg_k=seg)
    o_p, lse_p = flash.segment_flash_fwd_plain(*args, seg_k=seg)
    torch.cuda.synchronize()
    assert flash.segment_flash_fwd.rect_launches == before + 2
    assert o.shape == (hi - lo, k.shape[1]) and lse.shape == (H, hi - lo)
    gate = O_REL * o_p.float().abs().clamp_min(O_FLOOR)
    assert ((o.float() - o_p.float()).abs() <= gate).all()
    assert (lse - lse_p).abs().max().item() <= LSE_ATOL
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    return o, lse


@pytest.mark.cuda
@pytest.mark.parametrize('D', [16, 24, 32, 64, 128])
def test_flash_rect_kernel_matches_plain(cuda, D):
    """H9 (``segment_flash_fwd(..., seg_k=)``) on every rank of n = 2 and
    4 of a packed 4,096-token batch and on a ragged split (Tq = 1,001 from
    row 700), against its plain version; bit-equal to H1's rows where the
    rank starts on a q block; H1's counter does not move."""
    H, T = 4, 4096
    q, k, v, seg = _packed([30, 7, 250, 900, 2, 400, 1000, 700, 333], T, H,
                           D, cuda, seed=D)
    ks, ke = flash.block_spans(seg, flash.BLOCK_Q, flash.BLOCK_K)
    o_sq, lse_sq = flash.segment_flash_fwd(q, k, v, seg, ks, ke, H)
    h1 = flash.segment_flash_fwd.launches
    for n in (2, 4):
        for r in range(n):
            lo, hi = r * T // n, (r + 1) * T // n
            o, lse = _rect_check(q, k, v, seg, lo, hi, H)
            assert torch.equal(o, o_sq[lo:hi])
            assert torch.equal(lse, lse_sq[:, lo:hi])
    _rect_check(q, k, v, seg, 700, 1701, H)
    assert flash.segment_flash_fwd.launches == h1


@pytest.mark.cuda
@pytest.mark.parametrize('D', [16, 64])
def test_flash_rect_kernel_empty_span(cuda, D):
    """A q block whose ids match no key (an empty span) gets o = 0 and
    lse = ``EMPTY_LSE`` from H9, as from its plain version; the next blocks
    are unaffected."""
    H = 2
    q, k, v, seg = _packed([300, 500, 224], 1024, H, D, cuda, seed=1)
    sq = seg[:512].clone()
    sq[:flash.BLOCK_Q] += 10 ** 6
    ks, ke = flash.rect_spans(sq, seg)
    assert ke[0] <= ks[0]
    args = (q[:512].contiguous(), k, v, sq, ks, ke, H)
    o, lse = flash.segment_flash_fwd(*args, seg_k=seg)
    o_p, lse_p = flash.segment_flash_fwd_plain(*args, seg_k=seg)
    torch.cuda.synchronize()
    assert not o[:flash.BLOCK_Q].any()
    assert (lse[:, :flash.BLOCK_Q] == flash.EMPTY_LSE).all()
    assert torch.equal(lse[:, :flash.BLOCK_Q], lse_p[:, :flash.BLOCK_Q])
    gate = O_REL * o_p.float().abs().clamp_min(O_FLOOR)
    assert ((o.float() - o_p.float()).abs() <= gate).all()


def _rect_bwd_check(q, k, v, do, seg, lo, hi, H):
    """H10 on rows [lo, hi) of q and do over all of k, v (lse from H9):
    against its plain version under H2's gate, bit-equal from call to
    call; the key rows no query shares an id with get dk = dv = 0;
    returns dq, dk, dv."""
    sq = seg[lo:hi].contiguous()
    spans = flash.rect_flash_spans(sq, seg)
    qr, dor = q[lo:hi].contiguous(), do[lo:hi].contiguous()
    o, lse = flash.segment_flash_fwd(qr, k, v, sq, *spans[:2], H, seg_k=seg)
    delta = flash.attention_delta(o, dor, H)
    args = (qr, k, v, dor, lse, delta, sq, *spans, H)
    before = flash.segment_flash_bwd.rect_launches
    h2 = flash.segment_flash_bwd.launches
    got = flash.segment_flash_bwd(*args, seg_k=seg)
    again = flash.segment_flash_bwd(*args, seg_k=seg)
    ref = flash.segment_flash_bwd_plain(*args, seg_k=seg)
    torch.cuda.synchronize()
    assert flash.segment_flash_bwd.rect_launches == before + 2
    assert flash.segment_flash_bwd.launches == h2
    untouched = ~torch.isin(seg, sq)
    for a, b, c, rows in zip(got, ref, again, (hi - lo, *k.shape[:1] * 2)):
        assert a.dtype == torch.bfloat16 and a.shape == (rows, q.shape[1])
        assert torch.equal(a, c) and torch.isfinite(a.float()).all()
        b = b.float()
        gate = G_REL * b.abs().clamp_min(b.square().mean().sqrt())
        assert ((a.float() - b).abs() <= gate).all()
    for a in got[1:]:
        assert not a[untouched].any()
    return got


@pytest.mark.cuda
@pytest.mark.parametrize('D', [16, 24, 32, 64, 128])
def test_flash_rect_bwd_kernel_matches_plain(cuda, D):
    """H10 (``segment_flash_bwd(..., seg_k=)``) on every rank of n = 2 and
    4 of a packed 4,096-token batch and on a ragged split (Tq = 1,001 from
    row 700), against its plain version; dq bit-equal to H2's rows where
    the rank starts on a q block, and dk, dv summed over the ranks under
    H2's gate against H2's; H2's counter does not move."""
    H, T = 4, 4096
    q, k, v, seg = _packed([30, 7, 250, 900, 2, 400, 1000, 700, 333], T, H,
                           D, cuda, seed=D)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(D + 2)
    do = torch.randn(q.shape, generator=gen, device=cuda).to(torch.bfloat16)
    spans = flash.flash_spans(seg)
    o, lse = flash.segment_flash_fwd(q, k, v, seg, *spans[:2], H)
    sq = flash.segment_flash_bwd(q, k, v, do, lse,
                                 flash.attention_delta(o, do, H), seg,
                                 *spans, H)
    for n in (2, 4):
        dk = torch.zeros_like(k, dtype=torch.float32)
        dv = torch.zeros_like(dk)
        for r in range(n):
            lo, hi = r * T // n, (r + 1) * T // n
            dq_r, dk_r, dv_r = _rect_bwd_check(q, k, v, do, seg, lo, hi, H)
            assert torch.equal(dq_r, sq[0][lo:hi])
            dk += dk_r.float()
            dv += dv_r.float()
        for a, b in ((dk, sq[1]), (dv, sq[2])):
            b = b.float()
            gate = G_REL * b.abs().clamp_min(b.square().mean().sqrt())
            assert ((a - b).abs() <= gate).all()
    _rect_bwd_check(q, k, v, do, seg, 700, 1701, H)


@pytest.mark.cuda
@pytest.mark.parametrize('D', [16, 64])
def test_flash_rect_bwd_kernel_empty_span(cuda, D):
    """A q block whose ids match no key (an empty span) gets dq = 0 from
    H10, as from its plain version, and the key blocks no query shares an
    id with (empty dk/dv spans) get dk = dv = 0; the rest under H2's
    gate."""
    H = 2
    q, k, v, seg = _packed([300, 500, 224], 1024, H, D, cuda, seed=1)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    do = torch.randn(q.shape, generator=gen, device=cuda).to(torch.bfloat16)
    sq = seg[:512].clone()
    sq[:flash.BLOCK_Q] += 10 ** 6
    ks, ke, qs, qe = flash.rect_flash_spans(sq, seg)
    assert ke[0] <= ks[0] and bool((qe <= qs).any())
    o, lse = flash.segment_flash_fwd(q[:512].contiguous(), k, v, sq, ks, ke,
                                     H, seg_k=seg)
    dor = do[:512].contiguous()
    args = (q[:512].contiguous(), k, v, dor, lse,
            flash.attention_delta(o, dor, H), sq, ks, ke, qs, qe, H)
    got = flash.segment_flash_bwd(*args, seg_k=seg)
    ref = flash.segment_flash_bwd_plain(*args, seg_k=seg)
    torch.cuda.synchronize()
    assert not got[0][:flash.BLOCK_Q].any()
    empty = (qe <= qs).repeat_interleave(flash.BLOCK_KV)[:k.shape[0]]
    for a, b in zip(got, ref):
        b = b.float()
        gate = G_REL * b.abs().clamp_min(b.square().mean().sqrt())
        assert ((a.float() - b).abs() <= gate).all()
    for a in got[1:]:
        assert not a[empty].any()


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
    """H1 on its route (the Hopper form at every head dim, 16 and 24 on
    32-column tiles) against its plain version on masked and unmasked
    tiles (segment layouts of ``_bwd_seg``), under H1's gates."""
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
@pytest.mark.parametrize('D', [16, 24, 32, 64, 128])
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
    alignment, device); its C entry takes head dims 16 and 24 and refuses
    one it was not built for, and H5's token-minor entry refuses 16 and
    24."""
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
    for D in (8, 40, 48):
        assert lib.esme_segment_flash_fwd_sm90(*ptrs, 256, 2, D, 0.1,
                                               stream) != 0
    for D in (16, 24):
        assert lib.esme_flash_fwd_t_sm90(*ptrs, 256, 2, D, 0.1, stream) != 0
        args = _fwd_args(_bwd_seg('one', 256, cuda, 0), 2, D, cuda, D)
        o, lse = torch.empty_like(args[0]), torch.empty((2, 256), device=cuda)
        assert lib.esme_segment_flash_fwd_sm90(
            *(x.data_ptr() for x in (*args[:6], o, lse)), 256, 2, D,
            D ** -0.5, stream) == 0
        torch.cuda.synchronize()
        assert all(map(torch.equal, (o, lse), flash.segment_flash_fwd(*args)))


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
    """H2 on its route (the Hopper form at every head dim, 16 and 24 on
    32-column tiles) against its plain version on masked and unmasked
    tiles, under the H2 gate."""
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
@pytest.mark.parametrize('D', [16, 24, 32, 64, 128])
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
    """The wrapper's checks hold on the Hopper route; its C entries take
    head dims 16 and 24 and refuse a head dim or pass they were not built
    for (the ablation modes at 16 and 24 too)."""
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
    for D in (8, 40, 48):
        assert lib.esme_segment_flash_bwd_sm90(*ptrs, 256, 2, D, 0.1,
                                               stream) != 0
    for D in (16, 24):
        assert lib.esme_flash_bwd_sm90_pass(0, 1, *ptrs, 256, 2, D, 0.1,
                                            stream) != 0
        args = _bwd_inputs(_bwd_seg('one', 256, cuda, 0), 2, D, cuda, D)
        outs = [torch.empty_like(args[0]) for _ in range(3)]
        assert lib.esme_segment_flash_bwd_sm90(
            *(x.data_ptr() for x in (*args[:11], *outs)), 256, 2, D,
            D ** -0.5, stream) == 0
        torch.cuda.synchronize()
        assert all(map(torch.equal, outs, flash.segment_flash_bwd(*args)))
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
@pytest.mark.parametrize('H', [15, 18])
@pytest.mark.parametrize('lens,total', [
    ([30, 7, 250, 900, 2, 400, 1000], 3072),   # ALIGN multiple, a tail
    ([1000, 513, 77], 1700),                   # ragged last tiles
])
def test_kernels_at_esmc_head_counts_match_plain(cuda, H, lens, total):
    """H1, H2 and H3 (forward and inverse) at ESMC-300M's and ESMC-600M's
    head counts, D = 64: odd and even H, rows of 1,920 and 2,304 bytes in
    the TMA descriptors. H1 and H2 under their gates, H3 bit-equal."""
    D = 64
    q, k, v, seg = _packed(lens, total, H, D, cuda, seed=H)
    spans = flash.flash_spans(seg)
    o, lse = flash.segment_flash_fwd(q, k, v, seg, *spans[:2], H)
    o_p, lse_p = flash.segment_flash_fwd_plain(q, k, v, seg, *spans[:2], H)
    gate = O_REL * o_p.float().abs().clamp_min(O_FLOOR)
    assert ((o.float() - o_p.float()).abs() <= gate).all()
    assert (lse - lse_p).abs().max().item() <= LSE_ATOL
    gen = torch.Generator(device=cuda)
    gen.manual_seed(H + 1)
    do = torch.randn(q.shape, generator=gen, device=cuda).to(torch.bfloat16)
    delta = flash.attention_delta(o, do, H)
    got = flash.segment_flash_bwd(q, k, v, do, lse, delta, seg, *spans, H)
    ref = flash.segment_flash_bwd_plain(q, k, v, do, lse, delta, seg,
                                        *spans, H)
    for a, b in zip(got, ref):
        b = b.float()
        gate = G_REL * b.abs().clamp_min(b.square().mean().sqrt())
        assert torch.isfinite(a.float()).all()
        assert ((a.float() - b).abs() <= gate).all()
    cos, sin = rotary_cos_sin(torch.arange(total, device=cuda) % 1000, D)
    for inverse in (False, True):
        for a, b in zip(headsplit.rotary_qk(q, k, cos, sin, H, inverse),
                        headsplit.rotary_qk_plain(q, k, cos, sin, H,
                                                  inverse)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_segment_flash_grad_kernels_match_plain(cuda, monkeypatch):
    """The RoPE-free autograd route of ESM1b and ESM1v on the card:
    forward H1, backward H2 (one launch each) and no H3, against the same
    function through the plain versions, under H1's and H2's gates."""
    T, H, D = 3072, 20, 64
    q, k, v, seg = _packed([30, 7, 250, 900, 2, 400, 1000], T, H, D, cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    w = torch.randn(q.shape, generator=gen, device=cuda).to(torch.bfloat16)
    spans = flash.flash_spans(seg)

    def run():
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        o = flash.segment_flash(*xs, seg, H, spans)
        (o.float() * w.float()).sum().backward()
        return o.detach(), [x.grad for x in xs]

    counters = (flash.segment_flash_fwd, flash.segment_flash_bwd,
                headsplit.rotary_qk)
    before = [f.launches for f in counters]
    o, got = run()
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 0]
    monkeypatch.setattr(flash, 'segment_flash_fwd',
                        flash.segment_flash_fwd_plain)
    monkeypatch.setattr(flash, 'segment_flash_bwd',
                        flash.segment_flash_bwd_plain)
    o_p, ref = run()
    gate = O_REL * o_p.float().abs().clamp_min(O_FLOOR)
    assert ((o.float() - o_p.float()).abs() <= gate).all()
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


# -------------------------------------------------------------------------
# The memory slice on the card: remat='attn', adam8bit, the offload
# -------------------------------------------------------------------------

def _mlm_batch(seed, T=2048):
    """A packed masked-LM batch of T tokens (sequences of 20-400 residues,
    a padding tail), as the trainers take it."""
    from types import SimpleNamespace
    from esme_tpu_torch import Alphabet, mask_tokens, tokenize_unpad
    rng = np.random.default_rng(seed)
    lens, total = [], 0
    while total < T - 450:
        n = int(rng.integers(20, 400))
        lens.append(n)
        total += n + 2
    seqs = [''.join(rng.choice(list('LAGVSERTIDPKQNFYMHWC'), n))
            for n in lens]
    tok, _, cu, ml = tokenize_unpad(seqs)
    masked, mask = mask_tokens(tok, rng=np.random.default_rng(seed + 1))
    pad = T - tok.shape[0]
    fill = Alphabet.padding_idx
    return SimpleNamespace(
        tokens=np.pad(tok, (0, pad), constant_values=fill),
        masked_tokens=np.pad(masked, (0, pad), constant_values=fill),
        mask=np.pad(mask, (0, pad), constant_values=False), cu_lens=cu,
        max_len=ml)


def _flat_tree(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_tree(v, path + (k,))
        else:
            yield '.'.join(path + (k,)), v


@pytest.mark.cuda
@pytest.mark.parametrize('family', ['ESM2', 'ESM1b'])
def test_remat_attn_on_the_card_is_full_bit_for_bit(cuda, family):
    """``remat='attn'`` with checkpointing: the loss and every leaf's
    gradient bit-equal to ``'full'``'s (H1 is bit-equal from call to
    call), with H1 launched once per layer instead of twice (H2 once, H3
    three times in ESM2 and never in ESM1b) on the two attention
    boundaries of the trunk."""
    import esme_tpu_torch
    from dataclasses import replace
    from esme_tpu_torch.train import MaskedPLM
    cls = getattr(esme_tpu_torch, family)
    kw = dict(num_layers=2, embed_dim=128, attention_heads=2) \
        if family == 'ESM2' else {}
    batch = _mlm_batch(3)
    out = {}
    for remat in ('full', 'attn'):
        if family == 'ESM2':
            model = cls(**kw, rng=0, device=cuda, checkpointing=True)
        else:
            cfg = replace(esme_tpu_torch.esm1b_config(), num_layers=2,
                          embed_dim=128, attention_heads=2)
            model = cls(config=cfg, rng=0, device=cuda, checkpointing=True)
        counters = (flash.segment_flash_fwd, flash.segment_flash_bwd,
                    headsplit.rotary_qk)
        before = [c.launches for c in counters]
        out[remat] = MaskedPLM(model, remat=remat)._grad_step(batch)
        torch.cuda.synchronize()
        out[remat + '_launches'] = [c.launches - b
                                    for c, b in zip(counters, before)]
    L, rot = 2, int(family == 'ESM2')
    assert out['full_launches'] == [2 * L, L, 3 * L * rot]
    assert out['attn_launches'] == [L, L, 3 * L * rot]
    assert torch.equal(out['full'][0], out['attn'][0])
    for (name, a), (_, b) in zip(_flat_tree(out['full'][1]),
                                 _flat_tree(out['attn'][1])):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_adam8bit_on_the_card_is_the_cpu_arithmetic(cuda, dtype):
    """Three ``Adam8bit`` updates on the card and on the CPU from the same
    params and gradients (magnitudes over eight decades; a stacked leaf as
    three views in one group, and a leaf alone; AdamW): codes, scales and
    params bit-equal. Every step is IEEE fp32 on both sides: the bias
    corrections are computed on the host, the divisors are device
    tensors, the square roots correctly rounded."""
    from esme_tpu_torch.train.optim import Adam8bit
    rng = np.random.default_rng(0)
    init = [rng.standard_normal((3, 256, 300)), rng.standard_normal(4099)]
    sides = {}
    for dev in (cuda, torch.device('cpu')):
        leaves = [torch.from_numpy(x.astype(np.float32)).to(dev, dtype)
                  for x in init]
        groups = [[leaves[0][i].detach().requires_grad_() for i in range(3)],
                  [leaves[1].detach().requires_grad_()]]
        opt = Adam8bit([{'params': g} for g in groups], lr=1e-3,
                       weight_decay=0.01)
        grng = np.random.default_rng(1)
        for _ in range(3):
            for x, g in zip(init, groups):
                grad = torch.from_numpy((grng.standard_normal(x.shape)
                                         * 10.0 ** grng.integers(
                                             -6, 2, x.shape))
                                        .astype(np.float32)).to(dev, dtype)
                for i, p in enumerate(g):
                    p.grad = grad[i] if len(g) > 1 else grad
            opt.step()
        sides[dev.type] = (leaves, opt, groups)
    (gl, gopt, gg), (cl, copt, cg) = sides['cuda'], sides['cpu']
    for a, b in zip(gl, cl):
        assert torch.equal(a.cpu(), b)
    for ga, ca in zip(gg, cg):
        for key in ('mu_scale', 'nu_scale'):
            assert torch.equal(gopt.state[ga[0]][key].cpu(),
                               copt.state[ca[0]][key]), key
        for p, q in zip(ga, ca):
            for key in ('mu', 'nu'):
                assert torch.equal(gopt.state[p][key].view(torch.uint8).cpu(),
                                   copt.state[q][key].view(torch.uint8)), key


@pytest.mark.cuda
def test_offload_optimizer_on_the_card(cuda):
    """``MaskedPLM(offload_optimizer=True)`` with bf16 params on the card:
    pinned fp32 masters and Adam's state on the host, the card's params
    updated in place, three steps' losses within 2^-8 of the on-card
    trainer's (the host keeps fp32 masters, the card bf16 params)."""
    from esme_tpu_torch import ESM2
    from esme_tpu_torch.train import MaskedPLM
    batch = _mlm_batch(4)
    losses = {}
    for offload in (False, True):
        model = ESM2(num_layers=2, embed_dim=128, attention_heads=2, rng=0,
                     device=cuda)
        ptr = model.params['embed_tokens'].data_ptr()
        plm = MaskedPLM(model, learning_rate=1e-3, offload_optimizer=offload)
        losses[offload] = [plm.training_step(batch) for _ in range(3)]
        assert model.params['embed_tokens'].data_ptr() == ptr
    host = plm._host
    assert all(m.is_pinned() and m.dtype == torch.float32
               for _, m, _ in host._up)
    assert all(v.device.type == 'cpu' for st in plm.optimizer.state.values()
               for v in st.values() if torch.is_tensor(v))
    for param, master, _ in host._up:
        assert torch.equal(param.cpu(), master.to(param.dtype))
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[True], losses[False])]
    assert max(rel) <= 2.0 ** -8, (losses, rel)


# -------------------------------------------------------------------------
# The fine-tune slice on the card: a LoRA step through H1, H2 and H3
# -------------------------------------------------------------------------

@pytest.mark.cuda
def test_lora_fine_tune_step_kernels_match_plain(cuda, monkeypatch):
    """One ``RegressionTrainer`` step of a LoRA trunk (rank 8 on query,
    value and output, every ``b`` non-zero) with the learned-aggregation
    head, bf16, 2 layers of width 128 and head dim 64: launches exact (H1
    L, H2 L, H3 2L of which L inverse), the loss within 2^-8 of the plain
    versions' and every trained leaf's gradient under ``chip_smoke.py``'s
    phase 5 gates (cosine at least 0.99, max|Δ| at most 0.1·max|g|);
    frozen leaves take no gradient. The head's key bias is 0 in exact
    arithmetic and held as noise under 2^-4 of its kernel's.

    The head's hidden ReLU units whose pre-activation changes sign between
    the two runs (bf16 representations an ulp apart move a unit near 0
    across it) take their whole share of the batch's gradient in one run
    and none in the other: their columns of ``linear``'s kernel, entries
    of its bias and rows of ``final``'s kernel are left out of the
    max|Δ| gate (cosine still over all), and at most an eighth of the
    units may flip."""
    from esme_tpu_torch import ESM2, LabeledDataset
    from esme_tpu_torch.models import heads
    from esme_tpu_torch.models.heads import init_learned_aggregation
    from esme_tpu_torch.train import RegressionTrainer
    from esme_tpu_torch.train import trainer as trainer_mod
    from esme_tpu_torch.train.trainer import _grad_tree, _map
    rng = np.random.default_rng(5)
    seqs = [''.join(rng.choice(list('LAGVSERTIDPKQNFYMHWC'), int(n)))
            for n in rng.integers(20, 300, 16)]
    batch = LabeledDataset(seqs, [len(s) / 300 for s in seqs],
                           token_per_batch=4096, shuffle=False)[0]
    model = ESM2(num_layers=2, embed_dim=128, attention_heads=2, rng=0,
                 device=cuda)
    model.add_lora(rank=8, alpha=8)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    for p in model.params['layers']['attn'].values():
        for ad in p.get('lora', {}).values():
            ad['b'].copy_(torch.randn(ad['b'].shape, generator=gen,
                                      device=cuda) * 0.05)
    head = init_learned_aggregation(0, 128, device=cuda)
    tt = RegressionTrainer(model, head, head_attention_heads=4)
    pre = []        # each run's pre-activations of the head's ReLU units

    def recorded(params, x, seg_ids, num_segments, attention_heads):
        with torch.no_grad():
            pooled = heads.apply_learned_attention_pool(
                params, x, seg_ids, num_segments, attention_heads)
            pre.append(heads.linear(pooled, params['linear']).float())
        return heads.apply_learned_aggregation(params, x, seg_ids,
                                               num_segments, attention_heads)

    monkeypatch.setattr(trainer_mod, 'apply_learned_aggregation', recorded)

    def step():
        loss = tt._grad_step(batch)
        torch.cuda.synchronize()
        return loss, {'plm': _grad_tree(tt._views),
                      'head': _map(lambda t: t.grad.clone(), tt._head_views)}

    counters = (flash.segment_flash_fwd, flash.segment_flash_bwd,
                headsplit.rotary_qk)
    before = [c.launches for c in counters] + [
        headsplit.rotary_qk.inverse_launches]
    loss, got = step()
    after = [c.launches for c in counters] + [
        headsplit.rotary_qk.inverse_launches]
    assert [b - a for a, b in zip(before, after)] == [2, 2, 4, 2]
    monkeypatch.setattr(fused_attn, 'rotary_qk', headsplit.rotary_qk_plain)
    monkeypatch.setattr(fused_attn, 'segment_flash_fwd',
                        flash.segment_flash_fwd_plain)
    monkeypatch.setattr(fused_attn, 'segment_flash_bwd',
                        flash.segment_flash_bwd_plain)
    loss_p, ref = step()
    assert abs(loss.item() - loss_p.item()) <= 2.0 ** -8 * abs(loss_p.item())
    assert len(pre) == 2 and pre[0].shape == pre[1].shape
    flips = (pre[0] > 0) != (pre[1] > 0)            # (S, C, units)
    flipped = flips.flatten(0, -2).any(0)
    keep = ~flipped
    print(f'head units whose pre-activation changed sign: '
          f'{int(flipped.sum())} of {flipped.numel()} '
          f'({int(flips.sum())} of {flips.numel()} segment-unit pairs), '
          f'the flipped |pre| at most '
          f'{pre[1][flips].abs().max().item() if flips.any() else 0:.3g}')
    assert int(flipped.sum()) <= flipped.numel() // 8
    # the gradient entries of each unit: linear.kernel's column, its
    # bias's entry, final.kernel's row
    unit_of = {'head.linear.kernel': lambda g: g[:, keep],
               'head.linear.bias': lambda g: g[keep],
               'head.final.kernel': lambda g: g[keep]}
    n = 0
    pairs = dict(_flat_tree(ref))
    for name, a in _flat_tree(got):
        b = pairs[name]
        if a is None or b is None:         # frozen: the trunk, the scales
            assert a is None and b is None, name
            assert '.lora.' not in name or name.endswith('.scale'), name
            continue
        if name == 'head.k.bias':
            scale = pairs['head.k.kernel'].float().abs().max()
            assert max(a.abs().max(), b.abs().max()) <= 2.0 ** -4 * scale
            continue
        a, b = a.float(), b.float()
        af, bf = a.ravel(), b.ravel()
        cos = (af @ bf / (af.norm() * bf.norm())).item()
        assert cos >= 0.99, (name, cos)
        if name in unit_of:
            a, b = unit_of[name](a), unit_of[name](b)
        rel = ((a - b).abs().max() / b.abs().max()).item()
        assert rel <= 0.1, (name, cos, rel)
        n += 1
    assert n == 3 * 2 + 6          # a and b of q, v, out; the head's rest


@pytest.mark.cuda
def test_sharded_lora_step_kernels_match_plain(cuda, monkeypatch):
    """One step of ``ShardedMaskedPLM(lora_only=True, seq_axis='seq')`` in
    a one-rank NCCL world on a ``(1, 1, 1)`` mesh, LoRA rank 8 on query,
    value and output (every ``b`` non-zero), bf16, 2 layers of width 128
    and head dim 64: launches exact (H9 L, H10 L, H3 2L of which L
    inverse, H1 and H2 never); the loss within 2^-8 of the plain versions'
    and every adapter's gradient under ``chip_smoke.py``'s phase 5 gates
    (cosine at least 0.99, max|Δ| at most 0.1·max|g|); frozen leaves take
    no gradient, and an update leaves them bit-unchanged."""
    import socket
    import torch.distributed as dist
    from esme_tpu_torch import ESM2, mask_tokens, tokenize_unpad
    from esme_tpu_torch.parallel import initialize_distributed, make_mesh
    from esme_tpu_torch.train import ShardedMaskedPLM
    from types import SimpleNamespace
    rng = np.random.default_rng(6)
    seqs = [''.join(rng.choice(list('LAGVSERTIDPKQNFYMHWC'), int(n)))
            for n in rng.integers(30, 400, 12)]
    tok, _, cu, max_len = tokenize_unpad(seqs)
    masked, mask = mask_tokens(tok, rng=np.random.default_rng(7))
    batch = SimpleNamespace(tokens=tok, masked_tokens=masked, mask=mask,
                            cu_lens=cu, max_len=max_len)
    model = ESM2(num_layers=2, embed_dim=128, attention_heads=2, rng=0,
                 device=cuda)
    model.add_lora(rank=8, alpha=8)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    for p in model.params['layers']['attn'].values():
        for ad in p.get('lora', {}).values():
            ad['b'].copy_(torch.randn(ad['b'].shape, generator=gen,
                                      device=cuda) * 0.05)
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    initialize_distributed(f'127.0.0.1:{port}', 1, 0, device='cuda')
    try:
        mesh = make_mesh(1, 1, seq=1, device='cuda')
        plm = ShardedMaskedPLM(model, mesh, lora_only=True, seq_axis='seq')
        counters = (flash.segment_flash_fwd, flash.segment_flash_bwd,
                    headsplit.rotary_qk)

        def count():
            return [c.launches for c in counters] + [
                flash.segment_flash_fwd.rect_launches,
                flash.segment_flash_bwd.rect_launches,
                headsplit.rotary_qk.inverse_launches]
        before = count()
        loss, got = plm._grad_step([batch])
        torch.cuda.synchronize()
        assert [b - a for a, b in zip(before, count())] == [0, 0, 4, 2, 2, 2]
        with monkeypatch.context() as m:
            m.setattr(flash, 'segment_flash_fwd',
                      flash.segment_flash_fwd_plain)
            m.setattr(flash, 'segment_flash_bwd',
                      flash.segment_flash_bwd_plain)
            m.setattr(headsplit, 'rotary_qk', headsplit.rotary_qk_plain)
            loss_p, ref = plm._grad_step([batch])
        assert abs(loss.item() - loss_p.item()) <= \
            2.0 ** -8 * abs(loss_p.item())
        pairs = dict(_flat_tree(ref))
        n = 0
        for name, a in _flat_tree(got):
            b = pairs[name]
            if a is None or b is None:
                assert a is None and b is None, name
                assert '.lora.' not in name or name.endswith('.scale'), name
                continue
            a, b = a.float().ravel(), b.float().ravel()
            cos = (a @ b / (a.norm() * b.norm())).item()
            rel = ((a - b).abs().max() / b.abs().max()).item()
            assert cos >= 0.99 and rel <= 0.1, (name, cos, rel)
            n += 1
        assert n == 3 * 2
        frozen = {name: t.clone() for name, t in _flat_tree(plm.params)
                  if '.lora.' not in name or name.endswith('.scale')}
        plm.training_step([batch])
        now = dict(_flat_tree(plm.params))
        assert all(torch.equal(now[k], t) for k, t in frozen.items())
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_lora_dropout_on_the_card(cuda):
    """LoRA dropout on a CUDA tensor: the keep rate within 5 standard
    deviations of 1 - p over 2^20 draws, kept values scaled by exactly
    1/(1 - p), the key fixing the mask. A checkpointed ``MaskedPLM`` step
    with dropout gives the same loss and adapter gradients, bit for bit,
    with ``remat='attn'`` (the kept attention output meets q, k and v
    recomputed under the recompute's masks) as with ``'full'`` (all
    recomputed): the recompute draws the forward's masks."""
    from esme_tpu_torch import ESM2
    from esme_tpu_torch.ops.linear import dropout, fold_in
    from esme_tpu_torch.train import MaskedPLM
    x = torch.ones(2 ** 20, device=cuda)
    y = dropout(x, 0.3, fold_in(5, 0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) <= 5 * (0.21 / x.numel()) \
        ** 0.5
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / 0.7))
    assert torch.equal(y, dropout(x, 0.3, fold_in(5, 0)))
    batch = _mlm_batch(6)
    out = {}
    for remat, rate in (('full', 0.3), ('attn', 0.3), ('full', 0.0)):
        model = ESM2(num_layers=2, embed_dim=128, attention_heads=2, rng=0,
                     device=cuda, checkpointing=True)
        model.add_lora(rank=8, alpha=8, dropout_p=rate)
        for p in model.params['layers']['attn'].values():
            for ad in p.get('lora', {}).values():
                ad['b'].fill_(0.05)
        out[remat, rate] = MaskedPLM(model, remat=remat)._grad_step(batch)
    torch.cuda.synchronize()
    full, attn, plain = out['full', 0.3], out['attn', 0.3], out['full', 0.0]
    assert torch.equal(full[0], attn[0]) and not torch.equal(full[0],
                                                             plain[0])
    for (name, a), (_, b) in zip(_flat_tree(full[1]), _flat_tree(attn[1])):
        assert (a is None and b is None) or torch.equal(a, b), name


@pytest.mark.cuda
def test_embedding_grad_is_reproducible_on_the_card(cuda):
    """The token embedding's gradient (``models/modules.py:embed_tokens``,
    a fixed-order indicator product) at ESMC's vocabulary and width (64,
    960) on 50,176 bf16 rows: bit-equal over four repeats (the card's
    ``aten::embedding_dense_backward`` was not), and each entry within one
    bf16 rounding (2^-8 relative) of the fp64 sum."""
    from esme_tpu_torch.models.config import esmc_config
    from esme_tpu_torch.models.modules import embed_tokens
    cfg = esmc_config()
    gen = torch.Generator(device=cuda).manual_seed(0)
    ids = torch.randint(0, 64, (50_176,), device=cuda, generator=gen)
    dy = torch.randn(50_176, 960, device=cuda, generator=gen) \
        .to(torch.bfloat16)
    table = torch.zeros(64, 960, device=cuda, dtype=torch.bfloat16,
                        requires_grad=True)

    def grad():
        x = embed_tokens(ids, {'embed_tokens': table}, cfg)
        return torch.autograd.grad(x, table, dy)[0]
    first = grad()
    assert all(torch.equal(grad(), first) for _ in range(4))
    exact = torch.zeros(64, 960, dtype=torch.float64, device=cuda) \
        .index_add_(0, ids, dy.double())
    assert ((first.double() - exact).abs()
            <= 2.0 ** -8 * exact.abs()).all()


@pytest.mark.cuda
def test_scoring_kernels_match_plain(cuda, monkeypatch):
    """``predict_mask_margin`` on a 2-layer bf16 ESM2 (width 128, head dim
    64) over a 60-residue sequence in batches of 16: launches exact (H1
    and H3 once a layer a forward), the same scores on a second call, and
    against the same call through the plain versions max|Δscore| <= 0.5
    (twice ``chip_smoke.py``'s per-log-prob gate) and Spearman ρ >= 0.99
    over the 1,200 variants."""
    from esme_tpu_torch import ESM2
    from esme_tpu_torch.metrics import spearman
    from esme_tpu_torch.variant import predict_mask_margin
    model = ESM2(num_layers=2, embed_dim=128, attention_heads=2, rng=0,
                 device=cuda)
    rng = np.random.default_rng(3)
    seq = ''.join(rng.choice(list('LAGVSERTIDPKQNFYMHWC'), 60))
    counters = (flash.segment_flash_fwd, headsplit.rotary_qk)
    before = [c.launches for c in counters]
    got = predict_mask_margin(model, seq, batch_size=16)
    assert [c.launches - b for c, b in zip(counters, before)] == [8, 8]
    assert predict_mask_margin(model, seq, batch_size=16) == got
    monkeypatch.setattr(fused_attn, 'rotary_qk', headsplit.rotary_qk_plain)
    monkeypatch.setattr(fused_attn, 'segment_flash_fwd',
                        flash.segment_flash_fwd_plain)
    ref = predict_mask_margin(model, seq, batch_size=16)
    assert list(got) == list(ref) and len(got) == 1200
    a, b = np.array(list(got.values())), np.array(list(ref.values()))
    assert np.abs(a - b).max() <= 0.5
    assert spearman(a, b) >= 0.99


def _quant_kernels(dtype):
    """Seeded ``(in, out)`` kernels as torch stores them, transposed:
    ESM2-650M's fc1 (its 16th and 17th row maxima tie in bf16, seed 0) and
    a stack of three."""
    out = {}
    for name, shape, seed in (('fc1', (1280, 5120), 0),
                              ('stacked', (3, 256, 192), 1)):
        w = np.random.default_rng(seed).standard_normal(
            (*shape[:-2], shape[-1], shape[-2])) * 0.02
        out[name] = torch.from_numpy(np.swapaxes(w, -1, -2).copy()) \
            .float().to(dtype)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_quantizers_on_the_card_are_the_cpu_arithmetic(cuda, dtype):
    """``quantize_int8``, ``quantize_nf4`` and ``dequantize`` on the card
    bit-equal to the CPU on the same weights, dtypes included, the tied
    NF4 outlier rows in the same (lower index first) order."""
    from esme_tpu_torch import quant
    for name, w in _quant_kernels(dtype).items():
        for fn in (quant.quantize_int8, quant.quantize_nf4):
            ref = fn(w)
            got = fn(w.to(cuda))
            assert sorted(got) == sorted(ref)
            for k in ref:
                assert got[k].dtype == ref[k].dtype and torch.equal(
                    got[k].cpu(), ref[k]), (name, fn.__name__, k)
            for out in (torch.float32, torch.bfloat16):
                assert torch.equal(quant.dequantize(got, out).cpu(),
                                   quant.dequantize(ref, out)), (name, out)


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['8bit', '4bit'])
def test_quantized_model_kernels_match_plain(cuda, mode, monkeypatch):
    """A 2-layer bf16 ESM2 (width 128, head dim 64), quantized on the
    card: its forward launches H1 and H3 once a layer and no H2, and its
    log-probs against the same model through the plain versions have
    per-token centred cosine >= 0.99 and max|Δ| <= 0.25
    (``chip_smoke.py``'s phase-4 gates)."""
    from esme_tpu_torch import ESM2, tokenize_unpad
    model = ESM2(num_layers=2, embed_dim=128, attention_heads=2, rng=0,
                 device=cuda).quantize(mode)
    assert 'qvalue' in model.params['layers']['mlp']['fc2']
    rng = np.random.default_rng(4)
    seqs = [''.join(rng.choice(list('LAGVSERTIDPKQNFYMHWC'), n))
            for n in (200, 37, 310)]
    tok, _, cu, ml = tokenize_unpad(seqs)
    counters = (flash.segment_flash_fwd, headsplit.rotary_qk,
                flash.segment_flash_bwd)
    before = [c.launches for c in counters]
    got = model.predict_log_prob(tok, pad_args=(cu, ml))
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 2, 0]
    monkeypatch.setattr(fused_attn, 'rotary_qk', headsplit.rotary_qk_plain)
    monkeypatch.setattr(fused_attn, 'segment_flash_fwd',
                        flash.segment_flash_fwd_plain)
    ref = model.predict_log_prob(tok, pad_args=(cu, ml))
    a = got - got.mean(-1, keepdim=True)
    b = ref - ref.mean(-1, keepdim=True)
    cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
    assert bool(torch.isfinite(got).all())
    assert cos.min().item() >= 0.99 and (got - ref).abs().max().item() <= 0.25


@pytest.mark.cuda
def test_reshard_host_parts_onto_card(cuda, monkeypatch, tmp_path):
    """A (1, 2, 1) gloo world on the host (``tests/torch_cp_ranks.py:
    host_parts_rank``) trains ``ShardedMaskedPLM(grad_accum=2,
    seq_axis='seq')`` over a bf16 ESM2 of 2 layers, width 128, head dim 64
    for three micro-steps (an update, then a cycle left open) and saves
    its parts; a one-rank NCCL trainer on a (1, 1, 1) mesh on the card
    restores them (resharded): its params bit-equal to the host's at the
    cut; the micro-step that closes the cycle launches H9 L, H10 L, H3 2L
    of which L inverse, H1 and H2 never; the same micro-step through the
    plain versions from the same restore: the loss within 2^-8 and every
    gradient the update takes under ``chip_smoke.py``'s phase 5 gates
    (cosine at least 0.99, max|Δ| at most 0.1·max|g|)."""
    import multiprocessing
    import socket
    import torch.distributed as dist
    from types import SimpleNamespace
    from esme_tpu_torch import ESM2, mask_tokens, tokenize_unpad
    from esme_tpu_torch.parallel import initialize_distributed, make_mesh
    from esme_tpu_torch.train import CheckpointManager, ShardedMaskedPLM
    from esme_tpu_torch.train.trainer import _grad_tree
    from torch_cp_ranks import host_parts_rank

    def port():
        with socket.socket() as sock:
            sock.bind(('127.0.0.1', 0))
            return sock.getsockname()[1]
    rng = np.random.default_rng(6)
    seqs = [''.join(rng.choice(list('LAGVSERTIDPKQNFYMHWC'), int(n)))
            for n in rng.integers(30, 400, 12)]
    tok, _, cu, max_len = tokenize_unpad(seqs)
    masked, mask = mask_tokens(tok, rng=np.random.default_rng(7))
    batch = SimpleNamespace(tokens=tok, masked_tokens=masked, mask=mask,
                            cu_lens=cu, max_len=max_len)
    host = ESM2(num_layers=2, embed_dim=128, attention_heads=2, rng=0,
                device='cpu')
    ctx = multiprocessing.get_context('spawn')
    p0 = port()
    procs = [ctx.Process(target=host_parts_rank, args=(
        r, 2, p0, host.config, host.params, [batch], str(tmp_path)))
        for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    cut = torch.load(tmp_path / 'params.pt', weights_only=True)
    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.to(cuda)
                for k, v in tree.items()}
    model = ESM2(config=host.config, params=to_card(host.params),
                 device=cuda)
    L = model.config.num_layers
    initialize_distributed(f'127.0.0.1:{port()}', 1, 0, device='cuda')
    try:
        mesh = make_mesh(1, 1, seq=1, device='cuda')
        mgr = CheckpointManager(tmp_path / 'ckpt', monitor=None)

        def resumed():
            plm = ShardedMaskedPLM(model, mesh, learning_rate=1e-3,
                                   grad_accum=2, seq_axis='seq')
            plm.state = mgr.restore(plm.state)
            grads = {}
            step = plm.optimizer.step

            def take(*args, **kw):
                grads.update(_flat_tree(_grad_tree(plm._views)))
                return step(*args, **kw)
            plm.optimizer.step = take
            return plm, grads
        plm, got = resumed()
        assert plm.step == 3
        cut = dict(_flat_tree(cut))
        for name, t in _flat_tree(plm.params):
            assert torch.equal(t.cpu().view(torch.uint8),
                               cut[name].view(torch.uint8)), name
        counters = (flash.segment_flash_fwd, flash.segment_flash_bwd,
                    headsplit.rotary_qk)

        def count():
            return [c.launches for c in counters] + [
                flash.segment_flash_fwd.rect_launches,
                flash.segment_flash_bwd.rect_launches,
                headsplit.rotary_qk.inverse_launches]
        before = count()
        loss = plm.training_step([batch])
        torch.cuda.synchronize()
        assert [b - a for a, b in zip(before, count())] == \
            [0, 0, 2 * L, L, L, L]
        plain, ref = resumed()
        with monkeypatch.context() as m:
            m.setattr(flash, 'segment_flash_fwd',
                      flash.segment_flash_fwd_plain)
            m.setattr(flash, 'segment_flash_bwd',
                      flash.segment_flash_bwd_plain)
            m.setattr(headsplit, 'rotary_qk', headsplit.rotary_qk_plain)
            loss_p = plain.training_step([batch])
        assert abs(loss - loss_p) <= 2.0 ** -8 * abs(loss_p)
        assert sorted(got) == sorted(ref) and got
        for name, a in got.items():
            a, b = a.float().ravel(), ref[name].float().ravel()
            cos = (a @ b / (a.norm() * b.norm())).item()
            rel = ((a - b).abs().max() / b.abs().max()).item()
            assert cos >= 0.99 and rel <= 0.1, (name, cos, rel)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_kv_gather_two_nccl_ranks(cuda, tmp_path):
    """A two-rank NCCL world, one card a rank (``tests/torch_cp_ranks.py:
    nccl_gather_rank``), gathers one layer's k and v (ESM2-650M's width:
    20 heads of 64, bf16, 4,096 rows split in two) and the ids through
    ``parallel/context.py:make_kv_gather``, and reduce-scatters their
    gradients (every rank's own cotangent over all rows); the one-rank
    result is the same gather and backward in a one-rank NCCL world on
    the whole rows under the summed cotangent. Gates: each rank ran on
    its own card; its gathered k, v and ids bit-equal to the one-rank
    ones; its dk and dv bit-equal to the one-rank gradient's rows (a sum
    of two bf16 terms is rounded once, by NCCL and by the card alike)."""
    import multiprocessing
    import socket
    import torch.distributed as dist
    from esme_tpu_torch.parallel import (initialize_distributed,
                                         make_kv_gather, make_mesh)
    from torch_cp_ranks import nccl_gather_rank
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two CUDA cards (a two-rank NCCL world)')

    def port():
        with socket.socket() as sock:
            sock.bind(('127.0.0.1', 0))
            return sock.getsockname()[1]
    n, T, HD = 2, 4096, 1280
    gen = torch.Generator().manual_seed(21)
    k, v = (torch.randn(T, HD, generator=gen).to(torch.bfloat16)
            for _ in range(2))
    dk, dv = (torch.randn(n, T, HD, generator=gen).to(torch.bfloat16)
              for _ in range(2))
    ctx = multiprocessing.get_context('spawn')
    p0 = port()
    procs = [ctx.Process(target=nccl_gather_rank,
                         args=(r, n, p0, k, v, dk, dv, str(tmp_path)))
             for r in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * n
    ranks = [torch.load(tmp_path / f'rank{r}.pt', weights_only=True)
             for r in range(n)]
    assert [r['device'] for r in ranks] == list(range(n))

    initialize_distributed(f'127.0.0.1:{port()}', 1, 0, device='cuda')
    try:
        mesh = make_mesh(1, 1, seq=1, device='cuda')
        kr, vr = (x.to(cuda).requires_grad_() for x in (k, v))
        ids = torch.arange(T, dtype=torch.int32, device=cuda)
        kf, vf, sf = make_kv_gather(mesh['seq'])(kr, vr, ids)
        ((kf * (dk[0].to(cuda) + dk[1].to(cuda))).sum()
         + (vf * (dv[0].to(cuda) + dv[1].to(cuda))).sum()).backward()
        one = {'k': kf.detach().cpu(), 'v': vf.detach().cpu(),
               'ids': sf.cpu(), 'dk': kr.grad.cpu(), 'dv': vr.grad.cpu()}
    finally:
        dist.destroy_process_group()
    for r, res in enumerate(ranks):
        lo, hi = r * T // n, (r + 1) * T // n
        for key in ('k', 'v', 'ids'):
            assert torch.equal(res[key], one[key]), (r, key)
        for key in ('dk', 'dv'):
            assert torch.equal(res[key].view(torch.int16),
                               one[key][lo:hi].view(torch.int16)), (r, key)
