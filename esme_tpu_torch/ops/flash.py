"""Segment-flash attention, forward and backward, for packed (varlen)
batches.

Counterpart of ``esme_tpu/ops/flash.py``. Non-causal self-attention
over a flat token stream where token *t* attends token *s* iff
``seg_ids[t] == seg_ids[s]``.

:func:`segment_flash_fwd` is the wrapper of kernel H1
(``csrc/flash_fwd_sm90.cu`` at every head dim; its mma.sync form
``csrc/flash_fwd.cu`` stays built as a yardstick), which replaces the TPU
kernels ``esme_tpu/ops/flash.py:_fwd_kernel`` and ``:_fwd_jobs_kernel``;
:func:`segment_flash_bwd` is the wrapper of kernel H2
(``csrc/flash_bwd_sm90.cu`` at every head dim; its mma.sync form
``csrc/flash_bwd.cu`` likewise), which replaces the three TPU
backward paths
``:_dq_kernel``/``:_dkv_kernel``, ``:_dq_jobs_kernel``/``:_dkv_jobs_kernel``
and ``:_dkvq_jobs_kernel``. Each routes by a static rule on the head
dim (:func:`fwd_route`, :func:`bwd_route`). With the keys' own ids
(``seg_k``), :func:`segment_flash_fwd` launches kernel H9, a kernel of
its own over the body of H1's forms, which replaces the forward of
``:flash_rect_attention`` (K-rect) for context parallelism, and
:func:`segment_flash_bwd` launches kernel H10, kernels of their own over
the bodies of H2's forms, which replace its backward
(:func:`segment_flash_rect`, :func:`flash_rect_attention`). All read and
write the ``(T, H·D)`` layout directly (so the TPU relayouts
``headsplit.py:_split_one_kernel_t`` for v and do and
``:_merge_kernel_t`` for o and dv have no counterpart). On
a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it runs its plain PyTorch version (``*_plain``). What bounds each
kernel and what its design does about it is noted in its CUDA source.

The public entries with a gradient, :func:`flash_segment_attention`
(``(T, H, D)`` or ``(H, T, D)``) and :func:`flash_tm` (token-minor
``(H, D, T)``), run H1 forward and H2 backward through one autograd
Function over ``(T, H·D)``, with kernel H4 (``ops/headsplit.py``)
relayouting the other layouts on either side. :func:`segment_flash` is
the same Function on ``(T, H·D)`` itself: the model's attention without
RoPE (ESM1b, ESM1v).

Block spans: packed batches make attention block-diagonal. For each q
block the contiguous span ``[kstart, kend)`` of k blocks that share a
segment with it, and for each k block the span ``[qstart, qend)`` of q
blocks (the backward's dk/dv direction), are computed once per forward
(:func:`flash_spans`; the segment ids are the same in every layer), and
the kernels visit only those tiles. The kernels' tiles are their own
(H1 and H2's dq pass: 128-row q blocks over 64-row k tiles; H2's dk/dv
pass: 64-row k blocks over 64-row q tiles); the 256-token alignment of
the packed batch (``models/esm.py:ALIGN``) is unrelated.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .attention import NEG_INF
from .headsplit import relayout

# The kernels' tile sizes (csrc/flash_fwd*.cu and csrc/flash_bwd*.cu: BQ,
# BK/KT; keep them equal): q blocks and k tiles of H1 and of H2's dq pass,
# k blocks and q tiles of H2's dk/dv pass
BLOCK_Q = 128
BLOCK_K = 64
BLOCK_KV = 64
BLOCK_QT = 64

HEAD_DIMS = (16, 24, 32, 64, 128)

# H1's and H2's routes, static rules on the head dim: library -> (entry,
# error string). The Hopper forms (wgmma fed by TMA) take every head dim,
# 16 and 24 on 32-column tiles (csrc/sm90_common.cuh: Geo). The mma.sync
# forms stay built: chip_smoke.py checks and times the Hopper forms
# against them, and the probe tools run them at 16 and 24
# (esme_tpu_torch/tools: SM90_HEAD_DIMS).
FWD_ROUTES = {
    'flash_fwd_sm90': ('esme_segment_flash_fwd_sm90',
                       'esme_flash_fwd_sm90_error_string'),
    'flash_fwd': ('esme_segment_flash_fwd', 'esme_flash_error_string'),
}
BWD_ROUTES = {
    'flash_bwd_sm90': ('esme_segment_flash_bwd_sm90',
                       'esme_flash_bwd_sm90_error_string'),
    'flash_bwd': ('esme_segment_flash_bwd', 'esme_flash_bwd_error_string'),
}
SM90_HEAD_DIMS = (16, 24, 32, 64, 128)
# The lse of a query row that no key shares a segment with (a q block with
# an empty span, which only H9 meets): the kernels' running max of no key,
# -1e30 in base 2, carried to base e by an fp32 product with ln 2
EMPTY_LSE = (torch.tensor(NEG_INF, dtype=torch.float32)
             * torch.tensor(math.log(2), dtype=torch.float32)).item()
# H9, the rectangular forward: the entry of each of H1's libraries that
# launches its rectangular kernel (per-side ids and lengths)
FWD_RECT_ENTRIES = {
    'flash_fwd_sm90': 'esme_segment_flash_fwd_rect_sm90',
    'flash_fwd': 'esme_segment_flash_fwd_rect',
}
# H10, the rectangular backward: the entry of each of H2's libraries that
# launches its rectangular kernels
BWD_RECT_ENTRIES = {
    'flash_bwd_sm90': 'esme_segment_flash_bwd_rect_sm90',
    'flash_bwd': 'esme_segment_flash_bwd_rect',
}


# The head dims at which H9 takes a launch order (:func:`fwd_order`):
# ESM2-650M's, where it was measured (csrc/flash_fwd_sm90.cu's header); at
# the others, and H1 at every head dim, the kernels run in q-block order
# (H1's 30 waves of CTAs lost nothing to the order)
ORDER_HEAD_DIMS = (64,)
# H1's libraries whose H9 entry takes the launch order (a trailing
# pointer; null is q-block order)
ORDERED_LIBRARIES = ('flash_fwd_sm90',)


def fwd_route(head_dim: int) -> str:
    """The library H1 launches at this head dim."""
    return 'flash_fwd_sm90' if head_dim in SM90_HEAD_DIMS else 'flash_fwd'


def bwd_route(head_dim: int) -> str:
    """The library H2 launches at this head dim."""
    return 'flash_bwd_sm90' if head_dim in SM90_HEAD_DIMS else 'flash_bwd'


def _overlap(seg_ids: torch.Tensor, block_q: int, block_k: int,
             seg_k: torch.Tensor | None = None):
    """``(nqb, nkb)`` bool: q block i and k block j share a segment id
    range; the keys' ids are ``seg_k`` (self-attention when None). A
    ragged last block of either side is padded with that side's last id,
    which leaves its min/max unchanged."""
    def blocks(s, b):
        pad = (-s.shape[0]) % b
        if pad:
            s = torch.cat([s, s[-1:].expand(pad)])
        s = s.reshape(-1, b)
        return s.amin(1), s.amax(1)

    qmin, qmax = blocks(seg_ids, block_q)
    kmin, kmax = blocks(seg_ids if seg_k is None else seg_k, block_k)
    return (kmin[None, :] <= qmax[:, None]) & (kmax[None, :] >= qmin[:, None])


def _spans(overlap: torch.Tensor):
    n = overlap.shape[1]
    idx = torch.arange(n, dtype=torch.int32, device=overlap.device)
    start = torch.where(overlap, idx, n).amin(1)
    end = torch.where(overlap, idx + 1, 0).amax(1)
    return start.to(torch.int32), end.to(torch.int32)


def block_spans(seg_ids: torch.Tensor, block_q: int, block_k: int,
                seg_k: torch.Tensor | None = None):
    """Per-q-block ``[kstart, kend)`` span of overlapping k blocks, int32
    (``esme_tpu/ops/flash.py:88-122``, its first two outputs). ``seg_k``:
    the keys' own ids for rectangular attention (context parallelism:
    local queries over the gathered keys); None means self-attention.

    Exact for monotonic (packed) segment ids; for others the span is the
    min..max overlapping block and the in-kernel mask removes the rest.
    A q block that shares no id range with any k block gets an empty span
    (``kstart = nkb``, ``kend = 0``).
    """
    return _spans(_overlap(seg_ids, block_q, block_k, seg_k))


def transposed_spans(seg_ids: torch.Tensor, block_q: int, block_k: int,
                     seg_k: torch.Tensor | None = None):
    """Per-k-block ``[qstart, qend)`` span of overlapping q blocks, int32:
    the backward's dk/dv direction (``esme_tpu/ops/flash.py:88-122``,
    its last two outputs); ``seg_k`` as in :func:`block_spans`."""
    return _spans(_overlap(seg_ids, block_q, block_k, seg_k).T)


def flash_spans(seg_ids: torch.Tensor):
    """Every span the kernels walk, at their own tiles: ``(kstart, kend)``
    per ``BLOCK_Q`` q block in ``BLOCK_K`` tiles (H1 and H2's dq pass)
    and ``(qstart, qend)`` per ``BLOCK_KV`` k block in ``BLOCK_QT`` tiles
    (H2's dk/dv pass)."""
    return (*block_spans(seg_ids, BLOCK_Q, BLOCK_K),
            *transposed_spans(seg_ids, BLOCK_QT, BLOCK_KV))


def dkv_stage_rows(head_dim: int) -> int:
    """The q rows a stage of H2's and H10's Hopper dk/dv pass at this head
    dim (``csrc/flash_bwd_sm90.cu:dkv_qt``): 128 at D = 64, a ``BLOCK_QT``
    tile at the others."""
    return 2 * BLOCK_QT if head_dim == 64 else BLOCK_QT


def dkv_stages(qstart: torch.Tensor, qend: torch.Tensor, stage_rows: int):
    """The stages each CTA of the Hopper dk/dv pass walks, by the kernel's
    index arithmetic (``csrc/flash_bwd_sm90.cu:dkv_union_span``,
    ``dkv_body``): CTA ``c`` holds the 64-row k blocks ``2c`` and ``2c +
    1`` and walks the union of their ``[qstart, qend)`` spans of
    ``BLOCK_QT`` tiles (a last odd block alone keeps its own), rounded out
    to stages of ``stage_rows`` q rows. Returns int32 ``(sb0, n)`` per
    CTA: stage ``i < n`` covers q rows ``[(sb0 + i) stage_rows, (sb0 + i +
    1) stage_rows)``; ``n`` is 0 where the union is empty. Rows past the
    queries' end are zeros in the kernel's tiles."""
    r = stage_rows // BLOCK_QT
    qs, qe = qstart.long(), qend.long()
    if qs.numel() % 2:
        qs = torch.cat([qs, qs[-1:]])
        qe = torch.cat([qe, qe[-1:]])
    q0, q1 = qs.view(-1, 2).amin(1), qe.view(-1, 2).amax(1)
    sb0 = q0 // r
    n = torch.where(q1 > q0, (q1 + r - 1) // r - sb0, 0)
    return sb0.to(torch.int32), n.to(torch.int32)


def fwd_order(kstart: torch.Tensor, kend: torch.Tensor) -> torch.Tensor:
    """H9's launch order, int32 ``(3, nqb)`` on the spans' device: row 0
    the q blocks by falling span length (``kend - kstart`` k tiles), rows
    1 and 2 their ``kstart`` and ``kend`` in that order.
    Ties keep q-block order (a stable sort), and a block with an empty
    span (``kend <= kstart``: length 0) goes last. The kernel's CTA i runs
    the block of entry ``i // H``, head ``i % H`` (every head of a block
    together), so the longest blocks start in the first wave and the
    short ones fill the last; it reads the entry's block and span in one
    round of independent loads, as in q-block order it reads the span of
    its own block. Each CTA computes what it computed in q-block order,
    so o and lse keep their bits."""
    length = (kend - kstart).clamp_min(0)
    blocks = torch.argsort(-length, stable=True)
    return torch.stack([blocks.to(torch.int32), kstart[blocks], kend[blocks]])


class Spans(NamedTuple):
    """The spans a context-parallel forward computes once for every layer:
    the four of :func:`rect_flash_spans` and, where the span site computed
    it, H9's launch order (:func:`fwd_order`; None: q-block order).
    ``Spans(*spans)`` takes a plain four-tuple too. The backward reads the
    first four (``spans[:4]``)."""
    kstart: torch.Tensor
    kend: torch.Tensor
    qstart: torch.Tensor
    qend: torch.Tensor
    order: torch.Tensor | None = None


def with_order(spans) -> Spans:
    """``spans`` (:func:`rect_flash_spans`) with H9's launch order: what a
    context-parallel span site computes once per forward, with torch ops
    on the spans' device."""
    return Spans(*spans[:4], fwd_order(spans[0], spans[1]))


def segment_flash_fwd_plain(q2, k2, v2, seg_ids, kstart, kend,
                            num_heads: int, scale: float | None = None,
                            seg_k=None, order=None):
    """Plain PyTorch version of H1, and with ``seg_k`` of H9: the same
    inputs, the same outputs (the launch order ``order`` moves none, and
    is not read).

    Queries ``q2 (Tq, H·D)`` with ids ``seg_ids`` attend keys and values
    ``k2``/``v2 (Tk, H·D)`` with ids ``seg_k`` (``seg_ids`` and Tk = Tq
    when None). Processes 1024 query rows at a time against the union of
    their k spans, so memory stays ``O(H · 1024 · span)``. Scores, the
    max, the sum and lse are fp32; p is rounded to the value dtype before
    the product with v and normalised after it, as in the kernel. A q
    block with an empty span (``kend <= kstart``: no key shares its ids)
    gets o = 0 and lse = ``EMPTY_LSE``, as the kernels write it.
    Returns ``o (Tq, H·D)`` in q's dtype and ``lse (H, Tq)`` fp32.
    """
    T, HD = q2.shape
    Tk = k2.shape[0]
    H = num_heads
    D = HD // H
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    seg_k = seg_ids if seg_k is None else seg_k
    q = q2.reshape(T, H, D)
    k = k2.reshape(Tk, H, D)
    v = v2.reshape(Tk, H, D)
    o = torch.empty_like(q2)
    lse = torch.empty((H, T), dtype=torch.float32, device=q2.device)
    ks, ke = kstart.tolist(), kend.tolist()
    per = max(1, 1024 // BLOCK_Q)
    nqb = len(ks)
    for b0 in range(0, nqb, per):
        b1 = min(nqb, b0 + per)
        r0, r1 = b0 * BLOCK_Q, min(T, b1 * BLOCK_Q)
        k0 = min(ks[b0:b1]) * BLOCK_K
        k1 = min(Tk, max(ke[b0:b1]) * BLOCK_K)
        if k1 <= k0:
            continue
        s = torch.einsum('thd,shd->hts', q[r0:r1].float(),
                         k[k0:k1].float()) * scale
        mask = seg_ids[r0:r1, None] == seg_k[None, k0:k1]
        s = torch.where(mask[None], s, NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        pv = torch.einsum('hts,shd->htd', p.to(v.dtype).float(),
                          v[k0:k1].float())
        l_safe = torch.where(l == 0, 1.0, l)
        o[r0:r1] = (pv / l_safe).transpose(0, 1).reshape(r1 - r0, HD) \
            .to(q2.dtype)
        lse[:, r0:r1] = (m + torch.log(l_safe))[..., 0]
    for b in range(nqb):
        if ke[b] <= ks[b]:
            o[b * BLOCK_Q:(b + 1) * BLOCK_Q] = 0
            lse[:, b * BLOCK_Q:(b + 1) * BLOCK_Q] = EMPTY_LSE
    return o, lse


def segment_flash_fwd(q2, k2, v2, seg_ids, kstart, kend, num_heads: int,
                      scale: float | None = None, seg_k=None, order=None):
    """Segment-masked flash attention forward (kernel H1; with ``seg_k``,
    kernel H9).

    Routed by a static rule on the head dim (:func:`fwd_route`): every
    head dim in ``SM90_HEAD_DIMS`` launches the Hopper form,
    ``csrc/flash_fwd_sm90.cu`` (``wgmma`` fed by TMA through an
    ``mbarrier`` ring of 128-key stages; the segment mask only on stages
    that cross a segment; D = 16 and 24 on 32-column tiles), any other the
    mma.sync form, ``csrc/flash_fwd.cu``. Both compute the same function
    and are deterministic; ``launches`` counts either.

    With ``seg_k`` the keys have ids of their own and may be a different
    stream (context parallelism: the rank's queries over the gathered
    keys): the same route launches H9, the rectangular kernel of
    the same library, which replaces the TPU kernel K-rect's forward
    (``esme_tpu/ops/flash.py:1168 flash_rect_attention`` → ``_fwd``);
    ``rect_launches`` counts it.

    Args:
        q2: ``(Tq, H·D)`` with RoPE already applied.
        k2, v2: ``(Tk, H·D)``, k with RoPE already applied; Tk = Tq
            without ``seg_k``.
        seg_ids: ``(Tq,)`` int32, the queries' ids (and the keys' without
            ``seg_k``).
        kstart, kend: ``(ceil(Tq / BLOCK_Q),)`` int32 spans in units of
            ``BLOCK_K`` from :func:`block_spans` at the kernel's tiles
            (with ``seg_k`` given to it too).
        num_heads: H.
        scale: the scores' scale, ``1/sqrt(D)`` when None.
        seg_k: ``(Tk,)`` int32, the keys' ids; None for self-attention.
        order: with ``seg_k``, ``(3, nqb)`` int32, H9's launch order
            (:func:`fwd_order` over these spans), taken at the head dims
            of ``ORDER_HEAD_DIMS`` (q-block order at the others); None:
            q-block order. It moves no bit of o or lse, and the plain
            version ignores it. H1 takes none (``ValueError``).
    Returns:
        ``o (Tq, H·D)`` in q's dtype and ``lse (H, Tq)`` fp32.
    """
    if order is not None and seg_k is None:
        raise ValueError('segment_flash_fwd: H1 runs in q-block order; only '
                         'H9 (with seg_k) takes a launch order')
    if q2.device.type == 'cpu':
        return segment_flash_fwd_plain(q2, k2, v2, seg_ids, kstart, kend,
                                       num_heads, scale, seg_k)
    Tq, HD = q2.shape
    Tk = Tq if seg_k is None else k2.shape[0]
    H = num_heads
    D = HD // H
    what = 'segment_flash_fwd'
    _check_cuda_inputs(what, (('q', q2, Tq), ('k', k2, Tk), ('v', v2, Tk)),
                       H, D)
    nqb = -(-Tq // BLOCK_Q)
    _check_index_inputs(what, q2.device, (
        ('seg_ids', seg_ids, Tq, torch.int32),
        *((('seg_k', seg_k, Tk, torch.int32),) if seg_k is not None else ()),
        ('kstart', kstart, nqb, torch.int32),
        ('kend', kend, nqb, torch.int32),
        *((('order', order, (3, nqb), torch.int32),) if order is not None
          else ())))
    if D not in ORDER_HEAD_DIMS:
        order = None
    o, lse = launch_fwd(fwd_route(D), q2, k2, v2, seg_ids, kstart, kend, H,
                        scale, seg_k=seg_k, order=order)
    if order is not None:
        segment_flash_fwd.ordered_launches += 1
    if seg_k is None:
        segment_flash_fwd.launches += 1
    else:
        segment_flash_fwd.rect_launches += 1
    return o, lse


segment_flash_fwd.launches = 0
segment_flash_fwd.rect_launches = 0
# H9's launches that took a launch order (a share of rect_launches)
segment_flash_fwd.ordered_launches = 0


def launch_fwd(name, q2, k2, v2, seg_ids, kstart, kend, num_heads: int,
               scale: float | None = None, lib=None, seg_k=None, order=None):
    """H1's library ``name`` (a key of ``FWD_ROUTES``) launched through its
    C entry on :func:`segment_flash_fwd`'s arguments, which it does not
    check; no counter moves. With ``seg_k`` the library's rectangular
    entry (``FWD_RECT_ENTRIES``) launches H9. ``order`` (:func:`fwd_order`)
    goes to H9's entry of ``ORDERED_LIBRARIES`` as its trailing pointer
    (None: null, q-block order); the other forms take none.
    ``lib``, another build of the same entry (an A/B variant), takes the
    library's place. The wrapper's launch, and a direct one for timing and
    comparison. Returns ``o, lse``."""
    from .. import _build
    T, HD = q2.shape
    D = HD // num_heads
    entry, error_string = FWD_ROUTES[name]
    lib = _build.library(name) if lib is None else lib
    o = torch.empty_like(q2)
    lse = torch.empty((num_heads, T), dtype=torch.float32, device=q2.device)
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    stream = torch.cuda.current_stream(q2.device).cuda_stream
    if seg_k is None:
        rc = getattr(lib, entry)(
            *(x.data_ptr() for x in (q2, k2, v2, seg_ids, kstart, kend, o,
                                     lse)),
            T, num_heads, D, scale, stream)
        _build.check(rc, lib, error_string, f'segment_flash_fwd ({name})')
    else:
        tail = (None if order is None else order.data_ptr(),) \
            if name in ORDERED_LIBRARIES else ()
        rc = getattr(lib, FWD_RECT_ENTRIES[name])(
            *(x.data_ptr() for x in (q2, k2, v2, seg_ids, seg_k, kstart,
                                     kend, o, lse)),
            T, k2.shape[0], num_heads, D, scale, stream, *tail)
        _build.check(rc, lib, error_string,
                     f'segment_flash_fwd, rectangular ({name})')
    return o, lse


def _check_cuda_inputs(what, tensors, H, D):
    """The kernels take contiguous, 16-byte aligned bf16 ``(rows, H·D)``
    tensors on one CUDA device with D in ``HEAD_DIMS``; ``tensors`` holds
    ``(name, tensor, rows)``, q first."""
    q2 = tensors[0][1]
    if q2.device.type != 'cuda':
        raise ValueError(f'{what}: unsupported device {q2.device}')
    for name, t, rows in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f'{what}: the CUDA kernel takes bf16; {name} '
                            f'is {t.dtype} (fp32 runs on the CPU through '
                            'the plain version)')
        if t.shape != (rows, q2.shape[1]) or t.device != q2.device \
                or not t.is_contiguous():
            raise ValueError(f'{what}: {name} must be a contiguous '
                             f'{(rows, q2.shape[1])} tensor on {q2.device}')
        if t.data_ptr() % 16:
            raise ValueError(f'{what}: {name} must be 16-byte aligned')
    if q2.dim() != 2 or q2.shape[1] != H * D or D not in HEAD_DIMS:
        raise ValueError(f'{what}: head dim {D} of {tuple(q2.shape)} with '
                         f'{H} heads is not one of {HEAD_DIMS}')


def _check_index_inputs(what, device, specs):
    """Each ``(name, tensor, shape, dtype)`` is contiguous on ``device``
    with that shape and dtype."""
    for name, t, shape, dtype in specs:
        shape = shape if isinstance(shape, tuple) else (shape,)
        if t.dtype != dtype or tuple(t.shape) != shape \
                or t.device != device or not t.is_contiguous():
            raise ValueError(f'{what}: {name} must be a contiguous '
                             f'{dtype} {shape} tensor on {device}')

def attention_delta(o2, do2, num_heads: int):
    """``delta = rowsum(do · o)`` per head, fp32 ``(H, T)``: the
    softmax-backward term the backward kernels take
    (``esme_tpu/ops/fused_attn.py:149-153``)."""
    T, HD = o2.shape
    return (do2.float() * o2.float()).reshape(T, num_heads, -1).sum(-1) \
        .T.contiguous()


def segment_flash_bwd_plain(q2, k2, v2, do2, lse, delta, seg_ids, kstart,
                            kend, qstart, qend, num_heads: int, seg_k=None):
    """Plain PyTorch version of H2, and with ``seg_k`` of H10: the same
    inputs, the same outputs.

    Queries ``q2``/``do2 (Tq, H·D)`` with ids ``seg_ids`` over keys and
    values ``k2``/``v2 (Tk, H·D)`` with ids ``seg_k`` (``seg_ids`` and
    Tk = Tq when None). Processes 1024 query rows at a time against the
    union of their k spans (``qstart``/``qend`` are taken for the
    kernel's signature and not needed: dk and dv of each chunk are added
    into fp32 sums, and a key row that no query shares an id with keeps
    dk = dv = 0). Per same-segment pair and head, as K4/K5
    (``esme_tpu/ops/flash.py:496-508, 533-549``): ``p = exp(q·k·scale -
    lse)``, ``dp = do·v``, ``ds = p·(dp - delta)·scale`` in fp32; dv sums
    ``p·do`` with p rounded to the value dtype, dk and dq sum ``ds·q``
    and ``ds·k`` with ds rounded to it; each gradient is rounded once at
    the end. Returns ``dq (Tq, H·D)``, ``dk, dv (Tk, H·D)`` in q's dtype.
    """
    T, HD = q2.shape
    Tk = k2.shape[0]
    H = num_heads
    D = HD // H
    scale = 1.0 / math.sqrt(D)
    dt = q2.dtype
    seg_k = seg_ids if seg_k is None else seg_k
    q, do = (x.reshape(T, H, D) for x in (q2, do2))
    k, v = (x.reshape(Tk, H, D) for x in (k2, v2))
    dq = torch.zeros_like(q2)
    dk = torch.zeros((Tk, H, D), dtype=torch.float32, device=q2.device)
    dv = torch.zeros_like(dk)
    ks, ke = kstart.tolist(), kend.tolist()
    per = max(1, 1024 // BLOCK_Q)
    nqb = len(ks)
    for b0 in range(0, nqb, per):
        b1 = min(nqb, b0 + per)
        r0, r1 = b0 * BLOCK_Q, min(T, b1 * BLOCK_Q)
        k0 = min(ks[b0:b1]) * BLOCK_K
        k1 = min(Tk, max(ke[b0:b1]) * BLOCK_K)
        if k1 <= k0:
            continue
        qf, dof = q[r0:r1].float(), do[r0:r1].float()
        kf, vf = k[k0:k1].float(), v[k0:k1].float()
        s = torch.einsum('thd,shd->hts', qf, kf) * scale
        mask = seg_ids[r0:r1, None] == seg_k[None, k0:k1]
        p = torch.where(mask[None], torch.exp(s - lse[:, r0:r1, None]), 0.0)
        dp = torch.einsum('thd,shd->hts', dof, vf)
        ds = p * (dp - delta[:, r0:r1, None]) * scale
        p = p.to(dt).float()
        ds = ds.to(dt).float()
        dv[k0:k1] += torch.einsum('hts,thd->shd', p, dof)
        dk[k0:k1] += torch.einsum('hts,thd->shd', ds, qf)
        dq[r0:r1] = torch.einsum('hts,shd->thd', ds, kf) \
            .reshape(r1 - r0, HD).to(dt)
    return dq, dk.reshape(Tk, HD).to(dt), dv.reshape(Tk, HD).to(dt)


def segment_flash_bwd(q2, k2, v2, do2, lse, delta, seg_ids, kstart, kend,
                      qstart, qend, num_heads: int, seg_k=None):
    """Segment-masked flash attention backward (kernel H2; with ``seg_k``,
    kernel H10).

    Routed by a static rule on the head dim (:func:`bwd_route`): every
    head dim in ``SM90_HEAD_DIMS`` launches the Hopper form,
    ``csrc/flash_bwd_sm90.cu`` (two deterministic passes on ``wgmma`` fed
    by TMA through a producer warp's ``mbarrier`` ring; the segment mask
    only on tiles that cross a segment; D = 16 and 24 on 32-column tiles),
    any other the mma.sync form, ``csrc/flash_bwd.cu`` (two ``mma.sync``
    kernels). Both compute the same function and are deterministic;
    ``launches`` counts either.

    With ``seg_k`` the keys have ids of their own and may be a different
    stream (context parallelism: the rank's queries over the gathered
    keys): the same route launches H10, the rectangular kernels of the
    same library, which replace the TPU kernel K-rect's backward
    (``esme_tpu/ops/flash.py:1083 _flash_bwd_vjp`` → ``_bwd``);
    ``rect_launches`` counts it. dk and dv then hold this rank's queries'
    share of the keys' gradients (0 on key rows no query shares an id
    with), which the caller sums over the ranks.

    Args:
        q2, k2, v2: the forward's ``(Tq, H·D)`` queries and ``(Tk, H·D)``
            keys and values (q and k rotated); Tk = Tq without ``seg_k``.
        do2: ``(Tq, H·D)`` gradient of the attention output.
        lse: ``(H, Tq)`` fp32 from :func:`segment_flash_fwd`.
        delta: ``(H, Tq)`` fp32 from :func:`attention_delta`.
        seg_ids: ``(Tq,)`` int32, the queries' ids (and the keys' without
            ``seg_k``).
        kstart, kend, qstart, qend: :func:`flash_spans` for ``seg_ids``
            (:func:`rect_flash_spans` with ``seg_k``).
        num_heads: H.
        seg_k: ``(Tk,)`` int32, the keys' ids; None for self-attention.
    Returns:
        ``dq (Tq, H·D)``, ``dk, dv (Tk, H·D)`` in q's dtype.
    """
    if q2.device.type == 'cpu':
        return segment_flash_bwd_plain(q2, k2, v2, do2, lse, delta, seg_ids,
                                       kstart, kend, qstart, qend,
                                       num_heads, seg_k)
    T, HD = q2.shape
    Tk = T if seg_k is None else k2.shape[0]
    H = num_heads
    D = HD // H
    what = 'segment_flash_bwd'
    _check_cuda_inputs(what, (('q', q2, T), ('k', k2, Tk), ('v', v2, Tk),
                              ('do', do2, T)), H, D)
    nqb, nkb = -(-T // BLOCK_Q), -(-Tk // BLOCK_KV)
    _check_index_inputs(what, q2.device, (
        ('seg_ids', seg_ids, T, torch.int32),
        *((('seg_k', seg_k, Tk, torch.int32),) if seg_k is not None else ()),
        ('lse', lse, (H, T), torch.float32),
        ('delta', delta, (H, T), torch.float32),
        ('kstart', kstart, nqb, torch.int32),
        ('kend', kend, nqb, torch.int32),
        ('qstart', qstart, nkb, torch.int32),
        ('qend', qend, nkb, torch.int32)))
    dq, dk, dv = launch_bwd(bwd_route(D), q2, k2, v2, do2, lse, delta,
                            seg_ids, kstart, kend, qstart, qend, H,
                            seg_k=seg_k)
    if seg_k is None:
        segment_flash_bwd.launches += 1
    else:
        segment_flash_bwd.rect_launches += 1
    return dq, dk, dv


segment_flash_bwd.launches = 0
segment_flash_bwd.rect_launches = 0


def launch_bwd(name, q2, k2, v2, do2, lse, delta, seg_ids, kstart, kend,
               qstart, qend, num_heads: int, lib=None, seg_k=None):
    """H2's library ``name`` (a key of ``BWD_ROUTES``) launched through its
    C entry on :func:`segment_flash_bwd`'s arguments, as
    :func:`launch_fwd` launches H1; with ``seg_k`` the library's
    rectangular entry (``BWD_RECT_ENTRIES``) launches H10. Returns ``dq,
    dk, dv``."""
    from .. import _build
    T, HD = q2.shape
    D = HD // num_heads
    entry, error_string = BWD_ROUTES[name]
    lib = _build.library(name) if lib is None else lib
    stream = torch.cuda.current_stream(q2.device).cuda_stream
    if seg_k is None:
        outs = [torch.empty_like(q2) for _ in range(3)]
        rc = getattr(lib, entry)(
            *(x.data_ptr() for x in (q2, k2, v2, do2, lse, delta, seg_ids,
                                     kstart, kend, qstart, qend, *outs)),
            T, num_heads, D, 1.0 / math.sqrt(D), stream)
        _build.check(rc, lib, error_string, f'segment_flash_bwd ({name})')
        return tuple(outs)
    outs = [torch.empty_like(q2), torch.empty_like(k2), torch.empty_like(k2)]
    rc = getattr(lib, BWD_RECT_ENTRIES[name])(
        *(x.data_ptr() for x in (q2, k2, v2, do2, lse, delta, seg_ids, seg_k,
                                 kstart, kend, qstart, qend, *outs)),
        T, k2.shape[0], num_heads, D, 1.0 / math.sqrt(D), stream)
    _build.check(rc, lib, error_string,
                 f'segment_flash_bwd, rectangular ({name})')
    return tuple(outs)


# ---------------------------------------------------------------------------
# Public entries with a gradient: (T, H, D), (H, T, D) and token-minor
# (H, D, T) around H1 and H2 (esme_tpu/ops/flash.py:1109-1165, 1221-1285)
# ---------------------------------------------------------------------------

def check_tiles(what: str, block_q: int, block_k: int) -> None:
    """The JAX signatures' tile sizes stay; only the kernels' own are
    taken."""
    if (block_q, block_k) != (BLOCK_Q, BLOCK_K):
        raise ValueError(f'{what}: the flash kernel\'s tiles are '
                         f'{BLOCK_Q}x{BLOCK_K}, not {block_q}x{block_k}')


class AttnStash:
    """The attention output o and its lse that one checkpointed layer
    keeps under ``remat='attn'``: the counterpart of JAX's
    ``checkpoint_name`` marks ``flash_out``/``flash_lse``
    (``esme_tpu/ops/fused_attn.py:128-130``, ``ops/flash.py:1076-1078``,
    ``:1258-1260``) and the policy that saves only them
    (``esme_tpu/models/modules.py:328-340``).

    ``models/modules.py:layer_stack`` gives each checkpointed layer call
    one stash, and its attention Function (:class:`_FlashAttention`,
    :class:`_FlashRect`, ``ops/fused_attn.py:_FusedRotaryFlash``) passes
    its forward through :meth:`forward`: the first forward launches the
    kernel and keeps o and lse; the recompute in the backward launches
    nothing and takes them back. The Function's backward clears the
    stash once it has used them. A torch
    selective-checkpoint policy cannot do this: it sees dispatcher ops
    only, and the kernels launch through ``ctypes``."""

    __slots__ = ('o', 'lse')

    def __init__(self):
        self.o = self.lse = None

    def forward(self, launch):
        """``launch() -> (o, lse)`` on the first call; on the next, the
        kept pair. Either way aliases that share the kept storage
        (``detach()``): the stored objects never come back, since a second
        ``Function.apply`` would rewrite their autograd metadata, and
        never as copies, which would cost what the stash saves."""
        if self.o is None:
            o, lse = launch()
            self.o, self.lse = o.detach(), lse.detach()
            return o, lse
        return self.o.detach(), self.lse.detach()

    def clear(self):
        self.o = self.lse = None


def _stashed(stash, launch):
    """``launch()`` through ``stash`` (:class:`AttnStash`), or straight
    without one."""
    return launch() if stash is None else stash.forward(launch)


def _release(stash):
    if stash is not None:
        stash.clear()


class _FlashAttention(torch.autograd.Function):
    """Segment-flash attention over ``(T, H·D)`` with its gradient:
    forward H1, backward ``delta = rowsum(do·o)`` and H2. ``seg_ids`` and
    the spans get no gradient. The kernels are looked up in this module
    at call time, so a caller may swap in their plain versions. With a
    ``stash`` (:class:`AttnStash`) a checkpointed layer's recompute takes
    o and lse from it instead of launching H1."""

    @staticmethod
    def forward(ctx, q2, k2, v2, seg_ids, num_heads, spans, stash):
        o, lse = _stashed(stash, lambda: segment_flash_fwd(
            q2, k2, v2, seg_ids, spans[0], spans[1], num_heads))
        ctx.save_for_backward(q2, k2, v2, o, lse, seg_ids, *spans)
        ctx.num_heads = num_heads
        ctx.stash = stash
        return o

    @staticmethod
    def backward(ctx, do2):
        q2, k2, v2, o, lse, seg_ids, *spans = ctx.saved_tensors
        _release(ctx.stash)
        H = ctx.num_heads
        do2 = do2.to(o.dtype).contiguous()
        delta = attention_delta(o, do2, H)
        dq, dk, dv = segment_flash_bwd(q2, k2, v2, do2, lse, delta, seg_ids,
                                       *spans, H)
        return dq, dk, dv, None, None, None, None


def segment_flash(q2, k2, v2, seg_ids, num_heads: int, spans, stash=None):
    """Segment-flash attention over ``(T, H·D)`` q/k/v as they are (no
    RoPE): H1 forward and, where q, k or v needs a gradient, H2 backward
    through :class:`_FlashAttention`. The model's route without rotary
    embeddings (ESM1b, ESM1v), where JAX runs ``fused_rotary_flash`` with
    identity tables (``esme_tpu/models/modules.py:189-194``), an exact
    rotation: the same o, with no H3 launch in either direction.
    ``seg_ids``: int32; ``spans``: :func:`flash_spans` of them;
    ``stash``: the checkpointed layer's :class:`AttnStash` under
    ``remat='attn'``, or None."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q2, k2, v2)):
        return _FlashAttention.apply(q2, k2, v2, seg_ids, num_heads,
                                     tuple(spans), stash)
    return segment_flash_fwd(q2, k2, v2, seg_ids, spans[0], spans[1],
                             num_heads)[0]


def _flash_thd(q2, k2, v2, seg_ids, num_heads: int):
    seg = seg_ids.to(torch.int32).contiguous()
    return segment_flash(q2.contiguous(), k2.contiguous(), v2.contiguous(),
                         seg, num_heads, flash_spans(seg))


def flash_segment_attention(q, k, v, seg_ids, *, block_q: int = BLOCK_Q,
                            block_k: int = BLOCK_K,
                            max_seqlen: int | None = None,
                            interpret: bool | None = None,
                            layout: str = 'thd'):
    """Segment-masked flash attention with a gradient, as ``esme_tpu``'s
    function of the same name.

    ``layout='thd'`` takes and returns ``(T, H, D)``, which is H1's
    ``(T, H·D)`` without a copy; ``layout='htd'`` takes and returns
    ``(H, T, D)``, relayouted by H4 on either side (one launch for q, k
    and v, one for o; the same two in the backward). Any T: H1 and H2
    take a ragged last block, so nothing is padded (JAX pads to
    ``lcm(block_q, block_k)`` with a segment of its own, which leaves the
    real rows as they are).

    ``block_q``, ``block_k``: only the kernels' own tiles are taken.
    ``max_seqlen`` and ``interpret`` are accepted for call compatibility
    and unused: the kernels walk each block's exact span, and the device
    decides between the kernels and the plain versions.
    """
    check_tiles('flash_segment_attention', block_q, block_k)
    if layout == 'thd':
        T, H, D = q.shape
        o = _flash_thd(*(x.reshape(T, H * D) for x in (q, k, v)), seg_ids, H)
        return o.view(T, H, D)
    if layout == 'htd':
        H = q.shape[0]
        o = _flash_thd(*relayout((q, k, v), 'htd', 'thd', H), seg_ids, H)
        return relayout((o,), 'thd', 'htd', H)[0]
    raise ValueError(f'flash_segment_attention: unknown layout {layout!r}')


def flash_tm(qT, kT, vT, seg_ids, block_q: int = BLOCK_Q,
             block_k: int = BLOCK_K, max_seqlen: int | None = None,
             interpret: bool | None = None, num_jobs: int | None = None):
    """Segment-flash attention over token-minor ``(H, D, T)`` q/k/v (RoPE
    already applied), with a gradient; returns oT ``(H, D, T)``.

    H4 moves q, k and v to ``(T, H·D)`` in one launch and o back in
    another (and do, then dq, dk and dv, in the backward) around H1 and
    H2. ``block_q``/``block_k`` are checked as in
    :func:`flash_segment_attention`; ``max_seqlen``, ``interpret`` and
    ``num_jobs`` are accepted and unused (no job budget: the kernels walk
    each block's own span).
    """
    check_tiles('flash_tm', block_q, block_k)
    H = qT.shape[0]
    o = _flash_thd(*relayout((qT, kT, vT), 'hdt', 'thd', H), seg_ids, H)
    return relayout((o,), 'thd', 'hdt', H)[0]


# ---------------------------------------------------------------------------
# Rectangular attention (kernels H9 and H10): local queries over another
# key/value stream with ids of their own (esme_tpu/ops/flash.py:1083-1210)
# ---------------------------------------------------------------------------

def rect_spans(seg_q: torch.Tensor, seg_k: torch.Tensor):
    """H9's spans, ``(kstart, kend)`` per ``BLOCK_Q`` block of the queries'
    ids over ``BLOCK_K`` tiles of the keys' ids. They depend only on the
    ids, so a forward computes them once for every layer."""
    return block_spans(seg_q, BLOCK_Q, BLOCK_K, seg_k)


def rect_flash_spans(seg_q: torch.Tensor, seg_k: torch.Tensor):
    """Every span H9 and H10 walk, as :func:`flash_spans` for two streams:
    H9's and H10's dq pass's ``(kstart, kend)`` (:func:`rect_spans`) and
    H10's dk/dv pass's ``(qstart, qend)`` per ``BLOCK_KV`` block of the
    keys over ``BLOCK_QT`` tiles of the queries. A key block that no query
    shares an id with gets an empty span."""
    return (*rect_spans(seg_q, seg_k),
            *transposed_spans(seg_q, BLOCK_QT, BLOCK_KV, seg_k))


class _FlashRect(torch.autograd.Function):
    """Rectangular segment-flash attention with its gradient: forward H9,
    backward ``delta = rowsum(do·o)`` and H10. The ids and the spans get
    no gradient; the kernels are looked up in this module at call time,
    and a ``stash`` is taken, as in :class:`_FlashAttention`."""

    @staticmethod
    def forward(ctx, q2, k2, v2, seg_q, seg_k, num_heads, spans, stash):
        o, lse = _stashed(stash, lambda: segment_flash_fwd(
            q2, k2, v2, seg_q, spans[0], spans[1], num_heads, seg_k=seg_k,
            order=spans.order))
        ctx.save_for_backward(q2, k2, v2, o, lse, seg_q, seg_k, *spans[:4])
        ctx.num_heads = num_heads
        ctx.stash = stash
        return o

    @staticmethod
    def backward(ctx, do2):
        q2, k2, v2, o, lse, seg_q, seg_k, *spans = ctx.saved_tensors
        _release(ctx.stash)
        H = ctx.num_heads
        do2 = do2.to(o.dtype).contiguous()
        delta = attention_delta(o, do2, H)
        dq, dk, dv = segment_flash_bwd(q2, k2, v2, do2, lse, delta, seg_q,
                                       *spans, H, seg_k=seg_k)
        return dq, dk, dv, None, None, None, None, None


def segment_flash_rect(q2, k2, v2, seg_q, seg_k, num_heads: int,
                       spans=None, stash=None):
    """Rectangular segment-flash attention over ``(Tq, H·D)`` queries and
    ``(Tk, H·D)`` keys/values as they are (RoPE, where the family has it,
    already applied): H9 forward and, where q, k or v needs a gradient,
    H10 backward through :class:`_FlashRect` (their plain versions on a
    CPU tensor). Query t attends key s iff ``seg_q[t] == seg_k[s]``.
    ``seg_q``, ``seg_k``: int32; ``spans``: :func:`rect_flash_spans` of
    them (the forward reads only the first two), or their :class:`Spans`
    with the launch order, computed here (without one) when None;
    ``stash``: as in :func:`segment_flash`."""
    spans = Spans(*(rect_flash_spans(seg_q, seg_k) if spans is None
                    else spans))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q2, k2, v2)):
        return _FlashRect.apply(q2, k2, v2, seg_q, seg_k, num_heads, spans,
                                stash)
    return segment_flash_fwd(q2, k2, v2, seg_q, spans[0], spans[1],
                             num_heads, seg_k=seg_k, order=spans.order)[0]


def flash_rect_attention(q, k, v, seg_q, seg_k, *, block_q: int = BLOCK_Q,
                         block_k: int = BLOCK_K,
                         max_seqlen: int | None = None,
                         interpret: bool | None = None):
    """Rectangular segment-flash attention with a gradient, as
    ``esme_tpu``'s function of the same name: local queries ``q (Tq, H,
    D)`` over a different (e.g. all-gathered) stream ``k``/``v (Tk, H,
    D)``, with per-side segment ids. Returns ``(Tq, H, D)``; its gradient
    is H10's (dk and dv over all Tk rows, 0 where no query shares the
    key's id).

    Any Tq and Tk: H9 and H10 take a ragged last block on either side, so
    nothing is padded (JAX pads the queries with an id one past its fake
    key id, and the keys with the fake id, which match nothing real and
    leave the real rows as they are). ``block_q``/``block_k`` are checked
    as in :func:`flash_segment_attention`; ``max_seqlen`` and
    ``interpret`` are accepted for call compatibility and unused.
    """
    check_tiles('flash_rect_attention', block_q, block_k)
    Tq, H, D = q.shape
    Tk = k.shape[0]
    o = segment_flash_rect(
        q.reshape(Tq, H * D).contiguous(), k.reshape(Tk, H * D).contiguous(),
        v.reshape(Tk, H * D).contiguous(),
        seg_q.to(torch.int32).contiguous(),
        seg_k.to(torch.int32).contiguous(), H)
    return o.view(Tq, H, D)
