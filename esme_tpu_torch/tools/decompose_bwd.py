"""What each pass of the segment-flash backward costs: H2's two passes
with one part of the work removed at a time ("H7", their ablation modes),
on both of H2's forms: the Hopper form ``csrc/flash_bwd_sm90.cu``, the
one H2 runs at head dims 32-128, and the mma.sync form
``csrc/flash_bwd.cu``.

Counterpart of ``tools/decompose_bwd.py`` (K15: ``dq_variant`` at 66 and
``dkv_variant`` at 125, built into grids by ``build_dq``/``build_dkv``).
Each mode removes the same part as on the TPU:

  real     the form's production pass (its mode-0 instantiation)
  dma      every element of the tiles read, summed; no compute
  mm_only  the products alone (no mask, no exp: p = s, ds = p + dp)
  no_s     no score product (s = lse)
  no_dp    no dp = do·v product (ds = p·scale)
  no_acc   no accumulating products (the gradient gains max(ds))
  no_exp   p = s/2 + 0.01 instead of the masked exp
  no_mask  no segment mask

Numerics of every mode but ``real`` are wrong on purpose: this is a cost
model. The modes run at each form's own walk, D = 64: the dq pass's
128-row q blocks over 64-key tiles in both; the dk/dv pass's 64-row k
blocks over 64-query tiles on the mma.sync form, and on the Hopper form
128-row k blocks over 128-query stages: the union of the spans of the
two 64-row halves of a block (:func:`union_spans`) rounded out to stages
(:func:`stage_spans`), so the modes without a mask add those tiles too.

Beside the modes, :func:`dkv_timeline` runs the Hopper dk/dv pass at D =
64 with clock stamps of where each CTA's time goes, in the production
form or the form before it, and :func:`timeline_summary` reads them.

    python -m esme_tpu_torch.tools.decompose_bwd [--device cpu]

prints, on bench.py's 50k train batch, the full backward, then each mode
of each pass of the Hopper form and of the mma.sync form, beside the
bound of the work kept, then (on the card) the timeline of both dk/dv
forms.
"""

from __future__ import annotations

import math
import sys

import torch

from ..ops import flash
from ..profiling import benchmark
from . import (BWD_SEED, FLASH_G_REL, SUM_REL, attention_batch, bound_ms,
               bwd_route, check_cuda_tensors, pad_rows, parse_args,
               scaled_error, segment_pairs)

# K15's modes in the kernels' order (csrc/flash_bwd.cu: enum Mode), with
# the products each keeps in the dq kernel (S, dP, dQ) and in the dk/dv
# kernel (S, dP, dV, dK), and whether the exps stay
MODES = {
    'real': (3, 4, True),
    'dma': (0, 0, False),
    'mm_only': (3, 4, False),
    'no_s': (2, 3, True),
    'no_dp': (2, 3, True),
    'no_acc': (2, 2, True),
    'no_exp': (3, 4, False),
    'no_mask': (3, 4, True),
}
KERNELS = ('dkv', 'dq')
# the modes that drop the segment mask: they compute every pair of the
# tiles they walk
UNMASKED = ('mm_only', 'no_exp', 'no_mask')
# each form's C entry of one pass in one mode, by library
VARIANT_ENTRIES = {'flash_bwd_sm90': 'esme_flash_bwd_sm90_pass',
                   'flash_bwd': 'esme_segment_flash_bwd_variant'}


def _p_ds(mode, s, dp, lse, delta, mask, scale):
    """``p`` and ``ds`` of one step, as ``dq_variant``/``dkv_variant``
    compute them (``tools/decompose_bwd.py:93-113``); ``s`` is None in
    ``no_s`` (s = lse), ``dp`` in ``no_dp``."""
    if mode == 'no_s':
        s = lse.expand(*lse.shape[:2], *mask.shape[2:])
    if mode == 'mm_only':
        p = s
    elif mode == 'no_exp':
        p = s * 0.5 + 0.01
    elif mode == 'no_mask':
        p = torch.exp(s - lse)
    else:
        p = torch.where(mask, torch.exp(s - lse), 0.0)
    if mode == 'no_dp':
        ds = p * scale
    elif mode == 'mm_only':
        ds = p + dp
    else:
        ds = p * (dp - delta) * scale
    return p, ds


def _tiles(x2, block: int, heads: int):
    """``(T, H·D)`` -> fp32 tiles ``(n, H, block, D)``, zero-padded."""
    n = -(-x2.shape[0] // block)
    return pad_rows(x2, n * block).view(n, block, heads, -1) \
        .transpose(1, 2).float()


def _row_terms(x, block: int):
    """``(H, T)`` -> tiles ``(n, H, block)``, zero-padded."""
    H, T = x.shape
    n = -(-T // block)
    return pad_rows(x.T, n * block).view(n, block, H).permute(0, 2, 1)


def dq_variant_plain(mode: str, q2, k2, v2, do2, lse, delta, seg_ids,
                     kstart, kend, num_heads: int,
                     block_q: int = flash.BLOCK_Q,
                     block_k: int = flash.BLOCK_K):
    """Plain PyTorch version of H7's dq kernel: ``dq_variant``'s steps,
    tile by tile. Every ``block_q`` block walks its span ``[kstart,
    kend)`` of ``block_k`` tiles, all blocks in step, with dq summed in
    fp32 and ds rounded to the input dtype before its product; ``dma``
    faces q row p with k row p mod ``block_k`` (the TPU's tiles are
    square). Rows and keys past T are zeros matching no segment, as in
    the kernel. Returns dq ``(T, H·D)`` in q's dtype."""
    if mode not in MODES:
        raise ValueError(f'unknown mode {mode!r}; one of {list(MODES)}')
    T, HD = q2.shape
    H = num_heads
    D = HD // H
    scale = 1.0 / math.sqrt(D)
    dt = q2.dtype
    bq, bk = block_q, block_k
    nqb, nkb = -(-T // bq), -(-T // bk)
    qh, doh = _tiles(q2, bq, H), _tiles(do2, bq, H)    # (nqb, H, bq, D)
    k, v = _tiles(k2, bk, H), _tiles(v2, bk, H)        # (nkb, H, bk, D)
    lse_r, delta_r = (_row_terms(x, bq)[..., None] for x in (lse, delta))
    segq = pad_rows(seg_ids, nqb * bq, -2).view(nqb, bq)
    segk = pad_rows(seg_ids, nkb * bk, -1).view(nkb, bk)
    kstart = kstart.long()
    span = kend.long() - kstart
    dq = torch.zeros((nqb, H, bq, D), device=q2.device)
    rows = torch.arange(bq, device=q2.device) % bk
    for jj in range(int(span.max().item()) if nqb else 0):
        act = (jj < span)[:, None, None, None]
        j = torch.clamp(kstart + jj, max=nkb - 1)
        kt, vt = k[j], v[j]
        if mode == 'dma':
            z = ((qh + doh) + kt[:, :, rows]) + vt[:, :, rows]
            new = ((dq + z) + lse_r) + delta_r
        else:
            mask = (segq[:, :, None] == segk[j][:, None, :])[:, None]
            s = None if mode == 'no_s' else \
                torch.einsum('nhqd,nhkd->nhqk', qh, kt) * scale
            dp = None if mode == 'no_dp' else \
                torch.einsum('nhqd,nhkd->nhqk', doh, vt)
            _, ds = _p_ds(mode, s, dp, lse_r, delta_r, mask, scale)
            if mode == 'no_acc':
                new = dq + ds.amax(-1, keepdim=True)
            else:
                new = dq + torch.einsum('nhqk,nhkd->nhqd', ds.to(dt).float(),
                                        kt)
        dq = torch.where(act, new, dq)
    return dq.transpose(1, 2).reshape(nqb * bq, HD)[:T].to(dt)


def dkv_variant_plain(mode: str, q2, k2, v2, do2, lse, delta, seg_ids,
                      qstart, qend, num_heads: int,
                      block_k: int = flash.BLOCK_KV,
                      block_q: int = flash.BLOCK_QT):
    """Plain PyTorch version of H7's dk/dv kernel: ``dkv_variant``'s
    steps, tile by tile. Every ``block_k`` block walks its span
    ``[qstart, qend)`` of ``block_q`` tiles, all blocks in step, with dk
    and dv summed in fp32 and p and ds rounded to the input dtype before
    their products; ``dma`` and ``no_acc`` face k row p with q column p
    (square tiles, as on the TPU and in the kernel). A span may run past
    the last q tile: the tiles past it are zeros, as the kernel's loads
    give them. Returns dk, dv ``(T, H·D)`` in q's dtype."""
    if mode not in MODES:
        raise ValueError(f'unknown mode {mode!r}; one of {list(MODES)}')
    if mode in ('dma', 'no_acc') and block_k != block_q:
        raise ValueError(f'{mode}: k blocks and q tiles must be equal')
    T, HD = q2.shape
    H = num_heads
    D = HD // H
    scale = 1.0 / math.sqrt(D)
    dt = q2.dtype
    bk, bq = block_k, block_q
    # a walk may run past the last tile (a stage rounded out): zero tiles
    nkb = -(-T // bk)
    nqt = max(-(-T // bq), int(qend.max().item()) if qend.numel() else 0)
    k, v = _tiles(k2, bk, H), _tiles(v2, bk, H)        # (nkb, H, bk, D)
    q, do = (_tiles(pad_rows(x, nqt * bq), bq, H) for x in (q2, do2))
    lse_c, delta_c = (_row_terms(pad_rows(x.T, nqt * bq).T, bq)
                      for x in (lse, delta))
    segk = pad_rows(seg_ids, nkb * bk, -1).view(nkb, bk)
    segq = pad_rows(seg_ids, nqt * bq, -2).view(nqt, bq)
    qstart = qstart.long()
    span = qend.long() - qstart
    dk = torch.zeros((nkb, H, bk, D), device=q2.device)
    dv = torch.zeros_like(dk)
    for ii in range(int(span.max().item()) if nkb else 0):
        act = (ii < span)[:, None, None, None]
        i = torch.clamp(qstart + ii, max=nqt - 1)
        qt, dot = q[i], do[i]
        ls, dl = lse_c[i][:, :, None, :], delta_c[i][:, :, None, :]
        if mode == 'dma':
            dk_new = dk + (((qt + dot) + k) + v)
            dv_new = (dv + ls.transpose(2, 3)) + dl.transpose(2, 3)
        else:
            mask = (segk[:, :, None] == segq[i][:, None, :])[:, None]
            s = None if mode == 'no_s' else \
                torch.einsum('nhkd,nhqd->nhkq', k, qt) * scale
            dp = None if mode == 'no_dp' else \
                torch.einsum('nhkd,nhqd->nhkq', v, dot)
            p, ds = _p_ds(mode, s, dp, ls, dl, mask, scale)
            if mode == 'no_acc':
                dv_new = dv
                dk_new = dk + ds.amax(2)[..., None]
            else:
                dv_new = dv + torch.einsum('nhkq,nhqd->nhkd',
                                           p.to(dt).float(), dot)
                dk_new = dk + torch.einsum('nhkq,nhqd->nhkd',
                                           ds.to(dt).float(), qt)
        dk = torch.where(act, dk_new, dk)
        dv = torch.where(act, dv_new, dv)

    def out(x):
        return x.transpose(1, 2).reshape(nkb * bk, HD)[:T].to(dt)
    return out(dk), out(dv)


def union_spans(qstart, qend):
    """The q-tile span each 64-row k block walks in the Hopper form's dk/dv
    pass: the union of the spans of the two 64-row halves of its 128-row
    block (``csrc/flash_bwd_sm90.cu``; a last odd half keeps its own)."""
    n = qstart.numel()

    def pair(x, reduce):
        x = torch.cat([x, x[-1:]]) if n % 2 else x
        return reduce(x.view(-1, 2), 1).repeat_interleave(2)[:n] \
            .to(torch.int32).contiguous()
    return pair(qstart, torch.amin), pair(qend, torch.amax)


def stage_spans(qstart, qend, stage_rows: int):
    """The q-tile span each 64-row k block walks in the Hopper form's
    dk/dv pass when a stage is ``stage_rows`` q rows: its CTA's
    (:func:`esme_tpu_torch.ops.flash.dkv_stages`) in ``BLOCK_QT`` tiles,
    empty (start past end) where the CTA walks no stage. At 64-row stages
    these are :func:`union_spans`."""
    sb0, n = flash.dkv_stages(qstart, qend, stage_rows)
    r = stage_rows // flash.BLOCK_QT
    nkb = qstart.numel()
    start = torch.where(n > 0, sb0 * r, nkb).repeat_interleave(2)[:nkb]
    end = ((sb0 + n) * r).repeat_interleave(2)[:nkb]
    return start.to(torch.int32).contiguous(), end.to(torch.int32).contiguous()


def _library(library, head_dim: int) -> str:
    """``library``, a key of ``flash.BWD_ROUTES``, or the tools' form of
    H2 at ``head_dim`` (:func:`esme_tpu_torch.tools.bwd_route`) when
    None."""
    library = bwd_route(head_dim) if library is None else library
    if library not in flash.BWD_ROUTES:
        raise ValueError(f'unknown library {library!r}; one of '
                         f'{list(flash.BWD_ROUTES)}')
    return library


def bwd_variant_plain(kernel: str, mode: str, q2, k2, v2, do2, lse, delta,
                      seg_ids, kstart, kend, qstart, qend, num_heads: int,
                      library: str | None = None):
    """Plain PyTorch version of :func:`bwd_variant`: its pass at the walk
    of ``library``'s form (the dk/dv pass of the Hopper form over
    :func:`stage_spans`)."""
    D = q2.shape[1] // num_heads
    library = _library(library, D)
    if kernel == 'dq':
        return dq_variant_plain(mode, q2, k2, v2, do2, lse, delta, seg_ids,
                                kstart, kend, num_heads)
    if library == 'flash_bwd_sm90':
        qstart, qend = stage_spans(qstart, qend, flash.dkv_stage_rows(D))
    return dkv_variant_plain(mode, q2, k2, v2, do2, lse, delta, seg_ids,
                             qstart, qend, num_heads)


def bwd_variant(kernel: str, mode: str, q2, k2, v2, do2, lse, delta,
                seg_ids, kstart, kend, qstart, qend, num_heads: int,
                library: str | None = None):
    """One of H2's passes in ablation mode ``mode`` (kernel H7): the
    arguments of :func:`esme_tpu_torch.ops.flash.segment_flash_bwd`, D =
    64 only, on ``library``'s form (a key of ``flash.BWD_ROUTES``; the tools'
    form at D, the Hopper form at 64, when None). ``kernel='dq'`` returns
    dq, ``'dkv'`` returns (dk, dv). ``real`` launches the form's own
    production instantiations."""
    if mode not in MODES or kernel not in KERNELS:
        raise ValueError(f'unknown mode {mode!r} or kernel {kernel!r}; '
                         f'modes {list(MODES)}, kernels {KERNELS}')
    library = _library(library, q2.shape[1] // num_heads)
    if q2.device.type == 'cpu':
        return bwd_variant_plain(kernel, mode, q2, k2, v2, do2, lse, delta,
                                 seg_ids, kstart, kend, qstart, qend,
                                 num_heads, library)
    T, HD = q2.shape
    H = num_heads
    D = HD // H
    what = f'bwd_variant({kernel!r}, {mode!r}, {library!r})'
    if D != 64 or HD != H * D:
        raise ValueError(f'{what}: head dim {HD / H:g}: the ablation modes '
                         'are built for D = 64 only')
    check_cuda_tensors(what, (('q', q2), ('k', k2), ('v', v2), ('do', do2)),
                       (T, HD))
    nqb, nkb = -(-T // flash.BLOCK_Q), -(-T // flash.BLOCK_KV)
    flash._check_index_inputs(what, q2.device, (
        ('seg_ids', seg_ids, T, torch.int32),
        ('lse', lse, (H, T), torch.float32),
        ('delta', delta, (H, T), torch.float32),
        ('kstart', kstart, nqb, torch.int32),
        ('kend', kend, nqb, torch.int32),
        ('qstart', qstart, nkb, torch.int32),
        ('qend', qend, nkb, torch.int32)))
    from .. import _build
    lib = _build.library(library)
    entry = VARIANT_ENTRIES[library]
    dq = torch.empty_like(q2) if kernel == 'dq' else q2.new_empty(0)
    dk, dv = (torch.empty_like(q2) if kernel == 'dkv' else q2.new_empty(0)
              for _ in range(2))
    rc = getattr(lib, entry)(
        KERNELS.index(kernel), list(MODES).index(mode), q2.data_ptr(),
        k2.data_ptr(), v2.data_ptr(), do2.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), seg_ids.data_ptr(), kstart.data_ptr(),
        kend.data_ptr(), qstart.data_ptr(), qend.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), T, H, D, 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q2.device).cuda_stream)
    _build.check(rc, lib, flash.BWD_ROUTES[library][1], what)
    bwd_variant.launches += 1
    return dq if kernel == 'dq' else (dk, dv)


bwd_variant.launches = 0


# The timeline's forms of the Hopper dk/dv pass at D = 64, by the q rows
# of a stage: 128 the production form (a 256-thread CTA whose first warp
# loads), 64 the form before it (a 384-thread CTA with a producer warp)
TIMELINE_FORMS = (64, 128)
# Where a CTA's time goes, in the order of its timeline: the prologue
# (barriers, K and V by TMA), waits on full stages (starved of loads),
# S^T and dP^T issued and waited (the vote included), the scores, dV and
# dK issued and waited (the bf16 fragments included), the handback, the
# epilogue (the stores of dk and dv)
TL_PHASES = ('prologue', 'full_wait', 'st_dpt', 'scores', 'dv_dk',
             'handback', 'epilogue')
# a stage's five stamps (csrc/flash_bwd_sm90.cu:tl_words), the end of each
# of its phases
_TL_STAGE = ('full_wait', 'st_dpt', 'scores', 'dv_dk', 'handback')


def tl_words(stages: int) -> int:
    """64-bit words of one CTA's timeline record whose walk holds at most
    ``stages`` stages (``csrc/flash_bwd_sm90.cu:tl_words``)."""
    return 10 + 11 * stages


def dkv_timeline(form: int, q2, k2, v2, do2, lse, delta, seg_q, qstart,
                 qend, num_heads: int, seg_k=None, stages=None):
    """The Hopper dk/dv pass at D = 64 in ``form`` (one of
    ``TIMELINE_FORMS``) with its timeline: H2's arguments (``seg_k`` None)
    or H10's (the keys' ids ``seg_k``; its spans from
    ``flash.rect_flash_spans``). Returns dk, dv and the stamps, int64
    ``(CTAs, tl_words(stages))`` on the card, CTA ``h * nkb + kb`` for
    key block ``kb`` of head ``h``, and ``stages``, the most any CTA walks
    (:func:`esme_tpu_torch.ops.flash.dkv_stages`; pass it to launch
    without a host sync). Card only: the stamps are the card's clocks, so
    there is no plain version."""
    if form not in TIMELINE_FORMS:
        raise ValueError(f'unknown form {form}; one of {TIMELINE_FORMS}')
    if q2.device.type != 'cuda':
        raise RuntimeError('dkv_timeline reads the card\'s clocks: it '
                           'needs CUDA tensors')
    seg_k = seg_q if seg_k is None else seg_k
    Tq, HD = q2.shape
    Tk = k2.shape[0]
    H = num_heads
    D = HD // H
    if D != 64:
        raise ValueError(f'dkv_timeline: head dim {D}: built for D = 64')
    if stages is None:
        _, n = flash.dkv_stages(qstart, qend, form)
        stages = int(n.max().item()) if n.numel() else 0
    nkb = -(-Tk // (2 * flash.BLOCK_KV))
    stamps = torch.zeros((H * nkb, tl_words(stages)), dtype=torch.int64,
                         device=q2.device)
    dk, dv = torch.empty_like(k2), torch.empty_like(v2)
    from .. import _build
    lib = _build.library('flash_bwd_sm90')
    rc = lib.esme_flash_bwd_sm90_timeline(
        form, *(x.data_ptr() for x in (q2, k2, v2, do2, lse, delta, seg_q,
                                       seg_k, qstart, qend, dk, dv, stamps)),
        Tq, Tk, H, D, 1.0 / math.sqrt(D), stages,
        torch.cuda.current_stream(q2.device).cuda_stream)
    _build.check(rc, lib, flash.BWD_ROUTES['flash_bwd_sm90'][1],
                 f'dkv_timeline({form})')
    return dk, dv, stamps, stages


def _quartiles(x):
    """Median and quartiles of a 1-D tensor (None when empty)."""
    if x.numel() == 0:
        return None
    q = torch.quantile(x.double(), torch.tensor([0.25, 0.5, 0.75],
                                                dtype=torch.float64))
    return {'q1': q[0].item(), 'median': q[1].item(), 'q3': q[2].item()}


def timeline_summary(stamps, stages: int) -> dict:
    """Where the CTAs of a :func:`dkv_timeline` run spent their time. Per
    consumer warpgroup its wall time (entry to its stores done) splits
    into ``TL_PHASES``: the prologue (entry to K and V landed), then per
    stage the wait for the full barrier (from K and V, or the last
    handback), S^T and dP^T, the scores, dV and dK, the handback, and the
    epilogue (the last handback to the stores done); the shares of a CTA
    are its two warpgroups' means. Returns ``{'ctas', 'empty_ctas',
    'shares': {phase: quartiles over CTAs}, 'stage_cycles': {phase:
    quartiles over (CTA, warpgroup, stage)}, 'issue_to_ready_cycles' (a
    stage's loads issued to a warpgroup passing its full barrier),
    'stages_walked' (quartiles over CTAs), 'cta_us' (wall time, from the
    global timer), 'cycles_per_ns'}`` (the SM clock over the global
    timer, medians over CTAs)."""
    x = torch.as_tensor(stamps).to(torch.int64).cpu()
    n = x[:, 1]
    walk = n > 0
    x, n = x[walk], n[walk]
    S = stages
    c = x.shape[0]
    idx = torch.arange(S)
    valid = idx[None, :] < n[:, None]                       # (c, S)
    issue = x[:, 10:10 + S]
    st = x[:, 10 + S:10 + 11 * S].view(c, 2, S, 5)
    shares = {p: [] for p in TL_PHASES}
    per_stage = {p: [] for p in _TL_STAGE}
    ready, walls = [], []
    for w in range(2):
        entry, kv, end = (x[:, 4 + 3 * w + i] for i in range(3))
        sw = st[:, w]                                       # (c, S, 5)
        prev = torch.cat([kv[:, None], sw[:, :-1, 4]], 1)
        ends = [sw[..., i] for i in range(5)]
        starts = [prev, *ends[:4]]
        wall = (end - entry).double()
        walls.append(wall)
        for p, a, b in zip(_TL_STAGE, starts, ends):
            d = torch.where(valid, b - a, 0)
            shares[p].append(d.sum(1) / wall)
            per_stage[p].append((b - a)[valid])
        last = sw[torch.arange(c), (n - 1).clamp_min(0), 4]
        shares['prologue'].append((kv - entry) / wall)
        shares['epilogue'].append((end - last) / wall)
        ready.append((sw[..., 0] - issue)[valid])
    ns = (x[:, 3] - x[:, 2]).double()
    return {
        'ctas': c, 'empty_ctas': int((~walk).sum()),
        'shares': {p: _quartiles(sum(v) / 2) for p, v in shares.items()},
        'stage_cycles': {p: _quartiles(torch.cat(v))
                         for p, v in per_stage.items()},
        'issue_to_ready_cycles': _quartiles(torch.cat(ready)),
        'stages_walked': _quartiles(n),
        'cta_us': _quartiles(ns / 1e3),
        'cycles_per_ns': _quartiles(torch.maximum(*walls) / ns),
    }


def timeline_line(label: str, summary: dict) -> str:
    """One line of :func:`timeline_summary`'s medians and quartiles."""
    def q(d, fmt):
        return 'n/a' if d is None else \
            (f'{d["median"]:{fmt}} ({d["q1"]:{fmt}}-{d["q3"]:{fmt}})')
    return (f'{label}: {summary["ctas"]} CTAs walking '
            f'{q(summary["stages_walked"], ".0f")} stages, '
            f'{q(summary["cta_us"], ".2f")} us a CTA; shares of a CTA '
            + ', '.join(f'{p} {q(v, ".3f")}'
                        for p, v in summary['shares'].items())
            + '; cycles a stage ' + ', '.join(
                f'{p} {q(v, ".0f")}'
                for p, v in summary['stage_cycles'].items())
            + f'; issue to ready {q(summary["issue_to_ready_cycles"], ".0f")}'
            f' cycles; {q(summary["cycles_per_ns"], ".3f")} cycles/ns')


def check(mode: str, got, ref):
    """A mode's kernel gradients against its plain version's (dq, or dk
    and dv): ``{'err', 'share', 'ok'}`` over the tensors, under H2's gate
    (2^-4·max(|g|, rms g)), or SUM_REL for ``dma``'s sums."""
    rel = SUM_REL if mode == 'dma' else FLASH_G_REL
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    errs = [scaled_error(a, b, rel) for a, b in zip(got, ref)]
    err, share = max(e for e, _ in errs), max(s for _, s in errs)
    finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
    return {'err': err, 'share': share, 'ok': share <= 1.0 and finite}


def walked_pairs(kernel: str, library: str, spans, head_dim: int) -> float:
    """The (q, k) pairs per head of the tiles ``library``'s ``kernel``
    pass walks over ``spans`` (:func:`esme_tpu_torch.ops.flash.
    flash_spans`) at ``head_dim``."""
    kstart, kend, qstart, qend = spans
    if kernel == 'dq':
        return float((kend - kstart).clamp_min(0).sum().item()) \
            * flash.BLOCK_Q * flash.BLOCK_K
    if library == 'flash_bwd_sm90':
        qstart, qend = stage_spans(qstart, qend,
                                   flash.dkv_stage_rows(head_dim))
    return float((qend - qstart).clamp_min(0).sum().item()) \
        * flash.BLOCK_KV * flash.BLOCK_QT


def work(kernel: str, mode: str, b, library: str | None = None):
    """Bytes the pass must move (q, k, v and do read, its gradients
    written, lse and delta read, segment ids and its spans read) and the
    operations the mode keeps: 2·D flops per kept product and one exp
    per pair and head, over the same-segment pairs, or, in the modes
    without a mask, over every pair of the tiles ``library``'s form
    walks."""
    library = _library(library, b.D)
    dq_products, dkv_products, exps = MODES[mode]
    products = dq_products if kernel == 'dq' else dkv_products
    pairs = (walked_pairs(kernel, library, b.spans, b.D) if mode in UNMASKED
             else segment_pairs(b.seg)) * b.H
    nspans = b.spans[0 if kernel == 'dq' else 2].numel() * 2
    nbytes = (4 + (1 if kernel == 'dq' else 2)) * b.q.numel() \
        * b.q.element_size() + 2 * b.H * b.T * 4 + b.T * 4 + nspans * 4
    return nbytes, 2.0 * b.D * pairs * products, pairs if exps else 0.0


def backward_inputs(b):
    """H2's inputs on batch ``b``: H1's lse and delta = rowsum(do·o)."""
    o, lse = flash.segment_flash_fwd(b.q, b.k, b.v, b.seg, *b.spans[:2],
                                     b.H)
    return lse, flash.attention_delta(o, b.do, b.H)


def run(kernel: str, mode: str, b, lse, delta, reps: int,
        library: str | None = None):
    """Time one pass of ``library``'s form in one mode: its ms, bound and
    the work it keeps; prints its line."""
    library = _library(library, b.D)
    args = (b.q, b.k, b.v, b.do, lse, delta, b.seg, *b.spans, b.H)
    ms = benchmark(bwd_variant, kernel, mode, *args, library, reps=reps,
                   device=b.device.type) * 1e3
    nbytes, flops, exps = work(kernel, mode, b, library)
    bms, by = bound_ms(nbytes, flops, exps)
    print(f'{library:14s} {kernel:3s} {mode:8s} {ms:8.4f} ms (bound '
          f'{bms:.4f} ms by {by})', flush=True)
    return {'ms': ms, 'bound_ms': bms, 'bound_by': by, 'bytes': nbytes,
            'flops': flops, 'exps': exps}


def main(argv=None):
    args = parse_args(argv, __doc__.splitlines()[0])
    b = attention_batch(args.budget, BWD_SEED, device=args.device,
                        dtype=args.dtype, grads=True)
    lse, delta = backward_inputs(b)
    pairs = segment_pairs(b.seg) * b.H
    print(f'shape: H={b.H} D={b.D} T={b.T} {args.dtype} on {args.device}, '
          f'{len(b.cu) - 1} sequences, {pairs:.4g} same-segment pairs',
          flush=True)
    full = (b.q, b.k, b.v, b.do, lse, delta, b.seg, *b.spans, b.H)
    ms = benchmark(flash.segment_flash_bwd, *full, reps=args.reps,
                   device=args.device) * 1e3
    print(f'bwd both (H2)  {ms:8.4f} ms ({flash.bwd_route(b.D)})',
          flush=True)
    hopper = bwd_route(b.D)
    out = {'bwd_ms': ms, **{
        library: {f'{kernel} {mode}': run(kernel, mode, b, lse, delta,
                                          args.reps, library)
                  for kernel in KERNELS for mode in MODES}
        for library in (hopper, *(n for n in flash.BWD_ROUTES
                                  if n != hopper))}}
    if b.device.type == 'cuda':
        out['timeline'] = {}
        for form in TIMELINE_FORMS:
            for _ in range(2):   # the second call's stamps, warm
                *_, stamps, stages = dkv_timeline(form, *full[:7],
                                                  *full[9:])
            summary = timeline_summary(stamps, stages)
            print(timeline_line(f'dk/dv timeline, {form}-row stages',
                                summary), flush=True)
            out['timeline'][form] = summary
    return out


if __name__ == '__main__':
    main(sys.argv[1:])
