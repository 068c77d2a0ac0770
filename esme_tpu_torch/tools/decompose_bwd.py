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
blocks over 64-query tiles, which on the Hopper form walk the union of
the spans of the two 64-row halves of a 128-row block
(:func:`union_spans`), so the modes without a mask add those tiles too.

    python -m esme_tpu_torch.tools.decompose_bwd [--device cpu]

prints, on bench.py's 50k train batch, the full backward, then each mode
of each pass of the Hopper form and of the mma.sync form, beside the
bound of the work kept.
"""

from __future__ import annotations

import math
import sys

import torch

from ..ops import flash
from ..profiling import benchmark
from . import (BWD_SEED, FLASH_G_REL, SUM_REL, attention_batch, bound_ms,
               check_cuda_tensors, pad_rows, parse_args, scaled_error,
               segment_pairs)

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
    (square tiles, as on the TPU and in the kernel). Returns dk, dv
    ``(T, H·D)`` in q's dtype."""
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
    nkb, nqt = -(-T // bk), -(-T // bq)
    k, v = _tiles(k2, bk, H), _tiles(v2, bk, H)        # (nkb, H, bk, D)
    q, do = _tiles(q2, bq, H), _tiles(do2, bq, H)      # (nqt, H, bq, D)
    lse_c, delta_c = _row_terms(lse, bq), _row_terms(delta, bq)
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


def _library(library, head_dim: int) -> str:
    """``library``, a key of ``flash.BWD_ROUTES``, or H2's route at
    ``head_dim`` when None."""
    library = flash.bwd_route(head_dim) if library is None else library
    if library not in flash.BWD_ROUTES:
        raise ValueError(f'unknown library {library!r}; one of '
                         f'{list(flash.BWD_ROUTES)}')
    return library


def bwd_variant_plain(kernel: str, mode: str, q2, k2, v2, do2, lse, delta,
                      seg_ids, kstart, kend, qstart, qend, num_heads: int,
                      library: str | None = None):
    """Plain PyTorch version of :func:`bwd_variant`: its pass at the walk
    of ``library``'s form (the dk/dv pass of the Hopper form over
    :func:`union_spans`)."""
    library = _library(library, q2.shape[1] // num_heads)
    if kernel == 'dq':
        return dq_variant_plain(mode, q2, k2, v2, do2, lse, delta, seg_ids,
                                kstart, kend, num_heads)
    if library == 'flash_bwd_sm90':
        qstart, qend = union_spans(qstart, qend)
    return dkv_variant_plain(mode, q2, k2, v2, do2, lse, delta, seg_ids,
                             qstart, qend, num_heads)


def bwd_variant(kernel: str, mode: str, q2, k2, v2, do2, lse, delta,
                seg_ids, kstart, kend, qstart, qend, num_heads: int,
                library: str | None = None):
    """One of H2's passes in ablation mode ``mode`` (kernel H7): the
    arguments of :func:`esme_tpu_torch.ops.flash.segment_flash_bwd`, D =
    64 only, on ``library``'s form (a key of ``flash.BWD_ROUTES``; H2's
    route at D when None, the Hopper form at 64). ``kernel='dq'`` returns
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


def walked_pairs(kernel: str, library: str, spans) -> float:
    """The (q, k) pairs per head of the tiles ``library``'s ``kernel``
    pass walks over ``spans`` (:func:`esme_tpu_torch.ops.flash.
    flash_spans`)."""
    kstart, kend, qstart, qend = spans
    if kernel == 'dq':
        return float((kend - kstart).clamp_min(0).sum().item()) \
            * flash.BLOCK_Q * flash.BLOCK_K
    if library == 'flash_bwd_sm90':
        qstart, qend = union_spans(qstart, qend)
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
    pairs = (walked_pairs(kernel, library, b.spans) if mode in UNMASKED
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
    hopper = flash.bwd_route(b.D)
    return {'bwd_ms': ms, **{
        library: {f'{kernel} {mode}': run(kernel, mode, b, lse, delta,
                                          args.reps, library)
                  for kernel in KERNELS for mode in MODES}
        for library in (hopper, *(n for n in flash.BWD_ROUTES
                                  if n != hopper))}}


if __name__ == '__main__':
    main(sys.argv[1:])
