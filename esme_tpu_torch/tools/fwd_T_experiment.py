"""Segment-flash forward on token-minor operands: kernel H5, timed beside
H1.

Counterpart of ``tools/fwd_T_experiment.py`` (K14: ``_fwd_kernel_T`` at
27, launched by ``fwd_T`` at 115), the experiment that moved the TPU's
forward to scores laid out ``(keys, queries)``, so that the softmax's max
and sum reduce over the keys on the cheap axis. The function is H1's;
q, k, v and o are token-minor ``(H, D, T)``, lse ``(H, T)``. On the card
the question becomes what the token-minor layout costs there. H5 has two
forms, routed by a static rule (:func:`fwd_T_route`): H1's Hopper kernel
with the token-minor layout (``csrc/flash_fwd_sm90.cu``, entry
``esme_flash_fwd_t_sm90``: only its shared-memory descriptors differ from
H1's) at D = 32, 64, 128 when T % 8 == 0 (TMA's row stride), and the
``mma.sync`` form with transposed scores (``csrc/flash_fwd_t.cu``)
otherwise. Both take H1's spans and tiles (128-query blocks over 64-key
tiles); there is nothing to sweep.

    python -m esme_tpu_torch.tools.fwd_T_experiment [--device cpu]

prints, at ESM2-650M's attention on bench.py's 50k batch, H5's ms on its
route, its mma.sync form's and H1's, each beside the bound, and H5's
largest differences from H1.
"""

from __future__ import annotations

import math
import sys

import torch

from ..ops import flash
from ..ops.attention import NEG_INF
from ..profiling import benchmark
from . import (FLASH_LSE_ATOL, FLASH_O_FLOOR, FLASH_O_REL, FWD_SEED,
               attention_batch, bound_ms, check_cuda_tensors, hdt_to_thd,
               parse_args, scaled_error, segment_pairs, steps, thd_to_hdt)

BLOCK_Q, BLOCK_K = flash.BLOCK_Q, flash.BLOCK_K

# H5's routes: library -> (entry, error string)
FWD_T_ROUTES = {
    'flash_fwd_sm90': ('esme_flash_fwd_t_sm90',
                       'esme_flash_fwd_sm90_error_string'),
    'flash_fwd_t': ('esme_flash_fwd_t', 'esme_flash_fwd_t_error_string'),
}


def fwd_T_route(head_dim: int, T: int) -> str:
    """The library H5 launches: H1's Hopper kernel (token-minor layout) at
    its head dims when T % 8 == 0, where a token-minor row is a multiple
    of 16 bytes as TMA requires; the mma.sync form otherwise."""
    return 'flash_fwd_sm90' if head_dim in flash.SM90_HEAD_DIMS \
        and T % 8 == 0 else 'flash_fwd_t'


def fwd_T_plain(qT, kT, vT, seg_ids, kstart, kend, scale=None,
                block_q: int = BLOCK_Q, block_k: int = BLOCK_K):
    """Plain PyTorch version of H5, written from ``fwd_T``'s math.

    For each run of q blocks (1024 queries), the scores of the union of
    their k spans (``kstart``/``kend`` in ``block_k`` tiles per
    ``block_q`` block) are formed transposed, ``(H, keys, queries)``,
    masked to -1e30 across segments; the max and the sum run over the
    keys (axis 1); p is rounded to v's dtype before the product with v
    and the product is divided by the sum after it; fp32 throughout
    otherwise. Returns oT ``(H, D, T)`` in q's dtype and lse ``(H, T)``
    fp32."""
    H, D, T = qT.shape
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    oT = torch.empty_like(qT)
    lse = torch.empty((H, T), dtype=torch.float32, device=qT.device)
    ks, ke = kstart.tolist(), kend.tolist()
    per = max(1, 1024 // block_q)
    for b0 in range(0, len(ks), per):
        b1 = min(len(ks), b0 + per)
        r0, r1 = b0 * block_q, min(T, b1 * block_q)
        k0 = min(ks[b0:b1]) * block_k
        k1 = min(T, max(ke[b0:b1]) * block_k)
        s = torch.einsum('hds,hdt->hst', kT[:, :, k0:k1].float(),
                         qT[:, :, r0:r1].float()) * scale
        mask = seg_ids[k0:k1, None] == seg_ids[None, r0:r1]
        s = torch.where(mask[None], s, NEG_INF)
        m = s.amax(1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(1, keepdim=True)
        pv = torch.einsum('hds,hst->hdt', vT[:, :, k0:k1].float(),
                          p.to(vT.dtype).float())
        l_safe = torch.where(l == 0, 1.0, l)
        oT[:, :, r0:r1] = (pv / l_safe).to(qT.dtype)
        lse[:, r0:r1] = (m + torch.log(l_safe))[:, 0]
    return oT, lse


def fwd_T(qT, kT, vT, seg_ids, kstart, kend, scale=None):
    """Segment-masked flash attention forward over token-minor operands
    (kernel H5), on the route :func:`fwd_T_route` picks; ``launches``
    counts either route, ``routes`` each.

    Args:
        qT, kT, vT: ``(H, D, T)``, RoPE already applied to q and k.
        seg_ids: ``(T,)`` int32.
        kstart, kend: H1's spans, ``ops.flash.block_spans(seg_ids,
            BLOCK_Q, BLOCK_K)``.
        scale: the scores' scale, ``1/sqrt(D)`` when None.
    Returns:
        oT ``(H, D, T)`` in q's dtype and lse ``(H, T)`` fp32.
    """
    if qT.device.type == 'cpu':
        return fwd_T_plain(qT, kT, vT, seg_ids, kstart, kend, scale)
    H, D, T = qT.shape
    what = 'fwd_T'
    check_cuda_tensors(what, (('qT', qT), ('kT', kT), ('vT', vT)), (H, D, T))
    if D not in flash.HEAD_DIMS:
        raise ValueError(f'{what}: head dim {D} is not one of '
                         f'{flash.HEAD_DIMS}')
    nqb = -(-T // BLOCK_Q)
    flash._check_index_inputs(what, qT.device, (
        ('seg_ids', seg_ids, T, torch.int32),
        ('kstart', kstart, nqb, torch.int32),
        ('kend', kend, nqb, torch.int32)))
    route = fwd_T_route(D, T)
    out = launch_fwd_T(route, qT, kT, vT, seg_ids, kstart, kend, scale)
    fwd_T.launches += 1
    fwd_T.routes[route] += 1
    return out


fwd_T.launches = 0
fwd_T.routes = dict.fromkeys(FWD_T_ROUTES, 0)


def launch_fwd_T(name, qT, kT, vT, seg_ids, kstart, kend, scale=None,
                 lib=None):
    """H5's library ``name`` (a key of ``FWD_T_ROUTES``) launched through
    its C entry on :func:`fwd_T`'s arguments, which it does not check; no
    counter moves. ``lib``, another build of the same entry (an A/B
    variant), takes the library's place. Returns ``oT, lse``."""
    from .. import _build
    H, D, T = qT.shape
    entry, error_string = FWD_T_ROUTES[name]
    lib = _build.library(name) if lib is None else lib
    oT = torch.empty_like(qT)
    lse = torch.empty((H, T), dtype=torch.float32, device=qT.device)
    rc = getattr(lib, entry)(
        *(x.data_ptr() for x in (qT, kT, vT, seg_ids, kstart, kend, oT,
                                 lse)),
        T, H, D, 1.0 / math.sqrt(D) if scale is None else scale,
        torch.cuda.current_stream(qT.device).cuda_stream)
    _build.check(rc, lib, error_string, f'fwd_T ({name})')
    return oT, lse


def flash_errors(o, lse, o_ref, lse_ref):
    """H1's gates: ``(max|Δo|, its largest share of 2^-6·max(|o|, 1/4),
    max|Δlse|, ok)``."""
    e_o, share = scaled_error(o, o_ref, FLASH_O_REL, FLASH_O_FLOOR)
    e_l = (lse.float() - lse_ref.float()).abs().max().item()
    return e_o, share, e_l, share <= 1.0 and e_l <= FLASH_LSE_ATOL


def work(b):
    """Bytes and operations the function needs on batch ``b``: q, k, v
    read and o written once, lse written, segment ids and spans read;
    two products of 2·D flops and one exp per same-segment pair and
    head."""
    ks = b.spans[0]
    pairs = segment_pairs(b.seg) * b.H
    nbytes = 4 * b.q.numel() * b.q.element_size() + b.H * b.T * 4 \
        + b.T * 4 + 2 * ks.numel() * 4
    return nbytes, 4.0 * b.D * pairs, pairs


def measure(b, reps: int):
    """H5 on batch ``b`` (q, k, v made token-minor first) against H1 on
    the same values: ms of H5 on its route, of its mma.sync form (through
    its C entry, on the card) and of H1, H5's bound, and H5's largest
    differences from H1 under H1's gates."""
    ks, ke = b.spans[:2]
    qT, kT, vT = (thd_to_hdt(x, b.H) for x in (b.q, b.k, b.v))
    args = (qT, kT, vT, b.seg, ks, ke)
    oT, lse = fwd_T(*args)
    o1, lse1 = flash.segment_flash_fwd(b.q, b.k, b.v, b.seg, ks, ke, b.H)
    e_o, share, e_l, ok = flash_errors(hdt_to_thd(oT), lse, o1, lse1)
    dev = b.device.type
    ms = benchmark(fwd_T, *args, reps=reps, device=dev) * 1e3
    mma_sync_ms = benchmark(launch_fwd_T, 'flash_fwd_t', *args, reps=reps,
                            device=dev) * 1e3 if dev == 'cuda' else None
    h1_ms = benchmark(flash.segment_flash_fwd, b.q, b.k, b.v, b.seg, ks,
                      ke, b.H, reps=reps, device=dev) * 1e3
    nbytes, flops, exps = work(b)
    bms, by = bound_ms(nbytes, flops, exps)
    return {'ms': ms, 'route': fwd_T_route(b.D, b.T),
            'mma_sync_ms': mma_sync_ms, 'h1_ms': h1_ms, 'bound_ms': bms,
            'bound_by': by, 'bytes': nbytes, 'flops': flops, 'exps': exps,
            'steps': steps(ks, ke) * b.H, 'o_err_vs_h1': e_o,
            'o_gate_share_vs_h1': share, 'lse_err_vs_h1': e_l,
            'ok_vs_h1': ok, 'bit_equal_to_h1': bool(
                torch.equal(hdt_to_thd(oT), o1) and torch.equal(lse, lse1))}


def main(argv=None):
    args = parse_args(argv, __doc__.splitlines()[0])
    b = attention_batch(args.budget, FWD_SEED, device=args.device,
                        dtype=args.dtype)
    print(f'shape: H={b.H} D={b.D} T={b.T} {args.dtype} on {args.device}, '
          f'{len(b.cu) - 1} sequences', flush=True)
    r = measure(b, args.reps)
    bound = f'bound {r["bound_ms"]:.4f} ms by {r["bound_by"]}'
    print(f'fwd_T (H5, {r["route"]}) bq={BLOCK_Q} bk={BLOCK_K}: '
          f'{r["ms"]:8.4f} ms ({bound})', flush=True)
    if r['mma_sync_ms'] is not None:
        print(f'fwd_T mma.sync form (flash_fwd_t): {r["mma_sync_ms"]:8.4f} ms '
              f'(H5 / it {r["ms"] / r["mma_sync_ms"]:.3f})', flush=True)
    print(f'H1 ({flash.fwd_route(b.D)}): {r["h1_ms"]:8.4f} ms '
          f'(H5 / H1 {r["ms"] / r["h1_ms"]:.3f})', flush=True)
    print(f'   err vs H1: max|o| {r["o_err_vs_h1"]:.3e} '
          f'({r["o_gate_share_vs_h1"]:.3f} of the gate), max|lse| '
          f'{r["lse_err_vs_h1"]:.3e}, bit-equal {r["bit_equal_to_h1"]}',
          flush=True)
    return r


if __name__ == '__main__':
    main(sys.argv[1:])
