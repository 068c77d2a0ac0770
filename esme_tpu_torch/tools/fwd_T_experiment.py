"""Transposed-score segment-flash forward on token-minor operands: kernel
H5 (``csrc/flash_fwd_t.cu``), timed beside H1.

Counterpart of ``tools/fwd_T_experiment.py`` (K14: ``_fwd_kernel_T`` at
27, launched by ``fwd_T`` at 115), the experiment that moved the TPU's
forward to scores laid out ``(keys, queries)``, so that the softmax's max
and sum reduce over the keys on the cheap axis. The function is H1's;
q, k, v and o are token-minor ``(H, D, T)``, lse ``(H, T)``. On the card
the question becomes what the transposed orientation costs there (see
the kernel's source). H5 takes H1's spans and tiles (128-query blocks
over 64-key tiles); there is nothing to sweep.

    python -m esme_tpu_torch.tools.fwd_T_experiment [--device cpu]

prints H5's and H1's ms at ESM2-650M's attention on bench.py's 50k batch
and H5's largest differences from H1.
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
    (kernel H5).

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
    from .. import _build
    lib = _build.library('flash_fwd_t')
    oT = torch.empty_like(qT)
    lse = torch.empty((H, T), dtype=torch.float32, device=qT.device)
    rc = lib.esme_flash_fwd_t(
        qT.data_ptr(), kT.data_ptr(), vT.data_ptr(), seg_ids.data_ptr(),
        kstart.data_ptr(), kend.data_ptr(), oT.data_ptr(), lse.data_ptr(),
        T, H, D, 1.0 / math.sqrt(D) if scale is None else scale,
        torch.cuda.current_stream(qT.device).cuda_stream)
    _build.check(rc, lib, 'esme_flash_fwd_t_error_string', what)
    fwd_T.launches += 1
    return oT, lse


fwd_T.launches = 0


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
    the same values: ms of each, H5's bound, and H5's largest
    differences from H1 under H1's gates."""
    ks, ke = b.spans[:2]
    qT, kT, vT = (thd_to_hdt(x, b.H) for x in (b.q, b.k, b.v))
    oT, lse = fwd_T(qT, kT, vT, b.seg, ks, ke)
    o1, lse1 = flash.segment_flash_fwd(b.q, b.k, b.v, b.seg, ks, ke, b.H)
    e_o, share, e_l, ok = flash_errors(hdt_to_thd(oT), lse, o1, lse1)
    dev = b.device.type
    ms = benchmark(fwd_T, qT, kT, vT, b.seg, ks, ke, reps=reps,
                   device=dev) * 1e3
    h1_ms = benchmark(flash.segment_flash_fwd, b.q, b.k, b.v, b.seg, ks,
                      ke, b.H, reps=reps, device=dev) * 1e3
    nbytes, flops, exps = work(b)
    bms, by = bound_ms(nbytes, flops, exps)
    return {'ms': ms, 'h1_ms': h1_ms, 'bound_ms': bms, 'bound_by': by,
            'bytes': nbytes, 'flops': flops, 'exps': exps,
            'steps': steps(ks, ke) * b.H, 'o_err_vs_h1': e_o,
            'o_gate_share_vs_h1': share, 'lse_err_vs_h1': e_l,
            'ok_vs_h1': ok}


def main(argv=None):
    args = parse_args(argv, __doc__.splitlines()[0])
    b = attention_batch(args.budget, FWD_SEED, device=args.device,
                        dtype=args.dtype)
    print(f'shape: H={b.H} D={b.D} T={b.T} {args.dtype} on {args.device}, '
          f'{len(b.cu) - 1} sequences', flush=True)
    r = measure(b, args.reps)
    print(f'fwd_T (H5) bq={BLOCK_Q} bk={BLOCK_K}: {r["ms"]:8.4f} ms '
          f'(bound {r["bound_ms"]:.4f} ms by {r["bound_by"]})', flush=True)
    print(f'H1        bq={BLOCK_Q} bk={BLOCK_K}: {r["h1_ms"]:8.4f} ms '
          f'(H5 / H1 {r["ms"] / r["h1_ms"]:.3f})', flush=True)
    print(f'   err vs H1: max|o| {r["o_err_vs_h1"]:.3e} '
          f'({r["o_gate_share_vs_h1"]:.3f} of the gate), max|lse| '
          f'{r["lse_err_vs_h1"]:.3e}', flush=True)
    return r


if __name__ == '__main__':
    main(sys.argv[1:])
