"""Ceiling probes of the segment-flash forward's passes, each alone
("H8", ``csrc/probes.cu``), beside H1 itself.

Counterpart of ``tools/profile_attn.py`` (K16: ``vpu_kernel`` at 81,
``mxu_kernel`` at 115, ``dma_kernel`` at 155 and ``extra``'s
``dma_kernel`` at 209), which separated the TPU forward's softmax passes
(VPU), products (MXU) and k/v streams (DMA). Each probe here runs over
H1's grid and H1's exact count of (q block, k tile, head) steps:

  vpu    the softmax passes on a resident fp32 score tile: scale, row
         max, exp2, row sum; output sum(exp(s - max s)) per row
  mxu    H1's two products per step on resident tiles: bf16(q k^T) v
  dma    k and v tiles streamed from (T, H·D) over tiles (i + j) % nkb;
         output q + the last tile's first row summed
  dma_t  the same from token-minor (H, D, T); output the last tile's
         first token summed over d

The TPU tool's tile sweep of the forward (``time_v1``) has no
counterpart: H1's tiles are fixed, so :func:`main` times H1 at its own.

    python -m esme_tpu_torch.tools.profile_attn [--device cpu]
"""

from __future__ import annotations

import sys

import torch

from ..ops import flash
from ..profiling import benchmark
from . import (FLASH_O_REL, FWD_SEED, SUM_REL, attention_batch, bound_ms,
               check_cuda_tensors, parse_args, scaled_error, steps,
               thd_to_hdt)
from .fwd_T_experiment import work as flash_work

BLOCK_Q, BLOCK_K = flash.BLOCK_Q, flash.BLOCK_K
PROBES = ('vpu', 'mxu', 'dma', 'dma_t')


# ---------------------------------------------------------------------------
# Plain versions: the TPU probes' functions, tiles and head groups as
# parameters
# ---------------------------------------------------------------------------

def vpu_plain(s):
    """``sum(exp(s - max(s)))`` over the last axis, keeping it (the TPU
    probe's ``(hb, bq, 1)`` output of an ``(hb, bq, bk)`` block)."""
    s = s.float()
    return torch.exp(s - s.amax(-1, keepdim=True)).sum(-1, keepdim=True)


def mxu_plain(q, k, v):
    """``(q k^T as bf16) v`` per leading index, fp32 sums, in q's
    dtype."""
    s = torch.einsum('...qd,...kd->...qk', q.float(), k.float())
    return torch.einsum('...qk,...kd->...qd', s.to(torch.bfloat16).float(),
                        v.float()).to(q.dtype)


def _last_tiles(nsteps, nqb: int, nkb: int, block_k: int):
    """First row of the tile each q block reads last, ``(i + n_i - 1) %
    nkb`` in ``block_k`` units, and whether the block read any."""
    nsteps = torch.as_tensor(nsteps).long().expand(nqb)
    i = torch.arange(nqb, device=nsteps.device)
    return ((i + nsteps - 1) % nkb) * block_k, nsteps > 0


def dma_plain(q2, k2, v2, nsteps, num_heads: int, block_q: int = BLOCK_Q,
              block_k: int = BLOCK_K, head_block: int = 1):
    """The DMA probe's output on ``(T, H·D)`` tensors: each q block of
    each head group plus, in q's dtype, the sum over d of k + v at the
    first row of the last tile the block reads (of the group's first
    head); ``nsteps`` is each block's step count (or one for all)."""
    T, HD = q2.shape
    H = num_heads
    D = HD // H
    nqb, nkb = -(-T // block_q), -(-T // block_k)
    t0, read = _last_tiles(nsteps, nqb, nkb, block_k)
    first = (torch.arange(H, device=q2.device) // head_block) * head_block
    # tiles past T read zeros, as the kernel's zero-filled tiles do
    k3, v3 = (torch.cat([x.view(T, H, D), x.new_zeros(1, H, D)])
              for x in (k2, v2))
    t0 = t0.clamp(max=T)
    t = (k3[t0][:, first].float() + v3[t0][:, first].float()).sum(-1)
    t = torch.where(read[:, None], t, 0.0).to(q2.dtype)     # (nqb, H)
    rows = torch.arange(T, device=q2.device) // block_q
    o = q2.view(T, H, D).float() + t[rows].float()[..., None]
    return o.to(q2.dtype).view(T, HD)


def dma_t_plain(kT, vT, nsteps, block_q: int = BLOCK_Q,
                block_k: int = BLOCK_K, head_block: int = 1):
    """The token-minor DMA probe's function: per head group and q block,
    the sum over d of k + v at the first token of the last tile the
    block reads (the group's first head), fp32 ``(H / head_block,
    nqb)``."""
    H, D, T = kT.shape
    nqb, nkb = -(-T // block_q), -(-T // block_k)
    t0, read = _last_tiles(nsteps, nqb, nkb, block_k)
    first = torch.arange(0, H, head_block, device=kT.device)
    k, v = (torch.cat([x[first], x.new_zeros(len(first), D, 1)], 2)
            for x in (kT, vT))          # tiles past T read zeros
    t0 = t0.clamp(max=T)
    t = (k[:, :, t0].float() + v[:, :, t0].float()).sum(1)
    return torch.where(read[None], t, 0.0)


# ---------------------------------------------------------------------------
# Kernels (H8): grids (ceil(T / 128), H) over H1's spans, D = 64
# ---------------------------------------------------------------------------

def _check_spans(what, kstart, kend, nqb, device):
    flash._check_index_inputs(what, device, (
        ('kstart', kstart, nqb, torch.int32),
        ('kend', kend, nqb, torch.int32)))


def _launch(fn_name, what, args, out):
    from .. import _build
    lib = _build.library('probes')
    rc = getattr(lib, fn_name)(*args)
    _build.check(rc, lib, 'esme_probe_error_string', what)
    return out


def vpu(s, kstart, kend, num_heads: int):
    """The softmax-pass probe: ``s`` a ``(128, 64)`` fp32 score tile;
    returns ``(H, 128)``, each row's ``sum(exp(s - max s))`` as the first
    q block of each head computes it."""
    if s.device.type == 'cpu':
        return vpu_plain(s)[:, 0].expand(num_heads, -1).clone()
    check_cuda_tensors('vpu', (('s', s),), (BLOCK_Q, BLOCK_K), torch.float32)
    _check_spans('vpu', kstart, kend, kstart.numel(), s.device)
    out = torch.empty((num_heads, BLOCK_Q), dtype=torch.float32,
                      device=s.device)
    _launch('esme_probe_vpu', 'vpu', (
        s.data_ptr(), kstart.data_ptr(), kend.data_ptr(), out.data_ptr(),
        kstart.numel(), num_heads,
        torch.cuda.current_stream(s.device).cuda_stream), out)
    vpu.launches += 1
    return out


def mxu(q, k, kstart, kend, num_heads: int):
    """The products probe: q ``(128, 64)``, k ``(64, 64)`` bf16 (v = k);
    returns ``(H, 128, 64)``, ``bf16(q k^T) k`` as the first q block of
    each head computes it (its sum over its steps, divided by them)."""
    if q.device.type == 'cpu':
        return mxu_plain(q, k, k).expand(num_heads, -1, -1).clone()
    check_cuda_tensors('mxu', (('q', q),), (BLOCK_Q, 64))
    check_cuda_tensors('mxu', (('k', k),), (BLOCK_K, 64))
    _check_spans('mxu', kstart, kend, kstart.numel(), q.device)
    out = torch.empty((num_heads, BLOCK_Q, 64), dtype=q.dtype,
                      device=q.device)
    _launch('esme_probe_mxu', 'mxu', (
        q.data_ptr(), k.data_ptr(), kstart.data_ptr(), kend.data_ptr(),
        out.data_ptr(), kstart.numel(), num_heads,
        torch.cuda.current_stream(q.device).cuda_stream), out)
    mxu.launches += 1
    return out


def dma(q2, k2, v2, kstart, kend, num_heads: int):
    """The k/v streaming probe on ``(T, H·64)`` bf16 tensors: o as
    :func:`dma_plain` with each block's steps ``kend - kstart``."""
    if q2.device.type == 'cpu':
        return dma_plain(q2, k2, v2, kend - kstart, num_heads)
    T, HD = q2.shape
    if HD != num_heads * 64:
        raise ValueError(f'dma: head dim {HD / num_heads:g}: the probes are '
                         'built for D = 64 only')
    check_cuda_tensors('dma', (('q', q2), ('k', k2), ('v', v2)), (T, HD))
    _check_spans('dma', kstart, kend, -(-T // BLOCK_Q), q2.device)
    o = torch.empty_like(q2)
    _launch('esme_probe_dma', 'dma', (
        q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), kstart.data_ptr(),
        kend.data_ptr(), o.data_ptr(), T, num_heads,
        torch.cuda.current_stream(q2.device).cuda_stream), o)
    dma.launches += 1
    return o


def dma_t(kT, vT, kstart, kend):
    """The token-minor streaming probe on ``(H, 64, T)`` bf16 tensors, T
    a multiple of 8: ``(H, nqb)`` as :func:`dma_t_plain`."""
    if kT.device.type == 'cpu':
        return dma_t_plain(kT, vT, kend - kstart)
    H, D, T = kT.shape
    if D != 64 or T % 8:
        raise ValueError(f'dma_t: head dim {D}, T = {T}: the probe takes D '
                         '= 64 and T a multiple of 8')
    check_cuda_tensors('dma_t', (('kT', kT), ('vT', vT)), (H, D, T))
    _check_spans('dma_t', kstart, kend, -(-T // BLOCK_Q), kT.device)
    out = torch.empty((H, kstart.numel()), dtype=torch.float32,
                      device=kT.device)
    _launch('esme_probe_dma_t', 'dma_t', (
        kT.data_ptr(), vT.data_ptr(), kstart.data_ptr(), kend.data_ptr(),
        out.data_ptr(), T, H, torch.cuda.current_stream(kT.device)
        .cuda_stream), out)
    dma_t.launches += 1
    return out


for _f in (vpu, mxu, dma, dma_t):
    _f.launches = 0


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------

# Gates of a probe against its plain version on the card, relative to
# max(|x|, floor): vpu's sums within 1e-4 (exp2 in base 2, fp32
# summation order; floor 1); mxu's output under H1's o gate at its rms
# (bf16(s) can round the other way where the fp32 sums differ); dma's o,
# q plus a sum rounded to bf16, within an ulp of bf16 at o's rms (the
# sum, ~o's rms, can round the other way); dma_t's fp32 sums within
# 1e-5 (floor 1).
GATES = {'vpu': (1e-4, 1.0), 'mxu': (FLASH_O_REL, None),
         'dma': (SUM_REL, None), 'dma_t': (1e-5, 1.0)}


def check(probe: str, got, ref):
    """A probe's kernel output against its plain version's: ``{'err',
    'share', 'ok'}``."""
    rel, floor = GATES[probe]
    err, share = scaled_error(got, ref, rel, floor)
    return {'err': err, 'share': share, 'ok': share <= 1.0}


def probe_inputs(b):
    """The probes' inputs on batch ``b`` (values from a generator seeded
    with 1): a normal fp32 score tile, resident q and k tiles, and k and
    v token-minor."""
    gen = torch.Generator(device=b.device)
    gen.manual_seed(1)
    s = torch.randn((BLOCK_Q, BLOCK_K), generator=gen, device=b.device)
    qt = torch.randn((BLOCK_Q, 64), generator=gen, device=b.device) \
        .to(b.q.dtype)
    kt = torch.randn((BLOCK_K, 64), generator=gen, device=b.device) \
        .to(b.q.dtype)
    return s, qt, kt, thd_to_hdt(b.k, b.H), thd_to_hdt(b.v, b.H)


def calls(b, inputs):
    """``{probe: (kernel call, plain call)}`` on batch ``b``."""
    s, qt, kt, kT, vT = inputs
    ks, ke = b.spans[:2]
    n = ke - ks
    return {
        'vpu': (lambda: vpu(s, ks, ke, b.H),
                lambda: vpu_plain(s)[:, 0].expand(b.H, -1)),
        'mxu': (lambda: mxu(qt, kt, ks, ke, b.H),
                lambda: mxu_plain(qt, kt, kt).expand(b.H, -1, -1)),
        'dma': (lambda: dma(b.q, b.k, b.v, ks, ke, b.H),
                lambda: dma_plain(b.q, b.k, b.v, n, b.H)),
        'dma_t': (lambda: dma_t(kT, vT, ks, ke),
                  lambda: dma_t_plain(kT, vT, n)),
    }


def work(probe: str, b):
    """Bytes and operations a probe's function needs on batch ``b`` over
    H1's step count: vpu an exp and four fp32 operations (scale, max,
    subtract, add) per score element; mxu two products of 128·64·64
    multiply-adds per step; dma q, k, v read and o written once; dma_t k
    and v read once. ``tile_bytes``: the k/v tiles the streaming probes
    walk, re-reads included."""
    n = steps(*b.spans[:2]) * b.H
    elems = float(n) * BLOCK_Q * BLOCK_K
    one = b.q.numel() * b.q.element_size()
    tile_bytes = float(n) * 2 * BLOCK_K * 64 * b.q.element_size()
    return {'vpu': dict(exps=elems, fp32_ops=4 * elems),
            'mxu': dict(flops=2 * 2.0 * elems * 64),
            'dma': dict(nbytes=4.0 * one),
            'dma_t': dict(nbytes=2.0 * one)}[probe], tile_bytes


def measure(b, reps: int):
    """Each probe on batch ``b``: its kernel against its plain version,
    its ms, its bound and, for H1 on the same batch, H1's ms. Prints a
    line per probe."""
    dev = b.device.type
    ks, ke = b.spans[:2]
    h1_ms = benchmark(flash.segment_flash_fwd, b.q, b.k, b.v, b.seg, ks, ke,
                      b.H, reps=reps, device=dev) * 1e3
    h1_bound = bound_ms(*flash_work(b))
    print(f'H1 bq={BLOCK_Q} bk={BLOCK_K} steps={steps(ks, ke) * b.H}: '
          f'{h1_ms:8.4f} ms (bound {h1_bound[0]:.4f} ms by {h1_bound[1]})',
          flush=True)
    out = {'h1': {'ms': h1_ms, 'bound_ms': h1_bound[0]}}
    for probe, (kernel, plain) in calls(b, probe_inputs(b)).items():
        c = check(probe, kernel(), plain())
        ms = benchmark(kernel, reps=reps, device=dev) * 1e3
        kw, tile_bytes = work(probe, b)
        bms, by = bound_ms(**kw)
        rate = ''                       # device rates, on the card only
        if dev == 'cuda' and probe == 'mxu':
            rate = f', {kw["flops"] / ms / 1e9:.1f} TFLOP/s of 989'
        elif dev == 'cuda' and probe.startswith('dma'):
            rate = f', tiles {tile_bytes / ms / 1e6:.1f} GB/s'
        print(f'{probe:6s} {ms:8.4f} ms (bound {bms:.4f} ms by {by}{rate}); '
              f'vs plain {c["err"]:.3e} ({c["share"]:.3f} of the gate)',
              flush=True)
        out[probe] = {'ms': ms, 'bound_ms': bms, 'bound_by': by,
                      'tile_bytes': tile_bytes, **kw, **c}
    return out


def main(argv=None):
    args = parse_args(argv, __doc__.splitlines()[0])
    b = attention_batch(args.budget, FWD_SEED, device=args.device,
                        dtype=args.dtype)
    print(f'shape: H={b.H} D={b.D} T={b.T} {args.dtype} on {args.device}',
          flush=True)
    return measure(b, args.reps)


if __name__ == '__main__':
    main(sys.argv[1:])
