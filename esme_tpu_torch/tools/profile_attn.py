"""Ceiling probes of the segment-flash forward's passes, each alone
("H8", ``csrc/probes.cu``; the streaming probes also
``csrc/probes_sm90.cu``), beside H1 itself.

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

The streaming probes have two forms (``FORMS``): the Hopper form
``csrc/probes_sm90.cu`` (TMA boxes through an mbarrier ring of 128-key
stages on H1's Hopper geometry), which the wrappers launch by default, and
the cp.async form ``csrc/probes.cu`` (``library='probes'``), kept as its
yardstick. ``dma(..., cluster=2)`` runs the Hopper form in pairs: q blocks
2c and 2c + 1 of a head in one 2-CTA cluster, each tile that both read
loaded once, by TMA multicast (:func:`stream_walk` is the walk). The
streaming probes are bound by the stream of tiles from L2 into the SMs,
not by DRAM: :func:`work` counts the tiles each form and mode loads, and
:func:`measure` prints their rate beside the DRAM bound.

The TPU tool's tile sweep of the forward (``time_v1``) has no
counterpart: H1's tiles are fixed, so :func:`main` times H1 at its own.

    python -m esme_tpu_torch.tools.profile_attn [--device cpu]
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import torch

from ..ops import flash
from ..profiling import benchmark
from . import (FLASH_O_REL, FWD_SEED, SUM_REL, attention_batch, bound_ms,
               check_cuda_tensors, parse_args, scaled_error, steps,
               thd_to_hdt)
from .fwd_T_experiment import work as flash_work

BLOCK_Q, BLOCK_K = flash.BLOCK_Q, flash.BLOCK_K
PROBES = ('vpu', 'mxu', 'dma', 'dma_t')


# The streaming probes' forms, the default (Hopper) first: the C entries of
# dma and dma_t, the cluster sizes dma takes, the library's error string
class Form(NamedTuple):
    dma: str
    dma_t: str
    clusters: tuple
    error: str


FORMS = {'probes_sm90': Form('esme_probe_dma_sm90', 'esme_probe_dma_t_sm90',
                             (1, 2), 'esme_probe_sm90_error_string'),
         'probes': Form('esme_probe_dma', 'esme_probe_dma_t', (1,),
                        'esme_probe_error_string')}

# The kernel runs held against their plain versions (:func:`calls`): name ->
# (probe, library, cluster); each streaming probe in each form and mode
RUNS = {'vpu': ('vpu', 'probes', 1), 'mxu': ('mxu', 'probes', 1),
        'dma': ('dma', 'probes_sm90', 1),
        'dma_pair': ('dma', 'probes_sm90', 2),
        'dma_cp_async': ('dma', 'probes', 1),
        'dma_t': ('dma_t', 'probes_sm90', 1),
        'dma_t_cp_async': ('dma_t', 'probes', 1)}
# the runs that must equal another bit for bit: the cp.async form's
SAME_AS = {'dma': 'dma_cp_async', 'dma_pair': 'dma_cp_async',
           'dma_t': 'dma_t_cp_async'}


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


def stream_walk(nsteps, nkb: int, cluster: int = 1):
    """The k/v boxes the Hopper form's CTAs load, as
    ``csrc/probes_sm90.cu`` walks them: per unit (q block i with
    ``cluster=1``; the pair 2c, 2c + 1 with ``cluster=2``, the second
    missing past the last block), its stages in order, each a list of
    boxes ``(first tile, tiles, mask)``: one or two 64-key tiles of k and
    of v, and the unit's blocks that read them (bit r: block i0 + r).

    Block r of a unit reads positions ``[r, r + n_r)`` (``n_r =
    max(nsteps[i0 + r], 0)``) of tiles ``(i0 + p) % nkb``, the TPU
    probe's walk; the positions of a pair make one run, two to a stage. A
    stage is one box when its tiles are adjacent and go to the same
    blocks, else two (the walk wraps past ``nkb - 1``, or one block's walk
    ends inside it); an odd run's last stage is one tile. With
    ``cluster=2`` a tile both blocks read appears once."""
    n = [max(int(x), 0) for x in nsteps]
    units = []
    for i0 in range(0, len(n), cluster):
        ns = [n[i0 + r] if i0 + r < len(n) else 0 for r in range(cluster)]
        lo = min((r for r, m in enumerate(ns) if m), default=0)
        hi = max((r + m for r, m in enumerate(ns) if m), default=0)

        def box(p):
            mask = sum(1 << r for r, m in enumerate(ns) if r <= p < r + m)
            return (i0 + p) % nkb, 1, mask
        stages = []
        for p in range(lo, hi, 2):
            a = box(p)
            b = box(p + 1) if p + 1 < hi else None
            if b is None:
                stages.append([a])
            elif b[0] == a[0] + 1 and b[2] == a[2]:
                stages.append([(a[0], 2, a[2])])
            else:
                stages.append([a, b])
        units.append(stages)
    return units


def walk_tiles(units) -> int:
    """The 64-key tiles (of k, and as many of v) a walk loads."""
    return sum(t for stages in units for stage in stages
               for _, t, _ in stage)


# ---------------------------------------------------------------------------
# Kernels (H8): grids (ceil(T / 128), H) over H1's spans, D = 64
# ---------------------------------------------------------------------------

def _check_spans(what, kstart, kend, nqb, device):
    flash._check_index_inputs(what, device, (
        ('kstart', kstart, nqb, torch.int32),
        ('kend', kend, nqb, torch.int32)))


def _launch(library, fn_name, what, args, out, lib=None):
    from .. import _build
    lib = _build.library(library) if lib is None else lib
    rc = getattr(lib, fn_name)(*args)
    _build.check(rc, lib, FORMS[library].error, what)
    return out


def _form(what: str, library, cluster=1) -> str:
    """``library``, a key of ``FORMS`` (the Hopper form when None), if
    its dma takes ``cluster``; raise otherwise."""
    library = next(iter(FORMS)) if library is None else library
    if library not in FORMS:
        raise ValueError(f'{what}: unknown library {library!r}; one of '
                         f'{list(FORMS)}')
    if cluster not in FORMS[library].clusters:
        raise ValueError(f'{what}: cluster {cluster!r}: the {library} form '
                         f'takes {FORMS[library].clusters}')
    return library


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
    _launch('probes', 'esme_probe_vpu', 'vpu', (
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
    _launch('probes', 'esme_probe_mxu', 'mxu', (
        q.data_ptr(), k.data_ptr(), kstart.data_ptr(), kend.data_ptr(),
        out.data_ptr(), kstart.numel(), num_heads,
        torch.cuda.current_stream(q.device).cuda_stream), out)
    mxu.launches += 1
    return out


def dma(q2, k2, v2, kstart, kend, num_heads: int, library=None,
        cluster: int = 1):
    """The k/v streaming probe on ``(T, H·64)`` bf16 tensors: o as
    :func:`dma_plain` with each block's steps ``kend - kstart``, on
    ``library``'s form (a key of ``FORMS``; the Hopper form when None), in
    clusters of ``cluster`` CTAs (2: q blocks in pairs, the Hopper form
    only). On the CPU, after the arguments are checked, the plain
    version."""
    library = _form('dma', library, cluster)
    if q2.device.type == 'cpu':
        return dma_plain(q2, k2, v2, kend - kstart, num_heads)
    T, HD = q2.shape
    if HD != num_heads * 64:
        raise ValueError(f'dma: head dim {HD / num_heads:g}: the probes are '
                         'built for D = 64 only')
    check_cuda_tensors('dma', (('q', q2), ('k', k2), ('v', v2)), (T, HD))
    _check_spans('dma', kstart, kend, -(-T // BLOCK_Q), q2.device)
    o = launch_dma(library, q2, k2, v2, kstart, kend, num_heads, cluster)
    dma.launches += 1
    return o


def launch_dma(library, q2, k2, v2, kstart, kend, num_heads: int,
               cluster: int = 1, lib=None):
    """:func:`dma`'s kernel on ``library``'s form, launched straight
    through its C entry (the Hopper entry also takes the cluster size):
    no checks, no counter. The wrapper's own launch; timed alone by
    ``chip_smoke.py`` and ``sm90_ab``."""
    T = q2.shape[0]
    o = torch.empty_like(q2)
    more = (cluster,) if len(FORMS[library].clusters) > 1 else ()
    return _launch(library, FORMS[library].dma, f'dma ({library})', (
        q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), kstart.data_ptr(),
        kend.data_ptr(), o.data_ptr(), T, num_heads, *more,
        torch.cuda.current_stream(q2.device).cuda_stream), o, lib)


def dma_t(kT, vT, kstart, kend, library=None):
    """The token-minor streaming probe on ``(H, 64, T)`` bf16 tensors, T
    a multiple of 8: ``(H, nqb)`` as :func:`dma_t_plain`, on ``library``'s
    form (the Hopper form when None). On the CPU, after the arguments are
    checked, the plain version."""
    library = _form('dma_t', library)
    if kT.device.type == 'cpu':
        return dma_t_plain(kT, vT, kend - kstart)
    H, D, T = kT.shape
    if D != 64 or T % 8:
        raise ValueError(f'dma_t: head dim {D}, T = {T}: the probe takes D '
                         '= 64 and T a multiple of 8')
    check_cuda_tensors('dma_t', (('kT', kT), ('vT', vT)), (H, D, T))
    _check_spans('dma_t', kstart, kend, -(-T // BLOCK_Q), kT.device)
    out = launch_dma_t(library, kT, vT, kstart, kend)
    dma_t.launches += 1
    return out


def launch_dma_t(library, kT, vT, kstart, kend, lib=None):
    """:func:`dma_t`'s kernel on ``library``'s form through its C entry,
    as :func:`launch_dma`."""
    H, _, T = kT.shape
    out = torch.empty((H, kstart.numel()), dtype=torch.float32,
                      device=kT.device)
    return _launch(library, FORMS[library].dma_t, f'dma_t ({library})', (
        kT.data_ptr(), vT.data_ptr(), kstart.data_ptr(), kend.data_ptr(),
        out.data_ptr(), T, H, torch.cuda.current_stream(kT.device)
        .cuda_stream), out, lib)


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


def check(run: str, got, ref):
    """A run's kernel output (a key of ``RUNS``, or a probe) against its
    plain version's, under its probe's gate: ``{'err', 'share', 'ok'}``."""
    rel, floor = GATES[RUNS[run][0]]
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
    """``{run: (kernel call, plain call)}`` on batch ``b``, for each of
    ``RUNS``."""
    s, qt, kt, kT, vT = inputs
    ks, ke = b.spans[:2]
    n = ke - ks
    plain = {'vpu': lambda: vpu_plain(s)[:, 0].expand(b.H, -1),
             'mxu': lambda: mxu_plain(qt, kt, kt).expand(b.H, -1, -1),
             'dma': lambda: dma_plain(b.q, b.k, b.v, n, b.H),
             'dma_t': lambda: dma_t_plain(kT, vT, n)}

    def kernel(probe, library, cluster):
        return {'vpu': lambda: vpu(s, ks, ke, b.H),
                'mxu': lambda: mxu(qt, kt, ks, ke, b.H),
                'dma': lambda: dma(b.q, b.k, b.v, ks, ke, b.H, library,
                                   cluster),
                'dma_t': lambda: dma_t(kT, vT, ks, ke, library)}[probe]
    return {run: (kernel(*RUNS[run]), plain[RUNS[run][0]]) for run in RUNS}


def work(probe: str, b, cluster: int = 1):
    """Bytes and operations a probe's function needs on batch ``b`` over
    H1's step count: vpu an exp and four fp32 operations (scale, max,
    subtract, add) per score element; mxu two products of 128·64·64
    multiply-adds per step; dma q, k, v read and o written once; dma_t k
    and v read once. ``tile_bytes``: the k and v tiles the streaming
    probes load, re-reads included: every tile of every block's walk
    (either form one block to a CTA), or each tile of a pair's run once
    (``cluster=2``, :func:`stream_walk`)."""
    ks, ke = b.spans[:2]
    n = steps(ks, ke) * b.H
    tiles = n if cluster == 1 else b.H * walk_tiles(stream_walk(
        (ke - ks).tolist(), -(-b.T // BLOCK_K), cluster))
    elems = float(n) * BLOCK_Q * BLOCK_K
    one = b.q.numel() * b.q.element_size()
    tile_bytes = float(tiles) * 2 * BLOCK_K * 64 * b.q.element_size()
    return {'vpu': dict(exps=elems, fp32_ops=4 * elems),
            'mxu': dict(flops=2 * 2.0 * elems * 64),
            'dma': dict(nbytes=4.0 * one),
            'dma_t': dict(nbytes=2.0 * one)}[probe], tile_bytes


def measure(b, reps: int):
    """Each run of ``RUNS`` on batch ``b``: its kernel against its plain
    version, its ms and its bound (the streaming probes' DRAM bound, and
    the tiles they load with their rate from L2 into the SMs), each
    streaming run against its cp.async form bit for bit (``SAME_AS``)
    and, for H1 on the same batch, H1's ms. Prints a line per run."""
    dev = b.device.type
    ks, ke = b.spans[:2]
    h1_ms = benchmark(flash.segment_flash_fwd, b.q, b.k, b.v, b.seg, ks, ke,
                      b.H, reps=reps, device=dev) * 1e3
    h1_bound = bound_ms(*flash_work(b))
    print(f'H1 bq={BLOCK_Q} bk={BLOCK_K} steps={steps(ks, ke) * b.H}: '
          f'{h1_ms:8.4f} ms (bound {h1_bound[0]:.4f} ms by {h1_bound[1]})',
          flush=True)
    out = {'h1': {'ms': h1_ms, 'bound_ms': h1_bound[0]}}
    got = {}
    for run, (kernel, plain) in calls(b, probe_inputs(b)).items():
        probe, library, cluster = RUNS[run]
        got[run] = kernel()
        c = check(run, got[run], plain())
        ms = benchmark(kernel, reps=reps, device=dev) * 1e3
        kw, tile_bytes = work(probe, b, cluster)
        bms, by = bound_ms(**kw)
        rate, l2 = '', None             # device rates, on the card only
        if dev == 'cuda' and probe == 'mxu':
            rate = f', {kw["flops"] / ms / 1e9:.1f} TFLOP/s of 989'
        elif dev == 'cuda' and probe.startswith('dma'):
            l2 = tile_bytes / ms / 1e9
            rate = f', tiles {tile_bytes / 1e9:.3f} GB at {l2:.2f} TB/s'
        print(f'{run:14s} {"(" + library + ")":13s} {ms:8.4f} ms (bound '
              f'{bms:.4f} ms by {by}{rate}); vs plain {c["err"]:.3e} '
              f'({c["share"]:.3f} of the gate)', flush=True)
        out[run] = {'ms': ms, 'bound_ms': bms, 'bound_by': by,
                    'library': library, 'cluster': cluster,
                    'tile_bytes': tile_bytes, 'l2_tb_per_s': l2, **kw, **c}
    for run, ref in SAME_AS.items():
        out[run]['bit_equal'] = torch.equal(got[run], got[ref])
        print(f'{run} bit-equal to {ref}: {out[run]["bit_equal"]}',
              flush=True)
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
