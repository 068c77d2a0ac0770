"""What each pass of the segment-flash forward costs: H1 with one pass
removed at a time ("H6", its ablation modes), on both of H1's forms: the
Hopper form ``csrc/flash_fwd_sm90.cu``, the one H1 runs at head dims
32-128, and the mma.sync form ``csrc/flash_fwd.cu``.

Counterpart of ``tools/flash_variants.py`` (K17: ``variant_kernel`` at
32, which ``run`` swaps into ``flash._fwd``). Each mode removes the same
pass as on the TPU; the numerics of every mode but ``baseline`` (the
form's production instantiation) are wrong on purpose: this is a cost
model. On the card the modes run at D = 64 at each form's own walk:
128-row q blocks over the span's 64-key tiles, one tile per step on the
mma.sync form, two per step (a 128-key stage; an odd span's last stage
reads the tile after the span, whose ids match no q row) on the Hopper
form (``FORMS``), so the modes that depend on where a step's keys fall
(``noalpha``, ``sumfree``, ``nomask``, ``nopv``, ``noqk``, ``nothing``)
differ between the forms.

    python -m esme_tpu_torch.tools.flash_variants [--device cpu]
        [--library flash_fwd_sm90|flash_fwd]

prints the ms of each mode of the Hopper form, then of the mma.sync form
(or of the one ``--library`` names), at ESM2-650M's attention on
bench.py's 50k batch, beside the bound of the work it keeps.
"""

from __future__ import annotations

import math
import sys
from typing import NamedTuple

import numpy as np
import torch

from ..ops import flash
from ..ops.attention import NEG_INF
from ..profiling import benchmark
from . import (FLASH_LSE_ATOL, FLASH_O_FLOOR, FLASH_O_REL, FWD_SEED,
               SUM_REL, attention_batch, bound_ms, check_cuda_tensors,
               fwd_route, pad_rows, parse_args, scaled_error, segment_pairs)
from .fwd_T_experiment import work as flash_work

LOG2E, LN2 = math.log2(math.e), math.log(2.0)

# K17's modes, in the kernels' order (enum Mode of csrc/flash_fwd.cu and
# csrc/flash_fwd_sm90.cu): products kept (Q K^T, P V) and whether the exps
# stay. A step is one 64-key tile on the mma.sync form and a 128-key stage
# (two tiles) on the Hopper form.
MODES = {
    'baseline': (2, True),
    'noalpha': (2, True),     # keep the max per step, no rescale by alpha
    'maxfree': (2, True),     # no max: p = exp(s - 20), no rescale
    'sumfree': (2, True),     # l sums each step's first key only
    'nomax': (2, True),       # no max: p = exp(s), no rescale
    'nomask': (2, True),      # no segment mask (the Hopper form: no vote)
    'noexp': (2, False),      # p = s / 2 + 0.1, no max, no rescale
    'bf16exp': (2, True),     # exp of bf16 (packed bf16 SFU form)
    'nopv': (1, True),        # no P V: o gains p's first 64 keys of a step
    'noqk': (1, True),        # no Q K^T: s = o[:, 0] + k[:, 0]
    'nothing': (0, False),    # one element of every loaded tile into o
}


# Each of H1's forms (flash.FWD_ROUTES' libraries): the 64-key tiles of
# one step, the C entry of one mode, and noqk's lse gate relative to
# max(1, |lse|) (O_GATES' comment says why the forms differ).
class Form(NamedTuple):
    stage: int
    entry: str
    noqk_lse_rel: float


FORMS = {'flash_fwd_sm90': Form(2, 'esme_segment_flash_fwd_sm90_variant',
                                2.0 ** -12),
         'flash_fwd': Form(1, 'esme_segment_flash_fwd_variant',
                           FLASH_LSE_ATOL)}


def ex2_bf16(x):
    """``2^x`` for ``x <= 0`` as the kernel's ``bf16exp`` takes it: ``x``
    rounded to bf16, then the SFU's ``ex2.approx.ftz.bf16x2``, whose result
    is 2^x rounded to fp32 and then truncated to bf16, 1 for ``x >
    -2^-23``, and 0 where it would be subnormal (equal to the instruction
    for every bf16 ``x <= 0``: ``tests/test_torch_kernels_cuda.py``).
    fp32, holding bf16 values."""
    x = x.to(torch.bfloat16).float()
    p = torch.exp2(x.double()).float()
    p = (p.view(torch.int32) & ~0xffff).view(torch.float32)
    p = torch.where(x > -2.0 ** -23, 1.0, p)
    return torch.where(x < -126.0, 0.0, p)


def variant_fwd_plain(mode: str, q2, k2, v2, seg_ids, kstart, kend,
                      num_heads: int, scale=None, library: str | None = None,
                      block_q: int = flash.BLOCK_Q,
                      block_k: int = flash.BLOCK_K, head_block: int = 1,
                      exp2_bf16: bool = True):
    """Plain PyTorch version of H6: ``variant_kernel``'s steps, step by
    step.

    Every ``block_q`` block walks its span ``[kstart, kend)`` of
    ``block_k`` tiles, ``FORMS[library].stage`` tiles per step (one when
    ``library`` is None: the TPU tool's walk; a step past the span's
    end reads the tiles after it; rows past T are zeros whose ids match
    nothing), all blocks in step (a block whose span has ended keeps its
    state, as the TPU's ``pl.when`` does), with the running m, l and
    accumulator in fp32, per mode as ``tools/flash_variants.py:45-109``
    computes them. The modes depend on where the steps fall, so the walk
    is a parameter: 256x256 tiles one at a time reproduce the TPU tool,
    ``library='flash_fwd'`` (128x64, one at a time) the mma.sync form,
    ``library='flash_fwd_sm90'`` (128x64, two at a time) the Hopper form's
    128-key stages. ``head_block`` heads
    share the first head's elements in ``nothing`` (the TPU's head groups;
    a kernel's block holds one head). ``bf16exp`` takes p as the kernels
    do with ``exp2_bf16`` (:func:`ex2_bf16` of the base-2 exponent), or
    as the TPU tool does without (the base-e exponent rounded to bf16, its
    exp in bf16); in the kernels' form it runs in base 2 as they do
    (scores times fp32 ``scale·log2 e``, m in base 2, lse = m·ln 2 + log
    l), so that the exponents round to bf16 from the same fp32 values
    wherever the products agree. Returns ``o (T, H·D)`` in q's dtype and
    ``lse (H, T)`` fp32.
    """
    if mode not in MODES:
        raise ValueError(f'unknown mode {mode!r}; one of {list(MODES)}')
    T, HD = q2.shape
    H = num_heads
    D = HD // H
    stage = 1 if library is None else FORMS[_library(library, D)].stage
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    base2 = mode == 'bf16exp' and exp2_bf16
    if base2:
        scale = float(np.float32(scale) * np.float32(LOG2E))
    dt = v2.dtype
    bq, bk = block_q, block_k
    nqb, nkb = -(-T // bq), -(-T // bk)
    nk = nkb + stage - 1          # with the tiles a last step reads past T
    q = pad_rows(q2, nqb * bq).view(nqb, bq, H, D).float()
    k = pad_rows(k2, nk * bk).view(nk, bk, H, D).float()
    v = pad_rows(v2, nk * bk).view(nk, bk, H, D).float()
    segq = pad_rows(seg_ids, nqb * bq, -2).view(nqb, bq)
    segk = pad_rows(seg_ids, nk * bk, -1).view(nk, bk)
    first = (torch.arange(H, device=q2.device) // head_block) * head_block
    kstart = kstart.long()
    steps = ((kend.long() - kstart).clamp_min(0) + stage - 1) // stage
    tiles = torch.arange(stage, device=q2.device)
    m = torch.full((nqb, H, bq), NEG_INF, device=q2.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((nqb, H, bq, D), device=q2.device)
    for jj in range(int(steps.max().item()) if nqb else 0):
        act = (jj < steps)[:, None, None]
        j = torch.clamp(kstart[:, None] + stage * jj + tiles, max=nk - 1)
        kt = k[j].view(nqb, stage * bk, H, D)
        vt = v[j].view(nqb, stage * bk, H, D)
        sk = segk[j].view(nqb, stage * bk)
        m_new, l_new = m, l
        if mode == 'nothing':
            t = (((q[:, 0, first, 0] + kt[:, 0, first, 0])
                  + vt[:, 0, first, 0]) + segq[:, :1].float()) \
                + sk[:, :1].float()
            acc = torch.where(act[..., None], acc + t[:, :, None, None], acc)
            continue
        if mode == 'noqk':
            s = acc[..., :1] + kt[:, :, :, 0].transpose(1, 2)[:, :, None, :]
        else:
            s = torch.einsum('nqhd,nkhd->nhqk', q, kt) * scale
        if mode != 'nomask':
            mask = segq[:, None, :, None] == sk[:, None, None, :]
            s = torch.where(mask, s, NEG_INF)
        alpha = 1.0                  # or (nqb, H, bq)
        if mode == 'noexp':
            p = s * 0.5 + 0.1
        elif mode == 'maxfree':
            p = torch.exp(s - 20.0)
        elif mode == 'nomax':
            p = torch.exp(s)
        else:
            m_new = torch.maximum(m, s.amax(-1))
            if base2:
                alpha = torch.exp2(m - m_new)
            elif mode != 'noalpha':
                alpha = torch.exp(m - m_new)
            if base2:
                p = ex2_bf16(s - m_new[..., None])
            elif mode == 'bf16exp':
                p = torch.exp((s - m_new[..., None]).to(torch.bfloat16)) \
                    .float()
            else:
                p = torch.exp(s - m_new[..., None])
        l_new = l * alpha + (p[..., 0] if mode == 'sumfree' else p.sum(-1))
        if mode == 'nopv':
            pv = p[..., :64] * 1.0
        else:
            pv = torch.einsum('nhqk,nkhd->nhqd', p.to(dt).float(), vt)
        a = alpha[..., None] if isinstance(alpha, torch.Tensor) else alpha
        acc = torch.where(act[..., None], acc * a + pv, acc)
        m = torch.where(act, m_new, m)
        l = torch.where(act, l_new, l)
    l_safe = torch.where(l == 0, 1.0, l)
    o = (acc / l_safe[..., None]).transpose(1, 2).reshape(nqb * bq, HD)
    lse = (m * LN2 if base2 else m) + torch.log(l_safe)
    lse = lse.transpose(0, 1).reshape(H, nqb * bq)
    return o[:T].to(q2.dtype), lse[:, :T].contiguous()


def _library(library, head_dim: int) -> str:
    """``library``, a key of ``FORMS``, or the tools' form of H1 at
    ``head_dim`` (:func:`esme_tpu_torch.tools.fwd_route`) when None."""
    library = fwd_route(head_dim) if library is None else library
    if library not in FORMS:
        raise ValueError(f'unknown library {library!r}; one of '
                         f'{list(FORMS)}')
    return library


def variant_fwd(mode: str, q2, k2, v2, seg_ids, kstart, kend,
                num_heads: int, scale=None, library: str | None = None):
    """H1 in ablation mode ``mode`` (kernel H6) on ``library``'s form (a
    key of ``FORMS``; the tools' form at D when None, the Hopper
    form at 64): the arguments and outputs of
    :func:`esme_tpu_torch.ops.flash.segment_flash_fwd`, D = 64 only.
    ``baseline`` launches the form's own production instantiation. On the
    CPU it runs the plain version of that form's walk."""
    if mode not in MODES:
        raise ValueError(f'unknown mode {mode!r}; one of {list(MODES)}')
    library = _library(library, q2.shape[1] // num_heads)
    if q2.device.type == 'cpu':
        return variant_fwd_plain(mode, q2, k2, v2, seg_ids, kstart, kend,
                                 num_heads, scale, library)
    T, HD = q2.shape
    H = num_heads
    D = HD // H
    what = f'variant_fwd({mode!r}, {library!r})'
    if D != 64 or HD != H * D:
        raise ValueError(f'{what}: head dim {HD / H:g}: the ablation modes '
                         'are built for D = 64 only')
    check_cuda_tensors(what, (('q', q2), ('k', k2), ('v', v2)), (T, HD))
    nqb = -(-T // flash.BLOCK_Q)
    flash._check_index_inputs(what, q2.device, (
        ('seg_ids', seg_ids, T, torch.int32),
        ('kstart', kstart, nqb, torch.int32),
        ('kend', kend, nqb, torch.int32)))
    from .. import _build
    lib = _build.library(library)
    o = torch.empty_like(q2)
    lse = torch.empty((H, T), dtype=torch.float32, device=q2.device)
    rc = getattr(lib, FORMS[library].entry)(
        list(MODES).index(mode), q2.data_ptr(), k2.data_ptr(), v2.data_ptr(),
        seg_ids.data_ptr(), kstart.data_ptr(), kend.data_ptr(), o.data_ptr(),
        lse.data_ptr(), T, H, D, 1.0 / math.sqrt(D) if scale is None
        else scale, torch.cuda.current_stream(q2.device).cuda_stream)
    _build.check(rc, lib, flash.FWD_ROUTES[library][1], what)
    variant_fwd.launches += 1
    return o, lse


variant_fwd.launches = 0

# How a mode's kernel output is held to its plain version on the card:
# o under H1's gate (2^-6·max(|o|, 1/4)) and lse within 1e-4, except:
# (both forms, each against the plain version of its own walk)
# - sumfree: l holds only each step's first p, so o = acc / l magnifies
#   the bf16 rounding of P (one flip moves acc by 2^-8·p·|v|) by Σp / l,
#   as it magnifies o itself: o within 2^-6·max(|o|, rms o) (measured on
#   an H100 80GB HBM3 at 700 W, chip_smoke.py's 8k check batch: 4.6x H1's
#   gate, 0.5 at |o| = 103, max|o| 596);
# - bf16exp: the plain version takes p as the kernel does (ex2_bf16), but
#   each exponent rounds to bf16 from the fp32 score, and where the
#   kernel's tensor-core sums and the plain version's differ in the last
#   bits, a score near a rounding midpoint rounds the other way. One such
#   flip moves one p by at most 2^-7/e (max of p·|x|·ln 2·2^-7 over p =
#   2^x) and so lse by at most that, since l >= 1 (the row's maximum
#   contributes 1), and such flips are rare. So lse
#   within 2^-8 on every row, and within 1e-5 on the mean over the rows
#   (H1's rows agree to ~1e-7); an exp off by 0.1% everywhere moves the
#   mean by 1e-3 and fails. o keeps H1's gate;
# - noqk: m carries o's first column (~10-100): lse within
#   FORMS[...].noqk_lse_rel·max(1, |lse|), 1e-4 on the mma.sync form; on the Hopper form within 2^-12·max(1,
#   |lse|), since its scores take o's column after whole 128-key stages
#   whose bf16 flips of p move it further (measured on an NVIDIA H100 80GB
#   HBM3 at 700 W, chip_smoke.py's 8k check batch: 1.004e-4·max(1, |lse|),
#   0.41 of this gate);
# - noexp and nothing sum what they touch (o reaches ~1e31 inside noexp's
#   sums): o within SUM_REL·max(|o|, rms o), lse (NaN in noexp, -1e30 in
#   nothing) equal.
O_GATES = {'sumfree': (FLASH_O_REL, None),
           'noexp': (SUM_REL, None), 'nothing': (SUM_REL, None)}
BF16EXP_LSE_MEAN, BF16EXP_LSE_MAX = 1e-5, 2.0 ** -8


def check(mode: str, got, ref, library: str = 'flash_fwd_sm90'):
    """Mode ``mode``'s kernel outputs ``(o, lse)`` on ``library``'s form
    against its plain version's: ``{'o_err', 'o_share', 'lse_err',
    'lse_share', 'ok'}`` (and ``'lse_mean_err'`` in ``bf16exp``), each
    share the largest fraction of its gate (<= 1 passes)."""
    (o, lse), (o_p, lse_p) = got, ref
    out = {}
    rel, floor = O_GATES.get(mode, (FLASH_O_REL, FLASH_O_FLOOR))
    e_o, o_share = scaled_error(o, o_p, rel, floor)
    if mode in ('noexp', 'nothing'):
        same = torch.equal(lse.isnan(), lse_p.isnan()) and torch.equal(
            lse.nan_to_num(0.0), lse_p.nan_to_num(0.0))
        e_l, l_share = (0.0, 0.0) if same else (float('inf'), float('inf'))
    elif mode == 'noqk':
        e_l, l_share = scaled_error(lse, lse_p,
                                    FORMS[library].noqk_lse_rel, 1.0)
    elif mode == 'bf16exp':
        d = (lse - lse_p).abs().nan_to_num(float('inf'))
        e_l, out['lse_mean_err'] = d.max().item(), d.double().mean().item()
        l_share = max(out['lse_mean_err'] / BF16EXP_LSE_MEAN,
                      e_l / BF16EXP_LSE_MAX)
    else:
        e_l = (lse - lse_p).abs().max().nan_to_num(float('inf')).item()
        l_share = e_l / FLASH_LSE_ATOL
    return {'o_err': e_o, 'o_share': o_share, 'lse_err': e_l, **out,
            'lse_share': l_share, 'ok': o_share <= 1.0 and l_share <= 1.0}


def walked_pairs(b, library: str) -> float:
    """The (q, k) pairs per head of the steps ``library``'s form walks on
    batch ``b``: each 128-row q block's span in steps of the form's
    64-key tiles (``FORMS``)."""
    stage = FORMS[library].stage
    ks, ke = b.spans[:2]
    steps = ((ke - ks).clamp_min(0) + stage - 1) // stage
    return float(steps.sum().item()) * stage * flash.BLOCK_K \
        * flash.BLOCK_Q


def work(mode: str, b, library: str | None = None):
    """Bytes the mode must move (H1's) and the operations it keeps: H1's
    products and exps (``fwd_T_experiment.work``), less those it drops;
    ``nomask`` computes every pair of the steps ``library``'s form
    walks."""
    library = _library(library, b.D)
    products, exps = MODES[mode]
    nbytes, flops, n_exps = flash_work(b)
    if mode == 'nomask':
        scale = walked_pairs(b, library) / segment_pairs(b.seg)
        flops, n_exps = flops * scale, n_exps * scale
    return nbytes, flops * products / 2, n_exps if exps else 0.0


def run(mode: str, b, reps: int, library: str | None = None):
    """Time one mode of ``library``'s form on batch ``b``: its ms, bound
    and the work it keeps; prints its line."""
    library = _library(library, b.D)
    ks, ke = b.spans[:2]
    ms = benchmark(variant_fwd, mode, b.q, b.k, b.v, b.seg, ks, ke, b.H,
                   None, library, reps=reps, device=b.device.type) * 1e3
    nbytes, flops, exps = work(mode, b, library)
    bms, by = bound_ms(nbytes, flops, exps)
    print(f'{library:14s} {mode:10s} {ms:8.4f} ms (bound {bms:.4f} ms by '
          f'{by})', flush=True)
    return {'ms': ms, 'bound_ms': bms, 'bound_by': by, 'bytes': nbytes,
            'flops': flops, 'exps': exps}


def main(argv=None):
    args = parse_args(argv, __doc__.splitlines()[0],
                      libraries=tuple(FORMS))
    b = attention_batch(args.budget, FWD_SEED, device=args.device,
                        dtype=args.dtype)
    print(f'shape: H={b.H} D={b.D} T={b.T} {args.dtype} on {args.device}',
          flush=True)
    hopper = fwd_route(b.D)
    libraries = (args.library,) if args.library else \
        (hopper, *(n for n in FORMS if n != hopper))
    return {library: {mode: run(mode, b, args.reps, library)
                      for mode in MODES} for library in libraries}


if __name__ == '__main__':
    main(sys.argv[1:])
