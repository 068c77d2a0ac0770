#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port ``esme_tpu_torch`` on one CUDA card.

    python3 chip_smoke.py [--profile DIR]

Phases, in order; any failure exits non-zero before a result is printed:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``esme_tpu_torch/csrc`` with ``nvcc`` (timed);
   H1's and H2's mma.sync mode-0 instantiations (``flash_fwd.cu``,
   ``flash_bwd.cu``) must keep the registers, stack and spills ``ptxas``
   gave them before the ablation modes, H1's and H2's Hopper production
   kernels (``flash_fwd_sm90.cu``, ``flash_bwd_sm90.cu`` at D = 32, 64,
   128) the ones they had before the token-minor layout and the Hopper
   ablation modes (``SM90_PRODUCTION``), H5's Hopper form at D = 64 and
   every H6 mode of H1's Hopper form no stack frame and no spills (but
   ``noqk``'s pinned ``H6_SPILLS``; no ``wgmma`` serialisation warning
   names an H6 mode), every H7 mode of
   both Hopper passes must build (every instantiation's ``ptxas`` line
   and any ``wgmma`` serialisation warning is logged), and H8's Hopper
   kernels (``probes_sm90.cu``: dma alone and in pairs, dma_t) must have
   no stack frame and no spills;
3. hold each kernel against its plain PyTorch version on the card, on a
   packed 8k-token batch: segment-flash forward (H1) and backward (H2),
   each on its route (the Hopper form at D = 32, 64, 128, the mma.sync
   form at 16, 24), at head dims 16, 24, 32, 64 and 128, H1 bit-equal
   across two calls; both also on 8k tokens of one segment (every tile
   unmasked), of 1-70-token segments and of interleaved ids (every tile
   masked), H1 also at a ragged T (T % 64 != 0); RoPE (H3) forward and
   inverse,
   the head relayout (H4) in every layout pair and rotation the ops use
   at each head dim (bit-equal) at T % 8 == 0 and != 0, on the kernel
   its rule picks (``relayout_route``, shown by its counter: rows, vec or
   tile) and at T % 8 == 0 on the tile kernel too, each beside its gate;
4. the inference path: ESM2-650M (33 layers, width 1280, 20 heads,
   bf16, weights from seed 0) ``predict_log_prob(tokens,
   pad_args=(cu_lens, max_len))`` on ``bench.py``'s packed batch (seed
   0, 100-1000 aa, 50,000-token budget), with every launch counter set
   to 0 just before and read just after; then, on a smaller batch at
   full depth, the port with kernels against the port with plain
   versions and against its einsum attention path; its time (CUDA
   events after warm-up, peak memory);
5. the training path: ``MaskedPLM(model, learning_rate=1e-4)
   .training_step(batch)`` on ``bench.py``'s masked-LM batch recipe
   (lengths and tokens seed 2, masking seed 1, no loss on the tail), at
   a 10,000-token budget without checkpointing (one warm-up step, 5
   timed) and at 50,000 with ``checkpointing=True, remat='full'`` (one
   warm-up, 3 timed), with the launch counters read around the warm-up
   step; losses finite and falling; then, at full depth on a 4k batch,
   every leaf's gradient with kernels against with plain versions, and
   with ``remat='full'`` against without; then a two-step ``fit`` over a
   ``MaskedFastaTokenDataset`` on a FASTA file written from seed 0;
6. the attention op API at the main shape (T = 50,176, H = 20, D = 64,
   bf16), each op with the launch counters set to 0 just before and
   read just after, against the same op through the plain versions:
   ``flash_segment_attention`` ('thd' and 'htd') and ``flash_tm``,
   forward and backward, under H1's and H2's gates; ``split_heads_rotary``
   -> ``merge_heads``, values and gradients, bit-equal (and the merged q
   and k bit-equal to H3's); ``fwd_v2`` against ``segment_flash_fwd``;
   JAX's ``ESME_FLASH_IMPL=v2`` steps, ``_split_call_t`` -> ``fwd_v2``
   -> ``_merge_call``, against ``fused_rotary_flash``'s forward (o under
   H1's gate, lse within 1e-4). A plain run in which a kernel's counter
   moves fails (phases 4 and 5 too);
7. times: each kernel at its path's shapes beside its bound, its plain
   version and library calls timed as yardsticks only (the port calls
   none): for H1 ``scaled_dot_product_attention`` with a dense
   block-diagonal mask (``library_ms``, T^2 work) and PyTorch's varlen
   flash-attention forward over the same segments
   (``library_varlen_ms``; its ratio is logged, not gated) and its
   mma.sync form through its C entry (H1 on its route, the Hopper form at
   D = 64, must be faster); for H2 PyTorch's varlen flash-attention
   backward (``library_ms``), each of its passes alone and its mma.sync
   form; H1's Hopper form and each of H2's passes on T tokens of one
   segment against the same batch with one token of each 64-token tile
   given its own id (every tile unmasked, then every tile masked: each
   must be faster on the first, where the mask is skipped); the counts of
   (16-row, 64-row tile) units that lie in one segment, worked out from
   the segment ids by H2's rule (``mask_units``: the train batch's, and
   the inference batch's over H1's spans), are logged with the
   measurements as properties of the batches; for H4,
   each of its modes at the main shape on its route, with one
   ``permute(...).contiguous()`` call as the yardstick of a move without
   rotation, and each move with an hdt side (the vec kernel at this T)
   also on the tile kernel, held bit-equal to the plain version there
   too and timed in turn with the vec kernel (fastest of 8 calls each,
   on the card alone): the vec kernel faster where the move rotates, and
   within 3% of the tile kernel where it does not. ``--profile DIR`` also writes
   ``torch.profiler`` tables of one forward and one train step there;
8. the probe tools' kernels (``esme_tpu_torch/tools``, none on the model
   path, where their counters must stay 0): on the 8k check batch, H5 on
   its route (``fwd_T_route``: H1's Hopper kernel on token-minor operands
   at head dims 32-128, the mma.sync form with transposed scores at 16, 24
   and at a T that is not a multiple of 8, the route counter showing which
   ran) under H1's gates, every ablation mode of both forms of H1 (H6, 11
   modes each) and of
   both passes of both forms of H2 (H7, 8 modes each; the Hopper form's
   dk/dv pass over the union spans it walks) and the four ceiling probes
   (H8; the streaming ones, dma and dma_t, in both forms, the Hopper form
   ``probes_sm90.cu`` and the cp.async form ``probes.cu``, and dma also in
   2-CTA pairs), each against its plain version under the gate its tool's
   ``check`` states (H6 on both forms against the plain version of the
   form's walk, the Hopper form's ``baseline`` bit-equal to H1; H8's
   Hopper forms and pairs bit-equal to the cp.async form); then each
   tool's own run at the main shapes (H5 beside
   H1, every mode and probe timed beside the bound of the work it keeps,
   H6 and H8 on the inference batch, H7 on the 50k train batch), with the
   launch counters set to 0 just before and read just after; H5's Hopper
   form bit-equal to H1's (on the 8k batch too) and faster than its
   mma.sync form (fastest of 8 calls each, timed on the card alone), which
   is held under H1's gates against the plain version and H1 there, beside
   the varlen library and the bound; every H6 mode of both forms timed,
   the Hopper form's ``baseline`` bit-equal to H1 there, the mma.sync
   form's to H1's mma.sync form, and H1's Hopper form under H1's gates
   against the latter;
   H7 ``real`` of the Hopper form bit-equal to H2 and within 3% of H2's
   own passes timed in turn with it (fastest of 8 calls each, timed on the
   card alone; a gate on ``REF_CARD``), of the mma.sync form bit-equal to
   that form and under H2's gate against the Hopper form; the mma.sync forms' times (H1's and
   H6 ``baseline``, H2's and H7 ``real``) within 3% of their times before
   the ablation modes were added, on the card those were taken on
   (``REF_CARD``; logged on any other); H2's Hopper form faster than its
   mma.sync form, its time logged beside it and the library's; H8's
   Hopper forms and pairs bit-equal to the cp.async form there too, and
   each Hopper form faster than its cp.async form (fastest of 8 calls each,
   on the card alone; the pairs are timed beside them, not gated).

The last three lines are the kernels' JSON, the measurements' JSON and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

# Published H100 SXM peaks (dense): HBM rate and bf16 tensor-core rate,
# and the fp32 rate outside the tensor cores for elementwise work.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12

# Gates of phase 3, kernel vs plain version on the same bf16 inputs.
# o: each output is rounded to bf16, and the kernel rounds p to bf16
# against the running row max where the plain version uses the final
# one, so the two differ by up to one ulp of o, plus a small absolute
# part from p. The gate follows o's own scale: |o - o_plain| <= 2^-6 *
# max(|o_plain|, 1/4), two to four bf16 ulps of |o| for |o| >= 1/4 and
# 3.9e-3 below it (a one-ulp difference at the edge of a binade, such
# as 0.49609375 against 0.5, is a whole ulp of the larger value). A
# wrong v row or a misplaced store moves o by about its own size
# (|o| ~ 0.05-0.5 here).
# lse: both keep m, l and lse in fp32 and differ in summation order.
FLASH_O_REL, FLASH_O_FLOOR = 2.0 ** -6, 0.25
FLASH_LSE_ATOL = 1e-4
# H2: p and ds are rounded to bf16 before their products. Where the
# kernel's fp32 ds (mma.sync sums, exp2) and the plain version's
# (cuBLAS sums, exp) differ in their last fp32 bits, the two roundings
# can land on neighbouring bf16 values, and one such flip of a large ds
# term moves one gradient element by up to ~2^-8·|ds|·|k|: measured up
# to 0.019·rms(g) at 8k tokens, where a float64 sum with the same
# roundings sided with the kernel as often as with the plain version.
# Each gradient is then rounded to bf16 once. The gate follows each
# tensor's own scale: |g - g_plain| <= 2^-4 * max(|g_plain|,
# rms(g_plain)). A wrong row, a missed tile or a misplaced store moves
# g by about its own size.
FLASH_G_REL = 2.0 ** -4
# Phase 4: the model with kernels vs with plain versions (and vs its
# einsum attention path) at full depth, on the centred per-token
# log-probability vectors, real tokens only: bf16 rounding differences
# in attention carried through 33 layers.
MODEL_MIN_COS = 0.99
MODEL_MAX_ABS = 0.25
LOGSUMEXP_ATOL = 1e-4
# Phase 5: every leaf's gradient of one masked-LM step at full depth with
# kernels vs with plain versions: bf16 rounding differences in attention
# (H1 and H2 within two to four ulps of their plain versions) carried
# through 33 layers forward and back. Per leaf: cosine and the largest
# difference relative to the leaf's largest gradient (measured on the
# H100: cosine 0.998989 or more, 0.0213 · max|g| or less).
GRAD_MIN_COS = 0.99
GRAD_MAX_REL = 0.1
# With remat='full' against without: the same kernels and products
# recomputed, deterministic (no atomics anywhere), so bit-equal is
# expected; the gate allows one bf16 rounding of the leaf's largest
# value and the loss must be equal. (The cosine of two equal vectors
# computed in fp32 can fall a few 1e-7 below 1.)
REMAT_MIN_COS, REMAT_MAX_REL = 0.9999, 2.0 ** -8

H1_NAME, H2_NAME, H3_NAME, H4_NAME = (
    'segment_flash_fwd', 'segment_flash_bwd', 'rotary_qk', 'relayout_heads')
# the probe tools' kernels (esme_tpu_torch/tools): H5, H6 (H1's ablation
# modes), H7 (H2's) and the four H8 probes; none is on the model path
H5_NAME, H6_NAME, H7_NAME = 'fwd_T', 'variant_fwd', 'bwd_variant'
H8_NAMES = ('probe_vpu', 'probe_mxu', 'probe_dma', 'probe_dma_t')
# The times of H1's and H2's mma.sync forms at the main shapes before the
# ablation modes were added (PERF.md's kernel table), on REF_CARD. The
# mode-0 instantiations are held to within 3% of them there, on the better
# of the script's two timings of each (phase 7's and phase 8's); another
# card or power limit moves them, and there they are logged only.
H1_REF_MS, H2_REF_MS = 1.0984, 4.1524
REF_CARD = 'NVIDIA H100 80GB HBM3, 700.00 W'
# ptxas' report of the same instantiations before the modes were added
# (registers by padded head dim; no stack frame and no spills at any):
# the build must give them unchanged.
MODE0_REGISTERS = {
    ('flash_fwd', 'flash_fwd_kernel'): {16: 135, 32: 185, 64: 237, 128: 191},
    ('flash_bwd', 'flash_bwd_dq_kernel'): {16: 88, 32: 123, 64: 158,
                                           128: 182},
    ('flash_bwd', 'flash_bwd_dkv_kernel'): {16: 96, 32: 160, 64: 170,
                                            128: 255},
}

# H4's moves as the ops make them: (sources, destinations, rotations) of
# the tensors of one launch; 'R' is RoPE, 'RT' its transpose, 'N' none.
# The first is the kernel's headline mode (K11, the three-tensor split).
RELAYOUTS = {
    'split (K11)': ('thd', 'htd', 'R R N'),
    'split, R^T (K11)': ('thd', 'htd', 'RT RT N'),
    'merge (K12; K13 back)': ('htd', 'thd', 'N'),
    'merge, R (K12)': ('htd', 'thd', 'R'),
    'merge, R^T (split back)': ('htd', 'thd', 'RT RT N'),
    'split one (K13)': ('thd', 'htd', 'N'),
    'split_t (K7)': ('thd', ('htd', 'hdt', 'hdt'), 'R R N'),
    'split_t q_minor (K8, K9)': ('thd', 'hdt', 'R R N'),
    'merge_t, R^T (K10)': ('hdt', 'thd', 'RT'),
    'to thd (fwd_v2)': (('htd', 'hdt', 'hdt'), 'thd', 'N N N'),
    'to hdt (flash_tm)': ('thd', 'hdt', 'N'),
    'from hdt (flash_tm)': ('hdt', 'thd', 'N'),
}

# The tile kernel's times of H4's moves without rotation that have an hdt
# side, at the main shape on REF_CARD before the vec kernel took them
# (PERF.md's H4 modes): the vec kernel's ratio to each is logged.
H4_TILE_REF_MS = {'to thd (fwd_v2)': 0.2812, 'to hdt (flash_tm)': 0.0979,
                  'from hdt (flash_tm)': 0.0978}

# Phase 3's extra H2 batches (``layout_seg``)
BWD_LAYOUTS = ('one', 'short', 'interleaved')

# Sizes: ESM2-650M at full width and depth, bench.py's 50k-token batch,
# the 8k-token batch of the kernel checks (where the plain version's
# scores fit), the 4k-token batch of the full-depth comparisons, the
# train cells' budgets (bench.py's nockpt@10k and ckpt@50k) and the
# fit's budget.
MODEL = dict(num_layers=33, embed_dim=1280, attention_heads=20)
BUDGET = 50_000
CHECK_BUDGET = 8192
SMALL_BUDGET = 4096
# (key, budget, checkpointing, timed steps, loss must fall): the 50k
# cell starts from the 10k cell's weights with a fresh Adam, whose first
# updates (lr·sign(g) on every leaf) raise the loss before it falls, so
# only its losses' finiteness is checked there
TRAIN_CELLS = (('nockpt', 10_000, False, 5, True),
               ('ckpt', 50_000, True, 3, False))
FIT_BUDGET = 8192
DEVICE = 'cuda'
FWD_REPS = 5           # timed forwards of the main path, after one warm-up
# fastest_calls' spin ahead of each timed call: ~10 ms at the H100's
# 1.98 GHz boost clock, longer at a lower clock
SPIN_CYCLES = 20_000_000
# Published H100 SXM dense bf16 peak for MFU (bench.py's formula)
MFU_PEAK = BF16_FLOP_PER_S


def fail(msg: str):
    print(f'chip_smoke: FAIL: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(f'[chip_smoke] {msg}', flush=True)


def packed_batch(budget: int, seed: int):
    """``bench.py``'s packed batch: sequences of 100-1000 aa (+2) until
    the budget is within 1024 of full, random residue tokens, a padding
    tail. Returns ``(tokens, cu_lens, max_len)`` as numpy."""
    from esme_tpu_torch.alphabet import Alphabet
    rng = np.random.default_rng(seed)
    lens, total = [], 0
    while total < budget - 1024:
        n = int(rng.integers(100, 1000))
        lens.append(n + 2)
        total += n + 2
    cu = np.cumsum([0, *lens]).astype(np.int32)
    tokens = np.full(budget, Alphabet.padding_idx, np.int32)
    tokens[:cu[-1]] = rng.integers(4, 24, cu[-1])
    return tokens, cu, int(max(lens))


def flat_meta(cu, budget: int, dev):
    """Segment ids, positions and H1 spans through the functions
    ``_ESMBase._run`` and ``forward_flat`` make them with."""
    from esme_tpu_torch.models.esm import pad_flat_meta, packed_meta
    return pad_flat_meta(*packed_meta(torch.as_tensor(cu, device=dev),
                                      budget))


def randn(shape, gen, dev, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def flash_inputs(cu, budget, H, D, dev, seed):
    seg, pos, spans = flat_meta(cu, budget, dev)
    T = seg.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v = (randn((T, H * D), gen, dev) for _ in range(3))
    return q, k, v, seg, pos, spans


def o_errors(o, o_p):
    """max|o - o_plain| and its largest share of the o gate (<= 1
    passes)."""
    d = (o.float() - o_p.float()).abs()
    gate = FLASH_O_REL * o_p.float().abs().clamp_min(FLASH_O_FLOOR)
    return d.max().item(), (d / gate).max().item()


def flash_errors(o, lse, o_p, lse_p):
    """max|o - o_plain|, its largest share of the o gate (<= 1 passes)
    and max|lse - lse_plain|."""
    return (*o_errors(o, o_p), (lse - lse_p).abs().max().item())


def check_flash(cu, budget, H, D, dev, seed=0, what=''):
    """H1 vs its plain version on a packed batch; returns (o err, lse
    err)."""
    q, k, v, seg, _, spans = flash_inputs(cu, budget, H, D, dev, seed)
    return check_flash_args((q, k, v, seg, *spans[:2], H), what)


def check_flash_args(args, what=''):
    """H1 (on its route) vs its plain version on ``segment_flash_fwd``'s
    arguments, under H1's gates, and bit-equal across two calls; returns
    (o err, lse err)."""
    from esme_tpu_torch.ops import flash
    q, *_, H = args
    D = q.shape[1] // H
    o, lse = flash.segment_flash_fwd(*args)
    again = flash.segment_flash_fwd(*args)
    o_p, lse_p = flash.segment_flash_fwd_plain(*args)
    torch.cuda.synchronize()
    e_o, share, e_l = flash_errors(o, lse, o_p, lse_p)
    same = torch.equal(o, again[0]) and torch.equal(lse, again[1])
    ok = share <= 1.0 and e_l <= FLASH_LSE_ATOL and same \
        and bool(torch.isfinite(o.float()).all())
    log(f'H1{what} T={q.shape[0]} H={H} D={D} ({flash.fwd_route(D)}): '
        f'max|o-plain| {e_o:.3e}, {share:.3f} of the o gate '
        f'(2^-6*max(|o|, {FLASH_O_FLOOR})), max|lse-plain| {e_l:.3e} (gate '
        f'{FLASH_LSE_ATOL}), bit-equal across two calls {same} '
        f'{"ok" if ok else "FAIL"}')
    if not ok:
        fail(f'H1 disagrees with its plain version (or itself) at '
             f'T={q.shape[0]} D={D}{what}')
    return e_o, e_l


def seg_flash_args(seg, H, D, dev, seed):
    """H1's arguments over given segment ids: random q, k, v and the
    spans."""
    from esme_tpu_torch.ops import flash
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v = (randn((seg.shape[0], H * D), gen, dev) for _ in range(3))
    return (q, k, v, seg, *flash.flash_spans(seg)[:2], H)


def mma_sync_fwd(args):
    """H1's mma.sync form (``csrc/flash_fwd.cu``), the mode-0 kernel that
    H6 ``baseline`` ablates, through its C entry (no counter moves)."""
    from esme_tpu_torch.ops import flash
    return flash.launch_fwd('flash_fwd', *args)


def bwd_inputs(cu, budget, H, D, dev, seed):
    """H2's inputs: random q, k, v and do, H1's o and lse, delta."""
    from esme_tpu_torch.ops import flash
    q, k, v, seg, _, spans = flash_inputs(cu, budget, H, D, dev, seed)
    o, lse = flash.segment_flash_fwd(q, k, v, seg, *spans[:2], H)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    do = randn(q.shape, gen, dev)
    return q, k, v, do, lse, flash.attention_delta(o, do, H), seg, spans


def grad_errors(got, ref):
    """Per tensor: max|g - g_plain|, its largest share of the H2 gate
    (<= 1 passes); and whether every g is finite."""
    errs, shares, finite = [], [], True
    for a, b in zip(got, ref):
        a, b = a.float(), b.float()
        d = (a - b).abs()
        gate = FLASH_G_REL * b.abs().clamp_min(b.square().mean().sqrt())
        errs.append(d.max().item())
        shares.append((d / gate).max().item())
        finite = finite and bool(torch.isfinite(a).all())
    return errs, shares, finite


def layout_seg(layout, T, dev, seed):
    """Segment ids of phase 3's extra H2 batches: ``one`` segment over all
    T (every tile unmasked), ``short`` segments of 1-70 tokens (every
    tile masked) and ``interleaved`` ids 0-2 drawn per token (not
    monotonic: every tile masked, every span the whole batch)."""
    rng = np.random.default_rng(seed)
    if layout == 'one':
        ids = np.zeros(T, np.int32)
    elif layout == 'short':
        ids = np.repeat(np.arange(T), rng.integers(1, 71, T))[:T]
    else:
        ids = rng.integers(0, 3, T)
    return torch.from_numpy(ids.astype(np.int32)).to(dev)


def seg_bwd_inputs(seg, H, D, dev, seed):
    """H2's inputs over given segment ids: random q, k, v and do, H1's o
    and lse, delta, the spans."""
    from esme_tpu_torch.ops import flash
    T = seg.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v, do = (randn((T, H * D), gen, dev) for _ in range(4))
    spans = flash.flash_spans(seg)
    o, lse = flash.segment_flash_fwd(q, k, v, seg, *spans[:2], H)
    return q, k, v, do, lse, flash.attention_delta(o, do, H), seg, spans


def check_flash_bwd(cu, budget, H, D, dev, seed=0, what=''):
    """H2 vs its plain version on a packed batch; returns (max |error|,
    largest gate share) over dq, dk and dv."""
    return check_bwd_args(bwd_inputs(cu, budget, H, D, dev, seed), H, D,
                          what)


def check_bwd_args(inputs, H, D, what=''):
    """H2 vs its plain version on ``bwd_inputs``-shaped inputs."""
    from esme_tpu_torch.ops import flash
    q, k, v, do, lse, delta, seg, spans = inputs
    got = flash.segment_flash_bwd(q, k, v, do, lse, delta, seg, *spans, H)
    ref = flash.segment_flash_bwd_plain(q, k, v, do, lse, delta, seg, *spans,
                                        H)
    torch.cuda.synchronize()
    errs, shares, finite = grad_errors(got, ref)
    ok = max(shares) <= 1.0 and finite
    log(f'H2{what} T={q.shape[0]} H={H} D={D} ({flash.bwd_route(D)}): '
        f'max|g-plain| dq/dk/dv '
        f'{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, largest share of the '
        f'gate (2^-4*max(|g|, rms g)) {shares[0]:.3f}/{shares[1]:.3f}/'
        f'{shares[2]:.3f}, finite {finite} {"ok" if ok else "FAIL"}')
    if not ok:
        fail(f'H2 disagrees with its plain version at T={q.shape[0]} D={D}')
    return max(errs), max(shares)


def check_rope(T, H, D, dev, seed=0):
    """H3 vs its plain version, forward and inverse: bit equality (both
    round each product and each sum to bf16)."""
    from esme_tpu_torch.ops import headsplit
    from esme_tpu_torch.ops.rotary import rotary_cos_sin
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k = (randn((T, H * D), gen, dev) for _ in range(2))
    pos = torch.randint(0, 1024, (T,), generator=gen, device=dev)
    cos, sin = rotary_cos_sin(pos, D)
    err = 0.0
    for inverse in (False, True):
        got = headsplit.rotary_qk(q, k, cos, sin, H, inverse=inverse)
        ref = headsplit.rotary_qk_plain(q, k, cos, sin, H, inverse=inverse)
        torch.cuda.synchronize()
        e = max((a.float() - b.float()).abs().max().item()
                for a, b in zip(got, ref))
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        log(f'H3 T={T} H={H} D={D} inverse={inverse}: max|err| {e:.3e}, '
            f'bit-equal {same} (gate: bit equality)')
        if not same:
            fail(f'H3 disagrees with its plain version at D={D}')
        err = max(err, e)
    return err


def relayout_args(mode, T, H, D, dev, seed):
    """H4's arguments for ``RELAYOUTS[mode]``: random bf16 tensors in
    their source layouts and RoPE tables of random positions."""
    from esme_tpu_torch.ops import headsplit
    from esme_tpu_torch.ops.rotary import rotary_cos_sin
    src, dst, rot = RELAYOUTS[mode]
    rot = tuple({'N': headsplit.ROT_NONE, 'R': headsplit.ROT_R,
                 'RT': headsplit.ROT_RT}[r] for r in rot.split())
    srcs = (src,) * len(rot) if isinstance(src, str) else src
    shapes = {'thd': (T, H * D), 'htd': (H, T, D), 'hdt': (H, D, T)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    xs = tuple(randn(shapes[s], gen, dev) for s in srcs)
    pos = torch.randint(0, 1024, (T,), generator=gen, device=dev)
    cos, sin = rotary_cos_sin(pos, D)
    return xs, src, dst, H, rot, cos, sin


def check_relayout(T, H, D, dev):
    """H4 vs its plain version in every mode, on the route its rule picks
    (``relayout_route``; the route counter must show it) and, where that
    is the vec kernel, on the tile kernel launched by name too: bit
    equality (the rotation rounds each product and each sum to bf16 as
    the plain version does; a move without rotation copies the bits)."""
    from esme_tpu_torch.ops import headsplit
    routes = set()
    for i, mode in enumerate(RELAYOUTS):
        args = relayout_args(mode, T, H, D, dev, seed=D + i)
        route = headsplit.relayout_route(*args[1:3], T)
        before = dict(headsplit.relayout_heads.routes)
        runs = {route: headsplit.relayout_heads(*args)}
        moved = {n: c - before[n]
                 for n, c in headsplit.relayout_heads.routes.items()}
        if moved != {n: int(n == route) for n in moved}:
            fail(f'H4 {mode} at T={T} D={D} launched {moved}, not once on '
                 f'{route}')
        if route == 'vec':
            runs['tile'] = headsplit.launch_relayout('tile', *args)
        ref = headsplit.relayout_heads_plain(*args)
        torch.cuda.synchronize()
        for name, got in runs.items():
            routes.add(name)
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                e = max((a.float() - b.float()).abs().max().item()
                        for a, b in zip(got, ref))
                fail(f'H4 {mode} ({name}) at T={T} H={H} D={D} differs '
                     f'from its plain version by up to {e:.3e} (gate: bit '
                     'equality)')
    log(f'H4 T={T} H={H} D={D}: all {len(RELAYOUTS)} modes bit-equal to '
        f'the plain version on the routes {sorted(routes)} (gate: bit '
        'equality) ok')


@contextlib.contextmanager
def plain_versions():
    """Route attention, forward and backward, through the kernels' plain
    versions: the model's (phases 4 and 5) and the op API's (phase 6),
    for their comparisons only. Fails if a kernel launched inside: its
    counter is read on the wrapper itself, before and after."""
    from esme_tpu_torch.ops import flash, flash_v2, fused_attn, headsplit
    kernels = _counters()
    before = _launch_totals(kernels)
    swaps = [(m, n, getattr(flash, n + '_plain')) for m in
             (fused_attn, flash, flash_v2) for n in
             ('segment_flash_fwd', 'segment_flash_bwd') if hasattr(m, n)]
    swaps += [(m, 'rotary_qk', headsplit.rotary_qk_plain)
              for m in (fused_attn, headsplit)]
    swaps += [(m, 'relayout_heads', headsplit.relayout_heads_plain)
              for m in (headsplit, flash_v2)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    after = _launch_totals(kernels)
    if after != before:
        fail(f'a kernel launched while its plain version stood in: '
             f'{before} -> {after}')


def _launch_totals(kernels):
    c = {name: f.launches for name, f in kernels.items()}
    c['rope_inverse'] = kernels[H3_NAME].inverse_launches
    return c


def compare_logp(got, ref, what):
    a = got - got.mean(-1, keepdim=True)
    b = ref - ref.mean(-1, keepdim=True)
    cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
    c, e = cos.min().item(), (got - ref).abs().max().item()
    m = (got - ref).abs().mean().item()
    ok = c >= MODEL_MIN_COS and e <= MODEL_MAX_ABS
    log(f'{what}: min cosine {c:.6f} (gate {MODEL_MIN_COS}), max|err| '
        f'{e:.4f} (gate {MODEL_MAX_ABS}), mean|err| {m:.5f} '
        f'{"ok" if ok else "FAIL"}')
    if not ok:
        fail(f'{what} out of gate')
    return {'min_cos': c, 'max_abs': e, 'mean_abs': m}


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, flop_rate: float):
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / flop_rate
    return max(t_b, t_f) * 1e3, 'bytes' if t_b >= t_f else 'operations'


def flash_work(q, seg, ks, H, D):
    """Bytes H1 must move and the operations its segments need: q, k, v
    read and o written once, lse written, segment ids and spans read;
    2·2·D flops per same-segment (q, k) pair and head (QKᵀ and PV)."""
    T = q.shape[0]
    nbytes = 4 * q.numel() * q.element_size() + H * T * 4 + T * 4 \
        + 2 * ks.numel() * 4
    counts = torch.unique_consecutive(seg, return_counts=True)[1].double()
    flops = 4.0 * D * H * float((counts ** 2).sum().item())
    return nbytes, flops


def flash_bwd_work(q, seg, spans, H, D):
    """Bytes H2 must move and the operations its segments need: q, k, v
    and do read and dq, dk, dv written once, lse and delta read, segment
    ids and spans read; five products of 2·D flops per same-segment
    (q, k) pair and head (S, dP, dV, dK, dQ)."""
    T = q.shape[0]
    nbytes = 7 * q.numel() * q.element_size() + 2 * H * T * 4 + T * 4 \
        + sum(x.numel() for x in spans) * 4
    counts = torch.unique_consecutive(seg, return_counts=True)[1].double()
    flops = 10.0 * D * H * float((counts ** 2).sum().item())
    return nbytes, flops


def mask_units(seg, spans):
    """Counts, from a batch's segment ids, of the units on which H2's
    Hopper form decides the mask (a warp's 16 rows against one 64-row
    tile), per pass: ``{pass: (unmasked, total)}``. A property of the
    batch, worked out here by the kernel's rule, not read from the card
    (``time_mask_skip`` and ``time_fwd_mask_skip`` measure the skip). A
    unit is unmasked when its 16 rows (existing) and the tile's 64 ids
    share one id: in the dk/dv pass the k rows against a q tile of the
    block's span (ids past T read as 0, as the kernel's zero-filled copies
    do), in the dq pass the q rows against a k tile that lies wholly below
    T. The dq pass walks H1's spans, so its count is also the batch's
    (16-row, 64-key) units of the forward."""
    INT_MIN = -2 ** 31
    seg = seg.long().cpu()
    T = seg.numel()
    kstart, kend, qstart, qend = (s.long().cpu() for s in spans)

    def slices(ids):              # per 16 rows: the common id or None
        ids = torch.cat([ids, torch.full(((-T) % 128,), INT_MIN)])
        s16 = ids.view(-1, 16)
        return torch.where((s16 == s16[:, :1]).all(1), s16[:, 0], INT_MIN)

    def tiles(ids, pad):          # per 64 ids: the common id or a miss
        t64 = torch.cat([ids, torch.full(((-T) % 64,), pad)]).view(-1, 64)
        return (t64 == t64[:, :1]).all(1), t64[:, 0]

    r16 = slices(seg)
    counts = {}
    rows = 128                    # per CTA in either pass
    for name, spans_, pad in (('dkv', (qstart, qend), 0),
                              ('dq', (kstart, kend), INT_MIN)):
        uni, first = tiles(seg, pad)
        start, end = spans_
        if name == 'dkv':             # the union of two 64-row spans
            pad2 = (-start.numel()) % 2
            start = torch.cat([start, start[-1:].expand(pad2)]).view(-1, 2) \
                .amin(1)
            end = torch.cat([end, end[-1:].expand(pad2)]).view(-1, 2).amax(1)
        unmasked = total = 0
        for b in range(start.numel()):
            t = torch.arange(int(start[b]), int(end[b]))
            sl = r16[b * rows // 16:(b + 1) * rows // 16]
            hit = uni[t][None, :] & (first[t][None, :] == sl[:, None]) \
                & (sl[:, None] != INT_MIN)
            unmasked += int(hit.sum())
            total += sl.numel() * t.numel()
        counts[name] = (unmasked, total)
    return counts


def sm90_pass(which, args):
    """One pass of H2's Hopper form alone, through its C entry
    ``esme_flash_bwd_sm90_pass`` on ``segment_flash_bwd``'s arguments (no
    counter moves): ``which`` 0 writes dk and dv, 1 writes dq; the
    outputs it does not write are left uninitialised."""
    from esme_tpu_torch import _build
    from esme_tpu_torch.ops import flash
    q, *_, H = args
    T, HD = q.shape
    outs = [torch.empty_like(q) for _ in range(3)]
    lib = _build.library('flash_bwd_sm90')
    entry = 'esme_flash_bwd_sm90_pass'
    rc = getattr(lib, entry)(
        which, 0, *(x.data_ptr() for x in (*args[:11], *outs)), T, H,
        HD // H, 1.0 / math.sqrt(HD // H),
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, lib, flash.BWD_ROUTES['flash_bwd_sm90'][1], entry)
    return outs


def mask_skip_segs(T, dev):
    """The segment ids of the mask-skip pair: T tokens of one segment
    (every tile unmasked), and the same with the token at 37 of each
    64-token tile given an id of its own (the same spans, every tile
    masked)."""
    one = torch.zeros(T, dtype=torch.int32, device=dev)
    cut = one.clone()
    cut[37::64] = torch.arange(1, cut[37::64].numel() + 1, dtype=torch.int32,
                               device=dev)
    return {'one segment': one, 'every tile masked': cut}


def fastest_calls(what, runs):
    """Each of ``runs`` (name -> a call), one call at a time after a 0.2 s
    pause, eight each in the order first, ..., last, last, ..., first,
    four times. On the H100 at 700 W, back-to-back calls of 50-60 ms
    drifted by up to 10%; after the pause they agree within ~2%, and a
    kernel's time is its fastest call. A call is timed on the card alone:
    a spin (``torch.cuda._sleep``, ``SPIN_CYCLES``) is queued before the
    start event, so the host's work before the launch overlaps the spin
    instead of landing between the events (that work, 10-70 us more in a
    checking wrapper than in a bare C-entry call, took H7 ``real`` to
    1.0317 of H2's own pass in one H100 run). Logs the calls, the shortest
    spin and the longest host call, which must stay below it for the
    times to hold the card's work alone; returns ``{name: {'min': ms,
    'median': ms}}``."""
    times = {name: [] for name in runs}
    spin_ms, host_ms = [], []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for name in [*runs, *reversed(runs)] * 4:
        time.sleep(0.2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        torch.cuda._sleep(SPIN_CYCLES)
        ev[1].record()
        runs[name]()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        ev[2].record()
        torch.cuda.synchronize()
        spin_ms.append(ev[0].elapsed_time(ev[1]))
        times[name].append(ev[1].elapsed_time(ev[2]))
    calls = {n: [round(x, 4) for x in t] for n, t in times.items()}
    log(f'{what}: fastest call '
        + ', '.join(f'{n} {min(t):.4f} ms' for n, t in times.items())
        + f'; calls {calls}; shortest spin {min(spin_ms):.3f} ms, longest '
        f'host call {max(host_ms):.3f} ms')
    if max(host_ms) >= min(spin_ms):
        fail(f'{what}: a host call ({max(host_ms):.3f} ms) outlasted the '
             f'spin ahead of it ({min(spin_ms):.3f} ms), so the times hold '
             'host work')
    return {name: {'min': min(t), 'median': float(np.median(t))}
            for name, t in times.items()}


def fastest_pair(what, run, inputs):
    """Each of the two ``inputs`` (one segment, every tile masked) through
    ``run`` (:func:`fastest_calls`). Fails unless the unmasked batch is
    faster, where the kernel skips the mask. Returns ``{layout: {'min':
    ms, 'median': ms}}``."""
    times = fastest_calls(what, {name: (lambda x=x: run(x))
                                 for name, x in inputs.items()})
    a, b = (t['min'] for t in times.values())
    if not a < b:
        fail(f'{what} is not faster where every tile lies in one segment '
             f'({a:.4f} vs {b:.4f} ms): the mask is not skipped')
    return times


def time_mask_skip(T, H, D, dev):
    """Each pass of H2's Hopper form on the mask-skip pair
    (:func:`mask_skip_segs`, :func:`fastest_pair`). Returns ``{pass:
    {layout: {'min': ms, 'median': ms}}}``."""
    from esme_tpu_torch.ops import flash
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    q, k, v, do = (randn((T, H * D), gen, dev) for _ in range(4))
    inputs = {}
    for name, seg in mask_skip_segs(T, dev).items():
        spans = flash.flash_spans(seg)
        o, lse = flash.segment_flash_fwd(q, k, v, seg, *spans[:2], H)
        inputs[name] = (q, k, v, do, lse, flash.attention_delta(o, do, H),
                        seg, *spans, H)
    times = {pname: fastest_pair(f'H2 {pname} pass at T={T}',
                                 lambda a: sm90_pass(which, a), inputs)
             for which, pname in ((0, 'dkv'), (1, 'dq'))}
    del inputs, q, k, v, do
    torch.cuda.empty_cache()
    return times


def time_fwd_mask_skip(T, H, D, dev):
    """H1's Hopper form on the mask-skip pair (:func:`mask_skip_segs`,
    :func:`fastest_pair`). Returns ``{layout: {'min': ms, 'median':
    ms}}``."""
    # the same seed: the same q, k and v over both segment layouts
    from esme_tpu_torch.ops import flash
    inputs = {name: seg_flash_args(seg, H, D, dev, 13)
              for name, seg in mask_skip_segs(T, dev).items()}
    times = fastest_pair(f'H1 (flash_fwd_sm90) at T={T}',
                         lambda a: flash.launch_fwd('flash_fwd_sm90', *a),
                         inputs)
    del inputs
    torch.cuda.empty_cache()
    return times


def mma_sync_bwd(args):
    """H2's mma.sync form (``csrc/flash_bwd.cu``), the mode-0 pair that H7
    ``real`` ablates, through its C entry (no counter moves)."""
    from esme_tpu_torch.ops import flash
    return flash.launch_bwd('flash_bwd', *args)


def sdpa_ms(q, k, v, seg, H, D, reps):
    """One ``scaled_dot_product_attention`` call over the whole packed
    batch with a block-diagonal boolean mask (memory-efficient backend;
    the math backend would need (H, T, T) scores). Yardstick only."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    T = q.shape[0]
    qh, kh, vh = (x.view(T, H, D).transpose(0, 1)[None] for x in (q, k, v))
    mask = (seg[:, None] == seg[None, :])[None, None]
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        def run():
            return torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask)
        out = run()
        ms = cuda_ms(run, reps)
    o = out[0].transpose(0, 1).reshape(T, H * D)
    del mask, out
    return ms, o


def varlen_flash_ms(q, k, v, seg, H, D, reps):
    """One call of PyTorch's varlen flash-attention forward with the
    segments as ``cu_seqlens``: the same function, over same-segment
    tiles only (the dense-mask SDPA call does T^2 work). Yardstick
    only."""
    T = q.shape[0]
    counts = torch.unique_consecutive(seg, return_counts=True)[1]
    cu = torch.nn.functional.pad(counts.cumsum(0), (1, 0)).to(torch.int32)
    longest = int(counts.max())
    qh, kh, vh = (x.view(T, H, D) for x in (q, k, v))

    def run():
        return torch.ops.aten._flash_attention_forward(
            qh, kh, vh, cu, cu, longest, longest, 0.0, False, False,
            scale=D ** -0.5)[0]
    out = run()
    return cuda_ms(run, reps), out.reshape(T, H * D)


def varlen_flash_bwd_ms(q, k, v, do, seg, H, D, reps):
    """One call of PyTorch's varlen flash-attention backward with the
    segments as ``cu_seqlens``, on its own forward's output and lse.
    Yardstick only; returns its dq."""
    T = q.shape[0]
    counts = torch.unique_consecutive(seg, return_counts=True)[1]
    cu = torch.nn.functional.pad(counts.cumsum(0), (1, 0)).to(torch.int32)
    longest = int(counts.max())
    qh, kh, vh, doh = (x.view(T, H, D) for x in (q, k, v, do))
    out, lse, rng_state, unused, _ = torch.ops.aten._flash_attention_forward(
        qh, kh, vh, cu, cu, longest, longest, 0.0, False, False,
        scale=D ** -0.5)

    def run():
        return torch.ops.aten._flash_attention_backward(
            doh, qh, kh, vh, out, lse, cu, cu, longest, longest, 0.0, False,
            rng_state, unused, scale=D ** -0.5)[0]
    dq = run()
    return cuda_ms(run, reps), dq.reshape(T, H * D)


def yardstick(name, fn, ref, ref_name='H1'):
    """Milliseconds of a library call, or None if it did not run; logs
    its largest difference from the kernel's output ``ref``."""
    try:
        ms, out = fn()
    except RuntimeError as e:
        log(f'{name} did not run: {str(e).splitlines()[0][:200]}')
        return None
    log(f'{name} vs {ref_name}: max|diff| '
        f'{(out.float() - ref.float()).abs().max().item():.3e}')
    del out
    torch.cuda.empty_cache()
    return ms


def main(argv):
    if not torch.cuda.is_available():
        fail('no CUDA device: this script runs the port on the card')
    profile_dir = None
    if argv[:1] == ['--profile'] and len(argv) == 2:
        profile_dir = argv[1]
    elif argv:
        fail(f'usage: python3 chip_smoke.py [--profile DIR]; got {argv}')
    try:
        from esme_tpu_torch import _build
        from esme_tpu_torch.ops import flash, headsplit
        from esme_tpu_torch.train import MaskedPLM
        from esme_tpu_torch.ops.rotary import rotary_cos_sin
    except ImportError as e:
        fail(f'the esme_tpu_torch package is not beside this script ({e})')
    t_start = time.perf_counter()
    dev = torch.device(DEVICE)

    # 1. the card
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f'nvidia-smi failed: {smi.stderr.strip()}')
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} '
        f'device(s), python {sys.version.split()[0]}')

    # 2. build
    t0 = time.perf_counter()
    compiled = _build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    for name in _build.SIGNATURES:
        _build.library(name)
    log(f'build: {build_s:.1f} s wall, per source {compiled} '
        f'(empty: already built in {_build._build_dir()})')
    check_mode0_ptxas()
    sm90_usage = check_sm90_ptxas()
    h8_ptxas = check_probes_sm90_ptxas()

    # 3. kernels vs plain versions
    H = MODEL['attention_heads']
    D = MODEL['embed_dim'] // H
    _, cu8k, _ = packed_batch(CHECK_BUDGET, seed=1)
    h2_check_share = 0.0
    for d, h in ((16, 20), (24, 20), (32, 20), (64, 20), (128, 40)):
        check_flash(cu8k, CHECK_BUDGET, h, d, dev, seed=d)
        h2_check_share = max(h2_check_share, check_flash_bwd(
            cu8k, CHECK_BUDGET, h, d, dev, seed=d)[1])
    for layout in BWD_LAYOUTS:        # masked and unmasked tiles
        seg = layout_seg(layout, CHECK_BUDGET, dev, seed=5)
        for d in flash.HEAD_DIMS:
            h2_check_share = max(h2_check_share, check_bwd_args(
                seg_bwd_inputs(seg, 4, d, dev, d), 4, d, f' {layout}')[1])
        # H1 there too, and at a ragged T (T % 64 != 0)
        for t in (CHECK_BUDGET, CHECK_BUDGET - 27):
            for d in flash.HEAD_DIMS:
                check_flash_args(seg_flash_args(seg[:t], 4, d, dev, d + t),
                                 f' {layout}')
    for d in (16, 24, 32, 128):
        check_rope(CHECK_BUDGET, 20 if d < 128 else 40, d, dev, seed=d)
    rope_err = check_rope(BUDGET + (-BUDGET) % 256, H, D, dev)
    for d in (16, 24, 32, 64, 128):
        for t in (CHECK_BUDGET, CHECK_BUDGET - 1):    # T % 8 != 0 too
            check_relayout(t, 20 if d < 128 else 40, d, dev)

    # 4. the inference path
    from esme_tpu_torch import ESM2
    t0 = time.perf_counter()
    model = ESM2(**MODEL, dtype='bfloat16', rng=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(model.params))
    log(f'ESM2 {MODEL} init on the card: {time.perf_counter() - t0:.1f} s, '
        f'{n_params:,} params')
    tokens, cu, max_len = packed_batch(BUDGET, seed=0)
    real = int(cu[-1])
    log(f'main batch: {len(cu) - 1} sequences, {real} real tokens, '
        f'budget {BUDGET}, max_len {max_len}')
    reset_counters()
    lp = model.predict_log_prob(tokens, pad_args=(cu, max_len))
    torch.cuda.synchronize()
    launches = read_counters()
    L = model.config.num_layers
    log(f'inference path launches per forward: {launches} (expected one of '
        f'H1 and H3 per layer, no H4)')
    if launches != expected_launches(**{H1_NAME: L, H3_NAME: L}):
        fail(f'the inference path did not launch H1 and H3 once per layer: '
             f'{launches}')
    if tuple(lp.shape) != (BUDGET, 33) or lp.dtype != torch.float32:
        fail(f'log-probs have shape {tuple(lp.shape)} {lp.dtype}')
    lpr = lp[:real]
    lse_err = lpr.logsumexp(-1).abs().max().item()
    finite = bool(torch.isfinite(lp).all())
    log(f'log-probs finite {finite}, max|logsumexp| {lse_err:.2e} '
        f'(gate {LOGSUMEXP_ATOL})')
    if not finite or lse_err > LOGSUMEXP_ATOL:
        fail('main path log-probs are not finite normalised rows')

    stok, scu, sml = packed_batch(SMALL_BUDGET, seed=2)
    sreal = int(scu[-1])
    small = model.predict_log_prob(stok, pad_args=(scu, sml))[:sreal]
    with plain_versions():
        small_plain = model.predict_log_prob(stok, pad_args=(scu, sml))
    small_ref = model.predict_log_prob(stok, pad_args=(scu, sml),
                                       attn_impl='reference')
    model_checks = {
        'vs_plain': compare_logp(small, small_plain[:sreal],
                                 f'{L} layers, {sreal} tokens: kernels vs '
                                 f'plain versions'),
        'vs_einsum': compare_logp(small, small_ref[:sreal],
                                  f'{L} layers, {sreal} tokens: kernels vs '
                                  f'einsum attention'),
    }
    del small, small_plain, small_ref, lp, lpr

    torch.cuda.reset_peak_memory_stats()
    fwd_samples = [cuda_ms(lambda: model.predict_log_prob(
        tokens, pad_args=(cu, max_len)), reps=1, warmup=int(i == 0))
        for i in range(FWD_REPS)]
    fwd_ms = float(np.median(fwd_samples))
    t0 = time.perf_counter()
    model.predict_log_prob(tokens, pad_args=(cu, max_len))
    host_ms = (time.perf_counter() - t0) * 1e3     # enqueue, no sync
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f'inference path: median {fwd_ms:.2f} ms per batch of {FWD_REPS} '
        f'(min {min(fwd_samples):.2f}, max {max(fwd_samples):.2f}), '
        f'{real / fwd_ms * 1e3:.1f} real tokens/s, peak memory '
        f'{peak / 2**30:.2f} GiB; host returns after {host_ms:.2f} ms')
    if profile_dir:
        _profile(lambda: model.predict_log_prob(tokens,
                                                pad_args=(cu, max_len)),
                 profile_dir, 'profile_main.txt', 'forward')

    # 5. the training path
    cells = {}
    for key, budget, ckpt, reps, falls in TRAIN_CELLS:
        cells[key] = train_cell(model, MaskedPLM, key, budget, ckpt, reps,
                                falls, n_params, profile_dir)
    grad_checks = check_grads(model, MaskedPLM)
    fit_losses = check_fit(model, MaskedPLM)
    del model
    torch.cuda.empty_cache()

    # 6. the attention op API
    ops = check_op_api(cu, dev)

    # 7. times
    h1_err, h1_lse_err = check_flash(cu, BUDGET, H, D, dev, seed=7,
                                     what=' at the main shape')
    q, k, v, seg, pos, spans = flash_inputs(cu, BUDGET, H, D, dev, 7)
    ks, ke = spans[:2]
    h1_args = (q, k, v, seg, ks, ke, H)
    T = q.shape[0]
    o, _ = flash.segment_flash_fwd(*h1_args)
    h1_ms = cuda_ms(lambda: flash.segment_flash_fwd(*h1_args), reps=20,
                    warmup=2)
    # the mma.sync form (H6 `baseline`'s kernel) through its C entry
    h1_mma_sync_ms = cuda_ms(lambda: mma_sync_fwd(h1_args), reps=20,
                             warmup=2)
    h1_plain_ms = cuda_ms(lambda: flash.segment_flash_fwd_plain(*h1_args),
                          reps=2)
    h1_bytes, h1_flops = flash_work(q, seg, ks, H, D)
    h1_bound, h1_by = bound(h1_bytes, h1_flops, BF16_FLOP_PER_S)
    h1_lib_ms = yardstick(
        'SDPA (dense block-diagonal mask)',
        lambda: sdpa_ms(q, k, v, seg, H, D, reps=3), o)
    h1_varlen_ms = yardstick(
        'varlen flash-attention forward (aten)',
        lambda: varlen_flash_ms(q, k, v, seg, H, D, reps=20), o)
    u, n = mask_units(seg, spans)['dq']
    h1_units = {'unmasked': u, 'total': n, 'share': u / n}
    log(f'H1 at the main shape: {h1_ms:.4f} ms ({flash.fwd_route(D)}), the '
        f'mma.sync form {h1_mma_sync_ms:.4f} ms '
        f'({h1_ms / h1_mma_sync_ms:.4f}), '
        + (f'{h1_ms / h1_varlen_ms:.4f} of the varlen library '
           f'({h1_varlen_ms:.4f} ms; logged, not a gate)' if h1_varlen_ms
           else 'no varlen library time')
        + f'; the batch\'s unmasked (16-row, 64-key) units per head '
        f'{h1_units}')
    if not h1_ms < h1_mma_sync_ms:
        fail(f'H1 ({h1_ms:.4f} ms) is not faster than its mma.sync form '
             f'({h1_mma_sync_ms:.4f} ms) at the main shape')

    cos, sin = rotary_cos_sin(pos, D)
    h3_ms = cuda_ms(lambda: headsplit.rotary_qk(q, k, cos, sin, H),
                    reps=20, warmup=2)
    h3_plain_ms = cuda_ms(lambda: headsplit.rotary_qk_plain(
        q, k, cos, sin, H), reps=5)
    # q and k read and written once; of the tables, the halves
    # [:, :D/2] that H3 reads (csrc/rope.cu)
    h3_bytes = 4 * q.numel() * 2 + cos.numel() * 2
    h3_bound, h3_by = bound(h3_bytes, 6.0 * q.numel(), FP32_FLOP_PER_S)
    del q, k, v, o, cos, sin, h1_args
    torch.cuda.empty_cache()
    h1_mask_skip = time_fwd_mask_skip(T, H, D, dev)

    # H2 at the 50k train cell's shape (bench.py's train batch, seed 2)
    _, tcu, _ = packed_batch(BUDGET, seed=2)
    h2_err, h2_share = check_flash_bwd(tcu, BUDGET, H, D, dev, seed=9,
                                       what=' at the train shape')
    q, k, v, do, lse, delta, tseg, tspans = bwd_inputs(tcu, BUDGET, H, D,
                                                       dev, 9)
    TT = q.shape[0]
    h2_args = (q, k, v, do, lse, delta, tseg, *tspans, H)
    dq = flash.segment_flash_bwd(*h2_args)[0]
    h2_ms = cuda_ms(lambda: flash.segment_flash_bwd(*h2_args), reps=20,
                    warmup=2)
    # each pass of the Hopper form alone; the mma.sync form (H7 `real`'s
    # pair); the batch's unmasked tiles by the kernel's rule
    h2_passes = {name: cuda_ms(lambda: sm90_pass(which, h2_args), reps=20,
                               warmup=2)
                 for which, name in ((0, 'dkv'), (1, 'dq'))}
    mma_sync_ms = cuda_ms(lambda: mma_sync_bwd(h2_args), reps=20, warmup=2)
    units = {name: {'unmasked': a, 'total': b, 'share': a / b}
             for name, (a, b) in mask_units(tseg, tspans).items()}
    log(f'H2 at the train shape: {h2_ms:.4f} ms (dk/dv, then dq); passes '
        f'alone {h2_passes}; the mma.sync form {mma_sync_ms:.4f} ms; the '
        f'batch\'s unmasked (16-row, 64-row tile) units per head {units}')
    h2_plain_ms = cuda_ms(lambda: flash.segment_flash_bwd_plain(*h2_args),
                          reps=2)
    h2_bytes, h2_flops = flash_bwd_work(q, tseg, tspans, H, D)
    h2_bound, h2_by = bound(h2_bytes, h2_flops, BF16_FLOP_PER_S)
    h2_lib_ms = yardstick(
        'varlen flash-attention backward (aten)',
        lambda: varlen_flash_bwd_ms(q, k, v, do, tseg, H, D, reps=20), dq,
        'H2 dq')
    del q, k, v, do, dq, h2_args
    torch.cuda.empty_cache()
    mask_skip = time_mask_skip(TT, H, D, dev)

    h4_modes = time_relayouts(T, H, D, dev, card)
    h4 = h4_modes[next(iter(RELAYOUTS))]

    # 8. the probe tools' kernels
    probe_kernels = check_probes(
        dev, {'ms': h1_ms, 'mma_sync_ms': h1_mma_sync_ms},
        {'ms': h2_ms, 'mma_sync_ms': mma_sync_ms, 'library_ms': h2_lib_ms},
        card, h8_ptxas)

    train_launches = {key: c['launches'] for key, c in cells.items()}
    kernels = [
        {'name': H1_NAME, 'route': 'cuda',
         'source': 'esme_tpu_torch/csrc/flash_fwd_sm90.cu',
         'routes': {str(d): f'esme_tpu_torch/csrc/{flash.fwd_route(d)}.cu'
                    for d in flash.HEAD_DIMS},
         'replaces': 'esme_tpu/ops/flash.py:370',
         'also_replaces': ['esme_tpu/ops/flash.py:257',
                           'esme_tpu/ops/flash_v2.py:45',
                           'esme_tpu/ops/headsplit.py:114',
                           'esme_tpu/ops/headsplit.py:235'],
         'launches': launches[H1_NAME],
         'train_launches': {key: c[H1_NAME]
                            for key, c in train_launches.items()},
         'max_abs_err': h1_err,
         'lse_max_abs_err': h1_lse_err, 'ms': h1_ms,
         'plain_ms': h1_plain_ms, 'bound_ms': h1_bound, 'bound_by': h1_by,
         'library_ms': h1_lib_ms, 'library_varlen_ms': h1_varlen_ms,
         'mma_sync_form_ms': h1_mma_sync_ms, 'mask_skip_ms': h1_mask_skip,
         'ptxas': sm90_usage['flash_fwd_sm90'],
         'shape': f'T={T} H={H} D={D} bf16',
         'bytes': h1_bytes, 'flops': h1_flops},
        {'name': H2_NAME, 'route': 'cuda',
         'source': 'esme_tpu_torch/csrc/flash_bwd_sm90.cu',
         'routes': {str(d): f'esme_tpu_torch/csrc/{flash.bwd_route(d)}.cu'
                    for d in flash.HEAD_DIMS},
         'replaces': 'esme_tpu/ops/flash.py:475',
         'also_replaces': ['esme_tpu/ops/flash.py:511',
                           'esme_tpu/ops/flash.py:552',
                           'esme_tpu/ops/flash.py:581',
                           'esme_tpu/ops/flash.py:628',
                           'esme_tpu/ops/headsplit.py:114',
                           'esme_tpu/ops/headsplit.py:235'],
         'launches': train_launches['nockpt'][H2_NAME],
         'train_launches': {key: c[H2_NAME]
                            for key, c in train_launches.items()},
         'max_abs_err': h2_err, 'gate_share': max(h2_share, h2_check_share),
         'ms': h2_ms, 'plain_ms': h2_plain_ms, 'bound_ms': h2_bound,
         'bound_by': h2_by, 'library_ms': h2_lib_ms,
         'passes_ms': h2_passes, 'mma_sync_form_ms': mma_sync_ms,
         'mask_skip_ms': mask_skip, 'ptxas': sm90_usage['flash_bwd_sm90'],
         'shape': f'T={TT} H={H} D={D} bf16 (train batch)',
         'bytes': h2_bytes, 'flops': h2_flops},
        {'name': H3_NAME, 'route': 'cuda',
         'source': 'esme_tpu_torch/csrc/rope.cu',
         'replaces': 'esme_tpu/ops/headsplit.py:119',
         'also_replaces': ['esme_tpu/ops/headsplit.py:235 (rotating, '
                           'inverse=True)'],
         'launches': launches[H3_NAME],
         'train_launches': {key: c[H3_NAME]
                            for key, c in train_launches.items()},
         'inverse_launches': {key: c['rope_inverse']
                              for key, c in train_launches.items()},
         'max_abs_err': rope_err,
         'ms': h3_ms, 'plain_ms': h3_plain_ms, 'bound_ms': h3_bound,
         'bound_by': h3_by, 'library_ms': None,
         'shape': f'T={T} H={H} D={D} bf16', 'bytes': h3_bytes},
        {'name': H4_NAME, 'route': 'cuda',
         'source': 'esme_tpu_torch/csrc/headsplit.cu',
         'routes': {'no hdt side': 'relayout_rows_kernel',
                    'an hdt side, T % 8 == 0': 'relayout_vec_kernel',
                    'an hdt side, T % 8 != 0': 'relayout_tile_kernel'},
         'replaces': 'esme_tpu/ops/headsplit.py:52',
         'also_replaces': ['esme_tpu/ops/headsplit.py:70',
                           'esme_tpu/ops/headsplit.py:75',
                           'esme_tpu/ops/headsplit.py:216'],
         'launches': sum(r['launches'][H4_NAME] for r in ops.values()),
         'inference_launches': launches[H4_NAME],
         'train_launches': {key: c[H4_NAME]
                            for key, c in train_launches.items()},
         'op_launches': {op: r['launches'][H4_NAME]
                         for op, r in ops.items()},
         'max_abs_err': max(m['max_abs_err'] for m in h4_modes.values()),
         'ms': h4['ms'], 'plain_ms': h4['plain_ms'],
         'bound_ms': h4['bound_ms'], 'bound_by': h4['bound_by'],
         'library_ms': h4['library_ms'], 'mode': next(iter(RELAYOUTS)),
         'modes': h4_modes, 'shape': f'T={T} H={H} D={D} bf16',
         'bytes': h4['bytes']},
        *probe_kernels,
    ]
    for kd in kernels:
        log(f"{kd['name']}: {kd['ms']:.4f} ms (bound {kd['bound_ms']:.4f} "
            f"ms by {kd['bound_by']}), plain {kd['plain_ms']:.3f} ms, "
            f"library {kd['library_ms']}, varlen library "
            f"{kd.get('library_varlen_ms')}")
    measured = {
        'card': card, 'model': f'ESM2 {MODEL} bf16, seed-0 random weights',
        'batch': f'bench.py seed 0: {len(cu) - 1} seqs, {real} real tokens, '
        f'budget {BUDGET}',
        'ms_per_batch': fwd_ms, 'ms_per_batch_samples': fwd_samples,
        'real_tokens_per_s': real / fwd_ms * 1e3,
        'peak_mem_gib': peak / 2**30, 'host_enqueue_ms': host_ms,
        'train': cells, 'grad_checks': grad_checks, 'op_api': ops,
        'inference_batch_unmasked_units': h1_units,
        'train_batch_unmasked_units': units,
        'fit_losses': fit_losses, 'build_s': build_s,
        'model_checks': model_checks, 'torch': torch.__version__,
        'cuda': torch.version.cuda,
        'wall_s': time.perf_counter() - t_start,
    }
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps(measured), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


def _counters():
    from esme_tpu_torch.ops import flash, headsplit
    from esme_tpu_torch.tools import (decompose_bwd, flash_variants,
                                      fwd_T_experiment, profile_attn)
    return {H1_NAME: flash.segment_flash_fwd,
            H2_NAME: flash.segment_flash_bwd, H3_NAME: headsplit.rotary_qk,
            H4_NAME: headsplit.relayout_heads,
            H5_NAME: fwd_T_experiment.fwd_T,
            H6_NAME: flash_variants.variant_fwd,
            H7_NAME: decompose_bwd.bwd_variant,
            **{name: getattr(profile_attn, name[len('probe_'):])
               for name in H8_NAMES}}


def reset_counters():
    for f in _counters().values():
        f.launches = 0
    _counters()[H3_NAME].inverse_launches = 0
    for name in (H4_NAME, H5_NAME):
        # (a plain version standing in for H4 counts no routes)
        routes = getattr(_counters()[name], 'routes', {})
        routes.update(dict.fromkeys(routes, 0))


def read_counters():
    return _launch_totals(_counters())


def train_batch(budget: int):
    """``bench.py``'s masked-LM batch (``bench.py:50-85``): sequences and
    residues from seed 2, 80/10/10 masking from seed 1, no loss on the
    padding tail. Returns the batch and the attention flops of one
    forward (4·Σn²·C·L, bench.py's ``attn_flops``)."""
    from esme_tpu_torch.alphabet import Alphabet, mask_tokens
    tokens, cu, max_len = packed_batch(budget, seed=2)
    masked, mask = mask_tokens(tokens[None], alphabet=Alphabet,
                               rng=np.random.default_rng(1))
    masked, mask = masked[0], mask[0]
    mask[cu[-1]:] = False
    lens = np.diff(cu).astype(np.float64)
    attn = 4 * float((lens ** 2).sum()) * MODEL['embed_dim'] \
        * MODEL['num_layers']
    return SimpleNamespace(tokens=tokens, masked_tokens=masked, mask=mask,
                           cu_lens=cu, max_len=max_len), attn


def train_cell(model, plm_cls, key, budget, ckpt, reps, falls, n_params,
               profile_dir):
    """One train cell: a warm-up step with the launch counters set to 0
    just before it and read just after, then ``reps`` timed steps on the
    same batch. MFU as bench.py computes it: (6·N·tokens + 3.5·attention
    forward flops) / time / 989 TFLOP/s."""
    L = model.config.num_layers
    model.checkpointing = ckpt
    batch, attn_flops = train_batch(budget)
    real = int(batch.cu_lens[-1])
    plm = plm_cls(model, learning_rate=1e-4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    losses = [plm.training_step(batch)]
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counters()
    expected = expected_launches(**{
        H1_NAME: 2 * L if ckpt else L, H2_NAME: L,
        H3_NAME: (3 if ckpt else 2) * L, 'rope_inverse': L})
    log(f'train {key}@{budget}: launches in one step {launches} (expected '
        f'{expected})')
    if launches != expected:
        fail(f'train {key}: a kernel of the training path launched '
             f'{launches}, not {expected}')
    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(plm.training_step(batch))       # float(): a sync
        samples.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    ms = float(np.median(samples))
    flops = 6 * n_params * real + 3.5 * attn_flops
    cell = {'budget': budget, 'checkpointing': ckpt, 'real_tokens': real,
            'sequences': len(batch.cu_lens) - 1, 'launches': launches,
            'losses': losses, 'first_step_ms': first_ms,
            'ms_per_step': ms, 'ms_per_step_samples': samples,
            'real_tokens_per_s': real / ms * 1e3,
            'mfu': flops / (ms * 1e-3) / MFU_PEAK,
            'peak_mem_gib': peak / 2**30}
    log(f'train {key}@{budget}: losses {[round(x, 4) for x in losses]}, '
        f'median {ms:.2f} ms per step of {reps} (samples '
        f'{[round(x, 2) for x in samples]}), {cell["real_tokens_per_s"]:.1f} '
        f'real tokens/s, MFU {cell["mfu"]:.4f}, peak memory '
        f'{cell["peak_mem_gib"]:.2f} GiB')
    if not all(np.isfinite(losses)):
        fail(f'train {key}: losses not finite: {losses}')
    if falls and not losses[-1] < losses[0]:
        fail(f'train {key}: the last loss is not below the first: {losses}')
    if profile_dir:
        _profile(lambda: plm.training_step(batch), profile_dir,
                 f'profile_train_{key}.txt', f'train step {key}@{budget}')
    model.checkpointing = False
    del plm
    torch.cuda.empty_cache()
    return cell


def compare_grads(got, ref, min_cos, max_rel, what):
    """Per-leaf cosine and largest difference relative to the leaf's
    largest value; fails outside the gates."""
    worst_cos, worst_rel, equal, n = 1.0, 0.0, 0, 0
    for name, a, b in _leaf_pairs(got, ref):
        n += 1
        equal += bool(torch.equal(a, b))
        a, b = a.float().ravel(), b.float().ravel()
        scale = b.abs().max().item()
        if scale == 0.0:
            if a.abs().max().item() != 0.0:
                fail(f'{what}: {name} has a gradient where the reference '
                     'has none')
            continue
        cos = (a @ b / (a.norm() * b.norm())).item()
        rel = (a - b).abs().max().item() / scale
        worst_cos, worst_rel = min(worst_cos, cos), max(worst_rel, rel)
        if cos < min_cos or rel > max_rel:
            fail(f'{what}: {name} cosine {cos:.6f} (gate {min_cos}), max '
                 f'rel err {rel:.4f} (gate {max_rel})')
    log(f'{what}: {n} leaves, min cosine {worst_cos:.6f} (gate {min_cos}), '
        f'max|err|/max|g| {worst_rel:.5f} (gate {max_rel}), bit-equal '
        f'{equal} of {n}')
    return {'min_cos': worst_cos, 'max_rel': worst_rel, 'bit_equal': equal,
            'leaves': n}


def check_grads(model, plm_cls):
    """Every leaf's gradient of one masked-LM step at full depth on a 4k
    batch: kernels vs plain versions, and remat='full' vs none."""
    batch, _ = train_batch(SMALL_BUDGET)
    plm = plm_cls(model)
    loss, grads = plm._grad_step(batch)
    with plain_versions():
        loss_p, grads_p = plm._grad_step(batch)
    model.checkpointing = True
    try:
        loss_c, grads_c = plm._grad_step(batch)
    finally:
        model.checkpointing = False
    L = model.config.num_layers
    log(f'{L} layers, {int(batch.cu_lens[-1])} tokens: loss with kernels '
        f'{loss.item():.6f}, plain versions {loss_p.item():.6f}, '
        f'remat {loss_c.item():.6f}')
    checks = {
        'vs_plain': compare_grads(grads, grads_p, GRAD_MIN_COS, GRAD_MAX_REL,
                                  'gradients, kernels vs plain versions'),
        'remat_vs_none': compare_grads(grads_c, grads, REMAT_MIN_COS,
                                       REMAT_MAX_REL,
                                       "gradients, remat='full' vs none"),
        'loss': loss.item(), 'loss_plain': loss_p.item(),
    }
    if not torch.equal(loss, loss_c):
        fail(f"remat='full' changed the loss: {loss_c.item()} vs "
             f'{loss.item()}')
    del plm, grads, grads_p, grads_c
    torch.cuda.empty_cache()
    return checks


def check_fit(model, plm_cls):
    """``MaskedPLM(model).fit(MaskedFastaTokenDataset(...))`` over a FASTA
    file written from seed 0: two batches, two steps."""
    from esme_tpu_torch import Alphabet, MaskedFastaTokenDataset
    from esme_tpu_torch.fasta import write_fai
    aa = np.array(list('LAGVSERTIDPKQNFYMHWC'))
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'train.fa')
        total, nseq = 0, 0
        with open(path, 'w') as f:
            while total < 1.5 * FIT_BUDGET:
                n = int(rng.integers(100, 1000))
                seq = ''.join(rng.choice(aa, n))
                f.write(f'>seq{nseq}\n')
                for lo in range(0, n, 60):
                    f.write(seq[lo:lo + 60] + '\n')
                total += n + 2
                nseq += 1
        write_fai(path)
        ds = MaskedFastaTokenDataset(path, token_per_batch=FIT_BUDGET,
                                     shuffle=True, random_state=0,
                                     alphabet=Alphabet)
        if len(ds) != 2:
            fail(f'fit: the FASTA file gave {len(ds)} batches, not 2')
        history = plm_cls(model, learning_rate=1e-4).fit(ds, log_every=1)
    log(f'fit over {nseq} sequences ({total} tokens) in {len(ds)} batches '
        f'of {FIT_BUDGET}: losses {history}')
    if len(history) != 2 or not all(np.isfinite(history)):
        fail(f'fit: losses {history}')
    torch.cuda.empty_cache()
    return history


def op_run(fn, xs, w):
    """``fn(*xs)`` and the gradients of ``<fn(*xs), w>``, with the launch
    counters set to 0 just before and read just after."""
    xs = [x.clone().requires_grad_() for x in xs]
    torch.cuda.synchronize()
    reset_counters()
    o = fn(*xs)
    o.backward(w)
    torch.cuda.synchronize()
    return o.detach(), [x.grad for x in xs], read_counters()


def expected_launches(**counts):
    """Every counter at 0 but those given."""
    return {**{name: 0 for name in _counters()}, 'rope_inverse': 0,
            **counts}


def expect_launches(what, got, **expected):
    want = expected_launches(**expected)
    if got != want:
        fail(f'{what}: launches {got}, not {want}')


def check_op_api(cu, dev):
    """Phase 6: each op of the attention API at the main shape against
    the same op through the plain versions (see the module docstring).
    Returns per op its launches and errors."""
    from esme_tpu_torch.ops import flash, fused_attn, headsplit
    from esme_tpu_torch.ops.flash_v2 import fwd_v2
    from esme_tpu_torch.ops.rotary import rotary_cos_sin
    H = MODEL['attention_heads']
    D = MODEL['embed_dim'] // H
    q, k, v, seg, pos, spans = flash_inputs(cu, BUDGET, H, D, dev, 11)
    T = q.shape[0]
    cos, sin = rotary_cos_sin(pos, D)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    w = randn(q.shape, gen, dev)
    layouts = {
        'thd': lambda x: x.view(T, H, D),
        'htd': lambda x: x.view(T, H, D).transpose(0, 1).contiguous(),
        'hdt': lambda x: x.view(T, H, D).permute(1, 2, 0).contiguous()}
    results = {}

    def against_plain(name, fn, layout, **expected):
        xs = [layouts[layout](x) for x in (q, k, v)]
        wl = layouts[layout](w)
        o, g, launches = op_run(fn, xs, wl)
        expect_launches(name, launches, **expected)
        with plain_versions():
            o_p, g_p, _ = op_run(fn, xs, wl)
        e_o, share_o = o_errors(o, o_p)
        errs, shares, finite = grad_errors(g, g_p)
        ok = share_o <= 1.0 and max(shares) <= 1.0 and finite
        log(f'{name} at T={T} H={H} D={D}: launches {launches}; '
            f'max|o-plain| {e_o:.3e} ({share_o:.3f} of the H1 gate), '
            f'max|g-plain| {max(errs):.3e} ({max(shares):.3f} of the H2 '
            f'gate), finite {finite} {"ok" if ok else "FAIL"}')
        if not ok:
            fail(f'{name} disagrees with its plain version')
        results[name] = {'launches': launches, 'o_max_abs_err': e_o,
                         'o_gate_share': share_o,
                         'grad_max_abs_err': max(errs),
                         'grad_gate_share': max(shares)}

    against_plain('flash_segment_attention thd',
                  lambda q, k, v: flash.flash_segment_attention(q, k, v, seg),
                  'thd', **{H1_NAME: 1, H2_NAME: 1})
    against_plain('flash_segment_attention htd',
                  lambda q, k, v: flash.flash_segment_attention(
                      q, k, v, seg, layout='htd'),
                  'htd', **{H1_NAME: 1, H2_NAME: 1, H4_NAME: 4})
    against_plain('flash_tm', lambda q, k, v: flash.flash_tm(q, k, v, seg),
                  'hdt', **{H1_NAME: 1, H2_NAME: 1, H4_NAME: 4})

    # split_heads_rotary -> merge_heads: relayouts only, so bit-equal to
    # the plain versions, values and gradients; the merged q and k are
    # H3's rotation of the same rows
    def split_merge(q2, k2, v2):
        parts = headsplit.split_heads_rotary(q2, k2, v2, cos, sin, H)
        return torch.stack([headsplit.merge_heads(p) for p in parts])

    w3 = randn((3, T, H * D), gen, dev)
    o, g, launches = op_run(split_merge, (q, k, v), w3)
    expect_launches('split_heads_rotary -> merge_heads', launches,
                    **{H4_NAME: 8})
    with plain_versions():
        o_p, g_p, _ = op_run(split_merge, (q, k, v), w3)
    qr, kr = headsplit.rotary_qk(q, k, cos, sin, H)
    same = torch.equal(o, o_p) and all(map(torch.equal, g, g_p))
    same_h3 = torch.equal(o[0], qr) and torch.equal(o[1], kr) \
        and torch.equal(o[2], v)
    log(f'split_heads_rotary -> merge_heads at T={T}: launches {launches}; '
        f'values and gradients bit-equal to the plain versions {same}, '
        f'merged q and k bit-equal to H3 {same_h3} (gate: bit equality) '
        f'{"ok" if same and same_h3 else "FAIL"}')
    if not (same and same_h3):
        fail('split_heads_rotary -> merge_heads is not bit-equal')
    results['split_heads_rotary -> merge_heads'] = {
        'launches': launches, 'bit_equal': same, 'bit_equal_h3': same_h3}

    # fwd_v2 (H4, H1, H4) against H1 on the (T, H·D) layout
    qh, kT, vT = layouts['htd'](q), layouts['hdt'](k), layouts['hdt'](v)
    torch.cuda.synchronize()
    reset_counters()
    o, lse = fwd_v2(qh, kT, vT, seg.view(T, 1), seg.view(1, T), *spans[:2],
                    block_q=flash.BLOCK_Q, block_k=flash.BLOCK_K,
                    head_block=H, scale=D ** -0.5, interpret=False)
    torch.cuda.synchronize()
    launches = read_counters()
    expect_launches('fwd_v2', launches, **{H1_NAME: 1, H4_NAME: 2})
    o_r, lse_r = flash.segment_flash_fwd(q, k, v, seg, *spans[:2], H,
                                         scale=D ** -0.5)
    e_o, share, e_l = flash_errors(o.transpose(0, 1).reshape(T, H * D),
                                   lse[..., 0], o_r, lse_r)
    ok = share <= 1.0 and e_l <= FLASH_LSE_ATOL
    log(f'fwd_v2 at T={T}: launches {launches}; vs segment_flash_fwd '
        f'max|o| {e_o:.3e} ({share:.3f} of the H1 gate), max|lse| '
        f'{e_l:.3e} (gate {FLASH_LSE_ATOL}) {"ok" if ok else "FAIL"}')
    if not ok:
        fail('fwd_v2 disagrees with segment_flash_fwd')
    results['fwd_v2'] = {'launches': launches, 'o_max_abs_err': e_o,
                         'o_gate_share': share, 'lse_max_abs_err': e_l}

    # JAX's ESME_FLASH_IMPL=v2 steps against fused_rotary_flash's forward
    # (H3, H1): the same rotation and the same H1 on copies of the bits
    torch.cuda.synchronize()
    reset_counters()
    _, _, o_d, lse_d = fused_attn._forward(q, k, v, cos, sin, seg, H, spans)
    torch.cuda.synchronize()
    expect_launches('fused_rotary_flash', read_counters(),
                    **{H1_NAME: 1, H3_NAME: 1})
    reset_counters()
    qh, kT, vT = headsplit._split_call_t(q, k, v, cos, sin, H)
    o, lse = fwd_v2(qh, kT, vT, seg.view(T, 1), seg.view(1, T), *spans[:2],
                    block_q=flash.BLOCK_Q, block_k=flash.BLOCK_K,
                    head_block=H, scale=D ** -0.5, interpret=False)
    o = headsplit._merge_call(o, None, None, False, False)
    torch.cuda.synchronize()
    launches = read_counters()
    expect_launches('_split_call_t -> fwd_v2 -> _merge_call', launches,
                    **{H1_NAME: 1, H4_NAME: 4})
    e_o, share, e_l = flash_errors(o, lse.view(H, T), o_d, lse_d)
    same = torch.equal(o, o_d)
    ok = share <= 1.0 and e_l <= FLASH_LSE_ATOL
    log(f'_split_call_t -> fwd_v2 -> _merge_call at T={T}: launches '
        f'{launches}; vs fused_rotary_flash max|o| {e_o:.3e} ({share:.3f} '
        f'of the H1 gate), max|lse| {e_l:.3e} (gate {FLASH_LSE_ATOL}), '
        f'bit-equal o {same} {"ok" if ok else "FAIL"}')
    if not ok:
        fail('the v2 steps disagree with fused_rotary_flash')
    results['v2 steps'] = {
        'launches': launches, 'o_max_abs_err': e_o, 'o_gate_share': share,
        'lse_max_abs_err': e_l, 'bit_equal_o': same}
    del q, k, v, w, w3, o, g, o_p, g_p, o_d, qh, kT, vT
    torch.cuda.empty_cache()
    return results


def ptxas_usage(build_log: str) -> dict:
    """``{(kernel, padded head dim, mode): (registers, stack frame, spill
    stores, spill loads)}`` of the H1/H2 kernels in ``nvcc -Xptxas -v``
    output."""
    usage, name, frame = {}, None, None
    for line in build_log.splitlines():
        m = re.search(r'Function properties for \S*\d(flash_(?:fwd|bwd_dq|'
                      r'bwd_dkv)_kernel)ILi(\d+)ELi(\d+)E', line)
        if m:
            name = (m.group(1), int(m.group(2)), int(m.group(3)))
            continue
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m and name:
            frame = tuple(map(int, m.groups()))
            continue
        m = re.search(r'Used (\d+) registers', line)
        if m and name and frame:
            usage[name] = (int(m.group(1)), *frame)
            name = frame = None
    return usage


def check_mode0_ptxas():
    """H1's and H2's production instantiations (mode 0) use the registers
    they used before the ablation modes were added, with no stack frame
    and no spills (``MODE0_REGISTERS``); fail otherwise."""
    from esme_tpu_torch import _build
    usage = {lib: ptxas_usage(_build.build_log(lib))
             for lib, _ in MODE0_REGISTERS}
    for (lib, kernel), regs in MODE0_REGISTERS.items():
        for dp, r in regs.items():
            got = usage[lib].get((kernel, dp, 0))
            if got != (r, 0, 0, 0):
                fail(f'ptxas: {kernel}<{dp}, mode 0> uses (registers, stack, '
                     f'spill stores, spill loads) {got}, not {(r, 0, 0, 0)} '
                     'as before the ablation modes')
        log(f'ptxas: {kernel} mode 0 as before the ablation modes: {regs} '
            'registers, no stack, no spills')


# H1's and H2's Hopper kernels as ptxas reported them in the build of this
# slice's parent (the tree before the token-minor layout and the ablation
# modes were added; nvcc of CUDA 12.9 on the H100 machine): (registers,
# stack frame, spill stores, spill loads) by head dim. Their production
# instantiations (layout or mode 0) must come out unchanged.
SM90_PRODUCTION = {
    ('flash_fwd_sm90', 'flash_fwd_sm90_kernel'): {
        32: (127, 0, 0, 0), 64: (128, 0, 0, 0), 128: (168, 0, 0, 0)},
    ('flash_bwd_sm90', 'bwd_dkv_sm90_kernel'): {
        32: (128, 0, 0, 0), 64: (160, 0, 0, 0), 128: (156, 384, 896, 640)},
    ('flash_bwd_sm90', 'bwd_dq_sm90_kernel'): {
        32: (111, 0, 0, 0), 64: (123, 0, 0, 0), 128: (155, 0, 0, 0)},
}


# H6's modes of H1's Hopper form that spill, with (stack frame, spill
# stores, spill loads) as ptxas reported them (nvcc of CUDA 12.9 on the
# H100 machine): noqk builds its scores by register arithmetic instead of
# a wgmma, which puts the 128-register kernel over its cap (it spills
# about as much with no K read at all). Any other mode, or a larger
# spill, fails.
H6_SPILLS = {'noqk': (24, 24, 36)}


def sm90_ptxas_usage(build_log: str,
                     kernels: str = r'bwd_(?:dkv|dq)|flash_fwd') -> dict:
    """``{(kernel, head dim, *params): (registers, stack frame, spill
    stores, spill loads)}`` of H1's and H2's Hopper kernels in ``nvcc
    -Xptxas -v`` output, ``params`` the template parameters after D: H1's
    layout (0 for H1, 1 for H5) and mode (0 the production kernel, else
    H6's), H2's mode (0 the production pass, else H7's). ``kernels``
    matches the names before ``_sm90_kernel`` (H8's ``stream``: its
    template parameters, layout and cluster size, stand in D's place)."""
    usage, name, frame = {}, None, None
    for line in build_log.splitlines():
        m = re.search(r'Function properties for \S*?\d((?:' + kernels +
                      r')_sm90_kernel)I((?:Li\d+E)+)E', line)
        if m:
            name = (m.group(1), *map(int, re.findall(r'Li(\d+)E',
                                                     m.group(2))))
            continue
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m and name:
            frame = tuple(map(int, m.groups()))
            continue
        m = re.search(r'Used (\d+) registers', line)
        if m and name and frame:
            usage[name] = (int(m.group(1)), *frame)
            name = frame = None
    return usage


def production_key(kernel: str, d: int):
    """The usage key of a Hopper kernel's production instantiation: H1's
    layout and mode 0, H2's mode 0."""
    return (kernel, d, 0, 0) if kernel == 'flash_fwd_sm90_kernel' \
        else (kernel, d, 0)


def check_sm90_ptxas():
    """H1's and H2's Hopper libraries as built: each production
    instantiation with the parent's registers, stack and spills
    (``SM90_PRODUCTION``), H5's (H1's kernel, token-minor layout) at
    D = 64 without stack or spills, every H6 mode (H1's kernel at D = 64)
    built without a ``wgmma`` serialisation warning (C7510-C7520) naming
    it and without stack or spills but for ``H6_SPILLS``, and every H7
    mode of both passes at D = 64
    built; fail otherwise. Logs every instantiation's ``ptxas`` line and
    any serialisation warning. Returns per library the usage of all its
    kernels and its warnings."""
    from esme_tpu_torch import _build
    from esme_tpu_torch.tools import decompose_bwd as tdb
    from esme_tpu_torch.tools import flash_variants as tfv
    out = {}
    for lib in ('flash_fwd_sm90', 'flash_bwd_sm90'):
        build_log = _build.build_log(lib)
        usage = sm90_ptxas_usage(build_log)
        for (kernel, d, *p), (regs, *frame) in sorted(usage.items()):
            log(f'ptxas: {lib} {kernel}<D={d}, {", ".join(map(str, p))}>: '
                f'{regs} registers, stack {frame[0]}, spill stores '
                f'{frame[1]}, spill loads {frame[2]}')
        for (name, kernel), want in SM90_PRODUCTION.items():
            if name != lib:
                continue
            for d, usage_d in want.items():
                got = usage.get(production_key(kernel, d))
                if got != usage_d:
                    fail(f'ptxas: {kernel}<D={d}> production uses '
                         f'(registers, stack, spill stores, spill loads) '
                         f'{got}, not {usage_d} as in the parent\'s build')
            log(f'ptxas: {kernel} production as in the parent\'s build: '
                f'{want}')
        warnings = sorted({line.strip() for line in build_log.splitlines()
                           if re.search(r'C75(1\d|20)\b|wgmma', line)})
        for line in warnings:
            log(f'ptxas: {lib}: {line}')
        if lib == 'flash_fwd_sm90':
            got = usage.get(('flash_fwd_sm90_kernel', 64, 1, 0))
            if got is None or any(got[1:]):
                fail(f'ptxas: H5\'s flash_fwd_sm90_kernel<D=64, token-minor> '
                     f'has a stack frame or spills, or is missing: {got}')
            for mode, name in enumerate(tfv.MODES):
                got = usage.get(('flash_fwd_sm90_kernel', 64, 0, mode))
                want = H6_SPILLS.get(name, (0, 0, 0))
                if mode and (got is None or got[1:] != want):
                    fail(f'ptxas: H6 mode {name} (flash_fwd_sm90_kernel<64, '
                         f'0, {mode}>) has (stack, spill stores, spill loads) '
                         f'{got and got[1:]}, not {want}')
                mangled = f'flash_fwd_sm90_kernelILi64ELi0ELi{mode}EE'
                if any(mangled in line for line in warnings):
                    fail(f'ptxas serialises the wgmma of H6 mode '
                         f'{list(tfv.MODES)[mode]}')
            log(f'ptxas: H6\'s {len(tfv.MODES) - 1} modes at D = 64 built '
                f'without a wgmma serialisation warning, and without stack or '
                f'spills but for {H6_SPILLS}')
        else:
            for kernel in ('bwd_dkv_sm90_kernel', 'bwd_dq_sm90_kernel'):
                built = sorted(p for k, d, p in usage
                               if k == kernel and d == 64)
                if built != list(range(len(tdb.MODES))):
                    fail(f'ptxas: H7\'s {kernel} modes at D = 64: built '
                         f'{built}, not all {len(tdb.MODES)}')
        out[lib] = {'usage': {f'{k} D={d} {p}': u
                              for (k, d, *p), u in sorted(usage.items())},
                    'wgmma_warnings': warnings}
    return out


# H8's Hopper kernels (csrc/probes_sm90.cu) by (layout, cluster size): dma
# alone and in pairs, dma_t
H8_SM90_KERNELS = ((0, 1), (0, 2), (1, 1))


def check_probes_sm90_ptxas():
    """H8's Hopper kernels as built: each of ``H8_SM90_KERNELS`` without a
    stack frame or spills; fail otherwise. Logs their ``ptxas`` lines and
    returns them."""
    from esme_tpu_torch import _build
    usage = sm90_ptxas_usage(_build.build_log('probes_sm90'), 'stream')
    for (kernel, *p), (regs, *frame) in sorted(usage.items()):
        log(f'ptxas: probes_sm90 {kernel}<layout {p[0]}, cluster {p[1]}>: '
            f'{regs} registers, stack {frame[0]}, spill stores {frame[1]}, '
            f'spill loads {frame[2]}')
    for layout, cluster in H8_SM90_KERNELS:
        got = usage.get(('stream_sm90_kernel', layout, cluster))
        if got is None or any(got[1:]):
            fail(f'ptxas: H8\'s stream_sm90_kernel<{layout}, {cluster}> has '
                 f'a stack frame or spills, or is missing: {got}')
    return {f'stream_sm90_kernel layout={layout} cluster={cluster}':
            usage[('stream_sm90_kernel', layout, cluster)]
            for layout, cluster in H8_SM90_KERNELS}


def check_probes(dev, h1, h2, card, h8_ptxas):
    """Phase 8: the probe tools' kernels H5-H8 (see the module docstring).
    ``h1`` and ``h2`` hold phase 7's times of H1 and H2, ``h8_ptxas`` the
    ``ptxas`` lines of H8's Hopper kernels. Returns the probes' entries of
    the kernels line."""
    from esme_tpu_torch.ops import flash
    from esme_tpu_torch.tools import (BWD_SEED, FWD_SEED, attention_batch,
                                      hdt_to_thd, thd_to_hdt)
    from esme_tpu_torch.tools import decompose_bwd as tdb
    from esme_tpu_torch.tools import flash_variants as tfv
    from esme_tpu_torch.tools import fwd_T_experiment as tft
    from esme_tpu_torch.tools import profile_attn as tpa
    H = MODEL['attention_heads']
    D = MODEL['embed_dim'] // H

    def gate(what, c):
        """Log a tool's ``check`` result; fail where it is not ok."""
        vals = ', '.join(f'{k} {v:.3e}' for k, v in c.items() if k != 'ok')
        log(f'{what}: {vals} {"ok" if c["ok"] else "FAIL"}')
        if not c['ok']:
            fail(f'{what}: outside its gate')

    # 8a. each kernel against its plain version on the 8k check batch; H5
    # on its route (the Hopper form at D = 32-128, the mma.sync form at 16,
    # 24 and at a T that is not a multiple of 8), which its counter shows
    for d, h, cut in ((16, 20, 0), (24, 20, 0), (32, 20, 0), (64, 20, 0),
                      (128, 40, 0), (64, 20, 27)):
        b = attention_batch(CHECK_BUDGET, 1, h, d, dev)
        T = b.T - cut
        seg = b.seg[:T].contiguous()
        spans = flash.block_spans(seg, flash.BLOCK_Q, flash.BLOCK_K)
        qT, kT, vT = (thd_to_hdt(x[:T], h) for x in (b.q, b.k, b.v))
        route = tft.fwd_T_route(d, T)
        before = dict(tft.fwd_T.routes)
        got = tft.fwd_T(qT, kT, vT, seg, *spans)
        ref = tft.fwd_T_plain(qT, kT, vT, seg, *spans)
        torch.cuda.synchronize()
        moved = {n: c - before[n] for n, c in tft.fwd_T.routes.items()}
        if moved != {n: int(n == route) for n in moved}:
            fail(f'H5 at T={T} D={d} launched {moved}, not once on {route}')
        e_o, share, e_l, ok = tft.flash_errors(*got, *ref)
        gate(f'H5 ({route}) T={T} H={h} D={d} vs plain (H1\'s gates)',
             {'max|o-plain|': e_o, 'o gate share': share,
              'max|lse-plain|': e_l, 'ok': ok})
        if route == 'flash_fwd_sm90':
            o1, lse1 = flash.segment_flash_fwd(
                b.q[:T], b.k[:T], b.v[:T], seg, *spans, h)
            if not (torch.equal(hdt_to_thd(got[0]), o1)
                    and torch.equal(got[1], lse1)):
                fail(f'H5 ({route}) at T={T} D={d} is not bit-equal to H1')
            log(f'H5 ({route}) T={T} H={h} D={d}: bit-equal to H1')
    b8 = attention_batch(CHECK_BUDGET, 1, H, D, dev, grads=True)
    args8 = (b8.q, b8.k, b8.v, b8.seg, *b8.spans[:2], H)
    for library in flash.FWD_ROUTES:       # the Hopper form, then mma.sync
        for mode in tfv.MODES:
            got = tfv.variant_fwd(mode, *args8, library=library)
            gate(f'H6 ({library}) {mode} T={b8.T} vs plain', tfv.check(
                mode, got, tfv.variant_fwd_plain(mode, *args8,
                                                 library=library), library))
            if library == flash.fwd_route(D) and mode == 'baseline' and not \
                    all(map(torch.equal, got, flash.segment_flash_fwd(
                        *args8))):
                fail(f'H6 ({library}) baseline at T={b8.T} is not bit-equal '
                     'to H1')
    lse8, delta8 = tdb.backward_inputs(b8)
    bargs8 = (b8.q, b8.k, b8.v, b8.do, lse8, delta8, b8.seg, *b8.spans, H)
    for library in flash.BWD_ROUTES:       # the Hopper form, then mma.sync
        for kernel in tdb.KERNELS:
            for mode in tdb.MODES:
                got = tdb.bwd_variant(kernel, mode, *bargs8, library=library)
                ref = tdb.bwd_variant_plain(kernel, mode, *bargs8,
                                            library=library)
                gate(f'H7 ({library}) {kernel} {mode} T={b8.T} vs plain',
                     tdb.check(mode, got, ref))
    # H8: each probe, the streaming ones in both forms and dma in both
    # modes, the Hopper forms bit-equal to the cp.async form
    outs8 = {}
    for run, (kernel, plain) in tpa.calls(
            b8, tpa.probe_inputs(b8)).items():
        outs8[run] = kernel()
        gate(f'H8 {run} ({tpa.RUNS[run][1]}) T={b8.T} vs plain',
             tpa.check(run, outs8[run], plain()))
    for run, ref in tpa.SAME_AS.items():
        if not torch.equal(outs8[run], outs8[ref]):
            fail(f'H8 {run} at T={b8.T} is not bit-equal to {ref}')
    log(f'H8 T={b8.T}: {", ".join(tpa.SAME_AS)} bit-equal to their cp.async '
        'form')
    del b8, args8, bargs8, lse8, delta8, outs8
    torch.cuda.empty_cache()

    # 8b. each tool's own run at the main shapes, the launch counters set
    # to 0 just before it and read just after; then its comparisons
    def tool_run(what, name, fn):
        torch.cuda.synchronize()
        reset_counters()
        out = fn()
        torch.cuda.synchronize()
        launches = read_counters()
        log(f'{what}: launches {launches}')
        for n in name if isinstance(name, tuple) else (name,):
            if launches[n] < 1:
                fail(f'{what} did not launch {n}')
        return out, launches

    b = attention_batch(BUDGET, FWD_SEED, H, D, dev)
    ks, ke = b.spans[:2]
    args = (b.q, b.k, b.v, b.seg, ks, ke, H)
    # H5 beside H1: its Hopper form (the route at this shape) against H1's
    # Hopper form on the same values, its plain version and its mma.sync
    # form, which it must beat (fastest of 8 calls each)
    r5, l5 = tool_run('fwd_T_experiment.measure', H5_NAME,
                      lambda: tft.measure(b, reps=20))
    if r5['route'] != 'flash_fwd_sm90':
        fail(f'H5 ran on {r5["route"]} at the main shape, not its Hopper form')
    log(f'H5 ({r5["route"]}) vs H1 ({flash.fwd_route(D)}) at T={b.T}: '
        f'max|o| {r5["o_err_vs_h1"]:.3e} ({r5["o_gate_share_vs_h1"]:.3f} of '
        f'the gate), max|lse| {r5["lse_err_vs_h1"]:.3e}, bit-equal '
        f'{r5["bit_equal_to_h1"]}')
    # bit equality, as the first card run showed at every shape checked: the
    # same products summed in the same order, from operands laid out apart
    if not r5['bit_equal_to_h1']:
        fail('H5 is not bit-equal to H1 at the main shape')
    qT, kT, vT = (thd_to_hdt(x, H) for x in (b.q, b.k, b.v))
    targs = (qT, kT, vT, b.seg, ks, ke)
    ref5 = tft.fwd_T_plain(*targs)
    e_o, share, e_l, ok = tft.flash_errors(*tft.fwd_T(*targs), *ref5)
    gate(f'H5 T={b.T} vs plain', {'max|o-plain|': e_o, 'o gate share': share,
                                 'max|lse-plain|': e_l, 'ok': ok})
    # the mma.sync form, timed below, under H1's gates against the plain
    # version and against H1
    o1, lse1 = flash.segment_flash_fwd(*args)
    oT_m, lse_m = tft.launch_fwd_T('flash_fwd_t', *targs)
    for what, ref in (('plain', ref5), ('H1', (thd_to_hdt(o1, H), lse1))):
        e_m, share_m, e_lm, ok_m = tft.flash_errors(oT_m, lse_m, *ref)
        gate(f'H5 mma.sync form T={b.T} vs {what} (H1\'s gates)',
             {f'max|o-{what}|': e_m, 'o gate share': share_m,
              f'max|lse-{what}|': e_lm, 'ok': ok_m})
    del ref5, oT_m, lse_m
    h5_fastest = fastest_calls(
        f'H5 at T={b.T}',
        {'flash_fwd_sm90': lambda: tft.launch_fwd_T('flash_fwd_sm90', *targs),
         'flash_fwd_t': lambda: tft.launch_fwd_T('flash_fwd_t', *targs)})
    if not h5_fastest['flash_fwd_sm90']['min'] < \
            h5_fastest['flash_fwd_t']['min']:
        fail('H5\'s Hopper form is not faster than its mma.sync form')
    h5_plain_ms = cuda_ms(lambda: tft.fwd_T_plain(*targs), reps=2)
    h5_lib_ms = yardstick(
        'varlen flash-attention forward (aten), (T, H, D) operands',
        lambda: varlen_flash_ms(b.q, b.k, b.v, b.seg, H, D, reps=20), o1)
    log(f'H5 (flash_fwd_sm90) {r5["ms"]:.4f} ms: '
        f'{r5["ms"] / r5["mma_sync_ms"]:.4f} of its mma.sync form '
        f'({r5["mma_sync_ms"]:.4f} ms), {r5["ms"] / r5["h1_ms"]:.4f} of H1 '
        f'({r5["h1_ms"]:.4f} ms), {r5["ms"] / r5["bound_ms"]:.2f}x its bound '
        f'({r5["bound_ms"]:.4f} ms), '
        + (f'{r5["ms"] / h5_lib_ms:.4f} of the varlen library '
           f'({h5_lib_ms:.4f} ms)' if h5_lib_ms else 'no library time'))
    del qT, kT, vT, o1, lse1, targs
    kernels = [{
        'name': H5_NAME, 'route': 'cuda',
        'source': 'esme_tpu_torch/csrc/flash_fwd_sm90.cu',
        'form': 'flash_fwd_sm90 (H1\'s kernel, token-minor layout; entry '
                'esme_flash_fwd_t_sm90)',
        'routes': {'D 32-128, T % 8 == 0': 'esme_tpu_torch/csrc/'
                   'flash_fwd_sm90.cu', 'otherwise': 'esme_tpu_torch/csrc/'
                   'flash_fwd_t.cu'},
        'replaces': 'tools/fwd_T_experiment.py:27',
        'launches': l5[H5_NAME], 'max_abs_err': e_o, 'lse_max_abs_err': e_l,
        'ms': r5['ms'], 'plain_ms': h5_plain_ms, 'bound_ms': r5['bound_ms'],
        'bound_by': r5['bound_by'], 'library_ms': h5_lib_ms,
        'mma_sync_form_ms': r5['mma_sync_ms'], 'fastest_ms': h5_fastest,
        'h1_ms': r5['h1_ms'], 'vs_h1': {k: r5[k] for k in (
            'o_err_vs_h1', 'o_gate_share_vs_h1', 'lse_err_vs_h1',
            'bit_equal_to_h1')},
        'shape': f'T={b.T} H={H} D={D} bf16, (H, D, T) operands'}]

    # H6: every mode of both forms timed; the Hopper form's baseline
    # bit-equal to H1, the mma.sync form's to that form, each under its
    # gates against its plain walk; H1 under its gates against the latter
    hopper6, mma_sync6 = flash.fwd_route(D), 'flash_fwd'
    modes6, l6 = tool_run(
        'flash_variants.run, every mode of both forms', H6_NAME,
        lambda: {library: {m: tfv.run(m, b, reps=20, library=library)
                           for m in tfv.MODES}
                 for library in (hopper6, mma_sync6)})
    for library, runs in modes6.items():
        base = runs['baseline']['ms']
        log(f'H6 ({library}) at T={b.T}: ' + ', '.join(
            f'{m} {r["ms"]:.4f} ms ({r["ms"] / base:.3f}; '
            f'{r["ms"] / r["bound_ms"]:.2f}x its bound)'
            for m, r in runs.items()))
    got = tfv.variant_fwd('baseline', *args, library=hopper6)
    if not all(map(torch.equal, got, flash.segment_flash_fwd(*args))):
        fail(f'H6 ({hopper6}) baseline is not bit-equal to H1 at the main '
             'shape')
    c6 = tfv.check('baseline', got, tfv.variant_fwd_plain(
        'baseline', *args, library=hopper6))
    gate(f'H6 ({hopper6}) baseline T={b.T} vs plain (bit-equal to H1)', c6)
    got = tfv.variant_fwd('baseline', *args, library=mma_sync6)
    if not all(map(torch.equal, got, mma_sync_fwd(args))):
        fail('H6 baseline is not bit-equal to the mma.sync form of H1 at the '
             'main shape')
    gate(f'H6 ({mma_sync6}) baseline T={b.T} vs plain (bit-equal to the '
         'mma.sync form)', tfv.check('baseline', got, tfv.variant_fwd_plain(
             'baseline', *args, library=mma_sync6), mma_sync6))
    o, lse = flash.segment_flash_fwd(*args)
    e_o, share, e_l = flash_errors(o, lse, *got)
    gate(f'H1 ({flash.fwd_route(D)}) T={b.T} vs H6 baseline (the mma.sync '
         "form), H1's gates",
         {'max|o-baseline|': e_o, 'o gate share': share,
          'max|lse-baseline|': e_l,
          'ok': share <= 1.0 and e_l <= FLASH_LSE_ATOL})
    del o, lse, got
    h6_plain_ms = {library: cuda_ms(
        lambda library=library: tfv.variant_fwd_plain(
            'baseline', *args, library=library), reps=1)
        for library in (hopper6, mma_sync6)}
    kernels.append({
        'name': H6_NAME, 'route': 'cuda',
        'source': 'esme_tpu_torch/csrc/flash_fwd_sm90.cu',
        'form': f'{hopper6} (entry esme_segment_flash_fwd_sm90_variant)',
        'forms': {hopper6: 'esme_tpu_torch/csrc/flash_fwd_sm90.cu',
                  mma_sync6: 'esme_tpu_torch/csrc/flash_fwd.cu'},
        'replaces': 'tools/flash_variants.py:32', 'launches': l6[H6_NAME],
        'max_abs_err': c6['o_err'], 'ms': modes6[hopper6]['baseline']['ms'],
        'plain_ms': h6_plain_ms[hopper6],
        'bound_ms': modes6[hopper6]['baseline']['bound_ms'],
        'bound_by': modes6[hopper6]['baseline']['bound_by'],
        'library_ms': None,
        'mode': 'baseline (bit-equal to H1)', 'modes': modes6,
        'h1_ms': h1['ms'],
        'mma_sync_form_ms': modes6[mma_sync6]['baseline']['ms'],
        'mma_sync_form_plain_ms': h6_plain_ms[mma_sync6],
        'shape': f'T={b.T} H={H} D={D} bf16'})

    # H8 probes over H1's steps: every run (the streaming probes in both
    # forms, dma in both modes) under its gate, the Hopper forms bit-equal
    # to the cp.async form; each Hopper form faster than its cp.async form
    # (fastest of 8 calls each, on the card alone)
    r8, l8 = tool_run('profile_attn.measure', H8_NAMES,
                      lambda: tpa.measure(b, reps=20))
    for run in tpa.RUNS:
        if not r8[run]['ok']:
            fail(f'H8 {run} disagrees with its plain version')
    for run, ref in tpa.SAME_AS.items():
        if not r8[run]['bit_equal']:
            fail(f'H8 {run} is not bit-equal to {ref} at the main shape')
    calls8 = tpa.calls(b, tpa.probe_inputs(b))
    plains = {p: cuda_ms(calls8[p][1], reps=2) for p in tpa.PROBES}
    kT8, vT8 = (thd_to_hdt(x, H) for x in (b.k, b.v))
    fastest8 = {
        'dma': fastest_calls(f'H8 dma at T={b.T}', {
            'probes_sm90': lambda: tpa.launch_dma('probes_sm90', b.q, b.k,
                                                  b.v, ks, ke, H),
            'pair': lambda: tpa.launch_dma('probes_sm90', b.q, b.k, b.v, ks,
                                           ke, H, cluster=2),
            'probes': lambda: tpa.launch_dma('probes', b.q, b.k, b.v, ks, ke,
                                             H)}),
        'dma_t': fastest_calls(f'H8 dma_t at T={b.T}', {
            'probes_sm90': lambda: tpa.launch_dma_t('probes_sm90', kT8, vT8,
                                                    ks, ke),
            'probes': lambda: tpa.launch_dma_t('probes', kT8, vT8, ks,
                                               ke)})}
    for probe, fastest in fastest8.items():
        if not fastest['probes_sm90']['min'] < fastest['probes']['min']:
            fail(f'H8 {probe}\'s Hopper form is not faster than its cp.async '
                 'form')
    k3 = b.k.view(b.T, H, D)
    lib_ms = cuda_ms(lambda: k3.permute(1, 2, 0).contiguous(), reps=20,
                     warmup=2)
    for probe, line in zip(tpa.PROBES, (81, 115, 155, 209)):
        r = r8[probe]
        entry = {
            'name': f'probe_{probe}', 'route': 'cuda',
            'source': 'esme_tpu_torch/csrc/probes.cu',
            'replaces': f'tools/profile_attn.py:{line}',
            'launches': l8[f'probe_{probe}'], 'max_abs_err': r['err'],
            'ms': r['ms'], 'plain_ms': plains[probe],
            'bound_ms': r['bound_ms'], 'bound_by': r['bound_by'],
            'library_ms': lib_ms if probe.startswith('dma') else None,
            'tile_bytes': r['tile_bytes'], 'h1_ms': r8['h1']['ms'],
            'shape': f'T={b.T} H={H} D={D}, H1\'s steps'}
        if probe in fastest8:
            cp = r8[f'{probe}_cp_async']
            entry.update({
                'source': 'esme_tpu_torch/csrc/probes_sm90.cu',
                'forms': {'probes_sm90': 'esme_tpu_torch/csrc/'
                          'probes_sm90.cu',
                          'probes': 'esme_tpu_torch/csrc/probes.cu'},
                'l2_tb_per_s': r['l2_tb_per_s'], 'cp_async_form_ms': cp['ms'],
                'cp_async_l2_tb_per_s': cp['l2_tb_per_s'],
                'cp_async_max_abs_err': cp['err'],
                'bit_equal_to_cp_async': r['bit_equal'],
                'fastest_ms': fastest8[probe], 'ptxas': h8_ptxas})
            if probe == 'dma':
                pair = r8['dma_pair']
                entry.update({
                    'pair_ms': pair['ms'], 'pair_tile_bytes':
                    pair['tile_bytes'], 'pair_l2_tb_per_s':
                    pair['l2_tb_per_s'], 'pair_max_abs_err': pair['err'],
                    'pair_bit_equal_to_cp_async': pair['bit_equal']})
        kernels.append(entry)
        if probe in fastest8:
            log(f'H8 {probe}: ' + '; '.join(
                f'{run} {r8[run]["ms"]:.4f} ms, tiles '
                f'{r8[run]["tile_bytes"] / 1e9:.3f} GB'
                + ('' if r8[run]['l2_tb_per_s'] is None else
                   f' at {r8[run]["l2_tb_per_s"]:.3f} TB/s')
                for run in tpa.RUNS if tpa.RUNS[run][0] == probe)
                + f'; bound {r["bound_ms"]:.4f} ms by {r["bound_by"]}')
    del b, args, k3, kT8, vT8, calls8
    torch.cuda.empty_cache()

    # H7 at the train shape: every mode of each pass of both forms timed;
    # the Hopper form's real bit-equal to H2 and as fast as H2's own passes;
    # the mma.sync form's real bit-equal to that form and under H2's gate
    bt = attention_batch(BUDGET, BWD_SEED, H, D, dev, grads=True)
    lse, delta = tdb.backward_inputs(bt)
    bargs = (bt.q, bt.k, bt.v, bt.do, lse, delta, bt.seg, *bt.spans, H)
    hopper, mma_sync = flash.BWD_ROUTES
    modes7, l7 = tool_run(
        'decompose_bwd.run, every mode of each pass of both forms', H7_NAME,
        lambda: {library: {f'{kernel} {mode}': tdb.run(
            kernel, mode, bt, lse, delta, reps=20, library=library)
            for kernel in tdb.KERNELS for mode in tdb.MODES}
            for library in (hopper, mma_sync)})
    for kernel in tdb.KERNELS:
        real = modes7[hopper][f'{kernel} real']['ms']
        log(f'H7 ({hopper}) {kernel} at the train shape: '
            + ', '.join(f'{mode} {r["ms"]:.4f} ms ({r["ms"] / real:.3f}; '
                        f'{r["ms"] / r["bound_ms"]:.2f}x its bound)'
                        for mode, r in ((m, modes7[hopper][f'{kernel} {m}'])
                                        for m in tdb.MODES)))
    got = (tdb.bwd_variant('dq', 'real', *bargs, library=hopper),
           *tdb.bwd_variant('dkv', 'real', *bargs, library=hopper))
    if not all(map(torch.equal, got, flash.segment_flash_bwd(*bargs))):
        fail('H7 real (the Hopper form) is not bit-equal to H2 at the train '
             'shape')
    plain_dq = lambda: tdb.bwd_variant_plain(  # noqa
        'dq', 'real', *bargs, library=hopper)
    plain_dkv = lambda: tdb.bwd_variant_plain(  # noqa
        'dkv', 'real', *bargs, library=hopper)
    c7 = tdb.check('real', got, (plain_dq(), *plain_dkv()))
    gate(f'H7 ({hopper}) real T={bt.T} vs plain (bit-equal to H2)', c7)
    h7_plain_ms = cuda_ms(plain_dq, reps=1) + cuda_ms(plain_dkv, reps=1)
    # mode 0 is H2's own pass: each timed beside H2's launch of it, in turn
    h7_vs_h2 = {kernel: {side: t['min'] for side, t in fastest_calls(
        f'H7 real ({hopper}) {kernel} vs H2\'s pass', {
            'h2': lambda which=which: sm90_pass(which, bargs),
            'h7': lambda kernel=kernel: tdb.bwd_variant(
                kernel, 'real', *bargs, library=hopper)}).items()}
        for which, kernel in enumerate(tdb.KERNELS)}
    ratio = sum(x['h7'] for x in h7_vs_h2.values()) / \
        sum(x['h2'] for x in h7_vs_h2.values())
    within = abs(ratio - 1) <= 0.03
    log(f'H7 real ({hopper}) vs H2\'s passes at the train shape: '
        f'{h7_vs_h2}, {ratio:.4f} (within 3%: {within}; '
        f'{"a gate" if card == REF_CARD else "logged only"} on {card}); H2 '
        f'both passes in one call {h2["ms"]:.4f} ms')
    if card == REF_CARD and not within:
        fail(f'H7 real ({hopper}) took {ratio:.4f} of H2\'s passes')
    real = [modes7[hopper][f'{k} real'] for k in tdb.KERNELS]
    kernels.append({
        'name': H7_NAME, 'route': 'cuda',
        'source': 'esme_tpu_torch/csrc/flash_bwd_sm90.cu',
        'form': f'{hopper} (entry esme_flash_bwd_sm90_pass)',
        'replaces': 'tools/decompose_bwd.py:66',
        'also_replaces': ['tools/decompose_bwd.py:125'],
        'launches': l7[H7_NAME], 'max_abs_err': c7['err'],
        'ms': sum(r['ms'] for r in real), 'plain_ms': h7_plain_ms,
        'bound_ms': sum(r['bound_ms'] for r in real),
        'bound_by': max(real, key=lambda r: r['bound_ms'])['bound_by'],
        'library_ms': None,
        'mode': 'real (dk/dv + dq, bit-equal to H2)', 'modes': modes7,
        'h2_ms': h2['ms'], 'h2_passes_ms': h7_vs_h2,
        'mma_sync_form_ms': sum(modes7[mma_sync][f'{k} real']['ms']
                                for k in tdb.KERNELS),
        'shape': f'T={bt.T} H={H} D={D} bf16 (train batch)'})

    # the mma.sync form's real: bit-equal to that form, H2 under its gate
    # against it, its time held to before the modes were added
    dq = tdb.bwd_variant('dq', 'real', *bargs, library=mma_sync)
    dk, dv = tdb.bwd_variant('dkv', 'real', *bargs, library=mma_sync)
    if not all(map(torch.equal, (dq, dk, dv), mma_sync_bwd(bargs))):
        fail('H7 real is not bit-equal to the mma.sync form of H2 at the '
             'train shape')
    errs, shares, finite = grad_errors(flash.segment_flash_bwd(*bargs),
                                       (dq, dk, dv))
    ok = max(shares) <= 1.0 and finite
    log(f'H2 (the Hopper form) vs H7 real (the mma.sync form) T={bt.T}: '
        f'max|diff| {max(errs):.3e}, {max(shares):.3f} of the H2 gate, '
        f'finite {finite} {"ok" if ok else "FAIL"}')
    if not ok:
        fail('H2 disagrees with H7 real, its mma.sync form')
    del bt, bargs, dq, dk, dv, lse, delta, got
    torch.cuda.empty_cache()
    h7_times = (h2['mma_sync_ms'], sum(modes7[mma_sync][f'{k} real']['ms']
                                       for k in tdb.KERNELS))
    for name, timings, ref in (
            (f'{H1_NAME}, the mma.sync form',
             (h1['mma_sync_ms'], modes6[mma_sync6]['baseline']['ms']),
             H1_REF_MS),
            (f'{H7_NAME} real (the mma.sync form of H2)', h7_times,
             H2_REF_MS)):
        ratio = min((t / ref for t in timings), key=lambda x: abs(x - 1))
        within = abs(ratio - 1) <= 0.03
        log(f'{name} {" and ".join(f"{t:.4f}" for t in timings)} ms, best '
            f'{ratio:.4f} of its {ref} ms before the ablation modes on '
            f'{REF_CARD} (within 3%: {within}; '
            f'{"a gate" if card == REF_CARD else "logged only"} on {card})')
        if card == REF_CARD and not within:
            fail(f'{name} moved by more than 3% from {ref} ms')
    h7_ms = min(h7_times)
    lib = h2['library_ms']
    log(f'{H2_NAME} (the Hopper form) {h2["ms"]:.4f} ms at the train shape: '
        f'{h2["ms"] / h7_ms:.4f} of H7 real ({h7_ms:.4f} ms, the mma.sync '
        f'form), '
        + (f'{h2["ms"] / lib:.4f} of the library ({lib:.4f} ms)' if lib
           else 'no library time'))
    if not h2['ms'] < h7_ms:
        fail(f'H2 ({h2["ms"]:.4f} ms) is not faster than its mma.sync form '
             f'({h7_ms:.4f} ms)')
    return kernels


def time_relayouts(T, H, D, dev, card):
    """H4 in each mode at the main shape on the route its rule picks,
    held bit-equal to its plain version: ms beside its bound (bytes: each
    tensor read and written once and, where a tensor rotates, the halves
    ``[:, :D/2]`` of the cos and sin tables that H4 and its plain version
    read, once), its plain version's ms and, for a move of one tensor
    without rotation, one ``permute(...).contiguous()`` call's ms. A mode
    with an hdt side (the vec route at this T) is also timed on the tile
    kernel, its route where T % 8 != 0, in turn with the vec kernel
    (``fastest_calls``, the card alone), after the tile kernel's output
    too is held bit-equal to the plain version: the vec kernel's fastest
    call must be faster where the move rotates, and where it does not,
    within 3% of the tile kernel's fastest call (its ratio to the tile
    kernel's earlier times, ``H4_TILE_REF_MS``, is logged). A 20-call mean of a 0.1 ms
    move through the checking wrapper can hold host time between the
    launches, so the gates read the card alone."""
    from esme_tpu_torch.ops import headsplit
    order = {'thd': (0, 1, 2), 'htd': (1, 0, 2), 'hdt': (1, 2, 0)}
    modes = {}
    for mode in RELAYOUTS:
        args = relayout_args(mode, T, H, D, dev, seed=3)
        xs, src, dst, _, rot, cos, sin = args
        route = headsplit.relayout_route(src, dst, T)
        got = headsplit.relayout_heads(*args)
        ref = headsplit.relayout_heads_plain(*args)
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, ref))
        if not all(map(torch.equal, got, ref)):
            fail(f'H4 {mode} at T={T} H={H} D={D} differs from its plain '
                 f'version by up to {err:.3e} (gate: bit equality)')
        ms = cuda_ms(lambda: headsplit.relayout_heads(*args), reps=20,
                     warmup=2)
        plain_ms = cuda_ms(lambda: headsplit.relayout_heads_plain(*args),
                           reps=3)
        rotates = any(rot)
        nbytes = 2 * sum(x.numel() * x.element_size() for x in xs) \
            + (cos.numel() * cos.element_size() if rotates else 0)
        flops = 6.0 * xs[0].numel() * sum(map(bool, rot))
        b, by = bound(nbytes, flops, FP32_FLOP_PER_S)
        lib = None
        if len(xs) == 1 and not rotates:
            view = headsplit._thd_view(xs[0], src, H).permute(*order[dst])
            if not torch.equal(view.contiguous().view(got[0].shape), got[0]):
                fail(f'H4 {mode}: the library yardstick computes another '
                     'function')
            lib = cuda_ms(lambda: view.contiguous(), reps=20, warmup=2)
        modes[mode] = {'route': route, 'ms': ms, 'plain_ms': plain_ms,
                       'bound_ms': b, 'bound_by': by, 'library_ms': lib,
                       'bytes': nbytes, 'max_abs_err': err}
        log(f'H4 {mode} at T={T} H={H} D={D} ({route}): {ms:.4f} ms (bound '
            f'{b:.4f} ms by {by}, {ms / b:.2f}x), plain {plain_ms:.3f} ms, '
            f'library {lib}, max|err| {err}')
        if route == 'vec':
            tile = headsplit.launch_relayout('tile', *args)
            torch.cuda.synchronize()
            if not all(map(torch.equal, tile, ref)):
                e = max((a.float() - b.float()).abs().max().item()
                        for a, b in zip(tile, ref))
                fail(f'H4 {mode} (tile) at T={T} H={H} D={D} differs from '
                     f'its plain version by up to {e:.3e} (gate: bit '
                     'equality)')
            del tile
            fastest = fastest_calls(f'H4 {mode}, vec vs tile kernel', {
                r: lambda r=r: headsplit.launch_relayout(r, *args)
                for r in ('vec', 'tile')})
            vec, tile = fastest['vec']['min'], fastest['tile']['min']
            modes[mode]['fastest'] = fastest
            log(f'H4 {mode}: the tile kernel bit-equal to the plain version '
                f'too; fastest calls vec {vec:.4f} ms ({vec / b:.2f}x its '
                f'bound), tile {tile:.4f} ms ({tile / b:.2f}x), vec/tile '
                f'{vec / tile:.4f}')
            if rotates and not vec < tile:
                fail(f'H4 {mode}: the vec kernel ({vec:.4f} ms) is not '
                     f'faster than the tile kernel ({tile:.4f} ms)')
            if not rotates:
                ref_ms = H4_TILE_REF_MS[mode]
                log(f'H4 {mode}: vec {vec / ref_ms:.4f} of the tile '
                    f'kernel\'s earlier {ref_ms} ms on {REF_CARD} (logged '
                    f'only; this card: {card})')
                if not vec <= 1.03 * tile:
                    fail(f'H4 {mode}: the vec kernel took {vec / tile:.4f} '
                         'of the tile kernel\'s time in this run (gate: '
                         'within 3%)')
        del args, xs, got, ref
        torch.cuda.empty_cache()
    return modes


def _leaf_pairs(got, ref, path=()):
    for k, v in ref.items():
        if isinstance(v, dict):
            yield from _leaf_pairs(got[k], v, path + (k,))
        else:
            yield '.'.join(path + (k,)), got[k], v


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _profile(run, out_dir, table, what):
    """Device time by kernel over one call of ``run``, as a table in
    ``out_dir/table``."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    stats = prof.key_averages()
    # device time of the kernels and copies themselves: CPU-side ops also
    # carry the device time of what they launch, and CUPTI's "Command
    # Buffer Full" is the host waiting for room in the launch queue
    busy = sum(e.self_device_time_total for e in stats
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation
               and e.key != 'Command Buffer Full') / 1e3
    wall = start.elapsed_time(end)
    with open(os.path.join(out_dir, table), 'w') as f:
        f.write(stats.table(sort_by='self_device_time_total', row_limit=40))
    log(f'profiled {what}: device busy {busy:.2f} ms of {wall:.2f} ms '
        f'({1 - busy / wall:.1%} idle); table in {out_dir}/{table}')


if __name__ == '__main__':
    main(sys.argv[1:])
