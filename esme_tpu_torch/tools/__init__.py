"""Probes of the attention kernels: the JAX package's ``tools/``
experiments K14-K17, each with its Pallas kernels ported to Hopper.

- :mod:`.fwd_T_experiment` — kernel H5, the transposed-score forward on
  token-minor operands (K14), beside H1;
- :mod:`.flash_variants` — H1's ablation modes (K17), what each pass of
  the forward costs;
- :mod:`.decompose_bwd` — H2's ablation modes (K15), the same for each
  backward kernel;
- :mod:`.profile_attn` — ceiling probes of H1's passes alone (K16; the
  streaming ones in a Hopper and a cp.async form);
- :mod:`.sm90_ab` — a variant of a Hopper source (H1's, H2's, H4's vec
  kernel, H8's streaming probes) timed against the source (no TPU
  counterpart; on the card only, with the form's name and the variant's
  path as its arguments).

Each of the first four runs as ``python -m esme_tpu_torch.tools.<name>``: on the card by
default (ESM2-650M's attention, H = 20, D = 64, bf16, on ``bench.py``'s
packed 50k-token batch), or with ``--device cpu`` through the plain
versions at a small size. Each prints one line per measurement.

This module holds what they share: ``bench.py``'s packing (the recipe of
the JAX tools' ``tune_flash2.make_inputs``, ``decompose_bwd.make_inputs``
and ``profile_attn.make_shape``: sequences of 100-1000 residues plus two
specials until the budget is within 1024 of full; here the tail is
padded as the model pads it, so the batch and its spans are the ones the
model's attention runs on), random inputs and the command line.
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace

import numpy as np
import torch

# ESM2-650M's attention and bench.py's batches: seed 0 for the inference
# batch (forward probes), seed 2 for the masked-LM train batch (backward
# probes); T pads 50,000 to 50,176.
HEADS, HEAD_DIM = 20, 64
BUDGET = 50_000
FWD_SEED, BWD_SEED = 0, 2
CPU_BUDGET = 2048
CUDA_REPS = 20

# Published H100 SXM peaks (dense): HBM rate, bf16 tensor-core rate, fp32
# rate outside the tensor cores (NVIDIA's data sheet), and the SFU's
# exponentials, 16 per SM per clock (3.9 T/s; Shah et al.,
# FlashAttention-3, 2024, section 3.1).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
SFU_EXP_PER_S = 3.9e12

# Gates of a kernel against its plain version on the same bf16 inputs on
# the card, as chip_smoke.py states them for H1 and H2: o within
# 2^-6 * max(|o|, 1/4) and lse within 1e-4 (H1); a gradient g within
# 2^-4 * max(|g|, rms g) (H2: p and ds round to bf16 before their
# products). An output that only sums the elements it touched (the `dma`
# and `nothing` modes) differs by fp32 summation order before one bf16
# rounding: within 2^-7 * max(|x|, rms x), an ulp of bf16.
FLASH_O_REL, FLASH_O_FLOOR, FLASH_LSE_ATOL = 2.0 ** -6, 0.25, 1e-4
FLASH_G_REL = 2.0 ** -4
SUM_REL = 2.0 ** -7

# The head dims at which the tools' Hopper forms are built: H5's
# token-minor layout of H1's kernel, and the modes of H6 and H7 (D = 64,
# on the form H1's and H2's routes gave 64). H1 and H2 take 16 and 24 on
# their Hopper forms too, but these are not built there, so at 16 and 24
# the tools keep the mma.sync forms.
SM90_HEAD_DIMS = (32, 64, 128)


def fwd_route(head_dim: int) -> str:
    """The form of H1 the tools take by default at this head dim."""
    return 'flash_fwd_sm90' if head_dim in SM90_HEAD_DIMS else 'flash_fwd'


def bwd_route(head_dim: int) -> str:
    """The form of H2 the tools take by default at this head dim."""
    return 'flash_bwd_sm90' if head_dim in SM90_HEAD_DIMS else 'flash_bwd'


def packed_cu_lens(budget: int, seed: int) -> np.ndarray:
    """``bench.py``'s packed batch: cumulative lengths of sequences of
    100-1000 residues plus two specials, drawn from ``seed`` until the
    total is within 1024 of ``budget``."""
    rng = np.random.default_rng(seed)
    lens, total = [], 0
    while total < budget - 1024:
        n = int(rng.integers(100, 1000))
        lens.append(n + 2)
        total += n + 2
    return np.cumsum([0, *lens]).astype(np.int32)


def attention_batch(budget: int = BUDGET, seed: int = FWD_SEED,
                    heads: int = HEADS, head_dim: int = HEAD_DIM,
                    device='cuda', dtype=torch.bfloat16, grads: bool = False):
    """Random q, k, v (and ``do`` with ``grads``) ``(T, H·D)`` on the
    packed batch of ``(budget, seed)``, with the segment ids, positions
    and every kernel span the model's flash path makes for it
    (``models/esm.py:pad_flat_meta``). Values are normal, drawn from a
    generator on ``device`` seeded with ``seed``."""
    from ..models.esm import packed_meta, pad_flat_meta
    dev = torch.device(device)
    cu = packed_cu_lens(budget, seed)
    seg, pos, spans = pad_flat_meta(*packed_meta(
        torch.as_tensor(cu, device=dev), budget))
    T = seg.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def randn():
        return torch.randn((T, heads * head_dim), generator=gen,
                           device=dev).to(dtype)
    q, k, v = randn(), randn(), randn()
    return SimpleNamespace(q=q, k=k, v=v, do=randn() if grads else None,
                           seg=seg, pos=pos, spans=spans, cu=cu, T=T,
                           budget=budget, H=heads, D=head_dim, device=dev)


def pad_rows(x, n: int, value=0):
    """``x`` padded along dim 0 to ``n`` rows of ``value``."""
    if x.shape[0] == n:
        return x
    pad = x.new_full((n - x.shape[0], *x.shape[1:]), value)
    return torch.cat([x, pad])


def thd_to_hdt(x2, heads: int):
    """``(T, H·D)`` -> token-minor ``(H, D, T)``, a copy."""
    T = x2.shape[0]
    return x2.view(T, heads, -1).permute(1, 2, 0).contiguous()


def hdt_to_thd(xT):
    """Token-minor ``(H, D, T)`` -> ``(T, H·D)``, a copy."""
    H, D, T = xT.shape
    return xT.permute(2, 0, 1).reshape(T, H * D)


def parse_args(argv, description: str, libraries=()):
    """``--device {cuda,cpu}``, and from it the batch, the timed calls
    and the dtype: 50,000 tokens, 20 calls, bf16 on the card (raise
    without one); 2,048 tokens, 1 call, fp32 on the CPU. With
    ``libraries``, also ``--library``, one of them (None: every one)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    if libraries:
        p.add_argument('--library', choices=libraries, default=None)
    args = p.parse_args(argv)
    on_card = args.device == 'cuda'
    if on_card and not torch.cuda.is_available():
        raise RuntimeError('this tool runs the kernels on a CUDA card; pass '
                           "--device cpu to run the plain versions here")
    args.budget = BUDGET if on_card else CPU_BUDGET
    args.reps = CUDA_REPS if on_card else 1
    args.dtype = torch.bfloat16 if on_card else torch.float32
    return args


def segment_pairs(seg_ids) -> float:
    """Σ n² over the segments: the same-segment (q, k) pairs per head."""
    counts = torch.unique_consecutive(seg_ids, return_counts=True)[1]
    return float((counts.double() ** 2).sum().item())


def steps(kstart, kend) -> int:
    """The (q block, k tile) steps of a span list, per head."""
    return int((kend - kstart).sum().item())


def bound_ms(nbytes: float = 0.0, flops: float = 0.0, exps: float = 0.0,
             fp32_ops: float = 0.0):
    """The least time the card could take for this work, and what bounds
    it: bytes at the HBM rate, bf16 products at the tensor-core rate,
    exponentials at the SFU rate, other fp32 arithmetic at the fp32 rate.
    Returns ``(ms, 'bytes' or 'operations')``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / BF16_FLOP_PER_S, exps / SFU_EXP_PER_S,
                fp32_ops / FP32_FLOP_PER_S)
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def scaled_error(got, ref, rel: float, floor=None):
    """``(max|got - ref|, its largest share of the gate)``: the gate is
    ``rel * max(|ref|, floor)`` element by element, with ``floor`` the
    reference's rms where None. Elements where both are NaN agree; a NaN
    on one side only, or an infinity, has share inf."""
    a, b = got.float(), ref.float()
    both_nan = a.isnan() & b.isnan()
    a = torch.where(both_nan, 0.0, a)
    b = torch.where(both_nan, 0.0, b)
    d = (a - b).abs()
    if floor is None:
        floor = b.square().mean().sqrt().item()
    gate = rel * b.abs().clamp_min(floor)
    share = torch.where(d == 0, 0.0, d / gate)
    share = torch.where(d.isnan() | d.isinf(), float('inf'), share)
    return d.nan_to_num(float('inf')).max().item(), share.max().item()


def check_cuda_tensors(what: str, tensors, shape, dtype=torch.bfloat16):
    """Each ``(name, tensor)`` is a contiguous, 16-byte aligned CUDA
    tensor of ``shape`` and ``dtype``, all on one device."""
    dev = tensors[0][1].device
    if dev.type != 'cuda':
        raise ValueError(f'{what}: unsupported device {dev}')
    for name, t in tensors:
        if t.dtype != dtype:
            raise TypeError(f'{what}: the CUDA kernel takes {dtype}; {name} '
                            f'is {t.dtype} (the CPU runs the plain version)')
        if tuple(t.shape) != tuple(shape) or t.device != dev \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f'{what}: {name} must be a contiguous, 16-byte '
                             f'aligned {tuple(shape)} tensor on {dev}')
