"""The yardstick's arithmetic: the card's peaks, the least time of a piece
of work, the operations and bytes of the attention kernels from a batch's
sequence lengths, and the model's operations per token.

The attention counts are those the repository's ``chip_smoke.py`` used for
H1 and H2 (``bound``, ``flash_work``, ``flash_bwd_work``) at the time this
benchmark was written, taken from segment lengths instead of tensors; the
model's operations are its MFU's (6·N·tokens + 3.5·attention forward
operations for a step, 2·N·tokens + the attention forward's for a
forward)."""

from __future__ import annotations

import math

# NVIDIA H100 SXM, dense rates at the 700 W limit (NVIDIA's data sheet)
BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
# the kernels' tiles, for the bytes of their block spans
BLOCK_Q = 128
BLOCK_KV = 64


def bound_s(nbytes: float, flops: float) -> float:
    """The least seconds: the larger of the bytes' and the operations'."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)


def pair_sum(lengths) -> float:
    """Σ n² over the sequences: the (query, key) pairs attention needs."""
    return float(sum(float(n) ** 2 for n in lengths))


def flash_fwd_work(lengths, heads: int, head_dim: int, total=None):
    """H1's ``(bytes, flops)`` for one launch: q, k, v read and o written
    once in bf16, the fp32 lse written, segment ids and block spans read;
    2·2·D operations per same-sequence pair and head."""
    T = int(total if total is not None else sum(lengths))
    nbytes = 4 * T * heads * head_dim * 2 + heads * T * 4 + T * 4 \
        + 2 * math.ceil(T / BLOCK_Q) * 4
    return nbytes, 4.0 * head_dim * heads * pair_sum(lengths)


def flash_bwd_work(lengths, heads: int, head_dim: int, total=None):
    """H2's ``(bytes, flops)`` for one launch: q, k, v, do read and dq, dk,
    dv written once, lse and delta read, ids and both passes' spans read;
    five products of 2·D operations per pair and head."""
    T = int(total if total is not None else sum(lengths))
    spans = 2 * math.ceil(T / BLOCK_Q) + 2 * math.ceil(T / BLOCK_KV)
    nbytes = 7 * T * heads * head_dim * 2 + 2 * heads * T * 4 + T * 4 \
        + spans * 4
    return nbytes, 10.0 * head_dim * heads * pair_sum(lengths)


def attn_fwd_flops(lengths, width: int, layers: int) -> float:
    """The attention forward's operations over every layer: 4·Σn²·C·L."""
    return 4.0 * pair_sum(lengths) * width * layers


def gemm_flops_per_token(arch) -> tuple:
    """``(per layer, head)``: the matrix products' operations a token
    needs in the forward (the embedding is a gather)."""
    d, F, V = arch.width, arch.ffn, arch.vocab
    mlp = 3 * d * F if arch.swiglu else 2 * d * F
    return 2.0 * (4 * d * d + mlp), 2.0 * (d * d + d * V)


def gemm_flops_infer(arch, tokens: int) -> float:
    layer, head = gemm_flops_per_token(arch)
    return tokens * (arch.layers * layer + head)


def gemm_flops_train(arch, tokens: int, recompute: bool) -> float:
    """Forward, the backward's two products each, the layers' forward
    again where the step recomputes them, and the embedding's gradient
    (one product with the token indicator)."""
    layer, head = gemm_flops_per_token(arch)
    fwd = arch.layers * layer + head
    again = arch.layers * layer if recompute else 0.0
    return tokens * (3 * fwd + again + 2.0 * arch.vocab * arch.width)


def model_flops_infer(n_params: int, tokens: int, attn: float) -> float:
    return 2.0 * n_params * tokens + attn


def model_flops_train(n_params: int, tokens: int, attn: float) -> float:
    return 6.0 * n_params * tokens + 3.5 * attn
