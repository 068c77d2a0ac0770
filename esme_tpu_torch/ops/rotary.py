"""Rotary position embeddings over packed (varlen) layouts.

Counterpart of ``esme_tpu/ops/rotary.py``. Angles are computed from the
per-token within-sequence positions in fp32 and then cast to the
activation dtype (reference: esme/rotary.py:110-149). :func:`apply_rotary`
is also the plain version of the RoPE kernel
(:func:`esme_tpu_torch.ops.headsplit.rotary_qk`).
"""

from __future__ import annotations

import torch


def rotary_inv_freq(dim: int, base: float = 10000.0,
                    device=None) -> torch.Tensor:
    """``1 / base^(2i/dim)`` in fp32 (reference: esme/rotary.py:110-114)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (base ** exps)


def rotary_cos_sin(pos_ids: torch.Tensor, dim: int, base: float = 10000.0,
                   dtype=torch.bfloat16):
    """Per-token cos/sin of shape ``(T, dim)``, halves repeated."""
    inv_freq = rotary_inv_freq(dim, base, device=pos_ids.device)
    freqs = pos_ids.to(torch.float32)[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """(reference: esme/rotary.py:17-19)"""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate ``x`` of shape ``(T, H, D)`` with per-token cos/sin
    ``(T, D)`` (reference: esme/rotary.py:22-43). Pass ``-sin`` for the
    inverse rotation Rᵀ."""
    cos = cos[:, None, :]
    sin = sin[:, None, :]
    return x * cos + rotate_half(x) * sin


def apply_rotary_qk(q: torch.Tensor, k: torch.Tensor, pos_ids: torch.Tensor,
                    base: float = 10000.0):
    """Apply RoPE to q and k ``(T, H, D)`` with packed per-token positions
    (``esme_tpu/ops/rotary.py:55-61``; reference: esme/rotary.py:151-165).
    Plain PyTorch; the model path rotates with the RoPE kernel."""
    cos, sin = rotary_cos_sin(pos_ids, q.shape[-1], base, dtype=q.dtype)
    return apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
