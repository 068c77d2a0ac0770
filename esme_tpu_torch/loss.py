"""Losses over masked positions.

Counterpart of ``esme_tpu/loss.py`` (reference: esme/loss.py:5-54):
instead of gathering the masked positions, every position is weighted
by the mask and the sum is divided by ``max(count, 1)``. Everything is
computed in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _masked_mean(per: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    w = weight.to(torch.float32)
    return (per * w).sum() / w.sum().clamp_min(1.0)


def nll_loss(log_probs: torch.Tensor, targets: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Mean NLL over masked positions given log-probs ``(T, V)``."""
    ll = log_probs.float().gather(-1, targets.long()[:, None])[:, 0]
    return -_masked_mean(ll, mask)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over positions where ``mask`` is True.
    ``logits`` ``(T, V)``, ``targets`` ``(T,)``, ``mask`` ``(T,)`` bool."""
    return nll_loss(torch.log_softmax(logits.float(), dim=-1), targets, mask)


def mse_loss(pred: torch.Tensor, target: torch.Tensor,
             weight: torch.Tensor | None = None) -> torch.Tensor:
    """MSE with optional per-element weights (for padded segments)."""
    d = (pred.float() - target.float()) ** 2
    return d.mean() if weight is None else _masked_mean(d, weight)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    weight: torch.Tensor | None = None) -> torch.Tensor:
    """Binary cross-entropy on logits, in the stable form
    ``max(z, 0) - z t + log1p(exp(-|z|))``."""
    per = F.binary_cross_entropy_with_logits(
        logits.float(), targets.float(), reduction='none')
    return per.mean() if weight is None else _masked_mean(per, weight)
