"""Segment pooling over the packed layout.

Counterpart of ``esme_tpu/ops/pooling.py:21-76`` (reference:
esme/pooling.py:8-228): the mean of each segment's tokens, and pooling by
learned queries that attend each segment's tokens through a per-segment
softmax. Plain PyTorch: the JAX functions reach no Pallas kernel.

Tokens whose segment id is ``num_segments`` or more (the packed batch's
padding tail) are dropped. Segment sums are products with the ``(S, T)``
segment indicator in fp32 (``segment_sum``): a scatter-add of floats
(``index_add_``) adds with atomics on the card, in an order that changes
from call to call, where a product gives the same bits every call, so a
prediction is reproducible. The segment max is a ``scatter_reduce``
(``'amax'``), exact in any order.
"""

from __future__ import annotations

import torch

from .linear import linear


def _segments(seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``seg_ids`` as int64, the dropped tokens' ids set to
    ``num_segments``."""
    seg = seg_ids.to(torch.int64)
    return torch.clamp(seg, max=num_segments)


def segment_sum(x: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """fp32 sums of ``x`` ``(T, ...)`` over each segment's tokens ->
    ``(num_segments, ...)`` (JAX's ``segment_sum``; a token whose id is
    ``num_segments`` or more is dropped)."""
    rows = torch.arange(num_segments, device=x.device)
    ind = (_segments(seg_ids, num_segments)[None, :] == rows[:, None])
    flat = x.reshape(x.shape[0], -1).to(torch.float32)
    return (ind.to(torch.float32) @ flat).reshape(num_segments,
                                                  *x.shape[1:])


def partition_mean_pool(x: torch.Tensor, seg_ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """Mean of ``x`` ``(T, D)`` within each segment -> ``(S, D)`` in
    ``x``'s dtype: fp32 sums over counts floored at 1 (reference:
    esme/pooling.py:44-69)."""
    sums = segment_sum(x, seg_ids, num_segments)
    ones = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    counts = segment_sum(ones, seg_ids, num_segments).clamp_min(1.0)
    return (sums / counts[:, None]).to(x.dtype)


def attention_pool(cls_q: torch.Tensor, x: torch.Tensor, k_params: dict,
                   seg_ids: torch.Tensor, num_segments: int,
                   num_heads: int) -> torch.Tensor:
    """Cross-attention pooling: per segment, the ``C`` learned queries
    ``cls_q`` ``(C, D)`` attend that segment's tokens, per head (reference:
    esme/pooling.py:72-136). Keys are ``linear(x, k_params)``, values ``x``
    itself; scores, the softmax and the weighted sums in fp32. An empty
    segment gets max 0 and its sum floored at 1e-30, so it pools to 0, as
    in JAX. Returns ``(S, C, D)`` in ``x``'s dtype.

    The softmax's max is a stabiliser that cancels in exact arithmetic;
    it takes no gradient here (JAX differentiates through it, which moves
    the gradient by rounding only)."""
    T, D = x.shape
    C = cls_q.shape[0]
    Dh = D // num_heads
    scale = 1.0 / (Dh ** 0.5)
    S = num_segments

    k = linear(x, k_params).reshape(T, num_heads, Dh)
    q = cls_q.reshape(C, num_heads, Dh)
    v = x.reshape(T, num_heads, Dh)
    s = torch.einsum('thd,chd->tch', k.float(), q.float()) * scale

    # segment max over t; the dropped tokens take a row of their own (S),
    # so each token's exp is at most 1
    seg = _segments(seg_ids, S)
    idx = seg[:, None, None].expand(T, C, num_heads)
    m = torch.full((S + 1, C, num_heads), float('-inf'), device=x.device)
    m = m.scatter_reduce(0, idx, s.detach(), 'amax', include_self=False)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m[seg])
    z = segment_sum(p, seg, S).clamp_min(1e-30)
    pv = segment_sum(p[:, :, :, None] * v[:, None, :, :].float(), seg, S)
    out = pv / z[:, :, :, None]
    return out.reshape(S, C, D).to(x.dtype)
