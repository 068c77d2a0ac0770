"""Rotary + segment-flash attention over the projections' layout, with
its gradient.

Counterpart of ``esme_tpu/ops/fused_attn.py``: ``(T, H·D)`` q/k/v ->
RoPE on q and k (kernel H3) -> segment-flash forward (kernel H1) ->
``(T, H·D)`` output, as one autograd boundary. The backward runs
``delta = rowsum(do·o)`` (plain PyTorch, fp32), the segment-flash
backward (kernel H2) and the counter-rotation ``Rᵀ`` of dq and dk
(kernel H3 with ``inverse=True``). On the TPU this needed relayout
kernels on either side of the flash kernels; here H1 and H2 read and
write the ``(T, H·D)`` layout themselves.

What the forward saves: the rotated q and k (the same bytes as the
projections the JAX function saves), v, o and the fp32 lse. Saving the
rotated pair spares the backward one H3 launch per layer: it runs H3
once, for ``Rᵀ``.

JAX's ``ESME_FLASH_IMPL=v2`` route (an A/B switch of TPU tilings,
``esme_tpu/ops/fused_attn.py:71-93``) is no option here. Its steps are
functions of their own, ``_split_call_t`` and ``_merge_call`` in
``ops/headsplit.py`` around ``ops/flash_v2.py:fwd_v2``, and composed
they give this function's o.
"""

from __future__ import annotations

import torch

from .flash import (BLOCK_K, BLOCK_Q, _release, _stashed, attention_delta,
                    check_tiles, flash_spans, segment_flash_bwd,
                    segment_flash_fwd)
from .headsplit import rotary_qk


def _forward(q2, k2, v2, cos, sin, seg_ids, num_heads, spans, stash=None):
    qr, kr = rotary_qk(q2, k2, cos, sin, num_heads)
    o, lse = _stashed(stash, lambda: segment_flash_fwd(
        qr, kr, v2, seg_ids, spans[0], spans[1], num_heads))
    return qr, kr, o, lse


class _FusedRotaryFlash(torch.autograd.Function):
    """The autograd boundary; ``cos``, ``sin``, ``seg_ids`` and the spans
    get no gradient. The kernels are looked up in this module at call
    time, so a caller may swap in their plain versions. With a ``stash``
    (``ops/flash.py:AttnStash``, ``remat='attn'``) a checkpointed layer's
    recompute still rotates q and k (H3: the backward needs them) but
    takes o and lse from the stash instead of launching H1."""

    @staticmethod
    def forward(ctx, q2, k2, v2, cos, sin, seg_ids, num_heads, spans, stash):
        qr, kr, o, lse = _forward(q2, k2, v2, cos, sin, seg_ids, num_heads,
                                  spans, stash)
        ctx.save_for_backward(qr, kr, v2, o, lse, cos, sin, seg_ids,
                              *spans)
        ctx.num_heads = num_heads
        ctx.stash = stash
        return o

    @staticmethod
    def backward(ctx, do2):
        qr, kr, v2, o, lse, cos, sin, seg_ids, *spans = ctx.saved_tensors
        _release(ctx.stash)
        H = ctx.num_heads
        do2 = do2.to(o.dtype).contiguous()
        delta = attention_delta(o, do2, H)
        dq, dk, dv = segment_flash_bwd(qr, kr, v2, do2, lse, delta, seg_ids,
                                       *spans, H)
        # RoPE is orthogonal: the gradient of R x is R^T dy
        dq2, dk2 = rotary_qk(dq, dk, cos, sin, H, inverse=True)
        return dq2, dk2, dv, None, None, None, None, None, None


def fused_rotary_flash(q2, k2, v2, cos, sin, seg_ids, num_heads: int,
                       block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
                       max_seqlen: int | None = None,
                       interpret: bool | None = None,
                       num_jobs: int | None = None, *, spans=None,
                       stash=None):
    """RoPE + segment-flash attention with a gradient, as
    ``esme_tpu``'s function of the same name.

    Args:
        q2, k2, v2: ``(T, H·D)`` projection outputs.
        cos, sin: ``(T, D)`` RoPE tables.
        seg_ids: ``(T,)`` int32 segment ids.
        num_heads: H.
        block_q, block_k: the flash kernel's tiles; only its own
            (``BLOCK_Q`` x ``BLOCK_K``, 128 x 64) are taken.
        max_seqlen, interpret, num_jobs: accepted for call compatibility
            with the JAX signature and unused: the kernels walk each
            block's exact span on the card, so they need no static span
            cap and no job budget, and the device decides between the
            kernels and the plain versions.
        spans: :func:`~esme_tpu_torch.ops.flash.flash_spans` for these
            ``seg_ids``; computed here when None. The model computes
            them once per forward.
        stash: the checkpointed layer's ``AttnStash`` under
            ``remat='attn'`` (``ops/flash.py``), or None.
    Returns:
        ``(T, H·D)`` attention output.
    """
    check_tiles('fused_rotary_flash', block_q, block_k)
    spans = tuple(flash_spans(seg_ids) if spans is None else spans)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q2, k2, v2)):
        return _FusedRotaryFlash.apply(q2, k2, v2, cos, sin, seg_ids,
                                       num_heads, spans, stash)
    return _forward(q2, k2, v2, cos, sin, seg_ids, num_heads, spans)[2]
