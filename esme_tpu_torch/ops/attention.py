"""Segment-masked multi-head attention over packed token layouts.

Counterpart of ``esme_tpu/ops/attention.py``: non-causal self-attention
over a flat ``(T, H, D)`` layout where tokens attend only within their
own segment (flash-attn's varlen kernel, reference:
esme/attention.py:112-124). Two implementations:

* :func:`attention_reference` — einsum + mask, O(T²) memory; the
  numerics oracle and small-input path.
* :func:`~esme_tpu_torch.ops.flash.flash_segment_attention` — the
  segment-flash kernels H1 (forward) and H2 (backward) in
  :mod:`esme_tpu_torch.ops.flash`.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        seg_ids: torch.Tensor) -> torch.Tensor:
    """Masked softmax attention with fp32 scores and softmax.

    ``q, k, v``: ``(T, H, D)``; ``seg_ids``: ``(T,)``. Returns
    ``(T, H, D)`` in the dtype of ``q``.
    """
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum('thd,shd->hts', q.float(), k.float()) * scale
    mask = seg_ids[:, None] == seg_ids[None, :]
    scores = torch.where(mask[None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum('hts,shd->thd', probs.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def segment_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      seg_ids: torch.Tensor, *, impl: str = 'auto',
                      block_q: int | None = None, block_k: int | None = None,
                      max_seqlen: int | None = None,
                      layout: str = 'thd') -> torch.Tensor:
    """Dispatch between the einsum reference and segment-flash attention,
    both with a gradient. ``impl='auto'`` picks flash (kernels H1 and H2
    on a CUDA tensor, their plain versions on a CPU tensor).

    ``layout='thd'`` takes and returns ``(T, H, D)``, ``'htd'``
    ``(H, T, D)``. ``block_q``/``block_k`` default to the flash kernel's
    own tiles, the only ones it takes; ``max_seqlen`` is accepted and
    unused (see :func:`~esme_tpu_torch.ops.flash.flash_segment_attention`).
    """
    if impl == 'auto':
        impl = 'flash'
    if impl == 'reference':
        if layout == 'htd':
            q, k, v = (t.transpose(0, 1) for t in (q, k, v))
            return attention_reference(q, k, v, seg_ids).transpose(0, 1)
        return attention_reference(q, k, v, seg_ids)
    if impl == 'flash':
        from .flash import BLOCK_K, BLOCK_Q, flash_segment_attention
        return flash_segment_attention(
            q, k, v, seg_ids, block_q=BLOCK_Q if block_q is None else block_q,
            block_k=BLOCK_K if block_k is None else block_k,
            max_seqlen=max_seqlen, layout=layout)
    raise ValueError(f'unknown attention impl: {impl}')
