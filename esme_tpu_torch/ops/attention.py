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

:func:`attention_rect` is the rectangular form (local queries over
another key/value stream with ids of its own), the einsum route of
context parallelism; its kernel route is
:func:`~esme_tpu_torch.ops.flash.flash_rect_attention` (H9).
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


def attention_rect(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   seg_q: torch.Tensor, seg_k: torch.Tensor,
                   block_k: int = 1024,
                   scale: float | None = None) -> torch.Tensor:
    """Rectangular segment-masked attention with an online softmax
    (``esme_tpu/ops/attention.py:56-110``): local queries ``q (Tq, H, D)``
    over keys/values ``(Tk, H, D)`` with per-side segment ids, one
    ``block_k`` tile of keys at a time, so memory stays
    ``O(H · Tq · block_k)``. Scores, the running max and sum and the
    accumulator are fp32; p is rounded to q's dtype before the product
    with v, as JAX rounds it. Keys past Tk are padded with zeros and the
    id ``max(seg_q) + max(seg_k) + 1``, which no query carries. Returns
    ``(Tq, H, D)`` in q's dtype.
    """
    Tq, H, D = q.shape
    Tk = k.shape[0]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    pad = (-Tk) % block_k
    if pad:
        k = torch.cat([k, k.new_zeros((pad, H, D))])
        v = torch.cat([v, v.new_zeros((pad, H, D))])
        seg_k = torch.cat([seg_k, (seg_q.max() + seg_k.max() + 1)
                           .to(seg_k.dtype).expand(pad)])
    qf = q.float()
    m = torch.full((H, Tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((H, Tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((H, Tq, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, Tk + pad, block_k):
        kt = k[k0:k0 + block_k].float()
        vt = v[k0:k0 + block_k].float()
        s = torch.einsum('thd,shd->hts', qf, kt) * scale
        mask = seg_q[:, None] == seg_k[None, k0:k0 + block_k]
        s = torch.where(mask[None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            'hts,shd->htd', p.to(q.dtype).float(), vt)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(0, 1).to(q.dtype)


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
