"""Packed-layout helpers: segment ids and positions from ``cu_lens``.

Counterpart of ``esme_tpu/ops/segment.py``. Every op takes per-token
segment ids: attention masks cross-segment pairs. These helpers derive
that metadata from the reference's ``(cu_lens, max_len)`` contract
(reference: esme/alphabet.py:148-183).
"""

from __future__ import annotations

import torch

# Fake-tail segments are chunked to one 256-token tile: a single fake
# segment spanning a long padding tail would make every tail q block's
# k span cover the whole tail. With 256-token chunks, tail spans are as
# short as those of real short sequences.
TAIL_CHUNK = 256


def segment_ids_from_cu_lens(cu_lens: torch.Tensor, total: int
                             ) -> torch.Tensor:
    """Per-token segment index ``(total,)`` int32 from cumulative lengths.

    Token ``t`` in ``[cu_lens[i], cu_lens[i+1])`` gets id ``i``. Tokens
    past ``cu_lens[-1]`` (the padding tail) get ids past every real
    segment, advancing every :data:`TAIL_CHUNK` tokens, so they form
    fake segments that never attend real tokens.
    """
    cu = cu_lens.to(torch.int64)
    t = torch.arange(total, dtype=torch.int64, device=cu.device)
    seg = torch.searchsorted(cu[1:].contiguous(), t, right=True)
    tail = t >= cu[-1]
    chunk = torch.div(t - cu[-1], TAIL_CHUNK, rounding_mode='floor')
    return torch.where(tail, seg + chunk, seg).to(torch.int32)


def positions_from_cu_lens(cu_lens: torch.Tensor, total: int,
                           seg_ids: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Within-sequence position of each flat token, int32."""
    if seg_ids is None:
        seg_ids = segment_ids_from_cu_lens(cu_lens, total)
    cu = cu_lens.to(torch.int64)
    starts = cu[torch.clamp(seg_ids.to(torch.int64), max=cu.shape[0] - 1)]
    t = torch.arange(total, dtype=torch.int64, device=cu.device)
    return (t - starts).to(torch.int32)


def padded_to_flat_meta(batch: int, seq_len: int, valid: torch.Tensor):
    """Segment ids and positions of a padded ``(B, L)`` batch viewed as a
    flat ``(B*L,)`` packed vector (``esme_tpu/ops/segment.py:58-72``):
    the valid tokens of row ``b`` form segment ``b`` and pad positions get
    the fake id ``B``; positions are the column index. Returns
    ``(seg_ids, pos_ids)``, int32."""
    dev = valid.device
    row = torch.arange(batch, dtype=torch.int32,
                       device=dev).repeat_interleave(seq_len)
    col = torch.arange(seq_len, dtype=torch.int32, device=dev).repeat(batch)
    seg_ids = torch.where(valid.reshape(-1).bool(), row,
                          torch.full_like(row, batch))
    return seg_ids, col


def unpad_gather_meta(valid: torch.Tensor):
    """Repack metadata for a padded ``(B, L)`` batch: valid tokens move
    to the front in row-major order, pads to the tail (flash-attn's
    ``unpad_input``, reference: esme/esm.py:238). Segment ids become
    monotonic, so the flash kernel's per-block spans are tight. Each pad
    token gets its own fake segment id (``B + k``).

    Returns ``(src, dst, seg_ids, pos_ids)``: ``src[j]`` is the flat
    source index feeding packed slot ``j`` and ``dst[i]`` the packed
    slot of flat token ``i``.
    """
    B, L = valid.shape
    flat = valid.reshape(-1)
    n = flat.shape[0]
    dev = valid.device
    nvalid = flat.sum()
    cum_v = torch.cumsum(flat.to(torch.int64), 0)
    cum_p = torch.cumsum((~flat).to(torch.int64), 0)
    dst = torch.where(flat, cum_v - 1, nvalid + cum_p - 1)
    src = torch.empty(n, dtype=torch.int64, device=dev)
    src[dst] = torch.arange(n, dtype=torch.int64, device=dev)
    slot = torch.arange(n, dtype=torch.int64, device=dev)
    row = torch.div(src, L, rounding_mode='floor')
    seg_ids = torch.where(slot < nvalid, row, B + (slot - nvalid))
    # within-sequence position = rank among the row's valid tokens
    pos_flat = (torch.cumsum(valid.to(torch.int64), 1) - 1).reshape(-1)
    pos_ids = torch.where(slot < nvalid, pos_flat[src],
                          torch.zeros_like(slot))
    return (src.to(torch.int32), dst.to(torch.int32),
            seg_ids.to(torch.int32), pos_ids.to(torch.int32))


def segment_lengths(cu_lens: torch.Tensor) -> torch.Tensor:
    """Each segment's length from cumulative lengths
    (``esme_tpu/ops/segment.py:114-115``)."""
    return cu_lens[1:] - cu_lens[:-1]
