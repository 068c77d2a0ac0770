"""Segment-flash forward over head-major q and token-minor k/v.

Counterpart of ``esme_tpu/ops/flash_v2.py:fwd_v2``, whose TPU kernel
``_fwd_kernel_v2`` (K6) is K1 with one grid step per (head group, q
block) and an inner pipeline as long as the block's real k span. Kernel
H1 already has that schedule: each block walks its own k tiles
``[kstart, kend)`` and nothing else. So here the function is H4
(``ops/headsplit.py``) bringing q ``(H, T, D)`` and k, v ``(H, D, T)`` to
``(T, H·D)`` in one launch, H1 at its own tiles, and H4 splitting o back
to ``(H, T, D)``.
"""

from __future__ import annotations

import torch

from .flash import BLOCK_K, BLOCK_Q, block_spans, segment_flash_fwd
from .headsplit import relayout_heads


def fwd_v2(q, k, v, seg2d, segT, kstart, kend, *, block_q, block_k,
           head_block, scale, interpret, vmem_limit=None):
    """Segment-masked attention forward, as ``esme_tpu``'s ``fwd_v2``.

    Args:
        q: ``(H, T, D)``; k, v: token-minor ``(H, D, T)``.
        seg2d: ``(T, 1)`` segment ids (``segT``, the same ids as
            ``(1, T)``, is accepted for the signature).
        scale: the scores' scale.
        kstart, kend, block_q, block_k, head_block, vmem_limit: the TPU
            kernel's spans, tiles, head grouping and VMEM budget; accepted
            and unused. H1 computes its spans at its own 128 x 64 tiles
            from the segment ids.
        interpret: accepted and unused; the device decides between the
            kernels and their plain versions.
    Returns:
        ``o (H, T, D)`` in q's dtype and ``lse (H, T, 1)`` fp32. No
        gradient, as in JAX.
    """
    H, T, _ = q.shape
    seg = seg2d.reshape(T).to(torch.int32).contiguous()
    q2, k2, v2 = relayout_heads((q, k, v), ('htd', 'hdt', 'hdt'), 'thd', H)
    ks, ke = block_spans(seg, BLOCK_Q, BLOCK_K)
    o2, lse = segment_flash_fwd(q2, k2, v2, seg, ks, ke, H, scale=scale)
    o = relayout_heads((o2,), 'thd', 'htd', H)[0]
    return o, lse.reshape(H, T, 1)
