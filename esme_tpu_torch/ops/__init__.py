"""Neural ops over the packed flat-token layout: segment metadata,
rotary, attention (einsum reference and the segment-flash kernel),
LayerNorm and linear."""

from .segment import (padded_to_flat_meta, positions_from_cu_lens,
                      segment_ids_from_cu_lens, segment_lengths,
                      unpad_gather_meta)
from .rotary import apply_rotary, apply_rotary_qk, rotary_cos_sin
from .attention import attention_reference, segment_attention
