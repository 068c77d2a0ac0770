"""Long-context extension of the learned-position models (ESM1b, ESM1v).

Counterpart of ``esme_tpu/extend.py``. The reference extends ESM1b/1v
from 1024 to 4096 positions by copying the old table into a larger one
and training only ``embed_positions``
(reference: workflow/positional_emb/train_positional.py:42-56); rotary
models need nothing.
"""

from __future__ import annotations

from dataclasses import replace

import torch


def extend_positions(model, new_max_positions: int, rng=0,
                     std: float = 0.02):
    """Grow the learned position table to ``new_max_positions + 2`` rows
    and ``config.learned_positions`` with it, in place; returns the model.

    The old rows are copied; the new rows are ``std``-scaled normals drawn
    in fp32 on the table's device from a ``torch.Generator`` seeded by
    ``rng`` (an int; or a Generator), then cast to the table's dtype, as
    a fresh table is initialised. They are not JAX's bits."""
    cfg = model.config
    if cfg.learned_positions is None:
        raise ValueError('extend_positions only applies to learned-position '
                         'models')
    old = model.params['embed_positions']
    new_rows = new_max_positions + 2
    if new_rows <= old.shape[0]:
        raise ValueError(f'{new_max_positions} <= current '
                         f'{cfg.learned_positions}')
    gen = rng if isinstance(rng, torch.Generator) else \
        torch.Generator(device=old.device).manual_seed(int(rng))
    table = (torch.randn((new_rows, old.shape[1]), dtype=torch.float32,
                         device=old.device, generator=gen) * std) \
        .to(old.dtype)
    table[:old.shape[0]] = old
    model.params = {**model.params, 'embed_positions': table}
    model.config = replace(cfg, learned_positions=new_max_positions)
    return model


def positions_only_mask(params: dict) -> dict:
    """The trainable mask, a tree of bools over ``params``, that trains
    only ``embed_positions`` (reference:
    workflow/positional_emb/train_positional.py:42-56); for
    ``MaskedPLM(trainable_mask=...)``."""
    def falses(tree):
        return {k: falses(v) if isinstance(v, dict) else False
                for k, v in tree.items()}
    return {k: (k == 'embed_positions') if not isinstance(v, dict)
            else falses(v) for k, v in params.items()}
