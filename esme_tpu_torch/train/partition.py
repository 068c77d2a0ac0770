"""Trainable and frozen leaves of a params tree.

Counterpart of ``esme_tpu/train/partition.py:20-36`` (the functional form
of the reference's ``mark_only_lora_as_trainable``, reference:
esme/lora.py:97-108). JAX differentiates only the trainable leaves and
passes the frozen ones to the loss as plain arguments; in torch's idiom a
leaf's mask flag becomes its ``requires_grad``
(:func:`esme_tpu_torch.train.trainer.train_views`): a frozen leaf gets no
gradient and joins no optimizer, so it keeps its bits, and a LoRA step
computes adapter-sized gradients only.

The JAX module's ``split_by_mask``/``merge_leaves`` have no counterpart:
the trainers never take the leaves apart, they only read the mask,
expanded here to a bool at every leaf.
"""

from __future__ import annotations


def expand_mask(mask, tree):
    """``mask`` over ``tree``'s structure with a bool at every leaf: a bool
    at a subtree covers its leaves, None trains everything. Raises
    ``ValueError`` where the two structures differ."""
    if mask is None or isinstance(mask, bool):
        flag = True if mask is None else mask
        if isinstance(tree, dict):
            return {k: expand_mask(flag, v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [expand_mask(flag, v) for v in tree]
        return flag
    if isinstance(tree, dict) and isinstance(mask, dict):
        if set(mask) != set(tree):
            raise ValueError('the trainable mask does not match the params: '
                             f'keys {sorted(set(mask) ^ set(tree))}')
        return {k: expand_mask(mask[k], v) for k, v in tree.items()}
    raise ValueError('the trainable mask does not match the params: '
                     f'{type(mask).__name__} where the params have '
                     f'{type(tree).__name__}')

