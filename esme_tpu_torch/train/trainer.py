"""Masked-LM training.

Counterpart of ``MaskedPLM`` in ``esme_tpu/train/trainer.py:45-258``
(reference: esme/trainer.py:8-44). The JAX class owns an optax
optimizer and a jitted step; this one owns a ``torch.optim`` optimizer
and runs the step eagerly:

* ``optax.adam`` -> ``torch.optim.Adam``; with ``weight_decay``,
  ``optax.adamw`` -> ``torch.optim.AdamW`` (the same decoupled decay);
* gradient accumulation as ``optax.MultiSteps``: the mean of
  ``grad_accum`` micro-batch gradients, one update every
  ``grad_accum``-th step;
* activation checkpointing from the model's ``checkpointing`` flag
  (``remat='full'``).

Every floating leaf trains (``esme_tpu/lora.py:178-215`` without
adapters). The optimizer's leaves are views of the model's params: each
layer's row of a stacked leaf is its own gradient target (see
``models/modules.py``) and is updated in place, so ``model.params``
always holds the trained weights.

Each step runs forward, loss, backward and update inside
:func:`~esme_tpu_torch.ops.linear.fp32_accumulation`: the weight and
input gradients are cuBLAS products too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..loss import cross_entropy
from ..models.esm import forward_flat, packed_meta
from ..models.modules import check_remat, layer_params, num_layers
from ..ops.linear import fp32_accumulation

_LATER = {
    'lora_only': 'LoRA adapters come with the fine-tuning slice',
    'trainable_mask': 'trainable masks come with the fine-tuning slice',
    'offload_optimizer': 'the host-offloaded optimizer comes with '
                         'ROADMAP.md Queue 1, item 17',
    'optimizer': 'optax optimizers have no counterpart; adam8bit comes '
                 'with the memory slice',
}


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree):
    items = tree.values() if isinstance(tree, dict) else tree
    for v in items:
        if isinstance(v, (dict, list)):
            yield from _leaves(v)
        else:
            yield v


def _trainable(t: torch.Tensor) -> torch.Tensor:
    """A leaf sharing ``t``'s storage that autograd differentiates
    (floating leaves only)."""
    if not t.is_floating_point():
        return t
    return t.detach().requires_grad_()


def train_views(params: dict) -> dict:
    """``params`` with every floating leaf replaced by a gradient target
    that shares its storage, and ``layers`` by a list of per-layer dicts
    of such targets (rows of the stacked leaves)."""
    out = {}
    for key, v in params.items():
        if key == 'layers':
            out[key] = [_map(_trainable, layer_params(v, i))
                        for i in range(num_layers(v))]
        elif isinstance(v, dict):
            out[key] = _map(_trainable, v)
        else:
            out[key] = _trainable(v)
    return out


def _grad_tree(views: dict) -> dict:
    """The gradients of :func:`train_views`' leaves, in the layout of
    the model's params (layers stacked on axis 0)."""
    def grad(t):
        return None if t.grad is None else t.grad.detach().clone()

    out = {}
    for key, v in views.items():
        if key == 'layers':
            per = [_map(grad, layer) for layer in v]
            out[key] = _map_stack(per)
        elif isinstance(v, dict):
            out[key] = _map(grad, v)
        else:
            out[key] = grad(v)
    return out


def _map_stack(per_layer: list):
    first = per_layer[0]
    if isinstance(first, dict):
        return {k: _map_stack([p[k] for p in per_layer]) for k in first}
    return torch.stack(per_layer)


def _tensor(x, dtype, device):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x) \
        .to(device=device, dtype=dtype)


class MaskedPLM:
    """Masked-LM training (reference: esme/trainer.py:8-44).

    Args:
        model: an :class:`esme_tpu_torch.models.esm._ESMBase` instance.
        learning_rate: Adam learning rate (reference default 1e-4).
        grad_accum: accumulate this many micro-batches per update.
        lora_only, train_lmhead: the JAX signature's LoRA options; the
            port has no adapters yet, so ``lora_only=True`` raises and
            every floating leaf trains.
        weight_decay: decoupled decay (AdamW) when non-zero.
        optimizer, trainable_mask, offload_optimizer: raise unless left
            at their defaults (later slices).
        attn_impl: the model's attention path ('auto'/'flash' run the
            kernels on the card, 'reference' the einsum).
        remat: the checkpointing policy when ``model.checkpointing``
            ('full'; 'attn' raises with checkpointing on until the memory
            slice, and is ignored without it, as in JAX).
    """

    def __init__(self, model, learning_rate: float = 1e-4,
                 grad_accum: int = 1, lora_only=None, train_lmhead=False,
                 weight_decay: float = 0.0, optimizer=None,
                 attn_impl: str = 'auto', trainable_mask=None,
                 offload_optimizer: bool = False, remat: str = 'full'):
        for name, value in (('lora_only', lora_only),
                            ('trainable_mask', trainable_mask),
                            ('offload_optimizer', offload_optimizer),
                            ('optimizer', optimizer)):
            if value not in (None, False):
                raise NotImplementedError(f'MaskedPLM({name}=...): '
                                          f'{_LATER[name]}')
        check_remat(remat, model.checkpointing)
        if grad_accum < 1:
            raise ValueError(f'grad_accum must be >= 1, got {grad_accum}')
        self.model = model
        self.attn_impl = attn_impl
        self.remat = remat
        self.grad_accum = int(grad_accum)
        self.step = 0
        self._views = train_views(model.params)
        leaves = [t for t in _leaves(self._views) if t.requires_grad]
        if weight_decay:
            self.optimizer = torch.optim.AdamW(leaves, lr=learning_rate,
                                               weight_decay=weight_decay)
        else:
            self.optimizer = torch.optim.Adam(leaves, lr=learning_rate)

    def _loss(self, params, batch) -> torch.Tensor:
        dev = self.model.device
        tokens = _tensor(batch.masked_tokens, torch.int32, dev)
        cu_lens = _tensor(batch.cu_lens, torch.int32, dev)
        seg_ids, pos_ids = packed_meta(cu_lens, tokens.shape[0])
        logits = forward_flat(
            params, self.model.config, tokens, seg_ids, pos_ids,
            with_head=True, attn_impl=self.attn_impl,
            checkpointing=self.model.checkpointing,
            max_seqlen=int(batch.max_len), remat=self.remat)
        return cross_entropy(logits, _tensor(batch.tokens, torch.int64, dev),
                             _tensor(batch.mask, torch.bool, dev))

    def _grad_step(self, batch):
        """Loss and gradients of one batch, without an update: returns
        ``(loss, grads)`` with ``grads`` in the layout of
        ``model.params``. Drops any gradient still being accumulated."""
        self.optimizer.zero_grad(set_to_none=True)
        with fp32_accumulation():
            loss = self._loss(self._views, batch)
            loss.backward()
        grads = _grad_tree(self._views)
        self.optimizer.zero_grad(set_to_none=True)
        return loss.detach(), grads

    def training_step(self, batch) -> float:
        """One (micro-)batch step; returns its loss
        (reference: esme/trainer.py:31-35)."""
        with fp32_accumulation():
            loss = self._loss(self._views, batch)
            loss.backward()
            self.step += 1
            if self.step % self.grad_accum == 0:
                if self.grad_accum > 1:
                    for group in self.optimizer.param_groups:
                        for p in group['params']:
                            if p.grad is not None:
                                p.grad.div_(self.grad_accum)
                self.optimizer.step()
                self.optimizer.zero_grad(set_to_none=True)
        return float(loss.detach())

    @torch.no_grad()
    def validation_step(self, batch) -> float:
        """Loss without updates (reference: esme/trainer.py:37-41)."""
        with fp32_accumulation():
            return float(self._loss(self.model.params, batch))

    def fit(self, dataset, epochs: int = 1, val_dataset=None,
            log_every: int = 0, set_epoch=None, logger=None):
        """Epoch loop over an iterable of PackedBatch; returns the
        per-step losses.

        ``logger``: an object with ``log(dict, step=...)`` and
        ``track_best(dict)`` (the JAX package's ``MetricLogger``)
        receiving ``train_loss`` every ``log_every`` steps and
        ``val_loss`` per epoch; without one, those lines are printed."""
        history = []
        for epoch in range(epochs):
            if set_epoch is not None:
                set_epoch(epoch)
            for i, batch in enumerate(dataset):
                loss = self.training_step(batch)
                history.append(loss)
                if log_every and i % log_every == 0:
                    if logger is not None:
                        logger.log({'epoch': epoch, 'train_loss': loss},
                                   step=self.step)
                    else:
                        print(f'epoch {epoch} step {i}: loss {loss:.4f}')
            if val_dataset is not None:
                vloss = float(np.mean(
                    [self.validation_step(b) for b in val_dataset]))
                if logger is not None:
                    logger.log({'epoch': epoch, 'val_loss': vloss},
                               step=self.step)
                    logger.track_best({'val_loss': vloss})
                else:
                    print(f'epoch {epoch}: val_loss {vloss:.4f}')
        return history
