"""Multi-process masked-LM training: data parallelism, FSDP and context
parallelism over a named mesh.

Counterpart of ``ShardedMaskedPLM`` and ``stack_batches`` in
``esme_tpu/train/distributed.py:56-301``. The JAX class runs one
``shard_map`` program over a ``(data, fsdp[, seq])`` mesh; the port runs
one process per rank over a ``DeviceMesh`` with those axes
(:func:`esme_tpu_torch.parallel.make_mesh`):

* every rank receives the same R packed batches (R = the ``data`` axis
  size), takes its data row and, with ``seq_axis``, its contiguous slice
  of the row's tokens (attention gathers the keys over that axis: kernels
  H9 and H10, :mod:`esme_tpu_torch.parallel.context`);
* every rank holds its shards of the params and of the optimizer state
  (:mod:`esme_tpu_torch.parallel.fsdp`); the forward gathers the
  non-layer leaves once and each layer's leaves inside its checkpointed
  step, and the gathers' backward reduce-scatters the gradients over
  ``fsdp``;
* the gradients are then summed over the loss axes (``data`` and
  ``seq``), and a replicated leaf's over ``fsdp`` too, and the optimizer
  updates each rank's shards in place (``adam8bit``'s per-leaf max of
  |g| is all-reduced over ``fsdp``, as JAX's ``jnp.max`` of a sharded
  array is global).

The gradient is the single-device gradient of the global masked mean
(the loss of :class:`esme_tpu_torch.train.MaskedPLM` over the union of
the R batches). The ranks of one data row along ``fsdp`` compute the same
loss, so each counts it once: its local loss is divided by the ``fsdp``
size before the backward. (The JAX class ``psum``s gradients of a loss
it had already ``psum``'d and sums the ``fsdp`` copies in the gather's
transpose, which scales its update; ROADMAP.md Queue 3, item 17.)

Only the trainable leaves take part, as JAX differentiates only them
(``split_by_mask``): the mask is ``trainable_mask`` or the model's
``trainable_filter(lora_only, train_lmhead)``, as in
:class:`~esme_tpu_torch.train.MaskedPLM`. A frozen leaf (the dense trunk
under LoRA, a quantized projection's int8 or NF4 storage) is gathered
without an autograd node and takes no gradient, no optimizer state and no
all-reduce, so its bits never change; LoRA over a quantized trunk (QLoRA)
trains over the mesh as on one device.

:attr:`ShardedMaskedPLM.state` is this rank's part of the training
state (:class:`ShardedTrainState`: its shards of the params and of the
optimizer state, the step, any gradient being accumulated), which
:class:`~esme_tpu_torch.train.CheckpointManager` saves and restores on
every rank, as JAX's orbax manager writes each shard from its device: no
rank gathers the whole optimizer state. A part records its layout (the
shard dims, the rank's coordinates, the loss axes and the trained views),
so that a trainer on a mesh of another shape can take its own part of a
saved state (:meth:`CheckpointManager.restore
<esme_tpu_torch.train.checkpoint.CheckpointManager.restore>` reshards
it, as orbax restores into the template's shardings).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed import ReduceOp
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..models.esm import forward_flat, packed_meta
from ..models.modules import check_remat
from ..ops.flash import rect_flash_spans, with_order
from ..ops.linear import fp32_accumulation
from ..parallel.context import axis_size, make_kv_gather
from ..parallel.fsdp import (_map, fsdp_partition_specs, gather_dim,
                             make_layer_gather, make_outer_gather,
                             shard_params)
from ..parallel.mesh import axes_group
from .trainer import (_grad_tree, _leaves, _same_paths, _tensor,
                      build_optimizer, check_views, copy_named,
                      load_optimizer_state, named_views, train_views,
                      view_key)


class ShardedTrainState(NamedTuple):
    """One rank's part of a :class:`ShardedMaskedPLM`'s state, as JAX's
    ``ShardedTrainState(params, opt_state, step)``
    (``esme_tpu/train/distributed.py:53-56``), whose arrays orbax writes
    shard by shard: ``params``, this rank's shards (the layout of
    ``model.params``, each sharded leaf its block); ``opt_state``, the
    optimizer's ``state_dict()`` over those shards; ``step``; ``accum``,
    the ``.grad`` of each trainable leaf while a ``grad_accum`` cycle is
    open (None otherwise); ``mesh``, the part's layout: the mesh's axis
    names (``axes``) and sizes (``shape``), this rank (``rank``) and its
    coordinate on each axis (``coords``), the axes the loss is summed
    over (``loss_axes``) and each leaf's shard dim (``specs``, the tree of
    :func:`~esme_tpu_torch.parallel.fsdp.fsdp_partition_specs`);
    ``views``, the trained views as ``[leaf path, layer]`` (layer None
    outside the stacked layers) in the order of ``accum`` (``trained``)
    and of the optimizer's param ids (``optimizer``), and the optimizer's
    class (``optimizer_class``). As written by
    :class:`~esme_tpu_torch.train.CheckpointManager`, the part of a rank
    whose ``data`` or ``seq`` coordinate is not 0 has ``params`` and
    ``opt_state`` None: it is a replica of the rank at ``data`` and
    ``seq`` 0 of its ``fsdp`` coordinate, whose part holds them, as orbax
    writes each replicated shard once. A part saved before ``coords``,
    ``specs`` and ``views`` were recorded has neither, and restores only
    on the mesh shape it was saved from."""
    params: dict
    opt_state: dict
    step: int
    accum: Optional[list]
    mesh: dict
    views: Optional[dict] = None


def stack_batches(batches):
    """Stack R PackedBatches (one per data row) into leading-axis arrays
    ``(masked_tokens, tokens, mask, cu_lens, max_len)``. All must share
    their shapes."""
    return (
        np.stack([b.masked_tokens for b in batches]),
        np.stack([b.tokens for b in batches]),
        np.stack([b.mask for b in batches]),
        np.stack([b.cu_lens for b in batches]),
        max(int(b.max_len) for b in batches),
    )


def _all_reduce(tensors, group):
    """Sum each tensor over ``group`` in place, one collective per dtype
    (nothing to do on a group of one)."""
    if dist.get_world_size(group) == 1:
        return
    for dtype in {t.dtype for t in tensors}:
        ts = [t for t in tensors if t.dtype == dtype]
        flat = _flatten_dense_tensors(ts)
        dist.all_reduce(flat, group=group)
        for t, r in zip(ts, _unflatten_dense_tensors(flat, ts)):
            t.copy_(r)


class ShardedMaskedPLM:
    """Masked-LM trainer over a ``(data, fsdp)`` or ``(data, fsdp, seq)``
    mesh (``esme_tpu/train/distributed.py:68``); every rank of the mesh's
    process group constructs it and calls its steps.

    Args:
        model: an :class:`esme_tpu_torch.models.esm._ESMBase` instance,
            the same weights on every rank.
        mesh: a DeviceMesh with ``data`` and ``fsdp`` axes (and
            ``seq_axis``).
        learning_rate, weight_decay: Adam, or AdamW with decoupled decay
            when non-zero (as :class:`MaskedPLM`).
        optimizer: None, or a factory of param groups as in
            :class:`MaskedPLM` (``optim.adam8bit(...)``); each group holds
            this rank's shards of one JAX leaf. An optimizer with a
            ``reduce_max`` attribute (``Adam8bit``) gets the all-reduce
            that makes its per-leaf max global over ``fsdp``.
        attn_impl: the model's attention path ('auto'/'flash' run the
            kernels on the card, their plain versions on the CPU;
            'reference' the einsum).
        grad_accum: micro-batches accumulated per update (the mean, as
            ``optax.MultiSteps``).
        lora_only, train_lmhead, trainable_mask: the trainable leaves, as
            in :class:`MaskedPLM` (the model's ``trainable_filter``, or the
            caller's tree of bools); LoRA adapters over a dense or a
            quantized trunk train over the mesh. Unlike ``MaskedPLM`` no
            LoRA dropout is applied (the model's ``dropout_p`` is ignored),
            as JAX's class passes none to its forward (ROADMAP.md Queue 3,
            item 26).
        seq_axis: the mesh axis the packed token axis is split over
            (context parallelism), or None.
        remat: the checkpointing policy when ``model.checkpointing``, as
            in :class:`MaskedPLM`.
    """

    def __init__(self, model, mesh, learning_rate: float = 1e-4,
                 weight_decay: float = 0.0, attn_impl: str = 'auto',
                 grad_accum: int = 1, lora_only=None,
                 train_lmhead: bool = False, trainable_mask=None,
                 optimizer=None, seq_axis=None, remat: str = 'full'):
        names = mesh.mesh_dim_names
        if seq_axis is not None and seq_axis not in names:
            raise ValueError(f'mesh has no axis {seq_axis!r}')
        check_remat(remat)
        if grad_accum < 1:
            raise ValueError(f'grad_accum must be >= 1, got {grad_accum}')
        self.model = model
        self.mesh = mesh
        self.attn_impl = attn_impl
        self.remat = remat
        self.grad_accum = int(grad_accum)
        self.step = 0
        self._seq_axis = seq_axis
        self._fsdp_size = axis_size(mesh, 'fsdp')

        self.specs = fsdp_partition_specs(model.params, mesh)
        # this rank's shards, updated in place through per-layer views of
        # the trainable leaves
        self.params, _ = shard_params(model.params, mesh, self.specs)
        self._mask = trainable_mask if trainable_mask is not None else \
            model.trainable_filter(lora_only=lora_only,
                                   train_lmhead=train_lmhead)
        self._views = train_views(self.params, self._mask)
        layers = self._views['layers']
        view_specs = {k: [self.specs[k]] * len(layers) if k == 'layers'
                      else self.specs[k] for k in self.specs}
        named = named_views(self._views)
        pairs = [(t, d) for (t, _), d in zip(named, _leaves(view_specs))
                 if torch.is_tensor(t) and t.requires_grad]
        if not pairs:
            raise ValueError('ShardedMaskedPLM: no leaf of the model trains '
                             'under this mask (lora_only without adapters?)')
        self._sharded = [t for t, d in pairs if d is not None]
        self._replicated = [t for t, d in pairs if d is None]
        self._trained = [t for t, _ in pairs]
        self.optimizer = build_optimizer(self._views, optimizer,
                                         learning_rate, weight_decay)
        self._view_key = view_key(named, self.optimizer)

        self._layer_gather = make_layer_gather(self.specs['layers'], mesh)
        self._outer_gather = make_outer_gather(
            {k: v for k, v in self.specs.items() if k != 'layers'}, mesh)
        # the loss axes ('data' and seq_axis), and those with 'fsdp': the
        # ranks a replicated leaf's gradient is summed over. An axis that
        # splits nothing (a 'seq' axis without seq_axis) holds replicas of
        # the same step, whose gradients are not summed. Every rank
        # creates the groups in this order.
        loss_axes = ('data', seq_axis) if seq_axis else ('data',)
        self._loss_axes = loss_axes
        self._loss_group = axes_group(mesh, loss_axes)
        self._replica_group = axes_group(
            mesh, tuple(a for a in names if a in (*loss_axes, 'fsdp')))
        self._fsdp_group = mesh.get_group('fsdp')
        if hasattr(self.optimizer, 'reduce_max') \
                and dist.get_world_size(self._fsdp_group) > 1:
            self.optimizer.reduce_max = self._max_over_fsdp

    def _max_over_fsdp(self, t: torch.Tensor) -> None:
        dist.all_reduce(t, op=ReduceOp.MAX, group=self._fsdp_group)

    # -- the loss ---------------------------------------------------------

    def _rows(self, batches):
        """This rank's data row of the stacked batches, as tensors on the
        model's device: masked tokens, targets, mask, cu_lens, max_len."""
        if isinstance(batches, (list, tuple)) and hasattr(batches[0],
                                                          'tokens'):
            batches = stack_batches(batches)
        masked, targets, mask, cu_lens, max_len = batches
        rows = axis_size(self.mesh, 'data')
        if len(masked) != rows:
            raise ValueError(f'{len(masked)} batches for a data axis of '
                             f'size {rows}')
        d = self.mesh.get_local_rank('data')
        dev = self.model.device
        return (_tensor(masked[d], torch.int32, dev),
                _tensor(targets[d], torch.int64, dev),
                _tensor(mask[d], torch.float32, dev),
                _tensor(cu_lens[d], torch.int32, dev), int(max_len))

    def _local(self, params, batches):
        """This rank's sum of the masked log-likelihoods and its count of
        masked tokens (``esme_tpu/train/distributed.py:127-162``)."""
        tok, tgt, w, cu, max_len = self._rows(batches)
        T = tok.shape[0]
        seg, pos = packed_meta(cu, T)
        kv_gather = spans = None
        if self._seq_axis:
            # the global segment and position metadata from the row's
            # cu_lens, sliced to this rank's window; attention gathers k/v
            n = axis_size(self.mesh, self._seq_axis)
            if T % n:
                raise ValueError(f'token count {T} not divisible by '
                                 f'{self._seq_axis} axis size {n}')
            r = self.mesh.get_local_rank(self._seq_axis)
            lo, hi = r * (T // n), (r + 1) * (T // n)
            seg_all = seg.to(torch.int32).contiguous()
            seg, pos = seg_all[lo:hi].contiguous(), pos[lo:hi]
            tok, tgt, w = tok[lo:hi], tgt[lo:hi], w[lo:hi]
            kv_gather = make_kv_gather(self.mesh.get_group(self._seq_axis))
            if self.attn_impl != 'reference':
                spans = with_order(rect_flash_spans(seg, seg_all))
        logits = forward_flat(
            params, self.model.config, tok, seg, pos, with_head=True,
            attn_impl=self.attn_impl,
            checkpointing=self.model.checkpointing, max_seqlen=max_len,
            remat=self.remat, kv_gather=kv_gather, spans=spans,
            layer_gather=self._layer_gather,
            outer_gather=self._outer_gather)
        ll = torch.log_softmax(logits.float(), dim=-1) \
            .gather(-1, tgt[:, None])[:, 0]
        return (ll * w).sum(), w.sum()

    def _loss(self, params, batches):
        """``(local, loss)``: the loss this rank differentiates (its share
        of the global masked mean, counted once over ``fsdp``) and the
        global masked mean."""
        s, c = self._local(params, batches)
        total = torch.stack([s.detach(), c])
        _all_reduce([total], self._loss_group)
        count = total[1].clamp_min(1.0)
        return -(s / count) / self._fsdp_size, -(total[0] / count)

    def _reduce_grads(self):
        """Sum the gradients over the loss axes (a sharded leaf's are
        already summed over ``fsdp`` by the gathers' backward) and a
        replicated leaf's over the loss axes and ``fsdp``."""
        for group, leaves in ((self._loss_group, self._sharded),
                              (self._replica_group, self._replicated)):
            for t in leaves:
                if t.grad is None:
                    t.grad = torch.zeros_like(t)
            _all_reduce([t.grad for t in leaves], group)

    # -- public steps -------------------------------------------------------

    def _grad_step(self, batches):
        """Loss and full gradients of one step, without an update: returns
        ``(loss, grads)`` with ``grads`` in the layout of ``model.params``
        (the same on every rank; None at a frozen leaf). Drops any gradient
        still being accumulated."""
        self.optimizer.zero_grad(set_to_none=True)
        with fp32_accumulation():
            local, loss = self._loss(self._views, batches)
            local.backward()
            self._reduce_grads()
        grads = _map(lambda g, d: g if g is None or d is None
                     else gather_dim(g, d, self._fsdp_group),
                     _grad_tree(self._views), self.specs)
        self.optimizer.zero_grad(set_to_none=True)
        return loss, grads

    def training_step(self, batches) -> float:
        """One (micro-)step; returns the global loss. ``batches``: a list
        of R PackedBatches (R = the ``data`` axis size), the same on every
        rank, or a tuple from :func:`stack_batches`."""
        with fp32_accumulation():
            local, loss = self._loss(self._views, batches)
            local.backward()
            self.step += 1
            if self.step % self.grad_accum == 0:
                self._reduce_grads()
                if self.grad_accum > 1:
                    for t in self._sharded + self._replicated:
                        t.grad.div_(self.grad_accum)
                self.optimizer.step()
                self.optimizer.zero_grad(set_to_none=True)
        return float(loss)

    @torch.no_grad()
    def validation_step(self, batches) -> float:
        """Global loss without updates (reference: esme/trainer.py:37-41)."""
        with fp32_accumulation():
            return float(self._loss(self.params, batches)[1])

    def fit(self, dataset, epochs: int = 1, val_dataset=None,
            log_every: int = 0, set_epoch=None, logger=None):
        """Epoch loop over an iterable of replica-batch lists, as
        :meth:`MaskedPLM.fit` (``logger`` receives ``train_loss`` and
        ``val_loss``; without one, those lines are printed). Returns the
        per-step losses."""
        history = []
        for epoch in range(epochs):
            if set_epoch is not None:
                set_epoch(epoch)
            for i, batches in enumerate(dataset):
                loss = self.training_step(batches)
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

    # -- state ----------------------------------------------------------------

    def _mesh_key(self) -> dict:
        names = self.mesh.mesh_dim_names
        return {'axes': list(names), 'shape': list(self.mesh.mesh.shape),
                'rank': dist.get_rank(),
                'coords': [self.mesh.get_local_rank(a) for a in names],
                'loss_axes': list(self._loss_axes), 'specs': self.specs}

    @property
    def state(self) -> ShardedTrainState:
        """This rank's part of the state: its shards (the live tensors),
        the optimizer's state over them, the step, inside a
        ``grad_accum`` cycle the gradients gathered so far, and the
        part's layout (``mesh``, ``views``). ``CheckpointManager.restore``
        gives a trainer on a mesh of any shape its own part of it."""
        accum = None
        if self.step % self.grad_accum:
            accum = [t.grad for t in self._trained]
        return ShardedTrainState(self.params, self.optimizer.state_dict(),
                                 self.step, accum, self._mesh_key(),
                                 self._view_key)

    @state.setter
    def state(self, state: ShardedTrainState) -> None:
        """Take this rank's part of a state
        (:meth:`CheckpointManager.restore
        <esme_tpu_torch.train.checkpoint.CheckpointManager.restore>` on
        every rank, which reshards a state saved on a mesh of another
        shape): its shards copied into the live tensors by leaf path, bit
        for bit. Raises ``ValueError`` for a part keyed to another mesh,
        rank or layout, or to other trained views or another optimizer,
        and for a replica's part as saved (``CheckpointManager`` writes the
        params and optimizer state of the ranks at ``data`` and ``seq`` 0
        only; its ``restore`` fills them in). A part saved before the
        layout was recorded is checked on the mesh's axes, shape and rank
        only, and its params must list this trainer's paths in order."""
        mine = self._mesh_key()
        keys = mine if 'specs' in state.mesh else ('axes', 'shape', 'rank')
        differ = [k for k in keys if state.mesh.get(k) != mine[k]]
        if differ:
            raise ValueError(
                f"a part of rank {state.mesh['rank']} of a "
                f"{state.mesh['shape']} mesh cannot be taken by rank "
                f"{mine['rank']} of a {mine['shape']} mesh (its {differ} "
                'differ); CheckpointManager.restore reshards a saved state')
        if state.params is None or state.opt_state is None:
            raise ValueError('the part of a replica holds no params or '
                             'optimizer state (its replica at data and seq '
                             '0 does); CheckpointManager.restore fills them')
        if state.views is not None:
            check_views(state.views, self._view_key)
            if state.views != self._view_key:
                raise ValueError('the part lists the trained leaves in '
                                 'another order; CheckpointManager.restore '
                                 'reorders a saved state')
        else:
            _same_paths(self.params, state.params)
        copy_named(self.params, state.params,
                   {p for p, _ in self._view_key['trained']})
        load_optimizer_state(self.optimizer, state.opt_state)
        self.step = int(state.step)
        for t, g in zip(self._trained, state.accum or [None] *
                        len(self._trained)):
            t.grad = None if g is None else g.to(t.device, copy=True)

    def unsharded_params(self) -> dict:
        """The full params, gathered from every rank's shards, on the host
        (for ``save_pretrained``; quantized leaves keep their dtypes):
        copies, which later steps leave as they are."""
        with torch.no_grad():
            return _map(lambda x, d: (x if d is None else gather_dim(
                x, d, self._fsdp_group)).to('cpu', copy=True), self.params,
                self.specs)
