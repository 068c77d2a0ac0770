"""Training loops: masked-LM training and fine-tuning with a pooled head.

Counterpart of ``esme_tpu/train/trainer.py`` (reference:
esme/trainer.py:8-104): :class:`MaskedPLM` (``:45-258``),
:class:`RegressionTrainer` (``:261-401``) and
:class:`ClassificationTrainer` (``:404-432``). The JAX classes own an
optax optimizer and a jitted step; these own a ``torch.optim`` optimizer
and run the step eagerly:

* ``optax.adam`` -> ``torch.optim.Adam``; with ``weight_decay``,
  ``optax.adamw`` -> ``torch.optim.AdamW`` (the same decoupled decay);
  ``optimizer=`` takes a factory of the trainer's param groups, one per
  JAX leaf (:func:`leaf_groups`), such as
  :func:`esme_tpu_torch.train.optim.adam8bit`;
* gradient accumulation as ``optax.MultiSteps``: the running mean of
  ``grad_accum`` micro-batch gradients in MultiSteps' arithmetic
  (``acc + (g - acc) / (n + 1)``), one update every ``grad_accum``-th
  step;
* activation checkpointing from the model's ``checkpointing`` flag
  (``remat='full'`` or ``'attn'``, ``models/modules.py:layer_stack``);
* ``offload_optimizer``: fp32 master copies and the optimizer state on
  the host (:class:`_HostOptimizer`);
* ``lora_only``/``train_lmhead``/``trainable_mask``: the model's
  ``trainable_filter`` (``esme_tpu/lora.py:178-215``) or the caller's
  mask; a frozen leaf takes no gradient and joins no optimizer
  (``train/partition.py``), so its bits never change, where JAX zeroes
  its update (``optax.set_to_zero``);
* LoRA dropout (the model's ``lora_kwargs['dropout_p']``) in training
  steps, its key folded from ``DROPOUT_KEY`` and the step count, as JAX
  folds its ``random.key(0x10ad)``;
* the fine-tune trainers' two learning rates (``optax.multi_transform``
  in JAX): one Adam, a param group for the trunk's trainable leaves at
  ``lr`` and one for the head at ``head_lr``;
* ``state`` (a :class:`TrainState`) for
  :class:`~esme_tpu_torch.train.CheckpointManager`: a restored trainer
  continues bit for bit, inside a ``grad_accum`` cycle and under
  ``offload_optimizer`` too (JAX's ``TrainState`` holds no offloaded
  masters, so its offloaded resume restarts from the new trainer's own:
  ROADMAP.md Queue 3, item 25).

The optimizer's leaves are views of the model's params: each layer's row
of a stacked leaf is its own gradient target (see ``models/modules.py``)
and is updated in place, so ``model.params`` (and a fine-tune trainer's
``head_params``) always hold the trained weights.

Each step runs forward, loss, backward and update inside
:func:`~esme_tpu_torch.ops.linear.fp32_accumulation`: the weight and
input gradients are cuBLAS products too.
"""

from __future__ import annotations

import itertools
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..loss import bce_with_logits, cross_entropy, mse_loss
from ..metrics import auprc, auroc, spearman as _spearman
from ..models.esm import forward_flat, packed_meta
from ..models.heads import apply_cls_head, apply_learned_aggregation
from ..models.modules import check_remat, layer_params, num_layers
from ..ops.linear import fold_in, fp32_accumulation
from ..profiling import span
from .partition import expand_mask

# the LoRA dropout's base key, JAX's ``random.key(0x10ad)``; each step
# folds its count into it
DROPOUT_KEY = 0x10ad


class TrainState(NamedTuple):
    """A trainer's state, as JAX's ``TrainState``: ``params`` (the
    fine-tune trainers': ``{'plm', 'head'}``), ``opt_state`` (the torch
    optimizer's ``state_dict()``) and ``step``; :class:`MaskedPLM`'s also
    ``accum``, the running mean of an open ``grad_accum`` cycle (which JAX
    keeps in ``optax.MultiSteps``' state; None between cycles), and
    ``masters``, the fp32 master copies of ``offload_optimizer`` (None
    without it). ``views`` names what the lists and the optimizer's
    integer param ids hold, as
    :class:`~esme_tpu_torch.train.distributed.ShardedTrainState`'s does:
    the trained views as ``[leaf path, layer]`` (layer None outside the
    stacked layers) in the order of ``accum`` (``trained``) and of the
    optimizer's param ids (``optimizer``), the optimizer's class
    (``optimizer_class``) and, offloaded, the masters' ``[leaf path,
    None]`` (``masters``). A setter pairs every saved leaf with the
    trainer's of the same path, as orbax restores JAX's state by tree
    path, so two trees that list the same leaves in other orders (the
    init's, ``models/io.py:params_from_jax``'s sorted one, quantize-at-load
    against ``quantize()``) restore into each other. A state saved before
    ``views`` were recorded (None) restores only into a trainer whose
    params list the same paths in the same order."""
    params: dict
    opt_state: dict
    step: int
    accum: Optional[list] = None
    masters: Optional[list] = None
    views: Optional[dict] = None


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _map2(fn, tree, flags):
    """``fn(leaf, flag)`` over a tree and a bool tree of its structure."""
    return {k: _map2(fn, v, flags[k]) if isinstance(v, dict)
            else fn(v, flags[k]) for k, v in tree.items()}


def _leaves(tree):
    items = tree.values() if isinstance(tree, dict) else tree
    for v in items:
        if isinstance(v, (dict, list)):
            yield from _leaves(v)
        else:
            yield v


def _named(tree: dict, path: str = ''):
    """``(dotted path, leaf)`` for every leaf of a dict tree, in order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f'{path}{k}.')
        else:
            yield f'{path}{k}', v


def view_names(views: dict) -> list:
    """``[leaf path, layer]`` of every leaf of a :func:`train_views` tree,
    in the order its leaves are visited: a stacked leaf's per-layer views
    carry their layer, the others None."""
    out = []
    for key, v in views.items():
        if key == 'layers':
            out += [[f'layers.{n}', i] for i, layer in enumerate(v)
                    for n, _ in _named(layer)]
        elif isinstance(v, dict):
            out += [[f'{key}.{n}', None] for n, _ in _named(v)]
        else:
            out.append([key, None])
    return out


def _label(view) -> str:
    path, layer = view
    return path if layer is None else f'{path} (layer {layer})'


def check_views(saved: dict, mine: dict) -> None:
    """Raise ``ValueError`` where a saved state's trained views or
    optimizer (``TrainState.views``) are not this trainer's in any order,
    naming the first leaf that differs."""
    if saved['optimizer_class'] != mine['optimizer_class']:
        raise ValueError(f"the state was saved with optimizer "
                         f"{saved['optimizer_class']}; this trainer's is "
                         f"{mine['optimizer_class']}")
    a, b = ({tuple(v) for v in views['trained']} for views in (saved, mine))
    if a != b:
        view = min(a ^ b, key=str)
        where = ('here but not in the saved state' if view in b
                 else 'in the saved state but not here')
        raise ValueError(f'{_label(view)} trains {where} (another '
                         'trainable mask or model)')


def named_views(views: dict, prefix: str = '') -> list:
    """``(view, [leaf path, layer])`` for every leaf of a
    :func:`train_views` tree, each path after ``prefix``."""
    return [(t, [prefix + path, layer]) for t, (path, layer) in
            zip(_leaves(views), view_names(views))]


def view_key(named: list, optimizer) -> dict:
    """``TrainState.views`` of a trainer: ``named``'s trained views (from
    :func:`named_views`) and the optimizer's param ids by name."""
    trained = [(t, n) for t, n in named
               if torch.is_tensor(t) and t.requires_grad]
    name_of = {id(t): n for t, n in trained}
    return {'trained': [n for _, n in trained],
            'optimizer': [name_of[id(p)] for g in optimizer.param_groups
                          for p in g['params']],
            'optimizer_class': type(optimizer).__name__}


def _same_paths(live: dict, saved: dict) -> None:
    """For a state saved without ``views``: raise ``ValueError`` naming
    the first leaf where ``saved`` lists another path than ``live``."""
    a, b = ([p for p, _ in _named(t)] for t in (saved, live))
    for x, y in itertools.zip_longest(a, b):
        if x != y:
            raise ValueError(
                f'the state records no views (saved before states were '
                f'keyed by leaf path) and lists leaf {x} where this trainer '
                f'lists {y}: it restores only into a trainer whose params '
                'list the same leaves in the same order')


def _converts_exactly(v: torch.Tensor, dtype) -> bool:
    """Whether every value of ``v`` survives a round trip through
    ``dtype``, bit for bit."""
    if not (v.is_floating_point() and dtype.is_floating_point):
        return False
    back = v.to(dtype).to(v.dtype)
    return torch.equal(back.reshape(-1).view(torch.uint8),
                       v.reshape(-1).contiguous().view(torch.uint8))


def _check_leaf(name: str, v: torch.Tensor, t: torch.Tensor,
                cast: bool = False) -> None:
    """Raise ``ValueError`` naming ``name`` where the saved ``v`` has
    another shape or dtype than the trainer's ``t`` (with ``cast``, a
    dtype its values convert to exactly passes)."""
    if v.shape != t.shape or (v.dtype != t.dtype and not (
            cast and _converts_exactly(v, t.dtype))):
        raise ValueError(f'a saved leaf {name} of {tuple(v.shape)} {v.dtype} '
                         f'for one of {tuple(t.shape)} {t.dtype}')


def copy_named(live: dict, saved: dict, trained=()) -> None:
    """Copy each leaf of ``saved`` into the leaf of ``live`` at the same
    dotted path, bit for bit. Raises ``ValueError`` naming a leaf missing
    on either side, or whose shape or dtype differs; a frozen leaf (not
    in ``trained``, a set of paths) saved in another dtype is taken where
    its values convert exactly (a quantized trunk's NF4 outlier rows are
    fp32 from quantize-at-load, as in JAX, and in the model's dtype from
    ``quantize()``)."""
    live, saved = dict(_named(live)), dict(_named(saved))
    for path in sorted(set(live) | set(saved)):
        if path not in live or path not in saved:
            where = ('this trainer', 'the saved state')
            raise ValueError(f'leaf {path} is in {where[path in saved]} '
                             f'but not in {where[path in live]}: another '
                             'model')
        _check_leaf(path, saved[path], live[path],
                    cast=path not in trained)
    with torch.no_grad():
        for path, t in live.items():
            t.copy_(saved[path])


def by_view(values: list, saved: list, live: list, like: list) -> list:
    """``values``, listed by the views ``saved``, in the order of the
    views ``live`` (``[leaf path, layer]`` each); raises ``ValueError``
    naming a view missing from ``saved`` or whose value (not None) has
    another shape or dtype than its tensor in ``like``."""
    if len(values) != len(saved):
        raise ValueError(f'the saved state lists {len(values)} tensors for '
                         f'{len(saved)} views')
    index = {tuple(n): i for i, n in enumerate(saved)}
    out = []
    for name, t in zip(live, like):
        if tuple(name) not in index:
            raise ValueError(f'{_label(name)}: nothing saved for it')
        v = values[index[tuple(name)]]
        if v is not None:
            _check_leaf(_label(name), v, t)
        out.append(v)
    return out


def optimizer_ids(saved: dict, saved_opt: dict, live: dict,
                  live_opt: dict):
    """``(order, groups)``, a saved optimizer state laid onto a trainer's
    by view: ``order[i]`` the saved param id of the view of the trainer's
    id ``i`` (``saved`` and ``live``: the two ``views`` records), and the
    trainer's param groups with the saved groups' hyperparameters.
    Raises ``ValueError`` where a view has no saved id or the saved
    optimizer groups the views otherwise (another optimizer)."""
    ids = {tuple(v): i for i, v in enumerate(saved['optimizer'])}
    missing = [v for v in live['optimizer'] if tuple(v) not in ids]
    if missing:
        raise ValueError(f'{_label(missing[0])} has no saved optimizer id '
                         '(another optimizer or trainable mask)')
    order = [ids[tuple(v)] for v in live['optimizer']]
    saved_group = {i: g for g in saved_opt['param_groups']
                   for i in g['params']}
    groups = []
    for g in live_opt['param_groups']:
        sg = saved_group.get(order[g['params'][0]])
        if sg is None or sorted(order[i] for i in g['params']) \
                != sorted(sg['params']):
            raise ValueError('the saved optimizer groups the leaves '
                             'otherwise (another optimizer)')
        groups.append({**sg, 'params': list(g['params'])})
    return order, groups


def _load_optimizer(optimizer, opt_state: dict, saved: dict,
                    live: dict) -> None:
    """Load a saved ``state_dict`` into ``optimizer`` by view (the
    ``views`` records ``saved`` and ``live``): each param's state from
    the saved id of its view, each tensor of a param's shape checked."""
    order, groups = optimizer_ids(saved, opt_state, live,
                                  optimizer.state_dict())
    params = [p for g in optimizer.param_groups for p in g['params']]
    state = {}
    for pid, (sid, name) in enumerate(zip(order, live['optimizer'])):
        st = opt_state['state'].get(sid)
        if st is None:
            continue
        for k, v in st.items():
            if torch.is_tensor(v) and v.dim() > 0 \
                    and v.shape != params[pid].shape:
                raise ValueError(
                    f'optimizer state {k!r} of {_label(name)} saved as '
                    f'{tuple(v.shape)}; the leaf is '
                    f'{tuple(params[pid].shape)}')
        state[pid] = st
    load_optimizer_state(optimizer, {'state': state, 'param_groups': groups})


def restore_params(params: dict, state, key: dict) -> dict:
    """The first part of a setter: check the saved ``state``'s views
    against the trainer's (``key``), then copy its params into
    ``params`` by path (:func:`copy_named`). Returns the saved views: for
    a state saved without them, after checking that its params list the
    trainer's paths in order, the trainer's own."""
    saved = state.views
    if saved is None:
        _same_paths(params, state.params)
        saved = key
    check_views(saved, key)
    copy_named(params, state.params, {p for p, _ in key['trained']})
    return saved


def load_optimizer_state(optimizer, state_dict: dict) -> None:
    """``optimizer.load_state_dict(state_dict)``, then a copy of each state
    tensor that still shares memory with ``state_dict``'s (the base class
    keeps a saved tensor already on its param's device and dtype), so that
    the trainer's updates leave the saved state as it was."""
    optimizer.load_state_dict(state_dict)
    saved = {v.data_ptr() for st in state_dict['state'].values()
             for v in st.values() if torch.is_tensor(v) and v.numel()}
    for st in optimizer.state.values():
        for k, v in st.items():
            if torch.is_tensor(v) and v.numel() and v.data_ptr() in saved:
                st[k] = v.clone()


def _trainable(t: torch.Tensor, train: bool = True) -> torch.Tensor:
    """A leaf sharing ``t``'s storage that autograd differentiates
    (floating leaves that ``train`` only; the others as they are)."""
    if not (train and t.is_floating_point()):
        return t
    return t.detach().requires_grad_()


def train_views(params: dict, mask=None) -> dict:
    """``params`` with every floating leaf that ``mask`` trains (a tree of
    bools of ``params``' structure, or None: all) replaced by a gradient
    target that shares its storage, and ``layers`` by a list of per-layer
    dicts (rows of the stacked leaves). Frozen leaves stay as they are
    and take no gradient."""
    mask = expand_mask(mask, params)
    out = {}
    for key, v in params.items():
        if key == 'layers':
            out[key] = [_map2(_trainable, layer_params(v, i), mask[key])
                        for i in range(num_layers(v))]
        elif isinstance(v, dict):
            out[key] = _map2(_trainable, v, mask[key])
        else:
            out[key] = _trainable(v, mask[key])
    return out


def _trained(views) -> list:
    """The gradient targets among ``views``' leaves, in order."""
    return [t for t in _leaves(views) if t.requires_grad]


def _grad_tree(views: dict) -> dict:
    """The gradients of :func:`train_views`' leaves, in the layout of
    the model's params (layers stacked on axis 0)."""
    def grad(t):
        return None if not torch.is_tensor(t) or t.grad is None \
            else t.grad.detach().clone()

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


def leaf_groups(views: dict) -> list:
    """The gradient targets of :func:`train_views` grouped by the JAX leaf
    they belong to: a stacked layer leaf's per-layer views together, every
    other leaf alone. An optimizer that keeps one statistic per leaf (as
    ``adam8bit``'s scale) takes one param group per list."""
    groups = []
    for key, v in views.items():
        if key == 'layers':
            groups.extend(list(g) for g in zip(
                *(list(_leaves(layer)) for layer in v)))
        elif isinstance(v, dict):
            groups.extend([t] for t in _leaves(v))
        else:
            groups.append([v])
    return [g for g in groups if g[0].requires_grad]


def build_optimizer(views: dict, optimizer, learning_rate: float,
                    weight_decay: float, **adam):
    """The trainers' optimizer over ``views``: ``optimizer(groups)`` for a
    factory (one param group per JAX leaf, :func:`leaf_groups`), else
    Adam, or AdamW with decoupled ``weight_decay`` (``adam``: extra
    arguments of both)."""
    groups = leaf_groups(views)
    if optimizer is not None:
        if not callable(optimizer):
            raise TypeError('optimizer: a factory of param groups, such as '
                            f'train.optim.adam8bit(...), not {optimizer!r}')
        return optimizer([{'params': g} for g in groups])
    leaves = [t for t in _leaves(views) if t.requires_grad]
    if weight_decay:
        return torch.optim.AdamW(leaves, lr=learning_rate,
                                 weight_decay=weight_decay, **adam)
    return torch.optim.Adam(leaves, lr=learning_rate, **adam)


def accumulate(acc: dict, params, n: int) -> None:
    """Fold each param's ``.grad``, micro-batch ``n`` of a cycle (0 first),
    into its running mean ``acc[p]`` as ``optax.MultiSteps`` does
    (``acc + (g - acc) / (n + 1)``, in the gradient's dtype), and clear
    the ``.grad``. The divisor is a device tensor: a CUDA division by a
    Python number multiplies by its reciprocal, which rounds otherwise."""
    div = None
    for p in params:
        g = torch.zeros_like(p) if p.grad is None else p.grad
        p.grad = None
        if n == 0:
            acc[p] = g
            continue
        if div is None:
            div = torch.full((), n + 1.0, dtype=torch.float32,
                             device=p.device)
        acc[p].add_((g - acc[p]).div_(div))


def _map_stack(per_layer: list):
    first = per_layer[0]
    if isinstance(first, dict):
        return {k: _map_stack([p[k] for p in per_layer]) for k in first}
    return None if first is None else torch.stack(per_layer)


def _tensor(x, dtype, device):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x) \
        .to(device=device, dtype=dtype)


def _pinned(like: torch.Tensor, dtype, pin: bool) -> torch.Tensor:
    return torch.empty(like.shape, dtype=dtype, pin_memory=pin)


def _rows(tree: dict, mask=None) -> list:
    """The per-layer rows of :func:`train_views` over ``tree`` (``mask``:
    the trainable leaves, None: all), plain views (no autograd), in the
    order of its trainable leaves."""
    return [t.detach() for t in _trained(train_views(tree, mask))]


class _HostOptimizer:
    """The optimizer offloaded to the host, as ``MaskedPLM(offload_optimizer=
    True)`` in JAX (``esme_tpu/train/trainer.py:94-163``; DeepSpeed's CPU
    optimizer offload, reference: esme/deepspeed.py:18-21): fp32 master
    copies of the trainable leaves and the whole optimizer state live in
    host memory, pinned where the params are on the card, and the update
    runs there; the device keeps its working params and computes the
    gradients.

    :meth:`take_grads` brings one micro-batch's gradients down as fp32
    into the masters' ``.grad`` (several micro-batches folded into their
    running mean in fp32 on the host, as JAX's ``optax.MultiSteps`` over
    the host state does); :meth:`update` steps the host optimizer on the
    masters, rounds them to the params' dtype on the host and copies them
    back into the device params in place. ``ms`` holds the host-clock
    times of the last step's parts (``grads_down``, ``host_update``,
    ``params_up``; the trainer adds ``device``, forward and backward up to
    the grads' readiness)."""

    def __init__(self, params: dict, build, mask=None):
        pin = any(t.is_cuda for t in _leaves(params))
        self._pin = pin
        mask = expand_mask(mask, params)

        def trains(t, f):
            return f and t.is_floating_point()

        # fp32 copies of the trainable leaves; the frozen stay on the card
        masters = _map2(lambda t, f: _pinned(t, torch.float32, pin).copy_(t)
                        if trains(t, f) else t, params, mask)
        up = [((name, t), m, None if t.dtype == torch.float32
               else _pinned(t, t.dtype, pin))
              for (name, t), m, f in zip(_named(params), _leaves(masters),
                                         _leaves(mask)) if trains(t, f)]
        self._up = [(t, m, w) for (_, t), m, w in up]
        # the masters' names in a TrainState's views
        self.names = [[name, None] for (name, _), _, _ in up]
        self.views = train_views(masters, mask)
        masters_rows = _trained(self.views)
        grads = _map2(lambda t, f: _pinned(t, torch.float32, pin)
                      if trains(t, f) else t, params, mask)
        self._grads = _rows(grads, mask)
        for m, g in zip(masters_rows, self._grads):
            m.grad = g
        self._tmp = None
        self.optimizer = build(self.views)
        self.ms = {}

    def sync(self):
        if self._pin:
            torch.cuda.synchronize()

    def take_grads(self, device_params, n: int) -> None:
        """Micro-batch ``n``'s gradients (0 first in a cycle) of
        ``device_params`` (the device views, in :func:`train_views`' order)
        down into the masters' ``.grad``; the device ``.grad`` cleared."""
        t0 = time.perf_counter()
        if n and self._tmp is None:
            self._tmp = [torch.empty_like(g, pin_memory=self._pin)
                         for g in self._grads]
        bufs = self._grads if n == 0 else self._tmp
        for p, buf in zip(device_params, bufs):
            if p.grad is None:
                buf.zero_()
            else:
                buf.copy_(p.grad, non_blocking=True)
            p.grad = None
        self.sync()
        if n:
            div = torch.full((), n + 1.0, dtype=torch.float32)
            for g, t in zip(self._grads, self._tmp):
                g.add_((t - g).div_(div))
        self.ms['grads_down'] = (time.perf_counter() - t0) * 1e3

    def update(self) -> None:
        """Step the host optimizer, then round the masters and copy them
        into the device params."""
        t0 = time.perf_counter()
        self.optimizer.step()
        t1 = time.perf_counter()
        for param, master, work in self._up:
            if work is None:
                param.copy_(master, non_blocking=True)
            else:
                param.copy_(work.copy_(master), non_blocking=True)
        self.sync()
        self.ms['host_update'] = (t1 - t0) * 1e3
        self.ms['params_up'] = (time.perf_counter() - t1) * 1e3

    def host_bytes(self) -> int:
        """Bytes of host memory the offload holds: masters, gradient
        buffers, rounding buffers and the optimizer state."""
        tensors = [m for _, m, _ in self._up] + [w for _, _, w in self._up
                                                 if w is not None]
        tensors += self._grads + (self._tmp or [])
        tensors += [v for st in self.optimizer.state.values()
                    for v in st.values() if torch.is_tensor(v)]
        # the gradient buffers are rows of one tensor per leaf: count each
        # storage once
        seen, total = set(), 0
        for t in tensors:
            key = t.untyped_storage().data_ptr()
            if key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
        return total


def _lora_dropout_rate(model) -> float:
    """The LoRA dropout of training steps: the model's
    ``lora_kwargs['dropout_p']``, 0 without adapters."""
    return float((model.lora_kwargs or {}).get('dropout_p', 0.0) or 0.0)


def _dropout_key(rate: float, step: int):
    """Step ``step``'s LoRA dropout key, or None without dropout."""
    return fold_in(DROPOUT_KEY, step) if rate > 0.0 else None


class MaskedPLM:
    """Masked-LM training (reference: esme/trainer.py:8-44).

    Args:
        model: an :class:`esme_tpu_torch.models.esm._ESMBase` instance.
        learning_rate: Adam learning rate (reference default 1e-4).
        grad_accum: accumulate this many micro-batches per update (their
            running mean, as ``optax.MultiSteps``).
        lora_only: train the LoRA adapters only (None: iff the model has
            any; a list: those adapters), ``train_lmhead`` the LM head
            too (the model's ``trainable_filter``).
        weight_decay: decoupled decay (AdamW) when non-zero.
        optimizer: None (Adam or AdamW), or a factory of param groups, one
            per JAX leaf (:func:`leaf_groups`): ``optim.adam8bit(...)``, or
            e.g. ``functools.partial(torch.optim.SGD, lr=...)``.
        trainable_mask: a tree of bools over ``model.params`` (a bool may
            cover a subtree) that overrides ``lora_only``/``train_lmhead``.
        offload_optimizer: keep fp32 masters and the optimizer state on
            the host and update there (:class:`_HostOptimizer`).
        attn_impl: the model's attention path ('auto'/'flash' run the
            kernels on the card, 'reference' the einsum).
        remat: the checkpointing policy when ``model.checkpointing``:
            'full' recomputes each layer, 'attn' keeps the attention
            output and its lse (``models/modules.py:layer_stack``);
            ignored without checkpointing, as in JAX.
    """

    def __init__(self, model, learning_rate: float = 1e-4,
                 grad_accum: int = 1, lora_only=None, train_lmhead=False,
                 weight_decay: float = 0.0, optimizer=None,
                 attn_impl: str = 'auto', trainable_mask=None,
                 offload_optimizer: bool = False, remat: str = 'full'):
        check_remat(remat)
        if grad_accum < 1:
            raise ValueError(f'grad_accum must be >= 1, got {grad_accum}')
        self.model = model
        self.attn_impl = attn_impl
        self.remat = remat
        self.grad_accum = int(grad_accum)
        self.step = 0
        self._mask = trainable_mask if trainable_mask is not None else \
            model.trainable_filter(lora_only=lora_only,
                                   train_lmhead=train_lmhead)
        self._lora_dropout = _lora_dropout_rate(model)
        self._views = train_views(model.params, self._mask)
        self._params = _trained(self._views)
        if not self._params:
            raise ValueError('MaskedPLM: no leaf of the model trains under '
                             'this mask (lora_only without adapters?)')
        self._acc = {}
        self._host = None
        if offload_optimizer:
            # torch's one-pass CPU kernel for Adam and AdamW on the host
            adam = {} if optimizer else {'fused': True}
            self._host = _HostOptimizer(model.params, lambda views: (
                build_optimizer(views, optimizer, learning_rate,
                                weight_decay, **adam)), self._mask)
            self.optimizer = self._host.optimizer
        else:
            self.optimizer = build_optimizer(self._views, optimizer,
                                             learning_rate, weight_decay)
        # the optimizer's params are the masters' rows when offloaded
        self._view_key = view_key(named_views(
            self._host.views if self._host else self._views), self.optimizer)
        if self._host is not None:
            self._view_key['masters'] = self._host.names

    # -- state ------------------------------------------------------------

    @property
    def state(self) -> TrainState:
        """The params (``model.params``, the live tensors), the optimizer's
        state, the step, inside a ``grad_accum`` cycle the running mean of
        its gradients so far, under ``offload_optimizer`` the fp32
        masters, and the views that name them, so that a restored trainer
        continues as the saved one would have, bit for bit."""
        host = self._host
        accum = None
        if self.step % self.grad_accum:
            accum = list(host._grads) if host is not None else \
                [self._acc.get(p) for p in self._params]
        masters = None if host is None else [m for _, m, _ in host._up]
        return TrainState(self.model.params, self.optimizer.state_dict(),
                          self.step, accum, masters, self._view_key)

    @state.setter
    def state(self, state: TrainState) -> None:
        """Take a saved state (:meth:`CheckpointManager.restore
        <esme_tpu_torch.train.checkpoint.CheckpointManager.restore>`): the
        params, masters and running mean copied into the live tensors by
        leaf path and view, bit for bit, and the optimizer's state by
        view. Raises ``ValueError`` naming a leaf missing on either side
        or of another shape or dtype (:class:`TrainState`). A state without
        masters restored under ``offload_optimizer`` takes its params as
        masters, as a new trainer does."""
        key = self._view_key
        saved = restore_params(self.model.params, state, key)
        host = self._host
        if host is not None:
            masters = [m for _, m, _ in host._up]
            with torch.no_grad():
                for param, master, _ in host._up:
                    master.copy_(param)
                if state.masters is not None:
                    for m, v in zip(masters, by_view(
                            state.masters, saved.get('masters', key[
                                'masters']), key['masters'], masters)):
                        m.copy_(v)
        _load_optimizer(self.optimizer, state.opt_state, saved, key)
        self.step = int(state.step)
        self._acc.clear()
        if self.step % self.grad_accum:
            if state.accum is None:
                raise ValueError('the state is inside a grad_accum cycle '
                                 'but holds no accumulated gradients')
            like = host._grads if host is not None else self._params
            accum = by_view(state.accum, saved['trained'], key['trained'],
                            like)
            if host is not None:
                with torch.no_grad():
                    for t, g in zip(host._grads, accum):
                        t.copy_(g)
            else:
                for p, g in zip(self._params, accum):
                    self._acc[p] = torch.zeros_like(p) if g is None \
                        else g.to(p.device, copy=True)

    # -- the step ---------------------------------------------------------

    def _loss(self, params, batch, dropout_key=None) -> torch.Tensor:
        dev = self.model.device
        with span('esme.train.batch'):
            tokens = _tensor(batch.masked_tokens, torch.int32, dev)
            cu_lens = _tensor(batch.cu_lens, torch.int32, dev)
            seg_ids, pos_ids = packed_meta(cu_lens, tokens.shape[0])
        with span('esme.train.forward'):
            logits = forward_flat(
                params, self.model.config, tokens, seg_ids, pos_ids,
                with_head=True, attn_impl=self.attn_impl,
                checkpointing=self.model.checkpointing,
                max_seqlen=int(batch.max_len), remat=self.remat,
                lora_dropout=self._lora_dropout, dropout_key=dropout_key)
        # the targets go up once the forward is queued, behind its kernels
        with span('esme.train.loss'):
            return cross_entropy(
                logits, _tensor(batch.tokens, torch.int64, dev),
                _tensor(batch.mask, torch.bool, dev))

    def _zero_grads(self):
        for p in self._params:
            p.grad = None

    def _grad_step(self, batch):
        """Loss and gradients of one batch, without an update: returns
        ``(loss, grads)`` with ``grads`` in the layout of
        ``model.params``. Drops any gradient still being accumulated."""
        self._zero_grads()
        self._acc.clear()
        with fp32_accumulation():
            loss = self._loss(self._views, batch,
                              _dropout_key(self._lora_dropout, self.step))
            with span('esme.train.backward'):
                loss.backward()
        grads = _grad_tree(self._views)
        self._zero_grads()
        return loss.detach(), grads

    def training_step(self, batch) -> float:
        """One (micro-)batch step; returns its loss
        (reference: esme/trainer.py:31-35)."""
        t0 = time.perf_counter()
        n = self.step % self.grad_accum
        with fp32_accumulation():
            loss = self._loss(self._views, batch,
                              _dropout_key(self._lora_dropout, self.step))
            with span('esme.train.backward'):
                loss.backward()
            self.step += 1
            emit = self.step % self.grad_accum == 0
            with span('esme.train.optimizer'):
                if self._host is not None:
                    self._host.sync()
                    self._host.ms = {
                        'device': (time.perf_counter() - t0) * 1e3}
                    self._host.take_grads(self._params, n)
                    if emit:
                        self._host.update()
                else:
                    if self.grad_accum > 1:
                        accumulate(self._acc, self._params, n)
                    if emit:
                        for p in self._params:
                            p.grad = self._acc.pop(p, p.grad)
                        self.optimizer.step()
                        self._zero_grads()
        with span('esme.train.sync'):
            return float(loss.detach())

    @torch.no_grad()
    def validation_step(self, batch) -> float:
        """Loss without updates (reference: esme/trainer.py:37-41)."""
        with fp32_accumulation():
            loss = self._loss(self.model.params, batch)
        with span('esme.train.sync'):
            return float(loss)

    def fit(self, dataset, epochs: int = 1, val_dataset=None,
            log_every: int = 0, set_epoch=None, logger=None):
        """Epoch loop over an iterable of PackedBatch; returns the
        per-step losses.

        ``logger``: an :class:`esme_tpu_torch.logger.MetricLogger` (or an
        object with its ``log(dict, step=...)`` and ``track_best(dict)``)
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


class RegressionTrainer:
    """PLM and pooled-head regression fine-tuning (reference:
    esme/trainer.py:47-104; ``esme_tpu/train/trainer.py:261-401``).

    ``head='aggregation'``: the learned-attention-aggregation head
    (:func:`~esme_tpu_torch.models.heads.apply_learned_aggregation`,
    ``head_attention_heads`` heads); ``head='cls'``: the mean-pool MLP head.
    The trunk's leaves that ``model.trainable_filter(lora_only)`` marks
    train with Adam at ``lr``, the head's with Adam at ``head_lr``
    (reference: esme/trainer.py:92-103); the others take no gradient and
    keep their bits. ``head_params`` is updated in place.

    A batch is a :class:`~esme_tpu_torch.data.PackedBatch` with ``labels``
    (:class:`~esme_tpu_torch.data.LabeledDataset`); its padded segments
    (length 0) weigh 0 in the loss and are cut from :meth:`predict`.
    """

    def __init__(self, model, head_params, head: str = 'aggregation',
                 head_lr: float = 1e-3, lr: float = 1e-4,
                 head_attention_heads: int = 4, lora_only=None,
                 attn_impl: str = 'auto'):
        if head not in ('aggregation', 'cls'):
            raise ValueError(f'unknown head: {head}')
        self.model = model
        self.head = head
        self.head_params = head_params
        self.head_attention_heads = head_attention_heads
        self.attn_impl = attn_impl
        self.step = 0
        self._lora_dropout = _lora_dropout_rate(model)
        self._views = train_views(model.params,
                                  model.trainable_filter(lora_only=lora_only))
        self._head_views = _map(_trainable, head_params)
        groups = [{'params': ps, 'lr': rate} for ps, rate in (
            (_trained(self._views), lr),
            (_trained(self._head_views), head_lr)) if ps]
        self._params = [p for g in groups for p in g['params']]
        self.optimizer = torch.optim.Adam(groups, lr=lr)
        self._view_key = view_key(
            named_views(self._views, 'plm.')
            + named_views(self._head_views, 'head.'), self.optimizer)

    # -- state ------------------------------------------------------------

    @property
    def state(self) -> TrainState:
        """The params (``{'plm': model.params, 'head': head_params}``, the
        live tensors), the optimizer's state, the step and the views that
        name the optimizer's ids (``plm.``- and ``head.``-prefixed)."""
        return TrainState({'plm': self.model.params,
                           'head': self.head_params},
                          self.optimizer.state_dict(), self.step,
                          views=self._view_key)

    @state.setter
    def state(self, state: TrainState) -> None:
        """Take a saved state (:meth:`CheckpointManager.restore
        <esme_tpu_torch.train.checkpoint.CheckpointManager.restore>`):
        its params copied into the live tensors by leaf path, bit for bit,
        and the optimizer's state (both learning-rate groups) by view, as
        :meth:`MaskedPLM.state`'s setter."""
        saved = restore_params({'plm': self.model.params,
                                'head': self.head_params}, state,
                               self._view_key)
        _load_optimizer(self.optimizer, state.opt_state, saved,
                        self._view_key)
        self.step = int(state.step)

    # -- the step ---------------------------------------------------------

    def _batch_meta(self, batch):
        """Segment ids and positions, the segment count and each segment's
        loss weight (0 for a padded, empty segment)."""
        dev = self.model.device
        tokens = _tensor(batch.tokens, torch.int32, dev)
        cu_lens = _tensor(batch.cu_lens, torch.int32, dev)
        seg_ids, pos_ids = packed_meta(cu_lens, tokens.shape[0])
        lens = np.diff(np.asarray(batch.cu_lens))
        weight = torch.as_tensor((lens > 0).astype(np.float32), device=dev)
        return tokens, seg_ids, pos_ids, len(lens), weight

    def _predict(self, plm, head, tokens, seg_ids, pos_ids, num_segments,
                 max_seqlen, dropout_key=None):
        rep = forward_flat(
            plm, self.model.config, tokens, seg_ids, pos_ids,
            with_head=False, attn_impl=self.attn_impl,
            checkpointing=self.model.checkpointing, max_seqlen=max_seqlen,
            lora_dropout=self._lora_dropout, dropout_key=dropout_key)
        if self.head == 'aggregation':
            return apply_learned_aggregation(head, rep, seg_ids, num_segments,
                                             self.head_attention_heads)
        return apply_cls_head(head, rep, seg_ids, num_segments)

    def _loss_fn(self, pred, labels, weight):
        return mse_loss(pred, labels, weight)

    def _grad_step(self, batch):
        """The loss of one batch with the gradients in the trainable
        views' ``.grad`` (the dropout of this step's key), without an
        update."""
        tokens, seg_ids, pos_ids, S, weight = self._batch_meta(batch)
        key = _dropout_key(self._lora_dropout, self.step)
        for p in self._params:
            p.grad = None
        with fp32_accumulation():
            pred = self._predict(self._views, self._head_views, tokens,
                                 seg_ids, pos_ids, S, int(batch.max_len), key)
            loss = self._loss_fn(pred, _tensor(batch.labels, torch.float32,
                                               self.model.device), weight)
            loss.backward()
        return loss.detach()

    def training_step(self, batch) -> float:
        """One update; returns the batch's loss."""
        loss = self._grad_step(batch)
        with fp32_accumulation():
            self.optimizer.step()
        for p in self._params:
            p.grad = None
        self.step += 1
        return float(loss)

    @torch.no_grad()
    def predict(self, batch) -> np.ndarray:
        """The head's outputs for the batch's real (non-padded) sequences,
        fp32 on the host; no dropout."""
        tokens, seg_ids, pos_ids, S, weight = self._batch_meta(batch)
        with fp32_accumulation():
            pred = self._predict(self.model.params, self.head_params, tokens,
                                 seg_ids, pos_ids, S, int(batch.max_len))
        n_real = int((np.diff(np.asarray(batch.cu_lens)) > 0).sum())
        return pred[:n_real].float().cpu().numpy()

    def fit(self, dataset, epochs: int = 1, val_dataset=None,
            set_epoch=None, logger=None):
        """Epoch loop with per-epoch validation metrics; ``dataset`` may
        be a callable ``epoch -> iterable`` (a reshuffle or re-balance per
        epoch) or an iterable. ``logger``: a
        :class:`~esme_tpu_torch.logger.MetricLogger` receiving each
        epoch's record; without one it is printed."""
        history = []
        for epoch in range(epochs):
            if set_epoch is not None:
                set_epoch(epoch)
            ds = dataset(epoch) if callable(dataset) else dataset
            losses = [self.training_step(b) for b in ds]
            rec = {'epoch': epoch,
                   'train_loss': float(np.mean(losses)) if losses
                   else float('nan')}
            if val_dataset is not None:
                rec.update(self.validation_metrics(val_dataset))
            history.append(rec)
            if logger is not None:
                logger.log(rec, step=self.step)
                logger.track_best(rec)
            else:
                print(' '.join(f'{k}={v:.5g}' if isinstance(v, float)
                               else f'{k}={v}' for k, v in rec.items()))
        return history

    def _predictions(self, dataset):
        preds, targets = [], []
        for batch in dataset:
            p = self.predict(batch)
            preds.append(p)
            targets.append(np.asarray(batch.labels)[:len(p)])
        return np.concatenate(preds), np.concatenate(targets)

    def validation_metrics(self, dataset) -> dict:
        """``val_mse`` and ``val_spearman`` (reference:
        esme/trainer.py:59-60,95-98)."""
        pred, target = self._predictions(dataset)
        return {'val_mse': float(((pred - target) ** 2).mean()),
                'val_spearman': _spearman(pred, target)}


class ClassificationTrainer(RegressionTrainer):
    """PLM and pooled-head binary classification with BCE on logits
    (reference: workflow/tf/finetune.py; ``esme_tpu/train/trainer.py:
    404-432``): :class:`RegressionTrainer`'s machinery, ``predict``
    returns logits, validation reports BCE, AUROC and AUPRC."""

    def _loss_fn(self, pred, labels, weight):
        return bce_with_logits(pred, labels, weight)

    def validation_metrics(self, dataset) -> dict:
        """``val_bce``, ``val_auroc`` and ``val_auprc`` (in float64)."""
        logits, target = self._predictions(dataset)
        logits = logits.astype(np.float64)
        target = target.astype(np.float64)
        per = np.maximum(logits, 0) - logits * target \
            + np.log1p(np.exp(-np.abs(logits)))
        return {'val_bce': float(per.mean()),
                'val_auroc': auroc(target, logits),
                'val_auprc': auprc(target, logits)}
