"""Training checkpoints: save, keep the best, resume.

Counterpart of ``esme_tpu/train/checkpoint.py:29-86`` (reference:
Lightning's ``ModelCheckpoint`` and ``fit(ckpt_path=...)``, which resumes
from the newest checkpoint, workflow/meltome/finetune_meltome.py:31-41).
The JAX manager writes orbax checkpoints; this one writes torch state
files, and reads no orbax file:

    DIR/<step>/state.pt      a trainer's state (``torch.save``)
    DIR/<step>/rank<r>.pt    or rank r's part of a sharded trainer's
    DIR/<step>/metrics.json  the metrics saved with it

A state is a trainer's :class:`~esme_tpu_torch.train.trainer.TrainState`
(params, the optimizer's ``state_dict()``, step, and for
:class:`~esme_tpu_torch.train.MaskedPLM` an open accumulation cycle and
the offloaded masters; ``views``, the names of the optimizer's param ids
and of the lists' entries), a
:class:`~esme_tpu_torch.train.distributed.ShardedTrainState`, or a tree
of dicts, lists, tensors and numbers; it is read back with
``weights_only=True``, which runs no pickled code. A trainer takes a
state back by leaf path, as orbax restores JAX's by tree path: params by
dotted path, the optimizer's state, the open cycle and the masters by
the view (``[leaf path, layer]``) that ``views`` names, so that two
models of the same leaves listed in other orders (the init's tree,
``params_from_jax``'s sorted one, quantize-at-load against
``quantize()``) restore into each other bit for bit; a leaf missing on
either side or of another shape or dtype raises ``ValueError`` naming it
(a frozen leaf saved in a dtype whose values convert exactly, as NF4's
outlier rows of the two quantize routes, is taken). A state saved
before ``views`` were recorded restores where its params list the
trainer's paths in the same order, and raises naming the first leaf
that differs otherwise. ``max_to_keep``
checkpoints stay: with a ``monitor`` metric the best of them by ``mode``
(a tie keeps the newer), else the newest. A checkpoint is written under a
temporary name and renamed when complete, so a crash leaves no
half-written one.

A sharded trainer's state is saved as JAX's orbax manager saves a sharded
one, each part from where it lives: every rank of the default process
group calls :meth:`CheckpointManager.save` with its own part and writes
``rank<r>.pt`` into the temporary directory, and rank 0 renames the
directory into place once every rank's part is complete (barriers of the
process group around it). As orbax writes each replicated shard once, a
rank at a ``data`` or ``seq`` coordinate other than 0 writes no param or
optimizer tensor: the rank at ``data`` and ``seq`` 0 of its ``fsdp``
coordinate holds the same bits and writes them; the replica writes its
own open cycle's gradients (each rank's partial sums differ, below), its
step and its layout. :meth:`~CheckpointManager.restore` with a
sharded trainer's state as template gives each rank its own part: on a
mesh of the layout the state was saved from, the rank's own file (a
replica's params and optimizer state from its holder's); on a
mesh of another shape (other ``data``, ``fsdp`` or ``seq`` sizes, or
another ``seq_axis``), its part resharded from the saved ones, as orbax
restores into the template's shardings (``esme_tpu/train/checkpoint.py:
54-86``). Each rank reads the files, memory-mapped and one leaf at a
time, and runs no collective, so parts saved by a gloo world on the host
restore in an NCCL world on the card and the other way round:

* params (frozen and quantized leaves included) and every optimizer
  state tensor of its param's shape (Adam's moments, ``adam8bit``'s e5m2
  codes) are rebuilt from the blocks of data row 0 and ``seq`` 0 and cut
  along the template's shard dim
  (:func:`~esme_tpu_torch.parallel.fsdp.reshard_leaf`); a scalar (a step
  count, ``adam8bit``'s scales, global over ``fsdp``) is taken once and
  must be equal in every part that holds optimizer state;
* an open ``grad_accum`` cycle keeps what the cycle's end would sum
  (``ShardedMaskedPLM._reduce_grads``): each leaf's ``.grad`` summed over
  its old reduce group in coordinate order (the loss axes, and for a
  replicated leaf ``fsdp`` too: its gradient is each rank's share of a
  loss divided by the ``fsdp`` size) goes to the rank at coordinate 0 of
  its new group, and ``-0.0`` to the others, so that the new cycle's sum
  is that total (``x + -0.0`` is ``x`` for every ``x``, the sign of a
  zero included). JAX needs no such step: ``optax.MultiSteps`` keeps its
  gradients already reduced;
* a template of another model, trainable mask or optimizer raises
  ``ValueError`` naming the leaf, as does a checkpoint saved before a part
  recorded its layout (no ``specs``), which restores only on its own mesh
  shape.
"""

from __future__ import annotations

import json
import math
import os
import shutil
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.fsdp import reshard_leaf
from .distributed import ShardedTrainState
from .trainer import TrainState, _named, check_views, optimizer_ids

_STATES = {'train_state': TrainState,
           'sharded_train_state': ShardedTrainState}


def _to_devices(saved, template):
    """``saved`` with each tensor on the device of ``template``'s tensor
    of the same name: in a trainer's state the params by dotted path, its
    lists and optimizer state left on the host (the trainer's setter
    pairs them by view and puts each on its tensor's device); in any
    other tree of dicts, lists and tuples, at the same place."""
    if isinstance(saved, tuple(_STATES.values())) \
            and type(template) is type(saved):
        return saved._replace(params=_to_devices(saved.params,
                                                 template.params))
    if isinstance(saved, dict) and isinstance(template, dict):
        return {k: _to_devices(v, template.get(k)) for k, v in saved.items()}
    if isinstance(saved, (list, tuple)) and isinstance(
            template, (list, tuple)) and len(saved) == len(template):
        out = [_to_devices(s, t) for s, t in zip(saved, template)]
        return type(saved)(*out) if hasattr(saved, '_fields') \
            else type(saved)(out)
    if torch.is_tensor(saved) and torch.is_tensor(template):
        return saved.to(template.device)
    return saved


def _load(path, mmap: bool = False):
    """A state file's content (a trainer state as its class); with
    ``mmap`` its tensors map the file and are read where used."""
    saved = torch.load(path, map_location='cpu', weights_only=True,
                       mmap=mmap)
    if isinstance(saved, dict) and len(saved) == 1 \
            and next(iter(saved)) in _STATES:
        key, fields = next(iter(saved.items()))
        saved = _STATES[key](**fields)
    return saved


def _replica(mesh: dict) -> bool:
    """Whether the rank of a part of layout ``mesh`` is a replica: at a
    coordinate other than 0 on an axis other than ``fsdp``."""
    return any(c for a, c in zip(mesh['axes'], mesh.get('coords', ()))
               if a != 'fsdp')


def _holder(step_dir: Path, mesh: dict) -> ShardedTrainState:
    """The part (memory-mapped) that holds the params and optimizer
    state of a replica's part of layout ``mesh``: the part at its
    ``fsdp`` coordinate and at 0 on every other axis."""
    want = [c if a == 'fsdp' else 0
            for a, c in zip(mesh['axes'], mesh['coords'])]
    for r in range(math.prod(mesh['shape'])):
        part = _load(step_dir / f'rank{r}.pt', mmap=True)
        if list(part.mesh['coords']) == want:
            return part
    raise ValueError(f'no part of {step_dir} is at coordinates {want}')


def _same_layout(saved: dict, mine: dict) -> bool:
    """Whether a rank's own part of layout ``saved``
    (``ShardedTrainState.mesh``) is its part on a mesh of layout
    ``mine``: the same axes and sizes, and where ``saved`` records them,
    the same loss axes and shard dims."""
    keys = ('axes', 'shape', 'loss_axes', 'specs') if 'specs' in saved \
        else ('axes', 'shape')
    return all(saved[k] == mine[k] for k in keys)


def _map_named(fn, tree: dict, path: str = '') -> dict:
    """``fn(dotted path, leaf)`` over a dict tree."""
    return {k: _map_named(fn, v, f'{path}{k}.') if isinstance(v, dict)
            else fn(f'{path}{k}', v) for k, v in tree.items()}


class _Parts:
    """A sharded checkpoint's parts by mesh coordinate, memory-mapped;
    ``lead``, the part at 0 on every axis; ``holders``, the parts that hold
    params and optimizer state (every part, in a checkpoint written before
    replicas left theirs out)."""

    def __init__(self, step_dir: Path, first: ShardedTrainState):
        mesh = first.mesh
        if 'specs' not in mesh or first.views is None:
            raise ValueError(
                f'the checkpoint {step_dir} records no shard dims (its '
                'parts were saved before a part recorded its layout): it '
                f"restores only on a mesh of its own shape {mesh['shape']} "
                f"over {mesh['axes']}")
        self.axes = list(mesh['axes'])
        self.size = dict(zip(self.axes, mesh['shape']))
        self.loss_axes = list(mesh['loss_axes'])
        self.specs = dict(_named(mesh['specs']))
        self.parts = {}
        for r in range(math.prod(mesh['shape'])):
            part = first if r == 0 else _load(step_dir / f'rank{r}.pt',
                                              mmap=True)
            self.parts[tuple(part.mesh['coords'])] = part
        self.lead = self.select()[0]
        self.holders = [p for p in self.parts.values()
                        if p.opt_state is not None]

    def select(self, free=(), **at) -> list:
        """The parts at coordinate ``at`` (0 where not given) on every
        axis but ``free``, in coordinate order."""
        fixed = [(i, at.get(a, 0)) for i, a in enumerate(self.axes)
                 if a not in free]
        return [p for c, p in sorted(self.parts.items())
                if all(c[i] == v for i, v in fixed)]

    def blocks(self, dim: Optional[int], get) -> list:
        """``get(part)`` of data row 0 and ``seq`` 0 (the parts that hold
        params and optimizer state) for each ``fsdp`` block of a leaf
        sharded on ``dim`` (one part for a replicated leaf)."""
        n = self.size['fsdp'] if dim is not None else 1
        return [get(self.select(fsdp=i)[0]) for i in range(n)]


def _view_dim(specs: dict, name) -> Optional[int]:
    """The shard dim of a trained view ``[path, layer]``: its leaf's, less
    the stacked layer axis for a per-layer view."""
    path, layer = name
    d = specs[path]
    return d - 1 if d is not None and layer is not None else d


def _sum(tensors: list):
    """The sum of ``tensors`` in order, None terms skipped (None if every
    term is)."""
    out = None
    for t in tensors:
        if t is not None:
            out = t.clone() if out is None else out.add_(t)
    return out


def _check_params(old: _Parts, saved: dict, live: dict, specs: dict,
                  n: int) -> None:
    """Raise ``ValueError`` naming the first leaf whose path, whole shape
    or dtype differs between the saved part and the template."""
    def whole(t, d, k):
        return tuple(s * k if i == d else s for i, s in enumerate(t.shape))
    for path in sorted(set(live) | set(saved)):
        if path not in live or path not in saved:
            where = ('the template', 'the saved state')
            raise ValueError(f'leaf {path} is in {where[path in saved]} '
                             f'but not in {where[path in live]}: another '
                             'model')
        a = whole(saved[path], old.specs[path], old.size['fsdp'])
        b = whole(live[path], specs[path], n)
        if a != b or saved[path].dtype != live[path].dtype:
            raise ValueError(
                f'leaf {path} was saved as {a} {saved[path].dtype}; the '
                f'template has {b} {live[path].dtype}: another model')


def _reshard(step_dir: Path, first: ShardedTrainState,
             template: ShardedTrainState) -> ShardedTrainState:
    """``template``'s part of the sharded state saved in ``step_dir`` on a
    mesh of another layout (the module docstring)."""
    old = _Parts(step_dir, first)
    mesh = template.mesh
    at = dict(zip(mesh['axes'], mesh['coords']))
    n, f = dict(zip(mesh['axes'], mesh['shape']))['fsdp'], at['fsdp']
    specs = dict(_named(mesh['specs']))
    lead = old.lead
    check_views(lead.views, template.views)
    live = dict(_named(template.params))
    _check_params(old, dict(_named(lead.params)), live, specs, n)
    steps = {int(p.step) for p in old.parts.values()}
    if len(steps) != 1:
        raise ValueError(f'the saved parts are at steps {sorted(steps)}')

    def leaf(tree, path):
        for k in path.split('.'):
            tree = tree[k]
        return tree

    params = _map_named(lambda path, t: reshard_leaf(
        old.blocks(old.specs[path], lambda p: leaf(p.params, path)),
        old.specs[path], specs[path], n, f).to(t.device), template.params)

    # the optimizer's state by view: the template's param ids and groups,
    # each group's hyperparameters and each id's state from the saved id
    # of the same view (the trees of two models of the same leaves may
    # list them in other orders), over the parts that hold it
    order, groups = optimizer_ids(lead.views, lead.opt_state,
                                  template.views, template.opt_state)
    state = {}
    for pid, name in enumerate(template.views['optimizer']):
        entries = [p.opt_state['state'].get(order[pid])
                   for p in old.holders]
        if entries[0] is None:
            if any(e is not None for e in entries):
                raise ValueError(f'optimizer state of {name[0]} saved by '
                                 'some parts only')
            continue
        device = live[name[0]].device
        od, nd = _view_dim(old.specs, name), _view_dim(specs, name)
        state[pid] = {}
        for key, v in entries[0].items():
            if torch.is_tensor(v) and v.dim() > 0:
                v = reshard_leaf(old.blocks(od, lambda p: p.opt_state[
                    'state'][order[pid]][key]), od, nd, n, f).to(device)
            elif any(not (torch.equal(e[key], v) if torch.is_tensor(v)
                          else e[key] == v) for e in entries):
                raise ValueError(f'optimizer state {key!r} of {name[0]} '
                                 'differs between the saved parts')
            state[pid][key] = v
    opt_state = {'state': state, 'param_groups': groups}

    # the open cycle as the sums its end would take (the module
    # docstring); JAX's optax.MultiSteps keeps its gradients reduced and
    # needs no such step
    accum = None
    if first.accum is not None:
        lead = all(at[a] == 0 for a in mesh['loss_axes'])
        index = {tuple(v): i for i, v in enumerate(first.views['trained'])}
        accum = []
        for name in template.views['trained']:
            i = index[tuple(name)]
            od, nd = _view_dim(old.specs, name), _view_dim(specs, name)
            reduce = [old.select((*old.loss_axes, 'fsdp'))] if od is None \
                else [old.select(old.loss_axes, fsdp=j)
                      for j in range(old.size['fsdp'])]
            blocks = [_sum([p.accum[i] for p in parts]) for parts in reduce]
            if any(b is None for b in blocks):
                accum.append(None)
                continue
            g = reshard_leaf(blocks, od, nd, n, f)
            if not (lead and (nd is not None or f == 0)):
                g = torch.zeros_like(g).neg_()
            accum.append(g.to(live[name[0]].device))
    return ShardedTrainState(params, opt_state, int(first.step), accum, mesh,
                             template.views)


class CheckpointManager:
    """Save and restore trainer states with a best-metric policy."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 monitor: Optional[str] = 'val_loss', mode: str = 'min'):
        if mode not in ('min', 'max'):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        if max_to_keep < 1:
            raise ValueError(f'max_to_keep must be >= 1, got {max_to_keep}')
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = int(max_to_keep)
        self.monitor = monitor
        self.mode = mode

    def all_steps(self) -> list:
        """The steps of the complete checkpoints on disk, ascending."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and ((p / 'state.pt').is_file()
                                               or (p / 'rank0.pt').is_file()))

    def metrics(self, step: int) -> dict:
        with open(self.directory / str(step) / 'metrics.json') as f:
            return json.load(f)

    def _rank_key(self, step: int):
        """Sort key: the best checkpoint last (a tie: the newer)."""
        value = self.metrics(step).get(self.monitor)
        if value is None:
            return (0, 0.0, step)       # no metric: dropped first
        return (1, value if self.mode == 'max' else -value, step)

    def save(self, step: int, state, metrics: Optional[dict] = None):
        """Write ``state`` and ``metrics`` as checkpoint ``step``, then
        drop the checkpoints past ``max_to_keep``. Every rank calls it with
        its part of a :class:`ShardedTrainState`; a replica (a rank at
        ``data`` or ``seq`` other than 0) writes its own open cycle's
        gradients, step and layout, and leaves its params and optimizer
        state to the rank at ``data`` and ``seq`` 0 of its ``fsdp``
        coordinate, whose are the same bits."""
        step = int(step)
        final = self.directory / str(step)
        tmp = self.directory / f'.{step}.tmp'
        sharded = isinstance(state, ShardedTrainState)
        rank = dist.get_rank() if sharded else 0
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir()
        if sharded:
            dist.barrier()
        key = next((k for k, cls in _STATES.items()
                    if isinstance(state, cls)), None)
        name = f'rank{rank}.pt' if sharded else 'state.pt'
        if sharded and _replica(state.mesh):
            state = state._replace(params=None, opt_state=None)
        torch.save({key: state._asdict()} if key else state, tmp / name)
        if sharded:
            dist.barrier()
        if rank == 0:
            with open(tmp / 'metrics.json', 'w') as f:
                json.dump({k: float(v) for k, v in (metrics or {}).items()},
                          f)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            self._prune()
        if sharded:
            dist.barrier()

    def _prune(self) -> None:
        steps = self.all_steps()
        if len(steps) > self.max_to_keep:
            keep = sorted(steps, key=self._rank_key) if self.monitor \
                else steps
            for old in keep[:len(steps) - self.max_to_keep]:
                shutil.rmtree(self.directory / str(old))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        """The kept step with the best ``monitor`` value (a tie: the
        newer); None without a monitor or a checkpoint that has it."""
        if not self.monitor:
            return None
        scored = [s for s in self.all_steps()
                  if self.metrics(s).get(self.monitor) is not None]
        return max(scored, key=self._rank_key) if scored else None

    def restore(self, state_template=None, step: Optional[int] = None):
        """The state of checkpoint ``step`` (the latest by default; None if
        there is none), its params on the devices of ``state_template``'s
        leaves of the same paths (the CPU without a template). A trainer
        takes it back with ``trainer.state = manager.restore(
        trainer.state)``; a sharded trainer's ranks each take their own
        part so, on a mesh of the saved shape or, resharded, of another
        (module docstring)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        directory = self.directory / str(step)
        name = 'state.pt'
        if isinstance(state_template, ShardedTrainState):
            first = _load(directory / 'rank0.pt', mmap=True)
            if not _same_layout(first.mesh, state_template.mesh) or (
                    first.views not in (None, state_template.views)):
                return _reshard(directory, first, state_template)
            name = f'rank{dist.get_rank()}.pt'
        saved = _load(directory / name)
        if isinstance(saved, ShardedTrainState) and saved.params is None:
            held = _holder(directory, saved.mesh)
            saved = saved._replace(params=held.params,
                                   opt_state=held.opt_state)
        return _to_devices(saved, state_template) \
            if state_template is not None else saved
