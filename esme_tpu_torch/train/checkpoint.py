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
the offloaded masters), a
:class:`~esme_tpu_torch.train.distributed.ShardedTrainState`, or a tree
of dicts, lists, tensors and numbers; it is read back with
``weights_only=True``, which runs no pickled code. ``max_to_keep``
checkpoints stay: with a ``monitor`` metric the best of them by ``mode``
(a tie keeps the newer), else the newest. A checkpoint is written under a
temporary name and renamed when complete, so a crash leaves no
half-written one.

A sharded trainer's state is saved as JAX's orbax manager saves a sharded
one, each part from where it lives: every rank of the default process
group calls :meth:`CheckpointManager.save` with its own part and writes
``rank<r>.pt`` into the temporary directory, and rank 0 renames the
directory into place once every rank's part is complete (barriers of the
process group around it); :meth:`~CheckpointManager.restore` reads each
rank's own part back. A part restores only on a mesh of the shape and at
the rank it was saved from.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from .distributed import ShardedTrainState
from .trainer import TrainState

_STATES = {'train_state': TrainState,
           'sharded_train_state': ShardedTrainState}


def _to_devices(saved, template):
    """``saved`` with each tensor on the device of ``template``'s tensor
    at the same place (a tree of dicts, lists and tuples)."""
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
        its part of a :class:`ShardedTrainState`."""
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
        there is none), each tensor on the device of ``state_template``'s
        tensor at its place (the CPU without a template). A trainer takes
        it back with ``trainer.state = manager.restore(trainer.state)``; a
        sharded trainer's ranks each take their own part so."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        name = f'rank{dist.get_rank()}.pt' if isinstance(
            state_template, ShardedTrainState) else 'state.pt'
        saved = torch.load(self.directory / str(step) / name,
                           map_location='cpu', weights_only=True)
        if isinstance(saved, dict) and len(saved) == 1 \
                and next(iter(saved)) in _STATES:
            key, fields = next(iter(saved.items()))
            saved = _STATES[key](**fields)
        return _to_devices(saved, state_template) \
            if state_template is not None else saved
