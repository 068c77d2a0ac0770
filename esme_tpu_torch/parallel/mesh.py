"""Process group and device mesh construction.

Counterpart of ``esme_tpu/parallel/mesh.py``: where the JAX package
initialises its distributed runtime and builds a device ``Mesh`` with
named axes, the port initialises a ``torch.distributed`` process group
(NCCL on CUDA, gloo on the CPU) and builds a ``DeviceMesh`` with named
axes over its ranks. One process drives one device.

Axes:
  * ``data`` — data parallelism (each slice owns its own packed batch);
  * ``fsdp`` — parameter/optimizer sharding (ROADMAP.md Queue 1, item 24);
  * ``seq`` — context parallelism: the packed token axis is split over
    it (:mod:`esme_tpu_torch.parallel.context`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# the process group's backend for each device type
BACKENDS = {'cuda': 'nccl', 'cpu': 'gloo'}


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device: str = 'cuda'):
    """Join the default process group: ``num_processes`` processes meet at
    ``coordinator_address`` (``'host:port'``, as JAX takes it), this one
    as rank ``process_id``. NCCL on ``device='cuda'`` (the default; each
    process then takes card ``process_id % device_count``), gloo on
    ``'cpu'``. A no-op without an address, as in JAX; raises when a group
    already exists."""
    if coordinator_address is None:
        return
    if device not in BACKENDS:
        raise ValueError(f'initialize_distributed: unknown device {device!r}'
                         f'; one of {tuple(BACKENDS)}')
    if dist.is_initialized():
        raise RuntimeError('initialize_distributed: a process group exists')
    if device == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                'initialize_distributed: no CUDA device; pass device=\'cpu\' '
                'for a gloo group')
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(BACKENDS[device],
                            init_method=f'tcp://{coordinator_address}',
                            world_size=num_processes, rank=process_id)


def make_mesh(data: int = 1, fsdp: Optional[int] = None,
              devices: Optional[Sequence[int]] = None, *,
              seq: Optional[int] = None, device: str = 'cuda') -> DeviceMesh:
    """A ``(data, fsdp)`` mesh over the process group's ranks, as JAX's
    ``make_mesh`` builds one over its devices; with ``seq``, a ``(data,
    fsdp, seq)`` mesh (the axes of JAX's context-parallel training mesh).

    ``devices``: the ranks, in mesh order (every rank when None).
    ``fsdp=None`` takes all remaining ranks. ``device``: the mesh's device
    type, ``'cuda'`` by default or ``'cpu'`` for a gloo group. Needs
    :func:`initialize_distributed` first.
    """
    if not dist.is_initialized():
        raise RuntimeError('make_mesh: no process group; call '
                           'initialize_distributed first')
    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    n = len(ranks)
    s = 1 if seq is None else seq
    if fsdp is None:
        if n % (data * s):
            raise ValueError(f'{n} ranks not divisible by data={data} x '
                             f'seq={s}')
        fsdp = n // (data * s)
    if data * fsdp * s != n:
        raise ValueError(f'mesh {data}x{fsdp}x{s} != {n} ranks')
    shape, names = (data, fsdp), ('data', 'fsdp')
    if seq is not None:
        shape, names = shape + (seq,), names + ('seq',)
    return DeviceMesh(device, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=names)


def axes_group(mesh: DeviceMesh, axes: Sequence[str]):
    """The process group of the ranks that share this rank's place on
    every axis of ``mesh`` but ``axes`` (JAX's collective over a tuple of
    mesh axes, ``psum(x, axes)``). Every rank of the process group must
    call it, in the same order: each group is created collectively."""
    names = mesh.mesh_dim_names
    keep = [names.index(a) for a in axes]
    other = [i for i in range(len(names)) if i not in keep]
    ranks = mesh.mesh.permute(*other, *keep).reshape(
        -1, math.prod(mesh.size(i) for i in keep)).tolist()
    me = dist.get_rank()
    mine = None
    for row in ranks:
        group = dist.new_group(row)
        if me in row:
            mine = group
    return mine
