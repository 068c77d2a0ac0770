"""FSDP parameter sharding: shard dims and gather hooks.

Counterpart of ``esme_tpu/parallel/fsdp.py``, ZeRO-3-style sharding
over the ``fsdp`` axis of a mesh:

* every large leaf is sharded on one dimension over the axis, each rank
  holding its contiguous block of it (:func:`fsdp_partition_specs`,
  :func:`shard_params`); small leaves are replicated;
* inside the forward each layer all-gathers just its own shards
  (:func:`make_layer_gather`) and the non-layer leaves are gathered once
  (:func:`make_outer_gather`), so peak memory is one layer's full
  weights plus every layer's shards;
* the gather of a leaf that takes a gradient is an autograd Function
  whose backward reduce-scatters (sums over the ranks, each keeping its
  block) the gradient, JAX's transpose of ``all_gather(..., tiled=True)``;
  a frozen leaf, and an integer one (int8 and NF4 storage, NF4's outlier
  indices), is gathered with no autograd node, so no reduce-scatter ever
  runs for it. A gather concatenates bytes in rank order, so a quantized
  projection's gathered leaves are the unsharded ones bit for bit (NF4's
  nibble pairs lie along the input dim, never split by a shard of the
  output dim);
* the layer gather runs inside the checkpointed layer, so with
  checkpointing it runs again in the backward instead of keeping the
  full weights (ZeRO-3 semantics);
* :func:`reshard_leaf` moves a leaf between two layouts (another shard
  count, dim, or none), one leaf at a time and without a collective: a
  checkpoint's restore on a mesh of another shape
  (``train/checkpoint.py``).

JAX's ``PartitionSpec`` tree becomes a tree of shard dims: per leaf the
dimension sharded over the axis, or None for a replicated leaf. The rule
reads only a leaf's shape, so LoRA leaves (``lora.<name>.a``, ``.b``,
``.scale``) and quantized ones (``qvalue``, ``scale``, ``outlier_idx``,
``outlier_rows``) take JAX's specs as the dense ones do.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .context import _all_gather, _reduce_scatter, axis_size

# leaves below this many elements are replicated (esme_tpu/parallel/
# fsdp.py:39-44)
MIN_SIZE = 2 ** 15


def _map(fn, *trees):
    """``fn`` over the leaves of dicts of the same structure."""
    return {k: _map(fn, *(t[k] for t in trees))
            if isinstance(v, dict) else fn(*(t[k] for t in trees))
            for k, v in trees[0].items()}


def _leaf_dim(leaf: torch.Tensor, n: int, min_size: int) -> Optional[int]:
    """The trailing dimension of ``leaf`` that ``n`` divides (stacked layer
    leaves are ``(L, in, out)``), or None: a leaf below ``min_size``
    elements, or one with no such dimension, is replicated
    (``esme_tpu/parallel/fsdp.py:26-36``)."""
    if leaf.numel() < min_size:
        return None
    for d in reversed(range(leaf.dim())):
        if leaf.shape[d] % n == 0 and leaf.shape[d] >= n:
            return d
    return None


def fsdp_partition_specs(params: dict, mesh: DeviceMesh, axis: str = 'fsdp',
                         min_size: int = MIN_SIZE) -> dict:
    """A tree of shard dims matching ``params``: each large leaf sharded
    on one divisible dimension over ``axis``, small leaves replicated
    (None)."""
    n = axis_size(mesh, axis)
    return _map(lambda leaf: _leaf_dim(leaf, n, min_size), params)


def shard_params(params: dict, mesh: DeviceMesh, specs: Optional[dict] = None,
                 axis: str = 'fsdp') -> tuple[dict, dict]:
    """This rank's shards of ``params`` by ``specs`` (computed when None):
    a sharded leaf's block along its dim, a replicated leaf whole, each a
    contiguous copy. Returns ``(shards, specs)``."""
    specs = fsdp_partition_specs(params, mesh, axis) if specs is None \
        else specs
    n, r = axis_size(mesh, axis), mesh.get_local_rank(axis)

    def shard(leaf, d):
        # a copy even where the block is the whole leaf (n = 1), so that
        # the trainer's in-place updates leave ``params`` as they are
        leaf = leaf.detach()
        return (leaf if d is None else leaf.chunk(n, d)[r]) \
            .clone(memory_format=torch.contiguous_format)
    return _map(shard, params, specs), specs


def reshard_leaf(blocks: list, dim: Optional[int], new_dim: Optional[int],
                 new_n: int, index: int) -> torch.Tensor:
    """The block that rank ``index`` of ``new_n`` holds of a leaf that
    another layout saved as ``blocks``: the ``len(blocks)`` blocks of its
    dim ``dim`` in rank order, or, for ``dim`` None (replicated), copies
    of the whole leaf (the first is read). ``new_dim`` None: the whole
    leaf. A contiguous copy, exact for every dtype (int8 and NF4 storage,
    e5m2 codes): the leaf is rebuilt by concatenation and cut anew, so
    the two layouts may shard different dims, and at most one whole leaf
    and its blocks are in memory at once."""
    whole = blocks[0] if dim is None or len(blocks) == 1 \
        else torch.cat(list(blocks), dim)
    if new_dim is not None:
        if whole.shape[new_dim] % new_n:
            raise ValueError(f'dim {new_dim} of a leaf of '
                             f'{tuple(whole.shape)} does not split in '
                             f'{new_n}')
        whole = whole.chunk(new_n, new_dim)[index]
    return whole.clone(memory_format=torch.contiguous_format)


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's block ``x`` concatenated along ``dim`` in rank order:
    gathered as ``(n, *x.shape)``, then one copy puts the rank axis beside
    ``dim`` (none for ``dim`` 0 or a group of one)."""
    return _all_gather(x.unsqueeze(0), group).movedim(0, dim) \
        .flatten(dim, dim + 1)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's ``x``:
    one copy puts the n blocks along ``dim`` first (none for ``dim`` 0 or
    a group of one), then they are reduce-scattered."""
    n = dist.get_world_size(group)
    blocks = x.unflatten(dim, (n, x.shape[dim] // n)).movedim(dim, 0)
    return _reduce_scatter(blocks, group)[0]


class _GatherDim(torch.autograd.Function):
    """:func:`gather_dim` with its gradient, :func:`reduce_scatter_dim`."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


def _gather_leaf(x: torch.Tensor, d: Optional[int], group) -> torch.Tensor:
    """``x`` gathered along ``d`` (as it is for None): through
    :class:`_GatherDim` where it takes a gradient, else without an
    autograd node (frozen and integer leaves)."""
    if d is None:
        return x
    if x.requires_grad:
        return _GatherDim.apply(x, d, group)
    return gather_dim(x, d, group)


def _gather_tree(params: dict, dims: dict, group) -> dict:
    return _map(lambda x, d: _gather_leaf(x, d, group), params, dims)


def make_layer_gather(layer_specs: dict, mesh: DeviceMesh,
                      axis: str = 'fsdp'):
    """Gather hook for one layer's params: ``layer_specs`` are the shard
    dims of the *stacked* ``(L, ...)`` leaves, so a layer's leaf (the
    leading L gone) is gathered along its dim less one."""
    def dim(d):
        if d == 0:
            raise ValueError('a stacked layer leaf sharded on its layer '
                             'axis has no per-layer gather')
        return None if d is None else d - 1
    dims = _map(dim, layer_specs)
    group = mesh.get_group(axis)

    def gather(layer_params):
        return _gather_tree(layer_params, dims, group)
    return gather


def make_outer_gather(specs: dict, mesh: DeviceMesh, axis: str = 'fsdp'):
    """Gather hook for the non-layer params (embeddings, norms, LM
    head)."""
    group = mesh.get_group(axis)

    def gather(params):
        return _gather_tree(params, specs, group)
    return gather
