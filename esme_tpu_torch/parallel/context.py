"""Context (sequence) parallelism over a mesh axis.

Counterpart of ``esme_tpu/parallel/context.py``. The packed token axis
is split contiguously over a mesh axis: embeddings, LayerNorms, MLPs and
the LM head are token-local and run on the rank's tokens untouched, and
attention gathers keys, values and segment ids from every rank
(``all_gather_into_tensor``, in rank order, as JAX's ``all_gather(...,
tiled=True)``) while the queries stay local: kernel H9, the rectangular
segment-flash forward, and in training kernel H10, its backward
(:func:`esme_tpu_torch.ops.flash.segment_flash_rect`). The gather's
gradient reduce-scatters the keys' and values' gradients over the axis,
JAX's transpose of the tiled all-gather, so the same hook trains
(:class:`esme_tpu_torch.train.ShardedMaskedPLM`). Per-rank activation
memory drops by the axis size.

Where JAX runs one program over the mesh (``shard_map``), the port runs
one process per rank: every rank calls the same function with the same
global inputs and takes its slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along ``axis`` (JAX's ``mesh.shape[axis]``)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


# two collectives under two names each: PyTorch 2.13 renamed
# all_gather_into_tensor to all_gather_single and reduce_scatter_tensor to
# reduce_scatter_single
_GATHER = getattr(dist, 'all_gather_single', None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, 'reduce_scatter_single', None) \
    or dist.reduce_scatter_tensor


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along axis 0 in rank order (``x``
    itself, made contiguous, on a group of one)."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    if n == 1:
        return x
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    _GATHER(out, x, group=group)
    return out


def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """Block r (of n along axis 0, r this rank's index in the group) of
    the sum of every rank's ``x``: the transpose of :func:`_all_gather`
    (``x`` itself, made contiguous, on a group of one)."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    if n == 1:
        return x
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    _REDUCE_SCATTER(out, x, group=group)
    return out


class _GatherRows(torch.autograd.Function):
    """:func:`_all_gather` with its gradient, :func:`_reduce_scatter` (JAX's
    transpose of ``all_gather(..., tiled=True)``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group), None


def make_kv_gather(group_or_mesh_dim):
    """The attention hook: gather this rank's ``(T_loc, H, D)`` keys and
    values and ``(T_loc,)`` segment ids into the global ``(T, H, D)`` and
    ``(T,)`` over ``group_or_mesh_dim``, a process group or a
    one-dimensional DeviceMesh (one axis of a mesh, ``mesh['seq']``).
    The keys' and values' gradients are reduce-scattered (summed over the
    ranks, each rank keeping its own rows); the ids get none."""
    group = group_or_mesh_dim.get_group() \
        if isinstance(group_or_mesh_dim, DeviceMesh) else group_or_mesh_dim

    def kv_gather(k, v, seg_ids):
        return (_GatherRows.apply(k, group), _GatherRows.apply(v, group),
                _all_gather(seg_ids, group))
    return kv_gather


def forward_flat_cp(params, cfg, tokens, seg_ids, pos_ids, *,
                    mesh: DeviceMesh, axis: str = 'seq',
                    with_head: bool = True, log_prob: bool = False,
                    attn_impl: str = 'auto', checkpointing: bool = False,
                    max_seqlen: Optional[int] = None):
    """Context-parallel :func:`esme_tpu_torch.models.esm.forward_flat`:
    every rank of ``mesh``'s ``axis`` holds the global ``tokens``,
    ``seg_ids`` and ``pos_ids`` (``(T,)``), takes its contiguous slice of
    ``T / n`` tokens and returns its token-local rows ``(T / n, C)``.

    ``T`` must be divisible by the axis size (``ValueError``, as in JAX).
    ``attn_impl``: 'auto' or 'flash' runs H9 (its plain version on a CPU
    tensor), 'reference' the einsum ``attention_rect``. ``checkpointing``
    and ``max_seqlen`` are passed on as JAX passes them.
    """
    from ..models.esm import forward_flat
    from ..ops.flash import rect_flash_spans, with_order
    n = axis_size(mesh, axis)
    T = tokens.shape[0]
    if T % n:
        raise ValueError(f'token count {T} not divisible by '
                         f'{axis} axis size {n}')
    r = mesh.get_local_rank(axis)
    lo, hi = r * (T // n), (r + 1) * (T // n)
    seg_ids = seg_ids.to(torch.int32).contiguous()
    # the gathered ids are the global ones, so H9's and H10's spans, and
    # H9's launch order, are known here
    spans = None if attn_impl == 'reference' \
        else with_order(rect_flash_spans(seg_ids[lo:hi], seg_ids))
    return forward_flat(
        params, cfg, tokens[lo:hi], seg_ids[lo:hi], pos_ids[lo:hi],
        with_head=with_head, log_prob=log_prob, attn_impl=attn_impl,
        checkpointing=checkpointing, max_seqlen=max_seqlen,
        kv_gather=make_kv_gather(mesh.get_group(axis)), spans=spans)


def context_parallel_log_prob(model, tokens, pad_args, mesh: DeviceMesh,
                              axis: str = 'seq'):
    """Packed ``predict_log_prob`` under context parallelism: the flat
    tokens are padded with ``padding_idx`` to a multiple of the axis size
    (the pad forms one fake trailing segment), each rank runs its slice,
    and the rows are gathered back, so every rank returns the ``(T, V)``
    fp32 log-probabilities of the unpadded tokens (JAX's global array)."""
    from ..models.esm import packed_meta
    from ..ops.linear import fp32_accumulation
    cu_lens, max_len = pad_args
    model._check_positions(int(max_len))
    tokens = model._tensor(tokens).to(torch.int32)
    n = axis_size(mesh, axis)
    T = tokens.shape[0]
    pad = (-T) % n
    if pad:
        fill = model.config.padding_idx or 0
        tokens = torch.cat([tokens, tokens.new_full((pad,), fill)])
    cu = model._tensor(cu_lens).to(torch.int32)
    seg_ids, pos_ids = packed_meta(cu, tokens.shape[0])
    with torch.inference_mode(), fp32_accumulation():
        out = forward_flat_cp(model.params, model.config, tokens, seg_ids,
                              pos_ids, mesh=mesh, axis=axis, log_prob=True,
                              checkpointing=model.checkpointing,
                              max_seqlen=int(max_len))
        out = _all_gather(out, mesh.get_group(axis))
    return out[:T]
