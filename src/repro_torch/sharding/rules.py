"""The span plumbing of the partitioned (ZeRO-1) optimizer dispatch over
``torch.distributed`` (mirrors the partitioned part of
``repro.sharding.rules``; the tensor-parallel rules are ROADMAP A13b).

The partitioned dispatch splits the pooled QuantArena's leading dim into
per-owner spans (``core.optim.base.ArenaPartition``) and runs each span on
its owner.  Where the JAX package places arrays on mesh axes, the port
holds each owner's span in its own tensors and moves rows with
collectives:

  * :func:`owned_span_spec` is a rank's ``(start, n)``;
  * :func:`shard_map_over_spans` runs a function once per span: every span
    in one process without a group (the JAX package's unrolled path), the
    rank's own span on a group;
  * :func:`replicate_for_scales` gathers per-block rows (the norm
    prologue's partials, 8 floats a block) into the whole arena's rows in
    the arena's own order, so the trust ratios are finalized from the same
    rows in the same order as without a partition;
  * :func:`gather_span_rows` gathers any span-held rows (codes, absmax) to
    every rank or to one;
  * :func:`owner_routed` runs a function on the owner rank only and
    broadcasts what it wrote to the others;
  * :func:`data_parallel_degree` and :func:`axes_group` read a mesh's
    data-parallel dims (``launch.mesh`` re-exports them).

Every collective takes the rows of the padded span layout: owner d's rows
sit at ``d * span_pad``, the padding of a short span is zero.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist


def _collective(new: str, old: str):
    return getattr(dist, new, None) or getattr(dist, old)


def all_gather_into(out: torch.Tensor, inp: torch.Tensor, group,
                    async_op: bool = False):
    """``out`` (world x rows of ``inp``) gets every rank's ``inp``, in rank
    order; ``inp`` may be a view of ``out`` (in place)."""
    return _collective("all_gather_single", "all_gather_into_tensor")(
        out, inp, group=group, async_op=async_op)


def reduce_scatter_into(out: torch.Tensor, inp: torch.Tensor, group,
                        async_op: bool = False):
    """``out`` gets this rank's chunk (in rank order) of the sum over the
    ranks of ``inp`` (world x rows of ``out``)."""
    return _collective("reduce_scatter_single", "reduce_scatter_tensor")(
        out, inp, group=group, async_op=async_op)


def owned_span_spec(part, rank: int) -> tuple:
    """Owner ``rank``'s span of ``part``: ``(start, n)``."""
    return part.spans[rank]


def shard_map_over_spans(part, fn: Callable, group=None,
                         rank: Optional[int] = None) -> list:
    """``[fn(d, start, n)]`` for every non-empty span of ``part`` without
    a group, or for the rank's own span on one (an empty list when it is
    empty)."""
    owners = range(part.n_shards) if group is None else (rank,)
    return [fn(d, *part.spans[d]) for d in owners if part.spans[d][1] > 0]


def gather_span_rows(part, held: dict, group=None, dst: Optional[int] = None
                     ) -> Optional[torch.Tensor]:
    """The whole arena's rows ``(total, ...)`` from the span rows ``held``
    ({owner: (n_d, ...) tensor}).  Without a group every non-empty span is
    held and the rows are concatenated; on a group each rank holds its own
    and they are all-gathered, or gathered to rank ``dst`` alone (None on
    the others)."""
    if group is None:
        return torch.cat([held[d] for d, (_, n) in enumerate(part.spans)
                          if n > 0])
    (rank, rows), = held.items()
    tail = tuple(rows.shape[1:])
    pad = rows.new_zeros((part.span_pad,) + tail)
    pad[:rows.shape[0]] = rows
    if dst is None:
        out = rows.new_empty((part.padded_total,) + tail)
        all_gather_into(out, pad, group)
        return out[:part.total]
    outs = ([rows.new_empty((part.span_pad,) + tail)
             for _ in range(part.n_shards)] if rank == dst else None)
    dist.gather(pad, outs, dst=dist.get_global_rank(group, dst),
                group=group)
    if rank != dst:
        return None
    return torch.cat(outs)[:part.total]


def replicate_for_scales(part, partials: dict, group=None) -> torch.Tensor:
    """Per-block partials ({owner: (n_d, k)}) of every span, as the whole
    arena's ``(total, k)`` rows on every rank: block-local rows need no
    codes gathered, and the finalize that follows reads the same rows in
    the same order as the unpartitioned dispatch."""
    return gather_span_rows(part, partials, group)


def owner_routed(owner: int, fn: Callable, outputs: Callable, group=None,
                 rank: Optional[int] = None):
    """Whole-leaf owner routing (Muon's matrix leaves): without a group
    ``fn()`` runs here; on a group it runs on rank ``owner`` alone and
    every tensor of ``outputs()`` (what ``fn`` wrote, read after it ran)
    is broadcast from the owner into the same tensors of the other ranks
    (bit for bit).  Returns ``fn()``'s result on the owner, None
    elsewhere."""
    if group is None:
        return fn()
    out = fn() if rank == owner else None
    for t in outputs():
        dist.broadcast(t, src=dist.get_global_rank(group, owner),
                       group=group)
    return out


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over the group (a no-op without one)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def data_parallel_degree(mesh, axes=("pod", "data")) -> int:
    """Product of the data-parallel dim sizes present on ``mesh`` — the
    shard count the partitioned optimizer dispatch owns spans over
    (``OptimConfig.partition_shards``)."""
    names = mesh.mesh_dim_names or ()
    deg = 1
    for a in axes:
        if a in names:
            deg *= int(mesh.size(names.index(a)))
    return deg


def axes_group(mesh, axes):
    """(process group, rank in it, its size) of the mesh dims ``axes``
    (several dims are flattened into one group, major to minor)."""
    axes = tuple(axes)
    if len(axes) == 1:
        sub = mesh[axes[0]]
    else:
        sub = mesh[axes]._flatten()
    group = sub.get_group()
    return group, dist.get_rank(group), dist.get_world_size(group)
