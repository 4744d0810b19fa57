"""Sharding over ``torch.distributed`` (mirrors ``repro.sharding.rules``):
the tensor-parallel rules and the span plumbing of the partitioned
(ZeRO-1) optimizer dispatch.

**The tensor-parallel rules.**  Every parameter carries a tuple of logical
axis names (``models.model.logical_axes``).  :func:`resolve_spec` turns it
into a spec with the JAX package's greedy, divisibility-safe two passes:

  pass 1 (TP): each logical name tries its preferred mesh axes
    (:data:`DEFAULT_TP_RULES`); an axis is taken only if it divides the dim
    and is not used yet on this parameter (qwen's 40 heads on a 16-way
    'model' axis fall through);
  pass 2 (FSDP): the remaining axes (pod, data, and 'model' if still free)
    are swept onto the largest divisible dims of large parameters.

A spec is the JAX package's ``PartitionSpec`` as a tuple: per tensor dim
None, a mesh axis name, or a tuple of names.  :func:`placements` turns it
into DTensor placements on a ``DeviceMesh`` and :func:`local_shape` gives
one device's shape.  A dim that carries two mesh axes is split by DTensor
in mesh-dim order (('model', 'data') after the FSDP sweep: data major),
where the JAX package splits it in the spec's order (model major): the
local shapes agree, the devices' order along the dim differs.

Optimizer state (:func:`opt_state_shardings`) lives in the flat block
domain: codes and absmax shard their block dim over *all* mesh axes
(whole quantization blocks per device), packed codes on dim 0 only; the
masters keep their parameter's spec, a ``Full32Leaf`` mirrors it, the
small-leaf ``Pool32Arena`` and the percentile-clipping history are
replicated, and Adafactor's factored moments drop the reduced dim of the
parameter's spec.

A mesh is read by its dim names and sizes: a ``DeviceMesh`` or a mapping
{name: size} in mesh order (``mesh_sizes``).

**The span plumbing.**  The partitioned dispatch splits the pooled
QuantArena's leading dim into per-owner spans
(``core.optim.base.ArenaPartition``) and runs each span on its owner.
Where the JAX package places arrays on mesh axes, the port holds each
owner's span in its own tensors and moves rows with collectives:
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

import dataclasses
import math
from typing import Callable, Mapping, Optional

import torch
import torch.distributed as dist

from repro_torch.analysis import contracts as _contracts
from repro_torch.analysis import mutations as _mutations
from repro_torch.errors import ConfigError


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
    the same order as the unpartitioned dispatch.  Records the
    ``replicated_scales`` marker of the contract auditors (the rows
    gathered and the arena's)."""
    if _mutations.active("drop_replication_pin"):
        # Seeded violation for the replicated(...) auditor: only the
        # caller's own span's rows (the first held without a group), the
        # rest zero, so each rank would finalize other trust ratios.
        d = min(partials)
        rows = partials[d]
        out = rows.new_zeros((part.total,) + tuple(rows.shape[1:]))
        start = part.spans[d][0]
        out[start:start + rows.shape[0]] = rows
        return out
    rows = gather_span_rows(part, partials, group)
    _contracts.mark(_contracts.REPLICATION_MARK, rows=int(rows.shape[0]),
                    total=part.total)
    return rows


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
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in axes if a in sizes)


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


# --------------------------------------------------- tensor-parallel rules

# preferred mesh axes per logical axis name (pass 1)
DEFAULT_TP_RULES = {
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "lru": ("model",),
    "head_out": (),
    "embed": (),            # embed dim is FSDP territory, not TP
    "embed_out": (),
    "layers": (),           # scan dim: never sharded
    "unsharded": (),
}


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    tp_rules: Optional[dict] = None
    fsdp_axes: tuple = ("pod", "data")
    fsdp_include_model_if_free: bool = True
    fsdp_min_size: int = 1 << 20       # params smaller than 1M stay replicated
    data_axes: tuple = ("pod", "data")  # batch sharding
    # Params containing these logical dims are left out of the FSDP sweep:
    # a head or embedding both vocab-TP and embed-FSDP would have its
    # backward all-gather the f32 logit gradients.
    fsdp_exclude_logical: tuple = ("vocab",)

    def rules(self):
        r = dict(DEFAULT_TP_RULES)
        if self.tp_rules:
            r.update(self.tp_rules)
        return r


def mesh_sizes(mesh) -> dict:
    """{dim name: size} of a ``DeviceMesh`` (in mesh-dim order), or of a
    mapping given as such."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = mesh.mesh_dim_names or ()
    return {n: int(mesh.size(i)) for i, n in enumerate(names)}


def _prod(sizes: dict, axes) -> int:
    return math.prod(sizes[a] for a in axes)


def _entry_axes(entry) -> tuple:
    """A spec entry's mesh axes: () for None, (name,) or the tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def resolve_spec(logical: tuple, shape: tuple, mesh,
                 policy: ShardingPolicy) -> tuple:
    """Greedy TP + FSDP resolution for one param (the JAX package's
    ``resolve_spec``); returns the spec tuple."""
    sizes = mesh_sizes(mesh)
    rules = policy.rules()
    if len(logical) != len(shape):
        raise ConfigError(f"logical axes {logical} do not match param "
                          f"shape {shape}")
    assign: list[list[str]] = [[] for _ in shape]
    used: set[str] = set()

    # pass 1: TP preferences
    for i, (name, dim) in enumerate(zip(logical, shape)):
        for ax in rules.get(name, ()):  # unknown names -> no TP
            if ax in sizes and ax not in used and dim % sizes[ax] == 0:
                assign[i].append(ax)
                used.add(ax)
                break

    # pass 2: FSDP sweep for large params
    if (math.prod(shape) >= policy.fsdp_min_size
            and not any(l in policy.fsdp_exclude_logical for l in logical)):
        fsdp = list(policy.fsdp_axes)
        if policy.fsdp_include_model_if_free and "model" not in used \
                and "model" in sizes:
            fsdp.append("model")
        for ax in fsdp:
            if ax not in sizes or ax in used:
                continue
            # place on the largest dim still divisible by the extra factor
            order = sorted(range(len(shape)), key=lambda i: -(
                shape[i] // max(_prod(sizes, assign[i]), 1)))
            for i in order:
                if logical[i] == "layers":
                    continue
                if shape[i] % (_prod(sizes, assign[i]) * sizes[ax]) == 0:
                    assign[i].append(ax)
                    used.add(ax)
                    break

    return tuple(tuple(a) if len(a) > 1 else (a[0] if a else None)
                 for a in assign)


def param_shardings(specs: Mapping[str, tuple], params: Mapping, mesh,
                    policy: ShardingPolicy) -> dict:
    """{path: spec} for every parameter: ``specs`` maps each path to its
    logical axes, ``params`` to the tensor (or its shape)."""
    shape = lambda p: tuple(p.shape) if hasattr(p, "shape") else tuple(p)
    return {path: resolve_spec(tuple(specs[path]), shape(p), mesh, policy)
            for path, p in params.items()}


def flat_block_spec(mesh) -> tuple:
    """Spec for the flat block domain: block dim over ALL mesh axes."""
    return (tuple(mesh_sizes(mesh)), None)


def placements(spec: tuple, mesh) -> list:
    """DTensor placements on ``mesh`` of a spec: ``Shard(i)`` on every mesh
    dim that tensor dim i names, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_sizes(mesh))
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        for ax in _entry_axes(entry):
            out[names.index(ax)] = Shard(i)
    return out


def local_shape(shape: tuple, spec: tuple, mesh_shape) -> tuple:
    """One device's shape of a tensor of ``shape`` laid out by ``spec``
    (``mesh_shape``: a mesh or {name: size}); a dim that its axes do not
    divide keeps the ceiling, the largest device's share."""
    sizes = mesh_sizes(mesh_shape)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-d // _prod(sizes, _entry_axes(e)))
                 for d, e in zip(shape, spec))


def local_bytes(t, spec: tuple, mesh) -> int:
    """Bytes of one device's share of ``t`` (a tensor, meta or fake)."""
    return math.prod(local_shape(tuple(t.shape), spec, mesh)) \
        * t.element_size()


def _raw_codes(c):
    return getattr(c, "packed", c)


def opt_state_shardings(state, param_specs: Mapping[str, tuple], mesh,
                        policy: ShardingPolicy) -> dict:
    """Specs of a ``Block8bitOptimizer`` or ``Adafactor`` state's tensors,
    flat: {name: (tensor, spec)} with names 'leaves/<path>/<field>',
    'arena/<field>', 'pool32/<field>', 'gnorm_vec' (packed codes by their
    uint8 tensor).  ``param_specs``: :func:`param_shardings`.

    The arena's own master is left out: each pooled leaf's master is a
    view of it, counted with the leaf's spec.  The port's arena also holds
    what the JAX package's state does not — the f32 gradient buffer of the
    block domain ('arena/grad') and the per-block element offsets and seed
    terms — and those shard the block dim like the codes."""
    from repro_torch.core.optim.adafactor import AdafactorLeaf
    from repro_torch.core.optim.base import (Full32Leaf, Pool32Leaf,
                                             PooledQuantLeaf, Quant8Leaf)
    del policy
    blocks = flat_block_spec(mesh)
    vec = (tuple(mesh_sizes(mesh)),)
    out = {}

    def put(name, t, spec):
        if t is not None:
            out[name] = (_raw_codes(t), spec)

    for path, st in state.leaves.items():
        ps = tuple(param_specs[path])
        pre = f"leaves/{path}/"
        if isinstance(st, Quant8Leaf):
            put(pre + "master", st.master, ps)
            put(pre + "codes_m", st.codes_m, blocks)
            put(pre + "absmax_m", st.absmax_m, vec)
            put(pre + "codes_r", st.codes_r, blocks)
            put(pre + "absmax_r", st.absmax_r, vec)
        elif isinstance(st, PooledQuantLeaf):
            put(pre + "master", st.master, ps)
        elif isinstance(st, Pool32Leaf):
            continue                  # no tensors; the Pool32Arena below
        elif isinstance(st, Full32Leaf):
            for f in ("master", "m", "r"):
                put(pre + f, getattr(st, f), ps)
        elif isinstance(st, AdafactorLeaf):
            full = ps + (None,) * (st.master.dim() - len(ps))

            def reduce_last(drop):
                spec = list(full)
                del spec[drop]
                return tuple(spec)

            put(pre + "master", st.master, ps)
            put(pre + "m", st.m, ps)
            put(pre + "v_row", st.v_row,
                None if st.v_row is None else reduce_last(-1))
            put(pre + "v_col", st.v_col,
                None if st.v_col is None else reduce_last(-2))
            put(pre + "v_full", st.v_full, ps)
        else:
            raise TypeError(type(st))
    if getattr(state, "gnorm_vec", None) is not None:
        put("gnorm_vec", state.gnorm_vec, ())
    arena = getattr(state, "arena", None)
    if arena is not None:
        # a partitioned arena of one process holds its rows in pieces (a
        # bucket of a span each), laid out as the whole arena is
        parts = [("arena/", arena)] + [(f"arena/pieces/{k}/", piece)
                                       for k, piece in enumerate(arena.pieces)]
        put("arena/grad", arena.grad, blocks)
        for pre, a in parts:
            for f in ("codes_m", "codes_r"):
                put(pre + f, getattr(a, f), blocks)
            for f in ("absmax_m", "absmax_r", "block_offsets", "leaf_seeds"):
                put(pre + f, getattr(a, f), vec)
    pool32 = getattr(state, "pool32", None)
    if pool32 is not None:
        for f in ("master", "m", "r"):
            put(f"pool32/{f}", getattr(pool32, f), ())
    return out


def port_only_state(name: str) -> bool:
    """Whether an :func:`opt_state_shardings` name is one of the port's
    arena buffers that the JAX package's state has no counterpart of: the
    block domain's gradient buffer, the per-block offsets and seed terms."""
    return name.startswith("arena/") and name.rsplit("/", 1)[1] in (
        "grad", "block_offsets", "leaf_seeds")


def batch_sharding(mesh, policy: ShardingPolicy, ndim: int = 2,
                   batch_dim_size: Optional[int] = None) -> tuple:
    """Batch-dim spec over the data axes; drops axes that do not divide
    the batch (long_500k has global_batch=1 -> fully replicated)."""
    sizes = mesh_sizes(mesh)
    axes = tuple(a for a in policy.data_axes if a in sizes)
    if batch_dim_size is not None:
        kept = []
        prod = 1
        for a in axes:
            if batch_dim_size % (prod * sizes[a]) == 0:
                kept.append(a)
                prod *= sizes[a]
        axes = tuple(kept)
    if not axes:
        return (None,) * ndim
    return (axes,) + (None,) * (ndim - 1)


def cache_shardings(cache, cfg, mesh, policy: ShardingPolicy) -> dict:
    """KV-cache / recurrent-state specs for serving, {path: spec} over the
    cache tree's tensors (paths as ``convert.flatten_tree`` names them).

    batch dim -> data axes.  Attention caches additionally shard kv_heads
    on 'model' when divisible, else the *sequence* dim on 'model'
    (sequence parallelism for GQA kv < model axis).  As in the JAX package
    the batch dim is taken to follow a leading layer dim on every leaf
    when the layers are scanned, the remainder layers' (which have none)
    included."""
    from repro_torch.convert import flatten_tree
    sizes = mesh_sizes(mesh)
    dp = tuple(a for a in policy.data_axes if a in sizes)
    msize = sizes.get("model", 1)
    lead_scan = cfg.scan_layers and cfg.n_superblocks > 0

    def one(shape):
        nd = len(shape)
        spec = [None] * nd
        b_idx = 1 if lead_scan else 0
        if nd > b_idx and shape[b_idx] % max(_prod(sizes, dp), 1) == 0:
            spec[b_idx] = dp
        # attention kv cache: (..., B, S, KV, Dh) or absmax (..., B, S, KV)
        if nd - b_idx in (3, 4) and "model" in sizes:
            kv_idx = nd - 2 if nd - b_idx == 4 else nd - 1
            s_idx = kv_idx - 1
            if shape[kv_idx] % msize == 0:
                spec[kv_idx] = "model"
            elif shape[s_idx] % msize == 0:
                spec[s_idx] = "model"
        return tuple(spec)

    return {path: one(tuple(t.shape))
            for path, t in flatten_tree(cache).items()}


# ------------------------------------------------------------ contracts
# replicate_for_scales gathers the per-block partials of every span before
# the lamb/lars trust ratios are finalized; dropping it would not change
# one process's numbers while every span is held, only the trace shows it.
# Only the partitioned lamb/lars cells carry the contract: the other
# algorithms have no trust ratio to gather.  (The JAX package's pins also
# come from percentile clipping on adamw/muon; the port's percentile
# clipping sums whole gradients on every rank in one order — under ZeRO-2
# on a group, the buffer all-gathered first — so it has no pin to drop.)

def _trust_ratio_cell(cell) -> bool:
    return getattr(cell, "partition", 1) > 1 and \
        getattr(cell, "algo", "").rstrip("0123456789") in ("lamb", "lars")


def _check_replicated_scales(trace, cell):
    if not _trust_ratio_cell(cell):
        return None
    return _contracts.check_replicated(trace, min_pins=1)


def _check_partition_pins(pair, cell):
    """pair:partition — the partitioned step gathers the partials whole;
    its unpartitioned twin, which holds them whole, gathers nothing."""
    pins = {k: _contracts.replicated_pins(t) for k, t in pair.items()}
    on, off = pins.get("on", 0), pins.get("off", 0)
    return on >= 1 and on > off, \
        f"whole-arena gathers per partition setting: {pins}"


_contracts.register(
    "partitioned_step.replicated_scales", "step", _check_replicated_scales,
    doc="a partitioned lamb/lars step finalizes its trust ratios from the "
        "partials of every span gathered whole")
_contracts.register(
    "partitioned_step.partition_pins", "pair:partition",
    _check_partition_pins,
    doc="turning partitioning on introduces the whole-arena gather; off, "
        "the step needs none")
