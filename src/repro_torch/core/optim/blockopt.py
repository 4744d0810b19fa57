"""The paper's 8-bit optimizers (and their 32-bit twins) as one engine
(mirrors ``repro.core.optim.blockopt`` on its per-leaf path).

``Block8bitOptimizer`` implements Adam/AdamW/Momentum/LAMB/LARS/AdaGrad
with per-leaf state that is either block-wise 8-bit quantized
(``Quant8Leaf``) or full 32-bit (``Full32Leaf`` — the 32-bit baselines,
leaves below ``min_8bit_size``, and leaves matched by the stable-embedding
override, paper §2.3).  The 8-bit update is the paper's §2 procedure —
dequantize, 32-bit math, requantize — through
``repro_torch.kernels.ops.fused_update``: one launch of the fused CUDA
kernel per quantized leaf per step, after one launch of the norm prologue
for lamb/lars (the trust ratio is per leaf: a stacked leaf holds all its
layers, as in the JAX package).  The tensor-wise ablation
(``blockwise_norm=False``) has no kernel: ``ops.fused_update`` serves it
with the plain oracle, as the JAX package serves it with its jnp entry.

State signedness per algorithm (paper §2.2):

  adam/adamw/lamb : m -> signed dynamic, r -> unsigned dynamic
  momentum/lars   : m -> signed dynamic
  adagrad         : accumulator -> unsigned dynamic (stored in the m slot)

Stochastic rounding seeds derive from the step, as the JAX package's do
when ``apply`` gets no key: ``step * 1000003 + i * 7919`` in int32
wrap-around, i the leaf's index in the parameter tree's order, so a
restart replays the same rounding.  A ``jax.random`` key cannot be
reproduced in PyTorch, so ``apply`` takes none.

State is keyed by the parameters' path strings ('a/b/c', as the JAX
package's ``path_str`` gives them), so the two packages' states compare leaf
by leaf.

**In place.** ``init`` does not copy: each leaf's master *is* the parameter
tensor it was given (when that is f32), and ``apply`` overwrites the
masters, codes, absmax vectors and 32-bit moments in place, saving a copy of
each.  A model whose parameters were passed to ``init`` is therefore
updated by ``apply`` directly.

Sub-byte states (``state_bits``, e.g. ``(4, 8)``) store
:class:`~repro_torch.core.lowbit.PackedCodes`; the fused update takes them
as they are.

Matrix-class optimizers (``MuonOptimizer``, ``core/optim/muon.py``) plug in
through three hooks, as in the JAX package: ``_leaf_class`` ("ew" or
"matrix" per leaf), ``_init_matrix_leaf`` and ``_elementwise_algo`` (the
algorithm the other leaves run, "adamw" for muon).  The base engine is
element-wise only and rejects matrix-class algorithms.

The numerics sentinel (``sentinel=True``): every per-leaf update also
returns its leaf's summed health vector ((N_HEALTH,) f32,
``kernels/fused_update.HEALTH_SLOTS``) — from the fused update's own counts
for quantized leaves, the nonfinite raw-grad and new-parameter counts alone
for 32-bit leaves — and ``apply`` returns ``(params, state, health)`` with
their sum.  Params and state are bit-identical either way.

**Pooled single dispatch** (``cfg.pooled``, the default): ``init``
concatenates every quantized leaf's statistics into one
:class:`~repro_torch.core.optim.base.QuantArena` and every
sub-``min_quant_size`` leaf's f32 state into one
:class:`~repro_torch.core.optim.base.Pool32Arena`, so ``apply`` makes
**one** ``kops.fused_update`` call for the arena (one launch of the fused
kernel, after one of the norm prologue for lamb/lars) instead of one per
leaf.  The pool's leaves are updated by the per-leaf 32-bit math on their
views of it (plain PyTorch either way).  Per-leaf seeds become a per-block seed
vector, element indices a per-block offset vector, and lamb/lars trust
ratios are finalized per arena segment, so pooled and per-leaf dispatch
are bit-identical; ``pooled=False`` is kept as the parity oracle and
serves the tensor-wise ablation and ``bits=32`` (``pooling_active``).  The
arenas own the f32 masters: ``init`` copies each parameter into its
segment and points the parameter's storage at it, so the model's
parameters stay the masters that ``apply`` writes, with no per-step copy.
The step's gradients are gathered into the arena's gradient buffer;
:meth:`Block8bitOptimizer.grad_views` gives the buffer's per-leaf views,
into which a caller (the train loop's clip) may write them directly.
Stable-embedding overrides stay per-leaf ``Full32Leaf``s and Muon's matrix
leaves per-leaf ``Quant8Leaf``s, updated beside the arena.  Checkpoints
store the per-leaf canonical layout (:func:`unpool_state`), so pooled and
per-leaf states share checkpoints both ways.

**Partitioned (ZeRO-1) dispatch** (``cfg.partition_active``): ``init``
splits the QuantArena's blocks into ``partition_shards`` owned spans
(:func:`~repro_torch.core.optim.base.make_partition`, the JAX package's
arithmetic), each span into ``overlap_buckets`` bucket ranges
(:func:`~repro_torch.core.optim.base.make_buckets`), and holds each
(span, bucket) piece's statistics in tensors of its own
(:class:`~repro_torch.core.optim.base.ArenaPiece`), so that every
per-block vector a kernel reads starts 16-byte aligned.  ``apply`` then
launches the fused update once per piece it holds; lamb/lars run the norm
prologue per piece, gather the per-block partials of the whole arena and
finalize the trust ratios from them in the unpartitioned order, so the
result is bit-identical to the single arena launch.  Without a mesh one
process holds and updates every piece (the JAX package's unrolled path).
With ``mesh`` (a ``DeviceMesh`` whose ``partition_axes`` form a process
group of ``partition_shards`` ranks) a rank holds only its own span's
pieces (the ZeRO-1 saving), every rank keeps the whole f32 master (the
parameters are its views; ``partition.padded_total`` rows), and the
updated spans are all-gathered straight into it.  Muon's k-th matrix
leaf is updated by owner ``k % partition_shards`` and broadcast from it.

**Gradients on a process group, and ZeRO-2** (:class:`GradBuffer`):
:meth:`Block8bitOptimizer.accumulate_grads` reduce-scatters each
microbatch's gradients into the padded span layout, bucket by bucket
(asynchronously), and divides by the world size; the gradients of the
leaves outside the arena are all-reduced.  Every data-parallel mode sums
this way, so partitioned and unpartitioned runs on one world are
bit-identical.  ZeRO-2 (``shard_grads``) keeps only the owned span and
applies from the buffer; the other modes all-gather it back
(:meth:`Block8bitOptimizer.gather_grads`).

**bf16 masters** (``master_dtype="bfloat16"``): the quantized leaves'
masters are bf16 (the arena's master too), the update math stays f32 in
registers, and the new master is the f32 result rounded to nearest even,
as the JAX package's ``astype`` rounds it.  Gradients stay f32 whatever
the master's dtype, as the JAX package keeps them: the arena's gradient
buffer and a GradBuffer's blocks are f32, and a per-leaf gradient is
flattened to f32 blocks, so the fused update reads bf16 p and f32 g.
32-bit leaves (the stable-embedding override, the small
pooled leaves) keep f32 masters.  A parameter whose dtype differs from its
master's is not aliased: ``apply`` (and a checkpoint restore) writes the
master back into it, rounded to the parameter's dtype (``OptState.casts``),
as the JAX package's forward sees ``master.astype(param_dtype)``.  Muon's
quantized matrix leaves take bf16 masters too (the JAX package's
``param.astype(master_dtype)``): Newton–Schulz runs on the master read in
f32, and only the store rounds to bf16; its f32-momentum matrix leaves
keep f32 masters.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, NamedTuple, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.device import to_device
from repro_torch.core.lowbit import CodeFormat, PackedCodes
from repro_torch.core.optim import base
from repro_torch.core.lowbit.packing import packed_width, unwrap_codes
from repro_torch.core.optim.base import (ArenaPartition, ArenaPiece,
                                         FlatSegment, Full32Leaf, OptimConfig,
                                         Pool32Arena, Pool32Leaf,
                                         PooledQuantLeaf, Quant8Leaf,
                                         QuantArena, QuantSegment,
                                         blocks_to_param, flatten_to_blocks,
                                         make_buckets, make_partition)
from repro_torch.errors import ConfigError, FormatError
from repro_torch.kernels import fused_update as kfu
from repro_torch.kernels import ops as kops
from repro_torch.sharding import rules

# Ride-along gradients (the leaves outside the arena) sit in one flat
# buffer at offsets rounded up to this many elements, so each view starts
# where a fresh allocation would (the reductions over it then vectorize as
# over a gradient of its own).
RIDE_ALIGN = 128


def leaf_order(leaves: Mapping[str, object]) -> list:
    """Path strings in the JAX package's tree order: nested dict keys
    sorted level by level (which plain string order is not: '-' sorts
    before '/'), a list's items (``blocks_list/<i>``) by their index."""
    return sorted(leaves, key=lambda path: [
        (0, int(k), "") if k.isdigit() else (1, 0, k)
        for k in path.split("/")])


class OptState(NamedTuple):
    step: int                  # number of updates applied
    # path string -> Quant8Leaf | Full32Leaf (per-leaf dispatch), or
    # PooledQuantLeaf | Pool32Leaf | Full32Leaf | Quant8Leaf (pooled; the
    # last two are the overrides and Muon's matrix leaves)
    leaves: dict
    # (pclip_history,) f32 squared-gnorm history, or None when percentile
    # clipping is off (cfg.percentile_clipping == 100).
    gnorm_vec: Optional[torch.Tensor] = None
    # the pooled layout's arenas; None on the per-leaf layout
    arena: Optional[QuantArena] = None
    pool32: Optional[Pool32Arena] = None
    # (parameter, master) pairs whose dtypes differ (a bf16 parameter of
    # an f32 master, or the reverse): ``apply`` writes each master into its
    # parameter; None when every parameter is its master
    casts: Optional[tuple] = None


@dataclasses.dataclass
class GradBuffer:
    """Accumulated gradients of one step in the arena's flat block domain.

    ``blocks`` holds the gradients of every pooled quantized leaf: all of
    the arena's (padded) rows in one process (it is the arena's ``grad``
    buffer), or on a process group the rows of the rank's owned span of
    ``part`` (``span_pad`` rows from arena row ``start``).  ``ride`` holds
    the leaves that do not live in the arena (32-bit overrides, Muon's
    matrix leaves, pooled small leaves) as param-shaped f32 views of the
    one buffer ``flat``, replicated.  ``layout`` is the static routing
    table, one entry per parameter in leaf order::

        ("arena", block_offset, n_blocks, shape, n, path) | ("ride", path, shape)

    ``part`` is the layout of the reduction: the arena's partition, or on
    a group without one ``make_partition(blocks, world)``; None in one
    process without a partition.  ``full`` is the whole block domain
    all-gathered from the owned spans on a group, kept from the norm until
    the step ends when percentile clipping reads it again (None
    otherwise)."""
    blocks: Optional[torch.Tensor]
    ride: dict
    layout: tuple
    part: Optional[ArenaPartition] = None
    start: int = 0
    flat: Optional[torch.Tensor] = None
    count: int = 0
    full: Optional[torch.Tensor] = None


def _check_ported(cfg: OptimConfig) -> None:
    if cfg.master_dtype not in ("float32", "bfloat16"):
        raise ConfigError(f"master_dtype={cfg.master_dtype!r}: float32 or "
                          f"bfloat16")
    if cfg.impl not in (None, *kops.IMPLS):
        raise ConfigError(f"impl={cfg.impl!r}; one of {kops.IMPLS}")


class Block8bitOptimizer:
    """init/apply optimizer whose state owns the f32 masters of the
    parameters (aliasing them, see the module docstring)."""

    def __init__(self, config: OptimConfig,
                 override_32bit: Optional[Callable[[str], bool]] = None,
                 *, device="cuda", mesh=None):
        _check_ported(config)
        self.cfg = config
        self.device = device_lib.resolve(device)
        self.override_32bit = override_32bit or (lambda path: False)
        # The data-parallel process group of the mesh's partition axes: the
        # gradients are reduced over it and, partitioned, each rank owns
        # one span.  None: one process (the unrolled span dispatch).
        self._mesh = mesh
        self._group, self._rank, self._world = None, 0, 1
        if mesh is not None:
            self._group, self._rank, self._world = _mesh_group(config, mesh)
            if config.partition_active and \
                    config.partition_shards != self._world:
                raise ConfigError(
                    f"partition_shards={config.partition_shards} but the "
                    f"mesh's {config.partition_axis!r} group has "
                    f"{self._world} ranks")
            if config.shard_grads_active and not config.partition_active:
                raise ConfigError("shard_grads on a process group keeps "
                                  "the owned span of the gradients: it needs "
                                  "the partitioned arena (partition=True)")
        # The algorithm element-wise leaves run through the fused registry;
        # matrix-class optimizers (MuonOptimizer) override
        # `_elementwise_algo` with their fallback ("adamw") and route their
        # matrix leaves through `_leaf_class` / `_init_matrix_leaf`.
        self._ew_algo = self._elementwise_algo(config.algo)
        bits1, bits2 = config.state_bits_pair
        signed1 = kfu.ALGO_SPECS[config.algo].state1_signed
        self._fmt1 = CodeFormat(
            bits=bits1, signed=signed1,
            qmap_name=config.qmap_m if signed1 else config.qmap_r)
        self._fmt2 = CodeFormat(bits=bits2, signed=False,
                                qmap_name=config.qmap_r)
        self._qmap1 = torch.as_tensor(self._fmt1.codebook(),
                                      device=self.device)
        self._qmap2 = torch.as_tensor(self._fmt2.codebook(),
                                      device=self.device)
        self._impl = config.impl or kops.DEFAULT_IMPL
        self._mdt = getattr(torch, config.master_dtype)

    # ------------------------------------------------------------------ init
    def _leaf_is_quantized(self, path: str, param: torch.Tensor) -> bool:
        if self.cfg.bits == 32:
            return False
        if param.numel() < self.cfg.min_quant_size:
            return False
        return not self.override_32bit(path)

    def _elementwise_algo(self, algo: str) -> str:
        """The algorithm non-matrix leaves dispatch through the fused
        registry.  Matrix optimizers override this (muon -> "adamw")."""
        if kfu.ALGO_SPECS[algo].matrix:
            raise ValueError(
                f"'{algo}' is a matrix-class algorithm; construct it via "
                f"make_optimizer / MuonOptimizer — Block8bitOptimizer has "
                f"no matrix-leaf routing")
        return algo

    def _leaf_class(self, path: str, param: torch.Tensor) -> str:
        """Per-leaf algorithm class: "ew" (element-wise, the fused-registry
        path) or "matrix" (Newton–Schulz leaves, MuonOptimizer only).  The
        base engine is entirely element-wise."""
        del path, param
        return "ew"

    def _init_matrix_leaf(self, path: str, param: torch.Tensor,
                          master: torch.Tensor):
        raise NotImplementedError(
            "matrix-class leaves need a matrix optimizer (MuonOptimizer)")

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        """State for ``params`` (path string -> tensor on the optimizer's
        device).  The masters alias the parameters of their dtype (f32, or
        bf16 for the quantized leaves with ``master_dtype="bfloat16"``);
        others are copied, and ``apply`` writes them back
        (``OptState.casts``)."""
        cfg = self.cfg
        for path, p in params.items():
            if p.device != self.device:
                raise ValueError(f"{path}: on {p.device}, the optimizer is "
                                 f"on {self.device}")
        if cfg.pooling_active:
            return self._init_pooled(params)
        leaves, casts = {}, []
        for path in sorted(params):
            p = params[path]
            quant = self._leaf_is_quantized(path, p)
            master = _master(p, self._mdt if quant else torch.float32,
                             casts)
            if self._leaf_class(path, p) == "matrix":
                leaves[path] = self._init_matrix_leaf(path, p, master)
                continue
            second = cfg.has_second_moment
            if quant:
                nb = base.n_blocks_for(tuple(p.shape), cfg.block_size,
                                       cfg.shard_multiple)
                bs = cfg.block_size
                leaves[path] = Quant8Leaf(
                    master=master,
                    codes_m=self._fmt1.init_codes(nb, bs, self.device),
                    absmax_m=torch.zeros(nb, device=self.device),
                    codes_r=(self._fmt2.init_codes(nb, bs, self.device)
                             if second else None),
                    absmax_r=(torch.zeros(nb, device=self.device)
                              if second else None),
                    shape=tuple(p.shape), n=p.numel())
            else:
                leaves[path] = _full32(master, second)
        gnorm_vec = (torch.zeros(cfg.pclip_history, device=self.device)
                     if cfg.percentile_clipping < 100 else None)
        return OptState(step=0, leaves=leaves, gnorm_vec=gnorm_vec,
                        casts=tuple(casts) or None)

    def _init_pooled(self, params: Mapping[str, torch.Tensor]) -> OptState:
        """The pooled layout: quantized leaves' statistics and masters
        concatenate into one QuantArena, small leaves' f32 state into one
        Pool32Arena, segment offsets in leaf order (the order ``apply``
        numbers the leaves in).  Each f32 parameter is pointed at its
        segment of the arena's master (``p.data = view``) when their dtypes
        agree, so the model's parameters stay the masters; others are
        copied in and written back by ``apply`` (``OptState.casts``)."""
        cfg = self.cfg
        bs, dev = cfg.block_size, self.device
        second = cfg.has_second_moment
        order = leaf_order(params)
        leaves, qsegs, fsegs, matrix_paths, casts = {}, [], [], [], []
        for i, path in enumerate(order):
            p = params[path]
            shape, n = tuple(p.shape), p.numel()
            if self._leaf_class(path, p) == "matrix":
                # each matrix leaf is its own Newton–Schulz problem: it
                # stays per leaf, beside the arena (partitioned, whole-leaf
                # on its owner)
                leaves[path] = self._init_matrix_leaf(path, p, _master(
                    p, self._mdt if self._leaf_is_quantized(path, p)
                    else torch.float32, casts))
                if isinstance(leaves[path], Quant8Leaf):
                    matrix_paths.append(path)
            elif self._leaf_is_quantized(path, p):
                nb = base.n_blocks_for(shape, bs, cfg.shard_multiple)
                off = qsegs[-1][0].offset + qsegs[-1][0].n_blocks \
                    if qsegs else 0
                qsegs.append((QuantSegment(path, off, nb, shape, n), i))
            elif n < cfg.min_quant_size and not self.override_32bit(path):
                off = fsegs[-1].offset + fsegs[-1].n if fsegs else 0
                fsegs.append(FlatSegment(path, off, n, shape))
            else:
                # the stable-embedding override: a per-leaf Full32Leaf
                leaves[path] = _full32(_master(p, torch.float32, casts),
                                       second)
        arena = pool32 = None
        shards = cfg.partition_shards if cfg.partition_active else 0
        grid = max(cfg.shard_multiple, 1)
        if qsegs:
            total = qsegs[-1][0].offset + qsegs[-1][0].n_blocks
            # made on the device, so a layout on "meta" (the dry run's, at
            # up to 10^9 blocks) allocates nothing
            offsets = torch.cat([torch.arange(seg.n_blocks, dtype=torch.int32,
                                              device=dev)
                                 for seg, _ in qsegs])
            seeds = torch.cat([torch.full((seg.n_blocks,),
                                          kfu.to_i32(i * 7919),
                                          dtype=torch.int32, device=dev)
                               for seg, i in qsegs])
            segs = tuple(seg for seg, _ in qsegs)
            if shards:
                part = make_partition(
                    total, shards, grid=grid, matrix_owners=tuple(
                        (p_, k % shards) for k, p_ in enumerate(matrix_paths)))
                plan = (make_buckets(part, cfg.overlap_buckets, grid=grid)
                        if cfg.overlap_active else None)
                rows = part.padded_total
            else:
                part = plan = None
                # on a group the gradients are reduced in the padded span
                # layout of the world: the buffer has its rows
                rows = (self._reduce_partition(total).padded_total
                        if self._group is not None else total)
            master = torch.zeros(part.padded_total if part else total, bs,
                                 device=dev, dtype=self._mdt)
            for seg, _ in qsegs:
                view = _segment_view(master, seg)
                leaves[seg.path] = PooledQuantLeaf(
                    master=_alias(params[seg.path], view, casts),
                    shape=seg.shape, n=seg.n, offset=seg.offset,
                    n_blocks=seg.n_blocks)
            # ZeRO-2 on a group never holds the whole gradient
            grad = (None if cfg.shard_grads_active and self._group is not None
                    else torch.zeros(rows, bs, device=dev))
            if part is None:
                arena = QuantArena(
                    codes_m=self._fmt1.init_codes(total, bs, dev),
                    absmax_m=torch.zeros(total, device=dev),
                    codes_r=(self._fmt2.init_codes(total, bs, dev)
                             if second else None),
                    absmax_r=(torch.zeros(total, device=dev) if second
                              else None),
                    segments=segs, master=master, grad=grad,
                    block_offsets=offsets.to(dev), leaf_seeds=seeds.to(dev),
                    group=self._group)
            else:
                arena = QuantArena(
                    codes_m=None, absmax_m=None, codes_r=None, absmax_r=None,
                    segments=segs, master=master, grad=grad,
                    block_offsets=None, leaf_seeds=None, partition=part,
                    buckets=plan,
                    pieces=self._make_pieces(part, plan, offsets, seeds),
                    group=self._group)
        if fsegs:
            total = fsegs[-1].offset + fsegs[-1].n
            master = torch.zeros(total, device=dev)
            for seg in fsegs:
                view = master[seg.offset:seg.offset + seg.n].view(seg.shape)
                _alias(params[seg.path], view, casts)
                leaves[seg.path] = Pool32Leaf(shape=seg.shape, n=seg.n,
                                              offset=seg.offset)
            pool32 = Pool32Arena(
                master=master, m=torch.zeros(total, device=dev),
                r=torch.zeros(total, device=dev) if second else None,
                segments=tuple(fsegs),
                # element-granular ownership on 128-element spans, as in
                # the JAX package: accounting only, every process updates
                # the whole (small) pool
                partition=make_partition(total, shards, grid=128)
                if shards else None)
        gnorm_vec = (torch.zeros(cfg.pclip_history, device=dev)
                     if cfg.percentile_clipping < 100 else None)
        return OptState(step=0, leaves={k: leaves[k] for k in order},
                        gnorm_vec=gnorm_vec, arena=arena, pool32=pool32,
                        casts=tuple(casts) or None)

    def _make_pieces(self, part: ArenaPartition, plan, offsets, seeds
                     ) -> tuple:
        """The pieces this process holds: every (span, bucket) piece of
        ``part`` in one process, the rank's own on a group; each with new
        tensors (zero-state codes, zero absmax, its rows of the per-block
        element ``offsets`` and seed terms)."""
        bs, dev = self.cfg.block_size, self.device
        two = self.cfg.has_second_moment
        ranges = plan.ranges if plan is not None else ((0, part.span_pad),)
        owners = range(part.n_shards) if self._group is None \
            else (self._rank,)
        pieces = []
        for d in owners:
            start, n = part.spans[d]
            for k0, k1 in ranges:
                m = min(n, k1) - k0
                if m <= 0:
                    continue
                r0 = start + k0
                pieces.append(ArenaPiece(
                    owner=d, start=r0, n=m,
                    codes_m=self._fmt1.init_codes(m, bs, dev),
                    absmax_m=torch.zeros(m, device=dev),
                    codes_r=self._fmt2.init_codes(m, bs, dev) if two
                    else None,
                    absmax_r=torch.zeros(m, device=dev) if two else None,
                    block_offsets=offsets[r0:r0 + m].to(dev, copy=True),
                    leaf_seeds=seeds[r0:r0 + m].to(dev, copy=True)))
        return tuple(pieces)

    def _reduce_partition(self, total: int) -> ArenaPartition:
        """The padded span layout the gradients are reduced in on a group:
        the arena's partition when it has one, else the world's."""
        return make_partition(total, self._world,
                              grid=max(self.cfg.shard_multiple, 1))

    def grad_views(self, state: OptState) -> dict:
        """{path: the pooled quantized leaf's view, in param shape, of the
        arena's gradient buffer}; empty on the per-leaf layout (and under
        ZeRO-2 on a group, which holds no whole gradient).  A gradient
        written into its view (``torch.mul(g, scale, out=view)``) is not
        copied again by ``apply``."""
        if state.arena is None or state.arena.grad is None:
            return {}
        return {seg.path: _segment_view(state.arena.grad, seg)
                for seg in state.arena.segments}

    # ------------------------------------------------------------- algorithms
    def _math32(self, g, p, m, r, lr, step_f):
        """32-bit update math for Full32 leaves — the same update the fused
        kernel runs (``kernels/fused_update.update_math``), with the JAX
        engine's scalar types (lr and step f32, the rest Python floats) and
        the lamb/lars trust ratio from whole-tensor norms.  This is plain
        PyTorch on the card too, as the JAX package runs it without a
        kernel."""
        cfg = self.cfg
        spec = kfu.ALGO_SPECS[self._ew_algo]
        c1, c2 = kfu.bias_corrections(cfg.beta1, cfg.beta2, step_f)
        s = dict(lr=lr, beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps,
                 weight_decay=cfg.weight_decay, c1=to_device(c1, p.device),
                 c2=to_device(c2, p.device))
        s["tensor_scale"] = kfu.tensor_scale_for(spec, g, p, m, r, s,
                                                 cfg.trust_coeff)
        return kfu.update_math(spec, g, p, m, r, s)

    # -------------------------------------------------------------- clipping
    def percentile_clip(self, grads, state: OptState):
        """Percentile-clipping scale for this step (bitsandbytes-style).

        Returns ``(gnorm_scale, new_gnorm_vec)``: the 0-d f32 scale every
        gradient is multiplied by inside the fused update, and the updated
        squared-gnorm history.  Scale 1 and the history unchanged when
        disabled.  The history (including this step's norm) must fill
        before clipping engages.  ``grads`` may be a :class:`GradBuffer`:
        each leaf is then reduced on its param-shaped view of the buffer
        (on a group, of the buffer all-gathered for the purpose), in the
        same order, so the history is bit-identical either way."""
        cfg = self.cfg
        if cfg.percentile_clipping >= 100 or state.gnorm_vec is None:
            # a host scalar: the fused update reads it without a sync
            return torch.ones(()), state.gnorm_vec
        if isinstance(grads, GradBuffer):
            grads = self._grad_views(grads)
        one = torch.ones((), device=self.device)
        gn2 = torch.zeros((), device=self.device)
        for path in leaf_order(grads):
            gn2 = gn2 + grads[path].to(torch.float32).square().sum()
        hist = state.gnorm_vec
        new_vec = hist.clone()
        new_vec[state.step % hist.shape[0]] = gn2
        clip2 = torch.quantile(new_vec, cfg.percentile_clipping / 100.0)
        warm = (state.step + 1) >= hist.shape[0]
        scale = torch.sqrt(clip2.clamp(min=0.0) / gn2.clamp(min=1e-30))
        if not warm:
            return one, new_vec
        return torch.where(gn2 > clip2, scale, one), new_vec

    # ------------------------------------------- gradients: ZeRO-2 buffer
    @property
    def data_parallel(self) -> Optional[tuple]:
        """(process group, rank, world size) of the mesh the optimizer was
        built on, or None in one process."""
        return None if self._group is None else \
            (self._group, self._rank, self._world)

    def _grad_layout(self, state: OptState) -> tuple:
        """The GradBuffer routing table of a pooled state: one entry per
        parameter in leaf order."""
        out = []
        for path in leaf_order(state.leaves):
            leaf = state.leaves[path]
            if isinstance(leaf, PooledQuantLeaf):
                out.append(("arena", leaf.offset, leaf.n_blocks,
                            tuple(leaf.shape), leaf.n, path))
            else:
                shape = (tuple(leaf.master.shape)
                         if isinstance(leaf, (Full32Leaf, Quant8Leaf))
                         else tuple(leaf.shape))
                out.append(("ride", path, shape))
        return tuple(out)

    def init_grad_buffer(self, state: OptState) -> GradBuffer:
        """An empty gradient accumulator for ``state`` (pooled layouts
        only): in one process the arena's own gradient buffer (its padding
        stays zero), on a group a new owned-span buffer of the reduction
        layout; the ride-along gradients in one flat buffer."""
        cfg = self.cfg
        if not cfg.pooling_active:
            raise ConfigError(
                "GradBuffer accumulation needs the pooled arena layout")
        layout = self._grad_layout(state)
        arena, blocks, part, start = state.arena, None, None, 0
        if arena is not None:
            part = arena.partition
            if self._group is not None:
                part = part or self._reduce_partition(arena.total)
                start = rules.owned_span_spec(part, self._rank)[0]
                blocks = torch.empty(part.span_pad, cfg.block_size,
                                     device=self.device)
            else:
                blocks = arena.grad
        shapes = [(e[1], e[2]) for e in layout if e[0] == "ride"]
        sizes = [_numel(sh) for _, sh in shapes]
        offs, cursor = [], 0
        for n in sizes:
            offs.append(cursor)
            cursor += -(-n // RIDE_ALIGN) * RIDE_ALIGN
        flat = torch.zeros(cursor, device=self.device)
        ride = {path: flat[o:o + n].view(sh)
                for (path, sh), o, n in zip(shapes, offs, sizes)}
        return GradBuffer(blocks=blocks, ride=ride, layout=layout, part=part,
                          start=start, flat=flat)

    def accumulate_grads(self, buf: GradBuffer,
                         grads: Mapping[str, torch.Tensor]) -> GradBuffer:
        """Add one microbatch's param-shaped gradients into ``buf`` (in
        place; returns it).  In one process the arena leaves are written
        into their views of the block domain (the first microbatch copies,
        the others add).  On a group each bucket of the reduction layout
        (``make_buckets(part, overlap_buckets)``: local rows [k0, k1) of
        every owner's span) is packed from the gradients and
        reduce-scattered into the owned span while the next bucket is
        packed, and the ride-along gradients are all-reduced; each sum is
        divided by the world size and added in before the call returns."""
        if len(grads) != len(buf.layout):
            raise FormatError(f"gradient tree has {len(grads)} leaves but "
                              f"the GradBuffer layout has {len(buf.layout)}")
        first = buf.count == 0
        arena_segs = [_entry_segment(e) for e in buf.layout
                      if e[0] == "arena"]
        if self._group is None:
            for seg in arena_segs:
                view = _segment_view(buf.blocks, seg)
                view.copy_(grads[seg.path]) if first \
                    else view.add_(grads[seg.path])
            for path, v in buf.ride.items():
                v.copy_(grads[path]) if first else v.add_(grads[path])
        else:
            self._reduce_microbatch(buf, grads, arena_segs, first)
        buf.count += 1
        return buf

    def _reduce_microbatch(self, buf: GradBuffer, grads, segs, first):
        """One microbatch's reductions on the group (see
        :meth:`accumulate_grads`).  A bucket's pack (``n_shards x`` its
        rows) lives until its reduction is settled, which happens once the
        next bucket is issued: at most two packs are alive at a time, and
        none outlives the call."""
        part, bsz = buf.part, self.cfg.block_size
        pending = []
        if buf.ride:
            send = torch.zeros_like(buf.flat)
            for path, v in buf.ride.items():
                send[_offset_in(buf.flat, v):][:v.numel()].copy_(
                    grads[path].reshape(-1))
            work = torch.distributed.all_reduce(send, group=self._group,
                                                async_op=True)
            pending.append((work, send, send, buf.flat, first))
        if buf.blocks is not None:
            ranges = ((0, part.span_pad),)
            if self.cfg.overlap_buckets > 1:
                ranges = make_buckets(part, self.cfg.overlap_buckets,
                                      grid=max(self.cfg.shard_multiple,
                                               1)).ranges
            for k0, k1 in ranges:
                pack = torch.zeros(part.n_shards, k1 - k0, bsz,
                                   device=self.device)
                for d in range(part.n_shards):
                    r0 = d * part.span_pad
                    _fill_rows(pack[d], r0 + k0, r0 + k1, segs, grads)
                out = buf.blocks[k0:k1] if first else \
                    torch.empty(k1 - k0, bsz, device=self.device)
                work = rules.reduce_scatter_into(
                    out, pack.view(-1, bsz), self._group, async_op=True)
                self._settle(pending)
                pending = [(work, pack, out, buf.blocks[k0:k1], first)]
        self._settle(pending)

    def _settle(self, pending: list) -> None:
        """Wait for each reduction of ``pending`` ((work, its input, its
        sum, rows, first)) and add it in: the sum is divided by the world
        size, then written (first microbatch) or added into its rows.
        Empties the list."""
        for work, _, out, dst, first in pending:
            work.wait()
            out.div_(self._world)
            if first:
                if out.data_ptr() != dst.data_ptr():
                    dst.copy_(out)
            else:
                dst.add_(out)
        pending.clear()

    def finish_grads(self, buf: GradBuffer, microbatches: int = 1
                     ) -> GradBuffer:
        """Average over the microbatches (in place; returns ``buf``)."""
        if microbatches > 1:
            if buf.blocks is not None:
                buf.blocks.div_(microbatches)
            if buf.flat is not None:
                buf.flat.div_(microbatches)
        return buf

    def gather_grads(self, buf: GradBuffer, state: OptState) -> dict:
        """The whole reduced gradient as {path: param-shaped tensor}: on a
        group the owned spans are all-gathered into the arena's gradient
        buffer first (ZeRO-1 and the unpartitioned data-parallel run), the
        arena leaves are views of it, the others the ride-along views."""
        arena = state.arena
        out = dict(buf.ride)
        if arena is not None:
            if self._group is not None:
                rules.all_gather_into(arena.grad, buf.blocks, self._group)
            out.update(self.grad_views(state))
        return out

    def _full_blocks(self, buf: GradBuffer) -> Optional[torch.Tensor]:
        """All (padded) rows of the buffer's block domain: the buffer
        itself in one process, on a group an all-gather of the owned spans
        (one whole gradient beside the span, for the norm).  One gather a
        step: under percentile clipping, which reads the gradients again,
        the buffer keeps it (``full``) and :meth:`scale_grads` scales it
        with the span."""
        if buf.blocks is None or self._group is None:
            return buf.blocks
        if buf.full is not None:
            return buf.full
        full = torch.empty(buf.part.padded_total, buf.blocks.shape[1],
                           device=buf.blocks.device)
        rules.all_gather_into(full, buf.blocks, self._group)
        if self.cfg.percentile_clipping < 100:
            buf.full = full
        return full

    def _grad_views(self, buf: GradBuffer) -> dict:
        """{path: param-shaped gradient} of a buffer: the arena leaves'
        views of its whole block domain, the ride-along views."""
        full = self._full_blocks(buf)
        out = dict(buf.ride)
        for e in buf.layout:
            if e[0] == "arena":
                out[e[5]] = _segment_view(full, _entry_segment(e))
        return out

    def grad_buffer_norm(self, buf: GradBuffer) -> torch.Tensor:
        """Global gradient norm from the buffer, bit-identical to
        ``train.loop.global_norm`` on the equivalent param-shaped
        gradients: each leaf reduced on its param-shaped view, in the same
        order (on a group, of the buffer all-gathered transiently)."""
        from repro_torch.train.loop import global_norm
        return global_norm(self._grad_views(buf))

    def scale_grads(self, buf: GradBuffer, scale) -> GradBuffer:
        """Multiply every gradient element of ``buf`` by ``scale``, in
        place (the clip): the span's, those of the kept all-gather (the
        same products) and the ride-along ones; padding is left as it is
        (zero)."""
        bsz = self.cfg.block_size
        for blocks, r0 in ((buf.blocks, buf.start), (buf.full, 0)):
            if blocks is None:
                continue
            r1 = r0 + blocks.shape[0]
            flat = blocks.view(-1)
            for e in buf.layout:
                if e[0] != "arena":
                    continue
                e0 = max(e[1] * bsz, r0 * bsz)
                e1 = min(e[1] * bsz + e[4], r1 * bsz)
                if e1 > e0:
                    flat[e0 - r0 * bsz:e1 - r0 * bsz].mul_(scale)
        for v in buf.ride.values():
            v.mul_(scale)
        return buf

    def grad_buffer_bytes(self, state: OptState) -> dict:
        """Static peak-gradient accounting, as the JAX package counts it:
        bytes of the replicated param-shaped gradients (what the
        sequential accumulator holds) against one rank's ZeRO-2 share — one
        owned span of the block buffer plus the (replicated) ride-along
        gradients."""
        replicated = ride = 0
        for e in self._grad_layout(state):
            if e[0] == "arena":
                replicated += e[4] * 4
            else:
                n = _numel(e[2])
                replicated += n * 4
                ride += n * 4
        rows = 0
        arena = state.arena
        part = arena.partition if arena is not None else None
        if arena is not None:
            rows = part.span_pad if part is not None else arena.total
        sharded = rows * self.cfg.block_size * 4 + ride
        return {"replicated_grad_bytes": int(replicated),
                "sharded_grad_bytes": int(sharded),
                "grad_ride_bytes": int(ride),
                "grad_partition_shards": (part.n_shards if part is not None
                                          else 1)}

    # ---------------------------------------------------------------- update
    def _apply_quant8(self, leaf: Quant8Leaf, g: torch.Tensor, lr, step_f,
                      seed: int, gnorm_scale) -> Optional[torch.Tensor]:
        """Update one quantized leaf in place; returns its summed health
        vector under ``cfg.sentinel`` (else None)."""
        cfg = self.cfg
        mdt = leaf.master.dtype     # f32 or bf16; g is f32
        gb = flatten_to_blocks(g, cfg.block_size, cfg.shard_multiple)
        mb = flatten_to_blocks(leaf.master, cfg.block_size,
                               cfg.shard_multiple, mdt)
        res = kops.fused_update(
            self._ew_algo, mb, gb, leaf.codes_m, leaf.absmax_m, leaf.codes_r,
            leaf.absmax_r, self._qmap1, self._qmap2, lr=lr, beta1=cfg.beta1,
            beta2=cfg.beta2, eps=cfg.eps, weight_decay=cfg.weight_decay,
            step=step_f, trust_coeff=cfg.trust_coeff,
            gnorm_scale=gnorm_scale, blockwise=cfg.blockwise_norm,
            stochastic=cfg.stochastic_rounding, seed=seed, impl=self._impl,
            sentinel=cfg.sentinel)
        # mb is a view of the master unless padding forced a copy; the
        # "cuda" backend writes its result into mb.
        if not (res.p is mb and mb.data_ptr() == leaf.master.data_ptr()):
            leaf.master.copy_(blocks_to_param(res.p, leaf.shape, leaf.n,
                                              mdt))
        # the statistics too stay in place (train_step.donates): the "cuda"
        # element-wise backend wrote them there, the muon entries and the
        # "torch" oracle returned new tensors, copied in
        for dst, src in ((leaf.codes_m, res.codes_m),
                         (leaf.absmax_m, res.absmax_m),
                         (leaf.codes_r, res.codes_r),
                         (leaf.absmax_r, res.absmax_r)):
            _store(dst, src)
        return res.health.sum(dim=0) if cfg.sentinel else None

    def _apply_full32(self, leaf: Full32Leaf, g: torch.Tensor, lr, step_f,
                      gnorm_scale) -> Optional[torch.Tensor]:
        """Update one 32-bit leaf in place; under ``cfg.sentinel`` returns
        a health vector with only its nonfinite grad and update slots set
        (a 32-bit leaf has no codes or absmax), the grad counted raw,
        before gnorm_scale (inf * 0 would hide a nonfinite element)."""
        graw = g.to(torch.float32)
        g = graw * gnorm_scale
        m2, r2, p2 = self._math32(g, leaf.master, leaf.m, leaf.r, lr, step_f)
        leaf.master.copy_(p2)
        leaf.m.copy_(m2)
        if leaf.r is not None:
            leaf.r.copy_(r2)
        if not self.cfg.sentinel:
            return None
        return _nonfinite_health(graw, p2)

    @torch.no_grad()
    def apply(self, grads, state: OptState, *, lr=None) -> tuple:
        """One optimizer step, in place.  Returns (params view, new state);
        the new state holds the same (updated) leaf objects.  Under
        ``cfg.sentinel`` returns (params view, new state, health): the
        (N_HEALTH,) f32 sum of every leaf's health vector (on a group, the
        same on every rank).

        ``grads``: path string -> gradient of the parameter's shape, or a
        :class:`GradBuffer` (pooled layouts only).  ``lr`` overrides cfg.lr
        (schedules): a float or a 0-d tensor."""
        cfg = self.cfg
        buf = grads if isinstance(grads, GradBuffer) else None
        if buf is not None:
            if not cfg.pooling_active:
                raise ConfigError("GradBuffer input requires the pooled "
                                  "layout (shard_grads)")
        elif set(grads) != set(state.leaves):
            raise ValueError("grads and optimizer state hold different "
                             "parameter paths")
        # lr on the host for the kernel's scalar arguments (reading a
        # device scalar would wait for the device), on the device for the
        # 32-bit leaves' tensor math.
        lr_host = torch.as_tensor(cfg.lr if lr is None else lr,
                                  dtype=torch.float32).cpu()
        lr_dev = to_device(lr_host, self.device)
        step_f = torch.tensor(float(state.step + 1), dtype=torch.float32)
        gnorm_scale, new_vec = self.percentile_clip(grads, state)
        base_seed = kfu.to_i32(state.step * 1000003)
        health_parts = []
        if state.arena is not None:
            health_parts.append(self._apply_arena(
                state.arena, grads, lr_host, step_f, base_seed, gnorm_scale))
        # the leaves outside the QuantArena, numbered in leaf order over all
        # leaves as the per-leaf dispatch numbers them, so seed i matches;
        # a pooled small leaf is updated as a Full32Leaf of its views of
        # the Pool32Arena (the per-leaf math, per-tensor trust ratios)
        n_matrix = 0
        for i, path in enumerate(leaf_order(state.leaves)):
            leaf = state.leaves[path]
            if isinstance(leaf, PooledQuantLeaf):
                continue
            g = grads[path] if buf is None else buf.ride[path]
            if isinstance(leaf, Pool32Leaf):
                leaf = _pool32_view(state.pool32, leaf)
            if isinstance(leaf, Quant8Leaf):
                seed = kfu.to_i32(base_seed + i * 7919)
                run = lambda leaf=leaf, g=g, seed=seed: self._apply_quant8(
                    leaf, g, lr_host, step_f, seed, gnorm_scale)
                if cfg.partition_active:
                    # Muon's k-th matrix leaf: whole-leaf on owner k % D
                    h8 = self._route_matrix_leaf(
                        n_matrix % cfg.partition_shards, leaf, run)
                    n_matrix += 1
                else:
                    h8 = run()
            else:
                h8 = self._apply_full32(leaf, g, lr_dev, step_f, gnorm_scale)
            health_parts.append(h8)
        new_state = state._replace(step=state.step + 1, gnorm_vec=new_vec)
        sync_casts(new_state)
        if cfg.sentinel:
            return (self.params_view(new_state), new_state,
                    _sum_health(health_parts, self.device))
        return self.params_view(new_state), new_state

    def _route_matrix_leaf(self, owner: int, leaf: Quant8Leaf, run):
        """Whole-leaf owner routing of a Muon matrix leaf: in one process
        ``run()`` updates it here; on a group only the owner rank runs it
        and the master, codes, absmax (and health vector) are broadcast
        from it.  Returns the leaf's health vector under the sentinel."""
        health = (torch.zeros(kfu.N_HEALTH, device=self.device)
                  if self.cfg.sentinel else None)

        def fn():
            h8 = run()
            if health is not None:
                health.copy_(h8)

        rules.owner_routed(
            owner, fn, lambda: [leaf.master, _raw(leaf.codes_m),
                                leaf.absmax_m] + ([health] if health
                                                  is not None else []),
            self._group, self._rank)
        return health

    def _apply_arena(self, arena: QuantArena, grads, lr, step_f,
                     base_seed: int, gnorm_scale) -> Optional[torch.Tensor]:
        """The fused update of the QuantArena, in place: one launch over
        the whole arena, or one per held piece of a partitioned one.
        Gradients are copied into the arena's gradient buffer unless they
        already are its views (:meth:`grad_views`) or come in a
        :class:`GradBuffer`; the stochastic-rounding seeds are the
        per-block ``leaf_seeds`` plus this step's term, added on the device
        in int32 (wrapping, as the per-leaf seeds wrap).  Returns the
        summed health vector under ``cfg.sentinel`` (else None)."""
        nb = arena.total
        if isinstance(grads, GradBuffer):
            g0, gbuf = grads.start, grads.blocks
        else:
            g0, gbuf = 0, arena.grad
            for seg in arena.segments:
                # no copy when the gradient is the view (copy_ onto the
                # same memory returns at once)
                _segment_view(gbuf, seg).copy_(grads[seg.path])
        if arena.partition is not None:
            health = self._apply_partitioned(
                arena, lambda r0, n: gbuf[r0 - g0:r0 - g0 + n], lr, step_f,
                base_seed, gnorm_scale)
        else:
            health = self._launch(
                arena, arena.master, gbuf[:nb], base_seed,
                self._kernel_kw(lr, step_f, gnorm_scale),
                segments=_segment_ranges(arena))
        zero_block_tails(arena.master, arena.segments)
        return health

    def _launch(self, stats, master, g, base_seed: int, kw: dict, **extra):
        """One fused launch on the arena rows ``master`` and ``g`` with the
        statistics, block offsets and seed terms of ``stats`` (the arena,
        or one piece of a partitioned one), stored back in place; ``kw``:
        :meth:`_kernel_kw`.  Returns the launch's summed health vector
        under the sentinel (else None)."""
        seeds = (torch.add(stats.leaf_seeds, base_seed)
                 if self.cfg.stochastic_rounding else None)
        res = kops.fused_update(
            self._ew_algo, master, g, stats.codes_m, stats.absmax_m,
            stats.codes_r, stats.absmax_r, self._qmap1, self._qmap2,
            block_seeds=seeds, block_offsets=stats.block_offsets, **extra,
            **kw)
        # the "cuda" backend updated the rows in place; the "torch" oracle
        # returned new tensors
        for dst, src in zip((master, stats.codes_m, stats.absmax_m,
                             stats.codes_r, stats.absmax_r), res[:5]):
            _store(dst, src)
        return res.health.sum(dim=0) if self.cfg.sentinel else None

    def _kernel_kw(self, lr, step_f, gnorm_scale) -> dict:
        """The fused update's keyword arguments shared by every launch of a
        step (pooled and partitioned alike)."""
        cfg = self.cfg
        return dict(lr=lr, beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps,
                    weight_decay=cfg.weight_decay, step=step_f,
                    trust_coeff=cfg.trust_coeff, gnorm_scale=gnorm_scale,
                    blockwise=True, stochastic=cfg.stochastic_rounding,
                    impl=self._impl, sentinel=cfg.sentinel)

    def _apply_partitioned(self, arena: QuantArena, grad_rows, lr, step_f,
                           base_seed: int, gnorm_scale):
        """The ZeRO-1 arena update: one fused launch per held piece, on its
        rows of the master (a view) and of the gradient (``grad_rows(r0,
        n)``, a view) and its own statistics.  lamb/lars get their
        per-block trust ratios from :meth:`_partition_scales` (the same
        values as the single launch's).  On a group the updated spans are
        then all-gathered into every rank's master and the health counts
        summed over the ranks.  Returns the health vector under the
        sentinel."""
        cfg = self.cfg
        part = arena.partition
        spec = kfu.ALGO_SPECS[self._ew_algo]
        kw = self._kernel_kw(lr, step_f, gnorm_scale)
        tscale = (self._partition_scales(arena, grad_rows, kw)
                  if spec.needs_norms else None)
        health = (torch.zeros(kfu.N_HEALTH, device=self.device)
                  if cfg.sentinel else None)
        by_owner: dict = {}
        for pc in arena.pieces:
            by_owner.setdefault(pc.owner, []).append(pc)

        def span_update(d, start, n):
            # one launch per piece of owner d's span (its buckets)
            for pc in by_owner[d]:
                rows = slice(pc.start, pc.start + pc.n)
                h = self._launch(
                    pc, arena.master[rows], grad_rows(pc.start, pc.n),
                    base_seed, kw,
                    # a slice of the scales at an arbitrary row is not
                    # aligned: each piece gets its own copy
                    tensor_scale_blocks=None if tscale is None
                    else tscale[rows].clone())
                if health is not None:
                    health.add_(h)

        rules.shard_map_over_spans(part, span_update, self._group,
                                   self._rank)
        if self._group is not None:
            sp = part.span_pad
            own = arena.master[self._rank * sp:(self._rank + 1) * sp]
            rules.all_gather_into(arena.master, own, self._group)
            if health is not None:
                rules.all_reduce_sum(health, self._group)
        return health

    def _partition_scales(self, arena: QuantArena, grad_rows, kw
                          ) -> torch.Tensor:
        """The per-block trust ratios (total,) of a partitioned arena, on
        every rank.  "cuda": the norm prologue B4 per held piece, the
        per-block partials of every span gathered into the arena's rows
        (``rules.replicate_for_scales``: 8 floats a block, no codes) and
        finalized per segment over all rows, in the order the single
        launch finalizes them.  "torch": the oracle's whole-segment sums
        over the arena's rows gathered."""
        cfg, part = self.cfg, arena.partition
        segs = _segment_ranges(arena)
        hyper = {k: kw[k] for k in ("beta1", "beta2", "eps", "weight_decay",
                                    "step", "gnorm_scale")}
        if self._impl == "torch":
            full = lambda fn: rules.gather_span_rows(
                part, _span_rows(arena, fn), self._group)
            codes = lambda name: _rewrap(getattr(arena.pieces[0], name),
                                         full(lambda pc: _raw(
                                             getattr(pc, name))))
            two = arena.pieces[0].codes_r is not None
            return kops.segment_tensor_scales(
                self._ew_algo, full(lambda pc: arena.master[
                    pc.start:pc.start + pc.n]),
                full(lambda pc: grad_rows(pc.start, pc.n)),
                codes("codes_m"), full(lambda pc: pc.absmax_m),
                codes("codes_r") if two else None,
                full(lambda pc: pc.absmax_r) if two else None,
                self._qmap1, self._qmap2, lr=kw["lr"],
                trust_coeff=cfg.trust_coeff, segments=segs, impl="torch",
                **hyper)
        spec = kfu.ALGO_SPECS[self._ew_algo]

        def partials(pc):
            cm, bits_m, _ = unwrap_codes(pc.codes_m)
            cr, bits_r, _ = unwrap_codes(pc.codes_r)
            return kops.norm_partials(
                self._impl, arena.master[pc.start:pc.start + pc.n],
                grad_rows(pc.start, pc.n), cm, pc.absmax_m, cr, pc.absmax_r,
                self._qmap1, self._qmap2, algo=self._ew_algo, bits_m=bits_m,
                bits_r=bits_r, **hyper)

        rows = rules.replicate_for_scales(
            part, _span_rows(arena, partials), self._group)
        return kfu.segment_scales_from_partials(
            spec, rows, segs, arena.total, cfg.weight_decay,
            cfg.trust_coeff)

    def params_view(self, state: OptState,
                    param_dtype=torch.float32) -> dict:
        """Model-shape params: the masters themselves for f32 (no copy; a
        pooled small leaf's is its view of the Pool32Arena)."""
        out = {}
        for path, leaf in state.leaves.items():
            if isinstance(leaf, Pool32Leaf):
                leaf = _pool32_view(state.pool32, leaf)
            out[path] = leaf.master.to(param_dtype)
        return out

    # ------------------------------------------------------------- utilities
    def state_bytes(self, state: OptState) -> dict:
        """Measured memory of optimizer statistics vs the masters (packed
        codes count their packed bytes).  A partitioned arena counts all
        of its spans (on a group the ranks together hold them); the
        partitioned per-owner accounting (the JAX package's) is added as
        ``partition_shards``, ``owned_blocks`` and ``owned_state_bytes``."""
        stats = master = n_params = 0
        for leaf in state.leaves.values():
            if isinstance(leaf, Pool32Leaf):
                continue          # counted with the Pool32Arena below
            if isinstance(leaf, Quant8Leaf):
                stats += _leaf_stat_bytes(leaf)
                n_params += leaf.n
            elif isinstance(leaf, PooledQuantLeaf):
                n_params += leaf.n    # statistics counted with the arena
            else:
                for t in (leaf.m, leaf.r):
                    if t is not None:
                        stats += t.numel() * 4
                n_params += leaf.master.numel()
            master += leaf.master.numel() * leaf.master.element_size()
        if state.arena is not None:
            stats += state.arena.total * self._arena_block_bytes()
        if state.pool32 is not None:
            pool = state.pool32
            stats += sum(t.numel() * 4 for t in (pool.m, pool.r)
                         if t is not None)
            master += pool.master.numel() * 4
            n_params += pool.master.numel()
        out = {"state_bytes": int(stats), "master_bytes": int(master),
               "n_params": int(n_params)}
        owned = self._owned_state_bytes(state)
        if owned is not None:
            out.update(owned)
        return out

    def _arena_block_bytes(self) -> int:
        """Statistics bytes of one arena block: each state slot's (packed)
        codes and its f32 absmax."""
        bsz = self.cfg.block_size
        out = packed_width(bsz, self._fmt1.bits) + 4
        if self.cfg.has_second_moment:
            out += packed_width(bsz, self._fmt2.bits) + 4
        return out

    def _owned_state_bytes(self, state: OptState) -> Optional[dict]:
        """Partitioned (ZeRO-1) per-owner accounting, as the JAX package
        counts it: the largest owner's share of the quantized statistics —
        its arena span plus the matrix leaves it owns — with the
        (replicated) f32 pool and 32-bit overrides counted in full.  None
        when partitioning is inactive."""
        arena = state.arena
        part = arena.partition if arena is not None else None
        if part is None or not self.cfg.partition_active:
            return None
        per_block = self._arena_block_bytes()
        owner_bytes = [n * per_block for _, n in part.spans]
        matrix = [state.leaves[p] for p in leaf_order(state.leaves)
                  if isinstance(state.leaves[p], Quant8Leaf)]
        for k, leaf in enumerate(matrix):
            owner_bytes[k % part.n_shards] += _leaf_stat_bytes(leaf)
        rep = 0
        if state.pool32 is not None:
            rep += sum(t.numel() * 4 for t in (state.pool32.m,
                                               state.pool32.r)
                       if t is not None)
        for leaf in state.leaves.values():
            if isinstance(leaf, Full32Leaf):
                rep += sum(t.numel() * 4 for t in (leaf.m, leaf.r)
                           if t is not None)
        return {"partition_shards": part.n_shards,
                "owned_blocks": part.max_owned,
                "owned_state_bytes": int(max(owner_bytes) + rep)}


def _mesh_group(cfg: OptimConfig, mesh) -> tuple:
    """(group, rank, world size) of the mesh dims ``cfg.partition_axes``."""
    names = mesh.mesh_dim_names or ()
    axes = cfg.partition_axes
    if not axes or any(a not in names for a in axes):
        raise ConfigError(f"the mesh has dims {names}; partition_axis="
                          f"{cfg.partition_axis!r} names others")
    return rules.axes_group(mesh, axes)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _entry_segment(e) -> QuantSegment:
    """A GradBuffer arena entry as the QuantSegment it mirrors."""
    return QuantSegment(e[5], e[1], e[2], e[3], e[4])


def _offset_in(flat: torch.Tensor, view: torch.Tensor) -> int:
    """Element offset of ``view`` in the 1-D buffer ``flat`` it views."""
    return (view.data_ptr() - flat.data_ptr()) // flat.element_size()


def _fill_rows(dst: torch.Tensor, r0: int, r1: int, segs, grads) -> None:
    """Write the gradient elements of arena rows [r0, r1) into ``dst``
    ((r1 - r0, B), zero): each segment's part of those rows, taken from
    its param-shaped gradient ``grads[path]``."""
    bsz = dst.shape[1]
    out = dst.view(-1)
    for seg in segs:
        e0 = max(seg.offset * bsz, r0 * bsz)
        e1 = min(seg.offset * bsz + seg.n, r1 * bsz)
        if e1 > e0:
            g = grads[seg.path].reshape(-1)
            out[e0 - r0 * bsz:e1 - r0 * bsz].copy_(
                g[e0 - seg.offset * bsz:e1 - seg.offset * bsz])


def zero_block_tails(master: torch.Tensor, segments, row0: int = 0
                     ) -> None:
    """Zero each segment's block tail past its leaf's n in ``master``, the
    arena's rows from ``row0`` on: a block's tail is zero on input to the
    next update, as the per-leaf dispatch pads it each step."""
    bsz = master.shape[1]
    flat = master.view(-1)
    lo, hi = row0 * bsz, (row0 + master.shape[0]) * bsz
    for seg in segments:
        if seg.n < seg.n_blocks * bsz:
            a = max(seg.offset * bsz + seg.n, lo)
            b = min((seg.offset + seg.n_blocks) * bsz, hi)
            if a < b:
                flat[a - lo:b - lo].zero_()


def _segment_ranges(arena: QuantArena) -> tuple:
    return tuple((sg.offset, sg.n_blocks) for sg in arena.segments)


def _codes_bytes(c) -> int:
    return c.nbytes() if isinstance(c, PackedCodes) else c.numel()


def _leaf_stat_bytes(leaf: Quant8Leaf) -> int:
    """Codes and absmax bytes of a per-leaf quantized state."""
    return sum(_codes_bytes(c) + a.numel() * 4
               for c, a in ((leaf.codes_m, leaf.absmax_m),
                            (leaf.codes_r, leaf.absmax_r))
               if c is not None)


def _nonfinite_health(graw: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """(N_HEALTH,) f32 with the nonfinite counts of ``graw`` and ``p2`` in
    the grad and update slots, zero elsewhere."""
    nf = lambda x: (~torch.isfinite(x)).sum().to(torch.float32)
    h8 = torch.zeros(kfu.N_HEALTH, dtype=torch.float32, device=p2.device)
    h8[0] = nf(graw)
    h8[1] = nf(p2)
    return h8


def _sum_health(parts, device) -> torch.Tensor:
    """Sum per-leaf (N_HEALTH,) health vectors.  Counts are integer-valued
    f32, so the sum is exact in any order."""
    total = torch.zeros(kfu.N_HEALTH, dtype=torch.float32, device=device)
    for h in parts:
        total = total + h
    return total


def _master(p: torch.Tensor, dtype, casts: list) -> torch.Tensor:
    """The parameter itself as a master when it has ``dtype`` (aliasing
    it), else a copy of that dtype, recorded in ``casts`` with its
    parameter."""
    master = p.detach()
    if master.dtype == dtype:
        return master
    master = master.to(dtype)
    casts.append((p, master))
    return master


def sync_casts(state: OptState) -> None:
    """Write every master of ``state.casts`` into its parameter, rounded
    to nearest even to the parameter's dtype (the JAX package's
    ``master.astype(param_dtype)`` of its forward)."""
    with torch.no_grad():
        for param, master in state.casts or ():
            param.copy_(master)


def _full32(master: torch.Tensor, second: bool) -> Full32Leaf:
    return Full32Leaf(master=master, m=torch.zeros_like(master),
                      r=torch.zeros_like(master) if second else None)


# ------------------------------------------------------------ pooled layout
def _segment_view(blocks: torch.Tensor, seg: QuantSegment) -> torch.Tensor:
    """Segment ``seg``'s first ``n`` elements of an arena-shaped
    (total_blocks, B) tensor, in the leaf's param shape (a view)."""
    start = seg.offset * blocks.shape[1]
    return blocks.view(-1)[start:start + seg.n].view(seg.shape)


def _alias(param: torch.Tensor, view: torch.Tensor, casts: list
           ) -> torch.Tensor:
    """Copy ``param`` into its arena ``view`` and, when their dtypes agree,
    point the parameter's storage at the view, so the arena's master is
    the parameter; else record the pair in ``casts``.  Returns the view."""
    with torch.no_grad():
        view.copy_(param.detach())
    if param.dtype == view.dtype:
        param.data = view
    else:
        casts.append((param, view))
    return view


def _raw(codes):
    return codes.packed if isinstance(codes, PackedCodes) else codes


def _rewrap(like, raw):
    """``raw`` codes in ``like``'s container (PackedCodes or plain)."""
    if isinstance(like, PackedCodes):
        return PackedCodes(raw, like.bits, like.n_codes)
    return raw


def _store(dst, src) -> None:
    """Write a result into the state tensor it replaces (codes through
    PackedCodes); no copy when the backend already wrote it there, since
    copy_ onto the same memory returns at once."""
    if dst is not None and src is not None:
        _raw(dst).copy_(_raw(src))


# ------------------------------------------------ pooled <-> per-leaf views
# Checkpoints always store the per-leaf canonical layout: `unpool_state`
# gives each pooled leaf back as a Quant8Leaf / Full32Leaf whose tensors
# are views of the arenas (save side, and the in-place restore's target);
# `repool_like` writes per-leaf tensors into a pooled template's arenas.


def _slice_blocks(x, off: int, nb: int):
    """Block-dim slice [off, off+nb) of an arena tensor (a view), keeping a
    PackedCodes container."""
    if isinstance(x, PackedCodes):
        return PackedCodes(x.packed[off:off + nb], x.bits, x.n_codes)
    return x[off:off + nb]


def _pool32_view(pool: Pool32Arena, leaf: Pool32Leaf) -> Full32Leaf:
    """A pooled small leaf as the Full32Leaf of its views of the pool."""
    sl = lambda t: None if t is None else \
        t[leaf.offset:leaf.offset + leaf.n].view(leaf.shape)
    return Full32Leaf(master=sl(pool.master), m=sl(pool.m), r=sl(pool.r))


STAT_FIELDS = ("codes_m", "absmax_m", "codes_r", "absmax_r")


def _span_rows(arena: QuantArena, fn) -> dict:
    """{owner: rows of its span}: ``fn(piece)`` of each held piece,
    concatenated over the owner's pieces (in row order)."""
    out: dict = {}
    for pc in arena.pieces:
        out.setdefault(pc.owner, []).append(fn(pc))
    return {d: torch.cat(v) if len(v) > 1 else v[0] for d, v in out.items()}


def _write_rows(arena: QuantArena, name: str, off: int, src) -> None:
    """Write rows [off, off + len(src)) of statistic ``name`` into the
    held pieces that hold them (rows of pieces not held are skipped)."""
    src = _raw(src)
    end = off + src.shape[0]
    for pc in arena.pieces:
        r0, r1 = max(off, pc.start), min(end, pc.start + pc.n)
        if r1 > r0:
            _raw(getattr(pc, name))[r0 - pc.start:r1 - pc.start].copy_(
                src[r0 - off:r1 - off])


def gathered_arena(arena: Optional[QuantArena], dst: Optional[int] = None
                   ) -> Optional[QuantArena]:
    """A partitioned arena's statistics as one unpartitioned QuantArena
    (new contiguous tensors, every row): the held pieces concatenated in
    one process; on its group the spans all-gathered (every rank calls
    it), or gathered to rank ``dst`` alone (None on the others).
    Identity for an unpartitioned arena."""
    if arena is None or arena.partition is None:
        return arena
    pc0 = arena.pieces[0]
    fields = {}
    for name in STAT_FIELDS:
        if getattr(pc0, name) is None:
            fields[name] = None
            continue
        out = rules.gather_span_rows(
            arena.partition,
            _span_rows(arena, lambda pc: _raw(getattr(pc, name))),
            arena.group, dst)
        fields[name] = None if out is None else \
            _rewrap(getattr(pc0, name), out)
    if dst is not None and arena.group is not None and \
            torch.distributed.get_rank(arena.group) != dst:
        return None
    return dataclasses.replace(arena, partition=None, buckets=None,
                               pieces=(), group=None, **fields)


def gathered_state(state: OptState) -> OptState:
    """``state`` with a partitioned arena's statistics gathered into one
    unpartitioned arena (on a group all-gathered: every rank calls it),
    e.g. for a host snapshot; identity otherwise."""
    arena = state.arena
    if arena is None or arena.partition is None:
        return state
    return state._replace(arena=gathered_arena(arena))


def gather_spans(state: OptState, dst: int = 0) -> tuple:
    """(state, writer) for a checkpoint of ``state``: on a group ``writer``
    is True on rank ``dst`` alone, and a partitioned arena's spans are
    gathered to it (every rank calls this; ``dst``'s returned state holds
    the statistics unpartitioned); in one process ``(state, True)``."""
    arena = state.arena
    if arena is None or arena.group is None:
        return state, True
    if arena.partition is None:
        return state, torch.distributed.get_rank(arena.group) == dst
    whole = gathered_arena(arena, dst)
    if whole is None:
        return state, False
    return state._replace(arena=whole), True


def unpool_state(state: OptState, *, placeholders: bool = False
                 ) -> OptState:
    """Pooled layout -> per-leaf canonical layout (for per-leaf states the
    state itself, without ``casts``).  Unpartitioned, the result's tensors are views of the arenas:
    writing into it writes into ``state``.  A partitioned arena's
    statistics are copied out of its pieces (write back with
    :func:`repool_like`); on a group, where a rank holds only its own
    span, pass a gathered state, or ``placeholders=True`` for zero
    tensors of the right shapes (a restore's target)."""
    arena, pool = state.arena, state.pool32
    if arena is None and pool is None:
        # the canonical view carries no parameters (OptState.casts)
        return state if state.casts is None else state._replace(casts=None)
    if arena is not None and arena.partition is not None:
        held = {pc.owner for pc in arena.pieces}
        whole = all(n == 0 or d in held
                    for d, (_, n) in enumerate(arena.partition.spans))
        if whole:
            arena = gathered_arena(arena)
        elif placeholders:
            arena = _placeholder_arena(arena)
        else:
            raise ValueError("this rank holds one span of the partitioned "
                             "arena: gather the spans first "
                             "(blockopt.gather_spans)")

    def conv(leaf):
        if isinstance(leaf, PooledQuantLeaf):
            o, nb = leaf.offset, leaf.n_blocks
            sl = lambda x: None if x is None else _slice_blocks(x, o, nb)
            return Quant8Leaf(
                master=leaf.master, codes_m=sl(arena.codes_m),
                absmax_m=sl(arena.absmax_m), codes_r=sl(arena.codes_r),
                absmax_r=sl(arena.absmax_r), shape=leaf.shape, n=leaf.n)
        if isinstance(leaf, Pool32Leaf):
            return _pool32_view(pool, leaf)
        return leaf

    return OptState(step=state.step,
                    leaves={k: conv(v) for k, v in state.leaves.items()},
                    gnorm_vec=state.gnorm_vec)


def _placeholder_arena(arena: QuantArena) -> QuantArena:
    """An unpartitioned arena of zero statistics shaped like ``arena``'s
    whole block domain."""
    pc, total = arena.pieces[0], arena.total

    def zeros(x):
        if x is None:
            return None
        raw = _raw(x)
        return _rewrap(x, raw.new_zeros((total,) + tuple(raw.shape[1:])))

    return dataclasses.replace(
        arena, partition=None, buckets=None, pieces=(),
        **{name: zeros(getattr(pc, name)) for name in STAT_FIELDS})


def repool_like(per_leaf: OptState, template: OptState) -> OptState:
    """Per-leaf state -> ``template``'s pooled layout, in place: every
    per-leaf tensor is written into the template's arenas (the parameters
    that alias them included), unless it already is the template's own
    view (as after an in-place restore into ``unpool_state(template)``);
    a partitioned arena's statistics are written into the pieces it
    holds.  Returns the template with ``per_leaf``'s step and clipping
    history; identity when the template is per-leaf.  Either way the
    parameters that are not their masters get the restored masters
    (:func:`sync_casts`)."""
    if template.arena is None and template.pool32 is None:
        # restored in place into the template's masters
        sync_casts(template)
        return per_leaf if per_leaf.casts is template.casts else \
            per_leaf._replace(casts=template.casts)
    arena = template.arena
    parted = arena is not None and arena.partition is not None
    canon = unpool_state(template, placeholders=True)
    with torch.no_grad():
        for path, tleaf in canon.leaves.items():
            got = per_leaf.leaves[path]
            pooled = isinstance(template.leaves[path], PooledQuantLeaf)
            for name in ("master", "codes_m", "absmax_m", "codes_r",
                         "absmax_r", "m", "r"):
                dst = getattr(tleaf, name, None)
                if dst is None:
                    continue
                if parted and pooled and name in STAT_FIELDS:
                    _write_rows(arena, name,
                                         template.leaves[path].offset,
                                         getattr(got, name))
                else:
                    _store(dst, getattr(got, name))
        if template.gnorm_vec is not None:
            _store(template.gnorm_vec, per_leaf.gnorm_vec)
    sync_casts(template)
    return template._replace(step=per_leaf.step)


def map_opt_states(tree, fn):
    """Apply ``fn`` to every OptState inside a container tree (dicts,
    lists, (named)tuples), leaving everything else alone."""
    if isinstance(tree, OptState):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_opt_states(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_opt_states(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_opt_states(v, fn) for v in tree)
    return tree


def zip_opt_states(tree, template, fn):
    """Parallel walk of ``tree`` and ``template``; ``fn(sub,
    template_sub)`` wherever the template holds an OptState."""
    if isinstance(template, OptState):
        return fn(tree, template)
    if isinstance(template, dict):
        return {k: zip_opt_states(tree[k], v, fn)
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(zip_opt_states(t, v, fn)
                                for t, v in zip(tree, template)))
    if isinstance(template, (list, tuple)):
        return type(template)(zip_opt_states(t, v, fn)
                              for t, v in zip(tree, template))
    return tree
