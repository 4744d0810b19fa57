"""Optimizer substrate: config, per-leaf state containers, flat block domain
(mirrors ``repro.core.optim.base``).

Every quantized parameter leaf is flattened, zero-padded to a whole number of
quantization blocks ``(n_blocks, B)``, and ``n_blocks`` is additionally
padded to a multiple of ``shard_multiple``.  The quantized statistics live in
that flat block domain; the f32 master stays in parameter shape.

``OptimConfig`` keeps every field of the JAX package's config, so a config
means the same in both packages; the engine (``blockopt.py``) raises
:class:`~repro_torch.errors.ConfigError` for the settings whose code paths
are not ported yet, naming the ROADMAP item.  A quantized state slot holds
plain uint8 codes at 8 bits and
:class:`~repro_torch.core.lowbit.PackedCodes` at 4, 5 and 6 bits
(``state_bits``).

The pooled layout (``pooled=True``, the default) concatenates every
quantized leaf into one :class:`QuantArena` and every small leaf into one
:class:`Pool32Arena`; per-leaf identity lives in the static segments and in
the :class:`PooledQuantLeaf` / :class:`Pool32Leaf` nodes.  Unlike the JAX
package's, the port's arenas also own the f32 masters: each parameter is a
view into its arena's master, so the update writes the model's weights in
place with no per-step copy.

The ZeRO-1 partition (``partition`` / ``partition_shards``) splits the
QuantArena's block dim into owned spans (:class:`ArenaPartition`,
:func:`make_partition`) and each span into bucket ranges
(:class:`BucketPlan`, :func:`make_buckets`), with the JAX package's
arithmetic.  A partitioned arena holds its block-domain statistics as one
:class:`ArenaPiece` per (span, bucket): tensors of their own, so every
per-block vector a kernel reads starts 16-byte aligned whatever row the
piece starts at.  One process holds every piece; a rank of a process group
holds the pieces of its own span only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import blockwise
from repro_torch.core.lowbit import SUPPORTED_BITS, CodeFormat
from repro_torch.errors import ConfigError

ALGOS = ("adam", "adamw", "momentum", "lamb", "lars", "adagrad", "muon")


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Configuration for Block8bitOptimizer (and its 32-bit twin)."""

    algo: str = "adam"
    bits: int = 8                    # quantized (8) or full 32-bit state
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    block_size: int = blockwise.DEFAULT_BLOCK_SIZE
    qmap_m: str = "dynamic"          # signed map for state 1
    qmap_r: str = "dynamic"          # unsigned map for state 2
    blockwise_norm: bool = True      # False => tensor-wise absmax (ablation)
    stochastic_rounding: bool = False
    # Percentile clipping (bitsandbytes-style, DESIGN.md §7): keep a history
    # of the last ``pclip_history`` squared global gradient norms and scale
    # gradients down to the ``percentile_clipping``-th percentile of that
    # history. 100 disables it (no history state is allocated).
    percentile_clipping: int = 100
    pclip_history: int = 100
    # Per-state-slot storage bitwidth for quantized leaves (DESIGN.md §9):
    # an int (both slots) or a (bits_m, bits_r) pair, each in {4, 5, 6, 8};
    # None keeps the paper's 8-bit format.  Li et al. 2023 recommend a
    # 4-bit first moment with an 8-bit second moment: state_bits=(4, 8);
    # Gupta et al. 2025 show the same block-wise recipe holds for Muon's
    # matrix-shaped momentum (bits_m applies to it; DESIGN.md §11).
    state_bits: Optional[Any] = None
    # bitsandbytes-style small-tensor threshold: leaves with fewer elements
    # keep fp32 state.  ``min_quantized_size`` is the canonical name;
    # ``min_8bit_size`` is the legacy alias (used when the former is None).
    min_quantized_size: Optional[int] = None
    min_8bit_size: int = 4096        # legacy alias of min_quantized_size
    shard_multiple: int = 1          # pad n_blocks to a multiple (mesh size)
    # dtype of the stored parameter master copy. "float32" keeps a full
    # master (classic mixed precision); "bfloat16" matches the reference
    # implementation, which updates the 16-bit weights in place (update math
    # is always f32 in registers). Huge archs use bf16 (DESIGN.md §6).
    master_dtype: str = "float32"
    impl: Optional[str] = None       # fused-update backend: cuda|torch|plain
    # LARS/LAMB trust-ratio hyper
    trust_coeff: float = 0.001
    # Muon: Newton–Schulz iteration count for the matrix-class leaves
    # (kernels/newton_schulz.py; DESIGN.md §11).  Ignored by every
    # element-wise algorithm.
    ns_steps: int = 5
    # Pooled single-dispatch (DESIGN.md §10): at init, all quantized leaves
    # are concatenated into one (total_blocks, B) block arena per state
    # format, so `apply` issues ONE fused_update per arena instead of one
    # per leaf; sub-min_quant_size leaves pool into one shared fp32 arena.
    # False keeps the per-leaf dispatch — the parity oracle and the layout
    # the tensor-wise ablation (blockwise_norm=False) always uses.
    pooled: bool = True
    # ZeRO-1 partitioning of the pooled arenas (DESIGN.md §12): the block
    # dim of the QuantArena (and the element dim of the Pool32Arena) is
    # split into `partition_shards` contiguous owned spans, and `apply`
    # updates each span independently — on a mesh with a `partition_axis`
    # of matching size, via shard_map so every device runs ONE local fused
    # update over just its owned span (grads reduce-scatter in, updated
    # master slices all-gather out).  `partition=None` means auto: active
    # iff partition_shards > 1; True forces the span-structured dispatch
    # even for a single shard (the 1-device degenerate case), False
    # disables it.  Bit-exact vs the unpartitioned pooled dispatch by the
    # same contract pooled holds vs per-leaf (tests/test_partition.py).
    partition: Optional[bool] = None
    partition_shards: int = 1        # data-parallel degree (owned spans)
    # Mesh axes the shard_map path owns spans over, comma-separated in
    # major-to-minor order ("data"; "pod,data" on multi-pod meshes — the
    # product of the axis sizes must equal partition_shards).
    partition_axis: str = "data"
    # ZeRO-2 (DESIGN.md §13): accumulate gradients directly in the arena's
    # block domain, sharded to the owned span — the replicated param-shaped
    # grad pytree never materializes, cutting peak grad memory D ways.
    # Consumed by train/loop.py (``GradBuffer`` accumulation); requires the
    # pooled layout (it reuses the arena's segment map).
    shard_grads: bool = False
    # Bucketed overlap (DESIGN.md §13): each owned span is subdivided into
    # ``overlap_buckets`` contiguous bucket chunks; gradient accumulation
    # reduce-scatters bucket-by-bucket and the partitioned dispatch fires
    # one fused_update per bucket instead of one per span, so bucket k's
    # update can overlap bucket k+1's communication.  1 = the PR-5
    # sequential dispatch (one launch per span).  Bit-exact either way:
    # the update is block-local once trust scales are finalized globally.
    overlap_buckets: int = 1
    # Quantization-health probe schedule (DESIGN.md §14): every N steps the
    # HOST loop runs telemetry.qhealth probes over the optimizer state and
    # emits qhealth events.  0 (default) = off.  The flag is deliberately
    # never read inside the jitted train step — probes are a separate jitted
    # function on the host schedule, so the step's computation (and its
    # StableHLO) is identical at any value, and the only added host sync is
    # at the scheduled step (tests/test_telemetry.py pins this).
    telemetry_every: int = 0
    # In-graph numerics sentinel (DESIGN.md §16): the fused update kernels
    # additionally emit per-block health counts (nonfinite grads/updates,
    # absmax overflow, requant edge-code saturation — the HealthFlags of
    # telemetry/sentinel.py) and ``apply`` returns them as a third output.
    # Off (default) the kernels, the apply signature and the step's
    # StableHLO are byte-identical to a build without the feature; on, the
    # donation/aliasing set of the jitted step is unchanged (both pinned by
    # the ``train_step.sentinel_invariant`` compile contract).
    sentinel: bool = False

    def __post_init__(self):
        if self.algo not in ALGOS:
            raise ConfigError(f"unknown algo {self.algo!r}; one of {ALGOS}")
        if self.bits not in (8, 32):
            raise ConfigError(f"bits={self.bits}; quantized state is 8-bit "
                              f"(sub-byte widths ride state_bits), master "
                              f"precision is 32")
        if not 0 < self.percentile_clipping <= 100:
            raise ConfigError(f"percentile_clipping={self.percentile_clipping}"
                              f" must be in (0, 100]")
        if self.pclip_history <= 0:
            raise ConfigError(f"pclip_history={self.pclip_history} must be "
                              f"positive")
        if self.partition_shards < 1:
            raise ConfigError(f"partition_shards={self.partition_shards} "
                              f"must be >= 1")
        if self.overlap_buckets < 1:
            raise ConfigError(f"overlap_buckets={self.overlap_buckets} "
                              f"must be >= 1")
        if self.telemetry_every < 0:
            raise ConfigError(f"telemetry_every={self.telemetry_every} "
                              f"must be >= 0")
        if self.shard_grads and not self.pooled:
            raise ValueError(
                "shard_grads accumulates gradients in the pooled arena's "
                "block domain and cannot combine with pooled=False "
                "(DESIGN.md §13)")
        for b in self.state_bits_pair:
            if b not in SUPPORTED_BITS:
                raise ConfigError(f"state_bits={self.state_bits}: width {b} "
                                  f"unsupported (choose from "
                                  f"{SUPPORTED_BITS})")
        if not isinstance(self.ns_steps, int) or self.ns_steps < 0:
            raise ConfigError(f"ns_steps={self.ns_steps!r} must be an int "
                              f">= 0")

    @property
    def state_bits_pair(self) -> tuple:
        """(bits_m, bits_r) storage bitwidths for quantized leaves."""
        sb = self.state_bits
        if sb is None:
            return (8, 8)
        if isinstance(sb, int):
            return (sb, sb)
        pair = tuple(sb)
        if len(pair) != 2:
            raise ConfigError(f"state_bits={sb!r}: pass an int or a "
                              f"(bits_m, bits_r) pair")
        return pair

    @property
    def min_quant_size(self) -> int:
        """Effective small-tensor threshold (canonical name wins)."""
        if self.min_quantized_size is not None:
            return self.min_quantized_size
        return self.min_8bit_size

    @property
    def has_second_moment(self) -> bool:
        # adagrad's accumulator lives in the (unsigned) first-state slot
        # (paper Table 1: AdaGrad is a one-state optimizer).  muon counts
        # as two-state here because its *element-wise fallback* leaves run
        # adamw (DESIGN.md §11); muon's matrix leaves carry a single
        # momentum slot (codes_r=None) regardless.
        return self.algo in ("adam", "adamw", "lamb", "muon")

    @property
    def pooling_active(self) -> bool:
        """Whether init/apply use the pooled arena layout.  The tensor-wise
        ablation needs a per-*tensor* absmax, which the arena (one logical
        tensor) cannot represent, and a 32-bit engine has no quantized
        leaves to pool — both fall back to the per-leaf dispatch."""
        return self.pooled and self.blockwise_norm and self.bits != 32

    @property
    def partition_axes(self) -> tuple:
        """``partition_axis`` parsed into a tuple of mesh axis names."""
        return tuple(a.strip() for a in self.partition_axis.split(",")
                     if a.strip())

    @property
    def partition_active(self) -> bool:
        """Whether init attaches an ArenaPartition and apply runs the
        span-structured (ZeRO-1) dispatch.  Partitioning subdivides the
        pooled arenas, so it requires the pooled layout."""
        if not self.pooling_active:
            return False
        if self.partition is None:
            return self.partition_shards > 1
        return self.partition

    @property
    def shard_grads_active(self) -> bool:
        """Whether the train loop accumulates gradients in the ZeRO-2
        block-domain GradBuffer (DESIGN.md §13).  Needs the pooled arena
        for the segment map; a 32-bit engine has no arena to target."""
        return self.shard_grads and self.pooling_active

    @property
    def overlap_active(self) -> bool:
        """Whether the partitioned dispatch runs bucket-by-bucket
        (DESIGN.md §13).  Buckets subdivide owned spans, so they require
        the span-structured (partitioned) dispatch — partition_shards=1
        with partition=True is the valid single-device degenerate case."""
        return self.partition_active and self.overlap_buckets > 1

    def state_bytes_per_param(self) -> float:
        """Analytic bytes/param of the *optimizer statistics* (paper Table 1/2
        accounting; excludes the master copy which all variants share).

        For muon the dominant (matrix) leaves hold a *single* momentum
        slot (DESIGN.md §11), so the analytic figure counts one slot —
        the small element-wise adamw-fallback fraction is two-state and
        pushes the *measured* ``state_bytes`` metric slightly above this.
        """
        one_state = (not self.has_second_moment) or self.algo == "muon"
        if self.bits == 32:
            return 4.0 * (1 if one_state else 2)
        b1, b2 = self.state_bits_pair
        total = CodeFormat(bits=b1).bytes_per_param(self.block_size)
        if not one_state:
            total += CodeFormat(bits=b2).bytes_per_param(self.block_size)
        return total


@dataclasses.dataclass
class Quant8Leaf:
    """Quantized state for one parameter leaf, flat block domain.  The
    master is kept in parameter shape; the optimizer updates it, the codes
    and the absmax vectors in place."""
    master: torch.Tensor            # param shape, f32
    codes_m: Any                    # (n_blocks, B) uint8 | PackedCodes
    absmax_m: torch.Tensor          # (n_blocks,)  f32
    codes_r: Any                    # present iff the leaf has 2 states
    absmax_r: Optional[torch.Tensor]
    shape: tuple                    # original param shape
    n: int                          # logical element count


@dataclasses.dataclass
class Full32Leaf:
    """32-bit state for one parameter leaf (override / small leaves /
    32-bit baseline), kept in model shape."""
    master: torch.Tensor            # param shape, f32
    m: torch.Tensor                 # param shape, f32
    r: Optional[torch.Tensor]       # param shape, f32 (second moment)


# --------------------------------------------------- pooled arena containers
@dataclasses.dataclass(frozen=True)
class QuantSegment:
    """Static per-leaf slice of a QuantArena."""
    path: str        # leaf path string
    offset: int      # first block of this leaf in the arena
    n_blocks: int    # whole blocks incl. shard_multiple padding
    shape: tuple     # original param shape
    n: int           # logical element count


@dataclasses.dataclass(frozen=True)
class FlatSegment:
    """Static per-leaf slice of a Pool32Arena (element granularity)."""
    path: str
    offset: int      # first element of this leaf in the flat arena
    n: int
    shape: tuple


@dataclasses.dataclass(frozen=True)
class ArenaPartition:
    """Static ZeRO-1 ownership map over an arena's leading dim: owner d's
    span is ``spans[d] = (start, n)`` with ``start = d * span_pad`` —
    spans tile ``[0, total)`` contiguously on a grid of ``span_pad`` rows.
    Trailing spans may be shorter than ``span_pad`` (uneven arenas) or
    empty.  ``matrix_owners`` routes Muon's matrix leaves whole-leaf: the
    k-th matrix leaf (leaf order) belongs to owner ``k % n_shards``."""
    n_shards: int
    total: int                  # blocks (QuantArena) / elements (Pool32)
    span_pad: int               # rows per owner in the padded domain
    spans: tuple                # ((start, n), ...) — len == n_shards
    matrix_owners: tuple = ()   # ((leaf_path, owner), ...)

    @property
    def padded_total(self) -> int:
        return self.n_shards * self.span_pad

    @property
    def max_owned(self) -> int:
        """Largest owned span (rows of real, unpadded state)."""
        return max((n for _, n in self.spans), default=0)

    def owner_of(self, row: int) -> int:
        return min(row // self.span_pad, self.n_shards - 1)


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Static grad-bucket layout over an ArenaPartition: bucket k covers
    the local rows ``ranges[k] = (k0, k1)`` of *each* owner's
    ``span_pad``-row span, i.e. global rows ``d * span_pad + [k0, k1)``
    for every owner d.  Ranges are non-empty, disjoint and tile ``[0,
    span_pad)``.  The k-th matrix leaf (leaf order) flushes with bucket
    ``k % n_buckets``."""
    n_buckets: int              # requested bucket count
    span_pad: int               # rows per owner (ArenaPartition.span_pad)
    ranges: tuple               # ((k0, k1), ...) local row ranges
    matrix_buckets: tuple = ()  # ((leaf_path, bucket), ...)

    def bucket_of(self, row: int, part: ArenaPartition) -> int:
        """Bucket index owning global arena row ``row``."""
        local = row - part.owner_of(row) * part.span_pad
        for k, (k0, k1) in enumerate(self.ranges):
            if k0 <= local < k1:
                return k
        raise ValueError((row, local, self.ranges))


def make_buckets(part: ArenaPartition, n_buckets: int,
                 grid: int = 1) -> BucketPlan:
    """Chunk each owned span of ``part`` into up to ``n_buckets`` bucket
    ranges aligned to ``grid`` (the shard_multiple block grid).  Small
    spans yield fewer (never empty) ranges; every local row [0, span_pad)
    is covered exactly once."""
    if n_buckets < 1 or grid < 1:
        raise ConfigError(f"make_buckets needs n_buckets >= 1 and grid >= 1,"
                          f" got ({n_buckets}, {grid})")
    span_pad = part.span_pad
    per = -(-span_pad // n_buckets) if span_pad else 0
    chunk = max(-(-per // grid) * grid, grid)
    ranges = []
    k0 = 0
    while k0 < span_pad:
        k1 = min(k0 + chunk, span_pad)
        ranges.append((k0, k1))
        k0 = k1
    matrix_buckets = tuple((path, k % n_buckets)
                           for k, (path, _) in enumerate(part.matrix_owners))
    return BucketPlan(n_buckets=n_buckets, span_pad=span_pad,
                      ranges=tuple(ranges), matrix_buckets=matrix_buckets)


def make_partition(total: int, n_shards: int, grid: int = 1,
                   matrix_owners: tuple = ()) -> ArenaPartition:
    """Split ``total`` rows into ``n_shards`` contiguous owned spans padded
    to a multiple of ``grid``.  The spans cover exactly ``[0, total)``;
    uneven totals leave the trailing spans short or empty."""
    if n_shards < 1 or total < 0 or grid < 1:
        raise ConfigError(f"make_partition needs n_shards >= 1, total >= 0,"
                          f" grid >= 1; got ({total}, {n_shards}, {grid})")
    per = -(-total // n_shards) if total else 0
    span_pad = max(-(-per // grid) * grid, grid)
    spans = []
    for d in range(n_shards):
        start = d * span_pad
        spans.append((start, max(0, min(span_pad, total - start))))
    return ArenaPartition(n_shards=n_shards, total=total, span_pad=span_pad,
                          spans=tuple(spans),
                          matrix_owners=tuple(matrix_owners))


@dataclasses.dataclass
class ArenaPiece:
    """Rows [start, start + n) of a partitioned QuantArena — one bucket
    of owner ``owner``'s span — in tensors of their own: the codes and
    absmax of each state slot, and the static per-block element offsets
    and seed terms copied from the arena's layout."""
    owner: int
    start: int
    n: int
    codes_m: Any                    # (n, B) uint8 | PackedCodes
    absmax_m: torch.Tensor          # (n,) f32
    codes_r: Any
    absmax_r: Optional[torch.Tensor]
    block_offsets: torch.Tensor     # (n,) int32
    leaf_seeds: torch.Tensor        # (n,) int32


@dataclasses.dataclass
class PooledQuantLeaf:
    """Per-leaf node of a pooled quantized leaf: its master (a view, in
    param shape, of the arena's master) and its blocks' place in the
    arena."""
    master: torch.Tensor
    shape: tuple
    n: int
    offset: int
    n_blocks: int


@dataclasses.dataclass
class Pool32Leaf:
    """Per-leaf marker of a small leaf pooled into the Pool32Arena; all of
    its state (the master included) lives in the arena."""
    shape: tuple
    n: int
    offset: int


@dataclasses.dataclass
class QuantArena:
    """Pooled statistics of every quantized leaf: one (total_blocks, B)
    codes + (total_blocks,) absmax pair per state slot, segment by segment
    in leaf order.  The port's arena also holds what the update reads in
    the block domain: the ``master`` (f32, or bf16 with
    ``master_dtype="bfloat16"``; each parameter of that dtype is a view of
    its segment, the padding zero), the f32 ``grad`` buffer the step's
    gradients are gathered into (its padding never written), and per
    block the
    element-index ``block_offsets`` and the stochastic-rounding seed term
    ``leaf_seeds`` (``i * 7919`` in int32, i the leaf's index in leaf
    order).

    Partitioned (``partition`` set), the block-domain statistics and
    per-block vectors live in ``pieces`` (:class:`ArenaPiece`, the ones
    this process holds, in row order) and the arena-wide fields are None;
    ``master`` and ``grad`` then have ``partition.padded_total`` rows (the
    rows past the last segment stay zero), and ``grad`` is None where
    ZeRO-2 keeps only the owned span of the gradients.  ``group`` is the
    data-parallel process group the arena's ranks share (None in one
    process, which holds every piece).  An unpartitioned
    arena's ``grad`` may also have more rows than blocks: the padded
    layout of a data-parallel gradient reduction."""
    codes_m: Any                    # (total_blocks, B) uint8 | PackedCodes
    absmax_m: Optional[torch.Tensor]    # (total_blocks,) f32
    codes_r: Optional[Any]
    absmax_r: Optional[torch.Tensor]
    segments: tuple                 # tuple[QuantSegment, ...]
    master: torch.Tensor            # (total_blocks, B) master dtype
    grad: Optional[torch.Tensor]    # (rows >= total_blocks, B) f32
    block_offsets: Optional[torch.Tensor]   # (total_blocks,) int32
    leaf_seeds: Optional[torch.Tensor]      # (total_blocks,) int32
    partition: Optional[ArenaPartition] = None
    buckets: Optional[BucketPlan] = None
    pieces: tuple = ()              # tuple[ArenaPiece, ...]
    group: Any = None               # the data-parallel process group

    @property
    def total(self) -> int:
        """Blocks of the arena (its segments' rows, padding excluded)."""
        last = self.segments[-1]
        return last.offset + last.n_blocks


@dataclasses.dataclass
class Pool32Arena:
    """Pooled f32 state (master + moments) of the sub-min_quant_size
    leaves, flat (total_n,) element domain, one update per step; each
    parameter is a view of its segment of ``master``."""
    master: torch.Tensor            # (total_n,) f32
    m: torch.Tensor                 # (total_n,) f32
    r: Optional[torch.Tensor]       # (total_n,) f32 (second moment)
    segments: tuple                 # tuple[FlatSegment, ...]
    # the ZeRO-1 ownership map at element granularity: accounting only,
    # every process holds and updates the whole pool
    partition: Optional[ArenaPartition] = None


def flatten_to_blocks(x: torch.Tensor, block_size: int,
                      shard_multiple: int,
                      dtype=torch.float32) -> torch.Tensor:
    """Param -> (n_blocks, B) of ``dtype`` (f32 by default, as in the JAX
    package; a bf16 master's blocks stay bf16) with zero padding (elements
    & block dim).  A view of ``x`` when ``x`` is contiguous, of ``dtype``
    and no padding is needed, so a kernel that updates the blocks in place
    updates ``x``."""
    flat = x.reshape(-1).to(dtype)
    blocks = blockwise.pad_to_blocks(flat, block_size)
    nb = blocks.shape[0]
    target = -(-nb // shard_multiple) * shard_multiple
    if target != nb:
        blocks = torch.nn.functional.pad(blocks, (0, 0, 0, target - nb))
    return blocks


def blocks_to_param(blocks: torch.Tensor, shape: tuple, n: int,
                    dtype) -> torch.Tensor:
    """Flat block domain -> model-shape param of `dtype`."""
    return blocks.reshape(-1)[:n].reshape(shape).to(dtype)


def n_blocks_for(shape: tuple, block_size: int, shard_multiple: int) -> int:
    n = 1
    for s in shape:
        n *= s
    nb = -(-n // block_size)
    return -(-nb // shard_multiple) * shard_multiple


def path_str(path) -> str:
    """A parameter's path string, 'a/b/0/c', as the JAX package's
    ``path_str`` gives it for the same leaf: from a PyTorch parameter name
    ('a.b.0.c') or a sequence of keys."""
    if isinstance(path, str):
        return path.replace(".", "/")
    return "/".join(str(p) for p in path)


def default_override_32bit(path: str) -> bool:
    """Paper §2.3: embedding layers use 32-bit optimizer states."""
    p = path.lower()
    return ("embed" in p) or ("wte" in p) or ("wpe" in p)
