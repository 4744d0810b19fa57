"""Optimizer substrate: config, per-leaf state containers, flat block domain
(mirrors ``repro.core.optim.base``).

Every quantized parameter leaf is flattened, zero-padded to a whole number of
quantization blocks ``(n_blocks, B)``, and ``n_blocks`` is additionally
padded to a multiple of ``shard_multiple``.  The quantized statistics live in
that flat block domain; the f32 master stays in parameter shape.

``OptimConfig`` keeps every field of the JAX package's config, so a config
means the same in both packages; the engine (``blockopt.py``) raises
:class:`~repro_torch.errors.ConfigError` for the settings whose code paths
are not ported yet, naming the ROADMAP item.  The pooled arena containers
(``QuantArena``, ``Pool32Arena``, ...) are ROADMAP A9.  A quantized state
slot holds plain uint8 codes at 8 bits and
:class:`~repro_torch.core.lowbit.PackedCodes` at 4, 5 and 6 bits
(``state_bits``).
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
    impl: Optional[str] = None       # fused-update backend: cuda|torch
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


def flatten_to_blocks(x: torch.Tensor, block_size: int,
                      shard_multiple: int) -> torch.Tensor:
    """Param -> (n_blocks, B) f32 with zero padding (elements & block dim).
    A view of ``x`` when ``x`` is contiguous f32 and no padding is needed,
    so a kernel that updates the blocks in place updates ``x``."""
    flat = x.reshape(-1).to(torch.float32)
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
