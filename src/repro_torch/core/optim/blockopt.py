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

Not ported yet, and rejected with :class:`ConfigError` naming the ROADMAP
item: bf16 masters, and the ZeRO-1/2 partitioned, bucketed and
sharded-gradient dispatch (A13).
"""
from __future__ import annotations

from typing import Callable, Mapping, NamedTuple, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.device import to_device
from repro_torch.core.lowbit import CodeFormat, PackedCodes
from repro_torch.core.optim import base
from repro_torch.core.optim.base import (FlatSegment, Full32Leaf, OptimConfig,
                                         Pool32Arena, Pool32Leaf,
                                         PooledQuantLeaf, Quant8Leaf,
                                         QuantArena, QuantSegment,
                                         blocks_to_param, flatten_to_blocks)
from repro_torch.errors import ConfigError
from repro_torch.kernels import fused_update as kfu
from repro_torch.kernels import ops as kops


def leaf_order(leaves: Mapping[str, object]) -> list:
    """Path strings in the JAX package's tree order: nested dict keys
    sorted level by level (which plain string order is not: '-' sorts
    before '/')."""
    return sorted(leaves, key=lambda path: path.split("/"))


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


def _check_ported(cfg: OptimConfig) -> None:
    if cfg.partition_active or cfg.shard_grads_active:
        raise ConfigError("the partitioned (ZeRO-1), bucketed and "
                          "sharded-gradient (ZeRO-2) dispatch is not ported "
                          "yet (ROADMAP A13); leave partition, "
                          "partition_shards, shard_grads and overlap_buckets "
                          "at their defaults")
    if cfg.master_dtype != "float32":
        raise ConfigError(f"master_dtype={cfg.master_dtype!r}: the port keeps"
                          f" f32 masters")
    if cfg.impl not in (None, *kops.IMPLS):
        raise ConfigError(f"impl={cfg.impl!r}; one of {kops.IMPLS}")


class Block8bitOptimizer:
    """init/apply optimizer whose state owns the f32 masters of the
    parameters (aliasing them, see the module docstring)."""

    def __init__(self, config: OptimConfig,
                 override_32bit: Optional[Callable[[str], bool]] = None,
                 *, device="cuda"):
        _check_ported(config)
        self.cfg = config
        self.device = device_lib.resolve(device)
        self.override_32bit = override_32bit or (lambda path: False)
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
        device).  The masters alias f32 parameters; others are copied to
        f32."""
        cfg = self.cfg
        for path, p in params.items():
            if p.device != self.device:
                raise ValueError(f"{path}: on {p.device}, the optimizer is "
                                 f"on {self.device}")
        if cfg.pooling_active:
            return self._init_pooled(params)
        leaves = {}
        for path in sorted(params):
            p = params[path]
            master = _f32_master(p)
            if self._leaf_class(path, p) == "matrix":
                leaves[path] = self._init_matrix_leaf(path, p, master)
                continue
            second = cfg.has_second_moment
            if self._leaf_is_quantized(path, p):
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
        return OptState(step=0, leaves=leaves, gnorm_vec=gnorm_vec)

    def _init_pooled(self, params: Mapping[str, torch.Tensor]) -> OptState:
        """The pooled layout: quantized leaves' statistics and masters
        concatenate into one QuantArena, small leaves' f32 state into one
        Pool32Arena, segment offsets in leaf order (the order ``apply``
        numbers the leaves in).  Each f32 parameter is pointed at its
        segment of the arena's master (``p.data = view``), so the model's
        parameters stay the masters; other dtypes are copied in."""
        cfg = self.cfg
        bs, dev = cfg.block_size, self.device
        second = cfg.has_second_moment
        order = leaf_order(params)
        leaves, qsegs, fsegs = {}, [], []
        for i, path in enumerate(order):
            p = params[path]
            shape, n = tuple(p.shape), p.numel()
            if self._leaf_class(path, p) == "matrix":
                # each matrix leaf is its own Newton–Schulz problem: it
                # stays per leaf, beside the arena
                leaves[path] = self._init_matrix_leaf(path, p,
                                                      _f32_master(p))
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
                leaves[path] = _full32(_f32_master(p), second)
        arena = pool32 = None
        if qsegs:
            total = qsegs[-1][0].offset + qsegs[-1][0].n_blocks
            master = torch.zeros(total, bs, device=dev)
            for seg, _ in qsegs:
                view = _segment_view(master, seg)
                leaves[seg.path] = PooledQuantLeaf(
                    master=_alias(params[seg.path], view), shape=seg.shape,
                    n=seg.n, offset=seg.offset, n_blocks=seg.n_blocks)
            arena = QuantArena(
                codes_m=self._fmt1.init_codes(total, bs, dev),
                absmax_m=torch.zeros(total, device=dev),
                codes_r=(self._fmt2.init_codes(total, bs, dev)
                         if second else None),
                absmax_r=torch.zeros(total, device=dev) if second else None,
                segments=tuple(seg for seg, _ in qsegs), master=master,
                grad=torch.zeros(total, bs, device=dev),
                block_offsets=torch.cat([
                    torch.arange(seg.n_blocks, dtype=torch.int32)
                    for seg, _ in qsegs]).to(dev),
                leaf_seeds=torch.cat([
                    torch.full((seg.n_blocks,), kfu.to_i32(i * 7919),
                               dtype=torch.int32)
                    for seg, i in qsegs]).to(dev))
        if fsegs:
            total = fsegs[-1].offset + fsegs[-1].n
            master = torch.zeros(total, device=dev)
            for seg in fsegs:
                view = master[seg.offset:seg.offset + seg.n].view(seg.shape)
                _alias(params[seg.path], view)
                leaves[seg.path] = Pool32Leaf(shape=seg.shape, n=seg.n,
                                              offset=seg.offset)
            pool32 = Pool32Arena(
                master=master, m=torch.zeros(total, device=dev),
                r=torch.zeros(total, device=dev) if second else None,
                segments=tuple(fsegs))
        gnorm_vec = (torch.zeros(cfg.pclip_history, device=dev)
                     if cfg.percentile_clipping < 100 else None)
        return OptState(step=0, leaves={k: leaves[k] for k in order},
                        gnorm_vec=gnorm_vec, arena=arena, pool32=pool32)

    def grad_views(self, state: OptState) -> dict:
        """{path: the pooled quantized leaf's view, in param shape, of the
        arena's gradient buffer}; empty on the per-leaf layout.  A gradient
        written into its view (``torch.mul(g, scale, out=view)``) is not
        copied again by ``apply``."""
        if state.arena is None:
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
    def percentile_clip(self, grads: Mapping[str, torch.Tensor],
                        state: OptState):
        """Percentile-clipping scale for this step (bitsandbytes-style).

        Returns ``(gnorm_scale, new_gnorm_vec)``: the 0-d f32 scale every
        gradient is multiplied by inside the fused update, and the updated
        squared-gnorm history.  Scale 1 and the history unchanged when
        disabled.  The history (including this step's norm) must fill
        before clipping engages."""
        cfg = self.cfg
        if cfg.percentile_clipping >= 100 or state.gnorm_vec is None:
            # a host scalar: the fused update reads it without a sync
            return torch.ones(()), state.gnorm_vec
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

    # ---------------------------------------------------------------- update
    def _apply_quant8(self, leaf: Quant8Leaf, g: torch.Tensor, lr, step_f,
                      seed: int, gnorm_scale) -> Optional[torch.Tensor]:
        """Update one quantized leaf in place; returns its summed health
        vector under ``cfg.sentinel`` (else None)."""
        cfg = self.cfg
        gb = flatten_to_blocks(g, cfg.block_size, cfg.shard_multiple)
        mb = flatten_to_blocks(leaf.master, cfg.block_size, cfg.shard_multiple)
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
                                              torch.float32))
        leaf.codes_m, leaf.absmax_m = res.codes_m, res.absmax_m
        leaf.codes_r, leaf.absmax_r = res.codes_r, res.absmax_r
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
    def apply(self, grads: Mapping[str, torch.Tensor], state: OptState, *,
              lr=None) -> tuple:
        """One optimizer step, in place.  Returns (params view, new state);
        the new state holds the same (updated) leaf objects.  Under
        ``cfg.sentinel`` returns (params view, new state, health): the
        (N_HEALTH,) f32 sum of every leaf's health vector.

        ``grads``: path string -> gradient of the parameter's shape.
        ``lr`` overrides cfg.lr (schedules): a float or a 0-d tensor."""
        cfg = self.cfg
        if set(grads) != set(state.leaves):
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
        for i, path in enumerate(leaf_order(state.leaves)):
            leaf, g = state.leaves[path], grads[path]
            if isinstance(leaf, PooledQuantLeaf):
                continue
            if isinstance(leaf, Pool32Leaf):
                leaf = _pool32_view(state.pool32, leaf)
            if isinstance(leaf, Quant8Leaf):
                seed = kfu.to_i32(base_seed + i * 7919)
                h8 = self._apply_quant8(leaf, g, lr_host, step_f, seed,
                                        gnorm_scale)
            else:
                h8 = self._apply_full32(leaf, g, lr_dev, step_f, gnorm_scale)
            health_parts.append(h8)
        new_state = state._replace(step=state.step + 1, gnorm_vec=new_vec)
        if cfg.sentinel:
            return (self.params_view(new_state), new_state,
                    _sum_health(health_parts, self.device))
        return self.params_view(new_state), new_state

    def _apply_arena(self, arena: QuantArena, grads, lr, step_f,
                     base_seed: int, gnorm_scale) -> Optional[torch.Tensor]:
        """One fused update over the whole QuantArena, in place.  Gradients
        are copied into the arena's gradient buffer unless they already are
        its views (:meth:`grad_views`); the stochastic-rounding seeds are
        the per-block ``leaf_seeds`` plus this step's term, added on the
        device in int32 (wrapping, as the per-leaf seeds wrap).  Returns
        the summed health vector under ``cfg.sentinel`` (else None)."""
        cfg = self.cfg
        for seg in arena.segments:
            # no copy when the gradient is the view (copy_ onto the same
            # memory returns at once)
            _segment_view(arena.grad, seg).copy_(grads[seg.path])
        seeds = (torch.add(arena.leaf_seeds, base_seed)
                 if cfg.stochastic_rounding else None)
        res = kops.fused_update(
            self._ew_algo, arena.master, arena.grad, arena.codes_m,
            arena.absmax_m, arena.codes_r, arena.absmax_r, self._qmap1,
            self._qmap2, lr=lr, beta1=cfg.beta1, beta2=cfg.beta2,
            eps=cfg.eps, weight_decay=cfg.weight_decay, step=step_f,
            trust_coeff=cfg.trust_coeff, gnorm_scale=gnorm_scale,
            blockwise=True, stochastic=cfg.stochastic_rounding,
            block_seeds=seeds, block_offsets=arena.block_offsets,
            segments=tuple((sg.offset, sg.n_blocks)
                           for sg in arena.segments),
            impl=self._impl, sentinel=cfg.sentinel)
        # the "cuda" backend updated the arena in place; the "torch" oracle
        # returned new tensors
        for dst, src in zip((arena.master, arena.codes_m, arena.absmax_m,
                             arena.codes_r, arena.absmax_r), res[:5]):
            _store(dst, src)
        # a block's tail past its leaf's n is zero on input, as the
        # per-leaf dispatch pads it each step
        bsz = arena.master.shape[1]
        flat = arena.master.view(-1)
        for seg in arena.segments:
            if seg.n < seg.n_blocks * bsz:
                flat[seg.offset * bsz + seg.n:
                     (seg.offset + seg.n_blocks) * bsz].zero_()
        return res.health.sum(dim=0) if cfg.sentinel else None

    def params_view(self, state: OptState,
                    param_dtype=torch.float32) -> dict:
        """Model-shape params: the masters themselves for f32 (no copy; a
        pooled small leaf's is its view of the Pool32Arena)."""
        return {path: leaf.master.to(param_dtype)
                for path, leaf in unpool_state(state).leaves.items()}

    # ------------------------------------------------------------- utilities
    def state_bytes(self, state: OptState) -> dict:
        """Measured memory of optimizer statistics vs the masters (packed
        codes count their packed bytes)."""
        stats = master = n_params = 0

        def codes_bytes(*slots):
            return sum((c.nbytes() if isinstance(c, PackedCodes)
                        else c.numel()) + a.numel() * 4
                       for c, a in slots if c is not None)

        for leaf in state.leaves.values():
            if isinstance(leaf, Pool32Leaf):
                continue          # counted with the Pool32Arena below
            if isinstance(leaf, Quant8Leaf):
                stats += codes_bytes((leaf.codes_m, leaf.absmax_m),
                                     (leaf.codes_r, leaf.absmax_r))
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
            a = state.arena
            stats += codes_bytes((a.codes_m, a.absmax_m),
                                 (a.codes_r, a.absmax_r))
        if state.pool32 is not None:
            pool = state.pool32
            stats += sum(t.numel() * 4 for t in (pool.m, pool.r)
                         if t is not None)
            master += pool.master.numel() * 4
            n_params += pool.master.numel()
        return {"state_bytes": int(stats), "master_bytes": int(master),
                "n_params": int(n_params)}


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


def _f32_master(p: torch.Tensor) -> torch.Tensor:
    """The parameter itself as a master when it is f32 (aliasing it), else
    an f32 copy."""
    master = p.detach()
    return master if master.dtype == torch.float32 else \
        master.to(torch.float32)


def _full32(master: torch.Tensor, second: bool) -> Full32Leaf:
    return Full32Leaf(master=master, m=torch.zeros_like(master),
                      r=torch.zeros_like(master) if second else None)


# ------------------------------------------------------------ pooled layout
def _segment_view(blocks: torch.Tensor, seg: QuantSegment) -> torch.Tensor:
    """Segment ``seg``'s first ``n`` elements of an arena-shaped
    (total_blocks, B) tensor, in the leaf's param shape (a view)."""
    start = seg.offset * blocks.shape[1]
    return blocks.view(-1)[start:start + seg.n].view(seg.shape)


def _alias(param: torch.Tensor, view: torch.Tensor) -> torch.Tensor:
    """Copy ``param`` into its arena ``view`` and, when it is f32, point
    the parameter's storage at the view, so the arena's master is the
    parameter.  Returns the view."""
    with torch.no_grad():
        view.copy_(param.detach())
    if param.dtype == torch.float32:
        param.data = view
    return view


def _raw(codes):
    return codes.packed if isinstance(codes, PackedCodes) else codes


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


def unpool_state(state: OptState) -> OptState:
    """Pooled layout -> per-leaf canonical layout whose tensors are views of
    the arenas (identity for per-leaf states): writing into the result
    writes into ``state``."""
    arena, pool = state.arena, state.pool32
    if arena is None and pool is None:
        return state

    def conv(leaf):
        if isinstance(leaf, PooledQuantLeaf):
            o, nb = leaf.offset, leaf.n_blocks
            return Quant8Leaf(
                master=leaf.master,
                codes_m=_slice_blocks(arena.codes_m, o, nb),
                absmax_m=_slice_blocks(arena.absmax_m, o, nb),
                codes_r=None if arena.codes_r is None
                else _slice_blocks(arena.codes_r, o, nb),
                absmax_r=None if arena.absmax_r is None
                else _slice_blocks(arena.absmax_r, o, nb),
                shape=leaf.shape, n=leaf.n)
        if isinstance(leaf, Pool32Leaf):
            return _pool32_view(pool, leaf)
        return leaf

    return OptState(step=state.step,
                    leaves={k: conv(v) for k, v in state.leaves.items()},
                    gnorm_vec=state.gnorm_vec)


def repool_like(per_leaf: OptState, template: OptState) -> OptState:
    """Per-leaf state -> ``template``'s pooled layout, in place: every
    per-leaf tensor is written into the template's arenas (the parameters
    that alias them included), unless it already is the template's own
    view (as after an in-place restore into ``unpool_state(template)``).
    Returns the template with ``per_leaf``'s step and clipping history;
    identity when the template is per-leaf."""
    if template.arena is None and template.pool32 is None:
        return per_leaf
    canon = unpool_state(template)
    with torch.no_grad():
        for path, tleaf in canon.leaves.items():
            got = per_leaf.leaves[path]
            for name in ("master", "codes_m", "absmax_m", "codes_r",
                         "absmax_r", "m", "r"):
                dst = getattr(tleaf, name, None)
                if dst is not None:
                    _store(dst, getattr(got, name))
        if template.gnorm_vec is not None:
            _store(template.gnorm_vec, per_leaf.gnorm_vec)
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
