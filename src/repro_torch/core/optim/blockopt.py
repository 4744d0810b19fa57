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

Not ported yet, and rejected with :class:`ConfigError` naming the ROADMAP
item: the pooled single dispatch (``pooled=True`` with quantized leaves,
A9 — ``make_optimizer`` defaults to ``pooled=False``) and bf16 masters.
"""
from __future__ import annotations

from typing import Callable, Mapping, NamedTuple, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.device import to_device
from repro_torch.core.lowbit import CodeFormat, PackedCodes
from repro_torch.core.optim import base
from repro_torch.core.optim.base import (Full32Leaf, OptimConfig, Quant8Leaf,
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
    leaves: dict               # path string -> Quant8Leaf | Full32Leaf
    # (pclip_history,) f32 squared-gnorm history, or None when percentile
    # clipping is off (cfg.percentile_clipping == 100).
    gnorm_vec: Optional[torch.Tensor] = None


def _check_ported(cfg: OptimConfig) -> None:
    if cfg.pooling_active:
        raise ConfigError("pooled=True (the pooled single dispatch) is not "
                          "ported yet (ROADMAP A9); pass pooled=False — "
                          "per-leaf and pooled updates are bit-identical")
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
        leaves = {}
        for path in sorted(params):
            p = params[path]
            if p.device != self.device:
                raise ValueError(f"{path}: on {p.device}, the optimizer is "
                                 f"on {self.device}")
            master = p.detach()
            if master.dtype != torch.float32:
                master = master.to(torch.float32)
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
                leaves[path] = Full32Leaf(
                    master=master, m=torch.zeros_like(master),
                    r=torch.zeros_like(master) if second else None)
        gnorm_vec = (torch.zeros(cfg.pclip_history, device=self.device)
                     if cfg.percentile_clipping < 100 else None)
        return OptState(step=0, leaves=leaves, gnorm_vec=gnorm_vec)

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
        for i, path in enumerate(leaf_order(state.leaves)):
            leaf, g = state.leaves[path], grads[path]
            if isinstance(leaf, Quant8Leaf):
                seed = kfu.to_i32(base_seed + i * 7919)
                h8 = self._apply_quant8(leaf, g, lr_host, step_f, seed,
                                        gnorm_scale)
            else:
                h8 = self._apply_full32(leaf, g, lr_dev, step_f, gnorm_scale)
            health_parts.append(h8)
        new_state = OptState(step=state.step + 1, leaves=state.leaves,
                             gnorm_vec=new_vec)
        if cfg.sentinel:
            return (self.params_view(new_state), new_state,
                    _sum_health(health_parts, self.device))
        return self.params_view(new_state), new_state

    def params_view(self, state: OptState,
                    param_dtype=torch.float32) -> dict:
        """Model-shape params: the masters themselves for f32 (no copy)."""
        return {path: leaf.master.to(param_dtype)
                for path, leaf in state.leaves.items()}

    # ------------------------------------------------------------- utilities
    def state_bytes(self, state: OptState) -> dict:
        """Measured memory of optimizer statistics vs the masters (packed
        codes count their packed bytes)."""
        stats = master = n_params = 0
        for leaf in state.leaves.values():
            if isinstance(leaf, Quant8Leaf):
                for c, a in ((leaf.codes_m, leaf.absmax_m),
                             (leaf.codes_r, leaf.absmax_r)):
                    if c is not None:
                        stats += (c.nbytes() if isinstance(c, PackedCodes)
                                  else c.numel()) + a.numel() * 4
                n_params += leaf.n
            else:
                for t in (leaf.m, leaf.r):
                    if t is not None:
                        stats += t.numel() * 4
                n_params += leaf.master.numel()
            master += leaf.master.numel() * leaf.master.element_size()
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
