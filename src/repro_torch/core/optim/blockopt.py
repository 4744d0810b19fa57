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

Not ported yet, and rejected with :class:`ConfigError` naming the ROADMAP
item: the pooled single dispatch (``pooled=True`` with quantized leaves,
A9 — ``make_optimizer`` defaults to ``pooled=False``), muon (A10), the
sentinel (A11) and bf16 masters.
"""
from __future__ import annotations

from typing import Callable, Mapping, NamedTuple, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.device import to_device
from repro_torch.core.lowbit import CodeFormat
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
    if cfg.algo not in kfu.ALGO_SPECS:
        raise ConfigError(f"algo {cfg.algo!r} is not ported yet (ROADMAP "
                          f"A10); the port has {tuple(kfu.ALGO_SPECS)}")
    if cfg.pooling_active:
        raise ConfigError("pooled=True (the pooled single dispatch) is not "
                          "ported yet (ROADMAP A9); pass pooled=False — "
                          "per-leaf and pooled updates are bit-identical")
    if cfg.sentinel:
        raise ConfigError("the numerics sentinel is not ported yet "
                          "(ROADMAP A11)")
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
        spec = kfu.ALGO_SPECS[cfg.algo]
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
                      seed: int, gnorm_scale) -> None:
        cfg = self.cfg
        gb = flatten_to_blocks(g, cfg.block_size, cfg.shard_multiple)
        mb = flatten_to_blocks(leaf.master, cfg.block_size, cfg.shard_multiple)
        res = kops.fused_update(
            cfg.algo, mb, gb, leaf.codes_m, leaf.absmax_m, leaf.codes_r,
            leaf.absmax_r, self._qmap1, self._qmap2, lr=lr, beta1=cfg.beta1,
            beta2=cfg.beta2, eps=cfg.eps, weight_decay=cfg.weight_decay,
            step=step_f, trust_coeff=cfg.trust_coeff,
            gnorm_scale=gnorm_scale, blockwise=cfg.blockwise_norm,
            stochastic=cfg.stochastic_rounding, seed=seed, impl=self._impl)
        # mb is a view of the master unless padding forced a copy; the
        # "cuda" backend writes its result into mb.
        if not (res.p is mb and mb.data_ptr() == leaf.master.data_ptr()):
            leaf.master.copy_(blocks_to_param(res.p, leaf.shape, leaf.n,
                                              torch.float32))
        leaf.codes_m, leaf.absmax_m = res.codes_m, res.absmax_m
        leaf.codes_r, leaf.absmax_r = res.codes_r, res.absmax_r

    def _apply_full32(self, leaf: Full32Leaf, g: torch.Tensor, lr, step_f,
                      gnorm_scale) -> None:
        g = g.to(torch.float32) * gnorm_scale
        m2, r2, p2 = self._math32(g, leaf.master, leaf.m, leaf.r, lr, step_f)
        leaf.master.copy_(p2)
        leaf.m.copy_(m2)
        if leaf.r is not None:
            leaf.r.copy_(r2)

    @torch.no_grad()
    def apply(self, grads: Mapping[str, torch.Tensor], state: OptState, *,
              lr=None) -> tuple[dict, OptState]:
        """One optimizer step, in place.  Returns (params view, new state);
        the new state holds the same (updated) leaf objects.

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
        for i, path in enumerate(leaf_order(state.leaves)):
            leaf, g = state.leaves[path], grads[path]
            if isinstance(leaf, Quant8Leaf):
                seed = kfu.to_i32(base_seed + i * 7919)
                self._apply_quant8(leaf, g, lr_host, step_f, seed,
                                   gnorm_scale)
            else:
                self._apply_full32(leaf, g, lr_dev, step_f, gnorm_scale)
        new_state = OptState(step=state.step + 1, leaves=state.leaves,
                             gnorm_vec=new_vec)
        return self.params_view(new_state), new_state

    def params_view(self, state: OptState,
                    param_dtype=torch.float32) -> dict:
        """Model-shape params: the masters themselves for f32 (no copy)."""
        return {path: leaf.master.to(param_dtype)
                for path, leaf in state.leaves.items()}

    # ------------------------------------------------------------- utilities
    def state_bytes(self, state: OptState) -> dict:
        """Measured memory of optimizer statistics vs the masters."""
        stats = master = n_params = 0
        for leaf in state.leaves.values():
            if isinstance(leaf, Quant8Leaf):
                for c, a in ((leaf.codes_m, leaf.absmax_m),
                             (leaf.codes_r, leaf.absmax_r)):
                    if c is not None:
                        stats += c.numel() + a.numel() * 4
                n_params += leaf.n
            else:
                for t in (leaf.m, leaf.r):
                    if t is not None:
                        stats += t.numel() * 4
                n_params += leaf.master.numel()
            master += leaf.master.numel() * leaf.master.element_size()
        return {"state_bytes": int(stats), "master_bytes": int(master),
                "n_params": int(n_params)}
