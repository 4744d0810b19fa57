"""Muon with k-bit quantized momentum (mirrors ``repro.core.optim.muon``).

``MuonOptimizer`` (Jordan et al. 2024; quantized states: Gupta et al.
2025) is a ``Block8bitOptimizer`` with a per-leaf routing split:

  * **matrix-class leaves** — 2-D params not matched by the 32-bit
    override — keep a single block-wise quantized momentum state
    (``Quant8Leaf`` with ``codes_r=None``; ``PackedCodes`` for sub-byte
    ``state_bits``).  Each step runs dequantize -> nesterov momentum EMA
    -> Newton–Schulz orthogonalization -> param update -> requantize
    through ``ops.fused_update("muon", ...)``: on the card the B2
    dequantize, B5/B6 Newton–Schulz and B1 requantize kernels.
  * **element-wise leaves** — 1-D and 3-D params, embeddings (the
    stable-embedding override), anything else — run the fused **adamw**
    path of the base engine, the pooled ``QuantArena`` single dispatch
    included: one fused launch covers all of them, and the matrix leaves
    are dispatched per leaf beside it (each is its own Newton–Schulz
    problem), in both layouts with the same leaf-order seeds, so pooled
    and per-leaf Muon are bit-identical.  Under the partitioned dispatch
    the k-th matrix leaf (leaf order) is updated by owner ``k % D`` and,
    on a process group, broadcast from it (``sharding/rules.owner_routed``).

The routing is the JAX package's: ``ndim == 2``.  On a model that stacks
its layers (paper-lm-209m), the per-layer projections are 3-D and go to
adamw, while the head and the stacked (n_layers, d_model) norm vectors are
2-D and get Newton–Schulz; the port reproduces this.

Matrix leaves below ``min_quant_size`` (or under ``bits=32`` — the f32
Muon baseline) keep f32 momentum in a ``Full32Leaf`` with ``r=None`` and
run the same Muon math in f32 (``newton_schulz.muon_math``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.optim import base
from repro_torch.core.optim.base import Full32Leaf, OptimConfig, Quant8Leaf
from repro_torch.core.optim.blockopt import Block8bitOptimizer, _store
from repro_torch.errors import ConfigError
from repro_torch.kernels import newton_schulz as kns
from repro_torch.kernels import ops as kops


class MuonOptimizer(Block8bitOptimizer):
    """Block8bitOptimizer whose 2-D leaves get Newton–Schulz-orthogonalized
    (quantized) momentum updates; all other leaves run fused adamw."""

    def __init__(self, config: OptimConfig,
                 override_32bit: Optional[Callable[[str], bool]] = None,
                 *, device="cuda", mesh=None):
        if config.algo != "muon":
            raise ConfigError(f"MuonOptimizer requires algo='muon', got "
                              f"{config.algo!r}")
        if not config.blockwise_norm:
            raise ValueError(
                "muon serves block-wise quantization only; the tensor-wise "
                "ablation is element-wise")
        if config.impl == "plain":
            raise ConfigError("muon has no 'plain' backend: its plain "
                              "math is impl='torch'")
        super().__init__(config, override_32bit, device=device, mesh=mesh)

    # ------------------------------------------------------------- routing
    def _elementwise_algo(self, algo: str) -> str:
        # element-wise fallback leaves run adamw; cfg.beta1/beta2/eps/
        # weight_decay are shared between the two classes
        return "adamw"

    def _leaf_class(self, path: str, param: torch.Tensor) -> str:
        if param.dim() == 2 and not self.override_32bit(path):
            return "matrix"
        return "ew"

    def _init_matrix_leaf(self, path: str, param: torch.Tensor,
                          master: torch.Tensor):
        cfg = self.cfg
        if self._leaf_is_quantized(path, param):
            nb = base.n_blocks_for(tuple(param.shape), cfg.block_size,
                                   cfg.shard_multiple)
            return Quant8Leaf(
                master=master,
                codes_m=self._fmt1.init_codes(nb, cfg.block_size,
                                              self.device),
                absmax_m=torch.zeros(nb, device=self.device),
                codes_r=None, absmax_r=None,
                shape=tuple(param.shape), n=param.numel())
        # f32 momentum (sub-min_quant_size leaves and the bits=32 f32-Muon
        # baseline): a one-state Full32Leaf, the same Muon math
        return Full32Leaf(master=master, m=torch.zeros_like(master), r=None)

    # ------------------------------------------------------------- updates
    def _apply_quant8(self, leaf: Quant8Leaf, g: torch.Tensor, lr, step_f,
                      seed: int, gnorm_scale):
        if leaf.codes_r is None and len(leaf.shape) == 2:
            return self._apply_muon_leaf(leaf, g, lr, seed, gnorm_scale)
        return super()._apply_quant8(leaf, g, lr, step_f, seed, gnorm_scale)

    def _apply_muon_leaf(self, leaf: Quant8Leaf, g: torch.Tensor, lr,
                         seed: int, gnorm_scale):
        """One Muon step for a quantized matrix leaf: p and g stay in the
        param's (matrix) shape, the momentum in the flat block domain.
        Under ``cfg.sentinel`` returns the leaf's summed health vector, as
        every per-leaf update does (else None)."""
        cfg = self.cfg
        res = kops.fused_update(
            "muon", leaf.master, g, leaf.codes_m, leaf.absmax_m,
            qmap_m=self._qmap1, lr=lr, beta1=cfg.beta1,
            weight_decay=cfg.weight_decay, gnorm_scale=gnorm_scale,
            stochastic=cfg.stochastic_rounding, seed=seed,
            ns_steps=cfg.ns_steps, impl=self._impl, sentinel=cfg.sentinel)
        # the entry returns new tensors: written back into the state's own,
        # which stays in place (train_step.donates)
        leaf.master.copy_(res.p)
        _store(leaf.codes_m, res.codes_m)
        _store(leaf.absmax_m, res.absmax_m)
        return res.health.sum(dim=0) if cfg.sentinel else None

    def _math32(self, g, p, m, r, lr, step_f):
        """f32 Muon math for one-state 2-D leaves (the same ``muon_math``
        the quantized entry runs, so muon32 and muon8 cannot drift apart);
        the two-state fallback leaves run the inherited adamw math."""
        if r is None and p.dim() == 2:
            cfg = self.cfg
            m2, p2 = kns.muon_math(g, p, m, beta1=cfg.beta1, lr=lr,
                                   weight_decay=cfg.weight_decay,
                                   steps=cfg.ns_steps, impl=self._impl)
            return m2, None, p2
        return super()._math32(g, p, m, r, lr, step_f)
