"""Adafactor (Shazeer & Stern, 2018) — the paper's 32-bit memory-efficient
baseline (mirrors ``repro.core.optim.adafactor``), in the
time-independent-beta2 formulation the paper compares against (fixed beta2,
first moment enabled, externally supplied lr).

Second moment is factored over the last two dims for ndim>=2 leaves
(row/col means), full for 1-D leaves.  First moment is full f32.  Plain
PyTorch on any device: the JAX package runs it as plain jnp, with no
kernel.  As ``Block8bitOptimizer`` does, ``init`` aliases f32 parameters as
the masters and ``apply`` updates masters and moments in place.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.device import to_device


@dataclasses.dataclass
class AdafactorLeaf:
    master: torch.Tensor              # f32, model shape
    m: torch.Tensor                   # f32 first moment
    v_row: Optional[torch.Tensor]     # (..., rows) for ndim>=2
    v_col: Optional[torch.Tensor]     # (..., cols)
    v_full: Optional[torch.Tensor]    # for 1-D/0-D leaves


class AdafactorState(NamedTuple):
    step: int
    leaves: dict                      # path string -> AdafactorLeaf


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps1: float = 1e-30     # regularization inside the factored moment
    eps2: float = 1e-3      # rms floor
    clip_threshold: float = 1.0
    weight_decay: float = 0.0


class Adafactor:
    def __init__(self, config: AdafactorConfig, *, device="cuda"):
        self.cfg = config
        self.device = device_lib.resolve(device)

    def init(self, params: Mapping[str, torch.Tensor]) -> AdafactorState:
        leaves = {}
        for path in sorted(params):
            p = params[path]
            if p.device != self.device:
                raise ValueError(f"{path}: on {p.device}, the optimizer is "
                                 f"on {self.device}")
            master = p.detach()
            if master.dtype != torch.float32:
                master = master.to(torch.float32)
            zeros = lambda shape: torch.zeros(shape, device=p.device)
            if p.dim() >= 2:
                leaves[path] = AdafactorLeaf(
                    master=master, m=torch.zeros_like(master),
                    v_row=zeros(p.shape[:-1]),
                    v_col=zeros(p.shape[:-2] + p.shape[-1:]), v_full=None)
            else:
                leaves[path] = AdafactorLeaf(
                    master=master, m=torch.zeros_like(master), v_row=None,
                    v_col=None, v_full=torch.zeros_like(master))
        return AdafactorState(step=0, leaves=leaves)

    def _update(self, leaf: AdafactorLeaf, g: torch.Tensor, lr, step_f):
        cfg = self.cfg
        g = g.to(torch.float32)
        g2 = g * g + cfg.eps1
        corr = to_device(1 - torch.pow(torch.tensor(cfg.beta2), step_f),
                         g.device)
        if leaf.v_row is not None:
            vr = cfg.beta2 * leaf.v_row + (1 - cfg.beta2) * g2.mean(dim=-1)
            vc = cfg.beta2 * leaf.v_col + (1 - cfg.beta2) * g2.mean(dim=-2)
            # v̂ = outer(vr, vc) / mean(vr): rank-1 reconstruction
            denom = vr.mean(dim=-1, keepdim=True).clamp(min=1e-30)
            vhat = (vr / denom)[..., :, None] * vc[..., None, :]
            u = g / (torch.sqrt(vhat / corr) + cfg.eps2)
            leaf.v_row.copy_(vr)
            leaf.v_col.copy_(vc)
        else:
            vf = cfg.beta2 * leaf.v_full + (1 - cfg.beta2) * g2
            u = g / (torch.sqrt(vf / corr) + cfg.eps2)
            leaf.v_full.copy_(vf)
        # update clipping (d=1) per Adafactor alg. 4
        rms_u = torch.sqrt((u * u).mean() + 1e-30)
        u = u / torch.clamp(rms_u / cfg.clip_threshold, min=1.0)
        m2 = cfg.beta1 * leaf.m + (1 - cfg.beta1) * u
        leaf.master.copy_(leaf.master - lr * (m2 + cfg.weight_decay
                                              * leaf.master))
        leaf.m.copy_(m2)

    @torch.no_grad()
    def apply(self, grads: Mapping[str, torch.Tensor], state: AdafactorState,
              *, lr=None) -> tuple[dict, AdafactorState]:
        """One step, in place.  Returns (params view, new state)."""
        if set(grads) != set(state.leaves):
            raise ValueError("grads and optimizer state hold different "
                             "parameter paths")
        lr = to_device(torch.as_tensor(self.cfg.lr if lr is None else lr,
                                       dtype=torch.float32), self.device)
        step_f = torch.tensor(float(state.step + 1), dtype=torch.float32)
        for path, leaf in state.leaves.items():
            self._update(leaf, grads[path], lr, step_f)
        new_state = AdafactorState(step=state.step + 1, leaves=state.leaves)
        return self.params_view(new_state), new_state

    def params_view(self, state: AdafactorState,
                    param_dtype=torch.float32) -> dict:
        return {path: leaf.master.to(param_dtype)
                for path, leaf in state.leaves.items()}

    def state_bytes(self, state: AdafactorState) -> dict:
        stats = master = n_params = 0
        for leaf in state.leaves.values():
            stats += leaf.m.numel() * 4
            for v in (leaf.v_row, leaf.v_col, leaf.v_full):
                if v is not None:
                    stats += v.numel() * 4
            master += leaf.master.numel() * 4
            n_params += leaf.master.numel()
        return {"state_bytes": int(stats), "master_bytes": int(master),
                "n_params": int(n_params)}
