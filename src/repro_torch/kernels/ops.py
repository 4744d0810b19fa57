"""Public entry points of the kernel layer, plus the fused-update registry
(mirrors ``repro.kernels.ops``).

``impl`` selects the fused-update backend:
  * "cuda"  — the hand-written CUDA kernel's wrapper
              (``fused_update.fused_update_cuda``).  On CUDA tensors it
              launches the kernel; on CPU tensors it runs the kernel's plain
              version.  The default.
  * "torch" — the plain oracle ``ref.fused_update_ref`` on any device.

Every kernel wrapper counts its launches; :func:`launch_counts` reads the
counts and :func:`reset_launch_counts` zeroes them, so a run can show that
its main path went through the kernels.  :func:`fused_update_count` counts
dispatches through :func:`fused_update` whatever the backend (the train
step's ``opt_fused_dispatches`` metric).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.errors import ConfigError
from repro_torch.kernels import blockwise_dequant, blockwise_quant, ref
from repro_torch.kernels import fused_update as _fu

ALGOS = tuple(_fu.ALGO_SPECS)
IMPLS = ("torch", "cuda")
DEFAULT_IMPL = "cuda"

quantize_blockwise = blockwise_quant.quantize_blockwise
dequantize_blockwise = blockwise_dequant.dequantize_blockwise

# name -> kernel wrapper; each carries an integer ``launches`` attribute.
KERNELS = {
    "blockwise_quant": blockwise_quant.quantize_blockwise,
    "blockwise_dequant": blockwise_dequant.dequantize_blockwise,
    "fused_update": _fu.fused_update_cuda,
}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset (CPU runs of the
    plain versions do not count)."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


# ----------------------------------------------------- fused-update registry
_REGISTRY: dict[tuple[str, str], Callable] = {}
_FUSED_UPDATE_CALLS = [0]


def reset_fused_update_count() -> None:
    _FUSED_UPDATE_CALLS[0] = 0


def fused_update_count() -> int:
    return _FUSED_UPDATE_CALLS[0]


def register(algo: str, impl: str, fn: Callable) -> None:
    """Register a fused-update backend under ``(algo, impl)``.  ``fn`` takes
    (p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r, **hyper)
    and returns a :class:`~repro_torch.kernels.fused_update.FusedUpdateResult`."""
    _REGISTRY[(algo, impl)] = fn


def registered(algo: str | None = None) -> list[tuple[str, str]]:
    """Registry keys, optionally filtered by algorithm."""
    return sorted(k for k in _REGISTRY if algo is None or k[0] == algo)


for _algo in ALGOS:
    register(_algo, "torch", ref.fused_update_ref)
    register(_algo, "cuda", _fu.fused_update_cuda)


def fused_update(algo: str, p, g, codes_m, absmax_m, codes_r=None,
                 absmax_r=None, qmap_m=None, qmap_r=None, *, lr, beta1=0.9,
                 beta2=0.999, eps=1e-8, weight_decay=0.0, step=1.0,
                 gnorm_scale=1.0, blockwise: bool = True,
                 stochastic: bool = False, impl: Optional[str] = None
                 ) -> _fu.FusedUpdateResult:
    """One fused 8-bit optimizer step in the flat block domain, dispatched
    on the ``(algo, impl)`` registry.  The "cuda" backend updates its
    inputs in place (see ``fused_update_cuda``); the "torch" oracle returns
    new tensors.  Use the result's fields either way."""
    if not blockwise or stochastic:
        raise ConfigError("tensor-wise quantization and stochastic rounding "
                          "are not ported yet (ROADMAP A7)")
    impl = impl or DEFAULT_IMPL
    fn = _REGISTRY.get((algo, impl))
    if fn is None:
        raise KeyError(f"no fused_update backend for (algo={algo!r}, "
                       f"impl={impl!r}); registered: {registered()}")
    _FUSED_UPDATE_CALLS[0] += 1
    return fn(p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r,
              algo=algo, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, step=step, gnorm_scale=gnorm_scale)
