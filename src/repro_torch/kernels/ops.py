"""Public entry points of the kernel layer, plus the fused-update registry
(mirrors ``repro.kernels.ops``).

``impl`` selects the fused-update backend:
  * "cuda"  — the hand-written CUDA kernels' wrapper
              (``fused_update.fused_update_cuda``, with the lamb/lars norm
              prologue ``norm_partials_cuda``).  On CUDA tensors it
              launches the kernels; on CPU tensors it runs their plain
              versions.  The default.
  * "torch" — the plain oracle ``ref.fused_update_ref`` on any device.

The tensor-wise ablation (``blockwise=False``) is served by the "torch"
oracle whatever ``impl`` asks for, as the JAX package serves it from its
jnp entry: it is an accuracy ablation with no kernel.  Each dispatch is
counted under the backend that served it (:func:`fused_update_routes`).

Every kernel wrapper counts its launches; :func:`launch_counts` reads the
counts and :func:`reset_launch_counts` zeroes them, so a run can show that
its main path went through the kernels.  :func:`fused_update_count` counts
dispatches through :func:`fused_update` whatever the backend (the train
step's ``opt_fused_dispatches`` metric).
"""
from __future__ import annotations

import collections
from typing import Callable, Optional

import torch

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
    "norm_partials": _fu.norm_partials_cuda,
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
_ROUTES: collections.Counter = collections.Counter()


def reset_fused_update_count() -> None:
    _FUSED_UPDATE_CALLS[0] = 0
    _ROUTES.clear()


def fused_update_count() -> int:
    return _FUSED_UPDATE_CALLS[0]


def fused_update_routes() -> dict:
    """Dispatches per backend since the last reset, e.g. {"cuda": 11}; a
    tensor-wise ablation dispatch counts under "torch"."""
    return dict(_ROUTES)


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
for _algo in _fu.KERNEL_ALGOS:
    register(_algo, "cuda", _fu.fused_update_cuda)


def fused_update(algo: str, p, g, codes_m, absmax_m, codes_r=None,
                 absmax_r=None, qmap_m=None, qmap_r=None, *, lr, beta1=0.9,
                 beta2=0.999, eps=1e-8, weight_decay=0.0, step=1.0,
                 trust_coeff=0.001, gnorm_scale=1.0, blockwise: bool = True,
                 stochastic: bool = False, seed=0, block_seeds=None,
                 block_offsets=None, segments=None, tensor_scale_blocks=None,
                 impl: Optional[str] = None) -> _fu.FusedUpdateResult:
    """One fused 8-bit optimizer step in the flat block domain, dispatched
    on the ``(algo, impl)`` registry.  The "cuda" backend updates its
    inputs in place (see ``fused_update_cuda``); the "torch" oracle returns
    new tensors.  Use the result's fields either way.

    ``seed`` (an int, read as int32) seeds stochastic rounding for every
    block; ``block_seeds`` / ``block_offsets`` (per-block int32) and
    ``segments`` (contiguous ``(block_offset, n_blocks)`` per-tensor
    ranges for the lamb/lars trust ratios) carry several tensors' identity
    through one call; ``tensor_scale_blocks`` gives the per-block trust
    ratios directly (see :func:`segment_tensor_scales`).  codes_r and
    absmax_r are None for one-state algorithms."""
    impl = impl or DEFAULT_IMPL
    if not blockwise:
        impl = "torch"      # the tensor-wise ablation has no kernel
    fn = _REGISTRY.get((algo, impl))
    if fn is None:
        raise KeyError(f"no fused_update backend for (algo={algo!r}, "
                       f"impl={impl!r}); registered: {registered()}")
    hyper = dict(algo=algo, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                 weight_decay=weight_decay, step=step,
                 trust_coeff=trust_coeff, gnorm_scale=gnorm_scale,
                 stochastic=stochastic, seed=seed, block_seeds=block_seeds,
                 block_offsets=block_offsets, segments=segments,
                 tensor_scale_blocks=tensor_scale_blocks)
    if impl == "torch":
        hyper["blockwise"] = blockwise
    _FUSED_UPDATE_CALLS[0] += 1
    _ROUTES[impl] += 1
    return fn(p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r,
              **hyper)


def segment_tensor_scales(algo: str, p, g, codes_m, absmax_m, codes_r=None,
                          absmax_r=None, qmap_m=None, qmap_r=None, *, lr,
                          beta1=0.9, beta2=0.999, eps=1e-8,
                          weight_decay=0.0, step=1.0, trust_coeff=0.001,
                          gnorm_scale=1.0, segments=None,
                          impl: Optional[str] = None) -> torch.Tensor:
    """The per-block tensor_scale vector (n_blocks,) that ``fused_update``
    derives internally for ``algo`` and ``impl``: the norm prologue and the
    per-segment finalize ("cuda"), or the oracle's whole-segment sums
    ("torch").  All ones for block-local algorithms."""
    impl = impl or DEFAULT_IMPL
    spec = _fu.ALGO_SPECS[algo]
    nb = p.shape[0]
    if not spec.needs_norms:
        return torch.ones(nb, dtype=torch.float32, device=p.device)
    hyper = dict(beta1=beta1, beta2=beta2, eps=eps,
                 weight_decay=weight_decay, step=step,
                 gnorm_scale=gnorm_scale)
    segments = tuple(segments) if segments else ((0, nb),)
    if impl == "torch":
        return ref.segment_scales_ref(p, g, codes_m, absmax_m, codes_r,
                                      absmax_r, qmap_m, qmap_r, algo=algo,
                                      lr=lr, trust_coeff=trust_coeff,
                                      segments=segments, **hyper)
    if impl != "cuda":
        raise KeyError(f"no segment_tensor_scales backend for impl={impl!r}")
    partials = _fu.norm_partials_cuda(p, g, codes_m, absmax_m, codes_r,
                                      absmax_r, qmap_m, qmap_r, algo=algo,
                                      **hyper)
    return _fu.segment_scales_from_partials(spec, partials, segments, nb,
                                            weight_decay, trust_coeff)
