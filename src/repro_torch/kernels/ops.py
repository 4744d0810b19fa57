"""Public entry points of the kernel layer, plus the fused-update registry
(mirrors ``repro.kernels.ops``).

``impl`` selects the fused-update backend:
  * "cuda"  — the hand-written CUDA kernels' wrapper
              (``fused_update.fused_update_cuda``, with the lamb/lars norm
              prologue ``norm_partials_cuda``).  On CUDA tensors it
              launches the kernels; on CPU tensors it runs their plain
              versions.  The default.
  * "torch" — the plain oracle ``ref.fused_update_ref`` on any device.

Sub-byte state widths ride through the same entry point: callers pass
:class:`~repro_torch.core.lowbit.PackedCodes` instead of plain uint8 codes.
:func:`fused_update` unwraps them, hands the per-slot widths to the backend
(the kernel unpacks and re-packs on chip; the oracle unpacks and re-packs
around its math) and re-wraps the results.

Muon (a matrix-class algorithm) registers under the same keys: its entry
(:func:`_muon_entry`) takes ``p`` / ``g`` in the leaf's 2-D shape and the
momentum state in the flat block domain, and runs dequantize -> momentum ->
Newton–Schulz (``kernels/newton_schulz.py``) -> parameter update ->
requantize.  With "cuda" every step of it is a kernel on the card: B2
dequantize, the B5/B6 products (the m x m finalize aside), B1 requantize.

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

from repro_torch.core.lowbit.packing import (PackedCodes, pack_codes,
                                             unpack_codes, unwrap_codes)
from repro_torch.kernels import blockwise_dequant, blockwise_quant, ref
from repro_torch.kernels import fused_update as _fu
from repro_torch.kernels import newton_schulz as _ns

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
    "ns_gram": _ns.gram_cuda,
    "ns_apply": _ns.apply_cuda,
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


def _muon_entry(impl: str) -> Callable:
    """Matrix-class (muon) update: p / g arrive in the leaf's 2-D param
    shape, the single quantized momentum state in the flat block domain
    ((n_blocks, B * bits / 8) codes, (n_blocks,) absmax).  Dequantize ->
    nesterov momentum EMA -> Newton–Schulz -> param update -> requantize
    (stochastically with the counter hash at element index row * B + col,
    seed + the state-1 salt, as the JAX package draws it).  "cuda" runs
    the quantize steps through the B1/B2 wrappers and the products through
    the B5/B6 wrappers; "torch" runs the oracles.  Returns new tensors."""
    def run(p, g, cm, am, cr, ar, qmap_m, qmap_r, *, lr, beta1,
            weight_decay, gnorm_scale, stochastic, seed, bits_m=8,
            ns_steps=_ns.DEFAULT_NS_STEPS, blockwise=True, **_unused):
        del cr, ar, qmap_r, _unused
        if not blockwise:
            raise NotImplementedError(
                "muon serves block-wise quantization only (the tensor-wise "
                "ablation is element-wise)")
        if p.dim() != 2:
            raise ValueError(f"muon takes the leaf in its 2-D param shape, "
                             f"got {tuple(p.shape)}")
        shape, n = tuple(p.shape), p.numel()
        nb, bsz = cm.shape[0], cm.shape[1] * 8 // bits_m
        seed = seed if stochastic else None
        if impl == "cuda":
            m = dequantize_blockwise(cm, am, qmap_m, bits=bits_m)
        else:
            m = ref.dequantize_ref(unpack_codes(cm, bits_m), am, qmap_m)
        m = m.reshape(-1)[:n].reshape(shape)
        m2, p2 = _ns.muon_math(g.to(torch.float32) * gnorm_scale,
                               p.to(torch.float32), m, beta1=beta1, lr=lr,
                               weight_decay=weight_decay, steps=ns_steps,
                               impl=impl)
        blocks = torch.nn.functional.pad(m2.reshape(-1),
                                         (0, nb * bsz - n)).reshape(nb, bsz)
        if impl == "cuda":
            cm2, am2 = quantize_blockwise(blocks, qmap_m, bits=bits_m,
                                          seed=seed)
        else:
            u = (None if seed is None else _fu.block_uniforms(
                nb, bsz, two=False, seed=seed, device=p.device)[0])
            cm2, am2 = ref._requantize(blocks, qmap_m, blockwise=True,
                                       random_u=u)
            cm2 = pack_codes(cm2, bits_m)
        return _fu.FusedUpdateResult(p2, cm2, am2, None, None)
    return run


for _algo, _spec in _fu.ALGO_SPECS.items():
    if _spec.matrix:
        for _impl in IMPLS:
            register(_algo, _impl, _muon_entry(_impl))
        continue
    register(_algo, "torch", ref.fused_update_ref)
for _algo in _fu.KERNEL_ALGOS:
    register(_algo, "cuda", _fu.fused_update_cuda)


def fused_update(algo: str, p, g, codes_m, absmax_m, codes_r=None,
                 absmax_r=None, qmap_m=None, qmap_r=None, *, lr, beta1=0.9,
                 beta2=0.999, eps=1e-8, weight_decay=0.0, step=1.0,
                 trust_coeff=0.001, gnorm_scale=1.0, blockwise: bool = True,
                 stochastic: bool = False, seed=0, block_seeds=None,
                 block_offsets=None, segments=None, tensor_scale_blocks=None,
                 ns_steps: int = _ns.DEFAULT_NS_STEPS,
                 impl: Optional[str] = None) -> _fu.FusedUpdateResult:
    """One fused k-bit optimizer step in the flat block domain, dispatched
    on the ``(algo, impl)`` registry.  The "cuda" backend of the
    element-wise algorithms updates its inputs in place (see
    ``fused_update_cuda``); the "torch" oracle and the muon entries return
    new tensors.  Use the result's fields either way.

    ``codes_m`` / ``codes_r`` are plain uint8 tensors (8-bit states) or
    :class:`~repro_torch.core.lowbit.PackedCodes` (4/5/6-bit states); the
    result's codes come back in the same container type, and each qmap
    must have 2^bits entries.  Muon takes ``p`` / ``g`` in the leaf's 2-D
    shape and runs ``ns_steps`` Newton–Schulz iterations.

    ``seed`` (an int, read as int32) seeds stochastic rounding for every
    block; ``block_seeds`` / ``block_offsets`` (per-block int32) and
    ``segments`` (contiguous ``(block_offset, n_blocks)`` per-tensor
    ranges for the lamb/lars trust ratios) carry several tensors' identity
    through one call; ``tensor_scale_blocks`` gives the per-block trust
    ratios directly (see :func:`segment_tensor_scales`).  codes_r and
    absmax_r are None for one-state algorithms."""
    impl = impl or DEFAULT_IMPL
    matrix = algo in _fu.ALGO_SPECS and _fu.ALGO_SPECS[algo].matrix
    if not blockwise and not matrix:
        impl = "torch"      # the tensor-wise ablation has no kernel
    fn = _REGISTRY.get((algo, impl))
    if fn is None:
        raise KeyError(f"no fused_update backend for (algo={algo!r}, "
                       f"impl={impl!r}); registered: {registered()}")
    has_second = codes_r is not None
    codes_m, bits_m, ncodes_m = unwrap_codes(codes_m)
    codes_r, bits_r, ncodes_r = unwrap_codes(codes_r)
    checks = [(qmap_m, bits_m, "qmap_m")]
    if has_second:
        checks.append((qmap_r, bits_r, "qmap_r"))
    for qm, bits, name in checks:
        if qm is not None and qm.shape[-1] != (1 << bits):
            raise ValueError(f"{name} has {qm.shape[-1]} levels; "
                             f"{bits}-bit codes need {1 << bits}")
    hyper = dict(algo=algo, lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                 weight_decay=weight_decay, step=step,
                 trust_coeff=trust_coeff, gnorm_scale=gnorm_scale,
                 stochastic=stochastic, seed=seed, block_seeds=block_seeds,
                 block_offsets=block_offsets, segments=segments,
                 tensor_scale_blocks=tensor_scale_blocks, bits_m=bits_m,
                 bits_r=bits_r)
    if matrix:
        hyper.update(ns_steps=ns_steps, blockwise=blockwise)
    elif impl == "torch":
        hyper["blockwise"] = blockwise
    _FUSED_UPDATE_CALLS[0] += 1
    _ROUTES[impl] += 1
    res = fn(p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r,
             **hyper)
    if ncodes_m is not None:
        res = res._replace(codes_m=PackedCodes(res.codes_m, bits_m, ncodes_m))
    if ncodes_r is not None and res.codes_r is not None:
        res = res._replace(codes_r=PackedCodes(res.codes_r, bits_r, ncodes_r))
    return res


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
    codes_m, bits_m, _ = unwrap_codes(codes_m)
    codes_r, bits_r, _ = unwrap_codes(codes_r)
    hyper = dict(beta1=beta1, beta2=beta2, eps=eps,
                 weight_decay=weight_decay, step=step,
                 gnorm_scale=gnorm_scale, bits_m=bits_m, bits_r=bits_r)
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
