"""Plain PyTorch oracles for the kernels (mirrors ``repro.kernels.ref``).

All functions operate in the flat block domain: state tensors are
``(n_blocks, B)``, absmax is ``(n_blocks,)``.  ``fused_update_ref`` shares
the 32-bit update math and the trust-ratio finalization with
``fused_update.py`` (parity by construction) but keeps independent
quantization mechanics (``searchsorted`` + gather on the 255 real
midpoints) and takes each trust ratio as one whole-tensor sum, as the JAX
oracle does.  It also serves the ablation the kernels do not: tensor-wise
(single absmax) quantization.  It is registered in ``ops.py`` as the
``impl="torch"`` entry for every algorithm.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import common
from repro_torch.kernels import fused_update as fu


def _bounds(codebook: torch.Tensor) -> torch.Tensor:
    return (codebook[1:] + codebook[:-1]) * 0.5


def quantize_ref(x: torch.Tensor, codebook: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(n_blocks, B) f32 -> (codes uint8, absmax f32)."""
    x = x.to(torch.float32)
    absmax = x.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    xn = x / scale[:, None]
    codes = torch.searchsorted(_bounds(codebook), xn.contiguous(), right=True)
    return codes.to(torch.uint8), absmax


def dequantize_ref(codes: torch.Tensor, absmax: torch.Tensor,
                   codebook: torch.Tensor, dtype=torch.float32
                   ) -> torch.Tensor:
    return (codebook[codes.long()] * absmax[:, None]).to(dtype)


def _requantize(x: torch.Tensor, codebook: torch.Tensor, *, blockwise: bool,
                random_u: Optional[torch.Tensor]
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Requantize one state tensor: block-wise or tensor-wise absmax,
    optionally with stochastic rounding (same uniforms as the kernel)."""
    if blockwise:
        absmax = x.abs().amax(dim=-1)
    else:
        # tensor-wise ablation: a single absmax for the whole tensor
        absmax = x.abs().amax().expand(x.shape[0]).contiguous()
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    xn = x / scale[:, None]
    codes = torch.searchsorted(_bounds(codebook), xn.contiguous(), right=True)
    if random_u is not None:
        q_near = codebook[codes]
        direction = torch.where(xn > q_near, 1, -1)
        other = (codes + direction).clamp(0, codebook.shape[0] - 1)
        codes = common.stochastic_codes(xn, codes, q_near, codebook[other],
                                        other, random_u)
    return codes.to(torch.uint8), absmax


def _segment_scales(spec, g, p, m, r, s, trust_coeff, segments):
    """Per-block tensor_scale vector from per-segment trust ratios, each a
    whole-slice sum (shared by ``fused_update_ref`` and
    ``segment_scales_ref``)."""
    two = spec.n_states == 2

    def seg_scale(i, off, nb):
        sl = slice(off, off + nb)
        return fu.tensor_scale_for(spec, g[sl], p[sl], m[sl],
                                   r[sl] if two else None, s, trust_coeff)

    return fu.segment_scale_vector(segments, p.shape[0], seg_scale, p.device)


def _prepare(algo, p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m,
             qmap_r, hyper):
    spec = fu.ALGO_SPECS[algo]
    two = spec.n_states == 2
    s = fu.scalars(device=p.device, **hyper)
    g = g.to(torch.float32) * s["gnorm_scale"]
    m = dequantize_ref(codes_m, absmax_m, qmap_m)
    r = dequantize_ref(codes_r, absmax_r, qmap_r) if two else None
    s["tensor_scale"] = torch.ones((), dtype=torch.float32, device=p.device)
    return spec, s, p.to(torch.float32), g, m, r


def segment_scales_ref(
    p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r, *,
    algo: str, lr, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0,
    step=1.0, trust_coeff=0.001, gnorm_scale=1.0, segments=None,
) -> torch.Tensor:
    """Standalone (n_blocks,) per-block tensor_scale pass, exactly the
    vector ``fused_update_ref`` derives internally."""
    spec = fu.ALGO_SPECS[algo]
    n_blocks = p.shape[0]
    if not spec.needs_norms:
        return torch.ones(n_blocks, dtype=torch.float32, device=p.device)
    spec, s, p, g, m, r = _prepare(
        algo, p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r,
        dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
             weight_decay=weight_decay, step=step, gnorm_scale=gnorm_scale))
    tc = torch.as_tensor(trust_coeff, dtype=torch.float32, device=p.device)
    return _segment_scales(spec, g, p, m, r, s, tc,
                           tuple(segments) if segments else ((0, n_blocks),))


def fused_update_ref(
    p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r, *,
    algo: str, lr, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0,
    step=1.0, trust_coeff=0.001, gnorm_scale=1.0, blockwise: bool = True,
    stochastic: bool = False, seed=0, block_seeds=None, block_offsets=None,
    segments=None, tensor_scale_blocks=None,
) -> fu.FusedUpdateResult:
    """The paper's §2 procedure (dequantize -> 32-bit update -> requantize)
    for any of the six algorithms as straight-line ops; returns new
    tensors.  ``block_seeds`` / ``block_offsets`` / ``segments`` carry a
    pooled dispatch's per-leaf identity (None keeps the single-tensor
    meaning); ``tensor_scale_blocks`` replaces the trust-ratio computation
    with a given per-block vector."""
    spec, s, p, g, m, r = _prepare(
        algo, p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r,
        dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
             weight_decay=weight_decay, step=step, gnorm_scale=gnorm_scale))
    two = spec.n_states == 2
    tc = torch.as_tensor(trust_coeff, dtype=torch.float32, device=p.device)
    if tensor_scale_blocks is not None:
        s["tensor_scale"] = torch.as_tensor(
            tensor_scale_blocks, dtype=torch.float32, device=p.device)[:, None]
    elif spec.needs_norms and segments:
        s["tensor_scale"] = _segment_scales(spec, g, p, m, r, s, tc,
                                            tuple(segments))[:, None]
    else:
        s["tensor_scale"] = fu.tensor_scale_for(spec, g, p, m, r, s, tc)

    m2, r2, p2 = fu.update_math(spec, g, p, m, r, s)

    u1 = u2 = None
    if stochastic:
        nb, bsz = codes_m.shape
        u1, u2 = fu.block_uniforms(nb, bsz, two=two, seed=seed,
                                   block_seeds=block_seeds,
                                   block_offsets=block_offsets,
                                   device=p.device)
    cm, am = _requantize(m2, qmap_m, blockwise=blockwise, random_u=u1)
    if two:
        cr, ar = _requantize(r2, qmap_r, blockwise=blockwise, random_u=u2)
        return fu.FusedUpdateResult(p2, cm, am, cr, ar)
    return fu.FusedUpdateResult(p2, cm, am, None, None)
