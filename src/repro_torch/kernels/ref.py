"""Plain PyTorch oracles for the kernels (mirrors ``repro.kernels.ref``).

All functions operate in the flat block domain: state tensors are
``(n_blocks, B)``, absmax is ``(n_blocks,)``.  ``fused_update_ref`` shares
the 32-bit update math with ``fused_update.py`` (parity by construction) but
keeps independent quantization mechanics (``searchsorted`` + gather on the
255 real midpoints), as the JAX oracle does.  It is registered in ``ops.py``
as the ``impl="torch"`` entry.  Block-wise, deterministic rounding only:
the tensor-wise ablation and stochastic rounding are ROADMAP A7.
"""
from __future__ import annotations

import torch

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


def fused_update_ref(p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m,
                     qmap_r, *, algo: str, lr, beta1=0.9, beta2=0.999,
                     eps=1e-8, weight_decay=0.0, step=1.0, gnorm_scale=1.0
                     ) -> fu.FusedUpdateResult:
    """The paper's §2 procedure (dequantize -> 32-bit update -> requantize)
    for adam/adamw as straight-line ops; returns new tensors."""
    spec = fu.ALGO_SPECS[algo]
    s = fu.scalars(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                   weight_decay=weight_decay, step=step,
                   gnorm_scale=gnorm_scale, device=p.device)
    g = g.to(torch.float32) * s["gnorm_scale"]
    m = dequantize_ref(codes_m, absmax_m, qmap_m)
    r = dequantize_ref(codes_r, absmax_r, qmap_r)
    m2, r2, p2 = fu.update_math(spec, g, p.to(torch.float32), m, r, s)
    cm, am = quantize_ref(m2, qmap_m)
    cr, ar = quantize_ref(r2, qmap_r)
    return fu.FusedUpdateResult(p2, cm, am, cr, ar)
