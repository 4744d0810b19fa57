"""Shared helpers of the block-wise kernels (mirrors ``repro.kernels.common``).

The JAX package inlines three helpers into its Pallas kernels: ``encode``
(nearest code by a compare-count over the 255 codebook midpoints),
``decode`` (codebook lookup) and ``block_requantize`` (per-row absmax,
normalize, encode).  On Hopper they are ``__device__`` functions in
``csrc/common.cuh``: the codebook is a 256-entry lookup table in shared
memory and encode is a branch-free binary search over the midpoints, which
equals ``searchsorted(side="right")``.  The functions below are their plain
PyTorch versions, used on CPU tensors and as the reference the kernels are
held against on the card.

Boundary rows are padded to 256 lanes (boundary 256 = +inf), as in the JAX
package.  Codebooks are the 256-entry 8-bit maps; padding them for sub-byte
maps (``padded_qmap``) comes with ROADMAP A8, stochastic rounding
(``hash_uniform``) with B3(b).
"""
from __future__ import annotations

import torch

CODEBOOK_SIZE = 256
# Largest block a CUDA kernel holds in registers (csrc/common.cuh:
# rq_vectors_per_thread); block sizes must also be multiples of 4.
MAX_BLOCK_SIZE = 8192


def padded_bounds(codebook: torch.Tensor) -> torch.Tensor:
    """Midpoint decision boundaries padded with +inf to 256 lanes, (1, 256).

    ``(cb[1:] + cb[:-1]) * 0.5`` in f32 — the same values the kernels build
    in shared memory from the codebook."""
    cb = codebook.to(torch.float32)
    b = (cb[1:] + cb[:-1]) * 0.5
    pad = torch.full((CODEBOOK_SIZE - b.shape[0],), float("inf"),
                     dtype=torch.float32, device=cb.device)
    return torch.cat([b, pad]).reshape(1, CODEBOOK_SIZE)


def encode(x_norm: torch.Tensor, bounds_row: torch.Tensor) -> torch.Tensor:
    """Nearest-code indices (int64) for normalized values: the number of
    boundaries ``b_j <= x``.  NaN gets code 0, as the compare-count does."""
    codes = torch.searchsorted(bounds_row.reshape(-1), x_norm.contiguous(),
                               right=True)
    return torch.where(torch.isnan(x_norm), torch.zeros_like(codes), codes)


def decode(codes: torch.Tensor, qmap_row: torch.Tensor) -> torch.Tensor:
    """Codebook lookup: f32 levels of ``codes``."""
    return qmap_row.reshape(-1)[codes.long()]


def block_requantize(x: torch.Tensor, bounds_row: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax normalize + encode. x: (R, B) f32 ->
    (codes int64 (R, B), absmax f32 (R, 1)).  An all-zero row keeps scale 1;
    ``x / scale`` is a true division, as in the JAX package."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    return encode(x / scale, bounds_row), absmax
