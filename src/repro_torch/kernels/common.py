"""Shared helpers of the block-wise kernels (mirrors ``repro.kernels.common``).

The JAX package inlines these helpers into its Pallas kernels: ``encode``
(nearest code by a compare-count over the 255 codebook midpoints),
``decode`` (codebook lookup), the counter hash ``hash_uniform`` with
``element_indices`` and ``stochastic_codes`` (stochastic rounding), and
``block_requantize`` (per-row absmax, normalize, encode, optionally round
stochastically).  On Hopper they are ``__device__`` functions in
``csrc/common.cuh``: the codebook is a 256-entry lookup table in shared
memory and encode is a branch-free binary search over the midpoints, which
equals ``searchsorted(side="right")``.  The functions below are their plain
PyTorch versions, used on CPU tensors and as the reference the kernels are
held against on the card.

The hash works on uint32 values.  PyTorch's ``uint32`` dtype supports few
operations, so the plain versions hold them in int64 and keep the low 32
bits after every multiply and shift (``& 0xFFFFFFFF``); a multiply of two
32-bit values is split in 16-bit halves so no int64 product overflows.

Boundary rows are padded to 256 lanes with +inf, as in the JAX package;
for a 2^bits-entry codebook (bits < 8) the padding starts after its
2^bits - 1 real midpoints, which caps encode at ``max_code`` = 2^bits - 1.
The kernels build the same padded rows in shared memory from the short
codebook itself, so no padded copy of the codebook is needed.
"""
from __future__ import annotations

import torch

CODEBOOK_SIZE = 256
# Seed offsets decorrelating the two state tensors' stochastic rounding.
STATE1_SEED_SALT = 0
STATE2_SEED_SALT = 0x9E3779B9
_U32 = 0xFFFFFFFF
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


def mul_u32(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x * k mod 2**32`` for int64 ``x`` in [0, 2**32) and a constant
    ``k`` in [0, 2**32), without an int64 overflow."""
    lo, hi = k & 0xFFFF, k >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def hash_uniform(idx: torch.Tensor, seed) -> torch.Tensor:
    """Counter-based uniform [0, 1) f32 values from element index + seed:
    the JAX package's finalizer hash on uint32 wrap-around arithmetic, bit
    for bit.  ``idx`` and ``seed`` are integer tensors (or a Python int for
    ``seed``) read as uint32; they broadcast."""
    seed = torch.as_tensor(seed, dtype=torch.int64, device=idx.device)
    x = ((idx.long() & _U32) + mul_u32(seed & _U32, 2654435761)) & _U32
    x = x ^ (x >> 16)
    x = mul_u32(x, 0x21F0AAAD)
    x = x ^ (x >> 15)
    x = mul_u32(x, 0x735A2D97)
    x = x ^ (x >> 15)
    # the top 24 bits -> an exactly representable uniform in [0, 1)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def element_indices(n_rows: int, n_cols: int, row_offset,
                    device=None) -> torch.Tensor:
    """Global flat element index (uint32 values in int64) of a (n_rows,
    n_cols) tile whose first row is ``row_offset`` (an int or an (n_rows,)
    integer tensor of per-row offsets) in the full block domain."""
    off = torch.as_tensor(row_offset, dtype=torch.int64, device=device)
    if off.dim() == 0:
        off = off + torch.arange(n_rows, dtype=torch.int64, device=device)
    col = torch.arange(n_cols, dtype=torch.int64, device=off.device)
    return (mul_u32(off[:, None] & _U32, n_cols) + col) & _U32


def stochastic_codes(x_norm, codes, q_near, q_other, other, u):
    """Pick the far neighbour ``other`` with probability
    ``|x - q_near| / |q_other - q_near|`` (0 when the span is 0)."""
    span = (q_other - q_near).abs()
    safe = torch.where(span > 0, span, torch.ones_like(span))
    p_other = torch.where(span > 0, (x_norm - q_near).abs() / safe,
                          torch.zeros_like(span))
    return torch.where(u < p_other, other, codes)


def block_requantize(x: torch.Tensor, bounds_row: torch.Tensor,
                     qmap_row: torch.Tensor | None = None,
                     random_u: torch.Tensor | None = None,
                     max_code: int = CODEBOOK_SIZE - 1
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row absmax normalize + encode. x: (R, B) f32 ->
    (codes int64 (R, B), absmax f32 (R, 1)).  An all-zero row keeps scale 1;
    ``x / scale`` is a true division, as in the JAX package.

    With ``random_u`` (uniforms in [0, 1) of x's shape) the encode is
    stochastic: the nearest code moves to its neighbour on the far side of
    x with probability proportional to proximity (paper App H), never past
    ``max_code``; ``qmap_row`` gives the levels."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    x_norm = x / scale
    codes = encode(x_norm, bounds_row)
    if random_u is not None:
        q_near = decode(codes, qmap_row)
        direction = torch.where(x_norm > q_near, 1, -1)
        other = (codes + direction).clamp(0, max_code)
        codes = stochastic_codes(x_norm, codes, q_near,
                                 decode(other, qmap_row), other, random_u)
    return codes, absmax
