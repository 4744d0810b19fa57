"""Block-wise 8-bit quantization (paper §2.1) — plain PyTorch reference path
(mirrors ``repro.core.blockwise``).

A tensor is treated as a flat 1-D sequence, padded to a multiple of the block
size B (paper default 2048), reshaped to ``(n_blocks, B)``, and each block is
normalized by its own absmax before nearest-code lookup in a 256-entry
codebook.  These functions run on whatever device their inputs live on; the
CUDA kernels in ``repro_torch.kernels`` are held against them.

Stochastic rounding here draws its uniforms from a ``torch.Generator``, as
the JAX package draws them from a PRNG key: the two cannot give the same
numbers, so the port is held to the rounding's invariants (neighbouring
codes, unbiased mean), not bit for bit.  The optimizer's stochastic
rounding uses the counter hash instead (``kernels/common.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import qmap as qmap_lib

DEFAULT_BLOCK_SIZE = 2048


def pad_to_blocks(flat: torch.Tensor, block_size: int) -> torch.Tensor:
    """Pad a flat tensor with zeros to a whole number of blocks.  Returns a
    view of ``flat`` when no padding is needed."""
    n = flat.shape[0]
    n_blocks = -(-n // block_size)
    pad = n_blocks * block_size - n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(n_blocks, block_size)


def nearest_code(x_norm: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour code via the 255 midpoint boundaries:
    ``code = #{j : b_j <= x}`` == searchsorted(side='right')."""
    return torch.searchsorted(bounds, x_norm, right=True).to(torch.uint8)


def quantize_blocks(blocks: torch.Tensor, codebook: torch.Tensor, *,
                    stochastic_rounding: bool = False,
                    generator: Optional[torch.Generator] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``(n_blocks, B)`` f32 -> (codes uint8, absmax f32 (n_blocks,)).

    ``stochastic_rounding`` rounds to one of the two neighbouring codes with
    probability proportional to proximity (paper App H), with uniforms from
    ``generator`` (required)."""
    blocks = blocks.to(torch.float32)
    absmax = blocks.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    x = (blocks / scale[:, None]).contiguous()
    bounds = (codebook[1:] + codebook[:-1]) * 0.5
    codes = torch.searchsorted(bounds, x, right=True)
    if stochastic_rounding:
        if generator is None:
            raise ValueError("stochastic_rounding requires a torch.Generator")
        q_near = codebook[codes]
        direction = torch.where(x > q_near, 1, -1)
        other = (codes + direction).clamp(0, codebook.shape[0] - 1)
        span = (codebook[other] - q_near).abs()
        p_other = torch.where(span > 0, (x - q_near).abs() / torch.where(
            span > 0, span, torch.ones_like(span)), torch.zeros_like(span))
        u = torch.rand(x.shape, generator=generator, device=x.device)
        codes = torch.where(u < p_other, other, codes)
    return codes.to(torch.uint8), absmax


def dequantize_blocks(codes: torch.Tensor, absmax: torch.Tensor,
                      codebook: torch.Tensor) -> torch.Tensor:
    """Dequantize (codes, absmax) -> f32 blocks."""
    return codebook[codes.long()] * absmax[:, None]


@dataclasses.dataclass
class QuantizedTensor:
    """8-bit block-wise quantized tensor in the flat block domain.

    codes:  uint8 ``(n_blocks, B)``
    absmax: f32  ``(n_blocks,)``
    The logical (unpadded) element count and original shape are kept so the
    tensor can be restored exactly.
    """

    codes: torch.Tensor
    absmax: torch.Tensor
    shape: tuple
    qmap_name: str
    signed: bool

    @property
    def block_size(self) -> int:
        return self.codes.shape[-1]

    @property
    def n_elements(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def nbytes(self) -> int:
        return self.codes.numel() + self.absmax.numel() * 4


def _codebook(qmap_name: str, signed: bool, device) -> torch.Tensor:
    return torch.as_tensor(qmap_lib.get_qmap(qmap_name, signed),
                           device=device)


def quantize(x: torch.Tensor, *, qmap_name: str = "dynamic",
             signed: bool = True, block_size: int = DEFAULT_BLOCK_SIZE,
             pad_blocks_to: int = 1, stochastic_rounding: bool = False,
             generator: Optional[torch.Generator] = None) -> QuantizedTensor:
    """Quantize an arbitrary-shape tensor into the flat block domain.

    ``pad_blocks_to``: pad n_blocks up to a multiple (whole blocks per
    shard)."""
    shape = tuple(x.shape)
    codebook = _codebook(qmap_name, signed, x.device)
    blocks = pad_to_blocks(x.reshape(-1), block_size)
    if pad_blocks_to > 1:
        nb = blocks.shape[0]
        target = -(-nb // pad_blocks_to) * pad_blocks_to
        if target != nb:
            blocks = torch.nn.functional.pad(blocks, (0, 0, 0, target - nb))
    codes, absmax = quantize_blocks(blocks, codebook,
                                    stochastic_rounding=stochastic_rounding,
                                    generator=generator)
    return QuantizedTensor(codes=codes, absmax=absmax, shape=shape,
                           qmap_name=qmap_name, signed=signed)


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """Restore the original-shape tensor (f32 by default)."""
    codebook = _codebook(qt.qmap_name, qt.signed, qt.codes.device)
    flat = dequantize_blocks(qt.codes, qt.absmax, codebook).reshape(-1)
    return flat[:qt.n_elements].reshape(qt.shape).to(dtype)


def quantization_error(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Mean absolute dequantization error (for analysis benchmarks)."""
    return (dequantize(qt) - x).abs().mean()
