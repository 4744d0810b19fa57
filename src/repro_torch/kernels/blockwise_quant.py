"""Block-wise k-bit quantization kernel (mirrors
``repro.kernels.blockwise_quant``): ``(n_blocks, B)`` f32 -> codes and
absmax f32 ``(n_blocks,)``; the codes are uint8 ``(n_blocks, B)`` at 8 bits
and packed ``(n_blocks, B * bits / 8)`` rows at 4, 5 and 6 bits
(``core/lowbit/packing.py``).  With a ``seed`` the encode rounds
stochastically (the Muon leaf update's requantize).

``quantize_blockwise`` launches the CUDA kernel ``csrc/blockwise_quant.cu``
for CUDA tensors, on the grid its library picks for the card's SM count
(CTAs that walk the blocks), and runs :func:`quantize_plain` for CPU
tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.lowbit.packing import pack_codes, packed_width
from repro_torch.kernels import build, common
from repro_torch.kernels import fused_update as fu


def quantize_plain(x: torch.Tensor, codebook: torch.Tensor, *, bits: int = 8,
                   seed: Optional[int] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (any device).  With ``seed``
    the uniforms are the counter hash of element index row * B + col with
    ``seed`` plus the state-1 salt, as the JAX package's Muon requantize
    draws them."""
    x = x.to(torch.float32)
    u = (None if seed is None else fu.block_uniforms(
        *x.shape, two=False, seed=seed, device=x.device)[0])
    codes, absmax = common.block_requantize(x, common.padded_bounds(codebook),
                                            codebook, u,
                                            max_code=(1 << bits) - 1)
    return pack_codes(codes, bits), absmax[:, 0]


def _check(x: torch.Tensor, codebook: torch.Tensor, bits: int) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (n_blocks, B), got {tuple(x.shape)}")
    bsz = x.shape[1]
    if bsz % 4 or not 0 < bsz <= common.MAX_BLOCK_SIZE:
        raise ValueError(f"block size {bsz}: must be a multiple of 4 and at "
                         f"most {common.MAX_BLOCK_SIZE}")
    packed_width(bsz, bits)                 # raises for an invalid width
    if bits != 8 and bsz % 8:
        raise ValueError(f"packed codes need a block size that is a "
                         f"multiple of 8, got {bsz}")
    build.require(x, "x", torch.float32)
    build.require(codebook, "codebook", torch.float32, (1 << bits,),
                  x.device)


def quantize_blockwise(x: torch.Tensor, codebook: torch.Tensor, *,
                       bits: int = 8, seed: Optional[int] = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(n_blocks, B) f32 -> (codes uint8 (n_blocks, B * bits / 8), absmax
    f32 (n_blocks,)).  ``codebook``: the 2^bits-entry f32 map on x's
    device; ``seed`` (an int, read as int32): round stochastically."""
    _check(x, codebook, bits)
    if x.device.type == "cpu":
        return quantize_plain(x, codebook, bits=bits, seed=seed)
    if x.device.type != "cuda":
        raise ValueError(f"no quantize kernel for device {x.device}")
    nb, bsz = x.shape
    codes = torch.empty((nb, packed_width(bsz, bits)), dtype=torch.uint8,
                        device=x.device)
    absmax = torch.empty((nb,), dtype=torch.float32, device=x.device)
    sr = seed is not None
    lib = _lib()
    ctas = lib.blockwise_quantize_ctas(nb, bsz, bits,
                                       build.sm_count(x.device))
    with torch.cuda.device(x.device):
        rc = lib.blockwise_quantize_grid(
            build.ptr(x), build.ptr(codebook), build.ptr(codes),
            build.ptr(absmax), nb, bsz, bits, int(sr),
            fu.to_i32(seed) if sr else 0, ctas, build.stream(x.device))
    build.check(lib, rc, "blockwise_quantize_grid")
    quantize_blockwise.launches += 1
    return codes, absmax


quantize_blockwise.launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry -> argtypes
ARGTYPES = {
    # x, qmap, codes, absmax, n_blocks, block_size, bits, stochastic, seed,
    # stream (one CTA per block)
    "blockwise_quantize": [_P] * 4 + [_I] * 5 + [_P],
    # as blockwise_quantize, with ctas before the stream: CTAs that walk
    # the blocks, from blockwise_quantize_ctas(n_blocks, block_size, bits,
    # SM count)
    "blockwise_quantize_grid": [_P] * 4 + [_I] * 6 + [_P],
    "blockwise_quantize_ctas": [_I] * 4,
    # its dynamic shared memory per CTA: block_size
    "blockwise_quantize_smem": [_I],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("blockwise_quant")
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
