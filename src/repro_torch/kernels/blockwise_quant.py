"""Block-wise 8-bit quantization kernel (mirrors
``repro.kernels.blockwise_quant``): ``(n_blocks, B)`` f32 -> codes uint8
``(n_blocks, B)`` and absmax f32 ``(n_blocks,)``.

``quantize_blockwise`` launches the CUDA kernel ``csrc/blockwise_quant.cu``
for CUDA tensors and runs :func:`quantize_plain` for CPU tensors.  One CTA
per quantization block, so no row padding is needed.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, common

def quantize_plain(x: torch.Tensor, codebook: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (any device)."""
    codes, absmax = common.block_requantize(x.to(torch.float32),
                                            common.padded_bounds(codebook))
    return codes.to(torch.uint8), absmax[:, 0]


def _check(x: torch.Tensor, codebook: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (n_blocks, B), got {tuple(x.shape)}")
    bsz = x.shape[1]
    if bsz % 4 or not 0 < bsz <= common.MAX_BLOCK_SIZE:
        raise ValueError(f"block size {bsz}: must be a multiple of 4 and at "
                         f"most {common.MAX_BLOCK_SIZE}")
    build.require(x, "x", torch.float32)
    build.require(codebook, "codebook", torch.float32,
                  (common.CODEBOOK_SIZE,), x.device)


def quantize_blockwise(x: torch.Tensor, codebook: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(n_blocks, B) f32 -> (codes uint8 (n_blocks, B), absmax f32
    (n_blocks,)).  ``codebook``: the 256-entry f32 map on x's device."""
    _check(x, codebook)
    if x.device.type == "cpu":
        return quantize_plain(x, codebook)
    if x.device.type != "cuda":
        raise ValueError(f"no quantize kernel for device {x.device}")
    nb, bsz = x.shape
    codes = torch.empty((nb, bsz), dtype=torch.uint8, device=x.device)
    absmax = torch.empty((nb,), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.blockwise_quantize(build.ptr(x), build.ptr(codebook),
                                    build.ptr(codes), build.ptr(absmax), nb,
                                    bsz, build.stream(x.device))
    build.check(lib, rc, "blockwise_quantize")
    quantize_blockwise.launches += 1
    return codes, absmax


quantize_blockwise.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("blockwise_quant")
    lib.blockwise_quantize.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.blockwise_quantize.restype = ctypes.c_int
    return lib
