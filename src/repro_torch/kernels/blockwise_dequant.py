"""Block-wise dequantization kernel (mirrors
``repro.kernels.blockwise_dequant``): ``codebook[code] * absmax`` as f32 or
bf16, ``(n_blocks, B)``.

``dequantize_blockwise`` launches the CUDA kernel
``csrc/blockwise_dequant.cu`` for CUDA tensors and runs
:func:`dequantize_plain` for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, common

OUT_DTYPES = (torch.float32, torch.bfloat16)


def dequantize_plain(codes: torch.Tensor, absmax: torch.Tensor,
                     codebook: torch.Tensor, dtype=torch.float32
                     ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device)."""
    return (common.decode(codes, codebook) * absmax[:, None]).to(dtype)


def _check(codes, absmax, codebook, dtype) -> None:
    if codes.dim() != 2:
        raise ValueError(f"codes must be (n_blocks, B), got "
                         f"{tuple(codes.shape)}")
    if codes.shape[1] % 4:
        raise ValueError(f"block size {codes.shape[1]} must be a multiple "
                         f"of 4")
    if dtype not in OUT_DTYPES:
        raise TypeError(f"dtype {dtype}: one of {OUT_DTYPES}")
    build.require(codes, "codes", torch.uint8)
    build.require(absmax, "absmax", torch.float32, (codes.shape[0],),
                  codes.device)
    build.require(codebook, "codebook", torch.float32,
                  (common.CODEBOOK_SIZE,), codes.device)


def dequantize_blockwise(codes: torch.Tensor, absmax: torch.Tensor,
                         codebook: torch.Tensor, *, dtype=torch.float32
                         ) -> torch.Tensor:
    """(codes (n_blocks, B) uint8, absmax (n_blocks,)) -> values
    (n_blocks, B) of ``dtype`` (f32 or bf16)."""
    _check(codes, absmax, codebook, dtype)
    if codes.device.type == "cpu":
        return dequantize_plain(codes, absmax, codebook, dtype)
    if codes.device.type != "cuda":
        raise ValueError(f"no dequantize kernel for device {codes.device}")
    nb, bsz = codes.shape
    out = torch.empty((nb, bsz), dtype=dtype, device=codes.device)
    lib = _lib()
    with torch.cuda.device(codes.device):
        rc = lib.blockwise_dequantize(
            build.ptr(codes), build.ptr(absmax), build.ptr(codebook),
            build.ptr(out), int(dtype == torch.bfloat16), nb, bsz,
            build.stream(codes.device))
    build.check(lib, rc, "blockwise_dequantize")
    dequantize_blockwise.launches += 1
    return out


dequantize_blockwise.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("blockwise_dequant")
    lib.blockwise_dequantize.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.blockwise_dequantize.restype = ctypes.c_int
    return lib
