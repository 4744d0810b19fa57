"""Block-wise dequantization kernel (mirrors
``repro.kernels.blockwise_dequant``): ``codebook[code] * absmax`` as f32 or
bf16, ``(n_blocks, B)``; the codes are uint8 ``(n_blocks, B)`` at 8 bits
and packed ``(n_blocks, B * bits / 8)`` rows at 4, 5 and 6 bits
(``core/lowbit/packing.py``).

``dequantize_blockwise`` launches the CUDA kernel
``csrc/blockwise_dequant.cu`` for CUDA tensors and runs
:func:`dequantize_plain` for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.lowbit.packing import unpack_codes
from repro_torch.kernels import build, common

OUT_DTYPES = (torch.float32, torch.bfloat16)


def dequantize_plain(codes: torch.Tensor, absmax: torch.Tensor,
                     codebook: torch.Tensor, dtype=torch.float32, *,
                     bits: int = 8) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device)."""
    if bits != 8:
        codes = unpack_codes(codes, bits)
    return (common.decode(codes, codebook) * absmax[:, None]).to(dtype)


def _check(codes, absmax, codebook, dtype, bits) -> None:
    if codes.dim() != 2:
        raise ValueError(f"codes must be (n_blocks, B * bits / 8), got "
                         f"{tuple(codes.shape)}")
    if bits not in (4, 5, 6, 8):
        raise ValueError(f"bits={bits}: one of 4, 5, 6, 8")
    bsz = codes.shape[1] * 8 // bits
    if codes.shape[1] * 8 % bits or bsz % (4 if bits == 8 else 8) or \
            bsz > common.MAX_BLOCK_SIZE:
        raise ValueError(f"{codes.shape[1]} bytes of {bits}-bit codes: the "
                         f"block size must be a multiple of 4 (of 8 when "
                         f"packed) and at most {common.MAX_BLOCK_SIZE}")
    if dtype not in OUT_DTYPES:
        raise TypeError(f"dtype {dtype}: one of {OUT_DTYPES}")
    build.require(codes, "codes", torch.uint8)
    build.require(absmax, "absmax", torch.float32, (codes.shape[0],),
                  codes.device)
    build.require(codebook, "codebook", torch.float32, (1 << bits,),
                  codes.device)


def dequantize_blockwise(codes: torch.Tensor, absmax: torch.Tensor,
                         codebook: torch.Tensor, *, dtype=torch.float32,
                         bits: int = 8) -> torch.Tensor:
    """(codes (n_blocks, B * bits / 8) uint8, absmax (n_blocks,)) -> values
    (n_blocks, B) of ``dtype`` (f32 or bf16); ``codebook`` has 2^bits
    entries."""
    _check(codes, absmax, codebook, dtype, bits)
    if codes.device.type == "cpu":
        return dequantize_plain(codes, absmax, codebook, dtype, bits=bits)
    if codes.device.type != "cuda":
        raise ValueError(f"no dequantize kernel for device {codes.device}")
    nb, bsz = codes.shape[0], codes.shape[1] * 8 // bits
    out = torch.empty((nb, bsz), dtype=dtype, device=codes.device)
    lib = _lib()
    with torch.cuda.device(codes.device):
        rc = lib.blockwise_dequantize(
            build.ptr(codes), build.ptr(absmax), build.ptr(codebook),
            build.ptr(out), int(dtype == torch.bfloat16), nb, bsz, bits,
            build.stream(codes.device))
    build.check(lib, rc, "blockwise_dequantize")
    dequantize_blockwise.launches += 1
    return out


dequantize_blockwise.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("blockwise_dequant")
    lib.blockwise_dequantize.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.blockwise_dequantize.restype = ctypes.c_int
    return lib
