"""Bit-packing of sub-byte optimizer-state codes into uint8 words (mirrors
``repro.core.lowbit.packing``).

Layout: codes are written MSB-first into a big-endian bitstream per row —
code i occupies stream bits ``[i*b, (i+1)*b)`` and byte j holds stream bits
``[8j, 8j+8)`` with stream bit 8j at the byte's bit 7.  For b = 4 this is
the familiar two-codes-per-byte nibble layout; for b = 5/6 codes straddle
byte boundaries.  A row of N codes packs to exactly ``N*b/8`` bytes, so
the port's packed bytes equal the JAX package's bit for bit.

``pack_codes`` / ``unpack_codes`` are plain tensor ops (broadcast shifts,
masks and reshapes) on any device.  The CUDA kernels unpack and re-pack
the same bitstream in shared memory (``kernels/csrc/common.cuh``:
``unpack_code``, ``pack_byte``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.errors import FormatError

SUPPORTED_BITS = (4, 5, 6, 8)


def packed_width(n_codes: int, bits: int) -> int:
    """Bytes per row of ``n_codes`` b-bit codes (exact, no slack)."""
    if bits not in SUPPORTED_BITS:
        raise FormatError(f"bits={bits} unsupported; choose from "
                          f"{SUPPORTED_BITS}")
    if (n_codes * bits) % 8 != 0:
        raise FormatError(f"{n_codes} codes of {bits} bits do not fill "
                          f"whole bytes")
    return (n_codes * bits) // 8


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., N) integer codes in [0, 2^bits) -> (..., N*bits/8) uint8."""
    if bits == 8:
        return codes.to(torch.uint8)
    *lead, n = codes.shape
    w = packed_width(n, bits)
    c = codes.to(torch.int32)
    # codes -> per-code bit planes, MSB first: (..., N, bits)
    tsel = torch.arange(bits - 1, -1, -1, dtype=torch.int32,
                        device=codes.device)
    stream = (c[..., None] >> tsel) & 1
    # bitstream -> bytes, MSB first: (..., W, 8) -> (..., W)
    stream = stream.reshape(*lead, w, 8)
    ksel = torch.arange(7, -1, -1, dtype=torch.int32, device=codes.device)
    return (stream << ksel).sum(dim=-1).to(torch.uint8)


def unpack_codes(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., W) uint8 words -> (..., W*8/bits) int32 codes in [0, 2^bits)."""
    if bits == 8:
        return packed.to(torch.int32)
    if bits not in SUPPORTED_BITS:
        raise FormatError(f"bits={bits} unsupported; choose from "
                          f"{SUPPORTED_BITS}")
    *lead, w = packed.shape
    n = (w * 8) // bits
    b = packed.to(torch.int32)
    ksel = torch.arange(7, -1, -1, dtype=torch.int32, device=packed.device)
    stream = ((b[..., None] >> ksel) & 1).reshape(*lead, n, bits)
    tsel = torch.arange(bits - 1, -1, -1, dtype=torch.int32,
                        device=packed.device)
    return (stream << tsel).sum(dim=-1, dtype=torch.int32)


@dataclasses.dataclass
class PackedCodes:
    """Bit-packed codes for one state tensor in the flat block domain.

    packed : (n_blocks, n_codes*bits/8) uint8 — the one tensor, updated in
             place by the fused-update kernel and checkpointed with a
             ``"packed": {"bits", "n_codes"}`` annotation.
    bits   : bitwidth of each code (4/5/6; 8-bit states stay plain uint8
             tensors and never enter this container).
    n_codes: logical codes per row (= the quantization block size).
    """

    packed: torch.Tensor
    bits: int
    n_codes: int

    @classmethod
    def from_codes(cls, codes: torch.Tensor, bits: int) -> "PackedCodes":
        return cls(pack_codes(codes, bits), bits, int(codes.shape[-1]))

    def unpack(self) -> torch.Tensor:
        """-> (n_blocks, n_codes) int32 codes."""
        return unpack_codes(self.packed, self.bits)

    @property
    def shape(self) -> tuple:
        """Logical (unpacked) code-array shape."""
        return (*self.packed.shape[:-1], self.n_codes)

    def nbytes(self) -> int:
        return int(self.packed.numel())


def unwrap_codes(codes):
    """One state-slot codes container -> ``(raw, bits, n_codes)``.

    ``raw`` is the stored uint8 tensor, ``bits`` the code bitwidth (8 for
    plain tensors), ``n_codes`` the logical per-row code count for packed
    containers and None for plain tensors (the re-wrap sentinel)."""
    if isinstance(codes, PackedCodes):
        return codes.packed, codes.bits, codes.n_codes
    return codes, 8, None
