"""Per-state-slot code format: bitwidth + signedness + codebook family
(mirrors ``repro.core.lowbit.format``).

One :class:`CodeFormat` describes how a single optimizer state slot (first
moment, second moment, ...) is stored: a 2^bits-entry codebook from
``repro_torch.core.qmap`` and, for sub-byte widths, bit-packed storage via
:class:`~repro_torch.core.lowbit.packing.PackedCodes`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import qmap as qmap_lib
from repro_torch.core.lowbit.packing import SUPPORTED_BITS, PackedCodes
from repro_torch.errors import FormatError


@dataclasses.dataclass(frozen=True)
class CodeFormat:
    """Static description of one quantized state slot's storage format."""

    bits: int = 8
    signed: bool = True
    qmap_name: str = "dynamic"

    def __post_init__(self):
        if self.bits not in SUPPORTED_BITS:
            raise FormatError(f"bits={self.bits} unsupported; choose from "
                              f"{SUPPORTED_BITS}")

    @property
    def n_levels(self) -> int:
        return 1 << self.bits

    @property
    def max_code(self) -> int:
        return self.n_levels - 1

    def codebook(self) -> np.ndarray:
        """The sorted 2^bits-entry codebook for this slot."""
        return qmap_lib.get_qmap(self.qmap_name, self.signed, bits=self.bits)

    def zero_code(self) -> int:
        """Code index whose level is (closest to) 0.0 — the init fill."""
        return int(np.argmin(np.abs(self.codebook())))

    def init_codes(self, n_blocks: int, block_size: int, device):
        """Zero-state codes: PackedCodes below 8 bits, else a plain
        (n_blocks, block_size) uint8 tensor."""
        zc = self.zero_code()
        if self.bits == 8:
            return torch.full((n_blocks, block_size), zc, dtype=torch.uint8,
                              device=device)
        row = PackedCodes.from_codes(
            torch.full((1, block_size), zc, dtype=torch.int32), self.bits)
        return PackedCodes(row.packed.to(device).repeat(n_blocks, 1),
                           self.bits, block_size)

    def bytes_per_param(self, block_size: int) -> float:
        """Analytic storage cost: packed codes + amortized f32 absmax."""
        return self.bits / 8.0 + 4.0 / block_size
