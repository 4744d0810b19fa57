"""Per-state-slot code format: bitwidth + signedness + codebook family
(mirrors ``repro.core.lowbit.format``).

The port serves the paper's 8-bit slots.  Sub-byte widths (4/5/6-bit,
bit-packed) are ROADMAP item A8 and raise :class:`FormatError` here until
the packing module and the packed fused-update kernel are ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import qmap as qmap_lib
from repro_torch.errors import FormatError

SUPPORTED_BITS = (4, 5, 6, 8)
PORTED_BITS = (8,)


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
        if self.bits not in PORTED_BITS:
            raise FormatError(f"bits={self.bits}: packed sub-byte states are "
                              f"not ported yet (ROADMAP A8); the port stores "
                              f"{PORTED_BITS}-bit codes")

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

    def init_codes(self, n_blocks: int, block_size: int,
                   device) -> torch.Tensor:
        """Zero-state codes: a (n_blocks, block_size) uint8 tensor."""
        return torch.full((n_blocks, block_size), self.zero_code(),
                          dtype=torch.uint8, device=device)

    def bytes_per_param(self, block_size: int) -> float:
        """Analytic storage cost: codes + amortized f32 absmax."""
        return self.bits / 8.0 + 4.0 / block_size
