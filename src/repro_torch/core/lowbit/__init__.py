"""k-bit code formats for bit-packed optimizer states (mirrors
``repro.core.lowbit``): a state slot stores 2^b-level codes, b in
{4, 5, 6, 8}; sub-byte codes are bit-packed into uint8 words
(:class:`PackedCodes`), which the fused-update kernel unpacks and re-packs
on chip."""
from repro_torch.core.lowbit.format import CodeFormat
from repro_torch.core.lowbit.packing import (SUPPORTED_BITS, PackedCodes,
                                             pack_codes, packed_width,
                                             unpack_codes, unwrap_codes)

__all__ = [
    "CodeFormat", "PackedCodes", "SUPPORTED_BITS", "pack_codes",
    "packed_width", "unpack_codes", "unwrap_codes",
]
