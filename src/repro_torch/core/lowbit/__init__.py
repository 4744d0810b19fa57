"""k-bit code formats (mirrors ``repro.core.lowbit``; 8-bit slots only until
ROADMAP A8 ports the bit packing)."""
from repro_torch.core.lowbit.format import SUPPORTED_BITS, CodeFormat

__all__ = ["CodeFormat", "SUPPORTED_BITS"]
