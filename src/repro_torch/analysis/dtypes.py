"""The one dtype-size table of the port (mirrors ``repro.analysis.dtypes``).

Keys are the dtype names of the JAX package's HLO shape strings
(``f32``, ``bf16``, ``u8``, ...), so a byte count here and one there are
counted from the same table.  :data:`TORCH_NAMES` maps each ``torch.dtype``
that has such a name, by its ``str`` ("torch.float32"), to it; the module
never imports torch (production modules import the analysis package at
module level).  :func:`nbytes` is the bytes of a tensor's elements (its
``numel`` times its dtype's size), the one count the roofline's
``DeviceCounter`` and the dry run use.

Sub-byte types (s4/u4) round up to one byte, as XLA stores them.  Packed
sub-byte optimizer states do not go through this table: they are uint8
words (``core.lowbit.packing.packed_width``).
"""
from __future__ import annotations

DTYPE_BYTES: dict[str, int] = {
    "pred": 1,
    "s4": 1, "u4": 1,
    "s8": 1, "u8": 1,
    "s16": 2, "u16": 2,
    "s32": 4, "u32": 4,
    "s64": 8, "u64": 8,
    "f16": 2, "bf16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3b11fnuz": 1, "f8e5m2fnuz": 1,
    "f8e4m3fnuz": 1,
}

# str(torch.dtype) -> its name in DTYPE_BYTES
TORCH_NAMES: dict[str, str] = {
    "torch.bool": "pred",
    "torch.int8": "s8", "torch.uint8": "u8",
    "torch.int16": "s16", "torch.uint16": "u16",
    "torch.int32": "s32", "torch.uint32": "u32",
    "torch.int64": "s64", "torch.uint64": "u64",
    "torch.float16": "f16", "torch.bfloat16": "bf16",
    "torch.float32": "f32", "torch.float64": "f64",
    "torch.complex64": "c64", "torch.complex128": "c128",
    "torch.float8_e4m3fn": "f8e4m3fn", "torch.float8_e5m2": "f8e5m2",
    "torch.float8_e4m3fnuz": "f8e4m3fnuz",
    "torch.float8_e5m2fnuz": "f8e5m2fnuz",
}


def dtype_bytes(name: str) -> int:
    """Bytes per element of dtype ``name`` (a key of :data:`DTYPE_BYTES`);
    raises KeyError with the known names listed."""
    try:
        return DTYPE_BYTES[name]
    except KeyError:
        raise KeyError(f"unknown dtype {name!r}; known: "
                       f"{sorted(DTYPE_BYTES)}") from None


def dtype_name(dtype) -> str:
    """The table's name of a ``torch.dtype`` (KeyError for one it lacks)."""
    try:
        return TORCH_NAMES[str(dtype)]
    except KeyError:
        raise KeyError(f"no dtype name for {dtype}; known: "
                       f"{sorted(TORCH_NAMES)}") from None


def nbytes(t) -> int:
    """Bytes of a tensor's elements: ``numel`` times its dtype's size."""
    return t.numel() * dtype_bytes(dtype_name(t.dtype))
