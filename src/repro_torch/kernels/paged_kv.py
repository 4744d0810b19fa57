"""Paged block-wise quantized KV cache: append and gather-dequant (mirrors
``repro.kernels.paged_kv``).

The serving KV cache stores keys and values in a fixed pool of *pages*.
One page holds ``page_size`` token positions for every kv head of one
layer; each (position, head) row of ``Dh`` values is one quantization
block in the paper's scheme: normalized by its own absmax, nearest-code
encoded against the 2^bits signed dynamic codebook (``core/qmap.py``), and
at 4 bits packed two codes to a byte (``core/lowbit/packing.py``).

Storage per layer (``W = Dh * bits / 8`` bytes per row):

    codes : (n_pages, page_size, KV, W)  uint8
    absmax: (n_pages, page_size, KV)     f32

  * ``append_rows`` quantizes one new (B, KV, Dh) row batch and writes it
    in place to per-slot (page, offset) destinations.  Page ids outside
    ``[0, n_pages)`` (inactive slots) are dropped, never clamped.
  * ``gather_pages`` gathers and decodes every slot's pages to (B, L, KV,
    Dh) values.  ``impl="cuda"`` is the CUDA kernel
    ``csrc/paged_gather.cu`` (on CPU tensors its plain version
    :func:`_gather_torch`); ``impl="torch"`` is the plain version.

The row quantize and the append are XLA code in the JAX package, not
Pallas; plain tensor ops are their counterpart here.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import qmap as qmap_lib
from repro_torch.core.lowbit.packing import pack_codes, unpack_codes
from repro_torch.errors import FormatError
from repro_torch.kernels import build

KV_QMAP_NAME = "dynamic"
KV_BITS = (4, 8)
IMPLS = ("torch", "cuda")
OUT_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _kv_qmap(bits: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(qmap_lib.get_qmap(KV_QMAP_NAME, True, bits=bits),
                           device=device)


def kv_qmap(bits: int = 8, device="cpu") -> torch.Tensor:
    """The signed dynamic codebook used for every KV row (2^bits levels),
    one cached tensor per device (no host-to-device copy per call)."""
    return _kv_qmap(bits, torch.device(device))


def packed_row_width(head_dim: int, bits: int) -> int:
    """Stored bytes per (position, head) row of ``head_dim`` values."""
    if bits not in KV_BITS:
        raise FormatError(f"kv bits={bits} unsupported; choose from "
                          f"{KV_BITS}")
    if (head_dim * bits) % 8 != 0:
        raise FormatError(f"head_dim={head_dim} at {bits}-bit KV does not "
                          f"fill whole bytes")
    return (head_dim * bits) // 8


def bits_of(head_dim: int, row_width: int) -> int:
    """The code bitwidth from array shapes (8 * W / Dh): the paged cache
    carries no dtype tag, the packing ratio is the format."""
    bits = (row_width * 8) // head_dim
    if bits not in KV_BITS or packed_row_width(head_dim, bits) != row_width:
        raise FormatError(f"row width {row_width} is not a supported "
                          f"packing of head_dim {head_dim}")
    return bits


# ------------------------------------------------------------ row quantize

def quantize_rows(x: torch.Tensor, bits: int = 8
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (..., Dh) -> (codes uint8 (..., W), absmax f32 (...,)).

    Absmax per row, scale 1 for an all-zero row, ``x / scale`` (a true
    division), nearest code by ``searchsorted(right=True)`` over the
    midpoints — the JAX package's arithmetic, so the codes agree bit for
    bit."""
    cb = kv_qmap(bits, x.device)
    x = x.to(torch.float32)
    absmax = x.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax, torch.ones_like(absmax))
    bounds = (cb[1:] + cb[:-1]) * 0.5
    codes = torch.searchsorted(bounds, (x / scale[..., None]).contiguous(),
                               right=True)
    if bits == 8:
        return codes.to(torch.uint8), absmax
    return pack_codes(codes, bits), absmax


def dequantize_rows(codes: torch.Tensor, absmax: torch.Tensor, dtype,
                    bits: int = 8) -> torch.Tensor:
    """(codes (..., W), absmax (...,)) -> values (..., Dh) in ``dtype``."""
    cb = kv_qmap(bits, codes.device)
    idx = unpack_codes(codes, bits).long() if bits != 8 else codes.long()
    return (cb[idx] * absmax[..., None]).to(dtype)


# ----------------------------------------------------------------- append

def append_rows(pages_codes: torch.Tensor, pages_absmax: torch.Tensor,
                rows: torch.Tensor, page_ids: torch.Tensor,
                offsets: torch.Tensor, bits: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize-on-append one token row per slot, in place.

    pages_codes : (n_pages, page_size, KV, W) uint8
    pages_absmax: (n_pages, page_size, KV) f32
    rows        : (B, KV, Dh) new k or v rows (post-rope)
    page_ids    : (B,) integer physical destination page per slot; any id
                  outside [0, n_pages), negative ones too, is DROPPED
    offsets     : (B,) integer position within the page

    A dropped lane is pointed at the destination and row of the first kept
    lane, so the one ``index_put_`` writes every kept row and rewrites that
    one with its own value: no index leaves the pool (no CUDA index
    assert), no live row is overwritten, and no boolean mask forces a
    device-to-host sync.  With no kept lane, every lane rewrites row
    (0, 0) with the value it holds.  Returns the two (updated) pools.
    """
    n_pages = pages_codes.shape[0]
    codes, absmax = quantize_rows(rows, bits)
    page_ids, offsets = page_ids.long(), offsets.long()
    keep = (page_ids >= 0) & (page_ids < n_pages)
    lane = torch.arange(keep.shape[0], device=keep.device)
    src = torch.where(keep, lane, keep.int().argmax())   # first kept lane
    any_kept = keep.any()
    dst_page = torch.where(any_kept, page_ids[src], 0)
    dst_off = torch.where(any_kept, offsets[src], 0)
    for pool, new in ((pages_codes, codes), (pages_absmax, absmax)):
        vals = torch.where(any_kept, new[src],
                           pool[0, 0][None].expand_as(new))
        pool.index_put_((dst_page, dst_off), vals)
    return pages_codes, pages_absmax


# ----------------------------------------------------------- gather-dequant

def _gather_torch(pages_codes, pages_absmax, page_table, *, bits, dtype):
    """Plain version of the kernel (any device): clip the table to
    [0, n_pages), gather, dequantize."""
    n_pages, page, KV, W = pages_codes.shape
    B, P = page_table.shape
    table = page_table.long().clamp(0, n_pages - 1)
    vals = dequantize_rows(pages_codes[table], pages_absmax[table], dtype,
                           bits)                       # (B, P, page, KV, Dh)
    return vals.reshape(B, P * page, KV, (W * 8) // bits)


def _check(pages_codes, pages_absmax, page_table, bits, dtype) -> None:
    if pages_codes.dim() != 4:
        raise FormatError(f"pages_codes must be (n_pages, page, KV, W), got "
                          f"{tuple(pages_codes.shape)}")
    if bits not in KV_BITS:
        raise FormatError(f"kv bits={bits} unsupported; choose from "
                          f"{KV_BITS}")
    if dtype not in OUT_DTYPES:
        raise TypeError(f"dtype {dtype}: one of {OUT_DTYPES}")
    if page_table.dim() != 2:
        raise FormatError(f"page_table must be (B, P), got "
                          f"{tuple(page_table.shape)}")
    dev = pages_codes.device
    build.require(pages_codes, "pages_codes", torch.uint8)
    build.require(pages_absmax, "pages_absmax", torch.float32,
                  pages_codes.shape[:3], dev)
    build.require(page_table, "page_table", torch.int32, device=dev)


def gather_cuda(pages_codes: torch.Tensor, pages_absmax: torch.Tensor,
                page_table: torch.Tensor, *, bits: int,
                dtype=torch.float32) -> torch.Tensor:
    """The CUDA kernel ``csrc/paged_gather.cu`` on CUDA tensors; its plain
    version :func:`_gather_torch` on CPU tensors.  ``page_table`` is
    int32."""
    _check(pages_codes, pages_absmax, page_table, bits, dtype)
    if pages_codes.device.type == "cpu":
        return _gather_torch(pages_codes, pages_absmax, page_table,
                             bits=bits, dtype=dtype)
    if pages_codes.device.type != "cuda":
        raise ValueError(f"no paged gather kernel for device "
                         f"{pages_codes.device}")
    n_pages, page, KV, W = pages_codes.shape
    B, P = page_table.shape
    Dh = (W * 8) // bits
    out = torch.empty((B, P * page, KV, Dh), dtype=dtype,
                      device=pages_codes.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(pages_codes.device):
        rc = lib.paged_gather(
            build.ptr(pages_codes), build.ptr(pages_absmax),
            build.ptr(page_table),
            build.ptr(kv_qmap(bits, pages_codes.device)), build.ptr(out),
            int(dtype == torch.bfloat16), n_pages, page * KV, W, bits, B, P,
            build.stream(pages_codes.device))
    build.check(lib, rc, "paged_gather")
    gather_cuda.launches += 1
    return out


gather_cuda.launches = 0


def gather_pages(pages_codes: torch.Tensor, pages_absmax: torch.Tensor,
                 page_table: torch.Tensor, *, bits: int, dtype=torch.float32,
                 impl: str = "cuda") -> torch.Tensor:
    """Gather + dequantize every slot's pages.

    page_table: (B, P) int32 physical page per logical page (-1 =
    unallocated: read as page 0, masked downstream).  Returns
    (B, P * page_size, KV, Dh) values in ``dtype``."""
    if impl == "torch":
        return _gather_torch(pages_codes, pages_absmax, page_table,
                             bits=bits, dtype=dtype)
    if impl == "cuda":
        return gather_cuda(pages_codes, pages_absmax, page_table, bits=bits,
                           dtype=dtype)
    raise FormatError(f"unknown impl {impl!r}; have {'|'.join(IMPLS)}")


_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry -> argtypes
ARGTYPES = {
    # codes, absmax, table, qmap, out, out_bf16, n_pages, rows, row_width,
    # bits, n_slots, pages_per_seq, stream
    "paged_gather": [_P] * 5 + [_I] * 7 + [_P],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("paged_gather")
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib
