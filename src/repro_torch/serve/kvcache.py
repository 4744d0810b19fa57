"""Paged quantized KV-cache management for serving (mirrors
``repro.serve.kvcache``).

Host-side bookkeeping over the device page pool that
``models.model.init_paged_cache`` builds:

  * :class:`PageAllocator` — the free list.  Strict: allocating from an
    empty pool returns None (the scheduler's eviction trigger), freeing a
    free page or a foreign id raises ``ConfigError``.  Invariants: no
    double-free, no orphaned page, ``n_free + n_allocated == n_pages``.
  * :class:`PagedKVCache` — slots, page tables and the allocator.  One
    *slot* is one row of the fixed decode batch; a request owns a slot and
    an ordered list of physical pages (its page-table row).
    ``admit``/``extend``/``advance``/``release`` keep the host mirror
    (numpy ``page_table`` and ``positions``) consistent.  They write those
    arrays in place, so a caller that hands them to the device uploads
    copies (``serve/scheduler.py``).

The decode step's contracts are registered here, as in the JAX package
(``analysis/runner.py`` traces ``models.model.paged_decode_step``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.analysis import contracts as _contracts
from repro_torch.errors import ConfigError
from repro_torch.kernels.paged_kv import packed_row_width


@dataclasses.dataclass(frozen=True)
class PagedKVConfig:
    """Static layout of the serving KV pool."""
    page_size: int = 16
    n_pages: int = 64
    n_slots: int = 8
    max_pages_per_seq: int = 16
    kv_bits: int = 8               # 8 | 4 (packed codes)

    def __post_init__(self):
        if self.kv_bits not in (4, 8):
            raise ConfigError(f"kv_bits must be 4 or 8, got {self.kv_bits}")
        for f in ("page_size", "n_pages", "n_slots", "max_pages_per_seq"):
            if getattr(self, f) <= 0:
                raise ConfigError(f"{f} must be positive")

    def pages_needed(self, n_tokens: int) -> int:
        """Pages covering token positions [0, n_tokens)."""
        return -(-n_tokens // self.page_size)

    def max_tokens_per_seq(self) -> int:
        return self.max_pages_per_seq * self.page_size


class PageAllocator:
    """Free-list allocator over ``n_pages`` physical pages."""

    def __init__(self, n_pages: int):
        if n_pages <= 0:
            raise ConfigError(f"n_pages must be positive, got {n_pages}")
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, -1, -1))
        self._allocated: set = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_allocated(self) -> int:
        return len(self._allocated)

    @property
    def occupancy(self) -> float:
        return self.n_allocated / self.n_pages

    def alloc(self, n: int) -> Optional[list]:
        """``n`` pages, or None (all-or-nothing) when the pool is short."""
        if n < 0:
            raise ConfigError(f"cannot allocate {n} pages")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._allocated.update(pages)
        return pages

    def free(self, pages) -> None:
        for p in pages:
            if p not in self._allocated:
                raise ConfigError(
                    f"double-free or foreign page id {p} (allocated: "
                    f"{sorted(self._allocated)})")
            self._allocated.remove(p)
            self._free.append(p)


@dataclasses.dataclass
class SlotState:
    """Host mirror of one occupied decode slot."""
    rid: int                       # request id
    pages: list                    # ordered physical page ids
    position: int                  # next token index to be written
    admit_order: int               # monotonic admit counter (evict = LIFO)


class PagedKVCache:
    """Slots + page tables over one model's paged cache pytree."""

    def __init__(self, kvcfg: PagedKVConfig):
        self.cfg = kvcfg
        self.alloc = PageAllocator(kvcfg.n_pages)
        self.slots: dict = {}      # slot index -> SlotState
        self._by_rid: dict = {}    # rid -> slot index
        self._admits = 0
        self.page_table = np.full((kvcfg.n_slots, kvcfg.max_pages_per_seq),
                                  -1, np.int32)
        self.positions = np.full((kvcfg.n_slots,), -1, np.int32)

    # ------------------------------------------------------------ queries
    @property
    def n_active(self) -> int:
        return len(self.slots)

    def free_slot(self) -> Optional[int]:
        for s in range(self.cfg.n_slots):
            if s not in self.slots:
                return s
        return None

    def slot_of(self, rid: int) -> int:
        return self._by_rid[rid]

    def youngest_rid(self) -> Optional[int]:
        """Most recently admitted request (the eviction victim)."""
        if not self.slots:
            return None
        return max(self.slots.values(), key=lambda st: st.admit_order).rid

    # ------------------------------------------------------- transitions
    def admit(self, rid: int, prompt_len: int) -> Optional[int]:
        """Reserve a slot + pages covering the prompt AND the first
        generated token's append (position ``prompt_len``).  Returns the
        slot index, or None when no slot/pages are available."""
        need = self.cfg.pages_needed(prompt_len + 1)
        if need > self.cfg.max_pages_per_seq:
            raise ConfigError(
                f"request {rid}: prompt of {prompt_len} tokens needs {need} "
                f"pages > max_pages_per_seq={self.cfg.max_pages_per_seq}")
        slot = self.free_slot()
        if slot is None:
            return None
        pages = self.alloc.alloc(need)
        if pages is None:
            return None
        st = SlotState(rid=rid, pages=pages, position=prompt_len,
                       admit_order=self._admits)
        self._admits += 1
        self.slots[slot] = st
        self._by_rid[rid] = slot
        self.page_table[slot, :need] = pages
        self.positions[slot] = prompt_len
        return slot

    def extend(self, rid: int) -> bool:
        """Ensure the slot's CURRENT write position has a page; allocates
        one page at the boundary.  False = pool exhausted (evict and
        retry)."""
        st = self.slots[self._by_rid[rid]]
        need = self.cfg.pages_needed(st.position + 1)
        if need <= len(st.pages):
            return True
        if need > self.cfg.max_pages_per_seq:
            raise ConfigError(
                f"request {rid} at position {st.position} exceeds "
                f"max_pages_per_seq={self.cfg.max_pages_per_seq}")
        new = self.alloc.alloc(need - len(st.pages))
        if new is None:
            return False
        slot = self._by_rid[rid]
        self.page_table[slot, len(st.pages):need] = new
        st.pages.extend(new)
        return True

    def advance(self, rid: int) -> None:
        """The decode step wrote position ``position``; move to the next."""
        slot = self._by_rid[rid]
        self.slots[slot].position += 1
        self.positions[slot] = self.slots[slot].position

    def release(self, rid: int) -> None:
        """Free every page and the slot (completion or eviction)."""
        slot = self._by_rid.pop(rid)
        st = self.slots.pop(slot)
        self.alloc.free(st.pages)
        self.page_table[slot, :] = -1
        self.positions[slot] = -1

    # ---------------------------------------------------------- metrics
    def check_invariants(self) -> None:
        """Raise ConfigError on any bookkeeping drift (test hook)."""
        owned = [p for st in self.slots.values() for p in st.pages]
        if len(owned) != len(set(owned)):
            raise ConfigError("page owned by two slots")
        if set(owned) != self.alloc._allocated:
            raise ConfigError(
                f"orphaned/phantom pages: slots own {sorted(set(owned))}, "
                f"allocator says {sorted(self.alloc._allocated)}")
        if self.alloc.n_free + self.alloc.n_allocated != self.cfg.n_pages:
            raise ConfigError("occupancy bookkeeping drift")
        table_pages = set(self.page_table[self.page_table >= 0].tolist())
        if table_pages != set(owned):
            raise ConfigError("device page table out of sync with slots")


def kv_bytes_per_token(cfg, kv_bits: int) -> float:
    """Stored KV bytes per generated token across all attn layers (codes +
    absmax; the page-table int32s amortize to noise and are excluded).
    ``kv_bits=16`` gives the unquantized fp16 baseline."""
    KV, Dh = cfg.n_kv_heads, cfg.head_dim
    n_attn = sum(1 for i in range(cfg.n_layers)
                 if cfg.block_pattern[i % len(cfg.block_pattern)] == "attn")
    if kv_bits == 16:
        per_row = 2 * Dh
        return float(2 * KV * per_row * n_attn)          # k and v
    per_row = packed_row_width(Dh, kv_bits) + 4          # codes + absmax f32
    return float(2 * KV * per_row * n_attn)


# ------------------------------------------------------------ contracts
# Registered here, next to the serving cache they protect; evaluated on the
# trace of one paged decode step (analysis/runner.py::trace_serve).

_contracts.register(
    "serve_decode.donates_cache", "serve",
    lambda trace, cell: _contracts.check_donates(trace, "caches"),
    doc="the paged decode step appends to its KV pages in place: no "
        "shadow copy of the pool")
_contracts.register(
    "serve_decode.no_f64", "serve",
    lambda trace, cell: _contracts.check_no_dtype(trace, "f64"),
    doc="no f64 anywhere in the paged decode step")
