"""Contract checker: declarative invariants over a recorded trace of one
call (mirrors ``repro.analysis.contracts``).

The port's speed and exactness rest on properties of the step as it runs,
not of any one result: the step updates the masters, codes and absmax in
place; no float64 enters it; the optimizer math accumulates in f32; under
ZeRO-2 the gradients are reduce-scattered before the update and the
masters all-gathered after it; lamb/lars trust ratios are finalized from
per-block partials gathered whole; host-side knobs (``telemetry_every``,
``sentinel=False``) change nothing.  The JAX package checks these on the
lowered StableHLO text.  PyTorch runs eagerly and has no lowering, so the
port's subject is a **recorded trace of one call** (:class:`Trace`): its
events in order — each aten op with the dtypes of its tensor inputs and
outputs and the storages it wrote, each kernel launch, each collective,
each named marker — and the storages its named state tensors had before
and after the call.  ``analysis.runner`` records it (a
``TorchDispatchMode``; the CUDA kernels, called through ``ctypes``, from
the kernel layer's launch counters).

Contracts are **registered next to the code they protect**
(kernels/ops.py, train/loop.py, sharding/rules.py, serve/kvcache.py call
:func:`register` at import) and evaluated over a config matrix by
``python -m repro_torch.analysis``.  Scopes bind a contract to its
subject:

  * ``"step"``    — one train step of every cell of the matrix;
  * ``"update"``  — one bare fused update per (algo, bits);
  * ``"serve"``   — one paged decode step per kv width;
  * ``"pair:telemetry"`` / ``"pair:overlap"`` / ``"pair:partition"`` /
    ``"pair:sentinel"`` — two or three steps differing in one knob.

Checks take ``(trace, cell)`` — or ``(dict_of_traces, cell)`` for pair
scopes — and return ``(ok, detail)`` or None ("not applicable").

Two hooks let production code speak to a recorder without importing it:
:func:`exempt` names a narrow scope in which a dtype is allowed (the two
float64 expressions that round an f32 result exactly, ``fused_update.
sqrt_rn`` and the MoE drop fraction), and :func:`mark` records a named
marker (``rules.replicate_for_scales``'s gather of the partials).  Both
cost a list append when nothing records.

This module is stdlib-only on purpose: production modules import it at
module level, so it must never pull in torch or the subsystems it audits.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional


class AnalysisError(Exception):
    """A static-analysis contract or budget violation."""


@dataclasses.dataclass(frozen=True)
class Event:
    """One recorded event.  ``kind``: "op" (an aten op, ``name`` e.g.
    "aten.mm.default"), "kernel" (a CUDA kernel launch, by its counter's
    name), "collective" ("all_reduce", "all_gather", "reduce_scatter",
    "broadcast", "gather", ...) or "marker" (:func:`mark`, or a fused-update
    dispatch).  ``ins`` / ``outs``: dtype names (``dtypes.DTYPE_BYTES``) of
    the tensor inputs and outputs; ``writes``: storage addresses written in
    place; ``exempt``: the dtype names the :func:`exempt` scopes active at
    the event allow; ``attrs``: a marker's (key, value) pairs."""
    kind: str
    name: str
    ins: tuple = ()
    outs: tuple = ()
    writes: tuple = ()
    exempt: tuple = ()
    attrs: tuple = ()

    def signature(self) -> tuple:
        """What two runs of one computation share: kind, name, dtypes."""
        return (self.kind, self.name, self.ins, self.outs, self.attrs)

    def __str__(self):
        io = f"({','.join(self.ins)})->({','.join(self.outs)})" \
            if self.kind == "op" else ""
        return f"{self.kind}:{self.name}{io}"


@dataclasses.dataclass(frozen=True)
class Trace:
    """One recorded call: its name, its events in order, and per named
    state (e.g. "opt_state", "caches") ``{path: (storage address, dtype
    name, bytes)}`` of its tensors before and after the call."""
    name: str
    events: tuple
    before: dict = dataclasses.field(default_factory=dict)
    after: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class ContractResult:
    contract: str
    target: str
    ok: bool
    detail: str = ""

    def __str__(self):
        mark_ = "PASS" if self.ok else "FAIL"
        d = f" — {self.detail}" if self.detail else ""
        return f"[{mark_}] {self.contract} @ {self.target}{d}"


# ------------------------------------------------ hooks for the recorder
_EXEMPT: list = []          # stack of (dtype name, scope name)
_LISTENERS: list = []       # callables (name, attrs dict) of mark()


@contextlib.contextmanager
def exempt(dtype: str, scope: str):
    """Allow ``dtype`` (e.g. "f64") inside this block, named ``scope``:
    the recorder tags every event in it, and ``check_no_dtype`` passes the
    tagged ones.  A tensor of that dtype that leaves the block still
    fails at the first op that reads it outside."""
    _EXEMPT.append((dtype, scope))
    try:
        yield
    finally:
        _EXEMPT.pop()


def exemptions() -> tuple:
    """The (dtype, scope) pairs active now, innermost last."""
    return tuple(_EXEMPT)


def mark(name: str, **attrs) -> None:
    """Record a named marker with ``attrs`` in every active recording."""
    for fn in tuple(_LISTENERS):
        fn(name, attrs)


@contextlib.contextmanager
def listening(fn: Callable):
    """Call ``fn(name, attrs)`` for every :func:`mark` inside the block."""
    _LISTENERS.append(fn)
    try:
        yield
    finally:
        _LISTENERS.remove(fn)


# ------------------------------------------------------------- the checks
def _moved(trace: Trace, state: str) -> list:
    b, a = trace.before.get(state, {}), trace.after.get(state, {})
    return sorted(p for p in set(b) | set(a)
                  if p not in a or p not in b or a[p][0] != b[p][0])


def written_pieces(trace: Trace, state: str) -> list:
    """Paths of ``state`` whose storage some event of the call wrote."""
    wrote = {w for e in trace.events for w in e.writes}
    return sorted(p for p, (ptr, _, _) in trace.before.get(state, {}).items()
                  if ptr in wrote)


def check_donates(trace: Trace, state: str, min_written: int = 1) -> tuple:
    """``donates(state)``: every tensor of the named state keeps its
    storage through the call (``untyped_storage().data_ptr()``), and at
    least ``min_written`` of them were written in place — a step that
    reallocated its state would hold two copies of every arena."""
    if not trace.before.get(state):
        return False, f"no tensors of {state!r} recorded"
    moved = _moved(trace, state)
    n_w = len(written_pieces(trace, state))
    ok = not moved and n_w >= min_written
    detail = (f"{len(trace.before[state])} piece(s) of {state} kept in "
              f"place, {n_w} written (need >= {min_written})")
    if moved:
        detail += f"; {len(moved)} moved, e.g. {moved[0]}"
    return ok, detail


def find_dtype(trace: Trace, dtype: str) -> list:
    """Events with a ``dtype`` input or output outside an exempt scope."""
    return [e for e in trace.events
            if (dtype in e.ins or dtype in e.outs) and dtype not in e.exempt]


def check_no_dtype(trace: Trace, dtype: str = "f64") -> tuple:
    """``no_dtype(f64)``: no event of the call reads or makes a ``dtype``
    tensor outside a named :func:`exempt` scope — one stray promotion
    breaks the master-dtype policy and runs at a fraction of the card's
    f32 rate."""
    hits = find_dtype(trace, dtype)
    n_ex = sum(1 for e in trace.events
               if (dtype in e.ins or dtype in e.outs) and dtype in e.exempt)
    if not hits:
        return True, (f"no {dtype} outside exempt scopes "
                      f"({n_ex} exempt event(s))")
    return False, f"{len(hits)} {dtype} event(s), e.g. {hits[0]}"


# aten ops that accumulate: the products and the sum/norm reductions
ACCUMULATING = frozenset({
    "mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "dot", "mv",
    "addmv", "sum", "nansum", "norm", "linalg_vector_norm"})
INTEGER_DTYPES = ("pred", "s8", "u8", "s16", "u16", "s32", "u32", "s64",
                  "u64")


def op_base(name: str) -> str:
    """'mm' of 'aten.mm.default'."""
    parts = name.split(".")
    return parts[1] if len(parts) > 1 else name


def accumulation_sites(trace: Trace) -> list:
    """(op, output dtype, event) for every accumulating op of the call."""
    return [(op_base(e.name), d, e) for e in trace.events
            if e.kind == "op" and op_base(e.name) in ACCUMULATING
            for d in e.outs]


def check_accumulates_in(trace: Trace, dtype: str = "f32",
                         allow: tuple = INTEGER_DTYPES) -> tuple:
    """``accumulates_in(f32)``: every product and sum/norm reduction of
    the call lands in ``dtype`` (integer reductions are exempt) — a bf16
    or f16 accumulation in the update or the Newton–Schulz chain would
    pass every shape check and widen the quantization error band."""
    sites = accumulation_sites(trace)
    bad = [(op, d, e) for op, d, e in sites if d != dtype and d not in allow]
    if not bad:
        return True, (f"{len(sites)} accumulation site(s), all "
                      f"{dtype}/integer")
    return False, (f"{len(bad)} site(s) accumulate outside {dtype}, e.g. "
                   f"{bad[0][1]} in {bad[0][2]}")


REPLICATION_MARK = "replicated_scales"


def replicated_pins(trace: Trace, name: str = REPLICATION_MARK) -> int:
    """Markers ``name`` whose gathered rows cover the whole arena — what
    ``rules.replicate_for_scales`` records after gathering the per-block
    partials of every span (the port's counterpart of the JAX package's
    replicated sharding pins)."""
    return sum(1 for e in trace.events
               if e.kind == "marker" and e.name == name
               and dict(e.attrs).get("rows") == dict(e.attrs).get("total"))


def check_replicated(trace: Trace, min_pins: int = 1) -> tuple:
    """``replicated(trust ratios)``: a partitioned lamb/lars step must
    finalize its trust ratios from the partials of every span gathered
    whole — finalized from one span's rows, the ranks would scale each
    tensor by a different ratio, and the partitioned step would no longer
    equal the unpartitioned one bit for bit."""
    n = replicated_pins(trace)
    return n >= min_pins, f"{n} whole-arena gather(s), need >= {min_pins}"


def marker_positions(trace: Trace, markers) -> list:
    """Index of the first event named each marker (-1 = absent)."""
    out = []
    for m in markers:
        out.append(next((i for i, e in enumerate(trace.events)
                         if e.name == m and e.kind != "op"), -1))
    return out


def check_collective_order(trace: Trace, *markers,
                           require_all: bool = True) -> tuple:
    """``collective_order(a -> b -> ...)``: the named collectives, kernels
    or markers occur in the given order — the first ``b`` after the first
    ``a``, the first ``c`` after that ``b``, ...: the ZeRO-2 step's
    reduce-scatter of the gradients, then the span's update, then the
    all-gather of the masters.  (A trace holds every collective: the
    ZeRO-2 step also all-gathers the gradient buffer transiently for the
    global norm, before the update, which the first occurrences alone
    would take for the masters'.)"""
    pos = marker_positions(trace, markers)
    missing = [m for m, p in zip(markers, pos) if p < 0]
    if missing:
        return (not require_all), f"marker(s) absent: {missing}"
    at, chain = -1, []
    for m in markers:
        at = next((i for i, e in enumerate(trace.events)
                   if i > at and e.name == m and e.kind != "op"), -1)
        if at < 0:
            return False, (f"order VIOLATED: no {m} after "
                           f"{' -> '.join(chain)}")
        chain.append(f"{m}@{at}")
    return True, f"order holds: {' -> '.join(chain)}"


def inplace_set(trace: Trace, state: str) -> Optional[dict]:
    """Bytes per dtype of ``state`` kept in place through the call, or
    None if any piece moved."""
    if _moved(trace, state):
        return None
    out: dict = {}
    for _, dt, n in trace.before.get(state, {}).values():
        out[dt] = out.get(dt, 0) + n
    return out


def lowering_invariant(traces: dict, *, compare_aliases_only: bool = False,
                       state: str = "opt_state") -> tuple:
    """``invariant_to(knob)``: ``traces`` maps knob values to traces of the
    same call.  With ``compare_aliases_only=False`` every trace must hold
    the identical op sequence (kind, name and dtypes of every event: the
    knob is host-schedule only); with True only the in-place sets must be
    equal and non-empty (the knob may restructure the call — e.g.
    ``overlap_buckets`` changes the launches — but must never cost an
    in-place arena)."""
    items = sorted(traces.items(), key=lambda kv: str(kv[0]))
    if len(items) < 2:
        raise AnalysisError("lowering_invariant needs >= 2 traces")
    if compare_aliases_only:
        sets = {k: inplace_set(t, state) for k, t in items}
        vals = list(sets.values())
        ok = all(v is not None and v == vals[0] and sum(v.values()) > 0
                 for v in vals)
        return ok, f"in-place bytes of {state} per knob value: {sets}"
    base_k, base_t = items[0]
    a = [e.signature() for e in base_t.events]
    for k, t in items[1:]:
        b = [e.signature() for e in t.events]
        if a != b:
            for i, (ea, eb) in enumerate(zip(a, b)):
                if ea != eb:
                    return False, (f"knob {base_k!r} vs {k!r}: op sequences "
                                   f"diverge at event {i}: "
                                   f"{base_t.events[i]} != {t.events[i]}")
            return False, (f"knob {base_k!r} vs {k!r}: {len(a)} vs {len(b)} "
                           f"events")
    return True, f"{len(items)} traces with identical op sequences " \
                 f"({len(a)} events)"


# --------------------------------------------------------------- registry
@dataclasses.dataclass(frozen=True)
class ContractSpec:
    """One registered contract: a named check bound to a scope.  ``check``
    takes ``(trace_or_pair, cell)`` and returns ``(ok, detail)`` or
    ``None`` (not applicable to this cell)."""
    name: str
    scope: str
    check: Callable[[Any, Any], Optional[tuple]]
    doc: str = ""


_REGISTRY: dict = {}


def register(name: str, scope: str, check: Callable, doc: str = "") -> None:
    """Register (or re-register — module reloads are idempotent) a
    contract.  Call this next to the code the contract protects."""
    _REGISTRY[name] = ContractSpec(name=name, scope=scope, check=check,
                                   doc=doc)


def contracts_for(scope: str) -> list:
    """Registered contracts bound to ``scope``, name-ordered."""
    return [s for _, s in sorted(_REGISTRY.items()) if s.scope == scope]


def all_contracts() -> list:
    return [s for _, s in sorted(_REGISTRY.items())]


def evaluate(spec: ContractSpec, subject, cell) -> Optional[ContractResult]:
    """Run one contract; ``None`` means not applicable."""
    out = spec.check(subject, cell)
    if out is None:
        return None
    ok, detail = out
    target = getattr(cell, "name", None) or getattr(subject, "name", "?")
    return ContractResult(contract=spec.name, target=str(target),
                          ok=bool(ok), detail=detail)
