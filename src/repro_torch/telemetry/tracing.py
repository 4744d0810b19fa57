"""Step-phase tracing and the shared step-timing helper (mirrors
``repro.telemetry.tracing``).

**Phase annotations** — :func:`annotate` wraps each phase of the train step
(``forward_backward``, ``optimizer_update``).  Annotation is OFF by default
and the wrapper is then a literal no-op (``yield`` and nothing else).  When
enabled with :func:`set_phase_tracing`, each ``annotate`` block

  * opens ``torch.profiler.record_function("tel.<phase>")`` (a named range
    on the profiler's timeline) and, when CUDA is present,
    ``torch.cuda.nvtx.range("tel.<phase>")``, and
  * records a *trace event* ``(phase, fused dispatches inside, wall
    seconds)``, the dispatches counted by ``ops.fused_update_count``.

The JAX package records these events while it traces the step, once per
compiled step.  PyTorch runs eagerly and has no trace: the events are
recorded on every annotated step, and the train launcher emits those of
its first executed step as the run's one "trace" event (and drops the
rest), which is where JAX traces.

**Host wall-clock** — :class:`StepTimer` is the single definition of
``ms/step`` and ``compile_s``: the first executed step (which in the port
builds the CUDA kernels and warms PyTorch's caches) is reported apart as
``compile_s``, later steps make up ``ms/step``, and a trailing-window
z-score flags stragglers.  :func:`host_phase` times host-side phases
(probe runs, snapshots) into "phase" events for the JSONL timeline.
"""
from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import numpy as np

_PHASE_TRACING = [False]
_TRACE_EVENTS: List[dict] = []
_PHASE_EVENTS: List[dict] = []


def set_phase_tracing(enabled: bool) -> None:
    """Turn phase annotation on/off (process-wide, default off)."""
    _PHASE_TRACING[0] = bool(enabled)


def phase_tracing_enabled() -> bool:
    return _PHASE_TRACING[0]


@contextlib.contextmanager
def phase_tracing(enabled: bool = True):
    """Scoped :func:`set_phase_tracing` (restores the prior flag)."""
    prev = _PHASE_TRACING[0]
    _PHASE_TRACING[0] = bool(enabled)
    try:
        yield
    finally:
        _PHASE_TRACING[0] = prev


def trace_events() -> list:
    """Trace events recorded since :func:`reset_trace_events` — one dict
    ``{"phase", "dispatches", "trace_s"}`` per annotated region entered
    while tracing was on.  Nested regions appear as separate entries (outer
    spans include inner dispatches)."""
    return list(_TRACE_EVENTS)


def reset_trace_events() -> None:
    _TRACE_EVENTS.clear()


@contextlib.contextmanager
def annotate(phase: str):
    """Name one step phase.  A no-op unless phase tracing is enabled.
    Enabled, it opens a profiler range (and an NVTX range on a CUDA build)
    named ``tel.<phase>`` and records a trace event with the number of
    fused-update dispatches issued inside the region and its wall time
    (host time: the kernels it launches may still be running)."""
    if not _PHASE_TRACING[0]:
        yield
        return
    import torch
    from repro_torch.kernels import ops   # lazy: keeps this module light
    n0 = ops.fused_update_count()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(f"tel.{phase}"))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(f"tel.{phase}"))
        yield
    _TRACE_EVENTS.append({
        "phase": phase,
        "dispatches": ops.fused_update_count() - n0,
        "trace_s": time.perf_counter() - t0,
    })


def trace_event_dict(step: int) -> dict:
    """One "trace" JSONL event summarizing the recorded trace events (the
    per-phase dispatch accounting of the step at ``step``)."""
    return {"kind": "trace", "step": int(step),
            "phases": [dict(e) for e in _TRACE_EVENTS]}


# ------------------------------------------------------ host-side timeline
@contextlib.contextmanager
def host_phase(phase: str, step: int = -1):
    """Record host wall-clock for one phase into the pending "phase" event
    list (drained by :func:`drain_phase_events`)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _PHASE_EVENTS.append({"kind": "phase", "step": int(step),
                              "phase": phase,
                              "wall_s": time.perf_counter() - t0})


def drain_phase_events() -> list:
    evs, _PHASE_EVENTS[:] = list(_PHASE_EVENTS), []
    return evs


class StepTimer:
    """The single ms/step + compile_s definition, as in the JAX package.

    The first recorded step is the compile step: its wall time is stored
    as ``compile_s`` and EXCLUDED from the steady-state series, because it
    pays the one-time costs (in the port: building the CUDA kernels and
    warming PyTorch's allocator) and would otherwise skew ms/step and the
    straggler z-scores.  Subsequent steps append to ``times``.

        timer = StepTimer()
        for i in range(steps):
            with timer.step():
                ... run one step, block on the result ...
            if timer.straggler_z is not None and timer.straggler_z > 4: ...
    """

    def __init__(self, window: int = 20, z_threshold: float = 4.0):
        self.window = int(window)
        self.z_threshold = float(z_threshold)
        self.compile_s: Optional[float] = None
        self.times: List[float] = []
        self.last_dt: Optional[float] = None
        self.straggler_z: Optional[float] = None

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(time.perf_counter() - t0)

    def record(self, dt: float) -> float:
        """Record one step's wall time; returns it.  First call lands in
        ``compile_s``, later calls in the steady series."""
        dt = float(dt)
        self.last_dt = dt
        self.straggler_z = None
        if self.compile_s is None:
            self.compile_s = dt
            return dt
        # straggler detection: z-score over the trailing window,
        # computed against the window BEFORE this step
        if len(self.times) > self.window:
            w = np.array(self.times[-self.window:-1])
            std = float(w.std())
            # A zero-variance window has no scale to judge deviation
            # against — the epsilon-divide made any jump look like a
            # billions-sigma straggler (or NaN).  Report 0.0: "no
            # evidence", not "infinite evidence".
            self.straggler_z = (float((dt - w.mean()) / std)
                                if std > 0.0 else 0.0)
        self.times.append(dt)
        return dt

    @property
    def is_straggler(self) -> bool:
        return (self.straggler_z is not None
                and self.straggler_z > self.z_threshold)

    def steady_ms(self) -> float:
        """Mean steady-state step time in ms (nan before the 2nd step)."""
        return 1e3 * float(np.mean(self.times)) if self.times else float("nan")

    def summary(self) -> dict:
        return {"compile_s": self.compile_s, "steady_ms": self.steady_ms(),
                "n_steps": len(self.times) + (self.compile_s is not None)}
