"""Typed metric registry (mirrors ``repro.telemetry.registry``): counters,
gauges and histograms, each name registered once under one type, and the
sinks they emit to.

    reg = MetricRegistry()
    reg.counter("serve/requests").inc()
    reg.gauge("serve/tokens_per_s").set(812.5)
    reg.histogram("serve/latency_ms", n_bins=10).observe_counts(counts)
    reg.flush(step=7)           # one "metric" event per set metric

Values are host scalars and numpy arrays.  A sink is any object with
``write(event)``, ``flush()`` and ``close()`` (``export.py``).
``record_scalars(step, mapping)`` is the train loop's adapter: every scalar
of a step's metrics dict becomes a gauge sample, emitted at once, with one
device-to-host copy for all the tensors among them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

import torch

from repro_torch.errors import FormatError
from repro_torch.telemetry.export import SCHEMA


def _scalar(v: Any) -> float:
    """Host float from a python/numpy/0-d tensor scalar."""
    return float(v)


def host_scalars(mapping: dict) -> dict:
    """The scalar entries of ``mapping`` (Python and numpy scalars, 0-d
    tensors on any device) as host floats, in its order, with one
    device-to-host copy per device for all the tensors among them;
    entries with more than one element are dropped."""
    values, tensors = {}, {}
    for name, v in mapping.items():
        if isinstance(v, torch.Tensor):
            if v.dim() == 0:
                tensors.setdefault(v.device, {})[name] = v
        elif np.ndim(v) == 0:
            values[name] = float(v)
    for group in tensors.values():
        host = torch.stack([t.detach().to(torch.float64)
                            for t in group.values()]).cpu().tolist()
        values.update(zip(group, host))
    return {name: values[name] for name in mapping if name in values}


class Counter:
    """Monotonically increasing count (requests, tokens, events)."""

    mtype = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> int:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(got {n})")
        self.value += int(n)
        return self.value


class Gauge:
    """Last-value metric (tokens/s, occupancy, bytes per token)."""

    mtype = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, v: Any) -> float:
        self.value = _scalar(v)
        return self.value


class Histogram:
    """Binned counts.  The histograms arrive pre-binned, so the API takes
    counts instead of streaming observations."""

    mtype = "histogram"

    def __init__(self, name: str, n_bins: int):
        self.name = name
        self.n_bins = int(n_bins)
        self.value = np.zeros((self.n_bins,), np.int64)

    def observe_counts(self, counts: Any) -> np.ndarray:
        c = np.asarray(counts, np.int64).reshape(-1)
        if c.shape[0] != self.n_bins:
            raise FormatError(f"histogram {self.name}: got {c.shape[0]} "
                              f"bins, expected {self.n_bins}")
        self.value = c
        return self.value


class MetricRegistry:
    """Named, typed metrics plus the sinks they emit to."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}
        self._sinks: list = []

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, *args)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is a {m.mtype}, not a "
                            f"{cls.mtype}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, n_bins: int) -> Histogram:
        h = self._get(name, Histogram, n_bins)
        if h.n_bins != int(n_bins):
            raise TypeError(f"histogram {name!r} has {h.n_bins} bins, "
                            f"not {n_bins}")
        return h

    @staticmethod
    def _value(m):
        v = m.value
        return v.tolist() if isinstance(v, np.ndarray) else v

    def metrics(self) -> dict:
        """Snapshot {name: current value} (histograms as lists)."""
        return {name: self._value(m) for name, m in self._metrics.items()}

    def get(self, name: str):
        """Current value of ``name`` (None if never registered)."""
        m = self._metrics.get(name)
        return None if m is None else self._value(m)

    def add_sink(self, sink) -> None:
        self._sinks.append(sink)

    def emit_event(self, event: dict) -> None:
        """Stamp the schema version (and step -1 if absent) and write to
        every sink."""
        event = dict(event)
        event.setdefault("schema", SCHEMA)
        event.setdefault("step", -1)
        for s in self._sinks:
            s.write(event)

    def _metric_event(self, m, step: int) -> dict:
        ev = {"kind": "metric", "step": int(step), "name": m.name,
              "type": m.mtype, "value": self._value(m)}
        if isinstance(m, Histogram):
            ev["n_bins"] = m.n_bins
        return ev

    def flush(self, step: int = -1) -> None:
        """Write one "metric" event per set metric to every sink, then
        flush the sinks."""
        for m in self._metrics.values():
            if m.value is None:
                continue
            self.emit_event(self._metric_event(m, step))
        for s in self._sinks:
            s.flush()

    def record_scalars(self, step: int, mapping: dict,
                       prefix: str = "") -> None:
        """Route one step's scalar metrics through gauges and emit each at
        once.  Values may be Python or numpy scalars or 0-d tensors (copied
        to the host together, :func:`host_scalars`); anything with more
        than one element is skipped."""
        for name, v in host_scalars(mapping).items():
            g = self.gauge(prefix + name)
            g.set(v)
            self.emit_event(self._metric_event(g, step))
        for s in self._sinks:
            s.flush()

    def close(self) -> None:
        for s in self._sinks:
            s.close()
