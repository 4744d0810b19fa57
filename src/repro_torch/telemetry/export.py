"""Telemetry sinks and the JSONL event schema (mirrors
``repro.telemetry.export``, the same schema version and fields, so either
package's validator accepts the other's files).

Everything the port records about a run — the typed-metric registry
(``registry.py``), the quantization-health probes (``qhealth.py``), the
step-phase timeline (``tracing.py``) and the anomaly detectors
(``sentinel.py``) — is an *event*: a plain dict with a ``kind``, written to
*sinks*:

  * :class:`JsonlSink` — one JSON object per line (the ``--telemetry-dir``
    artifact; :func:`validate_jsonl` checks it);
  * :class:`InMemorySink` — a list, for tests;
  * :class:`BenchJsonSink` — routes events into a ``BENCH_*.json``-style
    trajectory file via :func:`append_json_trajectory`.

Every event carries ``kind``, ``step`` and ``schema``; the fields each kind
requires are in ``EVENT_FIELDS`` and :func:`validate_event` enforces them.
Extra fields are allowed.
"""
from __future__ import annotations

import json
import os
from typing import Any, Iterable, Optional

SCHEMA = "repro.telemetry.v1"

# kind -> required fields (beyond "kind"/"step"/"schema").  Extra fields are
# allowed; validation only enforces presence + basic types of these.
EVENT_FIELDS = {
    # one named, typed metric sample (registry.py)
    "metric": ("name", "type", "value"),
    # host-side step-phase timeline entry (tracing.py)
    "phase": ("phase", "wall_s"),
    # trace-time dispatch accounting for one compiled step (tracing.py)
    "trace": ("phases",),
    # per-segment quantization health (qhealth.py)
    "qhealth": ("target", "segment", "slot", "saturation_fraction",
                "util_hist", "util_fraction", "absmax_mean", "absmax_drift"),
    # detector escalation (sentinel.py): a watched signal
    # crossed its threshold — reason names the detector, severity is one
    # of ANOMALY_SEVERITIES, value is the offending measurement
    "anomaly": ("reason", "severity", "value"),
}

METRIC_TYPES = ("counter", "gauge", "histogram")
ANOMALY_SEVERITIES = ("warn", "error", "fatal")


def validate_event(ev: Any) -> list:
    """Schema errors for one event dict (empty list == valid)."""
    errs = []
    if not isinstance(ev, dict):
        return [f"event is {type(ev).__name__}, not dict"]
    kind = ev.get("kind")
    if kind not in EVENT_FIELDS:
        return [f"unknown kind {kind!r} (have {sorted(EVENT_FIELDS)})"]
    if ev.get("schema") != SCHEMA:
        errs.append(f"schema is {ev.get('schema')!r}, want {SCHEMA!r}")
    if not isinstance(ev.get("step"), int):
        errs.append(f"step is {ev.get('step')!r}, want int")
    for f in EVENT_FIELDS[kind]:
        if f not in ev:
            errs.append(f"{kind} event missing field {f!r}")
    if kind == "metric" and ev.get("type") not in METRIC_TYPES:
        errs.append(f"metric type {ev.get('type')!r} not in {METRIC_TYPES}")
    if kind == "metric" and ev.get("type") == "histogram":
        v = ev.get("value")
        if not isinstance(v, list):
            errs.append("histogram value must be a list of bin counts")
    if kind == "qhealth":
        if not isinstance(ev.get("util_hist"), list):
            errs.append("qhealth util_hist must be a list of bin counts")
    if kind == "trace" and not isinstance(ev.get("phases"), list):
        errs.append("trace phases must be a list")
    if kind == "anomaly" and "severity" in ev and \
            ev.get("severity") not in ANOMALY_SEVERITIES:
        errs.append(f"anomaly severity {ev.get('severity')!r} not in "
                    f"{ANOMALY_SEVERITIES}")
    return errs


def validate_jsonl(path: str) -> tuple:
    """Validate a telemetry JSONL artifact.

    Returns ``(events, errors)``: the parsed event dicts and a list of
    ``(line_number, error)`` strings — empty ``errors`` means the file is
    schema-valid."""
    events, errors = [], []
    with open(path) as f:
        for i, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                errors.append(f"line {i}: not JSON ({e})")
                continue
            for err in validate_event(ev):
                errors.append(f"line {i}: {err}")
            events.append(ev)
    return events, errors


class InMemorySink:
    """Keeps events in a list (tests, quickstart summary)."""

    def __init__(self):
        self.events: list = []

    def write(self, event: dict) -> None:
        self.events.append(event)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlSink:
    """Appends one JSON object per line; flushes eagerly so a preempted
    run leaves a readable artifact."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(self.path, "a")

    def write(self, event: dict) -> None:
        self._f.write(json.dumps(event) + "\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()


class BenchJsonSink:
    """Routes events into a ``BENCH_*.json`` trajectory file: each event
    becomes one deduped entry via :func:`append_json_trajectory` (the same
    writer behind ``benchmarks/common.append_bench_json``)."""

    def __init__(self, path: str, dedupe_fields: tuple = (),
                 defaults: Optional[dict] = None):
        self.path = path
        self.dedupe_fields = tuple(dedupe_fields)
        self.defaults = dict(defaults or {})

    def write(self, event: dict) -> None:
        entry = {**self.defaults, **event}
        append_json_trajectory(self.path, entry, self.dedupe_fields)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def append_json_trajectory(path: str, entry: dict,
                           dedupe_fields: Iterable = (),
                           defaults: Optional[dict] = None) -> str:
    """Record ``entry`` in a JSON trajectory file ``{"entries": [...]}``
    and return the absolute path.

    An existing entry agreeing with ``entry`` on every field in
    ``dedupe_fields`` is *replaced*, so repeat runs of the same cell don't
    pile up and the file reads as one row per (cell, commit).
    ``defaults`` are set on the entry only where absent.  Tolerates a
    missing or corrupt file.  This is the single trajectory writer shared
    by ``benchmarks/common.append_bench_json`` and :class:`BenchJsonSink`.
    """
    path = os.path.abspath(path)
    entry = dict(entry)
    for k, v in (defaults or {}).items():
        entry.setdefault(k, v)
    # Every trajectory entry carries a git_sha (it's a dedupe key): entries
    # written outside a git checkout — or by callers that couldn't resolve
    # one (detached/missing .git) — are stamped "unknown" rather than the
    # writer raising or silently dropping the key.
    entry.setdefault("git_sha", "unknown")
    data = {"entries": []}
    if os.path.exists(path):
        try:
            with open(path) as f:
                data = json.load(f)
        except (json.JSONDecodeError, OSError):
            data = {"entries": []}
    entries = data.setdefault("entries", [])
    fields = tuple(dedupe_fields)

    def key(e: dict) -> tuple:
        return tuple(repr(e.get(k)) for k in fields)

    if fields:
        k = key(entry)
        data["entries"] = [e for e in entries
                           if not (isinstance(e, dict) and key(e) == k)]
    data["entries"].append(entry)
    with open(path, "w") as f:
        json.dump(data, f, indent=2)
    return path
