"""Run inspector CLI: triage a telemetry dir or a flight dump (mirrors
``repro.telemetry.inspect``).

    PYTHONPATH=src python -m repro_torch.telemetry.inspect <run_dir>
    PYTHONPATH=src python -m repro_torch.telemetry.inspect --flight <dump_dir>
    PYTHONPATH=src python -m repro_torch.telemetry.inspect --diff <run_a> <run_b>
    PYTHONPATH=src python -m repro_torch.telemetry.inspect --validate <run_dir>

Reads the JSONL artifact a ``--telemetry-dir`` run produced
(``export.validate_jsonl`` is the gate: a malformed file is not
summarized) and renders the triage views: per-phase wall-time breakdown,
per-step dispatch accounting, quantization-health trends (first -> last
saturation and drift per probed leaf), and the anomaly timeline.
``--flight`` renders a flight-recorder bundle (trigger, last healthy
snapshot, metrics ring tail).  ``--diff`` compares two runs' phase totals
and final gauge values.

Exit codes:

    0  clean — schema-valid, no anomaly events
    1  anomalies present (or a flight dump was triggered)
    2  schema errors / unreadable artifact

``--validate`` runs only the schema gate (0/2).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from repro_torch.telemetry import export as _export
from repro_torch.telemetry import flight as _flight

EXIT_CLEAN, EXIT_ANOMALIES, EXIT_SCHEMA = 0, 1, 2


def _find_jsonl(path: str) -> Optional[str]:
    """Resolve a run dir (or direct file path) to its telemetry JSONL."""
    if os.path.isfile(path):
        return path
    if os.path.isdir(path):
        cands = sorted(f for f in os.listdir(path) if f.endswith(".jsonl"))
        pref = [c for c in cands if c == "telemetry.jsonl"] or cands
        if pref:
            return os.path.join(path, pref[0])
    return None


def _load(path: str, out) -> tuple:
    """(events, n_schema_errors) for one run; prints errors."""
    jsonl = _find_jsonl(path)
    if jsonl is None:
        print(f"error: no .jsonl artifact under {path}", file=out)
        return [], 1
    events, errors = _export.validate_jsonl(jsonl)
    for e in errors[:20]:
        print(f"  schema: {e}", file=out)
    if len(errors) > 20:
        print(f"  ... {len(errors) - 20} more schema errors", file=out)
    return events, len(errors)


# ------------------------------------------------------------ triage views
def _phase_breakdown(events: List[dict]) -> dict:
    """phase -> (total wall_s, count) over host "phase" events."""
    out: dict = {}
    for ev in events:
        if ev.get("kind") == "phase":
            t, n = out.get(ev["phase"], (0.0, 0))
            out[ev["phase"]] = (t + float(ev.get("wall_s", 0.0)), n + 1)
    return out


def _dispatch_accounting(events: List[dict]) -> List[dict]:
    """Per-phase dispatch counts (one list per "trace" event)."""
    return [ev for ev in events if ev.get("kind") == "trace"]


def _qhealth_trends(events: List[dict]) -> dict:
    """(target, segment, slot) -> [first_ev, last_ev] qhealth samples."""
    trends: dict = {}
    for ev in events:
        if ev.get("kind") != "qhealth":
            continue
        key = (ev.get("target"), ev.get("segment"), ev.get("slot"))
        if key in trends:
            trends[key][1] = ev
        else:
            trends[key] = [ev, ev]
    return trends


def _anomalies(events: List[dict]) -> List[dict]:
    return [ev for ev in events if ev.get("kind") == "anomaly"]


def _final_gauges(events: List[dict]) -> dict:
    """name -> last scalar value over gauge/counter metric events."""
    out: dict = {}
    for ev in events:
        if ev.get("kind") == "metric" and ev.get("type") in ("gauge",
                                                             "counter"):
            v = ev.get("value")
            if isinstance(v, (int, float)):
                out[ev["name"]] = float(v)
    return out


def _render_run(path: str, events: List[dict], out) -> None:
    print(f"== run: {path} ({len(events)} events)", file=out)
    phases = _phase_breakdown(events)
    if phases:
        print("-- phase breakdown (host wall-clock)", file=out)
        total = sum(t for t, _ in phases.values()) or 1.0
        for ph, (t, n) in sorted(phases.items(), key=lambda kv: -kv[1][0]):
            print(f"   {ph:24s} {t:9.3f}s  x{n:<5d} {100 * t / total:5.1f}%",
                  file=out)
    for tr in _dispatch_accounting(events):
        pieces = ", ".join(f"{p.get('phase')}={p.get('dispatches')}"
                           for p in tr.get("phases", [])
                           if p.get("dispatches"))
        print(f"-- dispatch accounting (step {tr.get('step')}): "
              f"{pieces or 'no fused dispatches recorded'}", file=out)
    trends = _qhealth_trends(events)
    if trends:
        print("-- qhealth trends (first -> last)", file=out)
        for (tgt, seg, slot), (a, b) in sorted(trends.items(),
                                               key=lambda kv: str(kv[0])):
            print(f"   {tgt}/{seg}/{slot}: sat "
                  f"{a.get('saturation_fraction', 0):.4f}->"
                  f"{b.get('saturation_fraction', 0):.4f}  drift "
                  f"{a.get('absmax_drift', 0):.4f}->"
                  f"{b.get('absmax_drift', 0):.4f}", file=out)
    anoms = _anomalies(events)
    if anoms:
        print(f"-- anomaly timeline ({len(anoms)} events)", file=out)
        for ev in anoms:
            print(f"   step {ev.get('step'):>6} [{ev.get('severity')}] "
                  f"{ev.get('reason')}: value={ev.get('value')} "
                  f"{ev.get('detail', '')}", file=out)
    else:
        print("-- no anomalies", file=out)


def _render_flight(dump_dir: str, out) -> int:
    """Render a flight dump; returns an exit code."""
    try:
        manifest = _flight.load_dump(dump_dir)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: cannot read flight dump {dump_dir}: {e}", file=out)
        return EXIT_SCHEMA
    print(f"== flight dump: {dump_dir}", file=out)
    print(f"   reason: {manifest.get('reason')}  trigger step: "
          f"{manifest.get('trigger_step')}  last healthy snapshot: "
          f"{manifest.get('snapshot_step')}", file=out)
    print(f"   git_sha: {manifest.get('git_sha')}  config_hash: "
          f"{manifest.get('config_hash')}", file=out)
    ring = manifest.get("ring", [])
    for row in ring[-5:]:
        extras = {k: v for k, v in row.items() if k != "step"}
        brief = ", ".join(f"{k}={v:.4g}" if isinstance(v, float)
                          else f"{k}={v}" for k, v in list(extras.items())[:6])
        print(f"   ring step {row.get('step'):>6}: {brief}", file=out)
    # dump anomalies are schema-checked too: a dump that recorded a
    # malformed event should fail loudly here, not in a later reader
    errs = [e for ev in manifest.get("anomalies", [])
            for e in _export.validate_event(ev)]
    for ev in manifest.get("anomalies", []):
        print(f"   anomaly step {ev.get('step'):>6} [{ev.get('severity')}] "
              f"{ev.get('reason')}: {ev.get('value')}", file=out)
    if errs:
        for e in errs[:10]:
            print(f"   schema: {e}", file=out)
        return EXIT_SCHEMA
    # a flight dump only exists because something triggered it
    return EXIT_ANOMALIES


def _render_diff(a: str, b: str, out) -> int:
    ev_a, err_a = _load(a, out)
    ev_b, err_b = _load(b, out)
    if err_a or err_b:
        return EXIT_SCHEMA
    print(f"== diff: {a} vs {b}", file=out)
    ph_a, ph_b = _phase_breakdown(ev_a), _phase_breakdown(ev_b)
    for ph in sorted(set(ph_a) | set(ph_b)):
        ta, tb = ph_a.get(ph, (0.0, 0))[0], ph_b.get(ph, (0.0, 0))[0]
        mark = "" if ta == 0 else f" ({(tb - ta) / ta * 100:+.1f}%)"
        print(f"   phase {ph:24s} {ta:9.3f}s -> {tb:9.3f}s{mark}", file=out)
    ga, gb = _final_gauges(ev_a), _final_gauges(ev_b)
    for name in sorted(set(ga) | set(gb)):
        va, vb = ga.get(name), gb.get(name)
        if va is not None and vb is not None and va != vb:
            print(f"   gauge {name:24s} {va:.6g} -> {vb:.6g}", file=out)
    na, nb = len(_anomalies(ev_a)), len(_anomalies(ev_b))
    print(f"   anomalies: {na} -> {nb}", file=out)
    return EXIT_ANOMALIES if (na or nb) else EXIT_CLEAN


def main(argv=None, out=None) -> int:
    out = out or sys.stdout
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.inspect",
        description="triage a telemetry run dir / flight dump")
    ap.add_argument("run", nargs="?", default=None,
                    help="telemetry dir (or JSONL file) to inspect")
    ap.add_argument("--flight", default=None,
                    help="flight-recorder dump dir to render")
    ap.add_argument("--diff", nargs=2, metavar=("RUN_A", "RUN_B"),
                    default=None, help="compare two runs")
    ap.add_argument("--validate", default=None, metavar="RUN",
                    help="schema-validate only (exit 0/2)")
    args = ap.parse_args(argv)

    if args.validate is not None:
        events, n_err = _load(args.validate, out)
        ok = n_err == 0
        print(f"{'VALID' if ok else 'INVALID'}: {len(events)} events, "
              f"{n_err} schema error(s)", file=out)
        return EXIT_CLEAN if ok else EXIT_SCHEMA

    if args.diff is not None:
        return _render_diff(args.diff[0], args.diff[1], out)

    code = EXIT_CLEAN
    if args.run is not None:
        events, n_err = _load(args.run, out)
        if n_err:
            return EXIT_SCHEMA
        _render_run(args.run, events, out)
        if _anomalies(events):
            code = EXIT_ANOMALIES
    if args.flight is not None:
        fcode = _render_flight(args.flight, out)
        code = max(code, fcode)
    if args.run is None and args.flight is None:
        ap.print_usage(out)
        return EXIT_SCHEMA
    return code


if __name__ == "__main__":
    raise SystemExit(main())
