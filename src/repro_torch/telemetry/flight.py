"""Flight recorder: a crash-forensics ring and an on-trigger dump (mirrors
``repro.telemetry.flight``; its dumps are in the JAX package's format).

A host-side ring keeps the last K steps' compact metrics (loss, grad norm,
sentinel counts, step wall time — plain floats), and a one-deep snapshot
slot holds a host copy of the most recent *healthy* train state.  On a
trigger — a fatal detector event or a nonfinite loss — the recorder dumps
a forensic bundle:

    <dump_dir>/
      flight.json          # schema, trigger reason/step, metrics ring,
                           # anomaly timeline, config hash, git sha,
                           # telemetry JSONL tail
      state/step_NNNN/     # the last healthy state in the ordinary
                           # checkpoint format (train/checkpoint.py)

The bundle is an ordinary checkpoint of the port, which is the JAX
package's format, so a dump restores like any checkpoint — into the port
or into ``repro.train.checkpoint.restore`` — and a run resumed from it
replays the step before the blow-up bit-exactly.

*Host copies.*  The port updates the optimizer state (and the model's
parameters, which are its masters) in place, so a snapshot that held
references would be overwritten by the next step, and a poisoned state
would become the resume point.  :meth:`FlightRecorder.snapshot` therefore
copies every tensor to host memory (``snapshot_every`` thins the copies
for large models: at paper-lm-209m's full width one snapshot is ~1.5 GB).
An unhealthy step's output is never snapshotted.  A pooled optimizer
state is copied in the checkpoint's per-leaf canonical layout
(``blockopt.unpool_state``), the layout the dump stores, so the arenas'
masters are not copied twice (once as the arena, once as the parameters'
views).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import os
import subprocess
from typing import Any, Mapping, Optional

import torch

from repro_torch.core.optim import blockopt
from repro_torch.train import checkpoint as _ckpt

FLIGHT_SCHEMA = "repro.flight.v1"


def _git_sha() -> str:
    """Current commit (best-effort; "unknown" outside a usable checkout)."""
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=10)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def config_hash(config: Any) -> str:
    """Stable content hash of a config object (repr-based: dataclass
    reprs list every field, so any hyperparameter change moves the hash)."""
    return hashlib.sha256(repr(config).encode()).hexdigest()[:16]


def _scalarize(metrics: dict) -> dict:
    """Host-float view of a step metrics dict (drops non-scalars)."""
    out = {}
    for k, v in metrics.items():
        try:
            out[k] = float(v)
        except (TypeError, ValueError, RuntimeError):
            continue
    return out


def host_copy(tree):
    """A copy of ``tree`` (NamedTuples, dicts, state-leaf dataclasses,
    tensors, ints) with every tensor copied to host memory."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(host_copy(v) for v in tree))
    if isinstance(tree, Mapping):
        return type(tree)((k, host_copy(v)) for k, v in tree.items())
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: host_copy(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


class FlightRecorder:
    """Ring of recent step metrics + last-healthy-state snapshot.

        fr = FlightRecorder(ring=64)
        for i in range(steps):
            state, metrics = step_fn(state, batch)
            fr.record(i, metrics, wall_s=dt)
            if <healthy>:
                fr.snapshot(i, state)       # host copy of the NEW state
            else:
                fr.dump(out_dir, reason="nonfinite_loss", trigger_step=i)

    ``snapshot_every`` thins the host copies for long healthy runs (the
    snapshot then lags up to that many steps — still a valid resume
    point, just an earlier one).
    """

    def __init__(self, ring: int = 64, snapshot_every: int = 1):
        self.ring = int(ring)
        self.snapshot_every = max(1, int(snapshot_every))
        self._ring: collections.deque = collections.deque(maxlen=self.ring)
        self._snap_step: Optional[int] = None
        self._snap_state: Any = None
        self.anomalies: list = []

    # ------------------------------------------------------------ record
    def record(self, step: int, metrics: dict, **extra) -> None:
        """Append one step's compact metrics to the ring (host floats)."""
        row = {"step": int(step)}
        row.update(_scalarize(metrics))
        row.update(_scalarize(extra))
        self._ring.append(row)

    def snapshot(self, step: int, state: Any) -> None:
        """Retain a host copy of ``state`` as the last healthy resume
        point.  Call AFTER the step's health verdict, with the step's
        OUTPUT state.  The copy is taken now: the port updates the state in
        place, so a reference would hold the next step's values.  A
        partitioned state on a process group is gathered first: every rank
        calls this."""
        if step % self.snapshot_every:
            return
        self._snap_step = int(step)
        self._snap_state = host_copy(blockopt.map_opt_states(
            state, lambda st: blockopt.unpool_state(
                blockopt.gathered_state(st))))

    def note_anomaly(self, event: dict) -> None:
        self.anomalies.append(dict(event))

    @property
    def snapshot_step(self) -> Optional[int]:
        return self._snap_step

    # -------------------------------------------------------------- dump
    def dump(self, dump_dir: str, *, reason: str, trigger_step: int,
             config: Any = None, telemetry_path: Optional[str] = None,
             tail: int = 50) -> str:
        """Write the forensic bundle; returns ``dump_dir``.

        ``telemetry_path``: the run's telemetry JSONL — its last ``tail``
        events are embedded so the dump is self-contained even if the
        telemetry dir is lost."""
        os.makedirs(dump_dir, exist_ok=True)
        if self._snap_state is not None:
            _ckpt.save(os.path.join(dump_dir, "state"), self._snap_step,
                       self._snap_state)
        jsonl_tail: list = []
        if telemetry_path and os.path.exists(telemetry_path):
            with open(telemetry_path) as f:
                lines = [ln.strip() for ln in f if ln.strip()]
            for ln in lines[-int(tail):]:
                try:
                    jsonl_tail.append(json.loads(ln))
                except json.JSONDecodeError:
                    jsonl_tail.append({"unparsed": ln})
        manifest = {
            "schema": FLIGHT_SCHEMA,
            "reason": reason,
            "trigger_step": int(trigger_step),
            "snapshot_step": self._snap_step,
            "git_sha": _git_sha(),
            "config_hash": config_hash(config) if config is not None else None,
            "ring": list(self._ring),
            "anomalies": list(self.anomalies),
            "jsonl_tail": jsonl_tail,
        }
        with open(os.path.join(dump_dir, "flight.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        return dump_dir


def load_dump(dump_dir: str) -> dict:
    """The ``flight.json`` manifest of a dump (raises if absent/invalid)."""
    with open(os.path.join(dump_dir, "flight.json")) as f:
        manifest = json.load(f)
    if manifest.get("schema") != FLIGHT_SCHEMA:
        raise ValueError(f"{dump_dir}: schema {manifest.get('schema')!r}, "
                         f"want {FLIGHT_SCHEMA!r}")
    return manifest


def restore_state(dump_dir: str, template: Any) -> tuple:
    """``(snapshot_step, state)`` from a dump's state bundle — the last
    healthy train state, restored like any checkpoint into ``template``'s
    own tensors (in place; see ``train/checkpoint.restore``)."""
    manifest = load_dump(dump_dir)
    step = manifest.get("snapshot_step")
    if step is None:
        raise ValueError(f"{dump_dir}: dump carries no state snapshot")
    state = _ckpt.restore(os.path.join(dump_dir, "state"), step, template)
    return int(step), state
