"""The port's telemetry (``repro_torch.telemetry``) against the JAX
package's (``tests/test_telemetry.py``'s cases but the 4-device
partitioned probe): the typed registry, the JSONL sinks and schema, the
qhealth probe on the same optimizer state, phase tracing and the step
timer.

Every JSONL file the port writes here must pass the JAX package's own
validator (``repro.telemetry.export.validate_jsonl`` and ``python -m
repro.telemetry.inspect --validate``).  Probe tolerances: counts,
fractions and histograms equal; ``absmax_mean`` and ``rms_error`` within
1e-6 relative (f32 means in another summation order).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_pipe
from repro import telemetry as jtel
from repro.core import optim as jopt
from repro.core.optim import base as jbase
from repro.telemetry import qhealth as jqh
from repro.train import checkpoint as JC
from repro_torch import telemetry as tel
from repro_torch.configs import base as tcb
from repro_torch.core import optim as topt
from repro_torch.telemetry import tracing
from repro_torch.telemetry.export import (append_json_trajectory,
                                          validate_event)
from repro_torch.train import checkpoint as TC
from repro_torch.train import loop as TL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_validates(path):
    events, errors = jtel.validate_jsonl(path)
    assert errors == [], errors
    r = subprocess.run([sys.executable, "-m", "repro.telemetry.inspect",
                        "--validate", path], capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=os.path.join(ROOT,
                                                                    "src"),
                                JAX_PLATFORMS="cpu"), timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return events


# ------------------------------------------------------------- registry
def test_registry_typed_metrics_round_trip():
    reg = tel.MetricRegistry()
    sink = tel.InMemorySink()
    reg.add_sink(sink)
    assert reg.counter("serve/requests").inc(3) == 3
    assert reg.counter("serve/requests").inc() == 4
    reg.gauge("train/loss").set(torch.tensor(2.5))       # 0-d tensor ok
    reg.histogram("q/util", n_bins=4).observe_counts([1, 0, 2, 7])
    reg.flush(step=5)
    assert reg.metrics() == {"serve/requests": 4, "train/loss": 2.5,
                             "q/util": [1, 0, 2, 7]}
    assert reg.get("never/registered") is None
    by_name = {e["name"]: e for e in sink.events}
    assert len(sink.events) == 3
    assert by_name["serve/requests"]["type"] == "counter"
    assert by_name["q/util"]["value"] == [1, 0, 2, 7]
    for e in sink.events:
        assert validate_event(e) == [] and jtel.validate_event(e) == [], e
        assert e["step"] == 5


def test_registry_type_mismatch_raises():
    reg = tel.MetricRegistry()
    reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")
    reg.histogram("h", n_bins=16)
    with pytest.raises(TypeError):
        reg.histogram("h", n_bins=256)
    with pytest.raises(TypeError):
        reg.counter("h")


def test_record_scalars_routes_gauges_and_skips_arrays():
    reg = tel.MetricRegistry()
    sink = tel.InMemorySink()
    reg.add_sink(sink)
    reg.record_scalars(3, {"loss": torch.tensor(1.5),
                           "grad_norm": np.float64(0.25),
                           "dispatches": 7.0,
                           "not_scalar": torch.zeros(4),
                           "not_scalar_np": np.zeros(2)}, prefix="train/")
    assert reg.get("train/loss") == 1.5
    assert reg.get("train/grad_norm") == 0.25
    assert reg.get("train/dispatches") == 7.0
    assert reg.get("train/not_scalar") is None
    assert reg.get("train/not_scalar_np") is None
    assert [e["name"] for e in sink.events] == [
        "train/loss", "train/grad_norm", "train/dispatches"]
    assert all(e["step"] == 3 and jtel.validate_event(e) == []
               for e in sink.events)


# ----------------------------------------------------------- JSONL schema
def test_jsonl_sink_and_schema_validation(tmp_path):
    path = str(tmp_path / "t.jsonl")
    reg = tel.MetricRegistry()
    reg.add_sink(tel.JsonlSink(path))
    reg.gauge("a").set(1.0)
    reg.flush(step=0)
    reg.emit_event({"kind": "phase", "step": 1, "phase": "step",
                    "wall_s": 0.01})
    reg.emit_event({"kind": "trace", "step": 1, "phases": []})
    reg.emit_event({"kind": "anomaly", "step": 2, "reason": "x",
                    "severity": "warn", "value": 1.0})
    reg.close()
    events, errors = tel.validate_jsonl(path)
    assert errors == []
    assert [e["kind"] for e in events] == ["metric", "phase", "trace",
                                           "anomaly"]
    assert all(e["schema"] == tel.SCHEMA == jtel.SCHEMA for e in events)
    assert _jax_validates(path) == events


def test_validate_event_rejects_malformed():
    assert validate_event("not a dict")
    assert validate_event({"kind": "nope"})
    errs = validate_event({"kind": "qhealth", "step": 1})
    assert any("missing field" in e for e in errs)
    assert any("schema" in e for e in errs)
    assert validate_event({"kind": "metric", "schema": tel.SCHEMA,
                           "step": "x", "name": "a", "type": "timer",
                           "value": 1})
    assert validate_event({"kind": "metric", "schema": tel.SCHEMA,
                           "step": 1, "name": "a", "type": "histogram",
                           "value": 3})
    from repro_torch.telemetry import export
    from repro.telemetry import export as jexport
    assert export.EVENT_FIELDS == jexport.EVENT_FIELDS
    assert export.ANOMALY_SEVERITIES == jexport.ANOMALY_SEVERITIES


def test_validate_jsonl_flags_bad_lines(tmp_path):
    path = str(tmp_path / "bad.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "phase", "schema": tel.SCHEMA,
                            "step": 0, "phase": "x", "wall_s": 0.1}) + "\n")
        f.write("not json\n")
        f.write(json.dumps({"kind": "metric", "schema": tel.SCHEMA,
                            "step": 0}) + "\n")
    events, errors = tel.validate_jsonl(path)
    assert len(events) == 2
    assert any("not JSON" in e for e in errors)
    assert any("missing field" in e for e in errors)


def test_append_json_trajectory_dedupes_and_stamps(tmp_path):
    path = str(tmp_path / "B.json")
    for sha, v in (("s1", 1), ("s1", 2), ("s2", 3)):
        append_json_trajectory(path, {"bench": "a", "git_sha": sha, "v": v},
                               dedupe_fields=("bench", "git_sha"))
    with open(path) as f:
        entries = json.load(f)["entries"]
    assert [(e["git_sha"], e["v"]) for e in entries] == [("s1", 2),
                                                         ("s2", 3)]
    with open(path, "w") as f:
        f.write("{broken")
    append_json_trajectory(path, {"bench": "a", "v": 9},
                           dedupe_fields=("bench",), defaults={"tag": "d"})
    with open(path) as f:
        entries = json.load(f)["entries"]
    assert entries == [{"bench": "a", "v": 9, "tag": "d",
                        "git_sha": "unknown"}]


def test_bench_json_sink_routes_events(tmp_path):
    path = str(tmp_path / "B.json")
    reg = tel.MetricRegistry()
    reg.add_sink(tel.BenchJsonSink(path, dedupe_fields=("name",),
                                   defaults={"git_sha": "deadbeef"}))
    reg.gauge("x").set(1.0)
    reg.flush(step=0)
    reg.gauge("x").set(2.0)
    reg.flush(step=1)
    with open(path) as f:
        entries = json.load(f)["entries"]
    assert len(entries) == 1
    assert entries[0]["value"] == 2.0 and entries[0]["git_sha"] == "deadbeef"


# --------------------------------------------------- qhealth vs the JAX probe
def _params():
    rng = np.random.RandomState(7)
    return {"a": rng.randn(3000).astype(np.float32),          # padded tail
            "b": rng.randn(64, 48).astype(np.float32)}


def _muon_params():
    rng = np.random.RandomState(0)
    return {"w": rng.randn(32, 64).astype(np.float32),
            "v": rng.randn(1024).astype(np.float32)}


def _states(tmp_path, name, params, kw):
    """One step of the JAX optimizer (per-leaf), its state copied into the
    port's through a JAX-written checkpoint."""
    jo = jopt.make_optimizer(name, lr=1e-2, min_8bit_size=256,
                             override_32bit=lambda p: False, pooled=False,
                             impl="jnp", **kw)
    js = jo.init({k: jnp.asarray(v) for k, v in params.items()})
    _, js = jo.apply({k: jnp.asarray(v * 0.01) for k, v in params.items()},
                     js)
    JC.save(str(tmp_path), 1, js)
    to = topt.make_optimizer(name, lr=1e-2, min_8bit_size=256,
                             override_32bit=lambda p: False, pooled=False,
                             device="cpu", **kw)
    ts = to.init({k: torch.zeros(v.shape) for k, v in params.items()})
    return jo, js, to, TC.restore(str(tmp_path), 1, ts)


def _jax_leaf_events(jo, js, step):
    """The JAX probe's events for every per-leaf Quant8Leaf.  The JAX
    package's probe takes a per-leaf master as it is (param-shaped, not in
    blocks: ROADMAP C), so its round-trip sample is taken here with its own
    ``_roundtrip_rms`` on the master cut into blocks, the port's
    definition."""
    probe = jtel.QHealthProbe(jo)
    events = []
    for path in sorted(js.leaves, key=lambda p: p.split("/")):
        leaf = js.leaves[path]
        if not isinstance(leaf, jbase.Quant8Leaf):
            continue
        segs = ((path, 0, int(leaf.absmax_m.shape[0]), leaf.n),)
        ev_m = probe._slot_events("leaf", "m", leaf.codes_m, leaf.absmax_m,
                                  segs, step)[0]
        blocks = jbase.flatten_to_blocks(leaf.master, jo.cfg.block_size, 1)
        blocks = blocks[:probe.sample_blocks]
        ev_m["rms_error"] = float(jqh._roundtrip_rms(blocks, jo._qmap1))
        ev_m["rms_sample_blocks"] = int(blocks.shape[0])
        events.append(ev_m)
        if leaf.codes_r is not None:
            events += probe._slot_events("leaf", "r", leaf.codes_r,
                                         leaf.absmax_r, segs, step)
    return events


PROBE_CASES = [("adam8", _params, {}),
               ("adam8", _params, {"state_bits": (4, 8)}),
               ("momentum8", _params, {"state_bits": 5}),
               ("muon8", _muon_params, {})]


@pytest.mark.parametrize("name,params,kw", PROBE_CASES,
                         ids=["adam8", "adam8-4-8", "momentum8-5", "muon8"])
def test_qhealth_probe_matches_jax(tmp_path, name, params, kw):
    jo, js, to, ts = _states(tmp_path, name, params(), kw)
    want = _jax_leaf_events(jo, js, step=1)
    got = tel.QHealthProbe(to).probe(ts, step=1)
    assert [(e["segment"], e["slot"]) for e in got] == \
        [(e["segment"], e["slot"]) for e in want]
    assert want
    for g, w in zip(got, want):
        key = (g["segment"], g["slot"])
        assert g["target"] == "leaf"
        for f in ("bits", "n_bins", "n_blocks", "saturation_fraction",
                  "edge_code_fraction", "util_hist", "util_fraction",
                  "absmax_drift"):
            assert g[f] == w[f], (key, f)
        np.testing.assert_allclose(g["absmax_mean"], w["absmax_mean"],
                                   rtol=1e-6, err_msg=str(key))
        if g["slot"] == "m":
            np.testing.assert_allclose(g["rms_error"], w["rms_error"],
                                       rtol=1e-6, err_msg=str(key))
            assert g["rms_sample_blocks"] == w["rms_sample_blocks"]
            assert 0.0 < g["rms_error"] < 0.2
        assert sum(g["util_hist"]) == int(np.prod(params()[g["segment"]]
                                                  .shape))
        assert jtel.validate_event({**g, "schema": tel.SCHEMA}) == []
    assert {e["n_bins"] for e in got if e["slot"] == "m"} == {
        1 << to.cfg.state_bits_pair[0]}


def test_qhealth_events_written_and_validated_by_jax(tmp_path):
    _, _, to, ts = _states(tmp_path / "ck", "adam8", _params(), {})
    path = str(tmp_path / "q.jsonl")
    reg = tel.MetricRegistry()
    reg.add_sink(tel.JsonlSink(path))
    for ev in tel.QHealthProbe(to).probe(ts, step=4):
        reg.emit_event(ev)
    reg.close()
    events = _jax_validates(path)
    assert [e["kind"] for e in events] == ["qhealth"] * 4


def test_qhealth_edge_is_the_reference_definition():
    """The probe's edge is |qmap[c]| >= max|qmap| (on the signed map the top
    code alone), not the sentinel's c in {0, 2^bits - 1}."""
    to = topt.make_optimizer("momentum8", min_8bit_size=256,
                             override_32bit=lambda p: False, pooled=False,
                             device="cpu")
    state = to.init({"a": torch.zeros(4096)})
    leaf = state.leaves["a"]
    leaf.codes_m[0, :10] = 0                 # the lowest level, -0.993
    leaf.codes_m[0, 10:20] = 255             # the top level, +1
    leaf.codes_m[1] = 128
    leaf.absmax_m.fill_(1.0)
    ev = tel.QHealthProbe(to).probe(state)[0]
    assert ev["edge_code_fraction"] == pytest.approx(10 / 4096)
    assert ev["saturation_fraction"] == 0.5


def test_qhealth_drift_ema():
    probe = tel.QHealthProbe(topt.make_optimizer("adam8", device="cpu"),
                             ema_decay=0.5)
    key = ("leaf", "x", "m")
    assert probe._drift(key, 2.0) == 1.0
    assert probe._drift(key, 4.0) == pytest.approx(2.0)
    assert probe._drift(key, 3.0) == pytest.approx(1.0)


def test_qhealth_arena_waits_for_pooling():
    """A pooled state's probe gives one "arena" event per segment and slot,
    with the per-leaf probe's values for the same state."""
    params = {k: torch.from_numpy(v) for k, v in _params().items()}
    events = {}
    for pooled in (True, False):
        to = topt.make_optimizer("adam8", lr=1e-2, min_8bit_size=256,
                                 override_32bit=lambda p: False,
                                 pooled=pooled, device="cpu")
        st = to.init({k: v.clone() for k, v in params.items()})
        _, st = to.apply({k: v * 0.01 for k, v in params.items()}, st)
        events[pooled] = tel.QHealthProbe(to).probe(st, step=1)
    assert [(e["target"], e["segment"], e["slot"]) for e in events[True]] \
        == [("arena", "a", "m"), ("arena", "b", "m"), ("arena", "a", "r"),
            ("arena", "b", "r")]
    leaf = {(e["segment"], e["slot"]): e for e in events[False]}
    for e in events[True]:
        want = dict(leaf[(e["segment"], e["slot"])], target="arena")
        assert e == want


# ------------------------------------------------------ tracing and timing
def _tcfg():
    return tcb.reduced(tcb.get_config("paper-lm-209m"), d_model=64,
                       n_layers=2, vocab_size=128)


def test_annotate_is_a_noop_when_disabled(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("annotate touched the profiler while off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    tracing.reset_trace_events()
    with tracing.annotate("x"):
        pass
    assert tracing.trace_events() == []
    assert not tracing.phase_tracing_enabled()


def test_annotate_records_events_and_profiler_ranges():
    with tracing.phase_tracing(True):
        tracing.reset_trace_events()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with tracing.annotate("x"):
                torch.ones(3).sum()
        evs = tracing.trace_events()
    assert [e["phase"] for e in evs] == ["x"]
    assert evs[0]["dispatches"] == 0 and evs[0]["trace_s"] >= 0.0
    assert any(e.key == "tel.x" for e in prof.key_averages())
    tracing.reset_trace_events()


def _train(steps, trace, telemetry_every=0):
    opt = topt.make_optimizer("adam8", lr=5e-3, min_8bit_size=1024,
                              telemetry_every=telemetry_every, pooled=False,
                              device="cpu")
    state, model = TL.init_train_state(
        _tcfg(), opt, torch.Generator().manual_seed(0), device="cpu")
    step = TL.make_train_step(model.cfg, model, opt)
    losses, events = [], []
    with tracing.phase_tracing(trace):
        for i in range(steps):
            tracing.reset_trace_events()
            state, m = step(state, tiny_pipe().batch_at(i))
            losses.append(float(m["loss"]))
            events.append(tracing.trace_events())
    tracing.reset_trace_events()
    n_quant = sum(isinstance(leaf, topt.Quant8Leaf)
                  for leaf in state.opt_state.leaves.values())
    return losses, events, n_quant, [p.clone() for p in model.parameters()]


def test_phase_tracing_accounts_dispatches_and_changes_nothing():
    """With tracing on, every step records forward_backward and
    optimizer_update, the latter with one fused dispatch per quantized
    leaf; losses and params are bit-identical to tracing (and
    telemetry_every) off."""
    losses_off, evs_off, _, params_off = _train(2, False)
    losses_on, evs_on, n_quant, params_on = _train(2, True,
                                                   telemetry_every=2)
    assert losses_on == losses_off
    assert all(torch.equal(a, b) for a, b in zip(params_on, params_off))
    assert evs_off == [[], []]
    for evs in evs_on:
        phases = {e["phase"]: e for e in evs}
        assert set(phases) == {"forward_backward", "optimizer_update"}
        assert phases["optimizer_update"]["dispatches"] == n_quant > 0
        assert phases["forward_backward"]["dispatches"] == 0
    with tracing.phase_tracing(True):
        tracing.reset_trace_events()
        with tracing.annotate("optimizer_update"):
            pass
        ev = tracing.trace_event_dict(0)
    tracing.reset_trace_events()
    assert ev["kind"] == "trace" and isinstance(ev["phases"], list)
    assert jtel.validate_event({**ev, "schema": tel.SCHEMA}) == []


def test_host_phase_timeline():
    with tracing.host_phase("probe", step=3):
        pass
    evs = tracing.drain_phase_events()
    assert len(evs) == 1
    assert evs[0]["kind"] == "phase" and evs[0]["phase"] == "probe"
    assert evs[0]["step"] == 3 and evs[0]["wall_s"] >= 0.0
    assert tracing.drain_phase_events() == []


def test_step_timer_compile_split_and_straggler():
    t = tracing.StepTimer(window=5, z_threshold=3.0)
    t.record(10.0)
    assert t.compile_s == 10.0 and np.isnan(t.steady_ms())
    steady = [0.1, 0.11, 0.09, 0.1, 0.105, 0.095, 0.1, 0.11]
    for dt in steady:
        t.record(dt)
    assert t.steady_ms() == pytest.approx(1e3 * np.mean(steady))
    assert not t.is_straggler
    t.record(5.0)
    assert t.is_straggler and t.straggler_z > 3.0
    assert t.summary() == {"compile_s": 10.0, "steady_ms": t.steady_ms(),
                           "n_steps": 10}


def test_step_timer_zero_variance_window_scores_zero():
    t = tracing.StepTimer(window=5, z_threshold=3.0)
    t.record(1.0)
    for _ in range(8):
        t.record(0.1)
    t.record(50.0)
    assert t.straggler_z == 0.0 and not t.is_straggler


def test_step_timer_context_manager():
    t = tracing.StepTimer()
    with t.step():
        pass
    with t.step():
        pass
    assert t.compile_s is not None and len(t.times) == 1


def test_telemetry_exports_match_jax():
    assert set(tel.__all__) == set(jtel.__all__)
