"""The numerics sentinel, the anomaly detectors, the flight recorder and
the run inspector of the port, held against the JAX package
(``tests/test_sentinel.py``'s cases but the 4-device ZeRO-1 one).

The same numpy inputs go to ``repro.core.optim.make_optimizer(...,
sentinel=True, pooled=False, impl="jnp")`` and to the port's optimizer on
the CPU (the kernel wrappers' plain versions, and the "torch" oracle for
the tensor-wise ablation).  Tolerances:

  * health vectors: equal (integer counts);
  * the port with the sentinel on against off: params and state equal bit
    for bit;
  * params against the JAX package: equal, NaN where it has NaN, except
    lamb/lars, whose trust ratios agree to rounding, and muon, whose
    Newton–Schulz products sum in another order (rtol 1e-5, as in
    tests/test_torch_optim_family.py and tests/test_torch_muon.py).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg, tiny_pipe
from repro.core import optim as jopt
from repro.telemetry import export as jexport
from repro.telemetry import inspect as jinsp
from repro.train import checkpoint as JC
from repro.train import loop as JL
from repro_torch import telemetry as tel
from repro_torch.configs import base as tcb
from repro_torch.core import optim as topt
from repro_torch.core.lowbit import PackedCodes
from repro_torch.core.optim import Full32Leaf, Quant8Leaf
from repro_torch.kernels import fused_update as kfu
from repro_torch.telemetry import inspect as insp
from repro_torch.train import checkpoint as TC
from repro_torch.train import loop as TL


# ------------------------------------------------------- in-graph health
def _params():
    rng = np.random.RandomState(7)
    return {"a": rng.randn(3000).astype(np.float32),        # padded tail
            "b": rng.randn(64, 48).astype(np.float32),
            "c": rng.randn(100).astype(np.float32)}         # 32-bit leaf


def _grads(poison: bool):
    g = {k: (v * 0.01).astype(np.float32) for k, v in _params().items()}
    if poison:
        # one block of "a" holds NaN, +inf and -inf (a NaN absmax: x /
        # scale reaches +inf, the capped encode); "b" holds 1e31 (an
        # absmax past the overflow guard, an inf second moment); the
        # 32-bit leaf "c" a NaN
        g["a"][123], g["a"][124], g["a"][5] = np.nan, np.inf, -np.inf
        g["b"][3, 3] = 1e31
        g["c"][0] = np.nan
    return g


def _jopt(name, **kw):
    return jopt.make_optimizer(name, lr=1e-2, min_8bit_size=256,
                               override_32bit=lambda p: False, pooled=False,
                               impl="jnp", **kw)


def _topt(name, **kw):
    return topt.make_optimizer(name, lr=1e-2, min_8bit_size=256,
                               override_32bit=lambda p: False, pooled=False,
                               device="cpu", **kw)


def _poison_state_jax(state):
    """Leaf "b"'s state poisoned: its block 0 absmax set to inf (the
    dequantized state is then inf and NaN), or for a 32-bit leaf its first
    moment's first element."""
    leaves = dict(state.leaves)
    b = leaves["b"]
    if hasattr(b, "absmax_m"):
        b = dataclasses.replace(b, absmax_m=b.absmax_m.at[0].set(jnp.inf))
    else:
        b = dataclasses.replace(b, m=b.m.at[0, 0].set(jnp.inf))
    leaves["b"] = b
    return state._replace(leaves=leaves)


def _poison_state_port(state):
    b = state.leaves["b"]
    if isinstance(b, Quant8Leaf):
        b.absmax_m[0] = float("inf")
    else:
        b.m[0, 0] = float("inf")


def _run_jax(name, kw, poison):
    jo = _jopt(name, sentinel=True, **kw)
    params = {k: jnp.asarray(v) for k, v in _params().items()}
    state = jo.init(params)
    clean = {k: jnp.asarray(v) for k, v in _grads(False).items()}
    _, state, _ = jo.apply(clean, state)
    if poison:
        state = _poison_state_jax(state)
    g = {k: jnp.asarray(v) for k, v in _grads(poison).items()}
    p, state, h = jo.apply(g, state)
    return ({k: np.asarray(v) for k, v in p.items()},
            np.asarray(jax.device_get(h)))


def _run_port(name, kw, poison, sentinel=True):
    to = _topt(name, sentinel=sentinel, **kw)
    state = to.init({k: torch.tensor(v) for k, v in _params().items()})
    state = to.apply({k: torch.tensor(v) for k, v in _grads(False).items()},
                     state)[1]
    if poison:
        _poison_state_port(state)
    out = to.apply({k: torch.tensor(v) for k, v in _grads(poison).items()},
                   state)
    return out


def _state_arrays(state):
    """Every tensor of an OptState, codes as their packed bytes."""
    out = {}
    for path, leaf in state.leaves.items():
        for f in dataclasses.fields(leaf):
            v = getattr(leaf, f.name)
            if isinstance(v, PackedCodes):
                v = v.packed
            if isinstance(v, torch.Tensor):
                out[f"{path}.{f.name}"] = v
    return out


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


CASES = [(a, {}) for a in ("adam8", "adamw8", "momentum8", "lamb8", "lars8",
                           "adagrad8")]
CASES += [(a, {"stochastic_rounding": True})
          for a in ("adam8", "momentum8", "lamb8", "adagrad8")]
CASES += [(a, {"state_bits": (4, 8)})
          for a in ("adam8", "momentum8", "lars8", "adagrad8")]
CASES += [("adamw8", {"state_bits": (4, 8), "stochastic_rounding": True}),
          ("adam8", {"blockwise_norm": False}),
          ("momentum8", {"blockwise_norm": False}),
          ("adam32", {}), ("muon8", {}),
          ("muon8", {"state_bits": (4, 8), "stochastic_rounding": True})]


def _case_id(case):
    name, kw = case
    return name + "".join(f"-{k}={v}" for k, v in kw.items())


@pytest.mark.parametrize("poison", [False, True], ids=["clean", "poisoned"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_sentinel_health_matches_jax(case, poison):
    """The port's summed health vector equals the JAX package's, clean and
    with NaN / +-inf / 1e31 planted in the grad and inf in the state, for
    every algorithm, 8-bit and (4, 8), deterministic and stochastic,
    tensor-wise, 32-bit leaves and muon8; params equal the JAX package's;
    and the port's params and state with the sentinel on are bit for bit
    those with it off."""
    name, kw = case
    jp, jh = _run_jax(name, kw, poison)
    tp, ts, th = _run_port(name, kw, poison)
    assert th.shape == (kfu.N_HEALTH,)
    np.testing.assert_array_equal(th.numpy(), jh)
    if poison:
        h = dict(zip(kfu.HEALTH_SLOTS, th.tolist()))
        assert h["nonfinite_grad"] >= 1 and h["nonfinite_update"] >= 1
    else:
        assert th[:4].sum() == 0 and th[6:].sum() == 0
    rtol = 1e-5 if name[:4] in ("lamb", "lars", "muon") else 0
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), jp[k], rtol=rtol, atol=0,
                                   err_msg=k)
    tp_off, ts_off = _run_port(name, kw, poison, sentinel=False)
    for k in tp:
        assert torch.equal(_bits(tp[k]), _bits(tp_off[k])), k
    on, off = _state_arrays(ts), _state_arrays(ts_off)
    assert on.keys() == off.keys()
    for k in on:
        assert torch.equal(_bits(on[k]), _bits(off[k])), k


def test_sentinel_counts_raw_grad_after_clip():
    """A NaN injected after the train step's in-place clip is still counted
    on the raw grad, before gnorm_scale (percentile clipping engaged)."""
    to = _topt("adam8", sentinel=True, percentile_clipping=5,
               pclip_history=2)
    state = to.init({k: torch.tensor(v) for k, v in _params().items()})
    for poison in (False, True):
        grads = {k: torch.tensor(v) for k, v in _grads(False).items()}
        if poison:
            for g in grads.values():
                g.mul_(0.5)                 # the clip's in-place scale
            grads["a"][7] = float("nan")
        _, state, h = to.apply(grads, state)
    assert h[0] == 1 and h[1] >= 1


def test_pclip_scale_matches_jax_step():
    """The train step reports percentile clipping's scale as pclip_scale,
    as the JAX step does (percentile_clipping=5 on the tiny model, from the
    same weights and batches): rtol 2e-4, the loss traces' tolerance."""
    from repro.models import model as jm
    from repro_torch import convert
    kw = dict(lr=5e-3, percentile_clipping=5, pclip_history=3,
              sentinel=True)
    jo = jopt.make_optimizer("adamw8", pooled=False, **kw)
    jstate, _ = JL.init_train_state(tiny_cfg(), jo, jax.random.PRNGKey(0))
    jstep = JL.jit_train_step(tiny_cfg(), jo)
    params, _ = jm.init_model(tiny_cfg(), jax.random.PRNGKey(0))
    model = convert.params_from_numpy(jax.device_get(params), _tcfg(),
                                      device="cpu")
    to = topt.make_optimizer("adamw8", device="cpu", **kw)
    tstate = TL.TrainState(to.init(model.param_dict()), 0)
    tstep = TL.make_train_step(model.cfg, model, to)
    scales = []
    for i in range(6):
        batch = tiny_pipe().batch_at(i)
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        tstate, tm_ = tstep(tstate, batch)
        scales.append((float(tm_["pclip_scale"]),
                       float(jm_["pclip_scale"])))
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                                   rtol=2e-4)
        assert float(tm_["sent_nonfinite_grad"]) == 0
    got, want = zip(*scales)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert min(got) < 1.0                 # the clip engaged
    _, state, step = _fresh(0)            # percentile clipping off
    assert "pclip_scale" not in step(state, tiny_pipe().batch_at(0))[1]


def test_apply_returns_three_tuple_only_with_sentinel():
    grads = {k: torch.tensor(v) for k, v in _grads(False).items()}
    to = _topt("adam8")
    assert len(to.apply(grads, to.init(
        {k: torch.tensor(v) for k, v in _params().items()}))) == 2
    to = _topt("adam8", sentinel=True)
    out = to.apply(grads, to.init(
        {k: torch.tensor(v) for k, v in _params().items()}))
    assert len(out) == 3 and out[2].dtype == torch.float32


def test_health_rows_folds_per_tensor_absmax():
    """An absmax vector shorter than n_blocks (a per-tensor absmax) folds
    its counts into row 0, as the JAX package's health_rows does."""
    from repro.kernels import fused_update as jfu
    rng = np.random.RandomState(0)
    g = rng.randn(3, 8).astype(np.float32)
    g[1, 2] = np.nan
    p2 = rng.randn(3, 8).astype(np.float32)
    c1 = rng.randint(0, 256, (3, 8)).astype(np.uint8)
    c1[0, :3] = (0, 255, 255)
    a1 = np.array([np.inf], np.float32)
    a2 = np.array([1e31, 2.0, np.nan], np.float32)
    c2 = rng.randint(0, 16, (3, 8)).astype(np.int32)
    want = jfu.health_rows(jnp.asarray(g), jnp.asarray(p2), jnp.asarray(c1),
                           jnp.asarray(a1), jnp.asarray(c2), jnp.asarray(a2),
                           8, 4)
    got = kfu.health_rows(torch.tensor(g), torch.tensor(p2),
                          torch.tensor(c1), torch.tensor(a1),
                          torch.tensor(c2), torch.tensor(a2), 8, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert kfu.HEALTH_SLOTS == jfu.HEALTH_SLOTS
    assert kfu.ABSMAX_OVERFLOW_THRESHOLD == jfu.ABSMAX_OVERFLOW_THRESHOLD


# ------------------------------------------------------ anomaly detector
def test_detector_nonfinite_loss_is_fatal():
    det = tel.AnomalyDetector()
    evs = det.observe_step(3, {"loss": float("nan"), "grad_norm": 1.0})
    assert [e["reason"] for e in evs] == ["nonfinite_loss"]
    assert evs[0]["severity"] == "fatal" and evs[0]["step"] == 3
    assert tel.validate_event(evs[0]) == []
    assert jexport.validate_event(evs[0]) == []
    assert det.worst_severity() == "fatal"


def test_detector_sentinel_counts_escalate():
    det = tel.AnomalyDetector()
    evs = det.observe_step(1, {"loss": torch.tensor(1.0), "grad_norm": 1.0,
                               "sent_nonfinite_grad": torch.tensor(2.0),
                               "sent_absmax_overflow_m": 1.0})
    reasons = {e["reason"]: e for e in evs}
    assert reasons["sentinel_nonfinite"]["severity"] == "fatal"
    assert reasons["sentinel_nonfinite"]["value"] == 2.0
    assert reasons["absmax_overflow"]["severity"] == "error"
    for ev in evs:
        assert jexport.validate_event(ev) == [], ev


@pytest.mark.parametrize("kind", ["spike", "flat"])
def test_detector_loss_window(kind):
    """A loss spike over the trailing window escalates; a perfectly flat
    window scores 0 (no division by zero)."""
    det = tel.AnomalyDetector(window=5, loss_z=4.0)
    for i in range(5):
        loss = 1.0 + (0.01 * (i % 2) if kind == "spike" else 0.0)
        assert det.observe_step(i, {"loss": loss, "grad_norm": 1.0}) == []
    evs = det.observe_step(5, {"loss": 100.0 if kind == "spike" else 1.0,
                               "grad_norm": 1.0})
    assert any(e["reason"] == "loss_spike" for e in evs) == (kind == "spike")


@pytest.mark.parametrize("pclip,severity", [(0.2, "warn"), (None, "error")])
def test_detector_gnorm_spike_pclip_crosscheck(pclip, severity):
    det = tel.AnomalyDetector(window=5, gnorm_factor=10.0)
    for i in range(5):
        det.observe_step(i, {"loss": 1.0, "grad_norm": 1.0})
    m = {"loss": 1.0, "grad_norm": 50.0}
    if pclip is not None:
        m["pclip_scale"] = pclip
    spike = [e for e in det.observe_step(5, m) if e["reason"] == "gnorm_spike"]
    assert spike and spike[0]["severity"] == severity


def test_detector_qhealth_escalation():
    det = tel.AnomalyDetector(qhealth_edge=0.05)
    evs = det.observe_qhealth([
        {"kind": "qhealth", "step": 2, "target": "leaf", "segment": "b",
         "slot": "m", "saturation_fraction": 1.0,
         "edge_code_fraction": 1.0 / 256},
        {"kind": "qhealth", "step": 2, "target": "leaf", "segment": "a",
         "slot": "m", "saturation_fraction": 1.0,
         "edge_code_fraction": 0.5},
        {"kind": "qhealth", "step": 2, "target": "leaf", "segment": "c",
         "slot": "r", "edge_code_fraction": 0.0, "absmax_drift": 50.0},
    ])
    assert [e["severity"] for e in evs] == ["error", "warn"]
    assert "edge_code_fraction" in evs[0]["detail"]
    assert "absmax_drift" in evs[1]["detail"]
    for ev in evs:
        assert jexport.validate_event(ev) == []


# --------------------------------------------- anomaly-injection e2e
def _tcfg():
    return tcb.reduced(tcb.get_config("paper-lm-209m"), d_model=64,
                       n_layers=2, vocab_size=128)


def _blowup_opt():
    return topt.make_optimizer("adam8", lr=1e18, min_8bit_size=256,
                               override_32bit=lambda p: False, sentinel=True,
                               device="cpu")


def _fresh(seed):
    opt = _blowup_opt()
    state, model = TL.init_train_state(
        _tcfg(), opt, torch.Generator().manual_seed(seed), device="cpu")
    return opt, state, TL.make_train_step(model.cfg, model, opt)


def _leaves(tree):
    return [(k, v.packed if isinstance(v, PackedCodes) else v)
            for k, v in TC._flatten(tree)]


def test_anomaly_injection_e2e(tmp_path):
    """lr=1e18 until a fatal anomaly: the dump holds the step before it
    (snapshot_step == trigger - 1) as a host copy, restores bit for bit
    into a fresh state, replays the trigger step to the recorded loss,
    restores into the JAX package's checkpoint reader, and scores 1 under
    both inspectors."""
    pipe = tiny_pipe()
    _, state, step = _fresh(0)
    det, fr = tel.AnomalyDetector(), tel.FlightRecorder(ring=8)
    last_healthy = None
    for i in range(40):
        state, m = step(state, pipe.batch_at(i))
        evs = det.observe_step(i, m)
        for ev in evs:
            fr.note_anomaly(ev)
        fr.record(i, m)
        if any(e["severity"] == "fatal" for e in evs):
            k, m_blow = i, m
            dump = fr.dump(str(tmp_path / "dump"), reason=evs[0]["reason"],
                           trigger_step=i, config=_tcfg())
            break
        fr.snapshot(i, state)
        last_healthy = [(key, v.clone() if isinstance(v, torch.Tensor)
                         else v) for key, v in _leaves(state)]
    else:
        pytest.fail("lr=1e18 did not produce a fatal anomaly in 40 steps")
    assert fr.snapshot_step == k - 1
    manifest = tel.load_dump(dump)
    assert manifest["trigger_step"] == k
    assert manifest["snapshot_step"] == k - 1
    assert manifest["config_hash"] == tel.config_hash(_tcfg())
    assert [r["step"] for r in manifest["ring"]][-1] == k
    assert manifest["anomalies"]
    for ev in manifest["anomalies"]:
        assert jexport.validate_event(ev) == [], ev
    # the live state moved on (in place); the snapshot did not
    _, fresh, fresh_step = _fresh(5)
    snap_step, restored = tel.restore_state(dump, fresh)
    assert snap_step == k - 1
    for (ka, a), (kb, b) in zip(_leaves(restored), last_healthy):
        assert ka == kb
        if isinstance(a, torch.Tensor):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), ka
        else:
            assert a == b, ka
    _, m_replay = fresh_step(restored, pipe.batch_at(k))
    a, b = float(m_replay["loss"]), float(m_blow["loss"])
    assert a == b or not (np.isfinite(a) or np.isfinite(b))
    # the dump is a JAX-format checkpoint
    jo = jopt.make_optimizer("adam8", lr=1e18, min_8bit_size=256,
                             override_32bit=lambda p: False, sentinel=True,
                             pooled=False)
    jstate, _ = JL.init_train_state(tiny_cfg(), jo, jax.random.PRNGKey(0))
    got = JC.restore(os.path.join(dump, "state"), k - 1,
                     jax.eval_shape(lambda s: s, jstate))
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(got)[0]}
    assert len(flat) == len(last_healthy)
    for key, v in last_healthy:
        w = np.asarray(v, np.int32) if isinstance(v, int) else v.numpy()
        np.testing.assert_array_equal(flat[key], w, err_msg=key)
    assert insp.main(["--flight", dump]) == insp.EXIT_ANOMALIES
    assert jinsp.main(["--flight", dump]) == jinsp.EXIT_ANOMALIES


def test_flight_snapshot_is_a_host_copy():
    """The port updates state in place: a snapshot must copy, or the next
    step would overwrite the resume point."""
    _, state, step = _fresh(0)
    fr = tel.FlightRecorder()
    state, _ = step(state, tiny_pipe().batch_at(0))
    fr.snapshot(0, state)
    before = [v.clone() for _, v in _leaves(fr._snap_state)
              if isinstance(v, torch.Tensor)]
    state, _ = step(state, tiny_pipe().batch_at(1))
    after = [v for _, v in _leaves(fr._snap_state)
             if isinstance(v, torch.Tensor)]
    assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
               for a, b in zip(before, after))
    live = [v for _, v in _leaves(state) if isinstance(v, torch.Tensor)]
    assert not all(torch.equal(a, b) for a, b in zip(live, after))
    assert isinstance(fr._snap_state.opt_state.leaves["head/w"],
                      (Quant8Leaf, Full32Leaf))


def test_flight_snapshot_every():
    fr = tel.FlightRecorder(snapshot_every=3)
    for i in range(5):
        fr.snapshot(i, {"x": torch.full((2,), float(i))})
    assert fr.snapshot_step == 3
    assert fr._snap_state["x"][0] == 3.0


# --------------------------------------------------------- flight basics
def test_flight_ring_is_bounded_and_scalarized():
    fr = tel.FlightRecorder(ring=3)
    for i in range(10):
        fr.record(i, {"loss": torch.tensor(float(i)),
                      "junk": torch.zeros(4)}, wall_s=0.1)
    assert [r["step"] for r in fr._ring] == [7, 8, 9]
    assert fr._ring[-1]["loss"] == 9.0
    assert "junk" not in fr._ring[-1]


def test_flight_dump_without_snapshot(tmp_path):
    fr = tel.FlightRecorder()
    fr.record(0, {"loss": 1.0})
    d = fr.dump(str(tmp_path / "d"), reason="test", trigger_step=0)
    assert tel.load_dump(d)["snapshot_step"] is None
    with pytest.raises(ValueError, match="no state snapshot"):
        tel.restore_state(d, template=None)


def test_flight_jsonl_tail_embedded(tmp_path):
    jl = tmp_path / "telemetry.jsonl"
    rows = [{"kind": "phase", "schema": tel.SCHEMA, "step": i,
             "phase": "step", "wall_s": 0.1} for i in range(5)]
    jl.write_text("".join(json.dumps(r) + "\n" for r in rows))
    d = tel.FlightRecorder().dump(str(tmp_path / "d"), reason="t",
                                  trigger_step=4, telemetry_path=str(jl),
                                  tail=3)
    assert [e["step"] for e in tel.load_dump(d)["jsonl_tail"]] == [2, 3, 4]
    assert tel.FLIGHT_SCHEMA == "repro.flight.v1"


# ----------------------------------------------------------- inspector
def _write_run(dirpath, events):
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, "telemetry.jsonl"), "w") as f:
        for ev in events:
            f.write(json.dumps({"schema": tel.SCHEMA, **ev}) + "\n")
    return dirpath


def _clean_events():
    return [
        {"kind": "metric", "step": 9, "name": "train/loss",
         "type": "gauge", "value": 2.5},
        {"kind": "phase", "step": 1, "phase": "step", "wall_s": 0.2},
        {"kind": "trace", "step": 0,
         "phases": [{"phase": "optimizer_update", "dispatches": 3,
                     "trace_s": 0.01}]},
        {"kind": "qhealth", "step": 5, "target": "leaf", "segment": "a",
         "slot": "m", "saturation_fraction": 0.01, "util_hist": [1, 2],
         "util_fraction": 0.5, "absmax_mean": 0.1, "absmax_drift": 1.0},
    ]


def test_inspector_exit_codes(tmp_path):
    clean = _write_run(str(tmp_path / "clean"), _clean_events())
    assert insp.main([clean]) == insp.EXIT_CLEAN
    anom = _write_run(str(tmp_path / "anom"), _clean_events() + [
        {"kind": "anomaly", "step": 7, "reason": "loss_spike",
         "severity": "warn", "value": 9.0}])
    assert insp.main([anom]) == insp.EXIT_ANOMALIES
    bad = _write_run(str(tmp_path / "bad"), [
        {"kind": "anomaly", "step": 7, "reason": "x",
         "severity": "catastrophic", "value": 1.0}])
    assert insp.main([bad]) == insp.EXIT_SCHEMA
    assert insp.main([str(tmp_path / "nonexistent")]) == insp.EXIT_SCHEMA
    assert (insp.EXIT_CLEAN, insp.EXIT_ANOMALIES, insp.EXIT_SCHEMA) == (
        0, 1, 2)


def test_inspector_validate_subcommand(tmp_path):
    clean = _write_run(str(tmp_path / "clean"), _clean_events())
    assert insp.main(["--validate", clean]) == insp.EXIT_CLEAN
    bad = _write_run(str(tmp_path / "bad"), [{"kind": "metric", "step": 0}])
    assert insp.main(["--validate", bad]) == insp.EXIT_SCHEMA


def test_inspector_diff(tmp_path):
    a = _write_run(str(tmp_path / "a"), _clean_events())
    b = _write_run(str(tmp_path / "b"), _clean_events() + [
        {"kind": "anomaly", "step": 3, "reason": "gnorm_spike",
         "severity": "error", "value": 12.0}])
    assert insp.main(["--diff", a, a]) == insp.EXIT_CLEAN
    assert insp.main(["--diff", a, b]) == insp.EXIT_ANOMALIES
