"""Subprocess smokes of the port's train launcher, ``python -m
repro_torch.launch.train --device cpu``, at d_model 64, 2 layers, vocab
256 (seq 32, batch 4): a clean run with the sentinel, telemetry and the
flight recorder; a diverging run (``--lr 1e18``, exit 2, a dump); resume
from ``--ckpt-dir``; and the loss trace against the JAX launcher
(``python -m repro.launch.train``) from the same weights and batches, at
the golden tests' rtol 2e-4."""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import base as jcfgs
from repro.core import optim as jopt
from repro.telemetry import export as jexport
from repro.train import checkpoint as JC
from repro.train import loop as JL
from repro_torch.telemetry import export as texport

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--d-model", "64", "--n-layers", "2", "--vocab", "256",
         "--seq-len", "32", "--batch", "4"]


def _run(module, *args, cwd):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def _port(*args, cwd):
    return _run("repro_torch.launch.train", "--device", "cpu", *SMALL, *args,
                cwd=cwd)


def _losses(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_clean_sentinel_run_writes_valid_telemetry(tmp_path):
    r = _port("--steps", "6", "--sentinel", "--telemetry-dir", "tel",
              "--telemetry-every", "3", "--flight-dir", "flight", "--out",
              "m.jsonl", cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    path = str(tmp_path / "tel" / "telemetry.jsonl")
    events, errors = texport.validate_jsonl(path)
    assert errors == []
    jevents, jerrors = jexport.validate_jsonl(path)
    assert jerrors == [] and jevents == events
    kinds = [e["kind"] for e in events]
    assert "anomaly" not in kinds and kinds.count("trace") == 1
    q = [e for e in events if e["kind"] == "qhealth"]
    assert sorted({e["step"] for e in q}) == [2, 5]
    sent = {e["name"]: e["value"] for e in events if e["kind"] == "metric"
            and e["name"].startswith("train/sent_")}
    assert len(sent) == 8
    assert all(sent[f"train/sent_{s}"] == 0 for s in (
        "nonfinite_grad", "nonfinite_update", "absmax_overflow_m"))
    assert not (tmp_path / "flight").exists()        # nothing triggered
    assert len(_losses(tmp_path / "m.jsonl")) == 6
    for module in ("repro_torch.telemetry.inspect", "repro.telemetry.inspect"):
        r = _run(module, str(tmp_path / "tel"), cwd=tmp_path)
        assert r.returncode == 0, r.stdout + r.stderr
        r = _run(module, "--validate", str(tmp_path / "tel"), cwd=tmp_path)
        assert r.returncode == 0 and "VALID" in r.stdout


def test_divergence_exits_2_with_a_flight_dump(tmp_path):
    r = _port("--steps", "6", "--lr", "1e18", "--sentinel",
              "--telemetry-dir", "tel", "--flight-dir", "flight",
              cwd=tmp_path)
    assert r.returncode == 2, r.stdout + r.stderr
    assert "[diverged]" in r.stdout
    with open(tmp_path / "flight" / "flight.json") as f:
        manifest = json.load(f)
    k = manifest["trigger_step"]
    assert manifest["snapshot_step"] == k - 1
    assert os.path.isdir(tmp_path / "flight" / "state" / f"step_{k - 1:010d}")
    for module in ("repro_torch.telemetry.inspect", "repro.telemetry.inspect"):
        r = _run(module, "--flight", "flight", cwd=tmp_path)
        assert r.returncode == 1, r.stdout + r.stderr
    events, errors = jexport.validate_jsonl(
        str(tmp_path / "tel" / "telemetry.jsonl"))
    assert errors == []
    assert any(e["kind"] == "anomaly" and e["severity"] == "fatal"
               for e in events)


def test_resume_continues_the_loss_trace_bit_exactly(tmp_path):
    r = _port("--steps", "6", "--ckpt-dir", "full", "--ckpt-every", "3",
              "--out", "full.jsonl", "--optimizer", "adam8",
              "--state-bits", "4,8", cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    os.makedirs(tmp_path / "part")
    shutil.copytree(tmp_path / "full" / "step_0000000003",
                    tmp_path / "part" / "step_0000000003")
    r = _port("--steps", "6", "--ckpt-dir", "part", "--ckpt-every", "3",
              "--out", "part.jsonl", "--optimizer", "adam8",
              "--state-bits", "4,8", cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[resume] from step 3" in r.stdout
    full, part = _losses(tmp_path / "full.jsonl"), _losses(
        tmp_path / "part.jsonl")
    assert [x["step"] for x in part] == [3, 4, 5]
    assert [x["loss"] for x in part] == [x["loss"] for x in full[3:]]
    assert [x["grad_norm"] for x in part] == [x["grad_norm"]
                                              for x in full[3:]]


def test_loss_trace_matches_the_jax_launcher(tmp_path):
    """Both launchers resume from one JAX-written step-0 checkpoint (the
    weights the JAX launcher draws from its seed) and train 5 steps on the
    same batches: losses and grad norms within rtol 2e-4."""
    cfg = jcfgs.get_config("paper-lm-209m")
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32", remat="none",
                              d_model=64, head_dim=64 // cfg.n_heads,
                              n_layers=2, vocab_size=256)
    opt = jopt.make_optimizer("adam8", lr=1e-3, weight_decay=0.0,
                              sentinel=True)
    state, _ = JL.init_train_state(cfg, opt, jax.random.PRNGKey(0))
    JC.save(str(tmp_path / "jax"), 0, state)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    common = ["--steps", "5", "--sentinel", "--ckpt-every", "100"]
    r = _run("repro.launch.train", *SMALL, *common, "--ckpt-dir", "jax",
             "--out", "jax.jsonl", cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    r = _port(*common, "--ckpt-dir", "port", "--out", "port.jsonl",
              cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[resume] from step 0" in r.stdout
    j, t = _losses(tmp_path / "jax.jsonl"), _losses(tmp_path / "port.jsonl")
    assert [x["step"] for x in t] == [x["step"] for x in j] == list(range(5))
    np.testing.assert_allclose([x["loss"] for x in t],
                               [x["loss"] for x in j], rtol=2e-4)
    np.testing.assert_allclose([x["grad_norm"] for x in t],
                               [x["grad_norm"] for x in j], rtol=2e-4)
    assert t[-1]["loss"] < t[0]["loss"]


def test_launcher_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    """The default device is the card: without one the launcher raises
    (no quiet fall back to the CPU)."""
    import torch
    from repro_torch.launch import train as launcher
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main([*SMALL, "--steps", "1"])
    assert launcher.build_parser().parse_args([]).device == "cuda"
