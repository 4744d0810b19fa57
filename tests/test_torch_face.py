"""The ``torch.optim.Optimizer`` face of the port's engine
(``repro_torch.core.optim.BlockOptimizer``) and the quickstart that drives
it (``examples/quickstart_torch.py``), on the CPU.

The face adds no arithmetic: ``step()`` is the engine's ``apply`` on the
parameters' ``.grad``, so it is held to the train loop's pooled ``apply``
bit for bit, and its ``state_dict`` to the checkpoint's keys and tensors
exactly.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import base as tcb
from repro_torch.core import optim as topt
from repro_torch.errors import ConfigError
from repro_torch.models import model as M
from repro_torch.train import checkpoint as TC
from repro_torch.train import loop as TL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = tcb.reduced(tcb.get_config("paper-lm-209m"), d_model=64, n_layers=2,
                  vocab_size=128)


def _batch(i):
    return np.random.RandomState(i).randint(0, 128, (4, 17))


def _model(seed=0):
    return M.init_model(CFG, torch.Generator().manual_seed(seed),
                        device="cpu")


def _face_steps(opt, model, steps, start=0):
    """The plain PyTorch loop with the repo's global-norm clip."""
    for i in range(start, start + steps):
        tokens = torch.as_tensor(_batch(i))
        logits, _ = M.forward(CFG, model, tokens[:, :-1])
        TL.cross_entropy(logits, tokens[:, 1:]).backward()
        TL.clip_by_global_norm({k: p.grad for k, p in
                                model.named_parameters()}, 1.0)
        opt.step()
        opt.zero_grad()


def _equal_trees(a, b):
    fa, fb = TC._flatten(a), TC._flatten(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (key, x), (_, y) in zip(fa, fb):
        x, y = getattr(x, "packed", x), getattr(y, "packed", y)
        assert (x == y) if isinstance(x, int) else torch.equal(x, y), key


@pytest.mark.parametrize("name,kw", [
    ("adamw8", {}), ("lamb8", {"state_bits": (4, 8),
                               "stochastic_rounding": True}),
    ("adamw8", {"pooled": False})], ids=["adamw8", "lamb8-4-8-sr",
                                         "adamw8-per-leaf"])
def test_face_step_is_the_engine_apply(name, kw):
    """Two steps through the face and the plain loop equal two train
    steps through ``make_train_step`` (pooled ``apply``, the clip written
    into the arena's gradient views), bit for bit."""
    model_a = _model()
    opt = topt.make_optimizer(name, lr=1e-2, device="cpu", **kw)
    state = TL.TrainState(opt.init(model_a.param_dict()), 0)
    step = TL.make_train_step(CFG, model_a, opt)
    for i in range(2):
        state, _ = step(state, {"tokens": _batch(i)})
    model_b = _model()
    face = topt.BlockOptimizer(model_b.named_parameters(), name, lr=1e-2,
                               device="cpu", **kw)
    assert isinstance(face, torch.optim.Optimizer)
    assert face.paths == list(model_b.param_dict())
    _face_steps(face, model_b, 2)
    _equal_trees(face.opt_state, state.opt_state)
    for (k, a), (_, b) in zip(model_a.named_parameters(),
                              model_b.named_parameters()):
        assert torch.equal(a, b), k
    assert all(p.grad is None for p in model_b.parameters())


def test_face_reads_lr_from_its_param_group():
    """``step()`` takes the group's lr (an lr scheduler's handle): at lr 0
    adamw moves nothing, and a scheduler's lr reaches the engine."""
    model = _model()
    face = topt.BlockOptimizer(model.named_parameters(), "adamw8", lr=1e-2,
                               weight_decay=0.01, device="cpu")
    before = [p.detach().clone() for p in model.parameters()]
    sched = torch.optim.lr_scheduler.LambdaLR(
        face, lambda s: 0.0 if s == 0 else 0.5)
    assert face.param_groups[0]["lr"] == 0.0
    _face_steps(face, model, 1)
    assert all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
    sched.step()
    assert face.param_groups[0]["lr"] == pytest.approx(5e-3)
    _face_steps(face, model, 1, start=1)
    assert not all(torch.equal(a, p)
                   for a, p in zip(before, model.parameters()))


def test_face_state_dict_is_the_checkpoint(tmp_path):
    """``state_dict`` holds the checkpoint's keys and tensors; it restores
    into a fresh pooled face and a fresh per-leaf face, and a checkpoint
    restores into a face through ``checkpoint.read``; the next step from
    each equals the uninterrupted one."""
    model = _model()
    face = topt.BlockOptimizer(model.named_parameters(), "adam8", lr=1e-2,
                               state_bits=(4, 8), device="cpu")
    _face_steps(face, model, 2)
    sd = face.state_dict()
    path = TC.save(str(tmp_path), 2, face.opt_state)
    manifest = TC.read(str(tmp_path), 2)
    assert list(sd["state"]) == list(manifest["state"])
    assert sd["packed"] == manifest["packed"] and sd["packed"]
    for key, v in sd["state"].items():
        np.testing.assert_array_equal(np.asarray(v), manifest["state"][key],
                                      err_msg=key)
    assert sd["param_groups"] == [{"lr": 1e-2}]
    assert os.path.isdir(path)
    sd = {"state": {k: v if isinstance(v, int) else v.clone()
                    for k, v in sd["state"].items()},
          "packed": sd["packed"], "param_groups": [{"lr": 2e-2}]}
    others = []
    for source, kw in ((sd, {}), (sd, {"pooled": False}),
                       (manifest, {})):
        m = _model(seed=9)
        other = topt.BlockOptimizer(m.named_parameters(), "adam8", lr=1e-2,
                                    state_bits=(4, 8), device="cpu", **kw)
        other.load_state_dict(source)
        assert (other.opt_state.arena is None) == ("pooled" in kw)
        assert other.opt_state.step == 2
        others.append((other, m))
    assert others[0][0].param_groups[0]["lr"] == 2e-2
    face.param_groups[0]["lr"] = 2e-2
    _face_steps(face, model, 1, start=2)
    for other, m in others:
        other.param_groups[0]["lr"] = 2e-2
        _face_steps(other, m, 1, start=2)
        _equal_trees(other.opt_state, face.opt_state)
        for a, b in zip(model.parameters(), m.parameters()):
            assert torch.equal(a, b)


def test_face_has_one_param_group():
    model = _model()
    with pytest.raises(ConfigError):
        topt.BlockOptimizer([{"params": list(model.named_parameters())}],
                            "adamw8", device="cpu")
    face = topt.BlockOptimizer(model.named_parameters(), "adamw8",
                               device="cpu")
    with pytest.raises(ConfigError):
        face.add_param_group({"params": [torch.zeros(3)]})
    with pytest.raises(ValueError, match="gradient"):
        face.step()


def test_quickstart_runs_on_the_cpu():
    """``examples/quickstart_torch.py --device cpu --steps 2``: both runs
    finish, and the summary shows the pooled quantized run's single fused
    dispatch per step and its smaller state."""
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "quickstart_torch.py"),
         "--device", "cpu", "--steps", "2"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = {line[:28].strip(): line[28:].split()
            for line in out.stdout.splitlines()[-5:]}
    assert rows["fused dispatches/step"] == ["0", "1"]
    b32, b8 = map(float, rows["state bytes/param"])
    assert b32 == 8.0 and b8 < 3.1
    l32, l8 = map(float, rows["final loss"])
    assert abs(l32 - l8) < 0.05 * l32
