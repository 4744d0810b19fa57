"""The port's two remaining examples, run on the CPU through
``subprocess`` with ``--device cpu`` (as ``test_torch_face.py`` runs the
quickstart):

  * ``examples/finetune_override_torch.py``: a short run to a finite
    loss, and every leaf's state kind (through ``unpool_state``) equal to
    the JAX example's (``examples/finetune_override.py``: its override and
    configuration, its optimizer's ``init`` through the JAX package's
    ``unpool_state``);
  * ``examples/serve_lm_torch.py``: all 8 mixed requests come back with
    exactly their ``max_new_tokens`` tokens, each a token id of the
    vocabulary.
"""
import importlib.util
import math
import os
import re
import subprocess
import sys

import jax

from repro.configs import base as JB
from repro.core.optim import Full32Leaf, Quant8Leaf, make_optimizer
from repro.core.optim import unpool_state
from repro.core.optim.base import path_str
from repro.train import loop as JL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(name, *args) -> str:
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", name), "--device",
         "cpu", *args], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def _jax_example_kinds() -> dict:
    """{path: state kind} of the JAX example's optimizer state."""
    spec = importlib.util.spec_from_file_location(
        "finetune_override", os.path.join(ROOT, "examples",
                                          "finetune_override.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    cfg = JB.reduced(JB.get_config("granite-3-8b"), d_model=128, n_layers=2,
                     vocab_size=256)
    opt = make_optimizer("adamw8", lr=3e-3, weight_decay=0.01,
                         override_32bit=example.my_override)
    state, _ = JL.init_train_state(cfg, opt, jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_flatten_with_path(
        unpool_state(state.opt_state).leaves,
        is_leaf=lambda x: isinstance(x, (Quant8Leaf, Full32Leaf)))[0]
    return {path_str(p): type(leaf).__name__ for p, leaf in leaves}


def test_finetune_override_example_runs_on_the_cpu():
    out = _run("finetune_override_torch.py", "--steps", "3")
    kinds = dict(re.findall(r"^state kind: (\S+) (\w+)$", out, re.M))
    assert kinds == _jax_example_kinds()
    assert kinds["embed/table"] == kinds["final_norm/scale"] == "Full32Leaf"
    assert "Quant8Leaf" in kinds.values()
    loss = float(re.search(r"^final loss: (\S+) after 3 steps", out,
                           re.M).group(1))
    assert math.isfinite(loss)


def test_serve_lm_example_runs_on_the_cpu():
    out = _run("serve_lm_torch.py")
    got = re.findall(r"^request (\d+): P=\s*(\d+) max_new=\s*(\d+) -> "
                     r"\[([\d, ]*)\]$", out, re.M)
    assert [int(rid) for rid, *_ in got] == list(range(8))
    for _, _, max_new, toks in got:
        toks = [int(t) for t in toks.split(",")]
        assert len(toks) == int(max_new)
        assert all(0 <= t < 512 for t in toks)
    assert "latency:" in out
