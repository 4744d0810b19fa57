"""Checkpoints across packages: the port writes and reads the JAX package's
format (``leaves.npz`` + ``manifest.json``, arrays keyed by
``jax.tree_util.keystr``), so a JAX-written 8-bit state restores into the
port and trains on, and a port-written one restores into JAX.  The key
strings are taken from the JAX side, never written by hand.  The rest
mirrors ``tests/test_checkpoint.py`` in the port."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg, tiny_pipe

from repro.core import optim as jopt
from repro.train import checkpoint as JC
from repro.train import loop as JL
from repro_torch.configs import base as tcb
from repro_torch.core import optim as topt
from repro_torch.core.lowbit import PackedCodes
from repro_torch.errors import ConfigError
from repro_torch.train import checkpoint as TC
from repro_torch.train import loop as TL

LR = 5e-3


def _tcfg():
    return tcb.reduced(tcb.get_config("paper-lm-209m"), d_model=64,
                       n_layers=2, vocab_size=128)


def _jax_run(name, steps, **kw):
    jo = jopt.make_optimizer(name, lr=LR, weight_decay=0.01, **kw)
    state, _ = JL.init_train_state(tiny_cfg(), jo, jax.random.PRNGKey(0))
    return jo, state, JL.jit_train_step(tiny_cfg(), jo)


def _jbatch(i):
    return {k: jnp.asarray(v) for k, v in tiny_pipe().batch_at(i).items()}


def _port(name, seed=1, **kw):
    to = topt.make_optimizer(name, lr=LR, weight_decay=0.01, device="cpu",
                             **kw)
    state, model = TL.init_train_state(_tcfg(), to,
                                       torch.Generator().manual_seed(seed),
                                       device="cpu")
    return to, state, model, TL.make_train_step(model.cfg, model, to)


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _tensors(tree):
    return [leaf for _, leaf in TC._flatten(tree)]


@pytest.mark.parametrize("name,kw", [
    ("adamw8", {"pooled": False}), ("adamw8", {}), ("lamb8", {}),
    ("momentum8", {"percentile_clipping": 50, "pclip_history": 3}),
    ("adagrad8", {}), ("adafactor32", {}),
    ("adam8", {"state_bits": (4, 8)}), ("muon8", {"state_bits": (5, 8)}),
    ("muon32", {})])
def test_key_strings_match_jax(tmp_path, name, kw):
    """The port writes the very key strings, dtypes and shapes the JAX
    package writes for the same configuration (a pooled JAX state is
    stored per leaf, so the per-leaf port matches it too)."""
    _, jstate, _ = _jax_run(name, 0, **kw)
    jm = _manifest(JC.save(str(tmp_path / "jax"), 0, jstate))
    kw.pop("pooled", None)
    _, tstate, _, _ = _port(name, **kw)
    tm = _manifest(TC.save(str(tmp_path / "port"), 0, tstate))
    strip = lambda m: sorted((e["key"], e["dtype"], tuple(e["shape"]),
                              str(e.get("packed")))
                             for e in m["index"])
    assert strip(tm) == strip(jm)


@pytest.mark.parametrize("name,kw", [
    ("adamw8", {"pooled": False}), ("adamw8", {}),
    ("adamw8", {"stochastic_rounding": True}), ("lars8", {}),
    ("adam8", {"pooled": False, "state_bits": (4, 8)}),
    ("muon8", {"pooled": False, "state_bits": (4, 8)})])
def test_jax_checkpoint_restores_into_port(tmp_path, name, kw):
    """A JAX-written checkpoint after 2 steps restores into a fresh port
    state (the model's weights included: they are the masters); one more
    step in each package then agrees at the trajectory tolerance."""
    jo, jstate, jstep = _jax_run(name, 2, **kw)
    for i in range(2):
        jstate, _ = jstep(jstate, _jbatch(i))
    JC.save(str(tmp_path), 2, jstate)
    jstate, jm = jstep(jstate, _jbatch(2))
    kw.pop("pooled", None)
    _, tstate, model, tstep = _port(name, **kw)
    tstate = TC.restore(str(tmp_path), 2, tstate)
    assert tstate.step == 2 and tstate.opt_state.step == 2
    tstate, tm = tstep(tstate, tiny_pipe().batch_at(2))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=2e-4)
    jparams = jo.params_view(jstate.opt_state)
    for path, p in model.param_dict().items():
        want = jparams
        for part in path.split("/"):
            want = want[part]
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-6, err_msg=path)


@pytest.mark.parametrize("name,kw", [
    ("adamw8", {"pooled": False}), ("adamw8", {}), ("lamb8", {}),
    ("momentum8", {"percentile_clipping": 50, "pclip_history": 3}),
    ("adagrad8", {"stochastic_rounding": True}), ("adafactor32", {}),
    ("adam8", {"pooled": False, "state_bits": (4, 8)}),
    ("muon8", {"pooled": False, "state_bits": (4, 8)})])
def test_port_checkpoint_restores_into_jax(tmp_path, name, kw):
    """A port-written checkpoint restores through
    ``repro.train.checkpoint.restore`` with array-equal leaves (into a
    pooled JAX state too: the JAX package repools per-leaf checkpoints)."""
    jkw = dict(kw)
    kw.pop("pooled", None)
    _, tstate, _, tstep = _port(name, **kw)
    for i in range(2):
        tstate, _ = tstep(tstate, tiny_pipe().batch_at(i))
    TC.save(str(tmp_path), 2, tstate)
    _, jstate, _ = _jax_run(name, 0, **jkw)
    got = JC.restore(str(tmp_path), 2,
                     jax.eval_shape(lambda s: s, jstate))
    got_c = JC._canonical(got)
    want = {k: leaf.packed if isinstance(leaf, PackedCodes) else leaf
            for k, leaf in TC._flatten(tstate)}
    flat = jax.tree_util.tree_flatten_with_path(
        got_c, is_leaf=JC._is_packed)[0]
    assert len(flat) == len(want)
    for p, leaf in flat:
        key = jax.tree_util.keystr(p)
        if JC._is_packed(leaf):
            leaf = leaf.packed
        w = want[key]
        w = np.asarray(w, np.int32) if isinstance(w, int) else w.numpy()
        np.testing.assert_array_equal(np.asarray(leaf), w, err_msg=key)


@pytest.mark.parametrize("kw", [{}, {"stochastic_rounding": True},
                                {"state_bits": (4, 8),
                                 "stochastic_rounding": True}])
def test_restart_equivalence_bit_exact(tmp_path, kw):
    """Save after 5 steps; 4 more steps from the live state and from the
    restored one (into a fresh state) end bit-identical."""
    _, state, _, step = _port("adam8", **kw)
    pipe = tiny_pipe()
    for i in range(5):
        state, _ = step(state, pipe.batch_at(i))
    TC.save(str(tmp_path), 5, state)
    for i in range(5, 9):
        state, _ = step(state, pipe.batch_at(i))
    _, state_b, _, step_b = _port("adam8", seed=7, **kw)
    state_b = TC.restore(str(tmp_path), 5, state_b)
    for i in range(5, 9):
        state_b, _ = step_b(state_b, pipe.batch_at(i))
    for a, b in zip(_tensors(state), _tensors(state_b)):
        if isinstance(a, int):
            assert a == b
        elif isinstance(a, PackedCodes):
            assert (a.bits, a.n_codes) == (b.bits, b.n_codes)
            assert torch.equal(a.packed, b.packed)
        else:
            assert torch.equal(a, b)


def test_keep_last_pruning(tmp_path):
    _, state, _, _ = _port("adam8")
    for s in [1, 2, 3, 4, 5]:
        TC.save(str(tmp_path), s, state, keep_last=2)
    assert TC.all_steps(str(tmp_path)) == [4, 5]
    assert TC.latest_step(str(tmp_path)) == 5
    assert TC.latest_step(str(tmp_path / "none")) is None


def test_atomic_no_partial_dirs(tmp_path):
    _, state, _, _ = _port("adam8")
    TC.save(str(tmp_path), 7, state)
    assert [f for f in os.listdir(tmp_path) if f.startswith(".tmp_")] == []
    with pytest.raises(TypeError):          # a failed write leaves nothing
        TC.save(str(tmp_path), 8, {"x": object()})
    assert os.listdir(tmp_path) == ["step_0000000007"]


def test_shape_mismatch_rejected(tmp_path):
    _, state, _, _ = _port("adam8")
    TC.save(str(tmp_path), 1, state)
    _, bad, _, _ = _port("adam8", min_8bit_size=10 ** 9)  # all 32-bit
    before = [t.clone() for t in _tensors(bad) if isinstance(t, torch.Tensor)]
    with pytest.raises((ValueError, KeyError)):
        TC.restore(str(tmp_path), 1, bad)
    after = [t for t in _tensors(bad) if isinstance(t, torch.Tensor)]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    path = next(iter(bad.opt_state.leaves))
    leaf = bad.opt_state.leaves[path]
    leaf.m = torch.zeros(leaf.m.shape + (2,))
    _, good, _, _ = _port("adam8")
    good.opt_state.leaves[path].master = torch.zeros(3)
    with pytest.raises(ValueError):
        TC.restore(str(tmp_path), 1, good)


def test_percentile_clipping_state_roundtrip(tmp_path):
    """The gnorm history survives save/restore bit-exactly and a restored
    run continues identically to the uninterrupted one."""
    def fresh():
        opt = topt.make_optimizer("adam8", lr=1e-2, min_8bit_size=256,
                                  percentile_clipping=50, pclip_history=4,
                                  override_32bit=lambda p: False,
                                  device="cpu")
        params = {"w": torch.ones(64, 64), "b": torch.zeros(8)}
        return opt, params, opt.init(params)

    opt, params, st = fresh()
    for _ in range(5):
        _, st = opt.apply({k: 2 * v for k, v in params.items()}, st)
    assert float(st.gnorm_vec.min()) > 0.0
    TC.save(str(tmp_path), 5, st)
    opt_b, params_b, st_b = fresh()
    st_b = TC.restore(str(tmp_path), 5, st_b)
    assert torch.equal(st.gnorm_vec, st_b.gnorm_vec) and st_b.step == 5
    _, sta = opt.apply({k: 2 * v for k, v in params.items()}, st)
    _, stb = opt_b.apply({k: 2 * v for k, v in params_b.items()}, st_b)
    for a, b in zip(_tensors(sta), _tensors(stb)):
        assert (a == b) if isinstance(a, int) else torch.equal(a, b)


def test_packed_and_pooled_checkpoints_raise(tmp_path):
    """Packed codes restore only into packed codes of the same width, and
    plain codes only into plain ones (ValueError, as in the JAX package);
    pooled arenas (A9) are not ported: restoring them raises ConfigError
    naming the item."""
    _, jstate, _ = _jax_run("adam8", 0, pooled=False, state_bits=(4, 8))
    JC.save(str(tmp_path / "packed"), 0, jstate)
    _, tstate, _, _ = _port("adam8")
    with pytest.raises(ValueError, match="packed"):
        TC.restore(str(tmp_path / "packed"), 0, tstate)
    _, tstate5, _, _ = _port("adam8", state_bits=(5, 8))
    with pytest.raises(ValueError, match="4-bit"):
        TC.restore(str(tmp_path / "packed"), 0, tstate5)
    path = TC.save(str(tmp_path / "plain"), 0, tstate)
    _, tstate4, _, _ = _port("adam8", state_bits=(4, 8))
    with pytest.raises(ValueError, match="plain"):
        TC.restore(str(tmp_path / "plain"), 0, tstate4)
    m = _manifest(path)
    m["index"].append(dict(m["index"][0], key=".opt_state.arena[0]"))
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(m, f)
    with pytest.raises(ConfigError, match="A9"):
        TC.restore(str(tmp_path / "plain"), 0, tstate)
