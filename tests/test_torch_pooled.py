"""The pooled single dispatch of the port (mirrors ``tests/test_pooled.py``).

The contract: ``pooled`` changes the dispatch (one fused update for the
whole QuantArena instead of one per quantized leaf) and nothing else.
Held here on the CPU, where the "cuda" backend runs its kernels' plain
versions:

  * pooled against per-leaf in the port, **bit for bit** (params, codes,
    absmax, 32-bit moments, health vectors, clipping history): the six
    element-wise algorithms with stochastic rounding, packed (4, 8) states
    with percentile clipping, the sentinel on clean and poisoned inputs,
    and muon8 (its matrix leaves stay per leaf);
  * the port's pooled path against the JAX package's (``impl="jnp"``, one
    device), from the same numpy params and per-step grads, by ROADMAP's
    comparison rules: adamw, momentum, adagrad and adam (4, 8) exactly (the
    element-wise family's exact cases); lamb, lars and muon, whose trust
    ratios and Newton–Schulz products the two packages sum in other
    orders, with every float within 1e-6 of the tensor's largest magnitude
    (measured: 2e-7) and codes equal, lars's up to a one-level flip at a
    midpoint;
  * checkpoints across packages (``state_bits=None``; the reference's
    packed interchange cells fail on this toolchain, ROADMAP C1) and
    pooled <-> per-leaf in the port at (4, 8);
  * the qhealth arena probe against the reference's ``_slot_events``.
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg

from repro.core import optim as jopt
from repro.core.optim import base as jbase
from repro.kernels import ops as jops
from repro.telemetry import qhealth as jqh
from repro.train import checkpoint as JC
from repro.train import loop as JL
from repro_torch import convert
from repro_torch import telemetry as tel
from repro_torch.configs import base as tcb
from repro_torch.core import optim as topt
from repro_torch.core.lowbit import PackedCodes
from repro_torch.core.optim import base as tbase
from repro_torch.kernels import ops
from repro_torch.train import checkpoint as TC
from repro_torch.train import loop as TL

SHAPES = {"dense": {"w": (64, 128), "v": (48, 64)},
          "stack": (3, 16, 64),            # 3-D: muon's adamw fallback
          "out": (96, 32),
          "embed": {"w": (128, 64)},       # stable-embedding override
          "bias": (10,), "small": (17,),   # pooled f32
          "u": (40, 70)}                   # 2800: a padded last block
KW = dict(lr=1e-2, min_8bit_size=1024, weight_decay=0.01)


def _tree(seed, scale):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: (rng.randn(*s) * scale).astype(np.float32), SHAPES,
        is_leaf=lambda s: isinstance(s, tuple))


def _params():
    return convert.flatten_tree(_tree(0, 0.5))


def _grads(step):
    return convert.flatten_tree(_tree(100 + step, 0.1))


def _run(name, steps, pooled, poison=None, **kw):
    """``steps`` port steps from _params on _grads; returns (opt, params,
    state, health vectors)."""
    opt = topt.make_optimizer(name, pooled=pooled, device="cpu",
                              **dict(KW, **kw))
    params = {k: torch.from_numpy(v.copy()) for k, v in _params().items()}
    state = opt.init(params)
    health = []
    for i in range(steps):
        g = {k: torch.from_numpy(v) for k, v in _grads(i).items()}
        if poison is not None and i == 1:
            g["dense/w"][0, :3] = torch.tensor([np.nan, np.inf, -np.inf])
            g["u"][5, 5] = 1e31
            g["bias"][0] = np.nan
        out = opt.apply(g, state)
        state = out[1]
        health += out[2:]
    return opt, params, state, health


def _equal(a, b) -> bool:
    """Bitwise equality, NaN equal to NaN."""
    if isinstance(a, int) or isinstance(b, int):
        return a == b
    a, b = getattr(a, "packed", a), getattr(b, "packed", b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _assert_same_state(sa, sb):
    fa, fb = TC._flatten(sa), TC._flatten(sb)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (key, a), (_, b) in zip(fa, fb):
        assert _equal(a, b), key


def _assert_pooled_matches_per_leaf(name, steps, **kw):
    oa, pa, sa, ha = _run(name, steps, True, **kw)
    ob, pb, sb, hb = _run(name, steps, False, **kw)
    assert sa.arena is not None and sb.arena is None
    for k in pa:
        assert _equal(pa[k], pb[k]), k
    _assert_same_state(sa, sb)
    assert len(ha) == len(hb) and all(_equal(x, y) for x, y in zip(ha, hb))
    assert oa.state_bytes(sa) == ob.state_bytes(sb)
    return sa, ha


# ------------------------------------------------- pooled == per-leaf, bitwise
@pytest.mark.parametrize("algo", ["adam", "adamw", "momentum", "lamb",
                                  "lars", "adagrad"])
def test_pooled_matches_per_leaf_bit_exact(algo):
    sa, _ = _assert_pooled_matches_per_leaf(f"{algo}8", 3,
                                            stochastic_rounding=True)
    assert sa.pool32 is not None
    assert isinstance(sa.leaves["embed/w"], tbase.Full32Leaf)


def test_pooled_matches_per_leaf_packed_and_clipping():
    sa, _ = _assert_pooled_matches_per_leaf(
        "adam8", 5, state_bits=(4, 8), stochastic_rounding=True,
        percentile_clipping=50, pclip_history=3)
    assert isinstance(sa.arena.codes_m, PackedCodes)
    assert sa.arena.codes_m.bits == 4 and sa.gnorm_vec is not None


@pytest.mark.parametrize("poison", [None, True], ids=["clean", "poisoned"])
@pytest.mark.parametrize("name,kw", [
    ("adamw8", {}), ("lamb8", {"state_bits": (4, 8)}),
    ("momentum8", {"stochastic_rounding": True})])
def test_pooled_sentinel_health_matches_per_leaf(name, kw, poison):
    _, health = _assert_pooled_matches_per_leaf(name, 3, poison=poison,
                                                sentinel=True, **kw)
    assert len(health) == 3
    if poison:
        assert float(health[1][0]) == 4.0     # nonfinite grads: 3 + bias


@pytest.mark.parametrize("kw", [{}, {"state_bits": (4, 8),
                                     "stochastic_rounding": True}],
                         ids=["8bit", "4-8-sr"])
def test_pooled_muon_matrix_leaves_stay_per_leaf(kw):
    sa, _ = _assert_pooled_matches_per_leaf("muon8", 3, **kw)
    # 2-D leaves: per-leaf one-state Newton–Schulz leaves; the 3-D stack
    # is the arena's only (adamw) segment
    assert [s.path for s in sa.arena.segments] == ["stack"]
    for path in ("dense/w", "dense/v", "out", "u"):
        leaf = sa.leaves[path]
        assert isinstance(leaf, tbase.Quant8Leaf) and leaf.codes_r is None


# ------------------------------------------------ layout, views, fallbacks
def test_pooled_layout_and_views():
    opt = topt.make_optimizer("adam8", device="cpu", **KW)
    params = {k: torch.from_numpy(v.copy()) for k, v in _params().items()}
    st = opt.init(params)
    kinds = {k: type(v).__name__ for k, v in st.leaves.items()}
    assert kinds == {"bias": "Pool32Leaf", "dense/v": "PooledQuantLeaf",
                     "dense/w": "PooledQuantLeaf", "embed/w": "Full32Leaf",
                     "out": "PooledQuantLeaf", "small": "Pool32Leaf",
                     "stack": "PooledQuantLeaf", "u": "PooledQuantLeaf"}
    segs = st.arena.segments
    # segments in leaf order, contiguous, covering the arena
    assert [s.path for s in segs] == ["dense/v", "dense/w", "out", "stack",
                                      "u"]
    assert [s.offset for s in segs] == list(
        np.cumsum([0] + [s.n_blocks for s in segs[:-1]]))
    assert st.arena.codes_m.shape[0] == sum(s.n_blocks for s in segs) \
        == st.arena.master.shape[0] == st.arena.grad.shape[0]
    assert [f.path for f in st.pool32.segments] == ["bias", "small"]
    # every pooled parameter IS its arena view; the padding is zero
    for seg in segs:
        p = params[seg.path]
        assert p.untyped_storage().data_ptr() == \
            st.arena.master.untyped_storage().data_ptr()
        assert st.leaves[seg.path].master.data_ptr() == p.data_ptr()
        np.testing.assert_array_equal(p.numpy(), _params()[seg.path])
    bsz = opt.cfg.block_size
    u = segs[-1]
    assert st.arena.master.reshape(-1)[u.offset * bsz + u.n:].abs().sum() \
        == 0
    for f in st.pool32.segments:
        assert params[f.path].untyped_storage().data_ptr() == \
            st.pool32.master.untyped_storage().data_ptr()
    # per-block seeds: i * 7919 with i the leaf's index over ALL leaves
    order = topt.blockopt.leaf_order(params)
    for seg in segs:
        sl = st.arena.leaf_seeds[seg.offset:seg.offset + seg.n_blocks]
        assert (sl == order.index(seg.path) * 7919).all()
        assert torch.equal(
            st.arena.block_offsets[seg.offset:seg.offset + seg.n_blocks],
            torch.arange(seg.n_blocks, dtype=torch.int32))
    view = opt.params_view(st)
    for k, v in _params().items():
        np.testing.assert_array_equal(view[k].numpy(), v)
    per_leaf = topt.make_optimizer("adam8", pooled=False, device="cpu", **KW)
    assert opt.state_bytes(st) == per_leaf.state_bytes(per_leaf.init(
        {k: torch.from_numpy(v.copy()) for k, v in _params().items()}))
    # the step's seed vector wraps in int32 as the per-leaf seeds do
    big = st.arena.leaf_seeds + topt.blockopt.kfu.to_i32(2 ** 31 - 5)
    assert big.dtype == torch.int32
    assert int(big[-1]) == topt.blockopt.kfu.to_i32(
        2 ** 31 - 5 + order.index("u") * 7919)


def test_model_parameters_alias_the_arena_through_zero_grad_and_save():
    """The model's parameters are the arena's views: an update moves them,
    ``zero_grad``, ``torch.save`` and an in-place ``load_state_dict`` or
    checkpoint restore leave them views, and a restore lands in the
    arena."""
    cfg = tcb.reduced(tcb.get_config("paper-lm-209m"), d_model=64,
                      n_layers=2, vocab_size=128)
    opt = topt.make_optimizer("adamw8", lr=1e-2, device="cpu")
    state, model = TL.init_train_state(cfg, opt, torch.Generator()
                                       .manual_seed(0), device="cpu")
    arena = state.opt_state.arena
    storage = arena.master.untyped_storage().data_ptr()
    pooled = {s.path for s in arena.segments}
    aliased = lambda: all(
        p.untyped_storage().data_ptr() == storage
        for k, p in model.param_dict().items() if k in pooled)
    assert pooled and aliased()
    before = {k: p.detach().clone() for k, p in model.param_dict().items()}
    step = TL.make_train_step(cfg, model, opt)
    state, _ = step(state, {"tokens": np.random.RandomState(0).randint(
        0, 128, (4, 17))})
    assert all(not torch.equal(before[k], model.param_dict()[k])
               for k in pooled)
    model.zero_grad(set_to_none=True)
    assert aliased()
    buf = io.BytesIO()
    torch.save(model.state_dict(), buf)
    trained = {k: p.detach().clone() for k, p in model.param_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    model.load_state_dict(torch.load(io.BytesIO(buf.getvalue())))
    assert aliased()
    for k, p in model.param_dict().items():
        assert torch.equal(p, trained[k]), k
    saved = TC.state_dict(state)
    sd = {"state": {k: v if isinstance(v, int) else v.clone()
                    for k, v in saved["state"].items()}}
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    state = TC.load_state_dict(state, sd)
    assert aliased() and state.opt_state.arena is arena
    for k, p in model.param_dict().items():
        assert torch.equal(p, trained[k]), k


def test_tensorwise_and_32bit_fall_back_to_per_leaf():
    """A per-tensor absmax (the tensor-wise ablation) cannot live in one
    arena, and a 32-bit engine has nothing to quantize: both keep the
    per-leaf layout with pooled left at its default."""
    for name, kw in (("adam8", {"blockwise_norm": False}), ("adam32", {})):
        opt = topt.make_optimizer(name, device="cpu", **dict(KW, **kw))
        assert opt.cfg.pooled and not opt.cfg.pooling_active
        st = opt.init({k: torch.from_numpy(v.copy())
                       for k, v in _params().items()})
        assert st.arena is None and st.pool32 is None
        want = tbase.Quant8Leaf if name == "adam8" else tbase.Full32Leaf
        assert isinstance(st.leaves["dense/w"], want)


def test_a13_settings_raise():
    """The A13 settings are ported: each is accepted and switches on its
    dispatch; ZeRO-2 without the pooled arena still raises, as in the JAX
    package."""
    for kw, on in (({"partition_shards": 4}, "partition_active"),
                   ({"partition": True}, "partition_active"),
                   ({"shard_grads": True}, "shard_grads_active"),
                   ({"partition": True, "overlap_buckets": 2},
                    "overlap_active")):
        opt = topt.make_optimizer("adamw8", device="cpu", **kw)
        assert getattr(opt.cfg, on), kw
    with pytest.raises(ValueError, match="shard_grads"):
        topt.make_optimizer("adamw8", device="cpu", shard_grads=True,
                            pooled=False)


# ------------------------------------------------------- dispatches per step
def test_pooled_single_dispatch_count():
    """One fused_update per arena; the per-leaf dispatch makes one per
    quantized leaf."""
    def calls(pooled):
        opt = topt.make_optimizer("adam8", pooled=pooled, device="cpu", **KW)
        st = opt.init({k: torch.from_numpy(v.copy())
                       for k, v in _params().items()})
        ops.reset_fused_update_count()
        opt.apply({k: torch.from_numpy(v) for k, v in _grads(0).items()},
                  st)
        return ops.fused_update_count()

    assert calls(False) == 5 and calls(True) == 1


@pytest.mark.parametrize("name", ["adamw8", "muon8"])
def test_train_step_dispatches_match_the_reference(name):
    """The step's opt_fused_dispatches on the reduced paper LM equals the
    JAX package's count for the same pooled tree: the arena plus each
    quantized matrix leaf (muon8's head)."""
    jo = jopt.make_optimizer(name, lr=1e-2)
    jst, _ = JL.init_train_state(tiny_cfg(), jo, jax.random.PRNGKey(0))
    g = jax.tree_util.tree_map(jnp.zeros_like,
                               jo.params_view(jst.opt_state))
    jops.reset_fused_update_count()
    jax.jit(lambda g, s: jo.apply(g, s)).lower(g, jst.opt_state)
    want = jops.fused_update_count()
    cfg = tcb.reduced(tcb.get_config("paper-lm-209m"), d_model=64,
                      n_layers=2, vocab_size=128)
    to = topt.make_optimizer(name, lr=1e-2, device="cpu")
    st, model = TL.init_train_state(cfg, to, torch.Generator()
                                    .manual_seed(0), device="cpu")
    _, m = TL.make_train_step(cfg, model, to)(st, {
        "tokens": np.random.RandomState(1).randint(0, 128, (2, 9))})
    assert m["opt_fused_dispatches"] == want == (1 if name == "adamw8"
                                                 else 2)


# ------------------------------------------------- port pooled vs JAX pooled
JAX_CASES = [("adamw8", {"stochastic_rounding": True}, True),
             ("momentum8", {}, True), ("adagrad8", {}, True),
             ("adam8", {"state_bits": (4, 8), "stochastic_rounding": True},
              True),
             ("lamb8", {}, False), ("lars8", {}, False),
             ("muon8", {"stochastic_rounding": True}, False)]


def _near_boundary_ok(a, b):
    diff = np.abs(a.astype(int) - b.astype(int))
    return diff.max() <= 1 and (diff > 0).sum() <= max(1, diff.size // 10_000)


@pytest.mark.parametrize("name,kw,exact", JAX_CASES,
                         ids=[c[0] + ("-" + "-".join(c[1]) if c[1] else "")
                              for c in JAX_CASES])
def test_pooled_matches_jax_pooled(name, kw, exact):
    jo = jopt.make_optimizer(name, impl="jnp", **dict(KW, **kw))
    js = jo.init(jax.tree_util.tree_map(jnp.asarray, _tree(0, 0.5)))
    to, _, ts, _ = _run(name, 3, True, **kw)
    for i in range(3):
        _, js = jo.apply(jax.tree_util.tree_map(jnp.asarray,
                                                _tree(100 + i, 0.1)), js)
    assert js.arena is not None and ts.arena is not None
    assert [s.path for s in ts.arena.segments] == \
        [s.path for s in js.arena.segments]
    assert [(s.offset, s.n_blocks) for s in ts.arena.segments] == \
        [(s.offset, s.n_blocks) for s in js.arena.segments]
    jl = {jbase.path_str(p): leaf for p, leaf in
          jax.tree_util.tree_leaves_with_path(
              jopt.unpool_state(js).leaves, is_leaf=lambda x: isinstance(
                  x, (jbase.Quant8Leaf, jbase.Full32Leaf)))}
    tl = topt.unpool_state(ts).leaves
    assert sorted(jl) == sorted(tl)
    for path, j in jl.items():
        t = tl[path]
        for f in ("master", "codes_m", "absmax_m", "codes_r", "absmax_r",
                  "m", "r"):
            a = getattr(j, f, None)
            if a is None:
                continue
            a = np.asarray(getattr(a, "packed", a))
            b = getattr(getattr(t, f), "packed", getattr(t, f)).numpy()
            if a.dtype == np.uint8:
                ok = (a == b).all() if exact or name != "lars8" \
                    else _near_boundary_ok(b, a)
                assert ok, (path, f)
            elif exact:
                np.testing.assert_array_equal(b, a, err_msg=f"{path} {f}")
            else:
                np.testing.assert_allclose(
                    b, a, rtol=0, atol=1e-6 * float(np.abs(a).max()),
                    err_msg=f"{path} {f}")
    assert to.state_bytes(ts) == jo.state_bytes(js)


# --------------------------------------------------------------- checkpoints
def _jtree(params):
    out = {}
    for path, v in params.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return out


def _by_key(tree, tmp_path, save):
    """{checkpoint key: numpy array} of ``tree``, written by ``save``."""
    path = str(tmp_path)
    save(path, 0, tree)
    return {k: np.asarray(v) for k, v in TC.read(path, 0)["state"].items()}


def test_checkpoint_jax_pooled_into_port_both_layouts(tmp_path):
    """A checkpoint of the JAX package's pooled state restores into a
    pooled and into a per-leaf port state, bit for bit, and the next step
    agrees with the JAX step by the exact cases' rule."""
    kw = dict(KW, stochastic_rounding=True)
    jo = jopt.make_optimizer("adamw8", impl="jnp", **kw)
    js = jo.init(_jtree(_params()))
    for i in range(2):
        _, js = jo.apply(_jtree(_grads(i)), js)
    JC.save(str(tmp_path), 2, js)
    states = []
    for pooled in (True, False):
        to = topt.make_optimizer("adamw8", pooled=pooled, device="cpu", **kw)
        params = {k: torch.zeros(v.shape) for k, v in _params().items()}
        st = TC.restore(str(tmp_path), 2, to.init(params))
        assert st.step == 2 and (st.arena is not None) == pooled
        _, st = to.apply({k: torch.from_numpy(v) for k, v in
                          _grads(2).items()}, st)
        states.append(st)
    _assert_same_state(states[0], states[1])
    _, js = jo.apply(_jtree(_grads(2)), js)
    want = _by_key(js, tmp_path / "jax", JC.save)
    got = _by_key(states[0], tmp_path / "port", TC.save)
    assert sorted(got) == sorted(want)
    for key, v in want.items():
        np.testing.assert_array_equal(got[key], v, err_msg=key)


@pytest.mark.parametrize("pooled_jax", [True, False])
def test_checkpoint_port_pooled_into_jax(tmp_path, pooled_jax):
    """A checkpoint of the port's pooled state restores into the JAX
    package's pooled and per-leaf templates with the port's values."""
    _, _, ts, _ = _run("adamw8", 2, True)
    TC.save(str(tmp_path), 2, ts)
    jo = jopt.make_optimizer("adamw8", pooled=pooled_jax, **KW)
    template = jax.eval_shape(lambda: jo.init(_jtree(_params())))
    js = JC.restore(str(tmp_path), 2, template)
    assert (js.arena is not None) == pooled_jax and int(js.step) == 2
    got = _by_key(js, tmp_path / "jax", JC.save)
    want = _by_key(ts, tmp_path / "port", TC.save)
    assert sorted(got) == sorted(want)
    for key, v in want.items():
        np.testing.assert_array_equal(got[key], v, err_msg=key)


@pytest.mark.parametrize("src_pooled", [True, False])
def test_checkpoint_pooled_per_leaf_interchange_packed(tmp_path, src_pooled):
    """(4, 8) states saved from one layout restore into the other bit for
    bit (packed rows concatenated by block are the per-leaf rows), and the
    next step from the restored state equals the uninterrupted one."""
    kw = dict(state_bits=(4, 8), stochastic_rounding=True)
    opt, _, st, _ = _run("adam8", 3, src_pooled, **kw)
    TC.save(str(tmp_path), 3, st)
    other = topt.make_optimizer("adam8", pooled=not src_pooled,
                                device="cpu", **dict(KW, **kw))
    rs = TC.restore(str(tmp_path), 3, other.init(
        {k: torch.zeros(v.shape) for k, v in _params().items()}))
    assert (rs.arena is None) == src_pooled
    _assert_same_state(rs, st)
    g = {k: torch.from_numpy(v) for k, v in _grads(3).items()}
    _, st = opt.apply(g, st)
    _, rs = other.apply(g, rs)
    _assert_same_state(rs, st)


def test_repool_like_writes_into_the_arena():
    _, _, pl, _ = _run("lamb8", 2, False, state_bits=(4, 8))
    opt = topt.make_optimizer("lamb8", device="cpu",
                              **dict(KW, state_bits=(4, 8)))
    params = {k: torch.zeros(v.shape) for k, v in _params().items()}
    template = opt.init(params)
    out = topt.repool_like(pl, template)
    assert out.arena is template.arena and out.step == 2
    _assert_same_state(out, pl)
    assert _equal(params["dense/w"], pl.leaves["dense/w"].master)
    assert topt.repool_like(pl, pl) is pl


# ------------------------------------------------------------ qhealth arena
def test_qhealth_arena_probe_matches_reference(tmp_path):
    """The port's probe of a pooled state against the JAX probe's arena
    branch (``_slot_events("arena", ...)``) on the same state, carried
    across by a checkpoint: the same events in the same order, counts
    exact, means to f32 rounding."""
    jo = jopt.make_optimizer("adam8", impl="jnp", **KW)
    js = jo.init(_jtree(_params()))
    _, js = jo.apply(_jtree(_grads(0)), js)
    JC.save(str(tmp_path), 1, js)
    to = topt.make_optimizer("adam8", device="cpu", **KW)
    ts = TC.restore(str(tmp_path), 1, to.init(
        {k: torch.zeros(v.shape) for k, v in _params().items()}))
    want = jqh.QHealthProbe(jo).probe(js, step=1)
    got = tel.QHealthProbe(to).probe(ts, step=1)
    assert [(e["target"], e["segment"], e["slot"]) for e in got] == \
        [(e["target"], e["segment"], e["slot"]) for e in want]
    assert {e["target"] for e in got} == {"arena"} and len(got) == 10
    for g, w in zip(got, want):
        key = (g["segment"], g["slot"])
        for f in ("bits", "n_bins", "n_blocks", "saturation_fraction",
                  "edge_code_fraction", "util_hist", "util_fraction",
                  "absmax_drift"):
            assert g[f] == w[f], (key, f)
        np.testing.assert_allclose(g["absmax_mean"], w["absmax_mean"],
                                   rtol=1e-6, err_msg=str(key))
        assert ("rms_error" in g) == ("rms_error" in w) == (g["slot"] == "m")
        if "rms_error" in g:
            np.testing.assert_allclose(g["rms_error"], w["rms_error"],
                                       rtol=1e-6, err_msg=str(key))
            assert g["rms_sample_blocks"] == w["rms_sample_blocks"]
