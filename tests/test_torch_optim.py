"""Differential tests of the port's optimizer engine
(``repro_torch.core.optim``) against the JAX engine on its per-leaf path
(``pooled=False``): the same params and per-step gradients, made with numpy,
go through both; the states are compared leaf by leaf by path string."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import optim as jopt
from repro.core.optim import base as jbase
from repro_torch import convert
from repro_torch.core import optim as topt
from repro_torch.core.optim import base as tbase
from repro_torch.errors import ConfigError, FormatError

BLOCK = 256
SHAPES = {
    "layer": {"w": (70, 64),          # 4480 elements: 8-bit, padded blocks
              "bias": (64,)},         # below min_8bit_size: 32-bit
    "embed": {"table": (80, 64)},     # stable-embedding override: 32-bit
    "head": {"w": (64, 128)},         # 8192: 8-bit, whole blocks
}


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: (rng.randn(*s) * 0.1).astype(np.float32), SHAPES,
        is_leaf=lambda s: isinstance(s, tuple))


def _grads(step):
    rng = np.random.RandomState(100 + step)
    return jax.tree_util.tree_map(
        lambda s: (rng.randn(*s) * 0.01).astype(np.float32), SHAPES,
        is_leaf=lambda s: isinstance(s, tuple))


def _near_boundary_ok(codes_t, codes_j):
    """Codes equal, or differing by one level in at most 1 in 10^4."""
    diff = np.abs(codes_t.astype(int) - codes_j.astype(int))
    return diff.max() <= 1 and (diff > 0).sum() <= max(1, diff.size // 10_000)


def _run_both(name, steps, **kw):
    params = _params()
    jo = jopt.make_optimizer(name, pooled=False, block_size=BLOCK, **kw)
    js = jo.init(jax.tree_util.tree_map(jnp.asarray, params))
    to = topt.make_optimizer(name, block_size=BLOCK, device="cpu", **kw)
    tparams = {k: torch.from_numpy(v.copy())
               for k, v in convert.flatten_tree(params).items()}
    ts = to.init(tparams)
    for i in range(steps):
        g = _grads(i)
        _, js = jo.apply(jax.tree_util.tree_map(jnp.asarray, g), js)
        _, ts = to.apply({k: torch.from_numpy(v) for k, v in
                          convert.flatten_tree(g).items()}, ts)
    jleaves = {jbase.path_str(p): leaf for p, leaf in
               jax.tree_util.tree_leaves_with_path(
                   js.leaves, is_leaf=lambda x: isinstance(
                       x, (jbase.Quant8Leaf, jbase.Full32Leaf)))}
    return jo, js, jleaves, to, ts, tparams


@pytest.mark.parametrize("name", ["adam8", "adamw8", "adam32", "adamw32"])
def test_engine_matches_jax_leaf_by_leaf(name):
    jo, js, jleaves, to, ts, tparams = _run_both(name, 3,
                                                 weight_decay=0.01)
    assert sorted(jleaves) == sorted(ts.leaves)
    assert ts.step == int(js.step) == 3
    for path, jl in jleaves.items():
        tl = ts.leaves[path]
        assert type(tl).__name__ == type(jl).__name__, path
        np.testing.assert_allclose(tl.master.numpy(), np.asarray(jl.master),
                                   rtol=1e-6, atol=1e-8, err_msg=path)
        # the masters are the parameters given to init, updated in place
        assert tl.master.data_ptr() == tparams[path].data_ptr()
        if isinstance(tl, tbase.Quant8Leaf):
            assert tl.shape == jl.shape and tl.n == jl.n
            for ct, cj in ((tl.codes_m, jl.codes_m), (tl.codes_r, jl.codes_r)):
                assert _near_boundary_ok(ct.numpy(), np.asarray(cj)), path
            np.testing.assert_allclose(tl.absmax_m.numpy(),
                                       np.asarray(jl.absmax_m), rtol=1e-6)
            np.testing.assert_allclose(tl.absmax_r.numpy(),
                                       np.asarray(jl.absmax_r), rtol=1e-6)
        else:
            np.testing.assert_allclose(tl.m.numpy(), np.asarray(jl.m),
                                       rtol=1e-6, atol=1e-12)
            np.testing.assert_allclose(tl.r.numpy(), np.asarray(jl.r),
                                       rtol=1e-6, atol=1e-16)
    assert to.state_bytes(ts) == jo.state_bytes(js)


def test_percentile_clipping_matches_jax():
    jo, js, jleaves, to, ts, _ = _run_both(
        "adamw8", 4, percentile_clipping=50, pclip_history=3)
    np.testing.assert_allclose(ts.gnorm_vec.numpy(), np.asarray(js.gnorm_vec),
                               rtol=1e-6)
    for path, jl in jleaves.items():
        np.testing.assert_allclose(ts.leaves[path].master.numpy(),
                                   np.asarray(jl.master), rtol=1e-6,
                                   atol=1e-8, err_msg=path)


def test_names_and_unported_settings():
    assert topt.optimizer_names() == jopt.optimizer_names()
    opt = topt.make_optimizer("adamw8", device="cpu")
    assert opt.cfg.pooled is False and opt.cfg.algo == "adamw"
    with pytest.raises(ConfigError, match="A9"):
        topt.make_optimizer(topt.OptimConfig(algo="adamw"), device="cpu")
    # a 32-bit engine has nothing to pool
    topt.make_optimizer(topt.OptimConfig(algo="adam", bits=32), device="cpu")
    topt.make_optimizer("adam8", stochastic_rounding=True, device="cpu")
    topt.make_optimizer(topt.OptimConfig(algo="lamb", pooled=False),
                        device="cpu")
    # muon (A10) and packed states (A8) are ported
    assert isinstance(topt.make_optimizer(
        topt.OptimConfig(algo="muon", pooled=False), device="cpu"),
        topt.MuonOptimizer)
    topt.make_optimizer("adam8", state_bits=(4, 8), device="cpu")
    with pytest.raises(ConfigError, match="A11"):
        topt.make_optimizer("adam8", sentinel=True, device="cpu")
    with pytest.raises(ConfigError):
        topt.make_optimizer("adam8", state_bits=(3, 8), device="cpu")
    with pytest.raises(FormatError):
        topt.make_optimizer("adam8", state_bits=(5, 8), block_size=6,
                            device="cpu").init({"w": torch.zeros(8192)})
    with pytest.raises(ConfigError):
        topt.make_optimizer("muon8", ns_steps=-1, device="cpu")
    with pytest.raises(ConfigError):
        topt.make_optimizer("sgd8", device="cpu")


def test_path_str_and_blocks():
    assert tbase.path_str("blocks.b0_attn.attn.wq") == "blocks/b0_attn/attn/wq"
    assert tbase.path_str(("head", "w")) == "head/w"
    x = torch.arange(10, dtype=torch.float32).reshape(2, 5)
    b = tbase.flatten_to_blocks(x, 4, 2)
    assert b.shape == (4, 4) and b.reshape(-1)[10:].abs().sum() == 0
    assert tbase.n_blocks_for((2, 5), 4, 2) == 4
    assert torch.equal(tbase.blocks_to_param(b, (2, 5), 10, torch.float32), x)
    view = tbase.flatten_to_blocks(torch.zeros(8, 4), 4, 1)
    assert view.shape == (8, 4)
    assert all(tbase.default_override_32bit(p) == jbase.default_override_32bit(p)
               for p in ("embed/table", "head/w", "wte", "blocks/wpe/x"))
