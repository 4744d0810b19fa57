"""The port's tensor-parallel rules against the JAX package's, at full
width and without devices: the JAX side on ``jax.eval_shape`` and
``AbstractMesh``es of the production shapes, the port's on the "meta"
device and meshes given as {name: size}.

  * ``logical_axes`` equals the JAX ``init_model`` specs for every
    architecture;
  * ``resolve_spec`` / ``param_shardings`` give every parameter the JAX
    package's spec on the pod (16 x 16), multipod (2 x 16 x 16) and smoke
    (2 x 2 x 2) meshes;
  * ``opt_state_shardings`` implies the JAX package's per-device state
    bytes (adam8 pooled, per leaf, (4, 8) packed; adafactor) on the pod;
  * ``batch_sharding`` and ``cache_shardings`` give every decode and
    long cell's tensors the JAX package's specs;
  * ``constrain`` is the identity without activation axes.

Specs compare after one normalisation: a one-axis tuple is its axis name,
an empty tuple None (the same ``PartitionSpec`` in JAX).
"""
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import base as JB
from repro.core import optim as jopt
from repro.launch import shapes as JS
from repro.models import model as JM
from repro.sharding import rules as JR
from repro_torch.configs import base as TB
from repro_torch.core import optim as topt
from repro_torch.launch import shapes as TS
from repro_torch.models import constrain as TC
from repro_torch.models import model as TM
from repro_torch.sharding import rules as TR

ARCHS = JB.list_archs()
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model")),
          "smoke": ((2, 2, 2), ("pod", "data", "model"))}


def _abstract_mesh(kind):
    shape, names = MESHES[kind]
    return jax.sharding.AbstractMesh(shape, names)


def _sizes(kind) -> dict:
    shape, names = MESHES[kind]
    return dict(zip(names, shape))


def _norm_entry(e):
    if isinstance(e, tuple):
        if len(e) == 0:
            return None
        return e[0] if len(e) == 1 else e
    return e


def _norm(spec, ndim) -> tuple:
    spec = tuple(_norm_entry(e) for e in spec)
    return spec + (None,) * (ndim - len(spec))


def _path(keypath) -> str:
    """A JAX key path as the port's 'a/b/0/c' path string."""
    out = []
    for k in keypath:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                out.append(str(getattr(k, attr)))
                break
    return "/".join(out)


_JAX_PARAMS = {}


def _jax_params(arch):
    """(abstract params, logical specs) of the JAX init, by path."""
    if arch not in _JAX_PARAMS:
        box = {}

        def init():
            p, s = JM.init_model(JB.get_config(arch), jax.random.PRNGKey(0))
            box["specs"] = s
            return p

        abstract = jax.eval_shape(init)
        is_spec = lambda t: isinstance(t, tuple) and all(
            isinstance(e, str) for e in t)
        specs = {_path(k): v for k, v in jax.tree_util.tree_flatten_with_path(
            box["specs"], is_leaf=is_spec)[0]}
        _JAX_PARAMS[arch] = (abstract, box["specs"], specs)
    return _JAX_PARAMS[arch]


def _port_model(arch):
    cfg = TB.get_config(arch)
    return cfg, TM.Model(cfg, device="meta")


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_axes_equal_jax(arch):
    _, _, jspecs = _jax_params(arch)
    cfg, model = _port_model(arch)
    assert TM.logical_axes(cfg, model) == jspecs


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_equal_jax(arch, mesh_kind):
    abstract, jspec_tree, _ = _jax_params(arch)
    jsh = JR.param_shardings(jspec_tree, abstract, _abstract_mesh(mesh_kind),
                             JR.ShardingPolicy())
    jflat = {_path(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jsh)[0]}
    cfg, model = _port_model(arch)
    params = model.param_dict()
    tsh = TR.param_shardings(TM.logical_axes(cfg, model), params,
                             _sizes(mesh_kind), TR.ShardingPolicy())
    assert set(tsh) == set(jflat)
    for path, p in params.items():
        assert _norm(tsh[path], p.dim()) == _norm(jflat[path].spec, p.dim()), \
            path


def _jax_state_bytes(state, shardings) -> int:
    total = 0
    leaves = jax.tree_util.tree_leaves(state)
    shards = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
    assert len(leaves) == len(shards)
    for a, sh in zip(leaves, shards):
        if a.ndim == 0:                  # the step counters: the port's ints
            continue
        total += math.prod(sh.shard_shape(a.shape)) * a.dtype.itemsize
    return total


STATE_CASES = {
    "adam8_pooled": ("adam8", {}),
    "adam8_per_leaf": ("adam8", {"pooled": False}),
    "adam8_4_8_packed": ("adam8", {"state_bits": (4, 8)}),
    "adafactor32": ("adafactor32", {}),
}


@pytest.mark.parametrize("case", list(STATE_CASES))
@pytest.mark.parametrize("arch", ["paper-lm-209m", "mixtral-8x22b"])
def test_opt_state_bytes_equal_jax(arch, case):
    name, kw = STATE_CASES[case]
    kw = dict(kw, shard_multiple=256, weight_decay=0.1)
    mesh = _abstract_mesh("pod")
    policy = JR.ShardingPolicy()
    abstract, jspec_tree, _ = _jax_params(arch)
    jopt_ = jopt.make_optimizer(name, lr=1e-4, impl="jnp", **kw)
    jstate = jax.eval_shape(jopt_.init, abstract)
    jpsh = JR.param_shardings(jspec_tree, abstract, mesh, policy)
    jsh = JR.opt_state_shardings(jstate, jpsh, mesh, policy)
    want = _jax_state_bytes(jstate, jsh)

    cfg, model = _port_model(arch)
    params = model.param_dict()
    tpol = TR.ShardingPolicy()
    pspec = TR.param_shardings(TM.logical_axes(cfg, model), params,
                               _sizes("pod"), tpol)
    topt_ = topt.make_optimizer(name, lr=1e-4, impl="torch", device="meta",
                                **kw)
    tstate = topt_.init(params)
    specs = TR.opt_state_shardings(tstate, pspec, _sizes("pod"), tpol)
    got = sum(TR.local_bytes(t, spec, _sizes("pod"))
              for n, (t, spec) in specs.items()
              if not TR.port_only_state(n))
    assert got == want


def _jax_cache_specs(cfg_j, batch, seq, kind):
    cache = jax.eval_shape(lambda: JM.init_cache(cfg_j, batch, seq))
    sh = JR.cache_shardings(cache, cfg_j, _abstract_mesh(kind),
                            JR.ShardingPolicy())
    leaves = jax.tree_util.tree_flatten_with_path(cache)[0]
    shards = jax.tree_util.tree_leaves(sh)
    return {_path(k): (a.shape, s.spec) for (k, a), s in zip(leaves, shards)}


SERVE_CELLS = [(a, s) for a in ARCHS for s in ("decode_32k", "long_500k")
               if JS.cell_supported(JB.get_config(a), JS.SHAPES[s])[0]]


@pytest.mark.parametrize("arch,shape", SERVE_CELLS)
def test_cache_and_batch_shardings_equal_jax(arch, shape):
    case = JS.SHAPES[shape]
    cfg_j, cfg_t = JB.get_config(arch), TB.get_config(arch)
    for kind in ("pod", "multipod"):
        want = _jax_cache_specs(cfg_j, case.global_batch, case.seq_len, kind)
        cache = TM.init_cache(cfg_t, case.global_batch, case.seq_len,
                              device="meta")
        got = TR.cache_shardings(cache, cfg_t, _sizes(kind),
                                 TR.ShardingPolicy())
        assert set(got) == set(want)
        for path, spec in got.items():
            shape_j, spec_j = want[path]
            assert _norm(spec, len(shape_j)) == _norm(spec_j, len(shape_j)), \
                path
        tok = TS.input_specs(cfg_t, TS.SHAPES[shape])["token"]
        jb = JR.batch_sharding(_abstract_mesh(kind), JR.ShardingPolicy(),
                               tok.dim(), tok.shape[0])
        tb = TR.batch_sharding(_sizes(kind), TR.ShardingPolicy(), tok.dim(),
                               tok.shape[0])
        assert _norm(tb, tok.dim()) == _norm(jb.spec, tok.dim())


def test_constrain_is_identity_without_axes():
    TC.clear_activation_axes()
    assert not TC.active()
    x = torch.randn(4, 8, 16)
    assert TC.constrain(x, "dp", "tp", None) is x
    bp = {"attn": {"wq": torch.randn(16, 16)}}
    assert TC.constrain_block_params(bp) is bp
    assert TC.attn_score_dims(4, 2, 8) == ("dp", None, None, None, None)


def test_placements_and_local_shape():
    from torch.distributed.tensor import Replicate, Shard
    sizes = {"pod": 2, "data": 16, "model": 16}
    spec = (("pod", "data"), "model", None)
    assert TR.placements(spec, sizes) == [Shard(0), Shard(0), Shard(1)]
    assert TR.local_shape((64, 32, 5), spec, sizes) == (2, 2, 5)
    assert TR.placements((None,), sizes) == [Replicate()] * 3
    assert TR.flat_block_spec(sizes) == (("pod", "data", "model"), None)
