"""bf16 masters (``master_dtype="bfloat16"``) in the port against the JAX
package's ``impl="jnp"`` apply with the same setting, on the CPU: the
per-leaf, pooled and partitioned (2 and 3 spans, one process) layouts.

Both packages start from the same bf16 parameters (an f32 draw rounded to
nearest even) and take the same gradients, bf16 (an unclipped gradient of
a bf16 parameter) or f32 (a clipped or accumulated one, as the JAX
package's train step hands it over); three steps.  The JAX
package updates ``f32(master)`` in f32 and rounds the result to nearest
even (``astype``); the port's plain versions do the same, so the
quantized leaves' bf16 masters must be **bit-identical**, and their codes
may differ only where a state lies within rounding of a codebook midpoint
(ROADMAP's rule), counted (zero here for adam8) and bounded by
``CODE_FLIPS``.  lamb8's trust ratios are sums whose order differs (the
port's block partials and pairwise tree against XLA's reduction), so its
masters are counted too, each at most one bf16 step off.  The 32-bit
leaves (the stable-embedding override, the small pooled leaf) keep f32
masters, updated as the JAX package's 32-bit math to f32 rounding, and the
port writes them back into their bf16 parameters; they are held to the
JAX package's params view in bf16 within one bf16 step.

The train step (bf16 parameters of the reduced qwen1.5-32b): over two
microbatches the gradients add up in f32 in both packages, whatever the
parameter's dtype, and the clipped gradient the optimizer receives is
f32.  The gradients the two train steps hand their optimizers are held to
each other at ``GRAD_RTOL``, but for at most ``GRAD_FLIPS`` of the
elements: a microbatch gradient whose f32 value lies within rounding of a
bf16 midpoint may round the other way (about 0.1% measured; accumulating
in bf16 puts ~86% of the elements off).  Full adamw8 runs with bf16
masters (per-leaf, pooled, and ZeRO-2's gradient buffer) are held to the
JAX package's train step: loss traces at the golden rtol=2e-4, masters and
codes counted under ``GRAD_FLIPS`` (a flipped gradient element moves its
moment code, and its master by a rounding step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.core import optim as jopt
from repro.core.optim.base import path_str
from repro.core.optim.blockopt import unpool_state as j_unpool
from repro.models import model as JM
from repro.train import loop as JL
from repro_torch import convert
from repro_torch.configs import base as TB
from repro_torch.core import optim as topt
from repro_torch.train import loop as TL

SHAPES = {"dense/w": (64, 256), "dense/v": (40, 130), "embed/table": (64, 32),
          "norm/scale": (100,)}
KW = dict(lr=1e-3, weight_decay=0.01, min_8bit_size=1024, block_size=256)
STEPS = 3
CODE_FLIPS = 1e-3
GRAD_RTOL, GRAD_FLIPS = 1e-5, 2e-3


def _nest(flat):
    out = {}
    for path, v in flat.items():
        a, b = path.split("/")
        out.setdefault(a, {})[b] = v
    return out


def _bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _data(grad_bf16=True):
    rng = np.random.RandomState(0)
    params = {k: _bf16(rng.randn(*s).astype(np.float32) * 0.1)
              for k, s in SHAPES.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) * 0.01
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    if grad_bf16:
        grads = [{k: _bf16(v) for k, v in g.items()} for g in grads]
    return params, grads


def _run(name, grad_bf16=True, **kw):
    params, grads = _data(grad_bf16)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if grad_bf16
                else (jnp.float32, torch.float32))
    jo = jopt.make_optimizer(name, impl="jnp", master_dtype="bfloat16", **kw,
                             **KW)
    js = jo.init(_nest({k: jnp.asarray(v) for k, v in params.items()}))
    for g in grads:
        jp, js = jo.apply(_nest({k: jnp.asarray(v).astype(jdt)
                                 for k, v in g.items()}), js,
                          param_dtype=jnp.bfloat16)
    to = topt.make_optimizer(name, master_dtype="bfloat16", device="cpu",
                             **kw, **KW)
    tp = {k: torch.from_numpy(v).to(torch.bfloat16)
          for k, v in params.items()}
    ts = to.init(tp)
    for g in grads:
        _, ts = to.apply({k: torch.from_numpy(v).to(tdt)
                          for k, v in g.items()}, ts)
    return jp, j_unpool(js), tp, topt.unpool_state(ts)


def _f32(t):
    return t.detach().to(torch.float32).numpy()


LAYOUTS = {"per_leaf": dict(pooled=False), "pooled": dict(pooled=True),
           "spans2": dict(partition_shards=2),
           "spans3": dict(partition_shards=3)}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", ["adam8", "lamb8"])
def test_bf16_masters_match_jax(name, layout):
    _check_masters(name, *_run(name, **LAYOUTS[layout]))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_bf16_masters_f32_grads_match_jax(layout):
    """f32 gradients (not bf16 values: a clipped or accumulated gradient)
    reach the update unrounded, as in the JAX package: the bf16 masters
    stay bit-identical."""
    _check_masters("adam8", *_run("adam8", grad_bf16=False,
                                  **LAYOUTS[layout]))


def _check_masters(name, jp, js, tp, ts):
    n_quant = 0
    for path, leaf in ts.leaves.items():
        a, b = path.split("/")
        jleaf = js.leaves[a][b]
        if isinstance(leaf, topt.Quant8Leaf):
            n_quant += 1
            assert leaf.master.dtype == torch.bfloat16
            assert jleaf.master.dtype == jnp.bfloat16
            # the parameter is the master (aliased)
            assert torch.equal(tp[path].detach(), leaf.master)
            got = _f32(leaf.master)
            want = np.asarray(jleaf.master.astype(jnp.float32))
            if name == "adam8":
                np.testing.assert_array_equal(got, want, err_msg=path)
            else:
                off = got != want
                assert off.sum() <= CODE_FLIPS * got.size, (path, off.sum())
                np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                           err_msg=path)
            for slot in ("codes_m", "codes_r"):
                d = np.abs(getattr(leaf, slot).numpy().astype(np.int64)
                           - np.asarray(getattr(jleaf, slot), np.int64))
                assert (d != 0).sum() <= CODE_FLIPS * d.size, (path, slot)
                if name == "adam8":
                    assert d.max() == 0, (path, slot)
        else:
            # an f32 master, written back into the bf16 parameter
            assert leaf.master.dtype == torch.float32
            assert tp[path].dtype == torch.bfloat16
            assert torch.equal(tp[path].detach(),
                               leaf.master.to(torch.bfloat16))
            np.testing.assert_allclose(_f32(tp[path]),
                                       np.asarray(jp[a][b], np.float32),
                                       rtol=2 ** -7, atol=1e-6, err_msg=path)
    assert n_quant == 2


def test_bf16_arena_buffers_and_kernel_dtypes():
    """The pooled arena's master is bf16 and its gradient buffer f32 (as
    are a ZeRO-2 GradBuffer's blocks); the fused update's wrapper takes
    bf16 p with f32 g and refuses a bf16 g or an f16 p."""
    from repro_torch.kernels import fused_update as fu
    params = {k: torch.zeros(s, dtype=torch.bfloat16)
              for k, s in SHAPES.items()}
    for kw in ({}, dict(shard_grads=True)):
        to = topt.make_optimizer("adamw8", master_dtype="bfloat16",
                                 device="cpu", **kw, **KW)
        st = to.init(params)
        assert st.arena.master.dtype == torch.bfloat16
        assert st.arena.grad.dtype == torch.float32
        assert all(v.dtype == torch.float32
                   for v in to.grad_views(st).values())
        if kw:
            assert to.init_grad_buffer(st).blocks.dtype == torch.float32
    nb = st.arena.total
    with pytest.raises(TypeError, match="g: dtype"):
        fu.fused_update_cuda(
            st.arena.master, torch.zeros(nb, 256, dtype=torch.bfloat16),
            st.arena.codes_m, st.arena.absmax_m, st.arena.codes_r,
            st.arena.absmax_r, to._qmap1, to._qmap2, algo="adamw", lr=1e-3)
    with pytest.raises(TypeError, match="p: dtype"):
        z = torch.zeros(nb, 256, dtype=torch.float16)
        fu.fused_update_cuda(
            z, z, st.arena.codes_m, st.arena.absmax_m, st.arena.codes_r,
            st.arena.absmax_r, to._qmap1, to._qmap2, algo="adamw", lr=1e-3)


def test_bf16_masters_train_loop_and_casts():
    """The train loop over a bf16-master arena: the clip writes the f32
    product into the f32 gradient buffer; a bf16 parameter of an f32
    master (qwen's bf16 params with the default f32 masters) gets its
    master back after every step."""
    from repro_torch.models import model as M
    cfg = TB.reduced(TB.get_config("qwen1.5-32b"),
                       param_dtype="bfloat16")
    tok = np.random.RandomState(0).randint(0, 256, (2, 9))
    for mdt in ("bfloat16", "float32"):
        model = M.init_model(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        opt = topt.make_optimizer("adamw8", master_dtype=mdt, device="cpu")
        state = TL.TrainState(opt.init(model.param_dict()), 0)
        step = TL.make_train_step(cfg, model, opt)
        for _ in range(2):
            state, m = step(state, {"tokens": tok})
        assert np.isfinite(float(m["loss"]))
        for path, leaf in topt.unpool_state(state.opt_state).leaves.items():
            p = model.param_dict()[path].detach()
            assert p.dtype == torch.bfloat16
            assert torch.equal(p, leaf.master.to(torch.bfloat16)), path


@pytest.mark.parametrize("layout", ["per_leaf", "pooled"])
def test_muon_bf16_masters_refused(layout):
    """muon8 on bf16 masters was refused before it was ported; it now
    runs as the JAX package's ``impl="jnp"`` apply does, leaf by leaf.
    The quantized matrix leaves' masters are bf16 (Newton–Schulz on the
    master read in f32, the store rounded to nearest even), the other
    leaves' f32.  The Newton–Schulz products sum in another order than
    XLA's, so a master may round to the neighbouring bf16 value and a
    momentum code flip at a midpoint: both counted under ``CODE_FLIPS``,
    the masters within one bf16 step."""
    jp, js, tp, ts = _run("muon8", grad_bf16=False, **LAYOUTS[layout])
    n_matrix = 0
    for path, leaf in ts.leaves.items():
        a, b = path.split("/")
        jleaf = js.leaves[a][b]
        got = _f32(leaf.master)
        want = np.asarray(jleaf.master.astype(jnp.float32))
        if isinstance(leaf, topt.Quant8Leaf) and leaf.codes_r is None:
            n_matrix += 1
            assert leaf.master.dtype == torch.bfloat16
            assert jleaf.master.dtype == jnp.bfloat16
            assert (got != want).sum() <= CODE_FLIPS * got.size, path
            np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                       err_msg=path)
            d = np.abs(leaf.codes_m.numpy().astype(np.int64)
                       - np.asarray(jleaf.codes_m, np.int64))
            assert (d != 0).sum() <= CODE_FLIPS * d.size, path
        else:
            assert leaf.master.dtype == torch.float32
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                       err_msg=path)
        np.testing.assert_allclose(_f32(tp[path]),
                                   np.asarray(jp[a][b], np.float32),
                                   rtol=2 ** -7, atol=1e-6, err_msg=path)
    assert n_matrix == 2


# ------------------------------------------------ the train step, bf16 params
TRAIN_ARCH = "qwen1.5-32b"


def _train_setup():
    jcfg = JB.reduced(JB.get_config(TRAIN_ARCH), param_dtype="bfloat16")
    tcfg = TB.reduced(TB.get_config(TRAIN_ARCH), param_dtype="bfloat16")
    params, _ = JM.init_model(jcfg, jax.random.PRNGKey(0))
    # the JAX package's init is f32 and its masters start there; the
    # port's parameters are bf16: both start from the bf16 values
    params = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16).astype(jnp.float32), params)
    return jcfg, tcfg, params


def _batches(n):
    rng = np.random.RandomState(5)
    return [{"tokens": rng.randint(0, 256, (4, 17)).astype(np.int32)}
            for _ in range(n)]


class _Recorder:
    """An optimizer that records the gradients its train step hands to
    ``apply`` (a pytree, a dict or a GradBuffer), then applies them."""

    def __init__(self, opt):
        self.opt = opt

    def __getattr__(self, name):
        return getattr(self.opt, name)

    def apply(self, grads, state, **kw):
        self.grads = grads
        return self.opt.apply(grads, state, **kw)


GRAD_MODES = {"mb1": (1, dict(pooled=False)), "mb2": (2, dict(pooled=False)),
              "zero2_mb2": (2, dict(shard_grads=True))}


@pytest.mark.parametrize("mode", GRAD_MODES)
def test_bf16_param_grads_match_jax_train_step(mode):
    """The clipped gradients of a bf16-parameter model with bf16 masters,
    as the two train steps hand them to adamw8 (per leaf, or ZeRO-2's
    GradBuffer in the arena's block domain): f32 in both (the JAX
    package's f32 accumulator and buffer, and its clip's f32 product), and
    equal but for a microbatch gradient's rounding to bf16
    (``GRAD_FLIPS``)."""
    jcfg, tcfg, params = _train_setup()
    batch = _batches(1)[0]
    microbatches, layout = GRAD_MODES[mode]
    okw = dict(master_dtype="bfloat16", weight_decay=0.01, **layout)
    jo = _Recorder(jopt.make_optimizer("adamw8", impl="jnp", **okw))
    _, jm = JL.make_train_step(jcfg, jo, JL.TrainHyper(
        microbatches=microbatches))(
        JL.TrainState(jo.init(params), jnp.zeros((), jnp.int32)),
        {"tokens": jnp.asarray(batch["tokens"])})
    model = convert.params_from_numpy(jax.device_get(params), tcfg,
                                      device="cpu")
    to = _Recorder(topt.make_optimizer("adamw8", device="cpu", **okw))
    _, tm = TL.make_train_step(tcfg, model, to, TL.TrainHyper(
        microbatches=microbatches))(
        TL.TrainState(to.init(model.param_dict()), 0), batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=2e-4)
    if "shard_grads" in layout:
        pairs = {"blocks": (to.grads.blocks, jo.grads.blocks)}
    else:
        jg = {path_str(p): v for p, v in
              jax.tree_util.tree_flatten_with_path(jo.grads)[0]}
        assert set(to.grads) == set(jg)
        pairs = {k: (g, jg[k]) for k, g in to.grads.items()}
    off = total = 0
    for path, (g, j) in pairs.items():
        assert g.dtype == torch.float32, path
        assert j.dtype == jnp.float32, path
        off += int((~np.isclose(g.detach().numpy(), np.asarray(j),
                                rtol=GRAD_RTOL, atol=1e-9)).sum())
        total += g.numel()
    assert off <= GRAD_FLIPS * total, (off, total)


TRAIN_LAYOUTS = {"per_leaf": dict(pooled=False), "pooled": dict(pooled=True),
                 "zero2": dict(shard_grads=True)}


@pytest.mark.parametrize("layout", TRAIN_LAYOUTS)
def test_bf16_masters_train_match_jax(layout):
    """Three adamw8 steps over two microbatches with bf16 parameters and
    bf16 masters, against the JAX package's jitted train step (``impl=
    "jnp"``): the loss traces, the masters and the codes."""
    jcfg, tcfg, params = _train_setup()
    batches = _batches(STEPS)
    hyper = dict(microbatches=2)
    okw = dict(master_dtype="bfloat16", weight_decay=0.01,
               **TRAIN_LAYOUTS[layout])
    jo = jopt.make_optimizer("adamw8", impl="jnp", **okw)
    js = JL.TrainState(jo.init(params), jnp.zeros((), jnp.int32))
    jstep = JL.jit_train_step(jcfg, jo, JL.TrainHyper(**hyper), donate=False)
    jm = []
    for b in batches:
        js, m = jstep(js, {"tokens": jnp.asarray(b["tokens"])})
        jm.append(float(m["loss"]))
    model = convert.params_from_numpy(jax.device_get(params), tcfg,
                                      device="cpu")
    to = topt.make_optimizer("adamw8", device="cpu", **okw)
    ts = TL.TrainState(to.init(model.param_dict()), 0)
    tstep = TL.make_train_step(tcfg, model, to, TL.TrainHyper(**hyper))
    tm = []
    for b in batches:
        ts, m = tstep(ts, b)
        tm.append(float(m["loss"]))
    np.testing.assert_allclose(tm, jm, rtol=2e-4)
    jleaves = {path_str(p): leaf for p, leaf in
               jax.tree_util.tree_flatten_with_path(
                   j_unpool(js.opt_state).leaves,
                   is_leaf=lambda x: hasattr(x, "master"))[0]}
    n_quant = 0
    for path, leaf in topt.unpool_state(ts.opt_state).leaves.items():
        if path.endswith("attn/bk"):
            # softmax is invariant to a shift of all keys: the k bias's
            # gradient is zero up to rounding, and Adam's normalized step
            # turns that rounding into steps of +-lr
            continue
        jl = jleaves[path]
        got = _f32(leaf.master)
        want = np.asarray(jl.master.astype(jnp.float32))
        if isinstance(leaf, topt.Quant8Leaf):
            # bf16 masters: equal but where a flipped gradient element
            # moved its moment
            n_quant += 1
            assert leaf.master.dtype == torch.bfloat16, path
            off = got != want
            for slot in ("codes_m", "codes_r"):
                d = (getattr(leaf, slot).numpy().astype(np.int64)
                     != np.asarray(getattr(jl, slot), np.int64))
                assert d.sum() <= GRAD_FLIPS * d.size, (path, slot,
                                                        int(d.sum()))
        else:       # the f32 masters of the 32-bit leaves
            off = ~np.isclose(got, want, rtol=1e-4, atol=1e-5)
        assert off.sum() <= GRAD_FLIPS * got.size, (path, int(off.sum()))
    assert n_quant > 0
