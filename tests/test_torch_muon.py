"""Muon in the port (``kernels/newton_schulz.py``, the muon registry
entries of ``kernels/ops.py``, ``core/optim/muon.py``), held against the
JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs its jnp oracle or its Pallas kernels in interpret mode.

Tolerances, and why:
  * Newton–Schulz: the port's plain version replays the JAX tile loop, but
    each matrix product is summed by PyTorch's CPU GEMM in another order
    than XLA's, so results agree to rounding.  One product of these
    shapes carries a relative error of order sqrt(k) u (k <= 256 terms,
    u = 2^-24), about 1e-6; five quintic iterations keep it there (the
    iteration contracts the singular values into a band around 1).  The
    test holds the result within 1e-5 of the output's largest magnitude.
  * The Muon update: the momentum m2 = beta1 m + g comes before the
    orthogonalization, so codes and absmax are exact (deterministic and
    stochastic: the counter hash is integer work); p is p - lr (rms O +
    wd p) with O from Newton–Schulz, so p is held within lr * 1e-5 (O's
    tolerance times lr) plus one ULP of p (the final subtraction may round
    the other way) of the JAX value, per step.
  * Trajectories: loss traces of the reduced paper LM at the golden tests'
    rtol 2e-4, against a live JAX run (never the committed goldens, which
    fail on this toolchain in the reference itself).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg, tiny_pipe

from repro.core import optim as jopt
from repro.core import qmap as jqm
from repro.core.lowbit import PackedCodes as JPackedCodes
from repro.kernels import newton_schulz as jns
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import model as jm
from repro.train import loop as JL
from repro_torch import convert
from repro_torch.configs import base as tcb
from repro_torch.core import optim as topt
from repro_torch.core.lowbit import PackedCodes
from repro_torch.core.optim import Full32Leaf, MuonOptimizer, Quant8Leaf
from repro_torch.errors import ConfigError
from repro_torch.kernels import newton_schulz as ns
from repro_torch.kernels import ops, ref
from repro_torch.models import model as tm
from repro_torch.train import loop as TL


def T(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _assert_p_close(got, want, lr, steps=1):
    """Muon's p within steps * (lr * 1e-5 + one ULP of p) (module doc)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = steps * (lr * 1e-5 + np.spacing(np.abs(want)))
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def J(x):
    return None if x is None else jnp.asarray(x)


# ----------------------------------------------------- Newton–Schulz (B5, B6)
def test_constants_match_jax():
    assert ns.NS_COEFFS == jns.NS_COEFFS
    assert ns.DEFAULT_NS_STEPS == jns.DEFAULT_NS_STEPS
    assert ns.TILE_N == jns.TILE_N
    for shape in ((128, 64), (64, 128), (33, 33), (1, 7)):
        assert ns.rms_scale(shape) == jns.rms_scale(shape)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("shape", [(48, 130), (130, 48), (8, 256), (33, 33)])
def test_newton_schulz_matches_jax(shape, impl):
    """Against JAX ``impl="jnp"`` (the tile-replaying path its interpret
    kernels match bit for bit) — incl. the transpose path and shapes that
    are not tile multiples; on CPU tensors "cuda" runs the kernels' plain
    versions."""
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    want = np.asarray(jns.newton_schulz(J(x), impl="jnp"))
    got = ns.newton_schulz(T(x), impl=impl).numpy()
    assert got.shape == shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_newton_schulz_orthogonalizes_and_pads():
    """The port's iteration drives the singular values into the band the
    reference's own test checks; gram/apply plain versions are the JAX
    tile loop on zero-padded arrays."""
    x = torch.from_numpy(np.random.RandomState(1).randn(64, 192)
                         .astype(np.float32))
    s = np.linalg.svd(ns.newton_schulz(x, impl="torch").double().numpy(),
                      compute_uv=False)
    assert 0.3 < s.min() and s.max() < 1.4, (s.min(), s.max())
    xp = ns.pad_matrix(torch.ones(10, 300))
    assert xp.shape == (16, 512) and float(xp.sum()) == 3000.0
    a = ns.gram_plain(xp)
    assert a.shape == (16, 16) and float(a[0, 0]) == 300.0


def test_gram_and_apply_wrappers():
    """The kernel wrappers on CPU tensors run the plain versions and count
    no launch; they reject what the kernels do not take."""
    x = torch.from_numpy(np.random.RandomState(2).randn(16, 256)
                         .astype(np.float32))
    ops.reset_launch_counts()
    a = ns.gram_cuda(x)
    assert torch.equal(a, ns.gram_plain(x))
    b = (2.0 * a).contiguous()
    assert torch.equal(ns.apply_cuda(x, b, 0.5), ns.apply_plain(x, b, 0.5))
    assert ops.launch_counts()["ns_gram"] == 0
    assert ops.launch_counts()["ns_apply"] == 0
    with pytest.raises(ValueError):
        ns.gram_cuda(x[:, :100].contiguous())     # n not a multiple of 64
    with pytest.raises(ValueError):
        ns.gram_cuda(x.T.contiguous())            # m > n
    with pytest.raises(ValueError):
        ns.apply_cuda(x, b[:8].contiguous(), 1.0)
    with pytest.raises(KeyError):
        ns.newton_schulz(x, impl="pallas")


def test_muon_math_matches_jax():
    rng = np.random.RandomState(3)
    g, p, m = (rng.randn(48, 70).astype(np.float32) * s
               for s in (0.1, 1.0, 0.01))
    jm2, jp2 = jns.muon_math(J(g), J(p), J(m), beta1=0.95, lr=1e-2,
                             weight_decay=0.01)
    tm2, tp2 = ns.muon_math(T(g), T(p), T(m), beta1=0.95, lr=1e-2,
                            weight_decay=0.01, impl="torch")
    np.testing.assert_array_equal(tm2.numpy(), np.asarray(jm2))
    _assert_p_close(tp2.numpy(), jp2, 1e-2)


# ------------------------------------------------- ("muon", impl) registry
def _muon_inputs(shape, bits, seed=0):
    rng = np.random.RandomState(seed)
    p = rng.randn(*shape).astype(np.float32)
    g = (rng.randn(*shape) * 0.1).astype(np.float32)
    n = shape[0] * shape[1]
    nb, bsz = -(-n // 256), 256
    q = jqm.get_qmap("dynamic", True, bits=bits)
    m0 = np.zeros(nb * bsz, np.float32)
    m0[:n] = rng.randn(n) * 0.01
    cm, am = jref.quantize_ref(J(m0.reshape(nb, bsz)), J(q))
    return p, g, np.asarray(cm), np.asarray(am), q


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
def test_muon_entry_matches_jax_interpret(bits, stochastic, impl):
    """("muon", "torch"/"cuda") against ("muon", "interpret") of the JAX
    package: codes and absmax exact (8-bit and packed 4-bit, deterministic
    and stochastic), p within lr * 1e-5."""
    p, g, cm, am, q = _muon_inputs((48, 66), bits)
    kw = dict(lr=1e-2, beta1=0.95, weight_decay=0.01, gnorm_scale=0.7,
              stochastic=stochastic, seed=123)
    jcm = J(cm) if bits == 8 else JPackedCodes.from_codes(J(cm), bits)
    want = jops.fused_update("muon", J(p), J(g), jcm, J(am), qmap_m=J(q),
                             impl="interpret", **kw)
    tcm = T(cm) if bits == 8 else PackedCodes.from_codes(T(cm), bits)
    ops.reset_fused_update_count()
    got = ops.fused_update("muon", T(p), T(g), tcm, T(am), qmap_m=T(q),
                           impl=impl, **kw)
    assert ops.fused_update_routes() == {impl: 1}
    assert got.codes_r is None and got.absmax_r is None
    if bits == 8:
        np.testing.assert_array_equal(got.codes_m.numpy(),
                                      np.asarray(want.codes_m))
    else:
        assert isinstance(got.codes_m, PackedCodes)
        assert got.codes_m.bits == 4 and got.codes_m.n_codes == 256
        np.testing.assert_array_equal(got.codes_m.packed.numpy(),
                                      np.asarray(want.codes_m.packed))
    np.testing.assert_array_equal(got.absmax_m.numpy(),
                                  np.asarray(want.absmax_m))
    _assert_p_close(got.p.numpy(), want.p, 1e-2)
    if stochastic:          # the seed moves codes
        det = ops.fused_update("muon", T(p), T(g), tcm, T(am), qmap_m=T(q),
                               impl=impl, **dict(kw, stochastic=False))
        a = det.codes_m if bits == 8 else det.codes_m.packed
        b = got.codes_m if bits == 8 else got.codes_m.packed
        assert not torch.equal(a, b)


@pytest.mark.parametrize("bits", [8, 4])
def test_muon_entry_requantizes_the_momentum(bits):
    """The ("muon", "torch") entry, composed by hand from the port's own
    pieces: the new codes and absmax are the block-wise requantization of
    m2 = beta1 m + gnorm_scale g (exact: the momentum comes before the
    orthogonalization), p is p - lr (rms O + wd p) with O the plain
    Newton–Schulz of g + beta1 m2 (within lr * 1e-5)."""
    shape, lr, beta1, wd, gs = (16, 40), 1e-2, 0.95, 0.01, 0.7
    p, g, cm, am, q = _muon_inputs(shape, bits, seed=5)
    tcm = T(cm) if bits == 8 else PackedCodes.from_codes(T(cm), bits)
    got = ops.fused_update("muon", T(p), T(g), tcm, T(am), qmap_m=T(q),
                           lr=lr, beta1=beta1, weight_decay=wd,
                           gnorm_scale=gs, impl="torch")
    n, (nb, bsz) = p.size, cm.shape
    m = ref.dequantize_ref(T(cm), T(am), T(q)).reshape(-1)[:n]
    m2 = torch.tensor(beta1) * m + T(g).reshape(-1) * torch.tensor(gs)
    want_c, want_a = ref.quantize_ref(
        torch.nn.functional.pad(m2, (0, nb * bsz - n)).reshape(nb, bsz),
        T(q))
    got_c = got.codes_m if bits == 8 else got.codes_m.unpack()
    np.testing.assert_array_equal(got_c.numpy(), want_c.numpy())
    np.testing.assert_array_equal(got.absmax_m.numpy(), want_a.numpy())
    o = ns.newton_schulz((T(g) * torch.tensor(gs)) + torch.tensor(beta1)
                         * m2.reshape(shape), impl="torch")
    want_p = T(p) - torch.tensor(lr) * (
        torch.tensor(ns.rms_scale(shape), dtype=torch.float32) * o
        + torch.tensor(wd) * T(p))
    _assert_p_close(got.p.numpy(), want_p.numpy(), lr)


def test_muon_entry_rejects_bad_inputs():
    p, g, cm, am, q = _muon_inputs((16, 40), 8)
    with pytest.raises(ValueError):
        ops.fused_update("muon", T(p).reshape(-1), T(g).reshape(-1), T(cm),
                         T(am), qmap_m=T(q), lr=1e-2)
    with pytest.raises(NotImplementedError):
        ops.fused_update("muon", T(p), T(g), T(cm), T(am), qmap_m=T(q),
                         lr=1e-2, blockwise=False)
    assert ops.registered("muon") == [("muon", "cuda"), ("muon", "torch")]


# ------------------------------------------------ mixed-class engine routing
def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "dense": {"w": rng.randn(64, 128).astype(np.float32),
                  "v": rng.randn(48, 64).astype(np.float32)},
        "vec": rng.randn(2048).astype(np.float32),
        "embed": {"w": rng.randn(128, 64).astype(np.float32)},
        "bias": np.zeros(10, np.float32),
        "small2d": (rng.randn(4, 4) * 0.1).astype(np.float32),
    }


def _flat_torch(params):
    return {k: torch.from_numpy(v.copy())
            for k, v in convert.flatten_tree(params).items()}


def test_muon_routing_table():
    """The per-leaf routing split as the JAX package's
    ``test_muon_routing_table`` builds it (per-leaf layout: the port has no
    pooled arena yet): 2-D leaves carry one quantized momentum slot,
    element-wise leaves keep adamw's two states, the override and small
    leaves f32."""
    opt = topt.make_optimizer("muon8", lr=1e-2, min_8bit_size=1024,
                              device="cpu")
    assert isinstance(opt, MuonOptimizer) and opt._ew_algo == "adamw"
    lv = opt.init(_flat_torch(_params())).leaves
    assert isinstance(lv["dense/w"], Quant8Leaf)           # matrix
    assert lv["dense/w"].codes_r is None                   # one-state
    assert isinstance(lv["vec"], Quant8Leaf)               # ew -> adamw
    assert lv["vec"].codes_r is not None
    assert isinstance(lv["embed/w"], Full32Leaf)           # override
    assert lv["embed/w"].r is not None                     # ...adamw
    assert isinstance(lv["bias"], Full32Leaf) and lv["bias"].r is not None
    assert isinstance(lv["small2d"], Full32Leaf)           # sub-min 2-D
    assert lv["small2d"].r is None                         # ...f32 muon
    lv32 = topt.make_optimizer("muon32", lr=1e-2, device="cpu").init(
        _flat_torch(_params())).leaves
    assert lv32["dense/w"].r is None and lv32["vec"].r is not None
    assert lv32["embed/w"].r is not None       # override routes muon32 too
    # the JAX engine routes the same leaves the same way
    jst = jopt.make_optimizer("muon8", lr=1e-2, min_8bit_size=1024,
                              pooled=False).init(
        jax.tree_util.tree_map(jnp.asarray, _params()))
    jlv = jst.leaves
    for path, tl in lv.items():
        jl = jlv
        for part in path.split("/"):
            jl = jl[part]
        assert type(tl).__name__ == type(jl).__name__, path
        second = tl.codes_r if isinstance(tl, Quant8Leaf) else tl.r
        jsecond = jl.codes_r if isinstance(jl, type(jl)) and hasattr(
            jl, "codes_r") else jl.r
        assert (second is None) == (jsecond is None), path


def test_paper_lm_routing_fact():
    """paper-lm-209m stacks its layers, so ``ndim == 2`` routes its head
    and its stacked (n_layers, d_model) norm vectors to Newton–Schulz, and
    every attention and MLP projection (3-D) to adamw — in both packages
    (the reduced config keeps the layout)."""
    cfg = tcb.reduced(tcb.get_config("paper-lm-209m"))
    model = tm.init_model(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    opt = topt.make_optimizer("muon8", device="cpu")
    params = model.param_dict()
    classes = {k: opt._leaf_class(k, v) for k, v in params.items()}
    matrix = sorted(k for k, c in classes.items() if c == "matrix")
    assert matrix == ["blocks/b0_attn/norm1/bias", "blocks/b0_attn/norm1/scale",
                      "blocks/b0_attn/norm2/bias", "blocks/b0_attn/norm2/scale",
                      "head/w"]
    assert all(params[k].dim() == 3 for k, c in classes.items()
               if c == "ew" and k.startswith("blocks/")
               and "norm" not in k)
    jcfg = tiny_cfg(d_model=cfg.d_model, n_layers=cfg.n_layers,
                    vocab_size=cfg.vocab_size)
    jparams, _ = jm.init_model(jcfg, jax.random.PRNGKey(0))
    jo = jopt.make_optimizer("muon8")
    jmatrix = sorted(
        "/".join(str(getattr(k, "key", k)) for k in path)
        for path, leaf in jax.tree_util.tree_leaves_with_path(jparams)
        if jo._leaf_class("/".join(str(getattr(k, "key", k))
                                   for k in path), leaf) == "matrix")
    assert jmatrix == matrix


def test_base_engine_rejects_matrix_algo():
    with pytest.raises(ValueError, match="matrix-class"):
        topt.Block8bitOptimizer(topt.OptimConfig(algo="muon", pooled=False),
                                device="cpu")
    with pytest.raises(ConfigError):
        MuonOptimizer(topt.OptimConfig(algo="adam", pooled=False),
                      device="cpu")
    with pytest.raises(ValueError):
        topt.make_optimizer("muon8", blockwise_norm=False, device="cpu")


@pytest.mark.parametrize("name,kw", [("muon8", {}), ("muon32", {}),
                                     ("muon8", {"state_bits": (4, 8),
                                                "stochastic_rounding": True})])
def test_engine_matches_jax_leaf_by_leaf(name, kw):
    """Three steps of both engines on the mixed dict: adamw leaves and the
    momentum codes exactly as the element-wise family holds them; masters
    of matrix leaves within lr * 1e-5 (Newton–Schulz rounding); measured
    state bytes equal."""
    params = _params()
    jo = jopt.make_optimizer(name, lr=1e-2, min_8bit_size=1024,
                             pooled=False, weight_decay=0.01, **kw)
    js = jo.init(jax.tree_util.tree_map(jnp.asarray, params))
    to = topt.make_optimizer(name, lr=1e-2, min_8bit_size=1024,
                             weight_decay=0.01, device="cpu", **kw)
    ts = to.init(_flat_torch(params))
    rng = np.random.RandomState(9)
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda v: (rng.randn(*v.shape) * 0.1).astype(np.float32), params)
        _, js = jo.apply(jax.tree_util.tree_map(jnp.asarray, g), js)
        _, ts = to.apply(_flat_torch(g), ts)
    for path, tl in ts.leaves.items():
        jl = js.leaves
        for part in path.split("/"):
            jl = jl[part]
        _assert_p_close(tl.master.numpy(), jl.master, 1e-2, steps=3)
        if isinstance(tl, Quant8Leaf):
            for f in ("codes_m", "codes_r"):
                t, j = getattr(tl, f), getattr(jl, f)
                assert (t is None) == (j is None), (path, f)
                if t is None:
                    continue
                t = t.packed if isinstance(t, PackedCodes) else t
                j = j.packed if isinstance(j, JPackedCodes) else j
                diff = np.abs(t.numpy().astype(int)
                              - np.asarray(j).astype(int))
                # the momentum of a matrix leaf feeds back through p only
                # via the next gradient, which is the same here: exact
                assert diff.max() == 0, (path, f)
    assert to.state_bytes(ts) == jo.state_bytes(js)


# ------------------------------------------------------------ trajectories
STEPS = 10


def _tcfg():
    return tcb.reduced(tcb.get_config("paper-lm-209m"), d_model=64,
                       n_layers=2, vocab_size=128)


@pytest.mark.parametrize("name,kw", [
    ("muon8", {}), ("muon32", {}),
    ("muon8", {"state_bits": (4, 8), "stochastic_rounding": True})])
def test_loss_trace_matches_live_jax(name, kw):
    """10 steps of the reduced paper LM in both packages from the same
    weights on the same batches: loss traces at rtol 2e-4, the same
    state bytes per parameter."""
    jcfg, pipe = tiny_cfg(), tiny_pipe()
    jo = jopt.make_optimizer(name, pooled=False, weight_decay=0.01, lr=1e-2,
                             **kw)
    state, _ = JL.init_train_state(jcfg, jo, jax.random.PRNGKey(0))
    step = JL.jit_train_step(jcfg, jo)
    jloss = []
    for i in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(i).items()}
        state, m = step(state, batch)
        jloss.append(float(m["loss"]))
    params, _ = jm.init_model(jcfg, jax.random.PRNGKey(0))
    model = convert.params_from_numpy(jax.device_get(params), _tcfg(),
                                      device="cpu")
    to = topt.make_optimizer(name, weight_decay=0.01, lr=1e-2, device="cpu",
                             **kw)
    ts = TL.TrainState(to.init(model.param_dict()), 0)
    tstep = TL.make_train_step(model.cfg, model, to)
    tloss = []
    for i in range(STEPS):
        ts, tmet = tstep(ts, pipe.batch_at(i))
        tloss.append(float(tmet["loss"]))
    np.testing.assert_allclose(tloss, jloss, rtol=2e-4)
    assert tmet["state_bytes_per_param"] == pytest.approx(
        float(m["state_bytes_per_param"]), rel=1e-6)
    assert tmet["opt_fused_dispatches"] == float(m["opt_fused_dispatches"])
