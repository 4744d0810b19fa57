"""Differential tests of the port's kernel layer on the CPU, where each
kernel wrapper runs its plain PyTorch version: ``ops.quantize_blockwise`` /
``ops.dequantize_blockwise`` / ``ops.fused_update`` against the JAX
package's Pallas kernels in interpret mode and its jnp oracles, on the same
numpy inputs.

Quantize and dequantize must match exactly.  The fused update's float math
may differ from XLA's by a few ULP (pow, FMA contraction in the
interpreter), so p is held at rtol 1e-6 and a code may differ only where
the normalized state lies within 2 f32 ULP of a codebook midpoint; those
mismatches are counted and bounded, not hidden by a wider tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qmap as jqm
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import common, ops, ref
from repro_torch.kernels import fused_update as fu

QS = jqm.get_qmap("dynamic", True)
QU = jqm.get_qmap("dynamic", False)
# n_blocks not a multiple of the JAX kernels' 8 rows, and an all-zero block
SHAPES = [(1, 128), (3, 2048), (13, 256), (16, 1024)]
HYPER = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)


def T(x):
    return torch.from_numpy(np.array(x))


def _rand(nb, bsz, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(nb, bsz) * scale
            ).astype(np.float32)


def _x(nb, bsz):
    x = _rand(nb, bsz, nb + bsz, 0.01)
    x[nb // 2] = 0.0
    return x


@pytest.mark.parametrize("nb,bsz", SHAPES)
@pytest.mark.parametrize("signed", [True, False])
def test_quantize_matches_jax_exactly(nb, bsz, signed):
    x = _x(nb, bsz) if signed else np.abs(_x(nb, bsz))
    q = QS if signed else QU
    ct, at = ops.quantize_blockwise(T(x), T(q))
    for impl_out in (jops.quantize_blockwise(jnp.asarray(x), jnp.asarray(q),
                                             impl="interpret"),
                     jref.quantize_ref(jnp.asarray(x), jnp.asarray(q))):
        np.testing.assert_array_equal(np.asarray(impl_out[0]), ct.numpy())
        np.testing.assert_array_equal(np.asarray(impl_out[1]), at.numpy())
    # the port's own oracle agrees too
    cr, ar = ref.quantize_ref(T(x), T(q))
    assert torch.equal(cr, ct) and torch.equal(ar, at)


@pytest.mark.parametrize("nb,bsz", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_matches_jax_exactly(nb, bsz, dtype):
    x = _x(nb, bsz)
    c, a = (np.asarray(v) for v in jref.quantize_ref(jnp.asarray(x),
                                                     jnp.asarray(QS)))
    vt = ops.dequantize_blockwise(T(c), T(a), T(QS),
                                  dtype=getattr(torch, dtype))
    assert vt.dtype == getattr(torch, dtype)
    vt = vt.float().numpy()
    for vj in (jops.dequantize_blockwise(jnp.asarray(c), jnp.asarray(a),
                                         jnp.asarray(QS), impl="interpret",
                                         dtype=getattr(jnp, dtype)),
               jref.dequantize_ref(jnp.asarray(c), jnp.asarray(a),
                                   jnp.asarray(QS), getattr(jnp, dtype))):
        np.testing.assert_array_equal(np.asarray(vj, np.float32), vt)


def test_encode_edges():
    bounds = common.padded_bounds(T(QS))
    x = torch.tensor([-2.0, -1.0, 0.0, 1.0, 2.0, float("nan")])
    codes = common.encode(x, bounds)
    assert codes.tolist() == [0, 0, int(np.argmin(np.abs(QS))), 255, 255, 0]


# ------------------------------------------------------------ fused update
def _states(nb, bsz, seed):
    cm, am = jref.quantize_ref(jnp.asarray(_rand(nb, bsz, seed, 0.01)),
                               jnp.asarray(QS))
    cr, ar = jref.quantize_ref(
        jnp.asarray(np.abs(_rand(nb, bsz, seed + 1, 1e-4))), jnp.asarray(QU))
    return [np.asarray(v) for v in (cm, am, cr, ar)]


def _near_boundary_mismatches(x2, absmax, codes_a, codes_b, q):
    """(#mismatching codes, #mismatches NOT explained by x2/absmax lying
    within 2 f32 ULP of the midpoint between the two codes)."""
    bad = codes_a != codes_b
    if not bad.any():
        return 0, 0
    scale = np.where(absmax > 0, absmax, 1.0).astype(np.float32)
    xn = (x2 / scale[:, None])[bad]
    lo = np.minimum(codes_a[bad], codes_b[bad]).astype(np.int64)
    bnd = jqm.boundaries(q)[np.minimum(lo, 254)]
    ulp = np.abs(np.spacing(bnd))
    near = (np.abs(xn - bnd) <= 2 * ulp) & \
        (np.abs(codes_a[bad].astype(int) - codes_b[bad].astype(int)) == 1)
    return int(bad.sum()), int((~near).sum())


def _new_states(p, g, cm, am, cr, ar, step):
    """The post-update f32 states (m2, r2), from the shared update math."""
    s = fu.scalars(step=step, gnorm_scale=1.0, device="cpu", **HYPER)
    m = common.decode(T(cm), T(QS)) * T(am)[:, None]
    r = common.decode(T(cr), T(QU)) * T(ar)[:, None]
    m2, r2, _ = fu.update_math(fu.ALGO_SPECS["adam"], T(g), T(p), m, r, s)
    return m2.numpy(), r2.numpy()


@pytest.mark.parametrize("nb,bsz", [(3, 2048), (13, 256)])
@pytest.mark.parametrize("jax_impl", ["interpret", "jnp"])
@pytest.mark.parametrize("algo", ["adam", "adamw"])
@pytest.mark.parametrize("steps", [1, 3])
def test_fused_update_matches_jax(algo, jax_impl, nb, bsz, steps):
    p = _rand(nb, bsz, 2)
    cm, am, cr, ar = _states(nb, bsz, 4)
    jstate = [jnp.asarray(v) for v in (p, cm, am, cr, ar)]
    tstate = [T(v) for v in (p, cm, am, cr, ar)]
    n_mis = 0
    for i in range(steps):
        step = 7.0 + i
        g = _rand(nb, bsz, 10 + i, 0.1)
        prev = [np.asarray(v) for v in jstate]
        jres = jops.fused_update(algo, jstate[0], jnp.asarray(g), *jstate[1:],
                                 jnp.asarray(QS), jnp.asarray(QU),
                                 impl=jax_impl, step=step, **HYPER)
        tres = ops.fused_update(algo, tstate[0], T(g), *tstate[1:], T(QS),
                                T(QU), step=step, **HYPER)
        np.testing.assert_allclose(tres.p.numpy(), np.asarray(jres.p),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tres.absmax_m.numpy(),
                                   np.asarray(jres.absmax_m), rtol=1e-6)
        np.testing.assert_allclose(tres.absmax_r.numpy(),
                                   np.asarray(jres.absmax_r), rtol=1e-6)
        m2, r2 = _new_states(prev[0], g, *prev[1:], step)
        for x2, a, ct, cj, q in (
                (m2, tres.absmax_m, tres.codes_m, jres.codes_m, QS),
                (r2, tres.absmax_r, tres.codes_r, jres.codes_r, QU)):
            mis, unexplained = _near_boundary_mismatches(
                x2, a.numpy(), ct.numpy(), np.asarray(cj), q)
            assert unexplained == 0, (mis, unexplained)
            n_mis += mis
        jstate = [jres.p, jres.codes_m, jres.absmax_m, jres.codes_r,
                  jres.absmax_r]
        tstate = [tres.p, tres.codes_m, tres.absmax_m, tres.codes_r,
                  tres.absmax_r]
    # near-boundary flips are rare: at most 1 in 10^4 codes
    assert n_mis <= 2 * nb * bsz * steps // 10_000, n_mis


@pytest.mark.parametrize("algo", ["adam", "adamw"])
def test_fused_update_plain_matches_oracle(algo):
    """The wrapper's plain version (compare-count semantics, in place)
    against the port's oracle (searchsorted + gather, new tensors)."""
    nb, bsz = 5, 512
    p, g = _rand(nb, bsz, 2), _rand(nb, bsz, 3, 0.1)
    cm, am, cr, ar = _states(nb, bsz, 4)
    kw = dict(step=3.0, gnorm_scale=0.5, **HYPER)
    want = ops.fused_update(algo, T(p), T(g), T(cm), T(am), T(cr), T(ar),
                            T(QS), T(QU), impl="torch", **kw)
    ins = [T(v) for v in (p, g, cm, am, cr, ar)]
    got = ops.fused_update(algo, *ins, T(QS), T(QU), impl="cuda", **kw)
    for a, b in zip(got[:5], want[:5]):
        assert torch.equal(a, b)
    # in place: the result holds the input tensors, overwritten
    for t, r in zip((ins[0], *ins[2:]), got[:5]):
        assert t is r


@pytest.mark.parametrize("algo,kw", [
    ("adamw", {}), ("adamw", dict(stochastic=True, seed=7)),
    ("momentum", {}), ("adagrad", dict(stochastic=True, seed=3)),
    ("adam", dict(pooled=True, stochastic=True)), ("adam", dict(bits=4)),
    ("lamb", {})], ids=["adamw", "adamw_sr", "momentum", "adagrad_sr",
                        "adam_pooled_sr", "adam_4bit", "lamb_whole"])
def test_torch_oracle_chunks_bit_identical(algo, kw, monkeypatch):
    """The torch oracle runs a large call PLAIN_CHUNK blocks at a time
    (each chunk with its blocks' seeds and element offsets) and gives the
    whole call's bits; lamb, whose trust ratio spans the leaf, runs
    whole."""
    from repro_torch.core.lowbit import PackedCodes
    nb, bsz = 37, 64
    kw = dict(kw)
    p, g = _rand(nb, bsz, 5), _rand(nb, bsz, 6, 0.1)
    cm, am, cr, ar = _states(nb, bsz, 8)
    if not fu.ALGO_SPECS[algo].n_states == 2:
        cr = ar = None
    extra = dict(step=2.0, gnorm_scale=0.5, **HYPER)
    if kw.pop("pooled", False):
        extra.update(block_seeds=torch.arange(nb, dtype=torch.int32) % 3,
                     block_offsets=torch.arange(nb, dtype=torch.int32) % 11)
    qm, qr = T(QS), T(QU)
    if kw.pop("bits", 8) == 4:
        cm = PackedCodes(torch.zeros((nb, bsz // 2), dtype=torch.uint8), 4,
                         nb * bsz)
        qm = T(jqm.get_qmap("dynamic", True, bits=4))
    extra.update(kw)
    tensors = lambda v: None if v is None else T(v)
    args = lambda: (T(p), T(g), cm if isinstance(cm, PackedCodes) else
                    T(cm), T(am), tensors(cr), tensors(ar), qm, qr)
    whole = ops.fused_update(algo, *args(), impl="torch", **extra)
    monkeypatch.setattr(fu, "PLAIN_CHUNK", 8)
    chunked = ops.fused_update(algo, *args(), impl="torch", **extra)
    # bits, not values: adagrad's state read through the signed codebook
    # here has negative values, whose square roots are NaN
    bits = lambda t: (lambda r: r.view(torch.int32) if r.is_floating_point()
                      else r)(getattr(t, "packed", t))
    for a, b in zip(whole[:5], chunked[:5]):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(bits(a), bits(b))


def test_registry_and_counters():
    assert ops.registered("adamw") == [("adamw", "cuda"), ("adamw", "plain"),
                                       ("adamw", "torch")]
    # "cuda" is registered for every algorithm: the fused-update kernel's
    # and muon's (whose entry runs the quantize and Newton–Schulz kernels);
    # "plain" (the fused-update kernels' plain versions on any device) for
    # the element-wise ones only
    assert sorted(a for a, i in ops.registered() if i == "cuda") == \
        sorted(ops.ALGOS) == sorted([*fu.KERNEL_ALGOS, "muon"])
    assert sorted(a for a, i in ops.registered() if i == "plain") == \
        sorted(fu.KERNEL_ALGOS)
    assert ops.registered("muon") == [("muon", "cuda"), ("muon", "torch")]
    ops.reset_launch_counts()
    ops.reset_fused_update_count()
    nb, bsz = 2, 256
    cm, am, cr, ar = _states(nb, bsz, 1)
    ops.fused_update("adam", T(_rand(nb, bsz, 0)), T(_rand(nb, bsz, 1)),
                     T(cm), T(am), T(cr), T(ar), T(QS), T(QU), lr=1e-3)
    ops.quantize_blockwise(T(_rand(nb, bsz, 2)), T(QS))
    assert ops.fused_update_count() == 1
    # CPU runs of the plain versions are not kernel launches
    assert ops.launch_counts() == {"blockwise_quant": 0,
                                   "blockwise_dequant": 0, "fused_update": 0,
                                   "norm_partials": 0, "ns_gram": 0,
                                   "ns_apply": 0}
    with pytest.raises(KeyError):
        ops.fused_update("adam", None, None, None, None, lr=1e-3,
                         impl="pallas")
    with pytest.raises(KeyError):
        ops.fused_update("muon", None, None, None, None, lr=1e-3,
                         impl="pallas")
    # the tensor-wise ablation is served by the oracle, and counted so
    ops.fused_update("adam", *(T(v) for v in (_rand(nb, bsz, 0),
                                              _rand(nb, bsz, 1), cm, am,
                                              cr, ar)), T(QS), T(QU),
                     lr=1e-3, blockwise=False, stochastic=True)
    assert ops.fused_update_routes() == {"cuda": 1, "torch": 1}
    assert ops.fused_update_count() == 2


def test_wrappers_reject_bad_inputs():
    x = T(_rand(4, 256, 0))
    with pytest.raises(TypeError):
        ops.quantize_blockwise(x.double(), T(QS))
    with pytest.raises(ValueError):
        ops.quantize_blockwise(x[:, :254], T(QS))          # not contiguous
    with pytest.raises(ValueError):
        ops.quantize_blockwise(T(_rand(4, 130, 0)), T(QS))  # B % 4 != 0
    c, a = ops.quantize_blockwise(x, T(QS))
    with pytest.raises(ValueError):
        ops.dequantize_blockwise(c, a[:3], T(QS))
    with pytest.raises(TypeError):
        ops.dequantize_blockwise(c, a, T(QS), dtype=torch.float16)
    with pytest.raises(ValueError):
        fu.fused_update_cuda(x, x, c, a, c, a, T(QS), T(QU), algo="muon",
                             lr=1e-3)
    with pytest.raises(ValueError):       # a two-state algorithm needs r
        fu.fused_update_cuda(x, x, c, a, None, None, T(QS), T(QU),
                             algo="lamb", lr=1e-3)
    with pytest.raises(ValueError):       # no norm prologue for adam
        fu.norm_partials_cuda(x, x, c, a, c, a, T(QS), T(QU), algo="adam")
