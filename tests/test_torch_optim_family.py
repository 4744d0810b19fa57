"""The rest of the paper's element-wise 8-bit optimizer family in the port
(momentum, lars, lamb, adagrad, stochastic rounding, the tensor-wise
ablation, Adafactor), held against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
port's "cuda" backend runs its kernels' plain versions on CPU tensors; the
JAX side runs its jnp oracle, and its Pallas kernels in interpret mode at
the shapes its own tests use.

Tolerances, and why:
  * Integer work (the counter hash, element indices, the stochastic
    choice) and every update whose float ops are the same sequence in both
    packages (momentum, adagrad, adam tensor-wise, stochastic adam) are
    exact against the jnp oracle.  The interpret-mode kernel may contract
    or reorder a few ops: p within 4 ULP, codes off only at a midpoint.
  * lamb and lars need a trust ratio, a sum over the whole leaf.  The port
    sums in its kernel's fixed order (``fused_update.block_sums``, then the
    pairwise ``tree_sum_rows``), XLA in its own, so the ratios differ by
    rounding.  A sum of n non-negative f32 terms carries a relative error of
    at most (n - 1) u in any order (u = 2^-24) and in practice about
    sqrt(n) u; the largest sum here has n = 13 * 2048 = 26624 terms,
    sqrt(n) u = 9.7e-6 — hence rtol 1e-5 on the lars local lr, which is
    ||p|| / ||g|| (square roots halve the error, the quotient adds the two).
    lamb's states do not depend on its trust ratio: codes and absmax exact,
    p within 4 ULP.  lars's momentum does: a code may flip, but only by one
    level and only where m2 / absmax lies within 4 ULP of the midpoint
    between the two codes — each mismatch is checked.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg, tiny_pipe

from repro.core import optim as jopt
from repro.core import qmap as jqm
from repro.core.lowbit import packing as jpack
from repro.core.optim import base as jbase
from repro.kernels import common as jcommon
from repro.kernels import fused_update as jfu
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import model as jm
from repro.train import loop as JL
from repro_torch import convert
from repro_torch.configs import base as tcb
from repro_torch.core import blockwise as tbw
from repro_torch.core import optim as topt
from repro_torch.core.optim import base as tbase
from repro_torch.errors import ConfigError
from repro_torch.kernels import common, ops, ref
from repro_torch.kernels import fused_update as fu
from repro_torch.train import loop as TL

QS = jqm.get_qmap("dynamic", True)
QU = jqm.get_qmap("dynamic", False)
HYPER = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
             step=7.0, trust_coeff=1e-3)
U = 2.0 ** -24


def T(x):
    return None if x is None else torch.from_numpy(np.array(x))


def J(x):
    return None if x is None else jnp.asarray(x)


def _rand(nb, bsz, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(nb, bsz) * scale
            ).astype(np.float32)


def _inputs(algo, nb, bsz):
    """(p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r) as
    numpy, as the JAX package's ``_fused_inputs`` builds them."""
    two = fu.ALGO_SPECS[algo].n_states == 2
    p, g = _rand(nb, bsz, 2), _rand(nb, bsz, 3, 0.1)
    if algo == "adagrad":
        cm, am = jref.quantize_ref(jnp.abs(J(_rand(nb, bsz, 4, 1e-3))), QU)
        q1 = QU
    else:
        cm, am = jref.quantize_ref(J(_rand(nb, bsz, 4, 0.01)), QS)
        q1 = QS
    cr = ar = None
    if two:
        cr, ar = jref.quantize_ref(jnp.abs(J(_rand(nb, bsz, 5, 1e-4))), QU)
    return [p, g] + [None if v is None else np.asarray(v)
                     for v in (cm, am, cr, ar)] + [q1, QU]


def _jax(algo, args, impl, **kw):
    return jops.fused_update(algo, *(J(a) for a in args), impl=impl,
                             **dict(HYPER, **kw))


def _port(algo, args, impl="cuda", **kw):
    return ops.fused_update(algo, *(T(a) for a in args), impl=impl,
                            **dict(HYPER, **kw))


def _ulps(a, b, operand=None):
    """|a - b| in units of the f32 spacing at b, or at the larger of b and
    ``operand`` — for p2 = p - step, the larger operand of the subtraction
    (where the two nearly cancel, an error in the step is many ULPs of the
    small result but a fraction of one of p)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ref = np.abs(b) if operand is None else np.maximum(
        np.abs(b), np.abs(np.asarray(operand, np.float32)))
    return np.abs(a.astype(np.float64) - b) / np.spacing(ref)


def _assert_exact(res_t, res_j):
    for name, t, j in zip(res_j._fields[:5], res_t[:5], res_j[:5]):
        if j is None:
            assert t is None, name
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=name)


def _codes_near_midpoint(x2, absmax, codes_a, codes_b, q, ulps):
    """Mismatching codes: each one level apart, with x2 / absmax within
    ``ulps`` f32 ULP of the midpoint between the two levels.  Returns the
    number of mismatches."""
    bad = codes_a != codes_b
    if not bad.any():
        return 0
    scale = np.where(absmax > 0, absmax, 1.0).astype(np.float32)
    xn = (x2 / scale[:, None])[bad]
    lo = np.minimum(codes_a[bad], codes_b[bad]).astype(np.int64)
    assert (np.abs(codes_a[bad].astype(int) - codes_b[bad].astype(int))
            == 1).all()
    bnd = jqm.boundaries(q)[np.minimum(lo, 254)]
    assert (np.abs(xn - bnd) <= ulps * np.spacing(np.abs(bnd))).all()
    return int(bad.sum())


# ------------------------------------------------------ B0: hash, rounding
@pytest.mark.parametrize("seed", [0, 1, 123, -5, 2 ** 31 - 1, -2 ** 31,
                                  jcommon.STATE2_SEED_SALT - 2 ** 32])
def test_hash_uniform_matches_jax(seed):
    idx = np.random.RandomState(0).randint(0, 2 ** 32, 4096,
                                           dtype=np.uint64)
    want = jcommon.hash_uniform(jnp.asarray(idx.astype(np.uint32)),
                                jnp.asarray(seed, jnp.int32)
                                .astype(jnp.uint32))
    got = common.hash_uniform(torch.from_numpy(idx.astype(np.int64)), seed)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert common.STATE2_SEED_SALT == jcommon.STATE2_SEED_SALT
    assert common.STATE1_SEED_SALT == jcommon.STATE1_SEED_SALT


def test_element_indices_matches_jax():
    for rows, cols, off in ((3, 7, 0), (5, 2048, 1000), (2, 8, 2 ** 30)):
        np.testing.assert_array_equal(
            common.element_indices(rows, cols, off).numpy(),
            np.asarray(jcommon.element_indices(rows, cols, off)))


def test_stochastic_codes_and_requantize_match_jax():
    rng = np.random.RandomState(7)
    x = (rng.randn(6, 512) * np.exp(rng.randn(6, 1))).astype(np.float32)
    x[2] = 0.0
    u = rng.rand(6, 512).astype(np.float32)
    for q in (QS, QU):
        xq = x if q is QS else np.abs(x)
        jc, ja = jcommon.block_requantize(
            J(xq), jcommon.padded_bounds(q), jcommon.padded_qmap(q),
            random_u=J(u))
        tc, ta = common.block_requantize(T(xq), common.padded_bounds(T(q)),
                                         T(q), random_u=T(u))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        det, _ = common.block_requantize(T(xq), common.padded_bounds(T(q)))
        assert (tc != det).any() and ((tc - det).abs() <= 1).all()
    # the shared choice function on its own
    args = [rng.rand(64).astype(np.float32) for _ in range(3)] + \
        [rng.randint(0, 255, 64), rng.randint(0, 255, 64),
         rng.rand(64).astype(np.float32)]
    xn, qn, qo, codes, other, uu = args
    np.testing.assert_array_equal(
        common.stochastic_codes(T(xn), T(codes), T(qn), T(qo), T(other),
                                T(uu)).numpy(),
        np.asarray(jcommon.stochastic_codes(J(xn), J(codes), J(qn), J(qo),
                                            J(other), J(uu))))


def test_quantize_blocks_stochastic_invariants():
    """core/blockwise's stochastic rounding draws from a torch.Generator
    (a JAX key cannot be reproduced): every code is the nearest one or its
    neighbour on the far side, and the mean over draws is unbiased where
    deterministic rounding is not."""
    q = torch.as_tensor(QS)
    x = torch.full((1, 2048), 0.3)
    x[0, 0] = 1.0
    det, _ = tbw.quantize_blocks(x, q)
    with pytest.raises(ValueError):
        tbw.quantize_blocks(x, q, stochastic_rounding=True)
    means = []
    for seed in range(30):
        c, a = tbw.quantize_blocks(x, q, stochastic_rounding=True,
                                   generator=torch.Generator()
                                   .manual_seed(seed))
        assert ((c.int() - det.int()).abs() <= 1).all()
        means.append(float(tbw.dequantize_blocks(c, a, q).mean()))
    exact = float(x.mean())
    det_mean = float(tbw.dequantize_blocks(det, a, q).mean())
    assert abs(det_mean - exact) > 1e-6
    assert abs(np.mean(means) - exact) < abs(det_mean - exact)
    qt = tbw.quantize(x.reshape(-1), stochastic_rounding=True,
                      generator=torch.Generator().manual_seed(0))
    assert qt.codes.shape == (1, 2048)


# ------------------------------------------------ B4: norm prologue + final
def test_tree_sum_rows_order():
    x = np.random.RandomState(0).rand(13, 8).astype(np.float32)
    rows = [x[i] for i in range(13)] + [np.zeros(8, np.float32)] * 3
    while len(rows) > 1:
        half = len(rows) // 2
        rows = [(rows[i] + rows[i + half]).astype(np.float32)
                for i in range(half)]
    np.testing.assert_array_equal(fu.tree_sum_rows(T(x)).numpy(), rows[0])


@pytest.mark.parametrize("algo", ["lamb", "lars"])
def test_tensor_scale_from_norms_matches_jax(algo):
    """The finalization math itself, on identical squared norms, is exact
    (guards included: a zero ||p|| or ||u|| gives 1)."""
    spec, jspec = fu.ALGO_SPECS[algo], jfu.ALGO_SPECS[algo]
    rng = np.random.RandomState(1)
    for pn2, gn2, un2 in list(rng.rand(20, 3).astype(np.float32)) + [
            np.float32([0, 1, 1]), np.float32([1, 1, 0])]:
        want = jfu.tensor_scale_from_norms(
            jspec, *map(jnp.float32, (pn2, gn2, un2)),
            weight_decay=jnp.float32(0.01), trust_coeff=jnp.float32(1e-3))
        got = fu.tensor_scale_from_norms(
            spec, *map(torch.tensor, (pn2, gn2, un2)),
            weight_decay=torch.tensor(0.01), trust_coeff=torch.tensor(1e-3))
        assert float(got) == float(want)


@pytest.mark.parametrize("algo", ["lamb", "lars"])
@pytest.mark.parametrize("segments", [((0, 1), (1, 1), (2, 2)),
                                      ((0, 5), (5, 8)), ((0, 13),),
                                      ((0, 3),)])
def test_segment_scales_from_partials_matches_jax(algo, segments):
    """Same partials into both finalizes: exact where the two summation
    orders coincide (segments of at most two blocks), within the bound
    from the sum's length otherwise; blocks past the last segment get 1."""
    rng = np.random.RandomState(3)
    parts = np.zeros((13, 8), np.float32)
    parts[:, :3] = rng.rand(13, 3) * np.exp(rng.randn(13, 1))
    want = np.asarray(jfu.segment_scales_from_partials(
        jfu.ALGO_SPECS[algo], J(parts), segments, 13, jnp.float32(0.01),
        jnp.float32(1e-3)))
    got = fu.segment_scales_from_partials(
        fu.ALGO_SPECS[algo], T(parts), segments, 13, 0.01, 1e-3).numpy()
    n_max = max(n for _, n in segments)
    if n_max <= 2:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2 * n_max * U, atol=0)
    end = sum(n for _, n in segments)
    assert (got[end:] == 1.0).all()


@pytest.mark.parametrize("algo", ["lamb", "lars"])
@pytest.mark.parametrize("nb,bsz", [(2, 256), (4, 512)])
def test_norm_partials_match_jax_interpret(algo, nb, bsz):
    """Per-block partials against the Pallas prologue in interpret mode:
    each is a sum of B non-negative terms in another order, so rtol is
    B u (the worst-case bound); the unused slots are exactly 0."""
    args = _inputs(algo, nb, bsz)
    scal = jops._scalars_vec(HYPER["lr"], HYPER["beta1"], HYPER["beta2"],
                             HYPER["eps"], HYPER["weight_decay"],
                             HYPER["step"], 0.5, HYPER["trust_coeff"])
    two = algo == "lamb"
    jargs = [J(a) for a in args]
    want = np.asarray(jfu._norm_partials_pallas(
        jfu.ALGO_SPECS[algo], jargs[0], jargs[1], jargs[2], jargs[3],
        jargs[4], jargs[5], jcommon.padded_qmap(args[6]),
        jcommon.padded_qmap(args[7]) if two else None, scal, rows=nb,
        bits_m=8, bits_r=8, interpret=True))
    got = fu.norm_partials_cuda(*(T(a) for a in args), algo=algo,
                                gnorm_scale=0.5, **{
                                    k: HYPER[k] for k in
                                    ("beta1", "beta2", "eps",
                                     "weight_decay", "step")}).numpy()
    assert got.shape == (nb, 8)
    np.testing.assert_allclose(got, want, rtol=bsz * U, atol=0)
    assert (got[:, 3:] == 0).all() and ((got[:, 2] > 0) == two).all()


# ----------------------------------------------- B3(b), B3(c): the update
@pytest.mark.parametrize("algo", ["momentum", "adagrad"])
@pytest.mark.parametrize("nb,bsz", [(2, 256), (4, 512), (13, 2048)])
@pytest.mark.parametrize("stochastic", [False, True])
def test_block_local_algos_match_jax(algo, nb, bsz, stochastic):
    """momentum and adagrad (adagrad's single state on the unsigned map):
    exact against the jnp oracle, through the kernel path's plain version
    and through the port's own oracle."""
    args = _inputs(algo, nb, bsz)
    want = _jax(algo, args, "jnp", stochastic=stochastic, seed=77)
    for impl in ("cuda", "torch"):
        got = _port(algo, args, impl, stochastic=stochastic, seed=77)
        assert got.codes_r is None and got.absmax_r is None
        _assert_exact(got, want)


@pytest.mark.parametrize("algo", ["momentum", "adagrad", "adam"])
@pytest.mark.parametrize("nb,bsz", [(2, 256), (4, 512)])
def test_block_local_algos_match_jax_interpret(algo, nb, bsz):
    """Against the Pallas kernel in interpret mode: p within 4 ULP,
    absmax within 4 ULP, codes off only at a midpoint."""
    args = _inputs(algo, nb, bsz)
    want = _jax(algo, args, "interpret", stochastic=True, seed=5)
    got = _port(algo, args, stochastic=True, seed=5)
    assert _ulps(got.p.numpy(), want.p, args[0]).max() <= 4
    assert _ulps(got.absmax_m.numpy(), want.absmax_m).max() <= 4
    assert (np.abs(got.codes_m.numpy().astype(int)
                   - np.asarray(want.codes_m).astype(int)) <= 1).all()


@pytest.mark.parametrize("nb,bsz", [(2, 256), (4, 512), (13, 2048)])
def test_adam_tensorwise_and_stochastic_match_jax(nb, bsz):
    """The tensor-wise ablation (one absmax per tensor, served by the
    oracle on every backend) and stochastic adam: exact against jnp."""
    args = _inputs("adam", nb, bsz)
    got = _port("adam", args, blockwise=False)
    _assert_exact(got, _jax("adam", args, "jnp", blockwise=False))
    assert (got.absmax_m.numpy() == got.absmax_m.numpy()[0]).all()
    _assert_exact(_port("adam", args, stochastic=True, seed=-3),
                  _jax("adam", args, "jnp", stochastic=True, seed=-3))


def test_block_seeds_and_offsets_match_jax():
    """Per-block seeds and leaf-local offsets (how a pooled dispatch keeps
    each leaf's rounding) give the JAX oracle's codes."""
    args = _inputs("adam", 6, 256)
    seeds = np.array([3, 3, 3, -9, -9, 2 ** 31 - 1], np.int32)
    offs = np.array([0, 1, 2, 0, 1, 0], np.int32)
    want = jops.fused_update("adam", *(J(a) for a in args), impl="jnp",
                             stochastic=True, block_seeds=J(seeds),
                             block_offsets=J(offs), **HYPER)
    for impl in ("cuda", "torch"):
        _assert_exact(_port("adam", args, impl, stochastic=True,
                            block_seeds=T(seeds), block_offsets=T(offs)),
                      want)


@pytest.mark.parametrize("nb,bsz", [(2, 256), (4, 512), (13, 2048)])
@pytest.mark.parametrize("stochastic", [False, True])
def test_lamb_matches_jax(nb, bsz, stochastic):
    """lamb: codes and absmax exact (its states do not depend on the trust
    ratio), p within 4 ULP of the larger operand of p - (lr * ts) * u (the
    trust ratio differs by rounding)."""
    args = _inputs("lamb", nb, bsz)
    impls = ["jnp"] + (["interpret"] if nb * bsz <= 2048 else [])
    for jimpl in impls:
        want = _jax("lamb", args, jimpl, stochastic=stochastic, seed=11)
        for impl in ("cuda", "torch"):
            got = _port("lamb", args, impl, stochastic=stochastic, seed=11)
            for name in ("codes_m", "absmax_m", "codes_r", "absmax_r"):
                if jimpl == "jnp":
                    np.testing.assert_array_equal(
                        getattr(got, name).numpy(),
                        np.asarray(getattr(want, name)), err_msg=name)
            assert _ulps(got.p.numpy(), want.p, args[0]).max() <= 4, \
                (jimpl, impl)


@pytest.mark.parametrize("nb,bsz", [(2, 256), (4, 512), (13, 2048)])
def test_lars_matches_jax(nb, bsz):
    """lars: the local lr within rtol 1e-5 (module docstring), p within
    rtol 1e-6, and every code that differs is one level apart with its m2
    within 4 ULP of the midpoint between the two levels."""
    args = _inputs("lars", nb, bsz)
    ts_port = ops.segment_tensor_scales("lars", *(T(a) for a in args),
                                        **HYPER).numpy()
    n_mis = 0
    for jimpl in ["jnp"] + (["interpret"] if nb * bsz <= 2048 else []):
        ts_jax = np.asarray(jops.segment_tensor_scales(
            "lars", *(J(a) for a in args), impl=jimpl, **HYPER))
        np.testing.assert_allclose(ts_port, ts_jax, rtol=1e-5)
        want = _jax("lars", args, jimpl)
        got = _port("lars", args)
        np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(got.absmax_m.numpy(),
                                   np.asarray(want.absmax_m), rtol=1e-5)
        # the port's own new state, from its own trust ratio
        s = dict(fu.scalars(gnorm_scale=1.0, device="cpu",
                            **{k: v for k, v in HYPER.items()
                               if k != "trust_coeff"}),
                 tensor_scale=T(ts_port)[:, None])
        m = common.decode(T(args[2]), T(QS)) * T(args[3])[:, None]
        m2, _, _ = fu.update_math(fu.ALGO_SPECS["lars"], T(args[1]),
                                  T(args[0]), m, None, s)
        n_mis += _codes_near_midpoint(m2.numpy(), got.absmax_m.numpy(),
                                      got.codes_m.numpy(),
                                      np.asarray(want.codes_m), QS, 4)
    assert n_mis <= max(1, nb * bsz // 10_000)
    # the port's oracle takes the whole-tensor sum, as the jnp oracle does
    ts_ref = ops.segment_tensor_scales("lars", *(T(a) for a in args),
                                       impl="torch", **HYPER).numpy()
    np.testing.assert_allclose(ts_ref, ts_port, rtol=1e-5)


@pytest.mark.parametrize("algo", ["adam", "lars"])
def test_fused_update_stochastic_parity(algo):
    """Mirrors the JAX test: the kernel path's stochastic rounding uses the
    reference's counter hash, so codes agree with both JAX impls for the
    same seed, and another seed changes them."""
    args = _inputs(algo, 2, 256)
    got = _port(algo, args, stochastic=True, seed=123)
    for jimpl in ("jnp", "interpret"):
        want = _jax(algo, args, jimpl, stochastic=True, seed=123)
        mism = int((got.codes_m.numpy() != np.asarray(want.codes_m)).sum())
        assert mism <= 512 * 0.001, (jimpl, mism)
    other = _port(algo, args, stochastic=True, seed=124)
    assert (got.codes_m != other.codes_m).any()


def test_fused_update_stochastic_mean_preserving():
    """Mirrors the JAX test: averaged over seeds, stochastic requantization
    is closer to the exact 32-bit state than deterministic rounding."""
    nb, bsz = 1, 2048
    q = torch.as_tensor(QS)
    p = torch.zeros(nb, bsz)
    g = torch.full((nb, bsz), 0.3)
    g[0, 0] = 1.0
    cm, am = ref.quantize_ref(torch.zeros(nb, bsz), q)
    kw = dict(HYPER, lr=0.0, weight_decay=0.0)
    exact = float(g.mean())

    def mean_of(res):
        return float(ref.dequantize_ref(res.codes_m, res.absmax_m, q).mean())

    det = ops.fused_update("momentum", p.clone(), g, cm.clone(), am.clone(),
                           None, None, q, None, **kw)
    det_mean = mean_of(det)
    assert abs(det_mean - exact) > 1e-6
    means = [mean_of(ops.fused_update(
        "momentum", p.clone(), g, cm.clone(), am.clone(), None, None, q,
        None, stochastic=True, seed=seed, **kw)) for seed in range(30)]
    assert abs(np.mean(means) - exact) < abs(det_mean - exact)


# ------------------------------------------------------------- the engine
BLOCK = 256
SHAPES = {"layer": {"w": (70, 64), "bias": (64,)},
          "embed": {"table": (80, 64)}, "head": {"w": (64, 128)}}


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


@pytest.mark.parametrize("name,kw", [
    ("momentum8", {}), ("adagrad8", {}), ("lamb8", {}), ("lars8", {}),
    ("adamw8", {"stochastic_rounding": True}),
    ("adam8", {"blockwise_norm": False}),
    ("momentum32", {}), ("adagrad32", {}), ("lamb32", {}), ("lars32", {}),
    ("adam8", {"state_bits": (4, 8)}), ("lamb8", {"state_bits": (5, 6)}),
    ("momentum8", {"state_bits": 4, "stochastic_rounding": True}),
    ("adagrad8", {"state_bits": 6})])
def test_engine_matches_jax_leaf_by_leaf(name, kw):
    """Three steps of both engines on the same params and gradients (the
    stochastic seeds derive from the step and the leaf index in both)."""
    params = _params()
    jo = jopt.make_optimizer(name, pooled=False, block_size=BLOCK,
                             weight_decay=0.01, **kw)
    js = jo.init(jax.tree_util.tree_map(jnp.asarray, params))
    to = topt.make_optimizer(name, block_size=BLOCK, weight_decay=0.01,
                             pooled=False, device="cpu", **kw)
    ts = to.init({k: torch.from_numpy(v.copy())
                  for k, v in convert.flatten_tree(params).items()})
    for i in range(3):
        g = _grads(i)
        _, js = jo.apply(jax.tree_util.tree_map(jnp.asarray, g), js)
        _, ts = to.apply({k: torch.from_numpy(v) for k, v in
                          convert.flatten_tree(g).items()}, ts)
    jleaves = {jbase.path_str(p): leaf for p, leaf in
               jax.tree_util.tree_leaves_with_path(
                   js.leaves, is_leaf=lambda x: isinstance(
                       x, (jbase.Quant8Leaf, jbase.Full32Leaf)))}
    assert sorted(jleaves) == sorted(ts.leaves)
    exact = not name.startswith("lars")
    for path, jl in jleaves.items():
        tl = ts.leaves[path]
        assert type(tl).__name__ == type(jl).__name__, path
        np.testing.assert_allclose(tl.master.numpy(), np.asarray(jl.master),
                                   rtol=1e-6, atol=1e-8, err_msg=path)
        if isinstance(tl, tbase.Quant8Leaf):
            for f in ("codes_m", "absmax_m", "codes_r", "absmax_r"):
                t, j = getattr(tl, f), getattr(jl, f)
                if isinstance(j, jpack.PackedCodes):   # packed k-bit codes
                    assert (t.bits, t.n_codes) == (j.bits, j.n_codes)
                    t, j = t.unpack(), j.unpack()
                if j is None:
                    assert t is None, (path, f)
                elif exact or f.startswith("absmax"):
                    np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                               rtol=0 if exact else 1e-5,
                                               err_msg=(path, f))
                else:
                    diff = np.abs(t.numpy().astype(int)
                                  - np.asarray(j).astype(int))
                    assert diff.max() <= 1 and (diff > 0).sum() <= 2
        else:
            for f in ("m", "r"):
                t, j = getattr(tl, f), getattr(jl, f)
                assert (t is None) == (j is None), (path, f)
                if j is not None:
                    # lars's momentum sums terms scaled by a trust ratio that
                    # differs by rounding; where they cancel, hold it at the
                    # tensor's scale
                    j = np.asarray(j)
                    floor = 1e-12 if exact else 1e-5 * np.abs(j).max()
                    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5,
                                               atol=floor, err_msg=(path, f))
    assert to.state_bytes(ts) == jo.state_bytes(js)


def test_optim_config_matches_jax():
    """OptimConfig keeps every field and default of the reference, and the
    per-algorithm state layout (adagrad: one unsigned state) agrees."""
    import dataclasses
    jfields = {f.name: f.default for f in dataclasses.fields(
        jopt.OptimConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(
        topt.OptimConfig)}
    assert tfields == jfields
    for algo in fu.ALGO_SPECS:
        for bits in (8, 32):
            jc = jopt.OptimConfig(algo=algo, bits=bits)
            tc = topt.OptimConfig(algo=algo, bits=bits)
            assert tc.has_second_moment == jc.has_second_moment
            assert tc.state_bytes_per_param() == jc.state_bytes_per_param()
        assert fu.ALGO_SPECS[algo].__dict__ == jfu.ALGO_SPECS[algo].__dict__
    opt = topt.make_optimizer("adagrad8", device="cpu")
    assert opt._fmt1.signed is False and opt._qmap1.min() >= 0


def _loss(p, target):
    return sum(((a - b) ** 2).sum() for a, b in zip(p.values(),
                                                    target.values()))


def _run(name, steps=150, lr=3e-2, **kw):
    """The JAX test_optim harness in the port: drive params to 0.5."""
    rng = np.random.RandomState(0)
    params = {"dense/w": torch.from_numpy(
                  rng.randn(64, 128).astype(np.float32)),
              "embed/w": torch.from_numpy(
                  rng.randn(128, 64).astype(np.float32)),
              "bias": torch.zeros(10)}
    target = {k: torch.full_like(v, 0.5) for k, v in params.items()}
    l0 = float(_loss(params, target))
    opt = topt.make_optimizer(name, lr=lr, min_8bit_size=1024, device="cpu",
                              **kw)
    st = opt.init(params)
    for _ in range(steps):
        grads = {k: 2 * (params[k] - target[k]) for k in params}
        _, st = opt.apply(grads, st)
    return l0, float(_loss(params, target)), opt, st


def test_momentum_converges():
    _, l8, _, _ = _run("momentum8", lr=1e-2)
    assert l8 < 1e-3


@pytest.mark.parametrize("name", [n for n in topt.optimizer_names()])
def test_all_optimizers_decrease_loss(name):
    l0, lend, _, _ = _run(name, steps=100, lr=1e-2)
    assert np.isfinite(lend) and lend < l0


def test_tensorwise_ablation_runs():
    _, l, _, st = _run("adam8", blockwise_norm=False)
    assert np.isfinite(l)
    am = st.leaves["dense/w"].absmax_m
    assert (am == am[0]).all()


def test_stochastic_rounding_path():
    _, l, _, _ = _run("adagrad8", steps=1, lr=1e-2,
                      stochastic_rounding=True)
    assert np.isfinite(l)


def test_stochastic_rounding_needs_no_key():
    """Seeds derive from the step counter: the same step rounds the same
    way, the next step differently."""
    rng = np.random.RandomState(0)
    w = rng.randn(64, 128).astype(np.float32)
    g = {"dense/w": torch.from_numpy(rng.randn(64, 128).astype(np.float32))}

    def fresh():
        opt = topt.make_optimizer("adam8", lr=1e-2, min_8bit_size=1024,
                                  stochastic_rounding=True, pooled=False,
                                  device="cpu")
        return opt, opt.init({"dense/w": torch.from_numpy(w.copy())})

    opt, st = fresh()
    _, st1 = opt.apply(g, st)        # in place: a fresh state per replay
    c1 = st1.leaves["dense/w"].codes_m.clone()
    opt_b, st_b = fresh()
    _, st1b = opt_b.apply(g, st_b)   # same step -> same seed -> same codes
    assert torch.equal(c1, st1b.leaves["dense/w"].codes_m)
    _, st2 = opt.apply(g, st1)       # next step -> different rounding
    assert not torch.equal(c1, st2.leaves["dense/w"].codes_m)


def test_adagrad_single_state():
    opt = topt.make_optimizer("adagrad8", lr=1e-2, min_8bit_size=1024,
                              override_32bit=lambda p: False, pooled=False,
                              device="cpu")
    st = opt.init({"dense/w": torch.zeros(64, 128), "bias": torch.zeros(10)})
    leaf = st.leaves["dense/w"]
    assert leaf.codes_r is None and leaf.absmax_r is None
    assert st.leaves["bias"].r is None


def test_bias_correction_first_step_magnitude():
    """After one step from zero state, Adam's update is ~ lr * sign(g)."""
    opt = topt.make_optimizer("adam32", lr=0.1, weight_decay=0.0,
                              device="cpu")
    p = {"w": torch.zeros(8)}
    st = opt.init(p)
    p2, _ = opt.apply({"w": torch.full((8,), 3.0)}, st)
    np.testing.assert_allclose(p2["w"].numpy(), -0.1, rtol=1e-3)


def test_unported_algorithms_raise():
    """Every algorithm of the JAX package is ported; an unknown one raises,
    and the element-wise engine rejects the matrix-class muon (which
    ``make_optimizer`` routes to ``MuonOptimizer``), as the JAX package's
    does."""
    with pytest.raises(ConfigError):
        topt.OptimConfig(algo="sgd", pooled=False)
    with pytest.raises(ValueError, match="matrix-class"):
        topt.Block8bitOptimizer(topt.OptimConfig(algo="muon", pooled=False),
                                device="cpu")


# ------------------------------------------------------------ trajectories
STEPS = 10


def _tcfg():
    return tcb.reduced(tcb.get_config("paper-lm-209m"), d_model=64,
                       n_layers=2, vocab_size=128)


@pytest.mark.parametrize("name,kw", [
    ("momentum8", {}), ("lars8", {}), ("lamb8", {}), ("adagrad8", {}),
    ("adamw8", {"stochastic_rounding": True}), ("adafactor32", {}),
    ("adam8", {"state_bits": (4, 8)}),
    ("lamb8", {"state_bits": (5, 6), "stochastic_rounding": True})])
def test_loss_trace_matches_live_jax(name, kw):
    """10 steps of the reduced paper LM in both packages from the same
    weights on the same batches: loss traces at rtol 2e-4."""
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
        ts, tm = tstep(ts, pipe.batch_at(i))
        tloss.append(float(tm["loss"]))
    np.testing.assert_allclose(tloss, jloss, rtol=2e-4)
    assert tm["state_bytes_per_param"] == pytest.approx(
        float(m["state_bytes_per_param"]), rel=1e-6)
