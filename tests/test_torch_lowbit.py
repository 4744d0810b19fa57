"""Packed 4/5/6-bit optimizer states in the port (``core/lowbit`` and the
packed fused update), held against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
port's "cuda" backend runs its kernels' plain versions on CPU tensors (the
kernels themselves are checked bit for bit against those plain versions
in ``tests/test_torch_kernels_emulated.py`` and on the card by
``chip_smoke.py``); the JAX side runs its jnp oracle, and its Pallas
kernel in interpret mode at the shapes its own tests use.

Tolerances, and why:
  * Bit packing, the codebooks, block-wise quantize (deterministic and
    stochastic) and dequantize are integer work or one rounding on equal
    inputs: exact.
  * The packed update runs the same float ops as the 8-bit one: against
    the jnp oracle exact for adam and momentum (deterministic and
    stochastic), and for lamb's codes and absmax (its states do not depend
    on the trust ratio, whose sums run in another order: p within 4 ULP of
    the larger operand of p - step).  Against the interpret-mode kernel,
    which may contract or reorder a few ops: p and absmax within 4 ULP,
    and a code may differ only by one level, only where the new state lies
    within 4 ULP of the midpoint between the two levels (deterministic) —
    each mismatch is checked; with stochastic rounding a flip also needs
    the uniform within a few ULP of the rounding probability, so those are
    held to one level and counted (at most 1 in 1000).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qmap as jqm
from repro.core.lowbit import format as jformat
from repro.core.lowbit import packing as jpack
from repro.kernels import common as jcommon
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import optim as topt
from repro_torch.core.lowbit import (CodeFormat, PackedCodes, pack_codes,
                                     packed_width, unpack_codes,
                                     unwrap_codes)
from repro_torch.errors import FormatError
from repro_torch.kernels import blockwise_dequant as bdq
from repro_torch.kernels import blockwise_quant as bq
from repro_torch.kernels import fused_update as fu
from repro_torch.kernels import ops

HYPER = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
             step=7.0, trust_coeff=1e-3)


def T(x):
    return None if x is None else torch.from_numpy(np.array(x))


def J(x):
    return None if x is None else jnp.asarray(x)


def _codes(shape, bits, seed):
    return np.random.RandomState(seed).randint(0, 1 << bits, shape)


# ------------------------------------------------------------- bit packing
@pytest.mark.parametrize("bits", [4, 5, 6, 8])
@pytest.mark.parametrize("shape", [(1, 8), (3, 16), (5, 264), (2, 2048),
                                   (2, 3, 40)])
def test_pack_unpack_matches_jax(bits, shape):
    """Packed bytes equal the JAX package's bit for bit (5- and 6-bit codes
    straddle bytes in every row here), and unpacking either gives the
    codes back."""
    codes = _codes(shape, bits, bits * 100 + shape[-1])
    got = pack_codes(T(codes), bits)
    want = np.asarray(jpack.pack_codes(J(codes.astype(np.int32)), bits))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape[-1] == packed_width(shape[-1], bits)
    np.testing.assert_array_equal(unpack_codes(T(want), bits).numpy(), codes)
    np.testing.assert_array_equal(
        np.asarray(jpack.unpack_codes(J(got.numpy()), bits)), codes)


def test_pack_layout_is_msb_first_bitstream():
    """5-bit codes 1, 2, 3, ... as one big-endian bitstream: 00001 00010
    00011 00100 00101 00110 00111 01000 -> 0x08 0x86 0x42 0x98 0xE8."""
    got = pack_codes(torch.arange(1, 9).reshape(1, 8), 5)
    assert got.tolist() == [[0x08, 0x86, 0x42, 0x98, 0xE8]]


def test_packed_width_and_errors():
    for n, bits in ((2048, 4), (2048, 5), (2048, 6), (2048, 8), (8, 5)):
        assert packed_width(n, bits) == jpack.packed_width(n, bits)
    with pytest.raises(FormatError):
        packed_width(2048, 3)
    with pytest.raises(FormatError):
        packed_width(6, 5)                  # 30 bits: not whole bytes
    with pytest.raises(FormatError):
        unpack_codes(torch.zeros(2, 5, dtype=torch.uint8), 7)


def test_packed_codes_container():
    codes = T(_codes((3, 264), 5, 1))
    pc = PackedCodes.from_codes(codes, 5)
    assert pc.bits == 5 and pc.n_codes == 264
    assert pc.shape == (3, 264) and pc.nbytes() == 3 * 165
    assert torch.equal(pc.unpack(), codes.to(torch.int32))
    raw, bits, n = unwrap_codes(pc)
    assert raw is pc.packed and (bits, n) == (5, 264)
    plain = torch.zeros(2, 8, dtype=torch.uint8)
    assert unwrap_codes(plain) == (plain, 8, None)


@pytest.mark.parametrize("bits", [4, 5, 6, 8])
@pytest.mark.parametrize("signed", [True, False])
def test_code_format_matches_jax(bits, signed):
    tf = CodeFormat(bits=bits, signed=signed)
    jf = jformat.CodeFormat(bits=bits, signed=signed)
    np.testing.assert_array_equal(tf.codebook(), jf.codebook())
    assert (tf.n_levels, tf.max_code, tf.zero_code()) == \
        (jf.n_levels, jf.max_code, jf.zero_code())
    assert tf.bytes_per_param(2048) == jf.bytes_per_param(2048)
    got, want = tf.init_codes(5, 2048, "cpu"), jf.init_codes(5, 2048)
    if bits == 8:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        assert isinstance(got, PackedCodes) and got.bits == bits
        np.testing.assert_array_equal(got.packed.numpy(),
                                      np.asarray(want.packed))
    with pytest.raises(FormatError):
        CodeFormat(bits=3)


# ------------------------------------------------------ quantize, dequantize
def _x(nb, bsz, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(nb, bsz) * np.exp(rng.randn(nb, 1) * 2)).astype(np.float32)
    x[nb // 2] = 0.0
    return x


@pytest.mark.parametrize("bits", [4, 5, 6, 8])
@pytest.mark.parametrize("seed", [None, 11, -4])
def test_quantize_dequantize_bits_match_jax(bits, seed):
    """B1 with ``bits`` (and the Muon requantize's stochastic rounding: the
    counter hash at element index row * B + col, seed + the state-1 salt)
    and B2 with ``bits``, exact against the JAX oracles + packing."""
    x = _x(5, 264, 3)
    q = jqm.get_qmap("dynamic", True, bits=bits)
    codes, absmax = ops.quantize_blockwise(T(x), T(q), bits=bits, seed=seed)
    u = None
    if seed is not None:
        u = jcommon.hash_uniform(
            jcommon.element_indices(5, 264, 0),
            jnp.asarray(seed, jnp.int32).astype(jnp.uint32)
            + jnp.uint32(jcommon.STATE1_SEED_SALT))
    jc, ja = jref._requantize(J(x), J(q), blockwise=True, random_u=u)
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jpack.pack_codes(jc, bits)))
    np.testing.assert_array_equal(absmax.numpy(), np.asarray(ja))
    got = ops.dequantize_blockwise(codes, absmax, T(q), bits=bits)
    want = jref.dequantize_ref(jnp.asarray(jc), ja, J(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, bdq.dequantize_plain(codes, absmax, T(q),
                                                 bits=bits))
    assert torch.equal(codes, bq.quantize_plain(T(x), T(q), bits=bits,
                                                seed=seed)[0])


def test_quantize_bits_rejects_bad_inputs():
    q4 = T(jqm.get_qmap("dynamic", True, bits=4))
    with pytest.raises(ValueError):          # 256-entry map for 4-bit codes
        ops.quantize_blockwise(T(_x(2, 64, 0)), T(jqm.get_qmap(
            "dynamic", True)), bits=4)
    with pytest.raises(ValueError):          # packed rows need B % 8 == 0
        ops.quantize_blockwise(T(_x(2, 68, 0)), q4, bits=4)
    with pytest.raises(ValueError):
        ops.dequantize_blockwise(torch.zeros(2, 32, dtype=torch.uint8),
                                 torch.ones(2), q4, bits=3)


# ------------------------------------------------------- the packed update
def _packed_args(algo, nb, bsz, bits_m, bits_r):
    """(p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r) as
    numpy, codes packed (the JAX package's packed test inputs)."""
    spec = fu.ALGO_SPECS[algo]
    two = spec.n_states == 2
    rng = np.random.RandomState(nb * 31 + bsz + bits_m)
    p = rng.randn(nb, bsz).astype(np.float32)
    g = (rng.randn(nb, bsz) * 0.1).astype(np.float32)
    q1 = jqm.get_qmap("dynamic", spec.state1_signed, bits=bits_m)
    q2 = jqm.get_qmap("dynamic", False, bits=bits_r)
    m0 = (rng.randn(nb, bsz) * 0.01).astype(np.float32)
    if not spec.state1_signed:
        m0 = np.abs(m0)
    cm, am = jref.quantize_ref(J(m0), J(q1))
    cm = np.asarray(jpack.pack_codes(cm, bits_m))
    cr = ar = None
    if two:
        cr, ar = jref.quantize_ref(
            jnp.abs(J((rng.randn(nb, bsz) * 1e-4).astype(np.float32))),
            J(q2))
        cr, ar = np.asarray(jpack.pack_codes(cr, bits_r)), np.asarray(ar)
    return [p, g, cm, np.asarray(am), cr, ar, q1, q2 if two else None]


def _jax(algo, args, bits, impl, **kw):
    cm = jpack.PackedCodes(J(args[2]), bits[0], args[0].shape[1])
    cr = (None if args[4] is None
          else jpack.PackedCodes(J(args[4]), bits[1], args[0].shape[1]))
    res = jops.fused_update(algo, J(args[0]), J(args[1]), cm, J(args[3]),
                            cr, J(args[5]), J(args[6]), J(args[7]),
                            impl=impl, **dict(HYPER, **kw))
    return res


def _port(algo, args, bits, impl="cuda", **kw):
    n = args[0].shape[1]
    cm = PackedCodes(T(args[2]), bits[0], n)
    cr = None if args[4] is None else PackedCodes(T(args[4]), bits[1], n)
    return ops.fused_update(algo, T(args[0]), T(args[1]), cm, T(args[3]),
                            cr, T(args[5]), T(args[6]), T(args[7]),
                            impl=impl, **dict(HYPER, **kw))


def _unpacked(res, field, bits):
    c = getattr(res, field)
    if c is None:
        return None
    if isinstance(c, PackedCodes):
        assert c.bits == bits
        return c.unpack().numpy()
    assert isinstance(c, jpack.PackedCodes) and c.bits == bits
    return np.asarray(c.unpack())


def _ulps(a, b, operand=None):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ref = np.abs(b) if operand is None else np.maximum(
        np.abs(b), np.abs(np.asarray(operand, np.float32)))
    return np.abs(a.astype(np.float64) - b) / np.spacing(ref)


def _new_states(algo, args, bits):
    """The update's new states (m2, r2) in f32, from the port's plain
    math: where a code may legitimately flip."""
    spec = fu.ALGO_SPECS[algo]
    s = fu.scalars(device="cpu", gnorm_scale=1.0,
                   **{k: v for k, v in HYPER.items() if k != "trust_coeff"})
    g, p = T(args[1]), T(args[0])
    m = fu.common.decode(unpack_codes(T(args[2]), bits[0]), T(args[6])) \
        * T(args[3])[:, None]
    r = None
    if args[4] is not None:
        r = fu.common.decode(unpack_codes(T(args[4]), bits[1]), T(args[7])) \
            * T(args[5])[:, None]
    s["tensor_scale"] = torch.ones(())
    m2, r2, _ = fu.update_math(spec, g, p, m, r, s)
    return m2.numpy(), None if r2 is None else r2.numpy()


def _flips_at_midpoints(x2, absmax, a, b, q, ulps=4):
    """Mismatching codes are one level apart with x2 / absmax within
    ``ulps`` ULP of the midpoint between the two levels."""
    bad = a != b
    if not bad.any():
        return 0
    assert (np.abs(a[bad].astype(int) - b[bad].astype(int)) == 1).all()
    scale = np.where(absmax > 0, absmax, 1.0).astype(np.float32)
    xn = (x2 / scale[:, None])[bad]
    lo = np.minimum(a[bad], b[bad]).astype(np.int64)
    bnd = jqm.boundaries(q)[lo]
    assert (np.abs(xn - bnd) <= ulps * np.spacing(np.abs(bnd))).all()
    return int(bad.sum())


BITS = [(4, 8), (5, 6)]


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", BITS, ids=lambda b: f"{b[0]}-{b[1]}")
@pytest.mark.parametrize("algo", ["adam", "lamb", "momentum"])
def test_packed_update_matches_jax_jnp(algo, bits, stochastic):
    """Against the JAX jnp oracle: adam and momentum exact (p, packed
    codes, absmax); lamb's codes and absmax exact, p within 4 ULP of the
    larger operand (its trust ratio is summed in another order).  Through
    the kernel path's plain version and the port's own oracle."""
    args = _packed_args(algo, 4, 512, *bits)
    want = _jax(algo, args, bits, "jnp", stochastic=stochastic, seed=9)
    for impl in ("cuda", "torch"):
        got = _port(algo, args, bits, impl, stochastic=stochastic, seed=9)
        for field, b in (("codes_m", bits[0]), ("codes_r", bits[1])):
            w = _unpacked(want, field, b)
            t = _unpacked(got, field, b)
            assert (w is None) == (t is None)
            if w is not None:
                np.testing.assert_array_equal(t, w, err_msg=field)
                np.testing.assert_array_equal(
                    getattr(got, field).packed.numpy(),
                    np.asarray(getattr(want, field).packed))
        for f in ("absmax_m", "absmax_r"):
            w, t = getattr(want, f), getattr(got, f)
            if w is not None:
                np.testing.assert_array_equal(t.numpy(), np.asarray(w))
        if algo == "lamb":
            assert _ulps(got.p.numpy(), want.p, args[0]).max() <= 4
        else:
            np.testing.assert_array_equal(got.p.numpy(), np.asarray(want.p))


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", BITS, ids=lambda b: f"{b[0]}-{b[1]}")
@pytest.mark.parametrize("algo", ["adam", "lamb", "momentum"])
def test_packed_update_matches_jax_interpret(algo, bits, stochastic):
    """Against the Pallas kernel in interpret mode (packed codes unpacked
    and re-packed in its VMEM): p and absmax within 4 ULP; code flips one
    level apart, at midpoints (deterministic) or counted (stochastic)."""
    args = _packed_args(algo, 2, 256, *bits)
    want = _jax(algo, args, bits, "interpret", stochastic=stochastic,
                seed=5)
    got = _port(algo, args, bits, stochastic=stochastic, seed=5)
    assert _ulps(got.p.numpy(), want.p, args[0]).max() <= 4
    m2, r2 = _new_states(algo, args, bits)
    for field, absmax, x2, q, b in (
            ("codes_m", "absmax_m", m2, args[6], bits[0]),
            ("codes_r", "absmax_r", r2, args[7], bits[1])):
        w = _unpacked(want, field, b)
        if w is None:
            assert getattr(got, field) is None
            continue
        t = _unpacked(got, field, b)
        am = getattr(got, absmax).numpy()
        assert _ulps(am, getattr(want, absmax)).max() <= 4
        if stochastic:
            diff = np.abs(t.astype(int) - w.astype(int))
            assert diff.max() <= 1 and (diff > 0).sum() <= diff.size // 1000
        else:
            _flips_at_midpoints(x2, am, t, w, q)


def test_packed_segment_tensor_scales():
    """lamb's per-block trust ratio from packed states: the kernel path
    (norm prologue + finalize) and the oracle agree with the JAX jnp
    oracle to rounding (the sums run in other orders: rtol from their
    length, as in tests/test_torch_optim_family.py)."""
    bits = (4, 8)
    args = _packed_args("lamb", 4, 512, *bits)
    n = args[0].shape[1]
    jwant = np.asarray(jops.segment_tensor_scales(
        "lamb", J(args[0]), J(args[1]),
        jpack.PackedCodes(J(args[2]), 4, n), J(args[3]),
        jpack.PackedCodes(J(args[4]), 8, n), J(args[5]), J(args[6]),
        J(args[7]), impl="jnp", segments=((0, 1), (1, 3)),
        **{k: v for k, v in HYPER.items()}))
    for impl in ("cuda", "torch"):
        got = ops.segment_tensor_scales(
            "lamb", T(args[0]), T(args[1]), PackedCodes(T(args[2]), 4, n),
            T(args[3]), PackedCodes(T(args[4]), 8, n), T(args[5]),
            T(args[6]), T(args[7]), impl=impl, segments=((0, 1), (1, 3)),
            **HYPER)
        np.testing.assert_allclose(got.numpy(), jwant, rtol=1e-5)


def test_fused_update_rejects_mismatched_codebooks():
    args = _packed_args("adam", 2, 256, 4, 8)
    args[6] = jqm.get_qmap("dynamic", True)          # 256 levels, 4-bit codes
    with pytest.raises(ValueError, match="levels"):
        _port("adam", args, (4, 8))


# ------------------------------------------------ the engine, every width
WIDTHS = [4, 5, 6, 8]


@pytest.mark.parametrize("bits_m", WIDTHS)
@pytest.mark.parametrize("algo", ["adam", "adamw", "momentum", "lamb",
                                  "lars", "adagrad"])
def test_every_algo_and_width_builds_and_steps(algo, bits_m):
    """``make_optimizer("<algo>8", state_bits=(b, 8 or b))`` builds and
    steps in the port on the CPU for every element-wise algorithm and
    width, its states packed at sub-byte widths, and matches the JAX
    engine's packed state bytes."""
    from repro.core import optim as jopt
    bits = (bits_m, 8 if bits_m == 4 else bits_m)
    opt = topt.make_optimizer(f"{algo}8", state_bits=bits, device="cpu",
                              min_8bit_size=64)
    params = {"w": torch.randn(24, 64, generator=torch.Generator()
                               .manual_seed(0))}
    state = opt.init(params)
    before = params["w"].clone()
    for i in range(2):
        _, state = opt.apply({"w": torch.full((24, 64), 0.01 * (i + 1))},
                             state)
    leaf = state.leaves["w"]
    assert bool(torch.isfinite(params["w"]).all())
    assert not torch.equal(params["w"], before)
    assert isinstance(leaf.codes_m, PackedCodes) == (bits[0] < 8)
    if leaf.codes_r is not None:
        assert isinstance(leaf.codes_r, PackedCodes) == (bits[1] < 8)
    jo = jopt.make_optimizer(f"{algo}8", state_bits=bits, pooled=False,
                             min_8bit_size=64)
    js = jo.init({"w": jnp.zeros((24, 64))})
    assert opt.state_bytes(state) == jo.state_bytes(js)
    assert opt.cfg.state_bytes_per_param() == jo.cfg.state_bytes_per_param()
