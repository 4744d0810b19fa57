"""Differential tests: the port's codebooks and block quantization
(``repro_torch.core.qmap`` / ``core.blockwise``) against the JAX package's,
on the same numpy inputs.  Integer work and the lookups are held to exact
equality (ROADMAP comparison rules)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blockwise as jbw
from repro.core import qmap as jqm
from repro_torch.core import blockwise as tbw
from repro_torch.core import qmap as tqm

MAPS = sorted(jqm.QMAPS)


def _blocks(nb, bsz, seed, signed=True):
    """Blocks with per-block scales over many decades, one all-zero block."""
    rng = np.random.RandomState(seed)
    x = rng.randn(nb, bsz) * np.exp(rng.randn(nb, 1) * 3)
    x[nb // 2] = 0.0
    x = x if signed else np.abs(x)
    return x.astype(np.float32)


@pytest.mark.parametrize("bits", [4, 5, 6, 8])
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("name", MAPS)
def test_qmap_matches_jax(name, signed, bits):
    a = jqm.get_qmap(name, signed, bits=bits)
    b = tqm.get_qmap(name, signed, bits=bits)
    assert b.dtype == np.float32 and b.shape == (2 ** bits,)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("name", MAPS)
def test_boundaries_match_jax(name, signed):
    q = jqm.get_qmap(name, signed)
    np.testing.assert_array_equal(jqm.boundaries(q), tqm.boundaries(q))


def test_unknown_qmap_raises():
    with pytest.raises(ValueError):
        tqm.get_qmap("nope", True)


@pytest.mark.parametrize("nb,bsz", [(1, 128), (4, 256), (7, 512), (3, 2048),
                                    (16, 1024)])
@pytest.mark.parametrize("signed", [True, False])
def test_quantize_dequantize_blocks_exact(nb, bsz, signed):
    x = _blocks(nb, bsz, seed=nb * bsz, signed=signed)
    cb = jqm.get_qmap("dynamic", signed)
    cj, aj = jbw.quantize_blocks(jnp.asarray(x), jnp.asarray(cb))
    ct, at = tbw.quantize_blocks(torch.from_numpy(x), torch.from_numpy(cb))
    assert ct.dtype == torch.uint8 and at.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    np.testing.assert_array_equal(np.asarray(aj), at.numpy())
    dj = jbw.dequantize_blocks(cj, aj, jnp.asarray(cb))
    dt = tbw.dequantize_blocks(ct, at, torch.from_numpy(cb))
    np.testing.assert_array_equal(np.asarray(dj), dt.numpy())


def test_nearest_code_and_padding_exact():
    cb = jqm.get_qmap("dynamic", True)
    bounds = jqm.boundaries(cb)
    x = np.linspace(-1.2, 1.2, 4001, dtype=np.float32)
    x = np.concatenate([x, bounds, np.nextafter(bounds, np.float32(2))])
    np.testing.assert_array_equal(
        np.asarray(jbw.nearest_code(jnp.asarray(x), jnp.asarray(bounds))),
        tbw.nearest_code(torch.from_numpy(x), torch.from_numpy(bounds)).numpy())
    flat = np.arange(1000, dtype=np.float32)
    np.testing.assert_array_equal(
        np.asarray(jbw.pad_to_blocks(jnp.asarray(flat), 256)),
        tbw.pad_to_blocks(torch.from_numpy(flat), 256).numpy())


@pytest.mark.parametrize("shape,block_size,pad_to",
                         [((5, 7, 33), 64, 1), ((1000,), 256, 4),
                          ((64, 64), 2048, 1), ((3, 2049), 2048, 2)])
@pytest.mark.parametrize("signed", [True, False])
def test_quantize_roundtrip_and_error(shape, block_size, pad_to, signed):
    rng = np.random.RandomState(len(shape) + block_size)
    x = rng.randn(*shape).astype(np.float32)
    x = x if signed else np.abs(x)
    kw = dict(signed=signed, block_size=block_size, pad_blocks_to=pad_to)
    qj = jbw.quantize(jnp.asarray(x), **kw)
    qt = tbw.quantize(torch.from_numpy(x), **kw)
    np.testing.assert_array_equal(np.asarray(qj.codes), qt.codes.numpy())
    np.testing.assert_array_equal(np.asarray(qj.absmax), qt.absmax.numpy())
    assert qt.shape == qj.shape and qt.nbytes() == qj.nbytes()
    assert qt.block_size == qj.block_size
    assert qt.n_elements == qj.n_elements
    np.testing.assert_array_equal(np.asarray(jbw.dequantize(qj)),
                                  tbw.dequantize(qt).numpy())
    # The error is a mean of the (exactly equal) elementwise errors; only
    # the f32 summation order of the mean differs between XLA and PyTorch.
    np.testing.assert_allclose(
        float(jbw.quantization_error(jnp.asarray(x), qj)),
        float(tbw.quantization_error(torch.from_numpy(x), qt)), rtol=1e-6)
