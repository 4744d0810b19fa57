"""The paged KV cache's row quantizer, append and gather-dequant, held bit
for bit against the JAX package (``repro.kernels.paged_kv``) on the same
numpy inputs: the codebook, quantize/dequantize at 4 and 8 bits, the
append's drop of out-of-range page ids, and the gather against the JAX
oracle (``impl="jnp"``) and the Pallas kernel in interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_kv as jkv
from repro_torch.errors import FormatError
from repro_torch.kernels import paged_kv as tkv


def _rows(shape, seed):
    """Rows over many decades, an all-zero row, and a row whose
    largest-magnitude value is negative (the signed dynamic map's lowest
    level is -0.993, so that row is not symmetric to its mirror)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape) * np.exp(rng.randn(*shape[:-1], 1) * 2)
    x = x.reshape(-1, shape[-1])
    x[0] = 0.0
    x[1] = np.abs(x[1])
    x[1, 3] = -2 * np.abs(x[1]).max()
    return x.reshape(shape).astype(np.float32)


@pytest.mark.parametrize("bits", [4, 8])
def test_kv_qmap_matches_jax(bits):
    np.testing.assert_array_equal(tkv.kv_qmap(bits).numpy(),
                                  np.asarray(jkv.kv_qmap(bits)))
    assert tkv.kv_qmap(bits).shape == (2 ** bits,)


@pytest.mark.parametrize("shape", [(5, 3, 16), (2, 4, 2, 64), (7, 8)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_rows_matches_jax(bits, shape):
    x = _rows(shape, 0)
    cj, aj = jkv.quantize_rows(jnp.asarray(x), bits)
    ct, at = tkv.quantize_rows(torch.from_numpy(x), bits)
    assert ct.dtype == torch.uint8 and ct.shape == cj.shape
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        vj = np.asarray(jkv.dequantize_rows(cj, aj, jdt, bits)
                        .astype(jnp.float32))
        vt = tkv.dequantize_rows(ct, at, tdt, bits)
        assert vt.dtype == tdt
        np.testing.assert_array_equal(vt.float().numpy(), vj)


def test_quantize_rows_bf16_input_matches_jax():
    """Prefill stores k/v in the compute dtype; the commit quantizes those
    bf16 rows (upcast to f32 first in both packages)."""
    x = _rows((6, 2, 16), 3)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    for bits in (4, 8):
        cj, aj = jkv.quantize_rows(xj, bits)
        ct, at = tkv.quantize_rows(xt, bits)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


def test_row_width_helpers():
    assert tkv.packed_row_width(64, 8) == 64
    assert tkv.packed_row_width(64, 4) == 32
    with pytest.raises(FormatError):
        tkv.packed_row_width(16, 3)
    with pytest.raises(FormatError):
        tkv.packed_row_width(3, 4)
    with pytest.raises(FormatError):
        tkv.bits_of(16, 5)
    assert tkv.bits_of(16, 16) == 8 and tkv.bits_of(16, 8) == 4
    assert (tkv.KV_QMAP_NAME, tkv.KV_BITS) == (jkv.KV_QMAP_NAME, jkv.KV_BITS)


def _pool(n_pages, page, KV, Dh, bits, seed):
    codes, absmax = tkv.quantize_rows(
        torch.from_numpy(_rows((n_pages, page, KV, Dh), seed)), bits)
    return codes, absmax


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("ids,offs", [
    ([2, 0, 5], [1, 3, 0]),            # all in range
    ([6, 1, 9], [0, 2, 3]),            # ids >= n_pages dropped
    ([6, 7, 8], [0, 0, 0]),            # every lane dropped
])
def test_append_rows_matches_jax(bits, ids, offs):
    n_pages, page, KV, Dh = 6, 4, 2, 8
    codes, absmax = _pool(n_pages, page, KV, Dh, bits, 1)
    rows = _rows((3, KV, Dh), 2)
    cj, aj = jkv.append_rows(jnp.asarray(codes.numpy()),
                             jnp.asarray(absmax.numpy()), jnp.asarray(rows),
                             jnp.asarray(ids, jnp.int32),
                             jnp.asarray(offs, jnp.int32), bits)
    ct, at = tkv.append_rows(codes, absmax, torch.from_numpy(rows),
                             torch.tensor(ids, dtype=torch.int32),
                             torch.tensor(offs, dtype=torch.int32), bits)
    assert ct is codes and at is absmax          # written in place
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


def test_append_rows_drops_negative_ids():
    """Port only: an id of -1 is dropped, as the reference's docstring
    says (its ``mode="drop"`` scatter wraps -1 onto the last page)."""
    codes = torch.zeros((3, 4, 2, 8), dtype=torch.uint8)
    absmax = torch.zeros((3, 4, 2))
    rows = torch.ones((2, 2, 8))
    tkv.append_rows(codes, absmax, rows, torch.tensor([-1, 1]),
                    torch.tensor([3, 2]), bits=8)
    assert float(absmax[1, 2, 0]) == 1.0
    assert float(absmax.sum()) == 2.0 and int(codes[2].sum()) == 0
    assert int(codes[0].sum()) == 0
    tkv.append_rows(codes, absmax, rows, torch.tensor([-1, -5]),
                    torch.tensor([0, 1]), bits=8)
    assert float(absmax.sum()) == 2.0


def _table(B, P, n_pages, seed):
    rng = np.random.RandomState(seed)
    t = rng.permutation(np.resize(rng.permutation(n_pages), B * P))
    t = t.reshape(B, P).astype(np.int32)
    t[0, -1] = -1
    t[-1, 0] = -1
    return t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [4, 8])
def test_gather_matches_jax_jnp_and_interpret(bits, dtype):
    """Scrambled table with -1 entries (read as page 0 in every path)."""
    n_pages, page, KV, Dh = 6, 4, 2, 8
    codes, absmax = _pool(n_pages, page, KV, Dh, bits, 4)
    table = _table(2, 3, n_pages, 5)
    cj, aj, tj = (jnp.asarray(a) for a in (codes.numpy(), absmax.numpy(),
                                           table))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = {impl: np.asarray(jkv.gather_pages(cj, aj, tj, bits=bits,
                                              dtype=jdt, impl=impl)
                             .astype(jnp.float32))
            for impl in ("jnp", "interpret")}
    for impl in ("torch", "cuda"):         # on CPU tensors, "cuda" = plain
        got = tkv.gather_pages(codes, absmax, torch.from_numpy(table),
                               bits=bits, dtype=tdt, impl=impl)
        assert got.shape == (2, 3 * page, KV, Dh) and got.dtype == tdt
        for impl_j, w in want.items():
            np.testing.assert_array_equal(got.float().numpy(), w,
                                          err_msg=f"{impl} vs {impl_j}")


def test_gather_rejects_bad_arguments():
    codes, absmax = _pool(3, 2, 1, 8, 8, 0)
    table = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(FormatError, match="unknown impl"):
        tkv.gather_pages(codes, absmax, table, bits=8, impl="pallas")
    with pytest.raises(TypeError):
        tkv.gather_pages(codes, absmax, table.long(), bits=8)
    with pytest.raises(TypeError):
        tkv.gather_pages(codes, absmax, table, bits=8, dtype=torch.float16)
    with pytest.raises(ValueError, match="no paged gather kernel"):
        tkv.gather_cuda(codes.to("meta"), absmax.to("meta"),
                        table.to("meta"), bits=8)
    assert tkv.gather_cuda.launches == 0     # CPU runs launch nothing
