"""Quantization codebooks ("qmaps") for k-bit optimizer states.

A numpy-only copy of ``repro.core.qmap``: the port keeps its own so that it
imports nothing of the JAX package; the two are held bit-equal by
``tests/test_torch_qmap_blockwise.py``.

All maps are 2^bits-entry sorted float32 arrays over [-1, 1] (signed) or
[0, 1] (unsigned); the paper's 8-bit maps are the ``bits=8`` point.  The
dynamic (tree) maps follow the construction of the released bitsandbytes
implementation (`create_dynamic_map`), which is the reference for the paper
"8-bit Optimizers via Block-wise Quantization" (Dettmers et al., ICLR 2022):

  * 1 sign bit (signed maps only),
  * the number of leading zero bits selects a decimal exponent 10^(i - E + 1)
    for E exponent levels,
  * the remaining bits linearly quantize the fraction over [0.1, 1].

The unsigned "dynamic quantization" variant (paper §2.2) re-purposes the sign
bit as one extra fraction bit for the strictly-positive second Adam state.

Sub-byte bitwidths (4/5/6) use the same tree construction with fewer total
bits — the format Li et al. 2023 ("Memory Efficient Optimizers with 4-bit
States") show is viable for the first Adam moment.  The k-bit code-format
subsystem (`repro_torch.core.lowbit`, DESIGN.md §9) owns bit-packing; this module
only generates level values.
"""
from __future__ import annotations

import functools

import numpy as np

from repro_torch.errors import ConfigError, FormatError

# Bit layout used by the reference implementation: for b total bits, b - 1
# dynamic-exponent levels (7 for the 8-bit maps).


def _dynamic_levels(signed: bool, inverse: bool = False,
                    bits: int = 8) -> list[float]:
    """Positive values of the dynamic (tree) map, before sign mirroring."""
    data: list[float] = []
    max_exp_bits = bits - 1
    non_sign_bits = bits - 1
    for i in range(max_exp_bits):
        # Fraction slots double per level; unsigned maps get one extra bit.
        n_frac = 2 ** (i + non_sign_bits - max_exp_bits) * (1 if signed else 2)
        if n_frac < 1:
            continue
        boundaries = np.linspace(0.1, 1.0, n_frac + 1)
        means = (boundaries[:-1] + boundaries[1:]) / 2.0
        if inverse:
            # Inverse dynamic quantization (paper App F.1): swap exponent
            # order so the *small*-magnitude end gets the most fraction bits.
            exponent = 10.0 ** (-i)
        else:
            exponent = 10.0 ** (-(max_exp_bits - 1) + i)
        data += (exponent * means).tolist()
    return data


def _finalize(values: list[float], bits: int) -> np.ndarray:
    values = list(values)
    values.append(0.0)
    values.append(1.0)
    target = 2 ** bits
    if len(values) > target:
        raise ConfigError(f"codebook construction produced {len(values)} "
                          f"levels for {bits}-bit storage (max {target})")
    # Pad (never needed for the standard configs, kept for safety/parity with
    # the reference implementation which pads with zeros).
    values += [0.0] * (target - len(values))
    out = np.sort(np.asarray(values, dtype=np.float32))
    if out.shape != (target,):
        raise FormatError(f"finalized codebook shape {out.shape} != "
                          f"({target},)")
    return out


@functools.lru_cache(maxsize=None)
def dynamic_map(signed: bool = True, bits: int = 8) -> np.ndarray:
    """Dynamic (tree) quantization map. Signed: Adam m / momentum. Unsigned:
    Adam r (second moment), with the sign bit re-used as a fraction bit."""
    pos = _dynamic_levels(signed=signed, bits=bits)
    if signed:
        vals = pos + [-v for v in pos]
    else:
        vals = pos
    return _finalize(vals, bits)


@functools.lru_cache(maxsize=None)
def inverse_dynamic_map(signed: bool = True, bits: int = 8) -> np.ndarray:
    """Inverse dynamic quantization (paper Appendix F.1)."""
    pos = _dynamic_levels(signed=signed, inverse=True, bits=bits)
    if signed:
        vals = pos + [-v for v in pos]
    else:
        vals = pos
    return _finalize(vals, bits)


@functools.lru_cache(maxsize=None)
def linear_map(signed: bool = True, bits: int = 8) -> np.ndarray:
    """Linear quantization baseline (ablation rows of paper Table 3)."""
    if signed:
        return np.linspace(-1.0, 1.0, 2 ** bits).astype(np.float32)
    return np.linspace(0.0, 1.0, 2 ** bits).astype(np.float32)


def _norm_ppf(p: np.ndarray) -> np.ndarray:
    """Inverse CDF of the standard normal (Acklam's rational approximation).

    scipy is not available in the container; this approximation has
    |rel err| < 1.15e-9 which is far below 8-bit resolution.
    """
    p = np.asarray(p, dtype=np.float64)
    a = [-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
         1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00]
    b = [-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
         6.680131188771972e01, -1.328068155288572e01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
         -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
         3.754408661907416e00]
    plow, phigh = 0.02425, 1 - 0.02425
    out = np.empty_like(p)
    lo = p < plow
    hi = p > phigh
    mid = ~(lo | hi)
    if lo.any():
        q = np.sqrt(-2 * np.log(p[lo]))
        out[lo] = (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
                  ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if hi.any():
        q = np.sqrt(-2 * np.log(1 - p[hi]))
        out[hi] = -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
                   ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if mid.any():
        q = p[mid] - 0.5
        r = q * q
        out[mid] = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
                   (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
    return out


@functools.lru_cache(maxsize=None)
def normal_quantile_map(signed: bool = True, bits: int = 8) -> np.ndarray:
    """Quantile map per paper Eq. 5 with X = N(0,1) (or |N(0,1)| unsigned)."""
    k = 2 ** bits
    if signed:
        # Eq. 5: midpoints of 2^k + 1 equally spaced quantiles.
        qs = _norm_ppf(np.linspace(1.0 / (k + 1), k / (k + 1), k + 1))
        q = (qs[:-1] + qs[1:]) / 2.0
    else:
        # Half-normal: quantiles of |N(0,1)| via Phi^-1((1+p)/2).
        ps = np.linspace(1.0 / (k + 1), k / (k + 1), k + 1)
        qs = _norm_ppf((1.0 + ps) / 2.0)
        q = (qs[:-1] + qs[1:]) / 2.0
    q = q / np.max(np.abs(q))
    return np.sort(q.astype(np.float32))


QMAPS = {
    "dynamic": dynamic_map,
    "inverse_dynamic": inverse_dynamic_map,
    "linear": linear_map,
    "quantile_normal": normal_quantile_map,
}


def get_qmap(name: str, signed: bool, bits: int = 8) -> np.ndarray:
    """Return the 2^bits-entry sorted codebook for `name` (default 256)."""
    try:
        return QMAPS[name](signed=signed, bits=bits)
    except KeyError:
        raise ValueError(f"unknown qmap '{name}'; have {sorted(QMAPS)}") from None


def boundaries(qmap: np.ndarray) -> np.ndarray:
    """255 nearest-neighbour decision boundaries (midpoints) of a sorted map."""
    return ((qmap[1:] + qmap[:-1]) / 2.0).astype(np.float32)
