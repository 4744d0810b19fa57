"""Fused k-bit optimizer update (mirrors ``repro.kernels.fused_update``).

The paper's §2 procedure in one HBM pass per block: dequantize the
quantized states, run the 32-bit update math, write the parameter,
requantize the states with a per-block absmax.  This port covers the six
element-wise algorithms (adam, adamw, lamb, momentum, lars, adagrad) with
deterministic or stochastic rounding, at 8-bit states and at bit-packed
4/5/6-bit states (``bits_m`` / ``bits_r``, ``core/lowbit/packing.py``):
the CUDA kernels are in ``csrc/fused_update.cu`` (ROADMAP B3(a)-(e)).
Muon is a matrix-class algorithm: its spec is here, its update is
``ops``'s muon entry over ``newton_schulz.py``.

*The numerics sentinel* (``sentinel=True``, B3(e)): the update also emits
per-block health counts ``(n_blocks, N_HEALTH)`` f32 in
:data:`HEALTH_SLOTS` order, counted in the same pass on the raw grad, the
new parameter and the new codes and absmax; :func:`health_rows` is their
plain version.  Counts are integer-valued f32, so every order of adding
them gives the same bits.

LAMB and LARS scale their step by a per-tensor trust ratio, a global
reduction that cannot live in a block-local pass.  They get a *norm
prologue* first: ``csrc/norm_partials.cu`` (B4) writes per-block partial
sums [||p||^2, ||g||^2, ||u||^2, 0 x 5], and :func:`
segment_scales_from_partials` (plain torch ops, as in the JAX package)
finalizes them per segment into the per-block ``tensor_scale`` vector the
update kernel reads beside each block's absmax.

:func:`update_math` is the 32-bit math shared by the kernel's plain
version, the ``ref`` oracle and the optimizer's 32-bit leaves, as in the
JAX package.  The scalars dict ``s`` carries ``c1 = 1 - beta1**step`` and
``c2 = 1 - beta2**step`` precomputed on the host (:func:`bias_corrections`):
the kernel receives the very same two floats, so ``pow`` is evaluated once
per call in one place.

*bf16 masters.*  ``p`` is f32 or bf16 (a bf16 master, ROADMAP A14b-1) and
``g`` is f32, as the JAX package feeds its kernel (it flattens p and g to
f32 and writes the master back in its dtype): the kernels are templates
on the element type of p, built once per type into two libraries
(``build.LIBRARIES``: ``fused_update`` and ``fused_update_bf16``,
``norm_partials`` and ``norm_partials_bf16``); they compute in f32 and
store the new ``p`` rounded to nearest even.  The plain versions cast to
f32 and return the new ``p`` in f32, which the wrapper rounds into ``p``.
Any other dtype, or a bf16 row whose block size is not a multiple of 8 on
the card, raises.

*Plain versions on any device.*  :func:`fused_update_chunked` and
:func:`norm_partials_chunked` (the ``"plain"`` backend of ``ops``, and
the CPU path of the CUDA wrappers) run the kernels' plain versions in
place, :data:`PLAIN_CHUNK` blocks at a time (every result is block-local,
so the chunks give the same bits and bound the temporaries on a
billion-element arena): the counterpart of the JAX package's interpret
mode.

*Summation order.*  A sum is not order-free in floating point, so the norm
prologue fixes one: each of a block's 256 threads adds its elements in
sequence (its float4 vectors in order, the four lanes of each in order),
then a warp-shuffle tree, then the same tree over the eight warp sums
(:func:`block_sums` is that order in PyTorch).  The per-segment finalize
adds the block partials in a pairwise tree (:func:`tree_sum_rows`).  Both
are the port's own orders: the JAX package sums with XLA's reductions, so
trust ratios agree with it to rounding, not bit for bit.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.analysis import contracts as _contracts
from repro_torch.core.lowbit.packing import (pack_codes, packed_width,
                                             unpack_codes)
from repro_torch.device import to_device
from repro_torch.kernels import build, common


@dataclasses.dataclass(frozen=True)
class AlgoSpec:
    """Static description of one optimizer algorithm for the kernel builder.

    name          : algorithm key ("adam", ...)
    n_states      : 1 (momentum/lars/adagrad) or 2 (adam/adamw/lamb)
    state1_signed : first state uses the signed codebook (False: adagrad's
                    non-negative accumulator uses the unsigned map)
    norm_kind     : "" (block-local), "lamb" or "lars" (per-tensor norms)
    matrix        : matrix-class algorithm (muon): its leaves take the
                    Newton–Schulz update (``ops``'s muon entry)
    """
    name: str
    n_states: int
    state1_signed: bool
    norm_kind: str = ""
    matrix: bool = False

    @property
    def needs_norms(self) -> bool:
        return self.norm_kind != ""


ALGO_SPECS: dict[str, AlgoSpec] = {
    "adam":     AlgoSpec("adam", 2, True),
    "adamw":    AlgoSpec("adamw", 2, True),
    "lamb":     AlgoSpec("lamb", 2, True, norm_kind="lamb"),
    "momentum": AlgoSpec("momentum", 1, True),
    "lars":     AlgoSpec("lars", 1, True, norm_kind="lars"),
    "adagrad":  AlgoSpec("adagrad", 1, False),
    "muon":     AlgoSpec("muon", 1, True, matrix=True),
}

# Algorithm ids of the kernels' C interface (adam and adamw share one
# update: decoupled weight decay, as in the JAX package).
KERNEL_ALGOS = {"adam": 0, "adamw": 0, "lamb": 1, "momentum": 2, "lars": 3,
                "adagrad": 4}
NORM_KINDS = {"lars": 0, "lamb": 1}
N_PARTIALS = 8          # [||p||^2, ||g||^2, ||u||^2, 0 x 5] per block


class FusedUpdateResult(NamedTuple):
    """Output of one fused update in the flat block domain; codes_r and
    absmax_r are None for one-state algorithms.  ``health``: the sentinel's
    (n_blocks, N_HEALTH) f32 counts, present iff the update ran with
    ``sentinel=True``."""
    p: torch.Tensor
    codes_m: torch.Tensor
    absmax_m: torch.Tensor
    codes_r: Optional[torch.Tensor]
    absmax_r: Optional[torch.Tensor]
    health: Optional[torch.Tensor] = None


# ------------------------------------------------------ numerics sentinel
# Slot layout of the per-block health counts (the JAX package's order).
HEALTH_SLOTS = (
    "nonfinite_grad",        # nonfinite entries in the incoming (raw) grad
    "nonfinite_update",      # nonfinite entries in the updated master
    "nonfinite_absmax_m",    # nonfinite new per-block absmax, state 1
    "nonfinite_absmax_r",    # nonfinite new per-block absmax, state 2
    "edge_hits_m",           # requantized state-1 codes at a codebook edge
    "edge_hits_r",           # requantized state-2 codes at a codebook edge
    "absmax_overflow_m",     # new state-1 absmax past the overflow guard
    "absmax_overflow_r",     # new state-2 absmax past the overflow guard
)
N_HEALTH = len(HEALTH_SLOTS)

# f32 max is ~3.4e38; an absmax past 1e30 means squaring/scale math on the
# dequantized state is about to overflow — flag before the inf appears.
ABSMAX_OVERFLOW_THRESHOLD = 1e30


def health_rows(g, p2, c1n, a1n, c2n, a2n, bits_m: int, bits_r: int):
    """Per-block health counts ``(n_blocks, N_HEALTH)`` f32, HEALTH_SLOTS
    order, from one fused update's inputs and outputs: the raw (unscaled)
    grad blocks ``g``, the updated master blocks ``p2``, and the new
    *unpacked* codes / absmax of each state slot (None for an absent second
    state).  The plain version of the kernels' sentinel output.  An absmax
    vector whose length differs from n_blocks (a per-tensor absmax) folds
    its counts into row 0."""
    nb = p2.shape[0]
    zero = torch.zeros(nb, dtype=torch.float32, device=p2.device)
    limit = torch.tensor(ABSMAX_OVERFLOW_THRESHOLD, dtype=torch.float32,
                         device=p2.device)

    def nf2(x):                                   # (nb, B) -> (nb,)
        return (~torch.isfinite(x.to(torch.float32))).sum(dim=1) \
            .to(torch.float32)

    def amax_slots(a):
        if a is None:
            return zero, zero
        a = a.to(torch.float32).reshape(-1)
        nfin = (~torch.isfinite(a)).to(torch.float32)
        over = (torch.isfinite(a) & (a > limit)).to(torch.float32)
        if a.shape[0] == nb:
            return nfin, over
        fold = lambda v: torch.cat([v.sum().reshape(1), zero[1:]])
        return fold(nfin), fold(over)

    def edge(c, bits):
        if c is None:
            return zero
        c = c.to(torch.int64)
        hit = (c == 0) | (c == (1 << bits) - 1)
        return hit.sum(dim=1).to(torch.float32)

    nf_a1, ov_a1 = amax_slots(a1n)
    nf_a2, ov_a2 = amax_slots(a2n)
    return torch.stack([nf2(g), nf2(p2), nf_a1, nf_a2, edge(c1n, bits_m),
                        edge(c2n, bits_r), ov_a1, ov_a2], dim=1)


# --------------------------------------------------------------- update math
def bias_corrections(beta1, beta2, step):
    """``(1 - beta1**step, 1 - beta2**step)`` as 0-d f32 CPU tensors.  The
    betas may be Python floats or 0-d f32 tensors (the JAX package mixes
    both; each is kept as its caller passes it)."""
    step = torch.as_tensor(step, dtype=torch.float32, device="cpu")
    return 1.0 - torch.pow(beta1, step), 1.0 - torch.pow(beta2, step)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, as the kernel's ``__fsqrt_rn``
    and XLA's ``sqrt`` are.  PyTorch's vectorized CPU ``sqrt`` is off by one
    ULP on about 0.7% of f32 inputs; the square root taken in f64 and
    rounded to f32 is exact (53 >= 2*24 + 2 bits).  The float64 stays
    inside the named exempt scope of the no_f64 contracts."""
    with _contracts.exempt("f64", "sqrt_rn"):
        return torch.sqrt(x.double()).to(x.dtype)


def adam_moments(g, m, r, s):
    """Shared first/second moment EMA for the adam family (incl. lamb)."""
    m2 = s["beta1"] * m + (1.0 - s["beta1"]) * g
    r2 = s["beta2"] * r + (1.0 - s["beta2"]) * g * g
    return m2, r2


def adam_base_update(g, p, m, r, s):
    """Bias-corrected adam step direction incl. decoupled weight decay —
    the pre-trust-ratio 'u' of LAMB.  Returns (m2, r2, u)."""
    m2, r2 = adam_moments(g, m, r, s)
    u = (m2 / s["c1"]) / (sqrt_rn(r2 / s["c2"]) + s["eps"]) \
        + s["weight_decay"] * p
    return m2, r2, u


def update_math(spec: AlgoSpec, g, p, m, r, s):
    """One 32-bit optimizer update on (already gnorm-scaled) g, in the JAX
    package's order of operations.  Returns (m2, r2, p2) with r2 = None for
    one-state algorithms.  ``s``: lr, beta1, beta2, eps, weight_decay, c1,
    c2 and, for lamb/lars, tensor_scale (the finalized trust ratio / local
    lr: a scalar or an (n_blocks, 1) column)."""
    algo = spec.name
    if algo in ("adam", "adamw"):
        m2, r2, u = adam_base_update(g, p, m, r, s)
        return m2, r2, p - s["lr"] * u
    if algo == "lamb":
        m2, r2, u = adam_base_update(g, p, m, r, s)
        return m2, r2, p - s["lr"] * s["tensor_scale"] * u
    if algo == "momentum":
        m2 = s["beta1"] * m + (g + s["weight_decay"] * p)
        return m2, None, p - s["lr"] * m2
    if algo == "lars":
        m2 = s["beta1"] * m + s["tensor_scale"] * (g + s["weight_decay"] * p)
        return m2, None, p - s["lr"] * m2
    if algo == "adagrad":
        m2 = m + g * g
        u = g / (sqrt_rn(m2) + s["eps"]) + s["weight_decay"] * p
        return m2, None, p - s["lr"] * u
    raise ValueError(algo)


def tensor_scale_from_norms(spec: AlgoSpec, pn2, gn2, un2, *, weight_decay,
                            trust_coeff):
    """Finalize squared norms into the update's scalar: lamb's trust ratio
    ||p|| / ||u||, lars's local lr trust_coeff*||p|| / (||g|| + wd*||p||),
    with the JAX package's guards; 1 for block-local algorithms."""
    if not spec.needs_norms:
        return torch.ones((), dtype=torch.float32, device=pn2.device)
    pn = sqrt_rn(pn2)
    one = torch.ones_like(pn)
    if spec.norm_kind == "lamb":
        un = sqrt_rn(un2)
        return torch.where((pn > 0) & (un > 0),
                           pn / torch.where(un > 0, un, one), one)
    gn = sqrt_rn(gn2)
    denom = gn + weight_decay * pn + 1e-12
    return torch.where(pn > 0, trust_coeff * pn / denom, one)


def segment_scale_vector(segments, total: int, scale_fn, device=None):
    """Per-block tensor_scale vector from per-segment scalars:
    ``scale_fn(i, off, n)`` returns segment i's 0-d scale; blocks past the
    last segment get 1.0.  Segments must tile a contiguous prefix of
    ``total``."""
    pieces, cursor = [], 0
    for i, (off, n) in enumerate(segments):
        if off != cursor:
            raise ValueError(f"segments must be contiguous: {segments}")
        scale = scale_fn(i, off, n)
        pieces.append(scale.to(torch.float32).reshape(1).expand(n))
        device = scale.device
        cursor += n
    if cursor < total:
        pieces.append(torch.ones(total - cursor, dtype=torch.float32,
                                 device=device))
    return torch.cat(pieces)


def tensor_scale_for(spec: AlgoSpec, g, p, m, r, s, trust_coeff):
    """Whole-tensor norm prologue + finalization for single-tensor callers
    (the ``ref`` oracle and the 32-bit engine leaves), one ``sum`` each as
    in the JAX package.  The kernel path computes per-block partials
    instead (:func:`norm_partials_cuda`)."""
    if not spec.needs_norms:
        return torch.ones((), dtype=torch.float32, device=p.device)
    pn2 = (p * p).sum()
    gn2 = (g * g).sum()
    un2 = torch.zeros((), dtype=torch.float32, device=p.device)
    if spec.norm_kind == "lamb":
        _, _, u = adam_base_update(g, p, m, r, s)
        un2 = (u * u).sum()
    return tensor_scale_from_norms(spec, pn2, gn2, un2,
                                   weight_decay=s["weight_decay"],
                                   trust_coeff=trust_coeff)


def tree_sum_rows(x: torch.Tensor) -> torch.Tensor:
    """Column sums of (n, k) non-negative partials in a fixed pairwise tree
    (zero rows pad n to a power of two; adding +0 is exact): the same
    element-wise adds on any device, log2(n) launches on the card."""
    n = x.shape[0]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.cat([x, x.new_zeros((width - n,) + tuple(x.shape[1:]))])
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        x = x[:half] + x[half:]
    return x[0]


def segment_scales_from_partials(spec: AlgoSpec, partials, segments,
                                 n_blocks: int, weight_decay, trust_coeff):
    """Finalize per-block norm partials (n_blocks, 8) into the per-block
    tensor_scale vector (n_blocks,): one trust ratio per segment, from the
    partials of its blocks summed by :func:`tree_sum_rows`.  Torch ops,
    not a kernel, as in the JAX package."""
    f32 = lambda v: to_device(torch.as_tensor(v, dtype=torch.float32),
                              partials.device)
    wd, tc = f32(weight_decay), f32(trust_coeff)

    def seg_scale(i, off, nb):
        sums = tree_sum_rows(partials[off:off + nb])
        return tensor_scale_from_norms(spec, sums[0], sums[1], sums[2],
                                       weight_decay=wd, trust_coeff=tc)

    return segment_scale_vector(segments, n_blocks, seg_scale,
                                partials.device)


def scalars(*, lr, beta1, beta2, eps, weight_decay, step, gnorm_scale,
            device) -> dict:
    """The kernel path's scalars as 0-d f32 tensors on ``device`` (as the
    JAX kernels and oracle cast them), with the bias corrections computed
    once on the host.  Every division in the math then has a tensor
    operand on the data's device, never a CPU scalar (PyTorch's CUDA
    division by a CPU scalar multiplies by its reciprocal)."""
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32).detach().cpu()
    s = dict(lr=f32(lr), beta1=f32(beta1), beta2=f32(beta2), eps=f32(eps),
             weight_decay=f32(weight_decay), gnorm_scale=f32(gnorm_scale))
    s["c1"], s["c2"] = bias_corrections(s["beta1"], s["beta2"], step)
    return {k: to_device(v, device) for k, v in s.items()}


def _kernel_scalars(s: dict) -> list:
    """The 10 floats of the kernels' scalar arguments, in their order."""
    v = {k: float(t) for k, t in s.items()}
    return [v["lr"], v["beta1"], float(1.0 - s["beta1"].cpu()), v["beta2"],
            float(1.0 - s["beta2"].cpu()), v["eps"], v["weight_decay"],
            v["c1"], v["c2"], v["gnorm_scale"]]


def to_i32(x: int) -> int:
    """A Python int wrapped to int32 (two's complement), as JAX's int32
    arithmetic wraps."""
    return ((int(x) + 2 ** 31) % 2 ** 32) - 2 ** 31


# ------------------------------------------------------------ norm prologue
THREADS = 256           # csrc/common.cuh: rq::kThreads


def _tree_halves(x: torch.Tensor) -> torch.Tensor:
    """x[..., i] + x[..., i + w/2] repeatedly, as a warp's xor-shuffle
    reduction adds lane i and lane i ^ o; the last axis is a power of two."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def block_sums(x: torch.Tensor) -> torch.Tensor:
    """Row sums of (n_blocks, B) f32 in the norm kernel's order: thread t of
    256 adds, in sequence, element 4*(t + 256*k) + c for k = 0, 1, ... and
    c = 0..3; each warp of 32 threads sums by the xor-shuffle tree; warp
    0 sums the 8 warp totals (zero-padded to 32 lanes) by the same tree."""
    nb, bsz = x.shape
    vpt = -(-(bsz // 4) // THREADS)
    pad = vpt * THREADS * 4 - bsz
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    per_thread = x.reshape(nb, vpt, THREADS, 4).permute(0, 2, 1, 3) \
        .reshape(nb, THREADS, vpt * 4)
    acc = per_thread[..., 0]
    for j in range(1, vpt * 4):
        acc = acc + per_thread[..., j]
    warps = _tree_halves(acc.reshape(nb, THREADS // 32, 32))
    return _tree_halves(torch.nn.functional.pad(warps,
                                                (0, 32 - THREADS // 32)))


def norm_partials_plain(p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m,
                        qmap_r, s, *, algo: str, bits_m: int = 8,
                        bits_r: int = 8) -> torch.Tensor:
    """Plain PyTorch version of the norm-prologue kernel (any device):
    (n_blocks, 8) f32 rows [||p||^2, ||g*gnorm_scale||^2, ||u||^2, 0 x 5],
    each summed in the kernel's order (:func:`block_sums`).  lamb
    re-derives u from the dequantized states (packed ``bits_m`` /
    ``bits_r``-bit codes below 8) as ``adam_base_update`` does; lars leaves
    ||u||^2 at 0."""
    spec = ALGO_SPECS[algo]
    p = p.to(torch.float32)
    g = g.to(torch.float32) * s["gnorm_scale"]
    zero = torch.zeros(p.shape[0], dtype=torch.float32, device=p.device)
    un2 = zero
    if spec.norm_kind == "lamb":
        m = common.decode(unpack_codes(codes_m, bits_m), qmap_m) \
            * absmax_m[:, None]
        r = common.decode(unpack_codes(codes_r, bits_r), qmap_r) \
            * absmax_r[:, None]
        _, _, u = adam_base_update(g, p, m, r, s)
        un2 = block_sums(u * u)
    return torch.stack([block_sums(p * p), block_sums(g * g), un2]
                       + [zero] * (N_PARTIALS - 3), dim=1)


# element type of p -> its kernels' library suffix (build.LIBRARIES)
P_LIBRARIES = {torch.float32: "", torch.bfloat16: "_bf16"}
PLAIN_CHUNK = 16384     # blocks per step of the plain versions


def _check_blocks(p, g):
    if p.dim() != 2 or p.shape[1] % 4 or not \
            0 < p.shape[1] <= common.MAX_BLOCK_SIZE:
        raise ValueError(f"p must be (n_blocks, B) with B a multiple of 4 "
                         f"and at most {common.MAX_BLOCK_SIZE}, got "
                         f"{tuple(p.shape)}")
    if p.dtype not in P_LIBRARIES:
        raise TypeError(f"p: dtype {p.dtype}, expected one of "
                        f"{tuple(P_LIBRARIES)}")
    build.require(p, "p", p.dtype)
    build.require(g, "g", torch.float32, tuple(p.shape), p.device)
    if p.device.type == "cuda" and p.dtype == torch.bfloat16 and \
            p.shape[1] % 8:
        raise ValueError(f"bf16 p needs a block size that is a multiple "
                         f"of 8, got {p.shape[1]}")


def _chunks(nb: int):
    return [(i, min(nb, i + PLAIN_CHUNK)) for i in range(0, nb, PLAIN_CHUNK)]


def _check_state(spec, p, codes_m, absmax_m, codes_r, absmax_r, qmap_m,
                 qmap_r, slots, bits=(8, 8)):
    """Codes (n_blocks, B * bits / 8) uint8, absmax (n_blocks,) f32 and a
    2^bits-entry f32 codebook for each of the first ``slots`` states."""
    nb, bsz = p.shape
    dev = p.device
    names = (("m", codes_m, absmax_m, qmap_m), ("r", codes_r, absmax_r,
                                                qmap_r))
    for (name, c, a, q), b in list(zip(names, bits))[:slots]:
        if c is None or a is None or q is None:
            raise ValueError(f"{spec.name} needs codes_{name}, absmax_{name}"
                             f" and qmap_{name}")
        build.require(c, f"codes_{name}", torch.uint8,
                      (nb, packed_width(bsz, b)), dev)
        build.require(a, f"absmax_{name}", torch.float32, (nb,), dev)
        build.require(q, f"qmap_{name}", torch.float32, (1 << b,), dev)


def norm_partials_cuda(*args, **kw) -> torch.Tensor:
    """Per-block norm partials (n_blocks, 8) f32 for lamb/lars
    (:func:`_norm_partials`'s arguments).  CUDA tensors launch
    ``csrc/norm_partials.cu`` (the library of p's element type); CPU
    tensors run :func:`norm_partials_chunked`."""
    return _norm_partials(True, *args, **kw)


def norm_partials_chunked(*args, **kw) -> torch.Tensor:
    """:func:`norm_partials_cuda`'s result from the kernel's plain version,
    :data:`PLAIN_CHUNK` blocks at a time, on any device."""
    return _norm_partials(False, *args, **kw)


def _norm_partials(kernel: bool, p, g, codes_m, absmax_m, codes_r,
                   absmax_r, qmap_m, qmap_r, *, algo: str, beta1=0.9,
                   beta2=0.999, eps=1e-8, weight_decay=0.0, step=1.0,
                   gnorm_scale=1.0, bits_m: int = 8,
                   bits_r: int = 8) -> torch.Tensor:
    """The norm prologue: the kernel on a CUDA tensor when ``kernel``,
    else :func:`norm_partials_plain` chunk by chunk.  p: f32 or bf16, g:
    f32.  lars reads p and g only; lamb reads its two states, as packed
    ``bits_m`` / ``bits_r``-bit codes below 8."""
    spec = ALGO_SPECS.get(algo)
    if spec is None or not spec.needs_norms:
        raise ValueError(f"no norm prologue for algo {algo!r}")
    _check_blocks(p, g)
    lamb = spec.norm_kind == "lamb"
    packed = lamb and (bits_m, bits_r) != (8, 8)
    _check_state(spec, p, codes_m, absmax_m, codes_r, absmax_r, qmap_m,
                 qmap_r, 2 if lamb else 0, (bits_m, bits_r))
    s = scalars(lr=0.0, beta1=beta1, beta2=beta2, eps=eps,
                weight_decay=weight_decay, step=step,
                gnorm_scale=gnorm_scale, device="cpu")
    if not kernel or p.device.type == "cpu":
        s = {k: to_device(v, p.device) for k, v in s.items()}
        rows = lambda t, i, j: None if t is None else t[i:j]
        return torch.cat([norm_partials_plain(
            p[i:j], g[i:j], rows(codes_m, i, j), rows(absmax_m, i, j),
            rows(codes_r, i, j), rows(absmax_r, i, j), qmap_m, qmap_r, s,
            algo=algo, bits_m=bits_m, bits_r=bits_r)
            for i, j in _chunks(p.shape[0])])
    if p.device.type != "cuda":
        raise ValueError(f"no norm-partials kernel for device {p.device}")
    if packed and p.shape[1] % 8:
        raise ValueError(f"packed states need a block size that is a "
                         f"multiple of 8, got {p.shape[1]}")
    nb, bsz = p.shape
    out = torch.empty((nb, N_PARTIALS), dtype=torch.float32, device=p.device)
    opt = lambda t: build.ptr(t) if lamb else None
    state = (opt(codes_m), opt(absmax_m), opt(codes_r), opt(absmax_r),
             opt(qmap_m), opt(qmap_r))
    lib = _lib("norm_partials" + P_LIBRARIES[p.dtype])
    kind = NORM_KINDS[spec.norm_kind]
    ctas = lib.norm_partials_ctas(kind, nb, bsz, build.sm_count(p.device))
    with torch.cuda.device(p.device):
        rc = lib.norm_partials_grid(
            kind, build.ptr(p), build.ptr(g), *state,
            build.ptr(out), nb, bsz, bits_m, bits_r, ctas,
            *_kernel_scalars(s), build.stream(p.device))
    build.check(lib, rc, "norm_partials")
    norm_partials_cuda.launches += 1
    return out


norm_partials_cuda.launches = 0


# ------------------------------------------------------------ plain version
def block_uniforms(nb: int, bsz: int, *, two: bool, seed=0,
                   block_seeds=None, block_offsets=None, device=None):
    """The stochastic-rounding uniforms (u1, u2) of a (nb, bsz) update:
    element index ``offset * bsz + col`` (offset = the block's index in its
    own leaf, ``arange`` by default) hashed with the block's seed (``seed``
    for every block by default) plus each state's salt.  u2 is None for
    one-state algorithms."""
    offs = (torch.arange(nb, dtype=torch.int64, device=device)
            if block_offsets is None else block_offsets.to(torch.int64))
    idx = common.element_indices(nb, bsz, offs, device)
    seeds = (torch.full((nb, 1), to_i32(seed), dtype=torch.int64,
                        device=device)
             if block_seeds is None else block_seeds.to(torch.int64)[:, None])
    u1 = common.hash_uniform(idx, seeds + common.STATE1_SEED_SALT)
    u2 = (common.hash_uniform(idx, seeds + common.STATE2_SEED_SALT)
          if two else None)
    return u1, u2


def fused_update_plain(p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m,
                       qmap_r, s, *, algo: str = "adam", tensor_scale=None,
                       uniforms=(None, None), bits_m: int = 8,
                       bits_r: int = 8,
                       sentinel: bool = False) -> FusedUpdateResult:
    """Plain PyTorch version of the kernels (any device; returns new
    tensors).  ``s`` from :func:`scalars`; ``tensor_scale``: the per-block
    (n_blocks,) trust ratio for lamb/lars; ``uniforms``: (u1, u2) from
    :func:`block_uniforms` for stochastic rounding; ``bits_m`` /
    ``bits_r``: the states' widths (packed codes below 8, unpacked here
    and re-packed after the update, with 2^bits-entry codebooks);
    ``sentinel``: also return :func:`health_rows` of the update."""
    spec = ALGO_SPECS[algo]
    two = spec.n_states == 2
    g_raw = g
    p = p.to(torch.float32)
    g = g.to(torch.float32) * s["gnorm_scale"]
    m = common.decode(unpack_codes(codes_m, bits_m), qmap_m) \
        * absmax_m[:, None]
    r = (common.decode(unpack_codes(codes_r, bits_r), qmap_r)
         * absmax_r[:, None] if two else None)
    if spec.needs_norms:
        s = dict(s, tensor_scale=tensor_scale[:, None])
    m2, r2, p2 = update_math(spec, g, p, m, r, s)
    u1, u2 = uniforms

    def requantize(x, qmap, u, bits):
        codes, absmax = common.block_requantize(
            x, common.padded_bounds(qmap), qmap, u, max_code=(1 << bits) - 1)
        return codes, absmax[:, 0]

    cm, am = requantize(m2, qmap_m, u1, bits_m)
    cr, ar = requantize(r2, qmap_r, u2, bits_r) if two else (None, None)
    health = (health_rows(g_raw, p2, cm, am, cr, ar, bits_m, bits_r)
              if sentinel else None)
    return FusedUpdateResult(p2, pack_codes(cm, bits_m), am,
                             pack_codes(cr, bits_r) if two else None, ar,
                             health)


# ----------------------------------------------------------------- wrapper
def _block_vector(t, name: str, nb: int, dtype, device):
    if t is None:
        return None
    t = torch.as_tensor(t).to(device=device, dtype=dtype).contiguous()
    build.require(t, name, dtype, (nb,), device)
    return t


def fused_update_cuda(*args, **kw) -> FusedUpdateResult:
    """One fused k-bit step of ``algo``, **in place**
    (:func:`_fused_update`'s arguments).  CUDA tensors launch
    ``csrc/fused_update.cu`` (the library of p's element type: the 8-bit
    kernel when both widths are 8, else the packed one, each on the grid
    its library picks for the card's SM count); CPU tensors run
    :func:`fused_update_chunked`."""
    return _fused_update(True, *args, **kw)


def fused_update_chunked(*args, **kw) -> FusedUpdateResult:
    """:func:`fused_update_cuda`'s step from the kernels' plain versions
    (:func:`fused_update_plain`, and :func:`norm_partials_plain` for
    lamb/lars), in place, :data:`PLAIN_CHUNK` blocks at a time, on any
    device: the kernels' bits, and no launch."""
    return _fused_update(False, *args, **kw)


def _fused_update(kernel: bool, p, g, codes_m, absmax_m, codes_r, absmax_r,
                  qmap_m, qmap_r, *, algo: str, lr, beta1=0.9, beta2=0.999,
                  eps=1e-8, weight_decay=0.0, step=1.0, trust_coeff=0.001,
                  gnorm_scale=1.0, stochastic: bool = False, seed=0,
                  block_seeds=None, block_offsets=None, segments=None,
                  tensor_scale_blocks=None, bits_m: int = 8,
                  bits_r: int = 8,
                  sentinel: bool = False) -> FusedUpdateResult:
    """One fused k-bit step of ``algo``, **in place**: ``p``, the code
    tensors and the absmax vectors are overwritten with the new values
    (saving a copy of each) and returned in the result; the kernels on a
    CUDA tensor when ``kernel``, else their plain versions chunk by chunk.
    ``sentinel`` adds the per-block health counts (``health``,
    (n_blocks, N_HEALTH) f32, :func:`health_rows`) to the result, from the
    same launch.

    p: (n_blocks, B) f32 or bf16 (block size a multiple of 8 on the card);
    g: (n_blocks, B) f32; codes: (n_blocks, B * bits / 8) uint8, plain
    codes at ``bits`` = 8 and packed b-bit rows (``core/lowbit``) at 4, 5
    and 6; absmax: (n_blocks,) f32; qmaps: 2^bits-entry f32 codebooks.
    One-state algorithms take codes_r = absmax_r = None.  lamb/lars first
    run the norm prologue (:func:`_norm_partials`) and finalize it per
    segment, unless ``tensor_scale_blocks`` gives the per-block scales.
    ``stochastic`` rounds with the counter hash seeded by ``seed`` (int32,
    every block) or ``block_seeds``, at element index ``block_offsets * B
    + col``."""
    if algo not in KERNEL_ALGOS:
        raise ValueError(f"no fused-update kernel for algo {algo!r}; the "
                         f"kernel takes {tuple(KERNEL_ALGOS)}")
    spec = ALGO_SPECS[algo]
    two = spec.n_states == 2
    if not two:
        bits_r = 8
    _check_blocks(p, g)
    _check_state(spec, p, codes_m, absmax_m, codes_r, absmax_r, qmap_m,
                 qmap_r, spec.n_states, (bits_m, bits_r))
    nb, bsz = p.shape
    dev = p.device
    packed = (bits_m, bits_r) != (8, 8)
    if packed and bsz % 8:
        raise ValueError(f"packed states need a block size that is a "
                         f"multiple of 8, got {bsz}")
    hyper = dict(beta1=beta1, beta2=beta2, eps=eps,
                 weight_decay=weight_decay, step=step,
                 gnorm_scale=gnorm_scale)
    s = scalars(lr=lr, device="cpu", **hyper)
    block_seeds = _block_vector(block_seeds, "block_seeds", nb, torch.int32,
                                dev)
    block_offsets = _block_vector(block_offsets, "block_offsets", nb,
                                  torch.int32, dev)
    ts = None
    if spec.needs_norms:
        if tensor_scale_blocks is None:
            partials = _norm_partials(kernel, p, g, codes_m, absmax_m,
                                      codes_r, absmax_r, qmap_m, qmap_r,
                                      algo=algo, bits_m=bits_m,
                                      bits_r=bits_r, **hyper)
            ts = segment_scales_from_partials(
                spec, partials, segments or ((0, nb),), nb, weight_decay,
                trust_coeff)
        else:
            ts = _block_vector(tensor_scale_blocks, "tensor_scale_blocks",
                               nb, torch.float32, dev)
    if not kernel or dev.type == "cpu":
        sd = {k: to_device(v, dev) for k, v in s.items()}
        if stochastic:
            block_seeds = (block_seeds if block_seeds is not None else
                           torch.full((nb,), to_i32(seed), dtype=torch.int32,
                                      device=dev))
            block_offsets = (block_offsets if block_offsets is not None
                             else torch.arange(nb, dtype=torch.int32,
                                               device=dev))
        rows = lambda t, i, j: None if t is None else t[i:j]
        parts = []
        for i, j in _chunks(nb):
            uniforms = (block_uniforms(j - i, bsz, two=two,
                                       block_seeds=block_seeds[i:j],
                                       block_offsets=block_offsets[i:j],
                                       device=dev)
                        if stochastic else (None, None))
            res = fused_update_plain(
                p[i:j], g[i:j], codes_m[i:j], absmax_m[i:j],
                rows(codes_r, i, j), rows(absmax_r, i, j), qmap_m, qmap_r,
                sd, algo=algo, tensor_scale=rows(ts, i, j),
                uniforms=uniforms, bits_m=bits_m, bits_r=bits_r,
                sentinel=sentinel)
            for dst, src in zip((p, codes_m, absmax_m, codes_r, absmax_r),
                                res[:5]):
                if dst is not None:
                    dst[i:j].copy_(src)     # p: to nearest even for bf16
            parts.append(res.health)
        health = torch.cat(parts) if sentinel else None
    elif dev.type == "cuda":
        health = (torch.empty((nb, N_HEALTH), dtype=torch.float32,
                              device=dev) if sentinel else None)
        opt = lambda t: None if t is None else build.ptr(t)
        ptrs = (KERNEL_ALGOS[algo], build.ptr(p), build.ptr(g),
                build.ptr(codes_m), build.ptr(absmax_m), opt(codes_r),
                opt(absmax_r), build.ptr(qmap_m),
                opt(qmap_r if two else None), opt(ts), opt(block_seeds),
                opt(block_offsets))
        ints = (int(bool(stochastic)), to_i32(seed), nb, bsz)
        lib = _lib("fused_update" + P_LIBRARIES[p.dtype])
        sms = build.sm_count(dev)   # the grid: CTAs that walk the blocks
        ptrs += (opt(health),)      # may be null
        if packed:
            entry = "fused_update_packed_grid"
            ints += (bits_m, bits_r,
                     lib.fused_update_packed_ctas(nb, bsz, sms))
        else:
            entry = "fused_update_grid"
            ints += (lib.fused_update_ctas(KERNEL_ALGOS[algo],
                                           int(sentinel), nb, bsz, sms),)
        with torch.cuda.device(dev):
            rc = getattr(lib, entry)(*ptrs, *ints, *_kernel_scalars(s),
                                     build.stream(dev))
        build.check(lib, rc, entry)
        fused_update_cuda.launches += 1
        fused_update_cuda.sentinel_launches += int(sentinel)
    else:
        raise ValueError(f"no fused-update kernel for device {dev}")
    return FusedUpdateResult(p, codes_m, absmax_m,
                             codes_r if two else None,
                             absmax_r if two else None, health)


fused_update_cuda.launches = 0
fused_update_cuda.sentinel_launches = 0     # the launches of those with B3(e)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> (source, argtypes); every library of the source
# (build.LIBRARIES) has the entry
ARGTYPES = {
    # algo, p, g, codes/absmax m and r, qmaps, tensor_scale, block_seeds,
    # block_offsets, stochastic, seed, n_blocks, block_size, 10 scalars,
    # stream
    "fused_update": ("fused_update", [_I] + [_P] * 11 + [_I] * 4
                     + [_F] * 10 + [_P]),
    # as fused_update, with bits_m, bits_r after block_size
    "fused_update_packed": ("fused_update", [_I] + [_P] * 11 + [_I] * 6
                            + [_F] * 10 + [_P]),
    # the sentinel (B3(e)): as fused_update / fused_update_packed, with the
    # (n_blocks, 8) f32 health output after block_offsets
    "fused_update_sentinel": ("fused_update", [_I] + [_P] * 12 + [_I] * 4
                              + [_F] * 10 + [_P]),
    "fused_update_packed_sentinel": ("fused_update", [_I] + [_P] * 12
                                     + [_I] * 6 + [_F] * 10 + [_P]),
    # the 8-bit kernel on a grid of ctas CTAs that walk the blocks:
    # fused_update_sentinel's arguments (health may be null) with ctas
    # after block_size; ctas from fused_update_ctas(algo, sentinel,
    # n_blocks, block_size, SM count)
    "fused_update_grid": ("fused_update", [_I] + [_P] * 12 + [_I] * 5
                          + [_F] * 10 + [_P]),
    "fused_update_ctas": ("fused_update", [_I] * 5),
    # its dynamic shared memory per CTA: algo, block_size
    "fused_update_smem": ("fused_update", [_I] * 2),
    # the packed kernel on a grid of ctas CTAs that walk the blocks:
    # fused_update_packed_sentinel's arguments (health may be null) with
    # ctas after bits_r; ctas from fused_update_packed_ctas(n_blocks,
    # block_size, SM count)
    "fused_update_packed_grid": ("fused_update", [_I] + [_P] * 12 + [_I] * 7
                                 + [_F] * 10 + [_P]),
    "fused_update_packed_ctas": ("fused_update", [_I] * 3),
    # its dynamic shared memory per CTA: algo, block_size, bits_m, bits_r
    "fused_update_packed_smem": ("fused_update", [_I] * 4),
    # kind, p, g, codes/absmax m and r, qmaps, out, n_blocks, block_size,
    # 10 scalars, stream
    "norm_partials": ("norm_partials", [_I] + [_P] * 9 + [_I] * 2
                      + [_F] * 10 + [_P]),
    # p, g, codes/absmax m and r, qmaps, out, n_blocks, block_size,
    # bits_m, bits_r, 10 scalars, stream
    "norm_partials_packed": ("norm_partials", [_P] * 9 + [_I] * 4
                             + [_F] * 10 + [_P]),
    # kind, p, g, codes/absmax m and r, qmaps, out, n_blocks, block_size,
    # bits_m, bits_r, ctas, 10 scalars, stream; ctas from
    # norm_partials_ctas(kind, n_blocks, block_size, SM count)
    "norm_partials_grid": ("norm_partials", [_I] + [_P] * 9 + [_I] * 5
                           + [_F] * 10 + [_P]),
    "norm_partials_ctas": ("norm_partials", [_I] * 4),
    # its dynamic shared memory per CTA: block_size, bits_m, bits_r
    "norm_partials_smem": ("norm_partials", [_I] * 3),
}


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (of ``build.LIBRARIES``) with its
    source's entries' argument types."""
    lib = build.library(name)
    source = build.LIBRARIES[name][0]
    for fn_name, (src, argtypes) in ARGTYPES.items():
        if src == source:
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib
