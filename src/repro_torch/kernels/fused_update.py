"""Fused 8-bit optimizer update (mirrors ``repro.kernels.fused_update``).

The paper's §2 procedure in one HBM pass per block: dequantize the 8-bit
states, run the 32-bit update math, write the parameter, requantize the
states with a per-block absmax.  This slice ports the Adam/AdamW branch at
8/8 bits with deterministic rounding (ROADMAP B3(a)): the CUDA kernel is
``csrc/fused_update.cu``.  Stochastic rounding, the other algorithms
(momentum/lamb/lars/adagrad, the norm prologue), packed sub-byte states and
the sentinel output are ROADMAP B3(b)-(e) and B4.

:func:`update_math` is the 32-bit math shared by the kernel's plain
version, the ``ref`` oracle and the optimizer's 32-bit leaves, as in the
JAX package.  The scalars dict ``s`` carries ``c1 = 1 - beta1**step`` and
``c2 = 1 - beta2**step`` precomputed on the host (:func:`bias_corrections`):
the kernel receives the very same two floats, so ``pow`` is evaluated once
per call in one place.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build, common


@dataclasses.dataclass(frozen=True)
class AlgoSpec:
    """Static description of one optimizer algorithm for the kernel builder.

    name          : algorithm key ("adam", ...)
    n_states      : 1 or 2 quantized states
    state1_signed : first state uses the signed codebook
    norm_kind     : "" (block-local), "lamb" or "lars" (per-tensor norms)
    matrix        : matrix-class algorithm (muon)
    """
    name: str
    n_states: int
    state1_signed: bool
    norm_kind: str = ""
    matrix: bool = False

    @property
    def needs_norms(self) -> bool:
        return self.norm_kind != ""


# The algorithms ported so far; the JAX package's other five are ROADMAP A7
# and A10.
ALGO_SPECS: dict[str, AlgoSpec] = {
    "adam":  AlgoSpec("adam", 2, True),
    "adamw": AlgoSpec("adamw", 2, True),
}


class FusedUpdateResult(NamedTuple):
    """Output of one fused update in the flat block domain.  ``health`` (the
    sentinel output, ROADMAP B3(e)) is always None in this port."""
    p: torch.Tensor
    codes_m: torch.Tensor
    absmax_m: torch.Tensor
    codes_r: Optional[torch.Tensor]
    absmax_r: Optional[torch.Tensor]
    health: Optional[torch.Tensor] = None


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
    rounded to f32 is exact (53 >= 2*24 + 2 bits)."""
    return torch.sqrt(x.double()).to(x.dtype)


def adam_moments(g, m, r, s):
    """Shared first/second moment EMA for the adam family."""
    m2 = s["beta1"] * m + (1.0 - s["beta1"]) * g
    r2 = s["beta2"] * r + (1.0 - s["beta2"]) * g * g
    return m2, r2


def adam_base_update(g, p, m, r, s):
    """Bias-corrected adam step direction incl. decoupled weight decay.
    Returns (m2, r2, u)."""
    m2, r2 = adam_moments(g, m, r, s)
    u = (m2 / s["c1"]) / (sqrt_rn(r2 / s["c2"]) + s["eps"]) \
        + s["weight_decay"] * p
    return m2, r2, u


def update_math(spec: AlgoSpec, g, p, m, r, s):
    """One 32-bit optimizer update on (already gnorm-scaled) g.  Returns
    (m2, r2, p2).  ``s``: lr, beta1, beta2, eps, weight_decay, c1, c2."""
    if spec.name in ("adam", "adamw"):
        m2, r2, u = adam_base_update(g, p, m, r, s)
        return m2, r2, p - s["lr"] * u
    raise ValueError(f"update math for {spec.name!r} is not ported yet "
                     f"(ROADMAP A7)")


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
    return {k: v.to(device) for k, v in s.items()}


# ------------------------------------------------------------ plain version
def fused_update_plain(p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m,
                       qmap_r, s, *, algo: str = "adam") -> FusedUpdateResult:
    """Plain PyTorch version of the kernel (any device; returns new
    tensors).  ``s`` from :func:`scalars`."""
    spec = ALGO_SPECS[algo]
    g = g.to(torch.float32) * s["gnorm_scale"]
    m = common.decode(codes_m, qmap_m) * absmax_m[:, None]
    r = common.decode(codes_r, qmap_r) * absmax_r[:, None]
    m2, r2, p2 = update_math(spec, g, p, m, r, s)
    cm, am = common.block_requantize(m2, common.padded_bounds(qmap_m))
    cr, ar = common.block_requantize(r2, common.padded_bounds(qmap_r))
    return FusedUpdateResult(p2, cm.to(torch.uint8), am[:, 0],
                             cr.to(torch.uint8), ar[:, 0])


# ----------------------------------------------------------------- wrapper
def _check(p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r):
    if p.dim() != 2 or p.shape[1] % 4 or not \
            0 < p.shape[1] <= common.MAX_BLOCK_SIZE:
        raise ValueError(f"p must be (n_blocks, B) with B a multiple of 4 "
                         f"and at most {common.MAX_BLOCK_SIZE}, got "
                         f"{tuple(p.shape)}")
    nb, bsz = p.shape
    dev = p.device
    build.require(p, "p", torch.float32)
    build.require(g, "g", torch.float32, (nb, bsz), dev)
    for name, c, a in (("m", codes_m, absmax_m), ("r", codes_r, absmax_r)):
        build.require(c, f"codes_{name}", torch.uint8, (nb, bsz), dev)
        build.require(a, f"absmax_{name}", torch.float32, (nb,), dev)
    for name, q in (("qmap_m", qmap_m), ("qmap_r", qmap_r)):
        build.require(q, name, torch.float32, (common.CODEBOOK_SIZE,), dev)


def fused_update_cuda(p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m,
                      qmap_r, *, algo: str, lr, beta1=0.9, beta2=0.999,
                      eps=1e-8, weight_decay=0.0, step=1.0, gnorm_scale=1.0
                      ) -> FusedUpdateResult:
    """One fused 8-bit Adam/AdamW step, **in place**: ``p``, both code
    tensors and both absmax vectors are overwritten with the new values
    (saving a copy of each) and returned in the result.

    p, g: (n_blocks, B) f32; codes: (n_blocks, B) uint8; absmax:
    (n_blocks,) f32; qmaps: 256-entry f32 codebooks (signed for m, unsigned
    for r).  CUDA tensors launch ``csrc/fused_update.cu``; CPU tensors run
    :func:`fused_update_plain`.  adam and adamw share one update (decoupled
    weight decay), as in the JAX package."""
    if algo not in ALGO_SPECS:
        raise ValueError(f"fused 8-bit update for {algo!r} is not ported yet"
                         f" (ROADMAP B3(c))")
    _check(p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r)
    s = scalars(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                weight_decay=weight_decay, step=step,
                gnorm_scale=gnorm_scale, device="cpu")
    if p.device.type == "cpu":
        res = fused_update_plain(p, g, codes_m, absmax_m, codes_r, absmax_r,
                                 qmap_m, qmap_r, s, algo=algo)
        for dst, src in zip((p, codes_m, absmax_m, codes_r, absmax_r),
                            res[:5]):
            dst.copy_(src)
    elif p.device.type == "cuda":
        lib = _lib()
        v = {k: float(t) for k, t in s.items()}
        with torch.cuda.device(p.device):
            rc = lib.fused_adam8_update(
                *(build.ptr(t) for t in (p, g, codes_m, absmax_m, codes_r,
                                         absmax_r, qmap_m, qmap_r)),
                p.shape[0], p.shape[1], v["lr"], v["beta1"],
                float(1.0 - s["beta1"]), v["beta2"],
                float(1.0 - s["beta2"]), v["eps"], v["weight_decay"],
                v["c1"], v["c2"], v["gnorm_scale"], build.stream(p.device))
        build.check(lib, rc, "fused_adam8_update")
        fused_update_cuda.launches += 1
    else:
        raise ValueError(f"no fused-update kernel for device {p.device}")
    return FusedUpdateResult(p, codes_m, absmax_m, codes_r, absmax_r)


fused_update_cuda.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("fused_update")
    lib.fused_adam8_update.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_float] * 10
        + [ctypes.c_void_p])
    lib.fused_adam8_update.restype = ctypes.c_int
    return lib
