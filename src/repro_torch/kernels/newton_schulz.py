"""Newton–Schulz orthogonalization for Muon (mirrors
``repro.kernels.newton_schulz``).

Muon (Jordan et al. 2024; quantized states: Gupta et al. 2025)
orthogonalizes its 2-D momentum with the quintic Newton–Schulz iteration

    X <- a X + b (X X^T) X + c (X X^T)^2 X

run ``steps`` times on the Frobenius-normalized momentum matrix.  With the
small dimension first (X is (m, n), m <= n; a tall matrix is transposed)
each iteration is

  * **gram**     A = X X^T, (m, m) — kernel B5, ``csrc/newton_schulz.cu``
    (``ns_gram``);
  * **finalize** B = b A + c A A — one m x m product, plain torch as the
    JAX package leaves it to XLA;
  * **apply**    X' = a X + B X, (m, n) — kernel B6 (``ns_apply``).

``impl="cuda"`` routes gram and apply through :func:`gram_cuda` /
:func:`apply_cuda`, which launch the kernels on CUDA tensors and run the
plain versions on CPU tensors; ``impl="torch"`` runs the plain versions.
The plain versions replay the JAX package's tile loop on the same zero-
padded arrays (rows to a multiple of 8, columns to a multiple of
``TILE_N``): the gram sums one (m, 256) x (256, m) product per column tile
in order, the apply computes each column tile on its own.  The kernels
take their products on the tensor cores in 3xTF32 (each f32 operand split
into two TF32 parts; lo*hi, hi*lo, then hi*hi, lo*lo dropped) and sum in
another order: each output over 32-column stages, a stage on the tensor
cores and the stages with round-to-nearest f32 adds; the gram's
contraction split into chunks of whole 256-column tiles (their count from
the C entry ``ns_gram_splits``), whose partials a second kernel adds in
chunk order.  So they agree
with the plain versions within a bound (``csrc/newton_schulz.cu``: about
2e-6 of the largest magnitude expected at the head's shape, held to
1e-5), not bit for bit, and give the same bits run to run; the gram is
exactly symmetric.  The m x m finalize uses ``torch.matmul``, which is
full f32 on the card unless the caller has enabled TF32
(``torch.backends.cuda.matmul.allow_tf32``); the kernels' TF32 is their
own.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.device import to_device
from repro_torch.kernels import build
from repro_torch.kernels.fused_update import sqrt_rn

# Muon quintic coefficients (Jordan et al. 2024).
NS_COEFFS = (3.4445, -4.7750, 2.0315)
DEFAULT_NS_STEPS = 5
# Column tile of the JAX package's kernels (and of the plain versions here).
TILE_N = 256
_ROW_MULTIPLE = 8


def pad_matrix(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad (m, n) so m is a multiple of 8 and n of ``TILE_N``."""
    m, n = x.shape
    mp = -(-m // _ROW_MULTIPLE) * _ROW_MULTIPLE
    np_ = -(-n // TILE_N) * TILE_N
    if (mp, np_) != (m, n):
        x = torch.nn.functional.pad(x, (0, np_ - n, 0, mp - m))
    return x


def gram_plain(x: torch.Tensor) -> torch.Tensor:
    """A = X X^T of a padded (m, n) f32 matrix, summed over column tiles
    in order (any device)."""
    m, n = x.shape
    acc = torch.zeros((m, m), dtype=torch.float32, device=x.device)
    for j in range(0, n, TILE_N):
        xt = x[:, j:j + TILE_N]
        acc = acc + xt @ xt.T
    return acc


def apply_plain(x: torch.Tensor, b_mat: torch.Tensor, a: float
                ) -> torch.Tensor:
    """X' = a X + B X of a padded (m, n) f32 matrix, one column tile at a
    time (any device)."""
    tiles = [a * x[:, j:j + TILE_N] + b_mat @ x[:, j:j + TILE_N]
             for j in range(0, x.shape[1], TILE_N)]
    return tiles[0] if len(tiles) == 1 else torch.cat(tiles, dim=1)


def _check_x(x: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got {tuple(x.shape)}")
    m, n = x.shape
    if m % 4 or n % 64 or not 0 < m <= n:
        raise ValueError(f"x {tuple(x.shape)}: the kernels take m <= n, m a "
                         f"multiple of 4 and n of 64 (pad_matrix pads to 8 "
                         f"and {TILE_N})")
    build.require(x, "x", torch.float32)


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def gram_cuda(x: torch.Tensor) -> torch.Tensor:
    """A = X X^T, (m, m) f32, for a padded (m, n) f32 matrix (m <= n).
    CUDA tensors launch ``ns_gram`` (the partial-product kernel over S
    chunks into an (S, m, m) workspace, S from ``ns_gram_splits``, then
    the kernel that adds the chunks); CPU tensors run :func:`gram_plain`."""
    _check_x(x)
    if x.device.type == "cpu":
        return gram_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no gram kernel for device {x.device}")
    m, n = x.shape
    lib = _lib()
    splits = lib.ns_gram_splits(m, n, _sm_count(x.device))
    work = torch.empty((splits, m, m), dtype=torch.float32, device=x.device)
    out = torch.empty((m, m), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.ns_gram(build.ptr(x), build.ptr(work), build.ptr(out), m, n,
                         splits, build.stream(x.device))
    build.check(lib, rc, "ns_gram")
    gram_cuda.launches += 1
    return out


gram_cuda.launches = 0


def apply_cuda(x: torch.Tensor, b_mat: torch.Tensor, a: float
               ) -> torch.Tensor:
    """X' = a X + B X, (m, n) f32, a new tensor, for a padded (m, n) f32
    matrix and B (m, m).  CUDA tensors launch ``ns_apply``; CPU tensors run
    :func:`apply_plain`."""
    _check_x(x)
    m, n = x.shape
    build.require(b_mat, "b_mat", torch.float32, (m, m), x.device)
    if x.device.type == "cpu":
        return apply_plain(x, b_mat, a)
    if x.device.type != "cuda":
        raise ValueError(f"no apply kernel for device {x.device}")
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.ns_apply(build.ptr(x), build.ptr(b_mat), build.ptr(out),
                          float(a), m, n, build.stream(x.device))
    build.check(lib, rc, "ns_apply")
    apply_cuda.launches += 1
    return out


apply_cuda.launches = 0

_STEPS = {"torch": (gram_plain, apply_plain),
          "cuda": (gram_cuda, apply_cuda)}


def newton_schulz(x: torch.Tensor, *, steps: int = DEFAULT_NS_STEPS,
                  impl: str = "cuda", eps: float = 1e-7) -> torch.Tensor:
    """≈ orth(x): quintic Newton–Schulz on a 2-D matrix of any shape
    (tall ones through the transpose), in f32.  ``impl``: "cuda" (the
    kernels on CUDA tensors, their plain versions on CPU tensors) or
    "torch" (the plain versions)."""
    if x.dim() != 2:
        raise ValueError(f"newton_schulz takes a 2-D matrix, got "
                         f"{tuple(x.shape)}")
    if impl not in _STEPS:
        raise KeyError(f"impl={impl!r}; one of {tuple(_STEPS)}")
    gram, apply = _STEPS[impl]
    a, b, c = NS_COEFFS
    transpose = x.shape[0] > x.shape[1]
    x = x.T if transpose else x
    shape = x.shape
    x = x.to(torch.float32)
    eps_t = to_device(torch.tensor(eps, dtype=torch.float32), x.device)
    x = x / (sqrt_rn((x * x).sum()) + eps_t)
    x = pad_matrix(x).contiguous()
    for _ in range(steps):
        g = gram(x)
        # the quintic's small m x m factor, outside the kernels:
        # B = b A + c A A
        b_mat = b * g + c * (g @ g)
        x = apply(x, b_mat, a)
    out = x[:shape[0], :shape[1]]
    return out.T if transpose else out


def rms_scale(shape: tuple) -> float:
    """Muon's shape-dependent update scale sqrt(max(1, m/n)): it matches
    the RMS of an Adam-style update across aspect ratios (Jordan et al.
    2024)."""
    m, n = shape
    return max(1.0, m / n) ** 0.5


def muon_math(g, p, m, *, beta1, lr, weight_decay,
              steps: int = DEFAULT_NS_STEPS, impl: str = "cuda"):
    """One f32 Muon step on matrix-shaped (g, p, m): nesterov momentum
    EMA, Newton–Schulz orthogonalization, rms-matched param update.
    Returns (m2, p2).  Shared by the quantized update (``ops``'s muon
    entry) and the f32 leaves (``MuonOptimizer._math32``), as in the JAX
    package.  ``g`` is already gnorm-scaled; all inputs f32."""
    def f32(v):                 # a scalar as a 0-d f32 tensor on p's device
        t = torch.as_tensor(v, dtype=torch.float32)
        return t if t.device == p.device else to_device(t, p.device)

    b1 = f32(beta1)
    m2 = b1 * m + g
    o = newton_schulz(g + b1 * m2, steps=steps, impl=impl)
    p2 = p - f32(lr) * (f32(rms_scale(tuple(p.shape))) * o
                        + f32(weight_decay) * p)
    return m2, p2


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library("newton_schulz")
    lib.ns_gram.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.ns_gram.restype = ctypes.c_int
    lib.ns_gram_splits.argtypes = [ctypes.c_int] * 3
    lib.ns_gram_splits.restype = ctypes.c_int
    lib.ns_apply.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_float] + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.ns_apply.restype = ctypes.c_int
    return lib
