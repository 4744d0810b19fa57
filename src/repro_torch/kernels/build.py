"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each library of :data:`LIBRARIES` is a source compiled by ``nvcc`` for
``sm_90a`` with its defines into a shared library with a plain C
interface, loaded with ``ctypes`` — no PyTorch headers, so a build takes
seconds.  The fused update and its norm prologue are each compiled twice,
once per element type of the parameter (``RQ_P_BF16``: bf16, the bf16
masters' instances; ``csrc/common.cuh`` ``PElem``), into two libraries
with the same C entries, so that the two builds run in parallel.  The
libraries go to ``build/kernels/<key>/`` under the repository root (listed
in ``.gitignore``), where ``<key>`` hashes the sources, the flags and the
defines, so an edited source is rebuilt and an unchanged one is reused.
All libraries are compiled in parallel, one ``nvcc`` process each.

Flags: no ``--use_fast_math``, and ``--fmad=false`` so that ``a*b + c`` is
not contracted into an FMA — the kernels round like PyTorch's eager
elementwise ops, which their plain versions use.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
# library -> (source in csrc/, its defines)
LIBRARIES = {
    "blockwise_quant": ("blockwise_quant", ()),
    "blockwise_dequant": ("blockwise_dequant", ()),
    "fused_update": ("fused_update", ()),
    "fused_update_bf16": ("fused_update", ("-DRQ_P_BF16",)),
    "norm_partials": ("norm_partials", ()),
    "norm_partials_bf16": ("norm_partials", ("-DRQ_P_BF16",)),
    "newton_schulz": ("newton_schulz", ()),
    "paged_gather": ("paged_gather", ()),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo")


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")
    return path


def build_dir(csrc: Path = CSRC) -> Path:
    """Directory keyed by the sources' contents, the compiler flags and
    the libraries' defines."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(LIBRARIES.items())).encode())
    for f in sorted(csrc.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(names=tuple(LIBRARIES), csrc: Path = CSRC) -> dict:
    """Compile every missing library of ``names`` (keys of
    :data:`LIBRARIES`) in parallel (from the sources in ``csrc``: another
    tree's, to compare kernels).  Returns
    ``{name: seconds}`` for the ones compiled (empty when all were built);
    the compiler's register/shared-memory report is kept beside each
    library as ``<name>.log``."""
    out_dir = build_dir(csrc)
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not (out_dir / f"{n}.so").exists()]
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = out_dir / f"{n}.{os.getpid()}.tmp.so"
        source, defines = LIBRARIES[n]
        cmd = [nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp),
               str(csrc / f"{source}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    seconds, failed = {}, []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        (out_dir / f"{n}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}:\n{log}")
            continue
        os.replace(tmp, out_dir / f"{n}.so")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a key of :data:`LIBRARIES`), built if
    missing."""
    build((name,))
    lib = ctypes.CDLL(str(build_dir() / f"{name}.so"))
    lib.rq_error_string.argtypes = [ctypes.c_int]
    lib.rq_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}: "
                           f"{lib.rq_error_string(rc).decode()}")


def require(t, name: str, dtype, shape=None, device=None) -> None:
    """Validate a kernel argument before its pointer is handed to C."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


@functools.cache
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device, from which the kernels'
    C helpers size their grids (the gram's chunks, the CTAs of the packed
    update and the norm prologue)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
