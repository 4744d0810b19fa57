"""The CUDA kernels' logic, checked on the CPU.

Each source in ``src/repro_torch/kernels/csrc`` is compiled by the host C++
compiler against a small emulation of the CUDA features it uses — one
``std::thread`` per CUDA thread, ``std::barrier`` for ``__syncthreads`` and
the warp shuffles, IEEE single-rounding float intrinsics — and its output
is held bit for bit against the kernel's plain PyTorch version.  This
covers the indexing, the block reductions, the binary-search encode and the
in-place ordering of every kernel without a card.  The inline PTX of the
tensor-core kernels sits behind the helpers of ``csrc/mma_sm90.cuh``, which
the fixture replaces by a host version: a synchronous copy for
``cp.async`` and, for the TF32 ``mma``, fragments exchanged through a
per-warp buffer and summed in f32 in a fixed order; those kernels are held
to their plain versions within the stated tolerance.  What ``nvcc``
accepts, and the kernels' speed, only ``chip_smoke.py`` on an H100 can
show."""
import ctypes
import re
import shutil
import subprocess

import pytest
import torch

from repro_torch.core import qmap
from repro_torch.kernels import blockwise_dequant as bdq
from repro_torch.kernels import blockwise_quant as bq
from repro_torch.kernels import build
from repro_torch.kernels import fused_update as fu
from repro_torch.kernels import paged_kv

CUDA_RUNTIME_H = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
inline unsigned char* emu_dyn_smem;
#define RQ_DYNAMIC_SHARED(T, name) T* name = reinterpret_cast<T*>(emu_dyn_smem)
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct dim3 { unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3 { unsigned x, y, z; };
inline thread_local uint3 threadIdx;
inline uint3 blockIdx;
inline dim3 blockDim;
struct float4 { float x, y, z, w; };
struct float3 { float x, y, z; };
struct float2 { float x, y; };
struct uchar4 { unsigned char x, y, z, w; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float3 make_float3(float a, float b, float c) { return {a, b, c}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d}; }
inline uchar4 make_uchar4(unsigned char a, unsigned char b, unsigned char c,
                          unsigned char d) { return {a, b, c, d}; }
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef struct CUstream_st* cudaStream_t;
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline std::barrier<>* emu_block_barrier;
inline std::vector<std::barrier<>*> emu_warp_barriers;
inline float emu_warp_buf[32][32];
inline int emu_warp_ibuf[32][32];
inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  emu_warp_buf[w][lane] = v;
  emu_warp_barriers[w]->arrive_and_wait();
  const float r = emu_warp_buf[w][lane ^ o];
  emu_warp_barriers[w]->arrive_and_wait();
  return r;
}
inline int __shfl_xor_sync(unsigned, int v, int o) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  emu_warp_ibuf[w][lane] = v;
  emu_warp_barriers[w]->arrive_and_wait();
  const int r = emu_warp_ibuf[w][lane ^ o];
  emu_warp_barriers[w]->arrive_and_wait();
  return r;
}
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fsqrt_rn(float a) { volatile float r = std::sqrt(a); return r; }
template <class F> void emu_launch(dim3 grid, dim3 block, size_t smem, F f) {
  blockDim = block;
  std::vector<float> dyn((smem + 3) / 4 + 4);
  for (unsigned by = 0; by < grid.y; ++by)
  for (unsigned b = 0; b < grid.x; ++b) {
    blockIdx = {b, by, 0};
    emu_dyn_smem = reinterpret_cast<unsigned char*>(dyn.data());
    std::memset(dyn.data(), 0xff, dyn.size() * 4);  // stale data: NaNs
    std::barrier<> bar(block.x);
    emu_block_barrier = &bar;
    std::vector<std::barrier<>*> warps;
    for (unsigned w = 0; w < block.x / 32; ++w)
      warps.push_back(new std::barrier<>(32));
    emu_warp_barriers = warps;
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block.x; ++t)
      threads.emplace_back([&, t] { threadIdx = {t, 0, 0}; f(); });
    for (auto& t : threads) t.join();
    for (auto* w : warps) delete w;
  }
}
"""

CUDA_BF16_H = r"""
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 emu_bf16(float f) {  // round to nearest even
  uint32_t u; std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {0x7fc0};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<unsigned short>(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {emu_bf16(a), emu_bf16(b)};
}
inline __nv_bfloat16 __float2bfloat16_rn(float a) { return emu_bf16(a); }
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.x; }
"""

# Host version of csrc/mma_sm90.cuh.  cp.async copies at once (the kernels
# order their stages with __syncthreads); tf32_round as on the card.  The
# mma: every lane posts its fragments, truncated to TF32 as the tensor core
# reads an f32 register, to a per-warp buffer, one warp barrier, then each
# lane sums its four outputs, d + the eight products in k order, in f32.
# Two buffers taken in turns make one barrier per call enough: a lane
# rewrites a buffer only after the next barrier, which every lane reaches
# after reading it.
MMA_SM90_H = r"""
#pragma once
#include <cstdint>
#include <cstring>
inline void cp_async_16(void* dst, const void* src, bool valid) {
  if (valid) std::memcpy(dst, src, 16); else std::memset(dst, 0, 16);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
inline float emu_bits_and(float x, uint32_t add, uint32_t mask) {
  uint32_t u; std::memcpy(&u, &x, 4);
  u = (u + add) & mask;
  std::memcpy(&x, &u, 4);
  return x;
}
inline float tf32_round(float x) {
  return emu_bits_and(x, 0x1000u, 0xffffe000u);
}
inline float emu_mma_buf[2][32][32][6];
inline thread_local unsigned emu_mma_turn;
inline void mma_tf32_m16n8k8(float (&d)[4], const float (&a)[4],
                             const float (&b)[2]) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float (*buf)[6] = emu_mma_buf[emu_mma_turn++ & 1][w];
  const uint32_t tf32 = 0xffffe000u;
  for (int i = 0; i < 4; ++i) buf[lane][i] = emu_bits_and(a[i], 0, tf32);
  buf[lane][4] = emu_bits_and(b[0], 0, tf32);
  buf[lane][5] = emu_bits_and(b[1], 0, tf32);
  emu_warp_barriers[w]->arrive_and_wait();
  const int g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i >> 1), c = 2 * t + (i & 1);
    float s = d[i];
    for (int k = 0; k < 8; ++k)
      s = s + buf[(r & 7) * 4 + (k & 3)][(r >> 3) + 2 * (k >> 2)]
              * buf[c * 4 + (k & 3)][4 + (k >> 2)];
    d[i] = s;
  }
}
"""

LAUNCH = re.compile(r"<<<grid, block, (\w+), stream>>>\(")
P = ctypes.c_void_p


def _emulated_source(src: str) -> str:
    """Rewrite each ``kernel<<<grid, block, smem, stream>>>(args)`` launch
    (the kernel name may carry template arguments) as
    ``emu_launch(grid, block, smem, [&]{ kernel(args); })``."""
    out, i = [], 0
    while (hit := LAUNCH.search(src, i)) is not None:
        j = hit.start()
        k, angle = j, 0
        while angle or src[k - 1] not in " \n\t:":
            angle += {">": 1, "<": -1}.get(src[k - 1], 0)
            k -= 1
        depth, m = 1, hit.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(src[m], 0)
            m += 1
        args = src[hit.end():m - 1]
        out.append(f"{src[i:k]}emu_launch(grid, block, {hit.group(1)}, "
                   f"[&]{{ {src[k:j]}({args}); }})")
        i = m
    out.append(src[i:])
    return "".join(out)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++) to build the emulation")
    d = tmp_path_factory.mktemp("emulated_cuda")
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (d / "cuda_bf16.h").write_text(CUDA_BF16_H)
    for f in build.CSRC.iterdir():
        (d / f.name).write_text(_emulated_source(f.read_text()))
    (d / "mma_sm90.cuh").write_text(MMA_SM90_H)
    procs = {n: subprocess.Popen(
        [cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread", f"-I{d}", "-x", "c++", str(d / f"{n}.cu"), "-o",
         str(d / f"{n}.so")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for n in build.SOURCES}
    for n, p in procs.items():
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, f"{n}:\n{log}"
    libs = {n: ctypes.CDLL(str(d / f"{n}.so")) for n in build.SOURCES}
    libs["blockwise_quant"].blockwise_quantize.argtypes = [P] * 4 + [
        ctypes.c_int] * 5 + [P]
    libs["blockwise_dequant"].blockwise_dequantize.argtypes = [P] * 4 + [
        ctypes.c_int] * 4 + [P]
    for name, (source, argtypes) in fu.ARGTYPES.items():
        getattr(libs[source], name).argtypes = argtypes
    libs["newton_schulz"].ns_gram.argtypes = [P] * 3 + [ctypes.c_int] * 3 \
        + [P]
    libs["newton_schulz"].ns_gram_splits.argtypes = [ctypes.c_int] * 3
    libs["newton_schulz"].ns_apply.argtypes = [P] * 3 + [ctypes.c_float] \
        + [ctypes.c_int] * 2 + [P]
    libs["paged_gather"].paged_gather.argtypes = [P] * 5 + [
        ctypes.c_int] * 7 + [P]
    return libs


SHAPES = [(5, 2048), (3, 260), (2, 8192), (1, 64)]
QS = torch.as_tensor(qmap.get_qmap("dynamic", True))
QU = torch.as_tensor(qmap.get_qmap("dynamic", False))


def _ptrs(*ts):
    return [P(t.data_ptr()) for t in ts]


def _x(nb, bsz, seed):
    """Blocks over many decades, an all-zero block, and in block 0 the
    codebook midpoints themselves (with absmax 1, so x / scale lands
    exactly on them: a midpoint belongs to the upper code)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(nb, bsz, generator=g) * torch.exp(
        torch.randn(nb, 1, generator=g) * 3)
    k = min(bsz, 256) - 1
    x[0, :k] = torch.as_tensor(qmap.boundaries(qmap.get_qmap(
        "dynamic", True)))[:k]
    x[0, k] = 1.0
    x[nb // 2] = 0.0
    return x


@pytest.mark.parametrize("nb,bsz", SHAPES)
def test_quantize_kernel_emulated(libs, nb, bsz):
    x = _x(nb, bsz, 0)
    if nb > 2:
        x[2, 3] = float("nan")        # NaN: code 0, NaN absmax
    codes = torch.empty(nb, bsz, dtype=torch.uint8)
    absmax = torch.empty(nb)
    rc = libs["blockwise_quant"].blockwise_quantize(
        *_ptrs(x, QS, codes, absmax), nb, bsz, 8, 0, 0, None)
    want_c, want_a = bq.quantize_plain(x, QS)
    assert rc == 0
    assert torch.equal(codes, want_c)
    assert torch.equal(absmax.nan_to_num(-1.0), want_a.nan_to_num(-1.0))


@pytest.mark.parametrize("nb,bsz", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequantize_kernel_emulated(libs, nb, bsz, dtype):
    codes, absmax = bq.quantize_plain(_x(nb, bsz, 1), QS)
    out = torch.empty(nb, bsz, dtype=dtype)
    rc = libs["blockwise_dequant"].blockwise_dequantize(
        *_ptrs(codes, absmax, QS, out), int(dtype == torch.bfloat16), nb, bsz,
        8, None)
    assert rc == 0
    assert torch.equal(out, bdq.dequantize_plain(codes, absmax, QS, dtype))


@pytest.mark.parametrize("nb,bsz", SHAPES)
def test_fused_update_kernel_emulated(libs, nb, bsz):
    g = torch.Generator().manual_seed(2)
    p = torch.randn(nb, bsz, generator=g) * 0.02
    grad = torch.randn(nb, bsz, generator=g) * 1e-3
    cm = torch.randint(0, 256, (nb, bsz), generator=g, dtype=torch.uint8)
    cr = torch.randint(0, 256, (nb, bsz), generator=g, dtype=torch.uint8)
    am = torch.rand(nb, generator=g) * 1e-3 + 1e-5
    ar = torch.rand(nb, generator=g) * 1e-6 + 1e-9
    s = fu.scalars(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                   weight_decay=0.01, step=7.0, gnorm_scale=0.5, device="cpu")
    want = fu.fused_update_plain(p, grad, cm, am, cr, ar, QS, QU, s,
                                 algo="adamw")
    got = [t.clone() for t in (p, grad, cm, am, cr, ar)]
    rc = libs["fused_update"].fused_update(
        fu.KERNEL_ALGOS["adamw"], *_ptrs(*got, QS, QU), None, None, None, 0,
        0, nb, bsz, *fu._kernel_scalars(s), None)
    assert rc == 0
    for a, b in zip((got[0], *got[2:]), want[:5]):    # updated in place
        assert torch.equal(a, b)


def _algo_inputs(algo, nb, bsz, seed):
    """p, g, states and codebooks for one algorithm: random codes with
    nonzero absmax (adagrad's single state on the unsigned map)."""
    spec = fu.ALGO_SPECS[algo]
    g = torch.Generator().manual_seed(seed)
    p = torch.randn(nb, bsz, generator=g) * 0.02
    grad = torch.randn(nb, bsz, generator=g) * 1e-3
    grad[nb - 1, :8] = 0.0
    cm = torch.randint(0, 256, (nb, bsz), generator=g, dtype=torch.uint8)
    am = torch.rand(nb, generator=g) * 1e-3 + 1e-5
    q1 = QS if spec.state1_signed else QU
    cr = ar = None
    if spec.n_states == 2:
        cr = torch.randint(0, 256, (nb, bsz), generator=g, dtype=torch.uint8)
        ar = torch.rand(nb, generator=g) * 1e-6 + 1e-9
    return p, grad, cm, am, cr, ar, q1, QU


def _scalars(step=7.0):
    return fu.scalars(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                      weight_decay=0.01, step=step, gnorm_scale=0.5,
                      device="cpu")


@pytest.mark.parametrize("nb,bsz", [(3, 2048), (2, 260)])
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("algo", ["adam", "lamb", "momentum", "lars",
                                  "adagrad"])
def test_fused_update_algos_emulated(libs, algo, stochastic, nb, bsz):
    """Every algorithm of the templated kernel, deterministic and
    stochastic (per-block seeds and leaf-local offsets), bit for bit
    against the plain version; lamb/lars read a per-block trust ratio."""
    spec = fu.ALGO_SPECS[algo]
    p, grad, cm, am, cr, ar, q1, q2 = _algo_inputs(algo, nb, bsz, 3)
    s = _scalars()
    ts = (torch.rand(nb, generator=torch.Generator().manual_seed(4)) + 0.5
          if spec.needs_norms else None)
    seeds = torch.tensor([-7, 2 ** 31 - 1, 12345][:nb], dtype=torch.int32)
    offs = torch.tensor([5, 0, 9][:nb], dtype=torch.int32)
    uniforms = (fu.block_uniforms(nb, bsz, two=spec.n_states == 2,
                                  block_seeds=seeds, block_offsets=offs)
                if stochastic else (None, None))
    want = fu.fused_update_plain(p, grad, cm, am, cr, ar, q1, q2, s,
                                 algo=algo, tensor_scale=ts,
                                 uniforms=uniforms)
    got = [None if t is None else t.clone() for t in (p, cm, am, cr, ar)]
    ptr = lambda t: None if t is None else P(t.data_ptr())
    rc = libs["fused_update"].fused_update(
        fu.KERNEL_ALGOS[algo], ptr(got[0]), ptr(grad), *map(ptr, got[1:]),
        ptr(q1), ptr(q2 if spec.n_states == 2 else None), ptr(ts),
        ptr(seeds), ptr(offs), int(stochastic), 0, nb, bsz,
        *fu._kernel_scalars(s), None)
    assert rc == 0
    for name, a, b in zip(want._fields, got, want[:5]):
        if b is None:
            continue
        assert torch.equal(a, b), name
    if stochastic:                    # the hash did move some codes
        det = fu.fused_update_plain(p, grad, cm, am, cr, ar, q1, q2, s,
                                    algo=algo, tensor_scale=ts)
        assert not torch.equal(det.codes_m, got[1])


@pytest.mark.parametrize("nb,bsz", SHAPES)
@pytest.mark.parametrize("algo", ["lars", "lamb"])
def test_norm_partials_emulated(libs, algo, nb, bsz):
    """The norm prologue's per-block partials, bit for bit against the
    plain version, which adds in the kernel's own order (per thread in
    sequence, then the warp and CTA trees)."""
    p, grad, cm, am, cr, ar, q1, q2 = _algo_inputs("lamb", nb, bsz, 5)
    p = p * torch.exp(torch.randn(nb, bsz, generator=torch.Generator()
                                  .manual_seed(nb)) * 2)  # wide range
    s = _scalars(step=3.0)
    want = fu.norm_partials_plain(p, grad, cm, am, cr, ar, q1, q2, s,
                                  algo=algo)
    out = torch.full((nb, fu.N_PARTIALS), float("nan"))
    lamb = algo == "lamb"
    state = (cm, am, cr, ar, q1, q2) if lamb else (None,) * 6
    ptr = lambda t: None if t is None else P(t.data_ptr())
    rc = libs["norm_partials"].norm_partials(
        fu.NORM_KINDS[algo], ptr(p), ptr(grad), *map(ptr, state), ptr(out),
        nb, bsz, *fu._kernel_scalars(s), None)
    assert rc == 0
    assert torch.equal(out, want)
    assert (want[:, :2] > 0).all() and bool((want[:, 2] > 0).all()) == lamb
    # the order is what the test holds: on uniform data a row sum in
    # another order disagrees with block_sums
    u = torch.rand(64, 2048, generator=torch.Generator().manual_seed(0))
    assert not torch.equal(fu.block_sums(u), u.sum(dim=1))


# ------------------------------------------------- packed k-bit states (B3(d))
def _packed_inputs(algo, nb, bsz, bits_m, bits_r, seed):
    """p, g, packed states with nonzero absmax and 2^bits codebooks."""
    from repro_torch.core.lowbit import pack_codes
    spec = fu.ALGO_SPECS[algo]
    g = torch.Generator().manual_seed(seed)
    p = torch.randn(nb, bsz, generator=g) * 0.02
    grad = torch.randn(nb, bsz, generator=g) * 1e-3
    q1 = torch.as_tensor(qmap.get_qmap("dynamic", spec.state1_signed,
                                       bits=bits_m))
    q2 = torch.as_tensor(qmap.get_qmap("dynamic", False, bits=bits_r))
    cm = pack_codes(torch.randint(0, 1 << bits_m, (nb, bsz), generator=g),
                    bits_m)
    am = torch.rand(nb, generator=g) * 1e-3 + 1e-5
    cr = ar = None
    if spec.n_states == 2:
        cr = pack_codes(torch.randint(0, 1 << bits_r, (nb, bsz),
                                      generator=g), bits_r)
        ar = torch.rand(nb, generator=g) * 1e-6 + 1e-9
    return p, grad, cm, am, cr, ar, q1, q2


PACKED_BITS = [(4, 8), (5, 6), (6, 4), (8, 5)]


@pytest.mark.parametrize("nb,bsz", [(3, 2048), (2, 264)])
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", PACKED_BITS, ids=lambda b: f"{b[0]}-{b[1]}")
@pytest.mark.parametrize("algo", ["adam", "lamb", "momentum", "lars",
                                  "adagrad"])
def test_fused_update_packed_emulated(libs, algo, bits, stochastic, nb, bsz):
    """The packed kernel at every width, every algorithm, deterministic
    and stochastic, bit for bit against the plain version (p, packed
    codes, absmax), updated in place."""
    spec = fu.ALGO_SPECS[algo]
    two = spec.n_states == 2
    bits_m, bits_r = bits
    p, grad, cm, am, cr, ar, q1, q2 = _packed_inputs(algo, nb, bsz, bits_m,
                                                     bits_r, 6)
    s = _scalars()
    ts = (torch.rand(nb, generator=torch.Generator().manual_seed(4)) + 0.5
          if spec.needs_norms else None)
    seeds = torch.tensor([-7, 2 ** 31 - 1, 12345][:nb], dtype=torch.int32)
    offs = torch.tensor([5, 0, 9][:nb], dtype=torch.int32)
    uniforms = (fu.block_uniforms(nb, bsz, two=two, block_seeds=seeds,
                                  block_offsets=offs)
                if stochastic else (None, None))
    want = fu.fused_update_plain(p, grad, cm, am, cr, ar, q1, q2, s,
                                 algo=algo, tensor_scale=ts,
                                 uniforms=uniforms, bits_m=bits_m,
                                 bits_r=bits_r if two else 8)
    got = [None if t is None else t.clone() for t in (p, cm, am, cr, ar)]
    ptr = lambda t: None if t is None else P(t.data_ptr())
    rc = libs["fused_update"].fused_update_packed(
        fu.KERNEL_ALGOS[algo], ptr(got[0]), ptr(grad), *map(ptr, got[1:]),
        ptr(q1), ptr(q2 if two else None), ptr(ts), ptr(seeds), ptr(offs),
        int(stochastic), 0, nb, bsz, bits_m, bits_r if two else 8,
        *fu._kernel_scalars(s), None)
    assert rc == 0
    for name, a, b in zip(want._fields, got, want[:5]):
        if b is None:
            continue
        assert torch.equal(a, b), name
    assert want.codes_m.shape == (nb, bsz * bits_m // 8)


def test_fused_update_packed_at_8_bits_equals_8bit_kernel(libs):
    """The packed kernel at (8, 8) gives the 8-bit kernel's bits."""
    p, grad, cm, am, cr, ar, q1, q2 = _algo_inputs("adam", 3, 2048, 8)
    s = _scalars()
    outs = []
    for fn in ("fused_update", "fused_update_packed"):
        got = [t.clone() for t in (p, cm, am, cr, ar)]
        widths = (8, 8) if fn == "fused_update_packed" else ()
        rc = getattr(libs["fused_update"], fn)(
            fu.KERNEL_ALGOS["adam"], *_ptrs(got[0], grad, *got[1:], q1, q2),
            None, None, None, 0, 0, 3, 2048, *widths,
            *fu._kernel_scalars(s), None)
        assert rc == 0
        outs.append(got)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---------------------------------------------- the sentinel output (B3(e))
def _poison(grad, am, ar):
    """Plant nonfinite and huge values: block 0's grad holds NaN, +inf and
    -inf (a NaN absmax, so x / scale reaches +inf: the capped encode),
    block 1's grad 1e31 (an absmax past the overflow guard, or an inf
    second moment), block 2's state absmax inf (dequantized state inf and
    NaN); block 3 stays clean."""
    grad[0, 3], grad[0, 7], grad[0, 11] = float("nan"), float("inf"), \
        -float("inf")
    grad[1, 5] = 1e31
    am[2] = float("inf")
    if ar is not None:
        ar[2] = float("inf")


def _same(a, b) -> bool:
    """Equal values with NaN at the same places (payloads aside)."""
    if a.is_floating_point():
        nan = a.isnan()
        return torch.equal(nan, b.isnan()) and torch.equal(a[~nan], b[~nan])
    return torch.equal(a, b)


def _bits_of(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


SENTINEL_BITS = [(8, 8), (4, 8), (5, 6), (6, 4)]


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", SENTINEL_BITS, ids=lambda b: f"{b[0]}-{b[1]}")
@pytest.mark.parametrize("algo", ["adam", "lamb", "momentum", "lars",
                                  "adagrad"])
def test_fused_update_sentinel_emulated(libs, algo, bits, stochastic):
    """The SENT instances of both kernels (8/8: fused_update_sentinel,
    below 8 bits: fused_update_packed_sentinel), with NaN, +-inf and 1e31
    planted in the grad and the state: the health rows equal
    ``health_rows`` of the plain version exactly, p / codes / absmax equal
    the plain version's (NaN where it has NaN), and bit for bit the
    sentinel-off instance's on the same inputs."""
    spec = fu.ALGO_SPECS[algo]
    two = spec.n_states == 2
    bits_m, bits_r = bits if two else (bits[0], 8)
    packed = (bits_m, bits_r) != (8, 8)
    nb, bsz = 4, 264
    p, grad, cm, am, cr, ar, q1, q2 = _packed_inputs(algo, nb, bsz, bits_m,
                                                     bits_r, 11)
    _poison(grad, am, ar)
    s = _scalars()
    ts = (torch.rand(nb, generator=torch.Generator().manual_seed(4)) + 0.5
          if spec.needs_norms else None)
    seeds = torch.tensor([-7, 2 ** 31 - 1, 12345, 3], dtype=torch.int32)
    offs = torch.tensor([5, 0, 9, 1], dtype=torch.int32)
    uniforms = (fu.block_uniforms(nb, bsz, two=two, block_seeds=seeds,
                                  block_offsets=offs)
                if stochastic else (None, None))
    want = fu.fused_update_plain(p, grad, cm, am, cr, ar, q1, q2, s,
                                 algo=algo, tensor_scale=ts,
                                 uniforms=uniforms, bits_m=bits_m,
                                 bits_r=bits_r, sentinel=True)
    ptr = lambda t: None if t is None else P(t.data_ptr())
    widths = (bits_m, bits_r) if packed else ()
    lib = libs["fused_update"]
    runs = {}
    for sent in (True, False):
        got = [None if t is None else t.clone() for t in (p, cm, am, cr, ar)]
        health = torch.full((nb, fu.N_HEALTH), -1.0)
        entry = "fused_update" + ("_packed" if packed else "") + (
            "_sentinel" if sent else "")
        rc = getattr(lib, entry)(
            fu.KERNEL_ALGOS[algo], ptr(got[0]), ptr(grad),
            *map(ptr, got[1:]), ptr(q1), ptr(q2 if two else None), ptr(ts),
            ptr(seeds), ptr(offs), *((ptr(health),) if sent else ()),
            int(stochastic), 0, nb, bsz, *widths, *fu._kernel_scalars(s),
            None)
        assert rc == 0
        runs[sent] = (got, health)
    got, health = runs[True]
    assert torch.equal(health, want.health)
    for name, a, b in zip(want._fields, got, want[:5]):
        if b is not None:
            assert _same(a, b), name
    for a, b in zip(got, runs[False][0]):
        if a is not None:
            assert torch.equal(_bits_of(a), _bits_of(b))
    h = dict(zip(fu.HEALTH_SLOTS, health.sum(dim=0).tolist()))
    assert h["nonfinite_grad"] == 3 and h["nonfinite_update"] >= 1
    assert h["nonfinite_absmax_m"] >= 1 and h["edge_hits_m"] >= 1
    assert health[3, :4].sum() == 0                 # the clean block


def test_fused_update_sentinel_clean_8bit_vpt(libs):
    """The 8-bit SENT instance at B = 2048 (two vectors per thread) on clean
    inputs: health equal to the plain version's, no nonfinite count."""
    p, grad, cm, am, cr, ar, q1, q2 = _algo_inputs("adam", 3, 2048, 8)
    s = _scalars()
    want = fu.fused_update_plain(p, grad, cm, am, cr, ar, q1, q2, s,
                                 algo="adam", sentinel=True)
    got = [t.clone() for t in (p, cm, am, cr, ar)]
    health = torch.full((3, fu.N_HEALTH), -1.0)
    rc = libs["fused_update"].fused_update_sentinel(
        fu.KERNEL_ALGOS["adam"], *_ptrs(got[0], grad, *got[1:], q1, q2),
        None, None, None, P(health.data_ptr()), 0, 0, 3, 2048,
        *fu._kernel_scalars(s), None)
    assert rc == 0
    assert torch.equal(health, want.health)
    assert health[:, :4].sum() == 0 and health[:, 4].sum() > 0
    for a, b in zip(got, want[:5]):
        assert torch.equal(a, b)


def test_fused_update_sentinel_requires_health(libs):
    p, grad, cm, am, cr, ar, q1, q2 = _algo_inputs("adam", 1, 64, 8)
    rc = libs["fused_update"].fused_update_sentinel(
        fu.KERNEL_ALGOS["adam"], *_ptrs(p, grad, cm, am, cr, ar, q1, q2),
        None, None, None, None, 0, 0, 1, 64, *fu._kernel_scalars(_scalars()),
        None)
    assert rc != 0


@pytest.mark.parametrize("bits", [(4, 8), (5, 6), (6, 4)],
                         ids=lambda b: f"{b[0]}-{b[1]}")
@pytest.mark.parametrize("nb,bsz", [(3, 2048), (2, 264)])
def test_norm_partials_packed_emulated(libs, bits, nb, bsz):
    """lamb's norm prologue on packed states, bit for bit against the plain
    version."""
    p, grad, cm, am, cr, ar, q1, q2 = _packed_inputs("lamb", nb, bsz, *bits,
                                                     7)
    s = _scalars(step=3.0)
    want = fu.norm_partials_plain(p, grad, cm, am, cr, ar, q1, q2, s,
                                  algo="lamb", bits_m=bits[0],
                                  bits_r=bits[1])
    out = torch.full((nb, fu.N_PARTIALS), float("nan"))
    rc = libs["norm_partials"].norm_partials_packed(
        *_ptrs(p, grad, cm, am, cr, ar, q1, q2, out), nb, bsz, *bits,
        *fu._kernel_scalars(s), None)
    assert rc == 0
    assert torch.equal(out, want)
    assert bool((want[:, 2] > 0).all())


@pytest.mark.parametrize("nb,bsz", [(5, 2048), (3, 264), (1, 64)])
@pytest.mark.parametrize("bits", [4, 5, 6, 8])
@pytest.mark.parametrize("seed", [None, -3])
def test_quantize_bits_emulated(libs, bits, seed, nb, bsz):
    """B1 at every width, deterministic and stochastic (seed), and B2 on
    its output, bit for bit against the plain versions."""
    q = torch.as_tensor(qmap.get_qmap("dynamic", True, bits=bits))
    x = _x(nb, bsz, 3)
    from repro_torch.core.lowbit import packed_width
    codes = torch.empty(nb, packed_width(bsz, bits), dtype=torch.uint8)
    absmax = torch.empty(nb)
    rc = libs["blockwise_quant"].blockwise_quantize(
        *_ptrs(x, q, codes, absmax), nb, bsz, bits, int(seed is not None),
        seed or 0, None)
    want_c, want_a = bq.quantize_plain(x, q, bits=bits, seed=seed)
    assert rc == 0
    assert torch.equal(codes, want_c) and torch.equal(absmax, want_a)
    if seed is not None and nb > 1:   # (one block of 1 is all zeros)
        det, _ = bq.quantize_plain(x, q, bits=bits)
        assert not torch.equal(det, want_c)
    for dtype in (torch.float32, torch.bfloat16):
        out = torch.empty(nb, bsz, dtype=dtype)
        rc = libs["blockwise_dequant"].blockwise_dequantize(
            *_ptrs(codes, absmax, q, out), int(dtype == torch.bfloat16), nb,
            bsz, bits, None)
        assert rc == 0
        assert torch.equal(out, bdq.dequantize_plain(codes, absmax, q, dtype,
                                                     bits=bits))


# ----------------------------------------------- Newton–Schulz (B5, B6)
# (16, 1024): the stacked norm vectors' padded shape, 32-row tiles whose
# warps past row (and, in the gram, column) 16 skip their products, the
# gram in 4 chunks; (200, 2816): 11 column tiles and a partial 128-row
# tile, the contraction of the apply (200) ends in a partial stage
NS_SHAPES = [(8, 256), (48, 256), (136, 512), (64, 64), (32, 256), (16, 1024),
             (200, 2816)]
NS_SMS = 132                              # an H100's SMs


def _ns_x(m, n, seed):
    return torch.randn(m, n, generator=torch.Generator().manual_seed(seed)) \
        / n ** 0.5


def _ns_gram(libs, x, splits):
    m, n = x.shape
    a = torch.full((m, m), float("nan"))
    work = torch.full((splits, m, m), float("nan"))
    rc = libs["newton_schulz"].ns_gram(*_ptrs(x, work, a), m, n, splits,
                                       None)
    assert rc == 0
    return a


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("m,n", NS_SHAPES)
def test_ns_gram_emulated(libs, m, n):
    """B5 against the tile-replaying plain version, at the chunk count the
    wrapper picks for an H100.  The kernel takes 3xTF32 products and sums
    32-column stages, then the stages with f32 adds, then the chunks; the
    plain version sums per 256-column tile, then the tiles.  The bound of
    ``csrc/newton_schulz.cu`` (~2e-6 of the largest entry expected) is
    held at 1e-5 of the output's largest magnitude.  The entries must also
    come out exactly symmetric and the same on a second run."""
    from repro_torch.kernels import newton_schulz as ns
    x = _ns_x(m, n, m)
    splits = libs["newton_schulz"].ns_gram_splits(m, n, NS_SMS)
    outs = [_ns_gram(libs, x, splits) for _ in range(2)]
    want = ns.gram_plain(x)
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], outs[0].T)
    err = _rel_err(outs[0], want)
    assert err < 1e-5, err


@pytest.mark.parametrize("splits", [3, 4])
def test_ns_gram_emulated_uneven_chunks(libs, splits):
    """The 11 column tiles of (200, 2816) in 3 or 4 chunks of unequal
    length (3/4/4 and 2/3/3/3 tiles): the same tolerance and exact
    symmetry, whatever the split."""
    from repro_torch.kernels import newton_schulz as ns
    x = _ns_x(200, 2816, 200)
    a = _ns_gram(libs, x, splits)
    assert torch.equal(a, a.T)
    err = _rel_err(a, ns.gram_plain(x))
    assert err < 1e-5, err


@pytest.mark.parametrize("m,n", NS_SHAPES)
def test_ns_apply_emulated(libs, m, n):
    """B6 against the plain version (a X + B X per column tile), with the
    quintic's a and a B of the iteration's own scale: each entry sums m
    3xTF32 products in another order (tolerance 1e-5 of the largest
    magnitude, as for the gram), bits identical run to run."""
    from repro_torch.kernels import newton_schulz as ns
    a_, b_, c_ = ns.NS_COEFFS
    x = _ns_x(m, n, m + 1)
    x = x / x.norm()
    g = ns.gram_plain(x)
    b_mat = (b_ * g + c_ * (g @ g)).contiguous()
    outs = []
    for _ in range(2):
        out = torch.full((m, n), float("nan"))
        rc = libs["newton_schulz"].ns_apply(*_ptrs(x, b_mat, out), a_, m, n,
                                            None)
        assert rc == 0
        outs.append(out)
    want = ns.apply_plain(x, b_mat, a_)
    assert torch.equal(outs[0], outs[1])
    err = _rel_err(outs[0], want)
    assert err < 1e-5, err


def test_ns_kernels_reject_bad_shapes(libs):
    x = torch.zeros(8, 256)
    a = torch.zeros(8, 8)
    work = torch.zeros(2, 8, 8)
    gram = libs["newton_schulz"].ns_gram
    assert gram(*_ptrs(x, work, a), 8, 100, 1, None) != 0   # n % 64
    assert gram(*_ptrs(x, work, a), 8, 256, 0, None) != 0   # no chunk
    assert gram(*_ptrs(x, work, a), 8, 256, 2, None) != 0   # > column tiles
    assert libs["newton_schulz"].ns_apply(*_ptrs(x, a, x), 1.0, 8, 128,
                                          None) != 0    # out aliases x


def test_gram_splits_fill_whole_waves(libs):
    """The chunk count the wrapper takes from the kernel's library: whole
    waves of 132 CTAs at the head's shape, one chunk per column tile when
    that fits in one wave (also for the 32-row tile of m <= 32), 0 for a
    shape the kernels refuse."""
    from repro_torch.kernels import newton_schulz as ns
    gram_splits = libs["newton_schulz"].ns_gram_splits
    assert gram_splits(1024, 50432, 132) == 11        # 396 = 3 x 132
    assert gram_splits(16, 1024, 132) == 4
    assert gram_splits(200, 2816, 132) == 11
    assert gram_splits(64, 64, 132) == 1
    assert gram_splits(8, 100, 132) == 0
    for m, n in [(1024, 50432), (512, 4096), (1320, 8192)]:
        s = gram_splits(m, n, 132)
        assert 1 <= s <= -(-n // ns.TILE_N)


# (n_pages, page, KV, Dh, B, P): Dh 64 takes the 16-byte path (W = 64 or
# 32 bytes), Dh 8 and 12 the byte path (W = 8/4 and 12/6 bytes)
GATHER_SHAPES = [(6, 4, 2, 64, 2, 3), (5, 2, 3, 8, 3, 4), (4, 3, 1, 12, 2, 2)]


@pytest.mark.parametrize("shape", GATHER_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
def test_paged_gather_emulated(libs, bits, dtype, shape):
    """B7 bit for bit against its plain version: a scrambled table with
    -1 entries (read as page 0) and an all-zero row."""
    n_pages, page, KV, Dh, B, P_ = shape
    g = torch.Generator().manual_seed(11)
    rows = torch.randn(n_pages, page, KV, Dh, generator=g) * torch.exp(
        torch.randn(n_pages, page, KV, 1, generator=g) * 2)
    rows[1, 0, 0] = 0.0
    codes, absmax = paged_kv.quantize_rows(rows, bits)
    perm = torch.randperm(n_pages, generator=g)
    table = perm[torch.arange(B * P_) % n_pages].reshape(B, P_).int()
    table[0, -1] = -1
    table[-1, 0] = -1
    out = torch.full((B, P_ * page, KV, Dh), float("nan"), dtype=dtype)
    rc = libs["paged_gather"].paged_gather(
        *_ptrs(codes, absmax, table, paged_kv.kv_qmap(bits), out),
        int(dtype == torch.bfloat16), n_pages, page * KV, codes.shape[-1],
        bits, B, P_, None)
    assert rc == 0
    want = paged_kv._gather_torch(codes, absmax, table, bits=bits,
                                  dtype=dtype)
    assert torch.equal(out, want)


def test_paged_gather_rejects_bad_bits(libs):
    z = torch.zeros(1, dtype=torch.uint8)
    rc = libs["paged_gather"].paged_gather(*_ptrs(z, z, z, z, z), 0, 1, 1, 1,
                                           5, 1, 1, None)
    assert rc != 0
