// In-kernel helpers shared by the block-wise kernels.
//
// Replaces the helpers that src/repro/kernels/common.py inlines into the
// Pallas kernels (encode, decode, hash_uniform, element_indices,
// stochastic_codes, block_requantize).  On the TPU the
// codebook lookup is a one-hot matmul and encode a compare-count over all
// 255 midpoints; here, as in the paper's own CUDA kernels, the codebook is a
// 256-entry lookup table in shared memory and encode is a branch-free
// search down the midpoints in Eytzinger order (bits shared-memory reads
// per element), which equals searchsorted(side="right") and the
// compare-count.
//
// Every float operation is written with an explicitly rounded intrinsic
// (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn), so no FMA contraction and
// no approximate division can creep in: the kernels round exactly like the
// plain PyTorch versions they are held against.
#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

// A dynamic shared-memory array of the launch's third <<<>>> argument.
#ifndef RQ_DYNAMIC_SHARED
#define RQ_DYNAMIC_SHARED(T, name) extern __shared__ __align__(16) T name[]
#endif

// The element type of the parameter p in a library of the fused update or
// its norm prologue: f32, or bf16 in the library compiled with RQ_P_BF16
// (kernels/build.py LIBRARIES).  Gradients are f32 in both.
#ifdef RQ_P_BF16
using PElem = __nv_bfloat16;
#else
using PElem = float;
#endif

namespace rq {

constexpr int kCodebookSize = 256;
constexpr int kThreads = 256;  // threads per CTA; one CTA per block
constexpr int kMaxBlock = 8192;  // largest block (kernels/common.py)
// Bytes of a staged packed row: the widest (8-bit) row plus the one byte
// unpack_code may read past its end, rounded to 16.
constexpr int kMaxStagedRow = kMaxBlock + 16;

// NaN-propagating max, like jnp.max / torch.amax (on the card one
// max.NaN instruction, whose NaN is the canonical one; the payload of a
// NaN absmax is not part of any result the kernels are held to).
__device__ __forceinline__ float nanmax(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a > b || a != a) ? a : b;
#endif
}

// Copy a codebook of n_levels = 2^bits <= 256 entries into a 256-entry
// shared-memory table (entries past n_levels are 0 and never read: codes
// stay below n_levels).  No barrier.
__device__ __forceinline__ void load_lut(const float* qmap, float* lut,
                                         int n_levels = kCodebookSize) {
  for (int i = threadIdx.x; i < kCodebookSize; i += blockDim.x)
    lut[i] = i < n_levels ? qmap[i] : 0.f;
}

// Copy a codebook of n_levels = 2^bits entries into shared memory (lut, as
// load_lut) and build its n_levels - 1 midpoints (cb[i+1] + cb[i]) * 0.5 in
// Eytzinger order for encode_tree: tree[k], k = 1 .. n_levels - 1, is the
// node k of a complete binary search tree over the sorted midpoints (its
// children 2k and 2k + 1; node k at level d = floor(log2 k), j = k - 2^d,
// holds midpoint (2j + 1) 2^(bits - 1 - d) - 1).  Ends with a barrier.
__device__ __forceinline__ void load_codebook_tree(const float* qmap,
                                                   float* lut, float* tree,
                                                   int bits) {
  const int n_levels = 1 << bits;
  load_lut(qmap, lut, n_levels);
  __syncthreads();
  for (int k = threadIdx.x + 1; k < n_levels; k += blockDim.x) {
    int d = 0;
    while ((2 << d) <= k) ++d;
    const int i = ((2 * (k - (1 << d)) + 1) << (bits - 1 - d)) - 1;
    tree[k] = __fmul_rn(__fadd_rn(lut[i + 1], lut[i]), 0.5f);
  }
  __syncthreads();
}

// ---- bit-packed codes (core/lowbit/packing.py): a row of b-bit codes is
// an MSB-first big-endian bitstream, code j at stream bits [j*b, j*b + b),
// byte k holding stream bits [8k, 8k + 8) with bit 8k at its bit 7.  5- and
// 6-bit codes straddle bytes.  b = 8 is the plain byte layout.

// Code j of a packed row staged in shared memory, which must hold one
// readable byte past the row's end (a code spans at most two bytes).
__device__ __forceinline__ uint32_t unpack_code(const uint8_t* row,
                                                uint32_t j, int bits) {
  const uint32_t bit = j * static_cast<uint32_t>(bits);
  const uint32_t w = (static_cast<uint32_t>(row[bit >> 3]) << 8) |
                     static_cast<uint32_t>(row[(bit >> 3) + 1]);
  return (w >> (16u - (bit & 7u) - static_cast<uint32_t>(bits))) &
         ((1u << bits) - 1u);
}

// The b bytes of 8 consecutive b-bit codes of a packed row, as one
// big-endian integer: code c of the 8 is bits [b (7 - c), b (8 - c)).
__device__ __forceinline__ uint64_t load_group(const uint8_t* src, int bits) {
  uint64_t v = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < bits) v = (v << 8) | src[i];
  return v;
}

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return (x >> 24) | ((x >> 8) & 0xFF00u) | ((x << 8) & 0xFF0000u) |
         (x << 24);
}

// Store the b bytes of a group (load_group's layout) at dst, in the widest
// words its alignment allows: dst is 4-byte aligned at b = 4, 8-byte at
// b = 8 and 2-byte at b = 6 (a packed row of B = 8k elements is k b bytes,
// and a group starts b bytes after the previous one).
__device__ __forceinline__ void store_group(uint8_t* dst, uint64_t v,
                                            int bits) {
  if (bits == 4) {
    *reinterpret_cast<uint32_t*>(dst) = bswap32(static_cast<uint32_t>(v));
  } else if (bits == 8) {
    uint2 w;
    w.x = bswap32(static_cast<uint32_t>(v >> 32));
    w.y = bswap32(static_cast<uint32_t>(v));
    *reinterpret_cast<uint2*>(dst) = w;
  } else if (bits == 6) {
    uint16_t* d = reinterpret_cast<uint16_t*>(dst);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const uint32_t w = static_cast<uint32_t>(v >> (32 - 16 * i)) & 0xFFFFu;
      d[i] = static_cast<uint16_t>((w >> 8) | ((w & 0xFFu) << 8));
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < bits)
        dst[i] = static_cast<uint8_t>(v >> (8 * (bits - 1 - i)));
  }
}

// ---- 8-bit codes of a thread's group of 8 elements (the walking kernels):
// two little-endian words, code c at byte c (w.x codes 0-3, w.y 4-7).  A
// group starts 8 bytes after the previous one, so its word is 8-byte
// aligned when the block size is a multiple of 8 (wide); at a block size of
// 8k + 4 every other row starts off an 8-byte boundary, the word is read
// and written as two 4-byte halves, and the row's last group is a half
// group of 4 codes (half: w.y is neither read nor written).
__device__ __forceinline__ uint2 load_codes8(const uint8_t* src, bool wide,
                                             bool half) {
  if (wide) return *reinterpret_cast<const uint2*>(src);
  uint2 w;
  w.x = *reinterpret_cast<const uint32_t*>(src);
  w.y = half ? 0u : *reinterpret_cast<const uint32_t*>(src + 4);
  return w;
}

__device__ __forceinline__ void store_codes8(uint8_t* dst, uint2 w,
                                             bool wide, bool half) {
  if (wide) {
    *reinterpret_cast<uint2*>(dst) = w;
    return;
  }
  *reinterpret_cast<uint32_t*>(dst) = w.x;
  if (!half) *reinterpret_cast<uint32_t*>(dst + 4) = w.y;
}

// The codebook value of code c of a group's word: the code's byte,
// shifted straight to its byte offset in the 256-entry table.
__device__ __forceinline__ float decode8(uint2 w, int c, const float* lut) {
  const uint32_t word = c < 4 ? w.x : w.y;
  const int sh = 8 * (c & 3);
  const uint32_t off = (sh ? word >> (sh - 2) : word << 2) & 0x3FCu;
  return *reinterpret_cast<const float*>(reinterpret_cast<const char*>(lut) +
                                         off);
}

__device__ __forceinline__ int popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// Bytes of w that are 0x00 or 0xFF (8-bit codes at a codebook edge): a
// byte is one of them iff its 8 bits are all equal, iff its 7 pairs of
// neighbouring bits XOR to 0.
__device__ __forceinline__ int edge_bytes(uint32_t w) {
  const uint32_t x = (w ^ (w >> 1)) & 0x7F7F7F7Fu;
  return 4 - popc((x + 0x7F7F7F7Fu) & 0x80808080u);
}

// Bytes a packed row of w bytes takes in a staging buffer: it is copied
// from the 16-byte boundary at or below its start, so it begins up to 15
// bytes in, and one readable byte follows it (unpack_code).
__host__ __device__ __forceinline__ int staged_row_bytes(int w) {
  return (w + 15) / 16 * 16 + 16;
}

// Issue this thread's share of the copies of the packed row of w bytes at
// byte `start` of `codes` (total bytes) into dst (16-byte aligned): 16-byte
// cp.async pieces from the 16-byte boundary at or below start; a piece
// that would read past `total` is read byte by byte (zeros past it).  The
// row begins at dst + (start & 15).  No commit.
__device__ __forceinline__ void stage_packed_row(uint8_t* dst,
                                                 const uint8_t* codes,
                                                 size_t start, int w,
                                                 size_t total) {
  const size_t base = start & ~static_cast<size_t>(15);
  const int pieces = static_cast<int>((start + w - base + 15) / 16);
  for (int c = threadIdx.x; c < pieces; c += blockDim.x) {
    const size_t off = base + 16 * static_cast<size_t>(c);
    if (off + 16 <= total) {
      cp_async_16(dst + 16 * c, codes + off, true);
    } else {
      for (int i = 0; i < 16; ++i)
        dst[16 * c + i] = off + i < total ? codes[off + i] : 0;
    }
  }
}

// Number of the 2^BITS - 1 midpoints <= x, by BITS steps down the
// Eytzinger tree of load_codebook_tree: searchsorted(side="right") over the
// midpoints padded with +inf (kernels/common.py::padded_bounds), capped at
// 2^BITS - 1 (NaN: 0; +inf: 2^BITS - 1, the code the JAX package's oracle
// gives x / scale = +inf, which a block with a NaN and an inf reaches:
// absmax NaN, scale 1).  A warp's lanes read the first five levels from neighbouring
// words, so those reads do not conflict in shared-memory banks.
template <int BITS>
__device__ __forceinline__ uint32_t encode_tree(float x, const float* tree) {
  // the node k as its byte offset 4k: each step is one shared load at
  // tree + 4k, a compare and a shift-add
  const char* base = reinterpret_cast<const char*>(tree);
  uint32_t off = 4;
#pragma unroll
  for (int d = 0; d < BITS; ++d)
    off = 2 * off +
          (*reinterpret_cast<const float*>(base + off) <= x ? 4u : 0u);
  return (off >> 2) - (1u << BITS);
}

__device__ __forceinline__ float decode(uint32_t code, const float* lut) {
  return lut[code];
}

// Max over the CTA of two values at once (warp shuffles, then one shared
// slot per warp).  red holds 66 floats.  Contains barriers: every thread of
// the CTA must call it.
__device__ __forceinline__ float2 block_max2(float a, float b, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = nanmax(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = nanmax(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    a = lane < nwarps ? red[lane] : 0.f;
    b = lane < nwarps ? red[32 + lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a = nanmax(a, __shfl_xor_sync(0xffffffffu, a, o));
      b = nanmax(b, __shfl_xor_sync(0xffffffffu, b, o));
    }
    if (lane == 0) {
      red[64] = a;
      red[65] = b;
    }
  }
  __syncthreads();
  return make_float2(red[64], red[65]);
}

// fma and reciprocal, rounded to nearest (under the host emulation of the
// CPU tests: std::fmaf and 1 / c, which round the same).
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
#ifdef __CUDACC__
  return __fmaf_rn(a, b, c);
#else
  return std::fmaf(a, b, c);
#endif
}

__device__ __forceinline__ float rcp_rn(float c) {
#ifdef __CUDACC__
  return __frcp_rn(c);
#else
  volatile float r = 1.f / c;
  return r;
#endif
}

// Division by a divisor c fixed before the loop (a block's scale), without
// __fdiv_rn's reciprocal, operand check and slow-path branch per element.
// hi = RN(1/c) and lo = RN(RN(1 - c hi) hi) carry 1/c to a relative
// 2^-47, so q0 = RN(x hi + RN(x lo)) (Brisebarre-Muller-Raina's
// one-multiply-one-fma quotient) is within 0.5 + 2^-22 ulp of x / c; the
// remainder x - c q0 is then exact (fma), and by Markstein's theorem (y
// within half an ulp of 1/c, q within one ulp of x / c: RN(q + (x - c q) y)
// is the correctly rounded x / c) one more fma gives RN(x / c), the bits of
// __fdiv_rn, for every divisor.  The theorem needs every intermediate
// normal: the shortcut takes c in [2^-60, 2^60] and |x| in [c 2^-40,
// c 2^40] (x and the quotient normal, x lo and the remainder above 2^-149
// apart from 0); x_min / x_max give that range (empty for another c), and
// a caller takes it for a whole group of values or not at all.
// chip_smoke.py checks it against __fdiv_rn for every f32 x at dozens of
// divisors (fused_update_div_check).
struct DivBy {
  float c, hi, lo;
  float x_min, x_max;
};

__device__ __forceinline__ DivBy div_by(float c) {
  DivBy d;
  d.c = c;
  d.hi = rcp_rn(c);
  d.lo = __fmul_rn(fma_rn(-c, d.hi, 1.f), d.hi);
  const bool ok = c >= 0x1p-60f && c <= 0x1p60f;   // false for NaN
  d.x_min = ok ? __fmul_rn(c, 0x1p-40f) : INFINITY;
  d.x_max = ok ? __fmul_rn(c, 0x1p40f) : 0.f;
  return d;
}

// RN(x / d.c) for |x| in [d.x_min, d.x_max].
__device__ __forceinline__ float div_fast(float x, const DivBy& d) {
  const float q0 = fma_rn(x, d.hi, __fmul_rn(x, d.lo));
  return fma_rn(fma_rn(-d.c, q0, x), d.hi, q0);
}

// xn[c] = RN(x[c] / d.c) for a group of 8 whose |x| lie in [lo, hi] (hi
// NaN if one is NaN; elements a caller discards may lie outside): div_fast
// when [lo, hi] lies in its range (one branch for the group), else
// __fdiv_rn.
__device__ __forceinline__ void div8(const float (&x)[8], const DivBy& d,
                                     float lo, float hi, float (&xn)[8]) {
  if (lo >= d.x_min && hi <= d.x_max) {
#pragma unroll
    for (int c = 0; c < 8; ++c) xn[c] = div_fast(x[c], d);
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) xn[c] = __fdiv_rn(x[c], d.c);
  }
}

// Scale of a block: its absmax, or 1 for an all-zero block (and, as in the
// JAX package, for a NaN absmax, since NaN > 0 is false).
__device__ __forceinline__ float block_scale(float absmax) {
  return absmax > 0.f ? absmax : 1.f;
}

// ---- stochastic rounding (kernels/common.py: hash_uniform,
// element_indices, stochastic_codes).  Exact integer arithmetic on uint32
// with wrap-around, as the JAX package's jnp.uint32 ops.
constexpr uint32_t kState1Salt = 0u;
constexpr uint32_t kState2Salt = 0x9E3779B9u;

// Uniform [0, 1) from element index + seed: a finalizer hash, then the top
// 24 bits times 2^-24 (exact in f32).
__device__ __forceinline__ float hash_uniform(uint32_t idx, uint32_t seed) {
  uint32_t x = idx + seed * 2654435761u;
  x ^= x >> 16;
  x *= 0x21F0AAADu;
  x ^= x >> 15;
  x *= 0x735A2D97u;
  x ^= x >> 15;
  return __fmul_rn(static_cast<float>(x >> 8), 1.0f / 16777216.0f);
}

// The stochastic choice of a requantized value xn = x / scale (the JAX
// package's requant_code): code, the nearest code of xn, moved to the
// neighbour on the far side of xn with probability |xn - q_near| /
// |q_other - q_near| (never past max_code).
__device__ __forceinline__ uint32_t stochastic_code(float xn, uint32_t code,
                                                    const float* lut, float u,
                                                    uint32_t max_code) {
  const float q_near = lut[code];
  int other = static_cast<int>(code) + (xn > q_near ? 1 : -1);
  other = other < 0 ? 0 : (other > static_cast<int>(max_code)
                               ? static_cast<int>(max_code) : other);
  const float span = fabsf(__fsub_rn(lut[other], q_near));
  const float p_other =
      span > 0.f ? __fdiv_rn(fabsf(__fsub_rn(xn, q_near)), span) : 0.f;
  return u < p_other ? static_cast<uint32_t>(other) : code;
}

// |x| <= FLT_MAX: false for NaN and +-inf (no isfinite needed).
__device__ __forceinline__ bool is_finite(float x) {
  return fabsf(x) <= 3.40282347e38f;
}

// Sum over the CTA of two words of integer counts at once: each warp adds
// by the xor-shuffle tree, lane 0 stores the warp's sums in shared memory,
// and warp 0 adds the warp sums by the same tree.  Integer adds, so the
// totals are exact in any order; a word may pack two 16-bit counts as long
// as each total stays below 2^16.  Only thread 0 holds the totals on
// return.  red holds 2 x 32 ints.  Contains a barrier: every thread of the
// CTA must call it.
__device__ __forceinline__ void block_sum2(int (&v)[2], int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    v[1] += __shfl_xor_sync(0xffffffffu, v[1], o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[warp] = v[0];
    red[32 + warp] = v[1];
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    v[0] = lane < nwarps ? red[lane] : 0;
    v[1] = lane < nwarps ? red[32 + lane] : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
      v[1] += __shfl_xor_sync(0xffffffffu, v[1], o);
    }
  }
}

// Sum over the CTA of three values at once, in one fixed order: each warp
// adds by the xor-shuffle tree (lane i + lane i^o, o = 16..1), lane 0
// stores the warp's sums in shared memory, and warp 0 adds the warp sums
// (lanes past the last warp hold 0) by the same tree.  red holds 99
// floats.  Contains barriers: every thread of the CTA must call it.  The
// plain version of this order is kernels/fused_update.py::block_sums.
__device__ __forceinline__ float3 block_sum3(float a, float b, float c,
                                             float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, o));
    c = __fadd_rn(c, __shfl_xor_sync(0xffffffffu, c, o));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
    red[64 + warp] = c;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    a = lane < nwarps ? red[lane] : 0.f;
    b = lane < nwarps ? red[32 + lane] : 0.f;
    c = lane < nwarps ? red[64 + lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
      b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, o));
      c = __fadd_rn(c, __shfl_xor_sync(0xffffffffu, c, o));
    }
    if (lane == 0) {
      red[96] = a;
      red[97] = b;
      red[98] = c;
    }
  }
  __syncthreads();
  return make_float3(red[96], red[97], red[98]);
}

// The f32 value of a bf16 given by its 16 bits (exact: a bf16 is the high
// half of an f32).
__device__ __forceinline__ float bf16_value(uint32_t bits) {
#ifdef __CUDACC__
  return __uint_as_float(bits << 16);
#else
  const uint32_t u = bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
#endif
}

// Two f32 values rounded to nearest even to bf16, a in the low half.
__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
          << 16);
}

// Loads and stores of a thread's elements of a row of the parameter (f32
// or bf16) or the gradient (f32), as f32 values, for their element type
// T: the kernels do every operation in f32 and store a bf16 parameter
// rounded to nearest even (as XLA's astype and PyTorch's .to(bfloat16)
// round).  load8 / store8: the 8 consecutive elements 8v .. 8v + 7 of a
// row (the first 4 when half; bf16 rows never end in a half group: their
// block size is a multiple of 8), one or two 16-byte words; load8_pair:
// load8 of p's row (of T) and g's (f32; for f32 p the words interleaved,
// as the 8-bit update's f32 kernel has always loaded them); load4:
// elements 4i .. 4i + 3, one 16- or 8-byte word.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ void load8(const void* row, int v,
                                               bool half, float (&x)[8]) {
    const float4* r = static_cast<const float4*>(row);
    const float4 a = r[2 * v];
    const float4 b = half ? make_float4(0.f, 0.f, 0.f, 0.f) : r[2 * v + 1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
  static __device__ __forceinline__ void store8(void* row, int v, bool half,
                                                const float (&x)[8]) {
    float4* r = static_cast<float4*>(row);
    r[2 * v] = make_float4(x[0], x[1], x[2], x[3]);
    if (!half) r[2 * v + 1] = make_float4(x[4], x[5], x[6], x[7]);
  }
  static __device__ __forceinline__ float4 load4(const void* row, int i) {
    return static_cast<const float4*>(row)[i];
  }
  // load8 of a row of p and of g, their 16-byte words interleaved
  static __device__ __forceinline__ void load8_pair(const void* prow,
                                                    const void* grow, int v,
                                                    bool half, float (&p)[8],
                                                    float (&g)[8]) {
    const float4* pr = static_cast<const float4*>(prow);
    const float4* gr = static_cast<const float4*>(grow);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 p0 = pr[2 * v], g0 = gr[2 * v];
    const float4 p1 = half ? zero : pr[2 * v + 1];
    const float4 g1 = half ? zero : gr[2 * v + 1];
    p[0] = p0.x; p[1] = p0.y; p[2] = p0.z; p[3] = p0.w;
    p[4] = p1.x; p[5] = p1.y; p[6] = p1.z; p[7] = p1.w;
    g[0] = g0.x; g[1] = g0.y; g[2] = g0.z; g[3] = g0.w;
    g[4] = g1.x; g[5] = g1.y; g[6] = g1.z; g[7] = g1.w;
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ void load8(const void* row, int v,
                                               bool, float (&x)[8]) {
    const uint4 w = static_cast<const uint4*>(row)[v];
    const uint32_t h[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      x[2 * c] = bf16_value(h[c] & 0xFFFFu);
      x[2 * c + 1] = bf16_value(h[c] >> 16);
    }
  }
  static __device__ __forceinline__ void store8(void* row, int v, bool,
                                                const float (&x)[8]) {
    uint4 w;
    w.x = bf16_pair(x[0], x[1]);
    w.y = bf16_pair(x[2], x[3]);
    w.z = bf16_pair(x[4], x[5]);
    w.w = bf16_pair(x[6], x[7]);
    static_cast<uint4*>(row)[v] = w;
  }
  static __device__ __forceinline__ float4 load4(const void* row, int i) {
    const uint2 w = static_cast<const uint2*>(row)[i];
    return make_float4(bf16_value(w.x & 0xFFFFu), bf16_value(w.x >> 16),
                       bf16_value(w.y & 0xFFFFu), bf16_value(w.y >> 16));
  }
  static __device__ __forceinline__ void load8_pair(const void* prow,
                                                    const void* grow, int v,
                                                    bool half, float (&p)[8],
                                                    float (&g)[8]) {
    load8(prow, v, half, p);
    Elem<float>::load8(grow, v, half, g);
  }
};

}  // namespace rq

// Waves of resident CTAs in the grid of a kernel whose CTAs walk the
// blocks (fused_update_kernel, fused_update_packed_kernel, quantize_kernel,
// norm_partials_kernel): each CTA
// walks n_blocks / ctas blocks, a few at the main path's shape, and the
// hardware hands CTAs to the SMs that free up.  One wave of CTAs with
// fixed shares of the blocks ran 13% slower on an H100 (B3(d), PERF.md):
// the SMs that finished first sat idle.
constexpr int kWaves = 16;

// The grid of such a kernel: kWaves waves of per_sm CTAs on each of sms
// SMs, at most one CTA per block; 0 for no block or no SM.
static inline int rq_walk_ctas(int n_blocks, int sms, int per_sm) {
  if (n_blocks <= 0 || sms <= 0) return 0;
  const long long ctas = static_cast<long long>(sms) * per_sm * kWaves;
  return ctas < n_blocks ? static_cast<int>(ctas) : n_blocks;
}

// Let a kernel take more than the default 48 KB of shared memory.  The
// default bounds static and dynamic shared memory together, and the
// kernels' static arrays take up to 4.6 KB (analysis/kernel_budget.py), so
// the limit is raised from 40 KB of dynamic shared memory on: at exactly
// 48 KB of it (the bf16 two-state 8-bit update at B = 4096) the launch
// would otherwise be refused.
constexpr int kSmemAttributeFrom = 40 * 1024;
template <class K>
static inline cudaError_t rq_allow_smem(K kernel, int smem) {
  return smem > kSmemAttributeFrom
             ? cudaFuncSetAttribute(kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem)
             : cudaSuccess;
}

#ifdef __CUDACC__
// What the runtime says of one kernel instance, for the static analysis's
// kernel budget (analysis/kernel_budget.py; host code only, so no kernel's
// code changes): out = {resident CTAs per SM at `threads` threads and
// `smem` bytes of dynamic shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers a thread,
// static shared memory, local memory a thread, the largest CTA the
// instance launches}.  Returns the CUDA error.
template <class K>
static inline int rq_occupancy(K kernel, int threads, int smem, int* out) {
  cudaError_t e = rq_allow_smem(kernel, smem);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  int ctas = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads,
                                                      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = ctas;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = attr.maxThreadsPerBlock;
  return 0;
}
#endif

// Threads of the CTA of a kernel in which each thread owns one group of 8
// consecutive elements of a block: the fewest of 256, 512 and 1024 that
// give every group of a block of block_size <= 8192 its own thread.
static inline int rq_walk_threads(int block_size) {
  return block_size <= 2048 ? 256 : (block_size <= 4096 ? 512 : 1024);
}

// Vectors of 4 per thread a kernel holds in registers for a block of
// block_size elements: 1, 2, 4 or 8 (block_size <= 8192).  0 = unsupported.
static inline int rq_vectors_per_thread(int block_size) {
  const int per = (block_size / 4 + rq::kThreads - 1) / rq::kThreads;
  for (int v = 1; v <= 8; v <<= 1)
    if (per <= v) return v;
  return 0;
}

extern "C" const char* rq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
