// In-kernel helpers shared by the block-wise kernels.
//
// Replaces the helpers that src/repro/kernels/common.py inlines into the
// Pallas kernels (encode, decode, hash_uniform, element_indices,
// stochastic_codes, block_requantize).  On the TPU the
// codebook lookup is a one-hot matmul and encode a compare-count over all
// 255 midpoints; here, as in the paper's own CUDA kernels, the codebook is a
// 256-entry lookup table in shared memory and encode is a branch-free binary
// search over the midpoints (8 shared-memory reads per element), which
// equals searchsorted(side="right") and the compare-count.
//
// Every float operation is written with an explicitly rounded intrinsic
// (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn), so no FMA contraction and
// no approximate division can creep in: the kernels round exactly like the
// plain PyTorch versions they are held against.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// A dynamic shared-memory array of the launch's third <<<>>> argument.
#ifndef RQ_DYNAMIC_SHARED
#define RQ_DYNAMIC_SHARED(T, name) extern __shared__ __align__(16) T name[]
#endif

namespace rq {

constexpr int kCodebookSize = 256;
constexpr int kThreads = 256;  // threads per CTA; one CTA per block
constexpr int kMaxBlock = 8192;  // largest block (kernels/common.py)
// Bytes of a staged packed row: the widest (8-bit) row plus the one byte
// unpack_code may read past its end, rounded to 16.
constexpr int kMaxStagedRow = kMaxBlock + 16;

// NaN-propagating max, like jnp.max / torch.amax.
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Copy a codebook of n_levels = 2^bits <= 256 entries into a 256-entry
// shared-memory table (entries past n_levels are 0 and never read: codes
// stay below n_levels).  No barrier.
__device__ __forceinline__ void load_lut(const float* qmap, float* lut,
                                         int n_levels = kCodebookSize) {
  for (int i = threadIdx.x; i < kCodebookSize; i += blockDim.x)
    lut[i] = i < n_levels ? qmap[i] : 0.f;
}

// Copy a codebook of n_levels entries into shared memory and build its
// n_levels - 1 midpoints (cb[i+1] + cb[i]) * 0.5, padded with +inf to 255
// — the values kernels/common.py::padded_bounds computes.  The padding
// caps encode at n_levels - 1 (no value compares >= +inf but +inf, which
// a normalized value never is).  Ends with a barrier.
__device__ __forceinline__ void load_codebook(const float* qmap, float* lut,
                                              float* bounds,
                                              int n_levels = kCodebookSize) {
  load_lut(qmap, lut, n_levels);
  __syncthreads();
  for (int i = threadIdx.x; i < kCodebookSize - 1; i += blockDim.x)
    bounds[i] = i < n_levels - 1
                    ? __fmul_rn(__fadd_rn(lut[i + 1], lut[i]), 0.5f)
                    : INFINITY;
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

// Byte k of the packed row of `codes` (one code per byte): the OR of every
// code that overlaps stream bits [8k, 8k + 8), each shifted so that its
// last bit lands at stream bit (c + 1) * b - 1.
__device__ __forceinline__ uint8_t pack_byte(const uint8_t* codes,
                                             uint32_t k, int bits) {
  const int hi = 8 * static_cast<int>(k) + 8;
  uint32_t acc = 0;
  for (int c = 8 * static_cast<int>(k) / bits; c * bits < hi; ++c) {
    const int shift = hi - (c + 1) * bits;
    const uint32_t code = codes[c];
    acc |= shift >= 0 ? code << shift : code >> -shift;
  }
  return static_cast<uint8_t>(acc & 0xFFu);
}

// Number of midpoints b_j <= x, j < 255: binary lifting over the sorted
// midpoints.  Reads bounds[0..254] only; NaN compares false everywhere and
// gets code 0.
__device__ __forceinline__ uint32_t encode(float x, const float* bounds) {
  uint32_t pos = 0;
#pragma unroll
  for (uint32_t step = 128; step > 0; step >>= 1)
    pos += (bounds[pos + step - 1] <= x) ? step : 0u;
  return pos;
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

// Scale of a block: its absmax, or 1 for an all-zero block (and, as in the
// JAX package, for a NaN absmax, since NaN > 0 is false).
__device__ __forceinline__ float block_scale(float absmax) {
  return absmax > 0.f ? absmax : 1.f;
}

// Encode four values normalized by a true division x / scale (not a
// multiply by 1/scale, which rounds differently).
__device__ __forceinline__ uchar4 encode4(float4 v, float scale,
                                          const float* bounds) {
  uchar4 c;
  c.x = static_cast<unsigned char>(encode(__fdiv_rn(v.x, scale), bounds));
  c.y = static_cast<unsigned char>(encode(__fdiv_rn(v.y, scale), bounds));
  c.z = static_cast<unsigned char>(encode(__fdiv_rn(v.z, scale), bounds));
  c.w = static_cast<unsigned char>(encode(__fdiv_rn(v.w, scale), bounds));
  return c;
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

// The code of one value of a block being requantized: nearest code of
// x / scale; with a uniform u, moved to the neighbour on the far side of
// x / scale with probability |x - q_near| / |q_other - q_near| (never past
// max_code).  NaN gets code 0 and stays there.
__device__ __forceinline__ uint32_t requant_code(float x, float scale,
                                                 const float* lut,
                                                 const float* bounds,
                                                 bool stochastic, float u,
                                                 uint32_t max_code) {
  const float xn = __fdiv_rn(x, scale);
  const uint32_t code = encode(xn, bounds);
  if (!stochastic) return code;
  const float q_near = lut[code];
  int other = static_cast<int>(code) + (xn > q_near ? 1 : -1);
  other = other < 0 ? 0 : (other > static_cast<int>(max_code)
                               ? static_cast<int>(max_code) : other);
  const float span = fabsf(__fsub_rn(lut[other], q_near));
  const float p_other =
      span > 0.f ? __fdiv_rn(fabsf(__fsub_rn(xn, q_near)), span) : 0.f;
  return u < p_other ? static_cast<uint32_t>(other) : code;
}

__device__ __forceinline__ float absmax4(float m, float4 v) {
  m = nanmax(m, fabsf(v.x));
  m = nanmax(m, fabsf(v.y));
  m = nanmax(m, fabsf(v.z));
  return nanmax(m, fabsf(v.w));
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

}  // namespace rq

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
