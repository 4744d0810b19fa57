// In-kernel helpers shared by the block-wise kernels.
//
// Replaces the helpers that src/repro/kernels/common.py inlines into the
// Pallas kernels (encode, decode, block_requantize).  On the TPU the
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

namespace rq {

constexpr int kCodebookSize = 256;
constexpr int kThreads = 256;  // threads per CTA; one CTA per block

// NaN-propagating max, like jnp.max / torch.amax.
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Copy a 256-entry codebook into shared memory and build its 255 midpoints
// (cb[i+1] + cb[i]) * 0.5 — the values kernels/common.py::padded_bounds
// computes.  Ends with a barrier.
__device__ __forceinline__ void load_codebook(const float* qmap, float* lut,
                                              float* bounds) {
  for (int i = threadIdx.x; i < kCodebookSize; i += blockDim.x) lut[i] = qmap[i];
  __syncthreads();
  for (int i = threadIdx.x; i < kCodebookSize - 1; i += blockDim.x)
    bounds[i] = __fmul_rn(__fadd_rn(lut[i + 1], lut[i]), 0.5f);
  __syncthreads();
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

__device__ __forceinline__ float absmax4(float m, float4 v) {
  m = nanmax(m, fabsf(v.x));
  m = nanmax(m, fabsf(v.y));
  m = nanmax(m, fabsf(v.z));
  return nanmax(m, fabsf(v.w));
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
