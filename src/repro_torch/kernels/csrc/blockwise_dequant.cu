// Block-wise dequantization: codebook[code] * absmax, written as f32 or bf16.
//
// Replaces the TPU kernel
// src/repro/kernels/blockwise_dequant.py::_dequant_kernel (pallas_call in
// dequantize_blockwise), whose lookup is a one-hot matmul on the MXU.
//
// Bound on an H100: memory.  It reads 1 byte per element (plus 4 bytes of
// absmax per block) and writes 4 (f32) or 2 (bf16): 5 or 3 B/element over
// 3.35 TB/s.
//
// Design: one 256-thread CTA per block, the 256-entry codebook in shared
// memory, four codes loaded and four values stored per thread step
// (neighbouring threads on neighbouring words).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ void store4(float* out, float4 v) {
  *reinterpret_cast<float4*>(out) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out) = packed;
}

template <typename OutT>
__global__ void __launch_bounds__(rq::kThreads)
dequantize_kernel(const uint8_t* codes, const float* absmax, const float* qmap,
                  OutT* out, int block_size) {
  __shared__ float lut[rq::kCodebookSize];
  for (int i = threadIdx.x; i < rq::kCodebookSize; i += blockDim.x) lut[i] = qmap[i];
  __syncthreads();

  const size_t row = blockIdx.x;
  const float a = absmax[row];
  const uchar4* cr = reinterpret_cast<const uchar4*>(codes + row * block_size);
  OutT* orow = out + row * block_size;
  for (int i = threadIdx.x; i < (block_size >> 2); i += blockDim.x) {
    const uchar4 c = cr[i];
    float4 v;
    v.x = __fmul_rn(rq::decode(c.x, lut), a);
    v.y = __fmul_rn(rq::decode(c.y, lut), a);
    v.z = __fmul_rn(rq::decode(c.z, lut), a);
    v.w = __fmul_rn(rq::decode(c.w, lut), a);
    store4(orow + 4 * i, v);
  }
}

}  // namespace

extern "C" int blockwise_dequantize(const uint8_t* codes, const float* absmax,
                                    const float* qmap, void* out, int out_bf16,
                                    int n_blocks, int block_size,
                                    cudaStream_t stream) {
  if (n_blocks == 0) return 0;
  const dim3 grid(n_blocks), block(rq::kThreads);
  if (out_bf16)
    dequantize_kernel<__nv_bfloat16><<<grid, block, 0, stream>>>(
        codes, absmax, qmap, static_cast<__nv_bfloat16*>(out), block_size);
  else
    dequantize_kernel<float><<<grid, block, 0, stream>>>(
        codes, absmax, qmap, static_cast<float*>(out), block_size);
  return static_cast<int>(cudaGetLastError());
}
