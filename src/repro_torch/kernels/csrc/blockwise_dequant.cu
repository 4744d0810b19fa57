// Block-wise dequantization: codebook[code] * absmax, written as f32 or bf16.
//
// Replaces the TPU kernel
// src/repro/kernels/blockwise_dequant.py::_dequant_kernel (pallas_call in
// dequantize_blockwise), whose lookup is a one-hot matmul on the MXU, and
// the dequantize step of the Muon leaf update
// (src/repro/kernels/ops.py::_muon_entry, done at the XLA level there):
// codes of `bits` in {4, 5, 6, 8} bits, bit-packed below 8
// (core/lowbit/packing.py).
//
// Bound on an H100: memory.  It reads bits/8 bytes per element (plus 4
// bytes of absmax per block) and writes 4 (f32) or 2 (bf16): 5 or 3
// B/element at 8 bits over 3.35 TB/s.
//
// Design: one 256-thread CTA per block, the codebook in shared memory, four
// values stored per thread step (neighbouring threads on neighbouring
// words).  8-bit codes are loaded four at a time; a packed row is first
// staged in shared memory (coalesced byte loads) and each thread unpacks
// its own four codes from there (rq::unpack_code).
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

template <typename OutT, bool PACKED>
__global__ void __launch_bounds__(rq::kThreads)
dequantize_kernel(const uint8_t* codes, const float* absmax, const float* qmap,
                  OutT* out, int block_size, int bits) {
  __shared__ float lut[rq::kCodebookSize];
  __shared__ uint8_t staged[PACKED ? rq::kMaxStagedRow : 1];
  const size_t row = blockIdx.x;
  const int w = block_size * bits / 8;
  if (PACKED)
    for (int k = threadIdx.x; k <= w; k += blockDim.x)
      staged[k] = k < w ? codes[row * w + k] : 0;
  rq::load_lut(qmap, lut, 1 << bits);
  __syncthreads();

  const float a = absmax[row];
  const uchar4* cr = reinterpret_cast<const uchar4*>(codes + row * block_size);
  OutT* orow = out + row * block_size;
  for (int i = threadIdx.x; i < (block_size >> 2); i += blockDim.x) {
    uint32_t c[4];
    if (PACKED) {
#pragma unroll
      for (int e = 0; e < 4; ++e) c[e] = rq::unpack_code(staged, 4 * i + e, bits);
    } else {
      const uchar4 c4 = cr[i];
      c[0] = c4.x; c[1] = c4.y; c[2] = c4.z; c[3] = c4.w;
    }
    float4 v;
    v.x = __fmul_rn(rq::decode(c[0], lut), a);
    v.y = __fmul_rn(rq::decode(c[1], lut), a);
    v.z = __fmul_rn(rq::decode(c[2], lut), a);
    v.w = __fmul_rn(rq::decode(c[3], lut), a);
    store4(orow + 4 * i, v);
  }
}

template <bool PACKED>
int launch(const uint8_t* codes, const float* absmax, const float* qmap,
           void* out, int out_bf16, int n_blocks, int block_size, int bits,
           cudaStream_t stream) {
  const dim3 grid(n_blocks), block(rq::kThreads);
  if (out_bf16)
    dequantize_kernel<__nv_bfloat16, PACKED><<<grid, block, 0, stream>>>(
        codes, absmax, qmap, static_cast<__nv_bfloat16*>(out), block_size,
        bits);
  else
    dequantize_kernel<float, PACKED><<<grid, block, 0, stream>>>(
        codes, absmax, qmap, static_cast<float*>(out), block_size, bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// codes: (n_blocks, block_size * bits / 8) uint8; qmap: 2^bits entries.
extern "C" int blockwise_dequantize(const uint8_t* codes, const float* absmax,
                                    const float* qmap, void* out, int out_bf16,
                                    int n_blocks, int block_size, int bits,
                                    cudaStream_t stream) {
  if (n_blocks == 0) return 0;
  if (bits == 8)
    return launch<false>(codes, absmax, qmap, out, out_bf16, n_blocks,
                         block_size, bits, stream);
  if ((bits != 4 && bits != 5 && bits != 6) || block_size % 8 ||
      block_size > rq::kMaxBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(codes, absmax, qmap, out, out_bf16, n_blocks,
                      block_size, bits, stream);
}
