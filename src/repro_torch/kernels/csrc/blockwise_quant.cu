// Block-wise 8-bit quantization: (n_blocks, B) f32 -> codes u8, absmax f32.
//
// Replaces the TPU kernel src/repro/kernels/blockwise_quant.py::_quant_kernel
// (pallas_call in quantize_blockwise).
//
// Bound on an H100: memory.  It reads 4 bytes and writes 1 byte per element
// (plus 4 bytes of absmax per block): 5 B/element over 3.35 TB/s.  The work
// per element (one division, an 8-step binary search in shared memory) is
// far below the card's compute rate.
//
// Design: one 256-thread CTA per block.  Each thread loads its elements as
// float4 (neighbouring threads on neighbouring 16-byte words) and keeps them
// in registers across the absmax reduction, so x is read from HBM once; the
// codebook midpoints sit in shared memory; codes are stored four at a time.
#include "common.cuh"

namespace {

template <int VPT>
__global__ void __launch_bounds__(rq::kThreads)
quantize_kernel(const float* x, const float* qmap, uint8_t* codes,
                float* absmax, int block_size) {
  __shared__ float lut[rq::kCodebookSize];
  __shared__ float bounds[rq::kCodebookSize];
  __shared__ float red[66];
  rq::load_codebook(qmap, lut, bounds);

  const size_t row = blockIdx.x;
  const int nvec = block_size >> 2;
  const float4* xr = reinterpret_cast<const float4*>(x + row * block_size);
  uchar4* cr = reinterpret_cast<uchar4*>(codes + row * block_size);

  float4 v[VPT];
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * rq::kThreads;
    if (i < nvec) {
      v[k] = xr[i];
      amax = rq::absmax4(amax, v[k]);
    }
  }
  const float a = rq::block_max2(amax, 0.f, red).x;
  const float scale = rq::block_scale(a);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * rq::kThreads;
    if (i < nvec) cr[i] = rq::encode4(v[k], scale, bounds);
  }
  if (threadIdx.x == 0) absmax[row] = a;
}

}  // namespace

extern "C" int blockwise_quantize(const float* x, const float* qmap,
                                  uint8_t* codes, float* absmax, int n_blocks,
                                  int block_size, cudaStream_t stream) {
  if (n_blocks == 0) return 0;
  const dim3 grid(n_blocks), block(rq::kThreads);
  switch (rq_vectors_per_thread(block_size)) {
    case 1: quantize_kernel<1><<<grid, block, 0, stream>>>(x, qmap, codes, absmax, block_size); break;
    case 2: quantize_kernel<2><<<grid, block, 0, stream>>>(x, qmap, codes, absmax, block_size); break;
    case 4: quantize_kernel<4><<<grid, block, 0, stream>>>(x, qmap, codes, absmax, block_size); break;
    case 8: quantize_kernel<8><<<grid, block, 0, stream>>>(x, qmap, codes, absmax, block_size); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
