// Block-wise k-bit quantization: (n_blocks, B) f32 -> codes, absmax f32.
//
// Replaces the TPU kernel src/repro/kernels/blockwise_quant.py::_quant_kernel
// (pallas_call in quantize_blockwise), and the requantize step of the Muon
// leaf update (src/repro/kernels/ops.py::_muon_entry, which quantizes at
// the XLA level): codes of `bits` in {4, 5, 6, 8} bits, bit-packed below 8
// (core/lowbit/packing.py), optionally with stochastic rounding.
//
// Bound on an H100: memory.  It reads 4 bytes and writes bits/8 bytes per
// element (plus 4 bytes of absmax per block): 5 B/element at 8 bits over
// 3.35 TB/s.  The work per element (one division, an 8-step binary search
// in shared memory, the counter hash when rounding stochastically) is far
// below the card's compute rate.
//
// Design: one 256-thread CTA per block.  Each thread loads its elements as
// float4 (neighbouring threads on neighbouring 16-byte words) and keeps them
// in registers across the absmax reduction, so x is read from HBM once; the
// codebook (2^bits entries) and its midpoints, padded with +inf, sit in
// shared memory.  8-bit codes are stored four at a time; packed codes go to
// shared memory one byte each, and after a barrier each thread packs whole
// output bytes (rq::pack_byte).
//
// Stochastic rounding (the Muon requantize): the uniform of element col of
// block row is the counter hash of index row * B + col (uint32) with seed
// `seed` + the state-1 salt, as kernels/common.py::element_indices and
// hash_uniform give it; the choice is capped at 2^bits - 1.
#include "common.cuh"

namespace {

template <int VPT, bool PACKED>
__global__ void __launch_bounds__(rq::kThreads)
quantize_kernel(const float* x, const float* qmap, uint8_t* codes,
                float* absmax, int block_size, int bits, int stochastic,
                int seed) {
  __shared__ float lut[rq::kCodebookSize];
  __shared__ float bounds[rq::kCodebookSize];
  __shared__ float red[66];
  __shared__ uint8_t new_codes[PACKED ? rq::kMaxBlock : 1];
  rq::load_codebook(qmap, lut, bounds, 1 << bits);

  const size_t row = blockIdx.x;
  const int nvec = block_size >> 2;
  const float4* xr = reinterpret_cast<const float4*>(x + row * block_size);

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
  const bool sr = stochastic != 0;
  const uint32_t max_code = (1u << bits) - 1u;
  const uint32_t sseed = static_cast<uint32_t>(seed) + rq::kState1Salt;
  const uint32_t base = static_cast<uint32_t>(row) *
                        static_cast<uint32_t>(block_size);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * rq::kThreads;
    if (i < nvec) {
      const float e[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
      uint8_t c4[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float u =
            sr ? rq::hash_uniform(base + static_cast<uint32_t>(4 * i + c),
                                  sseed)
               : 0.f;
        c4[c] = static_cast<uint8_t>(
            rq::requant_code(e[c], scale, lut, bounds, sr, u, max_code));
      }
      if (PACKED) {
#pragma unroll
        for (int c = 0; c < 4; ++c) new_codes[4 * i + c] = c4[c];
      } else {
        reinterpret_cast<uchar4*>(codes + row * block_size)[i] =
            make_uchar4(c4[0], c4[1], c4[2], c4[3]);
      }
    }
  }
  if (PACKED) {
    __syncthreads();
    const int w = block_size * bits / 8;
    for (int k = threadIdx.x; k < w; k += rq::kThreads)
      codes[row * w + k] = rq::pack_byte(new_codes, k, bits);
  }
  if (threadIdx.x == 0) absmax[row] = a;
}

template <bool PACKED>
int launch(const float* x, const float* qmap, uint8_t* codes, float* absmax,
           int n_blocks, int block_size, int bits, int stochastic, int seed,
           cudaStream_t stream) {
  const dim3 grid(n_blocks), block(rq::kThreads);
  switch (rq_vectors_per_thread(block_size)) {
    case 1: quantize_kernel<1, PACKED><<<grid, block, 0, stream>>>(x, qmap, codes, absmax, block_size, bits, stochastic, seed); break;
    case 2: quantize_kernel<2, PACKED><<<grid, block, 0, stream>>>(x, qmap, codes, absmax, block_size, bits, stochastic, seed); break;
    case 4: quantize_kernel<4, PACKED><<<grid, block, 0, stream>>>(x, qmap, codes, absmax, block_size, bits, stochastic, seed); break;
    case 8: quantize_kernel<8, PACKED><<<grid, block, 0, stream>>>(x, qmap, codes, absmax, block_size, bits, stochastic, seed); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// codes: (n_blocks, block_size * bits / 8) uint8; qmap: 2^bits entries.
// stochastic != 0 rounds stochastically with `seed` (see above).
extern "C" int blockwise_quantize(const float* x, const float* qmap,
                                  uint8_t* codes, float* absmax, int n_blocks,
                                  int block_size, int bits, int stochastic,
                                  int seed, cudaStream_t stream) {
  if (n_blocks == 0) return 0;
  if (bits == 8)
    return launch<false>(x, qmap, codes, absmax, n_blocks, block_size, bits,
                         stochastic, seed, stream);
  if ((bits != 4 && bits != 5 && bits != 6) || block_size % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(x, qmap, codes, absmax, n_blocks, block_size, bits,
                      stochastic, seed, stream);
}
