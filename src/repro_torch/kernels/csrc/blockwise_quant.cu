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
// 3.35 TB/s.  The work per element (one division, a bits-step search in
// shared memory, the counter hash when rounding stochastically) is far
// below the card's compute rate, but not far below its issue rate, so
// the design cuts instructions: the division by the block's scale is
// rq::div_fast for a group of 8 in its range (exact, common.cuh), and the
// search keeps its node as a byte offset (rq::encode_tree).
//
// Design: the fused update's streaming skeleton (csrc/fused_update.cu).
//   * Each thread owns one group of 8 consecutive elements of a block (a
//     CTA of 256, 512 or 1024 threads, the fewest that cover the block) and
//     keeps them in registers across the absmax reduction, so x is read
//     from HBM once.  Its 8 codes are b whole bytes of the packed row
//     (MSB-first bitstreams): the thread packs them in registers and
//     stores them in the widest words their alignment allows
//     (rq::store_group); at 8 bits one 8-byte word, or two 4-byte halves
//     and a last half group of 4 codes at a block size of 8k + 4
//     (rq::store_codes8).  No byte staging, no second barrier.
//   * CTAs walk the blocks on a grid of 16 waves of the CTAs resident at
//     once (blockwise_quantize_ctas, rq_walk_ctas), and each loads the
//     codebook (2^bits entries) and builds its midpoints once, in
//     Eytzinger order for rq::encode_tree<BITS> (bits steps).
//   * A two-slot ring of shared-memory stages, each one block's x row,
//     filled by 16-byte cp.async pieces: the next block's row is in flight
//     while the current block reduces and encodes.
//
// Stochastic rounding (the Muon requantize): the uniform of element col of
// block row is the counter hash of index row * B + col (uint32) with seed
// `seed` + the state-1 salt, as kernels/common.py::element_indices and
// hash_uniform give it; the choice is capped at 2^bits - 1.
#include "common.cuh"

namespace {

// Resident CTAs per SM: 6 of 256 threads (the launch bound caps registers
// at 40; 6 x 18.4 KB of shared memory at B = 2048), 3 of 512 and 1 of
// 1024.
template <int THREADS>
constexpr int quant_ctas_per_sm() {
  return THREADS == 256 ? 6 : (THREADS == 512 ? 3 : 1);
}

template <int BITS, int THREADS, bool STOCH>
__global__ void __launch_bounds__(THREADS, quant_ctas_per_sm<THREADS>())
quantize_kernel(const float* x, const float* qmap, uint8_t* codes,
                float* absmax, int n_blocks, int block_size, int seed) {
  __shared__ float lut[rq::kCodebookSize], tree[rq::kCodebookSize];
  __shared__ float red[66];
  RQ_DYNAMIC_SHARED(float4, ring);

  constexpr uint32_t kMax = (1u << BITS) - 1u;
  const int bsz = block_size, nvec = bsz >> 2, w = bsz * BITS / 8;
  const size_t nb = static_cast<size_t>(n_blocks);
  const size_t stride = gridDim.x;
  const int v = threadIdx.x;              // this thread's group
  const bool live = 8 * v < bsz;
  const bool half = 8 * v + 4 == bsz;     // 8 bits only: B = 8k + 4
  const bool wide = (bsz & 7) == 0;
  auto stage = [&](size_t row, int slot) {
    if (row < nb) {
      const float4* src = reinterpret_cast<const float4*>(x + row * bsz);
      for (int c = threadIdx.x; c < nvec; c += THREADS)
        cp_async_16(ring + nvec * slot + c, src + c, true);
    }
    cp_async_commit();
  };
  size_t row = blockIdx.x;
  stage(row, 0);
  stage(row + stride, 1);
  rq::load_codebook_tree(qmap, lut, tree, BITS);
  const uint32_t sseed = static_cast<uint32_t>(seed) + rq::kState1Salt;

  for (int slot = 0; row < nb; row += stride, slot ^= 1) {
    cp_async_wait<1>();   // this block's stage (the next one may still fly)
    __syncthreads();
    const float4* st = ring + nvec * slot;
    float e[8];
    float amax = 0.f, amin = INFINITY;   // the group's largest and least |x|
    if (live) {
      const float4 a = st[2 * v];
      const float4 b = half ? make_float4(0.f, 0.f, 0.f, 0.f) : st[2 * v + 1];
      const float t[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        e[c] = t[c];
        amax = rq::nanmax(amax, fabsf(t[c]));  // the zeros of a half group
        if (c < 4 || !half) amin = fminf(amin, fabsf(t[c]));  // move neither
      }
    }
    // every thread has read this stage before the reduction's first
    // barrier: refill it with the block two ahead
    const float a = rq::block_max2(amax, 0.f, red).x;
    stage(row + 2 * stride, slot);
    if (live) {
      const uint32_t idx0 = static_cast<uint32_t>(row) *
                                static_cast<uint32_t>(bsz) +
                            static_cast<uint32_t>(8 * v);
      float xn[8];
      rq::div8(e, rq::div_by(rq::block_scale(a)), amin, amax, xn);
      uint64_t packed = 0;   // rq::load_group's layout
      uint32_t le[2] = {0u, 0u};   // rq::load_codes8's (8 bits)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        uint32_t code = rq::encode_tree<BITS>(xn[c], tree);
        if (STOCH)
          code = rq::stochastic_code(xn[c], code, lut,
                                     rq::hash_uniform(idx0 + c, sseed), kMax);
        if (BITS == 8)
          le[c >> 2] |= code << (8 * (c & 3));
        else
          packed = (packed << BITS) | code;
      }
      if (BITS == 8) {
        uint2 cw;
        cw.x = le[0];
        cw.y = le[1];
        rq::store_codes8(codes + row * bsz + 8 * v, cw, wide, half);
      } else {
        rq::store_group(codes + row * w + BITS * v, packed, BITS);
      }
    }
    if (threadIdx.x == 0) absmax[row] = a;
  }
}

// Dynamic shared memory per CTA: the two-slot ring of x rows.
int quant_smem_bytes(int block_size) { return 2 * 4 * block_size; }

template <int BITS, int THREADS, bool STOCH>
int launch(const float* x, const float* qmap, uint8_t* codes, float* absmax,
           int n_blocks, int block_size, int seed, int ctas,
           cudaStream_t stream) {
  const int smem = quant_smem_bytes(block_size);
  const cudaError_t e =
      rq_allow_smem(quantize_kernel<BITS, THREADS, STOCH>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(ctas), block(THREADS);
  quantize_kernel<BITS, THREADS, STOCH><<<grid, block, smem, stream>>>(
      x, qmap, codes, absmax, n_blocks, block_size, seed);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS, bool STOCH>
int launch_threads(const float* x, const float* qmap, uint8_t* codes,
                   float* absmax, int n_blocks, int block_size, int seed,
                   int ctas, cudaStream_t stream) {
  switch (rq_walk_threads(block_size)) {
    case 256: return launch<BITS, 256, STOCH>(x, qmap, codes, absmax, n_blocks, block_size, seed, ctas, stream);
    case 512: return launch<BITS, 512, STOCH>(x, qmap, codes, absmax, n_blocks, block_size, seed, ctas, stream);
    default: return launch<BITS, 1024, STOCH>(x, qmap, codes, absmax, n_blocks, block_size, seed, ctas, stream);
  }
}

template <int BITS>
int launch_bits(const float* x, const float* qmap, uint8_t* codes,
                float* absmax, int n_blocks, int block_size, int stochastic,
                int seed, int ctas, cudaStream_t stream) {
  return stochastic
             ? launch_threads<BITS, true>(x, qmap, codes, absmax, n_blocks,
                                          block_size, seed, ctas, stream)
             : launch_threads<BITS, false>(x, qmap, codes, absmax, n_blocks,
                                           block_size, seed, ctas, stream);
}

// Block sizes the kernel takes at `bits`: a multiple of 4 at 8 bits (whole
// 4-byte code words), of 8 below (whole bytes per group), at most 8192.
bool valid_shape(int block_size, int bits) {
  return block_size > 0 && block_size <= rq::kMaxBlock &&
         block_size % (bits == 8 ? 4 : 8) == 0 &&
         (bits == 4 || bits == 5 || bits == 6 || bits == 8);
}

}  // namespace

// codes: (n_blocks, block_size * bits / 8) uint8; qmap: 2^bits entries.
// stochastic != 0 rounds stochastically with `seed` (see above).  ctas:
// the grid, from blockwise_quantize_ctas; each CTA walks the blocks
// blockIdx.x, blockIdx.x + ctas, ...
extern "C" int blockwise_quantize_grid(const float* x, const float* qmap,
                                       uint8_t* codes, float* absmax,
                                       int n_blocks, int block_size, int bits,
                                       int stochastic, int seed, int ctas,
                                       cudaStream_t stream) {
  if (n_blocks == 0) return 0;
  if (!valid_shape(block_size, bits) || ctas <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bits) {
    case 4: return launch_bits<4>(x, qmap, codes, absmax, n_blocks, block_size, stochastic, seed, ctas, stream);
    case 5: return launch_bits<5>(x, qmap, codes, absmax, n_blocks, block_size, stochastic, seed, ctas, stream);
    case 6: return launch_bits<6>(x, qmap, codes, absmax, n_blocks, block_size, stochastic, seed, ctas, stream);
    default: return launch_bits<8>(x, qmap, codes, absmax, n_blocks, block_size, stochastic, seed, ctas, stream);
  }
}

// The grid of blockwise_quantize_grid for n_blocks blocks on a card of
// `sms` SMs (rq_walk_ctas); 0 for a shape it refuses.
extern "C" int blockwise_quantize_ctas(int n_blocks, int block_size,
                                       int bits, int sms) {
  if (!valid_shape(block_size, bits)) return 0;
  int per_sm;
  switch (rq_walk_threads(block_size)) {
    case 256: per_sm = quant_ctas_per_sm<256>(); break;
    case 512: per_sm = quant_ctas_per_sm<512>(); break;
    default: per_sm = quant_ctas_per_sm<1024>(); break;
  }
  return rq_walk_ctas(n_blocks, sms, per_sm);
}

// Dynamic shared memory per CTA of blockwise_quantize_grid (its ring).
extern "C" int blockwise_quantize_smem(int block_size) {
  return quant_smem_bytes(block_size);
}

// blockwise_quantize_grid with one CTA per block.
extern "C" int blockwise_quantize(const float* x, const float* qmap,
                                  uint8_t* codes, float* absmax, int n_blocks,
                                  int block_size, int bits, int stochastic,
                                  int seed, cudaStream_t stream) {
  return blockwise_quantize_grid(x, qmap, codes, absmax, n_blocks,
                                 block_size, bits, stochastic, seed, n_blocks,
                                 stream);
}

#ifdef __CUDACC__
namespace {

// The occupancy query of one instance (rq_occupancy).
template <int BITS, bool STOCH>
int occupancy_threads(int threads, int smem, int* out) {
  switch (threads) {
    case 256: return rq_occupancy(quantize_kernel<BITS, 256, STOCH>, 256, smem, out);
    case 512: return rq_occupancy(quantize_kernel<BITS, 512, STOCH>, 512, smem, out);
    case 1024: return rq_occupancy(quantize_kernel<BITS, 1024, STOCH>, 1024, smem, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int BITS>
int occupancy_bits(int threads, int stochastic, int smem, int* out) {
  return stochastic ? occupancy_threads<BITS, true>(threads, smem, out)
                    : occupancy_threads<BITS, false>(threads, smem, out);
}

}  // namespace

// rq_occupancy of quantize_kernel<bits, threads, stochastic> at `smem`
// bytes of dynamic shared memory; out: 5 ints.
extern "C" int blockwise_quantize_occupancy(int bits, int threads,
                                            int stochastic, int smem,
                                            int* out) {
  switch (bits) {
    case 4: return occupancy_bits<4>(threads, stochastic, smem, out);
    case 5: return occupancy_bits<5>(threads, stochastic, smem, out);
    case 6: return occupancy_bits<6>(threads, stochastic, smem, out);
    case 8: return occupancy_bits<8>(threads, stochastic, smem, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif
