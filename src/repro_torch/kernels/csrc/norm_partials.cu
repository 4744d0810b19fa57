// Norm prologue of LAMB and LARS: per-block partial squared norms
// [||p||^2, ||g * gnorm_scale||^2, ||u||^2, 0, 0, 0, 0, 0], one f32 row of
// 8 per quantization block.
//
// Replaces the TPU kernel src/repro/kernels/fused_update.py::
// _make_norm_kernel (pallas_call in _norm_partials_pallas).  lars reads p
// and g; lamb also reads both states' codes and absmax and re-derives the
// pre-trust-ratio update u from the dequantized moments exactly as the
// fused update does (update_math.cuh, adam_base).  The partials stay per
// block, as in the reference: the per-segment finalize (torch ops,
// kernels/fused_update.py::segment_scales_from_partials) sums them into one
// trust ratio per tensor.
//
// Bound on an H100: memory.  lars reads 8 B/element (p, g), lamb 10
// B/element (p, g and two codes), plus 32 B written per block, over
// 3.35 TB/s: 0.201 ms for lars and 0.251 ms for lamb at the main path's
// 40960 x 2048 leaf.
//
// bf16 p (ROADMAP A14b-1, a bf16 master; the reference casts p and its f32
// g to f32, fused_update.py:407-408): the library built with RQ_P_BF16
// (kernels/build.py LIBRARIES) has the same entries on bf16 p and f32 g.
// It reads each thread's four-element vectors of p as 8-byte words and
// converts them to f32 on load, so the sums and their order are the f32
// instance's.  lars then reads 6 B/element, lamb 8.
//
// Packed states (ROADMAP B3(d)): lamb's codes may be packed b-bit rows
// (core/lowbit/packing.py), b in {4, 5, 6, 8} per state, with 2^b-entry
// codebooks.  lamb at (4, 8) reads 9.5 B/element.
//
// The order of the sums: a sum is not order-free in floating point, so
// this kernel fixes one order and its plain version
// (kernels/fused_update.py::block_sums) repeats it: each thread adds its
// own elements in sequence — its float4 vectors i = threadIdx.x + 256 k
// for k = 0, 1, ..., the four lanes of each in order — then rq::block_sum3
// adds across the CTA (the xor-shuffle tree in each warp, then the same
// tree over the warp sums).  Every addition and product is an explicitly
// rounded intrinsic.
//
// Design: 256-thread CTAs walk the blocks (block blockIdx.x, then
// + gridDim.x, ...; the grid is 16 waves of the CTAs resident at once,
// from the card's SM count: norm_partials_ctas, rq_walk_ctas), so a CTA's
// launch, its lookup tables (lamb) and its retirement are paid once for a
// few blocks, and the hardware still balances the SMs.  Each thread
// holds its VPT float4 vectors of p and g (and lamb's uchar4 codes and the
// block's absmax) in registers: after adding a block's elements it issues
// the loads of its next block into the same registers, and only then
// joins the block's reduction, so the next block's bytes are in flight
// through the reduction's barriers and the store of the partials.  Packed
// rows are staged in shared memory by 16-byte cp.async pieces
// (rq::stage_packed_row) in a two-slot ring, two blocks ahead, and each
// thread unpacks the codes of its own four-element vectors from there
// (rq::unpack_code).  Shared memory per CTA: 396 bytes of reduction
// slots, 2 KB of lookup tables for lamb, and for packed rows a dynamic
// 2 x (staged rows) — 6,208 bytes at B = 2048, (4, 8).  Up to B = 2048,
// 8 CTAs of 256 threads per SM for lars and 4 for lamb (norm_ctas_per_sm:
// the launch bound caps registers at 32 and 64).
#include "update_math.cuh"

namespace {

enum NormKind { kLarsNorms = 0, kLambNorms = 1 };

// Resident CTAs per SM that the launch bound asks registers for: up to 2
// vectors per thread, 8 for lars (32 registers a thread: its vectors of p
// and g and three sums; 128 KB of loads in flight per SM) and 4 for lamb
// (64 registers: its codes and the update's temporaries); half as many
// for each doubling of the vectors.
template <int KIND, int VPT>
constexpr int norm_ctas_per_sm() {
  return (KIND == kLarsNorms ? 8 : 4) / (VPT <= 2 ? 1 : VPT / 2);
}

// A thread's inputs of one block: its VPT float4 vectors of p and g, and
// for lamb its codes (8-bit rows) and the block's absmax.
template <int VPT>
struct NormInputs {
  float4 p[VPT], g[VPT];
  uchar4 cm[VPT], cr[VPT];
  float am, ar;
};

template <typename T, int KIND, int VPT, bool PACKED>
__device__ __forceinline__ void load_inputs(
    NormInputs<VPT>& in, const T* p, const float* g,
    const uint8_t* codes_m, const float* absmax_m, const uint8_t* codes_r,
    const float* absmax_r, size_t row, int block_size) {
  constexpr bool kLamb = KIND == kLambNorms;
  const size_t off = row * block_size;
  const int nvec = block_size >> 2;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * rq::kThreads;
    if (i < nvec) {
      in.p[k] = rq::Elem<T>::load4(p + off, i);
      in.g[k] = rq::Elem<float>::load4(g + off, i);
      if (kLamb && !PACKED) {
        in.cm[k] = reinterpret_cast<const uchar4*>(codes_m + off)[i];
        in.cr[k] = reinterpret_cast<const uchar4*>(codes_r + off)[i];
      }
    }
  }
  if (kLamb) {
    in.am = absmax_m[row];
    in.ar = absmax_r[row];
  }
}

template <typename T, int KIND, int VPT, bool PACKED>
__global__ void __launch_bounds__(rq::kThreads, norm_ctas_per_sm<KIND, VPT>())
norm_partials_kernel(const T* p, const float* g, const uint8_t* codes_m,
                     const float* absmax_m, const uint8_t* codes_r,
                     const float* absmax_r, const float* qmap_m,
                     const float* qmap_r, float* out, int n_blocks,
                     int block_size, int bits_m, int bits_r, rq::Scalars s) {
  constexpr bool kLamb = KIND == kLambNorms;
  __shared__ float lut_m[kLamb ? rq::kCodebookSize : 1];
  __shared__ float lut_r[kLamb ? rq::kCodebookSize : 1];
  __shared__ float red[99];
  RQ_DYNAMIC_SHARED(uint8_t, ring);
  const size_t nb = static_cast<size_t>(n_blocks);
  const size_t stride = gridDim.x;
  const int nvec = block_size >> 2;
  const int wm = PACKED ? block_size * bits_m / 8 : 0;
  const int wr = PACKED ? block_size * bits_r / 8 : 0;
  const int slot_bytes = PACKED ? rq::staged_row_bytes(wm) +
                                      rq::staged_row_bytes(wr) : 0;
  // issue (and commit, also when empty) the copies of block row's packed
  // rows into ring slot `slot`
  auto stage = [&](size_t row, int slot) {
    if (row < nb) {
      uint8_t* dst = ring + slot * slot_bytes;
      rq::stage_packed_row(dst, codes_m, row * wm, wm, nb * wm);
      rq::stage_packed_row(dst + rq::staged_row_bytes(wm), codes_r,
                           row * wr, wr, nb * wr);
    }
    cp_async_commit();
  };
  size_t row = blockIdx.x;
  if (PACKED) {
    stage(row, 0);
    stage(row + stride, 1);
  }
  NormInputs<VPT> in;
  if (row < nb)
    load_inputs<T, KIND, VPT, PACKED>(in, p, g, codes_m, absmax_m, codes_r,
                                      absmax_r, row, block_size);
  if (kLamb) {
    rq::load_lut(qmap_m, lut_m, 1 << bits_m);
    rq::load_lut(qmap_r, lut_r, 1 << bits_r);
    __syncthreads();
  }

  for (int slot = 0; row < nb; row += stride, slot ^= 1) {
    const uint8_t* old_m = nullptr;
    const uint8_t* old_r = nullptr;
    if (PACKED) {
      cp_async_wait<1>();   // this block's rows (the next may still fly)
      __syncthreads();
      old_m = ring + slot * slot_bytes + ((row * wm) & 15);
      old_r = ring + slot * slot_bytes + rq::staged_row_bytes(wm) +
              ((row * wr) & 15);
    }
    float pn2 = 0.f, gn2 = 0.f, un2 = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = threadIdx.x + k * rq::kThreads;
      if (i < nvec) {
        const float4 pv = in.p[k], gv = in.g[k];
        const float pe[4] = {pv.x, pv.y, pv.z, pv.w};
        const float ge[4] = {gv.x, gv.y, gv.z, gv.w};
        uint32_t ce_m[4] = {0, 0, 0, 0}, ce_r[4] = {0, 0, 0, 0};
        if (kLamb && PACKED) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            ce_m[c] = rq::unpack_code(old_m, 4 * i + c, bits_m);
            ce_r[c] = rq::unpack_code(old_r, 4 * i + c, bits_r);
          }
        } else if (kLamb) {
          const uchar4 cm = in.cm[k], cr = in.cr[k];
          ce_m[0] = cm.x; ce_m[1] = cm.y; ce_m[2] = cm.z; ce_m[3] = cm.w;
          ce_r[0] = cr.x; ce_r[1] = cr.y; ce_r[2] = cr.z; ce_r[3] = cr.w;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float gs = __fmul_rn(ge[c], s.gnorm_scale);
          pn2 = __fadd_rn(pn2, __fmul_rn(pe[c], pe[c]));
          gn2 = __fadd_rn(gn2, __fmul_rn(gs, gs));
          if (kLamb) {
            float u;
            rq::adam_base(pe[c], gs,
                          __fmul_rn(rq::decode(ce_m[c], lut_m), in.am),
                          __fmul_rn(rq::decode(ce_r[c], lut_r), in.ar), s,
                          &u);
            un2 = __fadd_rn(un2, __fmul_rn(u, u));
          }
        }
      }
    }
    // the next block's loads go out before this block's reduction
    if (row + stride < nb)
      load_inputs<T, KIND, VPT, PACKED>(in, p, g, codes_m, absmax_m,
                                        codes_r, absmax_r, row + stride,
                                        block_size);
    const float3 sums = rq::block_sum3(pn2, gn2, un2, red);
    // every thread has read this ring slot before the reduction's first
    // barrier: refill it with the block two ahead
    if (PACKED) stage(row + 2 * stride, slot);
    if (threadIdx.x < 8) {
      const float v[3] = {sums.x, sums.y, sums.z};
      out[row * 8 + threadIdx.x] = threadIdx.x < 3 ? v[threadIdx.x] : 0.f;
    }
  }
}

struct Args {
  const PElem* p;
  const float* g;
  const uint8_t* codes_m;
  const float* absmax_m;
  const uint8_t* codes_r;
  const float* absmax_r;
  const float* qmap_m;
  const float* qmap_r;
  float* out;
  int n_blocks, block_size, bits_m, bits_r, ctas;
  rq::Scalars s;
};

// Dynamic shared memory of the kernel on packed rows: its two-slot ring.
int packed_smem_bytes(int block_size, int bits_m, int bits_r) {
  return 2 * (rq::staged_row_bytes(block_size * bits_m / 8) +
              rq::staged_row_bytes(block_size * bits_r / 8));
}

template <int KIND, int VPT, bool PACKED>
int launch(const Args& a, cudaStream_t stream) {
  const int smem =
      PACKED ? packed_smem_bytes(a.block_size, a.bits_m, a.bits_r) : 0;
  const dim3 grid(a.ctas), block(rq::kThreads);
  norm_partials_kernel<PElem, KIND, VPT, PACKED><<<grid, block, smem, stream>>>(
      a.p, a.g, a.codes_m, a.absmax_m, a.codes_r, a.absmax_r, a.qmap_m,
      a.qmap_r, a.out, a.n_blocks, a.block_size, a.bits_m, a.bits_r, a.s);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND, bool PACKED>
int launch_vpt(const Args& a, cudaStream_t stream) {
  switch (rq_vectors_per_thread(a.block_size)) {
    case 1: return launch<KIND, 1, PACKED>(a, stream);
    case 2: return launch<KIND, 2, PACKED>(a, stream);
    case 4: return launch<KIND, 4, PACKED>(a, stream);
    case 8: return launch<KIND, 8, PACKED>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool valid_bits(int b) { return b == 4 || b == 5 || b == 6 || b == 8; }

}  // namespace

// kind: 0 = lars (codes, absmax, qmaps and widths unused, may be null),
// 1 = lamb, whose codes are packed bits_m- / bits_r-bit rows unless both
// widths are 8 (widths in {4, 5, 6, 8}, qmaps of 2^bits entries; packed
// rows need a block_size that is a multiple of 8).  ctas: the grid, from
// norm_partials_ctas; each CTA walks the blocks blockIdx.x,
// blockIdx.x + ctas, ...
extern "C" int norm_partials_grid(
    int kind, const PElem* p, const float* g, const uint8_t* codes_m,
    const float* absmax_m, const uint8_t* codes_r, const float* absmax_r,
    const float* qmap_m, const float* qmap_r, float* out, int n_blocks,
    int block_size, int bits_m, int bits_r, int ctas, float lr, float beta1,
    float one_minus_beta1, float beta2, float one_minus_beta2, float eps,
    float weight_decay, float c1, float c2, float gnorm_scale,
    cudaStream_t stream) {
  if (n_blocks == 0) return 0;
  if (ctas <= 0 || block_size <= 0 || block_size % 4 ||
      block_size > rq::kMaxBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r,
               out, n_blocks, block_size, bits_m, bits_r, ctas,
               rq::Scalars{lr, beta1, one_minus_beta1, beta2, one_minus_beta2,
                           eps, weight_decay, c1, c2, gnorm_scale}};
  if (kind == kLarsNorms) return launch_vpt<kLarsNorms, false>(a, stream);
  if (kind != kLambNorms || !codes_m || !absmax_m || !codes_r ||
      !absmax_r || !qmap_m || !qmap_r || !valid_bits(bits_m) ||
      !valid_bits(bits_r))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bits_m == 8 && bits_r == 8)
    return launch_vpt<kLambNorms, false>(a, stream);
  if (block_size % 8) return static_cast<int>(cudaErrorInvalidValue);
  return launch_vpt<kLambNorms, true>(a, stream);
}

// The grid of norm_partials_grid for kind on a card of `sms` SMs:
// rq_walk_ctas of the CTAs resident at once (norm_ctas_per_sm); 0 for an
// invalid shape.
template <int KIND>
int norm_ctas(int n_blocks, int block_size, int sms) {
  int per_sm;
  switch (rq_vectors_per_thread(block_size)) {
    case 1: per_sm = norm_ctas_per_sm<KIND, 1>(); break;
    case 2: per_sm = norm_ctas_per_sm<KIND, 2>(); break;
    case 4: per_sm = norm_ctas_per_sm<KIND, 4>(); break;
    case 8: per_sm = norm_ctas_per_sm<KIND, 8>(); break;
    default: return 0;
  }
  return rq_walk_ctas(n_blocks, sms, per_sm);
}

extern "C" int norm_partials_ctas(int kind, int n_blocks, int block_size,
                                  int sms) {
  if (n_blocks <= 0 || sms <= 0 || block_size % 4) return 0;
  if (kind == kLarsNorms)
    return norm_ctas<kLarsNorms>(n_blocks, block_size, sms);
  if (kind == kLambNorms)
    return norm_ctas<kLambNorms>(n_blocks, block_size, sms);
  return 0;
}

// Dynamic shared memory per CTA of norm_partials_grid for lamb on packed
// rows (0 otherwise).
extern "C" int norm_partials_smem(int block_size, int bits_m, int bits_r) {
  return bits_m == 8 && bits_r == 8 ? 0
                                    : packed_smem_bytes(block_size, bits_m,
                                                        bits_r);
}

// norm_partials_grid with one CTA per block, for lars or lamb on 8-bit rows.
extern "C" int norm_partials(
    int kind, const PElem* p, const float* g, const uint8_t* codes_m,
    const float* absmax_m, const uint8_t* codes_r, const float* absmax_r,
    const float* qmap_m, const float* qmap_r, float* out, int n_blocks,
    int block_size, float lr, float beta1, float one_minus_beta1, float beta2,
    float one_minus_beta2, float eps, float weight_decay, float c1, float c2,
    float gnorm_scale, cudaStream_t stream) {
  return norm_partials_grid(kind, p, g, codes_m, absmax_m, codes_r, absmax_r,
                            qmap_m, qmap_r, out, n_blocks, block_size, 8, 8,
                            n_blocks, lr, beta1, one_minus_beta1, beta2,
                            one_minus_beta2, eps, weight_decay, c1, c2,
                            gnorm_scale, stream);
}

// norm_partials_grid with one CTA per block, for lamb on packed rows.
extern "C" int norm_partials_packed(
    const PElem* p, const float* g, const uint8_t* codes_m,
    const float* absmax_m, const uint8_t* codes_r, const float* absmax_r,
    const float* qmap_m, const float* qmap_r, float* out, int n_blocks,
    int block_size, int bits_m, int bits_r, float lr, float beta1,
    float one_minus_beta1, float beta2, float one_minus_beta2, float eps,
    float weight_decay, float c1, float c2, float gnorm_scale,
    cudaStream_t stream) {
  return norm_partials_grid(kLambNorms, p, g, codes_m, absmax_m, codes_r,
                            absmax_r, qmap_m, qmap_r, out, n_blocks,
                            block_size, bits_m, bits_r, n_blocks, lr, beta1,
                            one_minus_beta1, beta2, one_minus_beta2, eps,
                            weight_decay, c1, c2, gnorm_scale, stream);
}

#ifdef __CUDACC__
namespace {

// The occupancy query of one instance (rq_occupancy).  lars reads no
// codes: its kernel has no packed instance, and none is made here.
template <int KIND, int VPT, bool PACKED>
int occupancy(int smem, int* out) {
  return rq_occupancy(norm_partials_kernel<PElem, KIND, VPT, PACKED>,
                      rq::kThreads, smem, out);
}

template <int KIND, bool PACKED>
int occupancy_vpt(int vpt, int smem, int* out) {
  switch (vpt) {
    case 1: return occupancy<KIND, 1, PACKED>(smem, out);
    case 2: return occupancy<KIND, 2, PACKED>(smem, out);
    case 4: return occupancy<KIND, 4, PACKED>(smem, out);
    case 8: return occupancy<KIND, 8, PACKED>(smem, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// rq_occupancy of norm_partials_kernel<PElem, kind, vpt, packed> at `smem`
// bytes of dynamic shared memory (packed lamb only); out: 5 ints.
extern "C" int norm_partials_occupancy(int kind, int vpt, int packed,
                                       int smem, int* out) {
  if (kind == kLarsNorms && !packed)
    return occupancy_vpt<kLarsNorms, false>(vpt, smem, out);
  if (kind == kLambNorms)
    return packed ? occupancy_vpt<kLambNorms, true>(vpt, smem, out)
                  : occupancy_vpt<kLambNorms, false>(vpt, smem, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif
