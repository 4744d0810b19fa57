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
// 3.35 TB/s.
//
// Packed states (ROADMAP B3(d)): lamb's codes may be packed b-bit rows
// (core/lowbit/packing.py), b in {4, 5, 6, 8} per state, with 2^b-entry
// codebooks.  Then the CTA stages its block's two packed rows in shared
// memory (coalesced byte loads) and each thread unpacks the codes of its
// own elements from there (rq::unpack_code); the order of the sums is the
// same.  lamb at (4, 8) reads 9.5 B/element.
//
// Design: one 256-thread CTA per block, float4/uchar4 loads, one HBM pass.
// A sum is not order-free in floating point, so this kernel fixes one
// order and its plain version (kernels/fused_update.py::block_sums) repeats
// it: each thread adds its own elements in sequence — its float4 vectors
// i = threadIdx.x + 256 k for k = 0, 1, ..., the four lanes of each in
// order — then rq::block_sum3 adds across the CTA (the xor-shuffle tree in
// each warp, then the same tree over the warp sums).  Every addition and
// product is an explicitly rounded intrinsic.
#include "update_math.cuh"

namespace {

enum NormKind { kLarsNorms = 0, kLambNorms = 1 };

template <int KIND, int VPT, bool PACKED>
__global__ void __launch_bounds__(rq::kThreads)
norm_partials_kernel(const float* p, const float* g, const uint8_t* codes_m,
                     const float* absmax_m, const uint8_t* codes_r,
                     const float* absmax_r, const float* qmap_m,
                     const float* qmap_r, float* out, int block_size,
                     int bits_m, int bits_r, rq::Scalars s) {
  constexpr bool kLamb = KIND == kLambNorms;
  __shared__ float lut_m[kLamb ? rq::kCodebookSize : 1];
  __shared__ float lut_r[kLamb ? rq::kCodebookSize : 1];
  __shared__ float red[99];
  __shared__ uint8_t old_m[PACKED ? rq::kMaxStagedRow : 1];
  __shared__ uint8_t old_r[PACKED ? rq::kMaxStagedRow : 1];
  const size_t row = blockIdx.x;
  const size_t off = row * block_size;
  const int nvec = block_size >> 2;
  if (PACKED) {
    const int wm = block_size * bits_m / 8, wr = block_size * bits_r / 8;
    for (int k = threadIdx.x; k <= wm; k += rq::kThreads)
      old_m[k] = k < wm ? codes_m[row * wm + k] : 0;
    for (int k = threadIdx.x; k <= wr; k += rq::kThreads)
      old_r[k] = k < wr ? codes_r[row * wr + k] : 0;
  }
  if (kLamb) {
    rq::load_lut(qmap_m, lut_m, 1 << bits_m);
    rq::load_lut(qmap_r, lut_r, 1 << bits_r);
    __syncthreads();
  }
  const float4* pr = reinterpret_cast<const float4*>(p + off);
  const float4* gr = reinterpret_cast<const float4*>(g + off);
  const uchar4* cmr = kLamb && !PACKED ? reinterpret_cast<const uchar4*>(codes_m + off) : nullptr;
  const uchar4* crr = kLamb && !PACKED ? reinterpret_cast<const uchar4*>(codes_r + off) : nullptr;
  const float am = kLamb ? absmax_m[row] : 0.f;
  const float ar = kLamb ? absmax_r[row] : 0.f;

  float pn2 = 0.f, gn2 = 0.f, un2 = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * rq::kThreads;
    if (i < nvec) {
      const float4 pv = pr[i], gv = gr[i];
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
        const uchar4 cm = cmr[i], cr = crr[i];
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
          rq::adam_base(pe[c], gs, __fmul_rn(rq::decode(ce_m[c], lut_m), am),
                        __fmul_rn(rq::decode(ce_r[c], lut_r), ar), s, &u);
          un2 = __fadd_rn(un2, __fmul_rn(u, u));
        }
      }
    }
  }
  const float3 sums = rq::block_sum3(pn2, gn2, un2, red);
  if (threadIdx.x < 8) {
    const float v[3] = {sums.x, sums.y, sums.z};
    out[row * 8 + threadIdx.x] = threadIdx.x < 3 ? v[threadIdx.x] : 0.f;
  }
}

struct Args {
  const float* p;
  const float* g;
  const uint8_t* codes_m;
  const float* absmax_m;
  const uint8_t* codes_r;
  const float* absmax_r;
  const float* qmap_m;
  const float* qmap_r;
  float* out;
  int n_blocks, block_size, bits_m, bits_r;
  rq::Scalars s;
};

template <int KIND, int VPT, bool PACKED>
int launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.n_blocks), block(rq::kThreads);
  norm_partials_kernel<KIND, VPT, PACKED><<<grid, block, 0, stream>>>(
      a.p, a.g, a.codes_m, a.absmax_m, a.codes_r, a.absmax_r, a.qmap_m,
      a.qmap_r, a.out, a.block_size, a.bits_m, a.bits_r, a.s);
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

// kind: 0 = lars (codes, absmax and qmaps may be null), 1 = lamb.
extern "C" int norm_partials(
    int kind, const float* p, const float* g, const uint8_t* codes_m,
    const float* absmax_m, const uint8_t* codes_r, const float* absmax_r,
    const float* qmap_m, const float* qmap_r, float* out, int n_blocks,
    int block_size, float lr, float beta1, float one_minus_beta1, float beta2,
    float one_minus_beta2, float eps, float weight_decay, float c1, float c2,
    float gnorm_scale, cudaStream_t stream) {
  if (n_blocks == 0) return 0;
  const Args a{p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r,
               out, n_blocks, block_size, 8, 8,
               rq::Scalars{lr, beta1, one_minus_beta1, beta2, one_minus_beta2,
                           eps, weight_decay, c1, c2, gnorm_scale}};
  if (kind == kLarsNorms) return launch_vpt<kLarsNorms, false>(a, stream);
  if (kind == kLambNorms) {
    if (!codes_m || !absmax_m || !codes_r || !absmax_r || !qmap_m || !qmap_r)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_vpt<kLambNorms, false>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// lamb's prologue on packed states: codes_m / codes_r are packed bits_m- /
// bits_r-bit rows (widths in {4, 5, 6, 8}), qmaps of 2^bits entries;
// block_size a multiple of 8 and at most rq::kMaxBlock.
extern "C" int norm_partials_packed(
    const float* p, const float* g, const uint8_t* codes_m,
    const float* absmax_m, const uint8_t* codes_r, const float* absmax_r,
    const float* qmap_m, const float* qmap_r, float* out, int n_blocks,
    int block_size, int bits_m, int bits_r, float lr, float beta1,
    float one_minus_beta1, float beta2, float one_minus_beta2, float eps,
    float weight_decay, float c1, float c2, float gnorm_scale,
    cudaStream_t stream) {
  if (n_blocks == 0) return 0;
  if (!codes_m || !absmax_m || !codes_r || !absmax_r || !qmap_m || !qmap_r ||
      !valid_bits(bits_m) || !valid_bits(bits_r) || block_size % 8 ||
      block_size <= 0 || block_size > rq::kMaxBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r,
               out, n_blocks, block_size, bits_m, bits_r,
               rq::Scalars{lr, beta1, one_minus_beta1, beta2, one_minus_beta2,
                           eps, weight_decay, c1, c2, gnorm_scale}};
  return launch_vpt<kLambNorms, true>(a, stream);
}
