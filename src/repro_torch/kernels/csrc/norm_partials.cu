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

template <int KIND, int VPT>
__global__ void __launch_bounds__(rq::kThreads)
norm_partials_kernel(const float* p, const float* g, const uint8_t* codes_m,
                     const float* absmax_m, const uint8_t* codes_r,
                     const float* absmax_r, const float* qmap_m,
                     const float* qmap_r, float* out, int block_size,
                     rq::Scalars s) {
  constexpr bool kLamb = KIND == kLambNorms;
  __shared__ float lut_m[kLamb ? rq::kCodebookSize : 1];
  __shared__ float lut_r[kLamb ? rq::kCodebookSize : 1];
  __shared__ float red[99];
  if (kLamb) {
    rq::load_lut(qmap_m, lut_m);
    rq::load_lut(qmap_r, lut_r);
    __syncthreads();
  }
  const size_t row = blockIdx.x;
  const size_t off = row * block_size;
  const int nvec = block_size >> 2;
  const float4* pr = reinterpret_cast<const float4*>(p + off);
  const float4* gr = reinterpret_cast<const float4*>(g + off);
  const uchar4* cmr = kLamb ? reinterpret_cast<const uchar4*>(codes_m + off) : nullptr;
  const uchar4* crr = kLamb ? reinterpret_cast<const uchar4*>(codes_r + off) : nullptr;
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
      uint8_t ce_m[4] = {0, 0, 0, 0}, ce_r[4] = {0, 0, 0, 0};
      if (kLamb) {
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

template <int KIND, int VPT>
int launch(const float* p, const float* g, const uint8_t* codes_m,
           const float* absmax_m, const uint8_t* codes_r,
           const float* absmax_r, const float* qmap_m, const float* qmap_r,
           float* out, int n_blocks, int block_size, const rq::Scalars& s,
           cudaStream_t stream) {
  const dim3 grid(n_blocks), block(rq::kThreads);
  norm_partials_kernel<KIND, VPT><<<grid, block, 0, stream>>>(
      p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r, out,
      block_size, s);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int launch_vpt(const float* p, const float* g, const uint8_t* codes_m,
               const float* absmax_m, const uint8_t* codes_r,
               const float* absmax_r, const float* qmap_m,
               const float* qmap_r, float* out, int n_blocks, int block_size,
               const rq::Scalars& s, cudaStream_t stream) {
  switch (rq_vectors_per_thread(block_size)) {
    case 1: return launch<KIND, 1>(p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r, out, n_blocks, block_size, s, stream);
    case 2: return launch<KIND, 2>(p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r, out, n_blocks, block_size, s, stream);
    case 4: return launch<KIND, 4>(p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r, out, n_blocks, block_size, s, stream);
    case 8: return launch<KIND, 8>(p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r, out, n_blocks, block_size, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
  const rq::Scalars s{lr, beta1, one_minus_beta1, beta2, one_minus_beta2,
                      eps, weight_decay, c1, c2, gnorm_scale};
  if (kind == kLarsNorms)
    return launch_vpt<kLarsNorms>(p, g, codes_m, absmax_m, codes_r, absmax_r,
                                  qmap_m, qmap_r, out, n_blocks, block_size,
                                  s, stream);
  if (kind == kLambNorms) {
    if (!codes_m || !absmax_m || !codes_r || !absmax_r || !qmap_m || !qmap_r)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_vpt<kLambNorms>(p, g, codes_m, absmax_m, codes_r, absmax_r,
                                  qmap_m, qmap_r, out, n_blocks, block_size,
                                  s, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
