// Fused 8-bit Adam/AdamW update: dequantize both states, 32-bit update in
// registers, write the parameter, requantize both states per block.
//
// Replaces the TPU kernel src/repro/kernels/fused_update.py::
// _make_update_kernel (pallas_call in fused_update_pallas) for algo
// adam/adamw at 8/8 bits, deterministic rounding, no sentinel output, one
// segment.  Stochastic rounding, the other algorithms, packed sub-byte
// states and the sentinel are later slices (ROADMAP B3(b)-(e)).
//
// Bound on an H100: memory.  Per element it reads p and g (f32) and one
// code of each state, and writes p and both codes: 4+4+1+1 in, 4+1+1 out =
// 16 B/element (plus 16 B of absmax per block), over 3.35 TB/s.  The ~40
// f32 operations per element (two divisions, a square root, two 8-step
// binary searches in shared memory) stay below the f32 rate.
//
// Design: one 256-thread CTA per quantization block, so the per-block
// absmax of both new states is one CTA reduction (warp shuffles, then
// shared memory) and nothing crosses CTAs.  Each thread loads p, g and the
// codes as float4/uchar4 words (coalesced), keeps the new states in
// registers across the reduction, and stores p and the codes once: a single
// HBM pass.  Both codebooks and their midpoints sit in shared memory.
//
// In place: p, both code arrays and both absmax vectors are overwritten.
// Each thread reads its own elements before it writes them, and every
// thread reads a block's old absmax before the barrier inside the
// reduction, after which thread 0 writes the new one.
//
// Order of operations (held bit-exactly against the plain version, which
// is repro_torch/kernels/fused_update.py::update_math):
//   g  = g * gnorm_scale
//   m2 = beta1 * m + (1 - beta1) * g
//   r2 = beta2 * r + (1 - beta2) * g * g          (left to right)
//   u  = (m2 / c1) / (sqrt(r2 / c2) + eps) + weight_decay * p
//   p  = p - lr * u
// with c1 = 1 - beta1^step and c2 = 1 - beta2^step computed once per call
// by the wrapper, since powf here and pow in PyTorch/XLA may differ in the
// last bit.
#include "common.cuh"

namespace {

struct AdamScalars {
  float lr, beta1, one_minus_beta1, beta2, one_minus_beta2, eps, weight_decay,
      c1, c2, gnorm_scale;
};

struct Moments {
  float m2, r2, p2;
};

__device__ __forceinline__ Moments adam_math(float p, float g, float m,
                                             float r, const AdamScalars& s) {
  g = __fmul_rn(g, s.gnorm_scale);
  Moments o;
  o.m2 = __fadd_rn(__fmul_rn(s.beta1, m), __fmul_rn(s.one_minus_beta1, g));
  o.r2 = __fadd_rn(__fmul_rn(s.beta2, r),
                   __fmul_rn(__fmul_rn(s.one_minus_beta2, g), g));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(o.r2, s.c2)), s.eps);
  const float u = __fadd_rn(__fdiv_rn(__fdiv_rn(o.m2, s.c1), denom),
                            __fmul_rn(s.weight_decay, p));
  o.p2 = __fsub_rn(p, __fmul_rn(s.lr, u));
  return o;
}

template <int VPT>
__global__ void __launch_bounds__(rq::kThreads)
adam8_update_kernel(float* p, const float* g, uint8_t* codes_m, float* absmax_m,
                    uint8_t* codes_r, float* absmax_r, const float* qmap_m,
                    const float* qmap_r, int block_size, AdamScalars s) {
  __shared__ float lut_m[rq::kCodebookSize], bounds_m[rq::kCodebookSize];
  __shared__ float lut_r[rq::kCodebookSize], bounds_r[rq::kCodebookSize];
  __shared__ float red[66];
  rq::load_codebook(qmap_m, lut_m, bounds_m);
  rq::load_codebook(qmap_r, lut_r, bounds_r);

  const size_t row = blockIdx.x;
  const size_t off = row * block_size;
  const int nvec = block_size >> 2;
  float4* pr = reinterpret_cast<float4*>(p + off);
  const float4* gr = reinterpret_cast<const float4*>(g + off);
  uchar4* cmr = reinterpret_cast<uchar4*>(codes_m + off);
  uchar4* crr = reinterpret_cast<uchar4*>(codes_r + off);
  const float am = absmax_m[row], ar = absmax_r[row];

  float4 m2[VPT], r2[VPT];
  float mx_m = 0.f, mx_r = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * rq::kThreads;
    if (i < nvec) {
      const float4 pv = pr[i], gv = gr[i];
      const uchar4 cm = cmr[i], cr = crr[i];
      float4 pn;
      Moments o;
      o = adam_math(pv.x, gv.x, __fmul_rn(rq::decode(cm.x, lut_m), am),
                    __fmul_rn(rq::decode(cr.x, lut_r), ar), s);
      m2[k].x = o.m2; r2[k].x = o.r2; pn.x = o.p2;
      o = adam_math(pv.y, gv.y, __fmul_rn(rq::decode(cm.y, lut_m), am),
                    __fmul_rn(rq::decode(cr.y, lut_r), ar), s);
      m2[k].y = o.m2; r2[k].y = o.r2; pn.y = o.p2;
      o = adam_math(pv.z, gv.z, __fmul_rn(rq::decode(cm.z, lut_m), am),
                    __fmul_rn(rq::decode(cr.z, lut_r), ar), s);
      m2[k].z = o.m2; r2[k].z = o.r2; pn.z = o.p2;
      o = adam_math(pv.w, gv.w, __fmul_rn(rq::decode(cm.w, lut_m), am),
                    __fmul_rn(rq::decode(cr.w, lut_r), ar), s);
      m2[k].w = o.m2; r2[k].w = o.r2; pn.w = o.p2;
      pr[i] = pn;
      mx_m = rq::absmax4(mx_m, m2[k]);
      mx_r = rq::absmax4(mx_r, r2[k]);
    }
  }
  const float2 mx = rq::block_max2(mx_m, mx_r, red);
  const float scale_m = rq::block_scale(mx.x), scale_r = rq::block_scale(mx.y);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * rq::kThreads;
    if (i < nvec) {
      cmr[i] = rq::encode4(m2[k], scale_m, bounds_m);
      crr[i] = rq::encode4(r2[k], scale_r, bounds_r);
    }
  }
  if (threadIdx.x == 0) {
    absmax_m[row] = mx.x;
    absmax_r[row] = mx.y;
  }
}

}  // namespace

extern "C" int fused_adam8_update(
    float* p, const float* g, uint8_t* codes_m, float* absmax_m,
    uint8_t* codes_r, float* absmax_r, const float* qmap_m,
    const float* qmap_r, int n_blocks, int block_size, float lr, float beta1,
    float one_minus_beta1, float beta2, float one_minus_beta2, float eps,
    float weight_decay, float c1, float c2, float gnorm_scale,
    cudaStream_t stream) {
  if (n_blocks == 0) return 0;
  const AdamScalars s{lr, beta1, one_minus_beta1, beta2, one_minus_beta2,
                      eps, weight_decay, c1, c2, gnorm_scale};
  const dim3 grid(n_blocks), block(rq::kThreads);
  switch (rq_vectors_per_thread(block_size)) {
    case 1: adam8_update_kernel<1><<<grid, block, 0, stream>>>(p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r, block_size, s); break;
    case 2: adam8_update_kernel<2><<<grid, block, 0, stream>>>(p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r, block_size, s); break;
    case 4: adam8_update_kernel<4><<<grid, block, 0, stream>>>(p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r, block_size, s); break;
    case 8: adam8_update_kernel<8><<<grid, block, 0, stream>>>(p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r, block_size, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
