// The 32-bit optimizer update of one element, for the fused update and the
// norm prologue: repro_torch/kernels/fused_update.py::update_math in the
// JAX package's order of operations, every float operation an explicitly
// rounded intrinsic (no FMA contraction, IEEE division and square root).
//
//   adam/adamw, lamb:  m2 = beta1 * m + (1 - beta1) * g
//                      r2 = beta2 * r + (1 - beta2) * g * g     (left to right)
//                      u  = (m2 / c1) / (sqrt(r2 / c2) + eps) + wd * p
//                      p2 = p - lr * u                 (adam/adamw)
//                      p2 = p - (lr * ts) * u          (lamb)
//   momentum:          m2 = beta1 * m + (g + wd * p);        p2 = p - lr * m2
//   lars:              m2 = beta1 * m + ts * (g + wd * p);   p2 = p - lr * m2
//   adagrad:           m2 = m + g * g
//                      p2 = p - lr * (g / (sqrt(m2) + eps) + wd * p)
//
// g arrives already multiplied by gnorm_scale; c1 = 1 - beta1^step and
// c2 = 1 - beta2^step are computed once per call by the wrapper (powf here
// and pow in PyTorch/XLA may differ in the last bit); ts is the block's
// trust ratio (lamb) or local lr (lars) from the norm prologue.
#pragma once

#include "common.cuh"

namespace rq {

enum Algo { kAdam = 0, kLamb = 1, kMomentum = 2, kLars = 3, kAdagrad = 4 };

template <int ALGO>
struct AlgoTraits {
  static constexpr bool kTwoStates = ALGO == kAdam || ALGO == kLamb;
  static constexpr bool kNeedsNorms = ALGO == kLamb || ALGO == kLars;
};

struct Scalars {
  float lr, beta1, one_minus_beta1, beta2, one_minus_beta2, eps, weight_decay,
      c1, c2, gnorm_scale;
};

struct Update {
  float m2, r2, p2;
};

// Adam's moments m2, r2.
__device__ __forceinline__ void adam_moments(float g, float m, float r,
                                             const Scalars& s, float& m2,
                                             float& r2) {
  m2 = __fadd_rn(__fmul_rn(s.beta1, m), __fmul_rn(s.one_minus_beta1, g));
  r2 = __fadd_rn(__fmul_rn(s.beta2, r),
                 __fmul_rn(__fmul_rn(s.one_minus_beta2, g), g));
}

// Adam's direction incl. decoupled weight decay from the bias-corrected
// moments mc = m2 / c1 and rc = r2 / c2: the pre-trust-ratio u of LAMB.
__device__ __forceinline__ float adam_direction(float p, float mc, float rc,
                                                const Scalars& s) {
  const float denom = __fadd_rn(__fsqrt_rn(rc), s.eps);
  return __fadd_rn(__fdiv_rn(mc, denom), __fmul_rn(s.weight_decay, p));
}

// The new parameter of adam/adamw (p - lr u) or lamb (p - (lr ts) u).
template <int ALGO>
__device__ __forceinline__ float adam_param(float p, float mc, float rc,
                                            float ts, const Scalars& s) {
  const float step = ALGO == kLamb ? __fmul_rn(s.lr, ts) : s.lr;
  return __fsub_rn(p, __fmul_rn(step, adam_direction(p, mc, rc, s)));
}

// Adam's moments and bias-corrected direction incl. decoupled weight
// decay: the pre-trust-ratio u of LAMB.
__device__ __forceinline__ Update adam_base(float p, float g, float m,
                                            float r, const Scalars& s,
                                            float* u) {
  Update o;
  adam_moments(g, m, r, s, o.m2, o.r2);
  *u = adam_direction(p, __fdiv_rn(o.m2, s.c1), __fdiv_rn(o.r2, s.c2), s);
  o.p2 = 0.f;
  return o;
}

// One element's update; g is already gnorm-scaled, r unused by one-state
// algorithms, ts unused by block-local ones.
template <int ALGO>
__device__ __forceinline__ Update update(float p, float g, float m, float r,
                                         float ts, const Scalars& s) {
  Update o;
  float u;
  if (ALGO == kAdam || ALGO == kLamb) {
    o = adam_base(p, g, m, r, s, &u);
    const float step = ALGO == kLamb ? __fmul_rn(s.lr, ts) : s.lr;
    o.p2 = __fsub_rn(p, __fmul_rn(step, u));
  } else if (ALGO == kMomentum || ALGO == kLars) {
    float d = __fadd_rn(g, __fmul_rn(s.weight_decay, p));
    if (ALGO == kLars) d = __fmul_rn(ts, d);
    o.m2 = __fadd_rn(__fmul_rn(s.beta1, m), d);
    o.r2 = 0.f;
    o.p2 = __fsub_rn(p, __fmul_rn(s.lr, o.m2));
  } else {  // kAdagrad
    o.m2 = __fadd_rn(m, __fmul_rn(g, g));
    o.r2 = 0.f;
    u = __fadd_rn(__fdiv_rn(g, __fadd_rn(__fsqrt_rn(o.m2), s.eps)),
                  __fmul_rn(s.weight_decay, p));
    o.p2 = __fsub_rn(p, __fmul_rn(s.lr, u));
  }
  return o;
}

}  // namespace rq
