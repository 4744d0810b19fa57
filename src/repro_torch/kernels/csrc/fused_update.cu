// Fused k-bit optimizer update: dequantize the state(s), 32-bit update in
// registers, write the parameter, requantize the state(s) per block.
//
// Replaces the TPU kernel src/repro/kernels/fused_update.py::
// _make_update_kernel (pallas_call in fused_update_pallas) with no
// sentinel output, for the six element-wise algorithms: adam and adamw
// (one update), lamb, momentum, lars and adagrad, with deterministic or
// stochastic rounding.  Two kernels: fused_update_kernel for 8-bit states
// (bits_m = bits_r = 8, the main path) and fused_update_packed_kernel for
// bit-packed 4/5/6-bit states (either slot may also be 8), whose widths are
// runtime arguments.  The sentinel output is a later slice (ROADMAP B3(e)).
//
// Bound on an H100: memory.  Per element it reads p and g (f32) and one
// code per state, and writes p and the codes: 14 B/element for the
// one-state algorithms (momentum, lars, adagrad), 16 B/element for the
// two-state ones (adam/adamw, lamb), plus 8 B of absmax per block and
// state and, for lamb/lars, 4 B of trust ratio per block, over 3.35 TB/s.
// The ~40-60 f32 operations per element (divisions, a square root, the
// 8-step binary searches in shared memory, the hash when rounding
// stochastically) stay below the f32 rate.
//
// Design: one 256-thread CTA per quantization block, so the per-block
// absmax of the new states is one CTA reduction (warp shuffles, then
// shared memory) and nothing crosses CTAs.  Each thread loads p, g and the
// codes as float4/uchar4 words (coalesced), keeps the new states in
// registers across the reduction, and stores p and the codes once: a single
// HBM pass.  The codebooks and their midpoints sit in shared memory;
// adagrad's single state uses the unsigned codebook, which the wrapper
// passes as qmap_m.  The kernel is a template on the algorithm (one- or
// two-state, trust ratio or not), on the vectors per thread and on
// stochastic rounding, so each variant carries only its own work.
//
// Stochastic rounding (paper App H) draws its uniform per element from the
// counter hash of common.cuh at the JAX package's element index
// block_offset * B + col with seed block_seed + salt (salt 0 for state 1,
// 0x9E3779B9 for state 2): exact integer arithmetic, so the codes equal
// the reference's for equal inputs.  block_seeds / block_offsets may be
// null: then every block uses `seed` and its own row index.
//
// In place: p, the code arrays and the absmax vectors are overwritten.
// Each thread reads its own elements before it writes them, and every
// thread reads a block's old absmax before the barrier inside the
// reduction, after which thread 0 writes the new one.
//
// Order of operations: update_math.cuh, held bit-exactly against the plain
// version, repro_torch/kernels/fused_update.py::fused_update_plain.
#include "update_math.cuh"

namespace {

template <int ALGO, int VPT, bool STOCH>
__global__ void __launch_bounds__(rq::kThreads)
fused_update_kernel(float* p, const float* g, uint8_t* codes_m,
                    float* absmax_m, uint8_t* codes_r, float* absmax_r,
                    const float* qmap_m, const float* qmap_r,
                    const float* tensor_scale, const int* block_seeds,
                    const int* block_offsets, int seed, int block_size,
                    rq::Scalars s) {
  constexpr bool kTwo = rq::AlgoTraits<ALGO>::kTwoStates;
  __shared__ float lut_m[rq::kCodebookSize], bounds_m[rq::kCodebookSize];
  __shared__ float lut_r[kTwo ? rq::kCodebookSize : 1];
  __shared__ float bounds_r[kTwo ? rq::kCodebookSize : 1];
  __shared__ float red[66];
  rq::load_codebook(qmap_m, lut_m, bounds_m);
  if (kTwo) rq::load_codebook(qmap_r, lut_r, bounds_r);

  const size_t row = blockIdx.x;
  const size_t off = row * block_size;
  const int nvec = block_size >> 2;
  float4* pr = reinterpret_cast<float4*>(p + off);
  const float4* gr = reinterpret_cast<const float4*>(g + off);
  uchar4* cmr = reinterpret_cast<uchar4*>(codes_m + off);
  uchar4* crr = kTwo ? reinterpret_cast<uchar4*>(codes_r + off) : nullptr;
  const float am = absmax_m[row];
  const float ar = kTwo ? absmax_r[row] : 0.f;
  const float ts = rq::AlgoTraits<ALGO>::kNeedsNorms ? tensor_scale[row] : 1.f;

  float4 m2[VPT], r2[VPT];
  float mx_m = 0.f, mx_r = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * rq::kThreads;
    if (i < nvec) {
      const float4 pv = pr[i], gv = gr[i];
      const uchar4 cm = cmr[i];
      const uchar4 cr = kTwo ? crr[i] : make_uchar4(0, 0, 0, 0);
      const float pe[4] = {pv.x, pv.y, pv.z, pv.w};
      const float ge[4] = {gv.x, gv.y, gv.z, gv.w};
      const uint8_t ce_m[4] = {cm.x, cm.y, cm.z, cm.w};
      const uint8_t ce_r[4] = {cr.x, cr.y, cr.z, cr.w};
      float pn[4], mn[4], rn[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float m = __fmul_rn(rq::decode(ce_m[c], lut_m), am);
        const float r = kTwo ? __fmul_rn(rq::decode(ce_r[c], lut_r), ar) : 0.f;
        const rq::Update o = rq::update<ALGO>(
            pe[c], __fmul_rn(ge[c], s.gnorm_scale), m, r, ts, s);
        pn[c] = o.p2;
        mn[c] = o.m2;
        rn[c] = o.r2;
      }
      pr[i] = make_float4(pn[0], pn[1], pn[2], pn[3]);
      m2[k] = make_float4(mn[0], mn[1], mn[2], mn[3]);
      r2[k] = make_float4(rn[0], rn[1], rn[2], rn[3]);
      mx_m = rq::absmax4(mx_m, m2[k]);
      if (kTwo) mx_r = rq::absmax4(mx_r, r2[k]);
    }
  }
  const float2 mx = rq::block_max2(mx_m, mx_r, red);
  const float scale_m = rq::block_scale(mx.x), scale_r = rq::block_scale(mx.y);
  const uint32_t bseed =
      static_cast<uint32_t>(block_seeds ? block_seeds[row] : seed);
  const uint32_t boff =
      static_cast<uint32_t>(block_offsets ? block_offsets[row]
                                          : static_cast<int>(row));
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = threadIdx.x + k * rq::kThreads;
    if (i < nvec) {
      const float xm[4] = {m2[k].x, m2[k].y, m2[k].z, m2[k].w};
      const float xr[4] = {r2[k].x, r2[k].y, r2[k].z, r2[k].w};
      uint8_t om[4], orr[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // element index in the block's own leaf, as uint32 (wraps)
        const uint32_t idx = boff * static_cast<uint32_t>(block_size) +
                             static_cast<uint32_t>(4 * i + c);
        const float u1 = STOCH ? rq::hash_uniform(idx, bseed + rq::kState1Salt) : 0.f;
        om[c] = static_cast<uint8_t>(
            rq::requant_code(xm[c], scale_m, lut_m, bounds_m, STOCH, u1, 255u));
        if (kTwo) {
          const float u2 = STOCH ? rq::hash_uniform(idx, bseed + rq::kState2Salt) : 0.f;
          orr[c] = static_cast<uint8_t>(
              rq::requant_code(xr[c], scale_r, lut_r, bounds_r, STOCH, u2, 255u));
        }
      }
      cmr[i] = make_uchar4(om[0], om[1], om[2], om[3]);
      if (kTwo) crr[i] = make_uchar4(orr[0], orr[1], orr[2], orr[3]);
    }
  }
  if (threadIdx.x == 0) {
    absmax_m[row] = mx.x;
    if (kTwo) absmax_r[row] = mx.y;
  }
}

// The packed variant (ROADMAP B3(d)): the same update on states stored as
// packed b-bit codes (core/lowbit/packing.py), b in {4, 5, 6, 8} per slot,
// with 2^b-entry codebooks whose midpoints are padded with +inf (so encode
// never passes max_code = 2^b - 1, and the stochastic choice is capped
// there too, as kernels/common.py::block_requantize does).
//
// Bound: memory, as above; at (4, 8) adam moves 15 B per element (p read
// and written, g read, 1/2 + 1 B of codes read and written).
//
// Design: a packed row does not split into whole bytes per float4 (4 codes
// of 5 bits are 20 bits), so the CTA stages its block's packed rows in
// shared memory (coalesced byte loads) and each thread unpacks the codes of
// its own float4 vectors from there.  The new states go to shared memory as
// f32 (the widths are runtime values, so the per-thread register arrays of
// the 8-bit kernel, sized by a template argument, are not used); after the
// absmax reduction each thread encodes its own values into one byte per
// code in shared memory, and after a barrier each thread packs whole
// output bytes, each from the codes that overlap it (rq::pack_byte).
// Shared memory per CTA, dynamic: per state 5 B per element plus the
// staged row — 23.5 KB for two states at B = 2048.
template <int ALGO, bool STOCH>
__global__ void __launch_bounds__(rq::kThreads)
fused_update_packed_kernel(float* p, const float* g, uint8_t* codes_m,
                           float* absmax_m, uint8_t* codes_r,
                           float* absmax_r, const float* qmap_m,
                           const float* qmap_r, const float* tensor_scale,
                           const int* block_seeds, const int* block_offsets,
                           int seed, int block_size, int bits_m, int bits_r,
                           rq::Scalars s) {
  constexpr bool kTwo = rq::AlgoTraits<ALGO>::kTwoStates;
  constexpr int kStates = kTwo ? 2 : 1;
  __shared__ float lut_m[rq::kCodebookSize], bounds_m[rq::kCodebookSize];
  __shared__ float lut_r[kTwo ? rq::kCodebookSize : 1];
  __shared__ float bounds_r[kTwo ? rq::kCodebookSize : 1];
  __shared__ float red[66];
  RQ_DYNAMIC_SHARED(float4, dyn);

  const size_t row = blockIdx.x;
  const size_t off = row * block_size;
  const int nvec = block_size >> 2;
  const int wm = block_size * bits_m / 8, wr = block_size * bits_r / 8;
  // dynamic shared memory: new states (f32), new codes (a byte each), the
  // staged packed rows (+1 byte each for unpack_code)
  float4* m2s = dyn;
  float4* r2s = dyn + nvec;
  uint8_t* new_m = reinterpret_cast<uint8_t*>(dyn + kStates * nvec);
  uint8_t* new_r = new_m + block_size;
  uint8_t* old_m = new_m + kStates * block_size;
  uint8_t* old_r = old_m + wm + 1;
  const uint8_t* src_m = codes_m + row * wm;
  const uint8_t* src_r = kTwo ? codes_r + row * wr : nullptr;
  for (int k = threadIdx.x; k <= wm; k += rq::kThreads)
    old_m[k] = k < wm ? src_m[k] : 0;
  if (kTwo)
    for (int k = threadIdx.x; k <= wr; k += rq::kThreads)
      old_r[k] = k < wr ? src_r[k] : 0;
  // (load_codebook's barriers also publish the staged rows)
  rq::load_codebook(qmap_m, lut_m, bounds_m, 1 << bits_m);
  if (kTwo) rq::load_codebook(qmap_r, lut_r, bounds_r, 1 << bits_r);

  float4* pr = reinterpret_cast<float4*>(p + off);
  const float4* gr = reinterpret_cast<const float4*>(g + off);
  const float am = absmax_m[row];
  const float ar = kTwo ? absmax_r[row] : 0.f;
  const float ts = rq::AlgoTraits<ALGO>::kNeedsNorms ? tensor_scale[row] : 1.f;

  float mx_m = 0.f, mx_r = 0.f;
  for (int i = threadIdx.x; i < nvec; i += rq::kThreads) {
    const float4 pv = pr[i], gv = gr[i];
    const float pe[4] = {pv.x, pv.y, pv.z, pv.w};
    const float ge[4] = {gv.x, gv.y, gv.z, gv.w};
    float pn[4], mn[4], rn[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t j = 4 * i + c;
      const float m =
          __fmul_rn(rq::decode(rq::unpack_code(old_m, j, bits_m), lut_m), am);
      const float r =
          kTwo ? __fmul_rn(rq::decode(rq::unpack_code(old_r, j, bits_r),
                                      lut_r), ar)
               : 0.f;
      const rq::Update o = rq::update<ALGO>(
          pe[c], __fmul_rn(ge[c], s.gnorm_scale), m, r, ts, s);
      pn[c] = o.p2;
      mn[c] = o.m2;
      rn[c] = o.r2;
    }
    pr[i] = make_float4(pn[0], pn[1], pn[2], pn[3]);
    const float4 vm = make_float4(mn[0], mn[1], mn[2], mn[3]);
    m2s[i] = vm;
    mx_m = rq::absmax4(mx_m, vm);
    if (kTwo) {
      const float4 vr = make_float4(rn[0], rn[1], rn[2], rn[3]);
      r2s[i] = vr;
      mx_r = rq::absmax4(mx_r, vr);
    }
  }
  const float2 mx = rq::block_max2(mx_m, mx_r, red);
  const float scale_m = rq::block_scale(mx.x), scale_r = rq::block_scale(mx.y);
  const uint32_t bseed =
      static_cast<uint32_t>(block_seeds ? block_seeds[row] : seed);
  const uint32_t boff =
      static_cast<uint32_t>(block_offsets ? block_offsets[row]
                                          : static_cast<int>(row));
  const uint32_t max_m = (1u << bits_m) - 1u, max_r = (1u << bits_r) - 1u;
  for (int i = threadIdx.x; i < nvec; i += rq::kThreads) {
    const float4 vm = m2s[i];
    const float4 vr = kTwo ? r2s[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float xm[4] = {vm.x, vm.y, vm.z, vm.w};
    const float xr[4] = {vr.x, vr.y, vr.z, vr.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t idx = boff * static_cast<uint32_t>(block_size) +
                           static_cast<uint32_t>(4 * i + c);
      const float u1 = STOCH ? rq::hash_uniform(idx, bseed + rq::kState1Salt) : 0.f;
      new_m[4 * i + c] = static_cast<uint8_t>(rq::requant_code(
          xm[c], scale_m, lut_m, bounds_m, STOCH, u1, max_m));
      if (kTwo) {
        const float u2 = STOCH ? rq::hash_uniform(idx, bseed + rq::kState2Salt) : 0.f;
        new_r[4 * i + c] = static_cast<uint8_t>(rq::requant_code(
            xr[c], scale_r, lut_r, bounds_r, STOCH, u2, max_r));
      }
    }
  }
  __syncthreads();
  uint8_t* dst_m = codes_m + row * wm;
  for (int k = threadIdx.x; k < wm; k += rq::kThreads)
    dst_m[k] = rq::pack_byte(new_m, k, bits_m);
  if (kTwo) {
    uint8_t* dst_r = codes_r + row * wr;
    for (int k = threadIdx.x; k < wr; k += rq::kThreads)
      dst_r[k] = rq::pack_byte(new_r, k, bits_r);
  }
  if (threadIdx.x == 0) {
    absmax_m[row] = mx.x;
    if (kTwo) absmax_r[row] = mx.y;
  }
}

struct Args {
  float* p;
  const float* g;
  uint8_t* codes_m;
  float* absmax_m;
  uint8_t* codes_r;
  float* absmax_r;
  const float* qmap_m;
  const float* qmap_r;
  const float* tensor_scale;
  const int* block_seeds;
  const int* block_offsets;
  int seed, n_blocks, block_size, bits_m, bits_r;
  rq::Scalars s;
};

template <int ALGO, int VPT, bool STOCH>
int launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.n_blocks), block(rq::kThreads);
  fused_update_kernel<ALGO, VPT, STOCH><<<grid, block, 0, stream>>>(
      a.p, a.g, a.codes_m, a.absmax_m, a.codes_r, a.absmax_r, a.qmap_m,
      a.qmap_r, a.tensor_scale, a.block_seeds, a.block_offsets, a.seed,
      a.block_size, a.s);
  return static_cast<int>(cudaGetLastError());
}

template <int ALGO, bool STOCH>
int launch_vpt(const Args& a, cudaStream_t stream) {
  switch (rq_vectors_per_thread(a.block_size)) {
    case 1: return launch<ALGO, 1, STOCH>(a, stream);
    case 2: return launch<ALGO, 2, STOCH>(a, stream);
    case 4: return launch<ALGO, 4, STOCH>(a, stream);
    case 8: return launch<ALGO, 8, STOCH>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int ALGO>
int launch_algo(const Args& a, bool stochastic, cudaStream_t stream) {
  return stochastic ? launch_vpt<ALGO, true>(a, stream)
                    : launch_vpt<ALGO, false>(a, stream);
}

// Dynamic shared memory of fused_update_packed_kernel (see its layout).
size_t packed_smem_bytes(const Args& a, bool two) {
  const size_t states = two ? 2 : 1;
  const size_t rows = (a.block_size * a.bits_m / 8 + 1) +
                      (two ? a.block_size * a.bits_r / 8 + 1 : 0);
  return (states * a.block_size * 5 + rows + 15) / 16 * 16;
}

template <int ALGO, bool STOCH>
int launch_packed(const Args& a, cudaStream_t stream) {
  const size_t smem =
      packed_smem_bytes(a, rq::AlgoTraits<ALGO>::kTwoStates);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_update_packed_kernel<ALGO, STOCH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(a.n_blocks), block(rq::kThreads);
  fused_update_packed_kernel<ALGO, STOCH><<<grid, block, smem, stream>>>(
      a.p, a.g, a.codes_m, a.absmax_m, a.codes_r, a.absmax_r, a.qmap_m,
      a.qmap_r, a.tensor_scale, a.block_seeds, a.block_offsets, a.seed,
      a.block_size, a.bits_m, a.bits_r, a.s);
  return static_cast<int>(cudaGetLastError());
}

template <int ALGO>
int launch_packed_algo(const Args& a, bool stochastic, cudaStream_t stream) {
  return stochastic ? launch_packed<ALGO, true>(a, stream)
                    : launch_packed<ALGO, false>(a, stream);
}

bool valid_bits(int b) { return b == 4 || b == 5 || b == 6 || b == 8; }

}  // namespace

// algo: rq::Algo (adam and adamw are both kAdam).  codes_r, absmax_r and
// qmap_r are null for one-state algorithms, tensor_scale for block-local
// ones; block_seeds and block_offsets may be null (see above).
extern "C" int fused_update(
    int algo, float* p, const float* g, uint8_t* codes_m, float* absmax_m,
    uint8_t* codes_r, float* absmax_r, const float* qmap_m,
    const float* qmap_r, const float* tensor_scale, const int* block_seeds,
    const int* block_offsets, int stochastic, int seed, int n_blocks,
    int block_size, float lr, float beta1, float one_minus_beta1, float beta2,
    float one_minus_beta2, float eps, float weight_decay, float c1, float c2,
    float gnorm_scale, cudaStream_t stream) {
  if (n_blocks == 0) return 0;
  const Args a{p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r,
               tensor_scale, block_seeds, block_offsets, seed, n_blocks,
               block_size, 8, 8,
               rq::Scalars{lr, beta1, one_minus_beta1, beta2, one_minus_beta2,
                           eps, weight_decay, c1, c2, gnorm_scale}};
  const bool two = algo == rq::kAdam || algo == rq::kLamb;
  const bool norms = algo == rq::kLamb || algo == rq::kLars;
  if ((two && (!codes_r || !absmax_r || !qmap_r)) ||
      (norms && !tensor_scale))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool sr = stochastic != 0;
  switch (algo) {
    case rq::kAdam: return launch_algo<rq::kAdam>(a, sr, stream);
    case rq::kLamb: return launch_algo<rq::kLamb>(a, sr, stream);
    case rq::kMomentum: return launch_algo<rq::kMomentum>(a, sr, stream);
    case rq::kLars: return launch_algo<rq::kLars>(a, sr, stream);
    case rq::kAdagrad: return launch_algo<rq::kAdagrad>(a, sr, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The packed variant: as fused_update, with codes_m / codes_r stored as
// packed bits_m- / bits_r-bit rows of block_size * bits / 8 bytes, and
// qmaps of 2^bits entries.  Widths in {4, 5, 6, 8}; block_size a multiple
// of 8 and at most rq::kMaxBlock.
extern "C" int fused_update_packed(
    int algo, float* p, const float* g, uint8_t* codes_m, float* absmax_m,
    uint8_t* codes_r, float* absmax_r, const float* qmap_m,
    const float* qmap_r, const float* tensor_scale, const int* block_seeds,
    const int* block_offsets, int stochastic, int seed, int n_blocks,
    int block_size, int bits_m, int bits_r, float lr, float beta1,
    float one_minus_beta1, float beta2, float one_minus_beta2, float eps,
    float weight_decay, float c1, float c2, float gnorm_scale,
    cudaStream_t stream) {
  if (n_blocks == 0) return 0;
  const Args a{p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r,
               tensor_scale, block_seeds, block_offsets, seed, n_blocks,
               block_size, bits_m, bits_r,
               rq::Scalars{lr, beta1, one_minus_beta1, beta2, one_minus_beta2,
                           eps, weight_decay, c1, c2, gnorm_scale}};
  const bool two = algo == rq::kAdam || algo == rq::kLamb;
  const bool norms = algo == rq::kLamb || algo == rq::kLars;
  if ((two && (!codes_r || !absmax_r || !qmap_r || !valid_bits(bits_r))) ||
      (norms && !tensor_scale) || !valid_bits(bits_m) || block_size % 8 ||
      block_size <= 0 || block_size > rq::kMaxBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool sr = stochastic != 0;
  switch (algo) {
    case rq::kAdam: return launch_packed_algo<rq::kAdam>(a, sr, stream);
    case rq::kLamb: return launch_packed_algo<rq::kLamb>(a, sr, stream);
    case rq::kMomentum: return launch_packed_algo<rq::kMomentum>(a, sr, stream);
    case rq::kLars: return launch_packed_algo<rq::kLars>(a, sr, stream);
    case rq::kAdagrad: return launch_packed_algo<rq::kAdagrad>(a, sr, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
