// Fused k-bit optimizer update: dequantize the state(s), 32-bit update in
// registers, write the parameter, requantize the state(s) per block.
//
// Replaces the TPU kernel src/repro/kernels/fused_update.py::
// _make_update_kernel (pallas_call in fused_update_pallas), for the six
// element-wise algorithms: adam and adamw (one update), lamb, momentum,
// lars and adagrad, with deterministic or stochastic rounding, with or
// without the numerics sentinel's output.  Two kernels: fused_update_kernel
// for 8-bit states (bits_m = bits_r = 8, the main path) and
// fused_update_packed_kernel for bit-packed 4/5/6-bit states (either slot
// may also be 8), whose widths are runtime arguments.
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
// Design of the 8-bit kernel (the packed kernel's is below): one
// 256-thread CTA per quantization block, so the per-block
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
// The sentinel (ROADMAP B3(e), template flag SENT; the reference's
// sentinel=True, fused_update.py:308-380): each block also writes its 8
// health counts, fused_update.py::HEALTH_SLOTS order — nonfinite raw
// gradient elements (as loaded, before gnorm_scale: inf * 0 would hide
// one), nonfinite new parameters, nonfinite new absmax per state, new codes
// at a codebook edge (0 or 2^bits - 1, before packing) per state, and new
// absmax past ABSMAX_OVERFLOW_THRESHOLD (1e30) per state — counted on
// values the thread already holds in registers or shared memory, in the
// same single pass.  Each thread keeps four integer counters packed two to
// a word (16 bits each: a block holds at most 8192 elements); after the
// encode loop one CTA reduction of the two words (rq::block_sum2) sums them
// exactly, and thread 0 adds the absmax slots and stores the block's row:
// the only extra traffic is the (n_blocks, 8) f32 store, 32 B per block
// (0.2% of the 8-bit update's bytes at B = 2048).  SENT = false compiles
// to the kernel without it.  The plain version is
// fused_update.py::health_rows.
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

// Sentinel counts of a thread, two 16-bit counts to a word:
// n[0] = nonfinite g | nonfinite new p << 16, n[1] = edge m | edge r << 16.
constexpr int kHigh = 1 << 16;

// Thread 0's store of a block's health row (HEALTH_SLOTS order): the
// CTA-summed counts n and the absmax slots of the new absmax mx.x (m) and
// mx.y (r; two-state only).
template <bool TWO>
__device__ __forceinline__ void store_health(float* health, size_t row,
                                             const int (&n)[2], float2 mx) {
  const float nf_m = rq::is_finite(mx.x) ? 0.f : 1.f;
  const float nf_r = TWO && !rq::is_finite(mx.y) ? 1.f : 0.f;
  const float ov_m = rq::is_finite(mx.x) && mx.x > 1e30f ? 1.f : 0.f;
  const float ov_r = TWO && rq::is_finite(mx.y) && mx.y > 1e30f ? 1.f : 0.f;
  float4* h = reinterpret_cast<float4*>(health + row * 8);
  h[0] = make_float4(static_cast<float>(n[0] & 0xFFFF),
                     static_cast<float>(n[0] >> 16), nf_m, nf_r);
  h[1] = make_float4(static_cast<float>(n[1] & 0xFFFF),
                     static_cast<float>(n[1] >> 16), ov_m, ov_r);
}

template <int ALGO, int VPT, bool STOCH, bool SENT>
__global__ void __launch_bounds__(rq::kThreads)
fused_update_kernel(float* p, const float* g, uint8_t* codes_m,
                    float* absmax_m, uint8_t* codes_r, float* absmax_r,
                    const float* qmap_m, const float* qmap_r,
                    const float* tensor_scale, const int* block_seeds,
                    const int* block_offsets, float* health, int seed,
                    int block_size, rq::Scalars s) {
  constexpr bool kTwo = rq::AlgoTraits<ALGO>::kTwoStates;
  __shared__ float lut_m[rq::kCodebookSize], bounds_m[rq::kCodebookSize];
  __shared__ float lut_r[kTwo ? rq::kCodebookSize : 1];
  __shared__ float bounds_r[kTwo ? rq::kCodebookSize : 1];
  __shared__ float red[66];
  __shared__ int hred[SENT ? 64 : 1];
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
  int cnt[2] = {0, 0};          // sentinel counts (see kHigh)
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
        if (SENT)
          cnt[0] += (rq::is_finite(ge[c]) ? 0 : 1) +
                    (rq::is_finite(o.p2) ? 0 : kHigh);
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
        if (SENT) cnt[1] += om[c] == 0 || om[c] == 255 ? 1 : 0;
        if (kTwo) {
          const float u2 = STOCH ? rq::hash_uniform(idx, bseed + rq::kState2Salt) : 0.f;
          orr[c] = static_cast<uint8_t>(
              rq::requant_code(xr[c], scale_r, lut_r, bounds_r, STOCH, u2, 255u));
          if (SENT) cnt[1] += orr[c] == 0 || orr[c] == 255 ? kHigh : 0;
        }
      }
      cmr[i] = make_uchar4(om[0], om[1], om[2], om[3]);
      if (kTwo) crr[i] = make_uchar4(orr[0], orr[1], orr[2], orr[3]);
    }
  }
  if (SENT) rq::block_sum2(cnt, hred);
  if (threadIdx.x == 0) {
    absmax_m[row] = mx.x;
    if (kTwo) absmax_r[row] = mx.y;
    if (SENT) store_health<kTwo>(health, row, cnt, mx);
  }
}

// The packed variant (ROADMAP B3(d)): the same update on states stored as
// packed b-bit codes (core/lowbit/packing.py), b in {4, 5, 6, 8} per slot,
// with 2^b-entry codebooks; encode never passes max_code = 2^b - 1 (the
// +inf padding of kernels/common.py::padded_bounds, ROADMAP C3), and the
// stochastic choice is capped there too.
//
// Bound: memory, as above; at (4, 8) adam moves 15 B per element (p read
// and written, g read, 1/2 + 1 B of codes read and written): 0.376 ms for
// the main path's 40960 x 2048 leaf at 3.35 TB/s.
//
// Design: a streaming kernel.
//   * Each thread owns one group of 8 consecutive elements of a block
//     (thread v: elements 8v .. 8v + 7; a CTA of THREADS = 256, 512 or
//     1024 threads, the fewest that cover the block).  The packed rows are
//     MSB-first bitstreams, so a group's 8 codes are exactly b whole bytes:
//     the thread unpacks its old codes in registers with shifts
//     (rq::load_group), keeps its new states in registers across the
//     absmax reduction, packs its 8 new codes into b bytes in registers
//     and stores them in the widest words the alignment allows
//     (rq::store_group).  Every quantity that depends on the mapping of
//     elements to threads is order-free: the absmax is a NaN-propagating
//     max, the sentinel counts are integers, the stochastic uniform is
//     indexed by the element's position in its leaf.
//   * Encode: the midpoints in Eytzinger order (rq::encode_tree, exactly b
//     steps, the first levels free of bank conflicts), specialised per
//     width (encode_group, one uniform switch per group and state).
//   * CTAs walk the blocks (block blockIdx.x, then + gridDim.x, ...); the
//     grid is 16 waves of the CTAs resident at once, from the card's SM
//     count (fused_update_packed_ctas, rq_walk_ctas): each CTA walks a few
//     blocks (3.9 at the main path's 40960) and loads the codebooks and
//     midpoints once for them.
//   * A two-slot ring of shared-memory stages, each one block's p and g
//     rows and both packed rows, filled by 16-byte cp.async pieces
//     (rq::stage_packed_row for the codes, whose rows need not start on a
//     16-byte boundary): the next block's copies are in flight while the
//     current block updates, reduces its absmax and encodes.  A stage is
//     refilled with the block two ahead right after the reduction's first
//     barrier, by which every thread has read it.
// Shared memory per CTA: dynamic 2 x (8 B + staged packed rows) — 38,976
// bytes for adam at B = 2048, (4, 8) — plus 4 KB of codebooks and
// midpoints.  Resident CTAs per SM: 5 of 256 threads (the launch bound
// caps registers at 48; 5 x 43.6 KB of shared memory fit in an H100 SM's
// 228 KB at (4, 8)), 2 of 512 and 1 of 1024 (64 registers).
template <int THREADS>
constexpr int packed_ctas_per_sm() {
  return THREADS == 256 ? 5 : 1024 / THREADS;
}

// Bytes of one stage of the packed kernel's ring (a multiple of 16).
__host__ __device__ inline int packed_stage_bytes(int block_size, int wm,
                                                  int wr) {
  return 8 * block_size + rq::staged_row_bytes(wm) +
         (wr ? rq::staged_row_bytes(wr) : 0);
}

// Encode a group's 8 new values x of one state at BITS bits (x / scale,
// the nearest code, with a uniform from element idx0 + c the stochastic
// choice) into load_group's layout; edge counts the codes at 0 or
// 2^BITS - 1.
template <int BITS, bool STOCH>
__device__ __forceinline__ uint64_t encode_group_bits(
    const float (&x)[8], float scale, const float* lut, const float* tree,
    uint32_t idx0, uint32_t seed, int& edge) {
  constexpr uint32_t kMax = (1u << BITS) - 1u;
  uint64_t v = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float xn = __fdiv_rn(x[c], scale);
    uint32_t code = rq::encode_tree<BITS>(xn, tree);
    if (STOCH)
      code = rq::stochastic_code(xn, code, lut,
                                 rq::hash_uniform(idx0 + c, seed), kMax);
    v = (v << BITS) | code;
    edge += code == 0 || code == kMax ? 1 : 0;
  }
  return v;
}

template <bool STOCH>
__device__ __forceinline__ uint64_t encode_group(
    int bits, const float (&x)[8], float scale, const float* lut,
    const float* tree, uint32_t idx0, uint32_t seed, int& edge) {
  switch (bits) {
    case 4:
      return encode_group_bits<4, STOCH>(x, scale, lut, tree, idx0, seed,
                                         edge);
    case 5:
      return encode_group_bits<5, STOCH>(x, scale, lut, tree, idx0, seed,
                                         edge);
    case 6:
      return encode_group_bits<6, STOCH>(x, scale, lut, tree, idx0, seed,
                                         edge);
    default:
      return encode_group_bits<8, STOCH>(x, scale, lut, tree, idx0, seed,
                                         edge);
  }
}

template <int ALGO, int THREADS, bool STOCH, bool SENT>
__global__ void __launch_bounds__(THREADS, packed_ctas_per_sm<THREADS>())
fused_update_packed_kernel(float* p, const float* g, uint8_t* codes_m,
                           float* absmax_m, uint8_t* codes_r,
                           float* absmax_r, const float* qmap_m,
                           const float* qmap_r, const float* tensor_scale,
                           const int* block_seeds, const int* block_offsets,
                           float* health, int seed, int n_blocks,
                           int block_size, int bits_m, int bits_r,
                           rq::Scalars s) {
  constexpr bool kTwo = rq::AlgoTraits<ALGO>::kTwoStates;
  __shared__ float lut_m[rq::kCodebookSize], tree_m[rq::kCodebookSize];
  __shared__ float lut_r[kTwo ? rq::kCodebookSize : 1];
  __shared__ float tree_r[kTwo ? rq::kCodebookSize : 1];
  __shared__ float red[66];
  __shared__ int hred[SENT ? 64 : 1];
  RQ_DYNAMIC_SHARED(float4, dyn);

  const int bsz = block_size, nvec = bsz >> 2;
  const int wm = bsz * bits_m / 8, wr = kTwo ? bsz * bits_r / 8 : 0;
  const int stage_bytes = packed_stage_bytes(bsz, wm, wr);
  const size_t nb = static_cast<size_t>(n_blocks);
  const size_t stride = gridDim.x;
  uint8_t* ring = reinterpret_cast<uint8_t*>(dyn);
  // issue (and commit, also when empty) the copies of block `row` into
  // ring slot `slot`: p, g, then the packed rows
  auto stage = [&](size_t row, int slot) {
    if (row < nb) {
      uint8_t* dst = ring + slot * stage_bytes;
      const float4* sp = reinterpret_cast<const float4*>(p + row * bsz);
      const float4* sg = reinterpret_cast<const float4*>(g + row * bsz);
      float4* d = reinterpret_cast<float4*>(dst);
      for (int c = threadIdx.x; c < nvec; c += THREADS) {
        cp_async_16(d + c, sp + c, true);
        cp_async_16(d + nvec + c, sg + c, true);
      }
      rq::stage_packed_row(dst + 8 * bsz, codes_m, row * wm, wm, nb * wm);
      if (kTwo)
        rq::stage_packed_row(dst + 8 * bsz + rq::staged_row_bytes(wm),
                             codes_r, row * wr, wr, nb * wr);
    }
    cp_async_commit();
  };
  size_t row = blockIdx.x;
  stage(row, 0);
  stage(row + stride, 1);
  rq::load_codebook_tree(qmap_m, lut_m, tree_m, bits_m);
  if (kTwo) rq::load_codebook_tree(qmap_r, lut_r, tree_r, bits_r);
  const uint32_t max_m = (1u << bits_m) - 1u;
  const uint32_t max_r = kTwo ? (1u << bits_r) - 1u : 0u;
  const int v = threadIdx.x;          // this thread's group
  const bool live = 8 * v < bsz;

  for (int slot = 0; row < nb; row += stride, slot ^= 1) {
    const float am = absmax_m[row];
    const float ar = kTwo ? absmax_r[row] : 0.f;
    const float ts =
        rq::AlgoTraits<ALGO>::kNeedsNorms ? tensor_scale[row] : 1.f;
    cp_async_wait<1>();   // this block's stage (the next one may still fly)
    __syncthreads();
    const uint8_t* st = ring + slot * stage_bytes;
    float xm[8], xr[8];   // the new states, kept across the absmax
    float mx_m = 0.f, mx_r = 0.f;
    int cnt[2] = {0, 0};  // sentinel counts (see kHigh)
    if (live) {
      const float4* sp = reinterpret_cast<const float4*>(st);
      const float4* sg = sp + nvec;
      const uint64_t om = rq::load_group(
          st + 8 * bsz + ((row * wm) & 15) + bits_m * v, bits_m);
      const uint64_t orr =
          kTwo ? rq::load_group(st + 8 * bsz + rq::staged_row_bytes(wm) +
                                    ((row * wr) & 15) + bits_r * v,
                                bits_r)
               : 0u;
      const float4 p0 = sp[2 * v], p1 = sp[2 * v + 1];
      const float4 g0 = sg[2 * v], g1 = sg[2 * v + 1];
      const float pe[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float ge[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      float pn[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint32_t cm =
            static_cast<uint32_t>(om >> (bits_m * (7 - c))) & max_m;
        const float m = __fmul_rn(rq::decode(cm, lut_m), am);
        float r = 0.f;
        if (kTwo) {
          const uint32_t cr =
              static_cast<uint32_t>(orr >> (bits_r * (7 - c))) & max_r;
          r = __fmul_rn(rq::decode(cr, lut_r), ar);
        }
        const rq::Update o = rq::update<ALGO>(
            pe[c], __fmul_rn(ge[c], s.gnorm_scale), m, r, ts, s);
        pn[c] = o.p2;
        xm[c] = o.m2;
        xr[c] = o.r2;
        mx_m = rq::nanmax(mx_m, fabsf(o.m2));
        if (kTwo) mx_r = rq::nanmax(mx_r, fabsf(o.r2));
        if (SENT)
          cnt[0] += (rq::is_finite(ge[c]) ? 0 : 1) +
                    (rq::is_finite(o.p2) ? 0 : kHigh);
      }
      float4* pr = reinterpret_cast<float4*>(p + row * bsz);
      pr[2 * v] = make_float4(pn[0], pn[1], pn[2], pn[3]);
      pr[2 * v + 1] = make_float4(pn[4], pn[5], pn[6], pn[7]);
    }
    // every thread has read this stage before the reduction's first
    // barrier: refill it with the block two ahead
    const float2 mx = rq::block_max2(mx_m, mx_r, red);
    stage(row + 2 * stride, slot);
    if (live) {
      const uint32_t bseed =
          static_cast<uint32_t>(block_seeds ? block_seeds[row] : seed);
      const uint32_t boff =
          static_cast<uint32_t>(block_offsets ? block_offsets[row]
                                              : static_cast<int>(row));
      // element index in the block's own leaf, as uint32 (wraps)
      const uint32_t idx0 = boff * static_cast<uint32_t>(bsz) +
                            static_cast<uint32_t>(8 * v);
      int edge_m = 0, edge_r = 0;
      const uint64_t nm = encode_group<STOCH>(
          bits_m, xm, rq::block_scale(mx.x), lut_m, tree_m, idx0,
          bseed + rq::kState1Salt, edge_m);
      rq::store_group(codes_m + row * wm + bits_m * v, nm, bits_m);
      if (kTwo) {
        const uint64_t nr = encode_group<STOCH>(
            bits_r, xr, rq::block_scale(mx.y), lut_r, tree_r, idx0,
            bseed + rq::kState2Salt, edge_r);
        rq::store_group(codes_r + row * wr + bits_r * v, nr, bits_r);
      }
      if (SENT) cnt[1] += edge_m + edge_r * kHigh;
    }
    if (SENT) rq::block_sum2(cnt, hred);
    if (threadIdx.x == 0) {
      absmax_m[row] = mx.x;
      if (kTwo) absmax_r[row] = mx.y;
      if (SENT) store_health<kTwo>(health, row, cnt, mx);
    }
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
  float* health;  // (n_blocks, 8) sentinel output, or null
  int seed, n_blocks, block_size, bits_m, bits_r;
  int ctas;       // the packed kernel's grid
  rq::Scalars s;
};

template <int ALGO, int VPT, bool STOCH, bool SENT>
int launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.n_blocks), block(rq::kThreads);
  fused_update_kernel<ALGO, VPT, STOCH, SENT><<<grid, block, 0, stream>>>(
      a.p, a.g, a.codes_m, a.absmax_m, a.codes_r, a.absmax_r, a.qmap_m,
      a.qmap_r, a.tensor_scale, a.block_seeds, a.block_offsets, a.health,
      a.seed, a.block_size, a.s);
  return static_cast<int>(cudaGetLastError());
}

template <int ALGO, bool STOCH, bool SENT>
int launch_vpt(const Args& a, cudaStream_t stream) {
  switch (rq_vectors_per_thread(a.block_size)) {
    case 1: return launch<ALGO, 1, STOCH, SENT>(a, stream);
    case 2: return launch<ALGO, 2, STOCH, SENT>(a, stream);
    case 4: return launch<ALGO, 4, STOCH, SENT>(a, stream);
    case 8: return launch<ALGO, 8, STOCH, SENT>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int ALGO>
int launch_algo(const Args& a, bool stochastic, cudaStream_t stream) {
  const bool sent = a.health != nullptr;
  if (stochastic)
    return sent ? launch_vpt<ALGO, true, true>(a, stream)
                : launch_vpt<ALGO, true, false>(a, stream);
  return sent ? launch_vpt<ALGO, false, true>(a, stream)
              : launch_vpt<ALGO, false, false>(a, stream);
}

// Threads of the packed kernel's CTA: the fewest of 256, 512 and 1024
// that give every group of 8 elements of a block its own thread.
int packed_threads(int block_size) {
  return block_size <= 2048 ? 256 : (block_size <= 4096 ? 512 : 1024);
}

// Dynamic shared memory of the packed kernel: its two-slot ring.
int packed_smem_bytes(int block_size, int bits_m, int bits_r, bool two) {
  return 2 * packed_stage_bytes(block_size, block_size * bits_m / 8,
                                two ? block_size * bits_r / 8 : 0);
}

// CTAs of the packed kernel for n_blocks blocks on a card of `sms` SMs
// (rq_walk_ctas); 0 for an invalid shape.
int packed_ctas(int n_blocks, int block_size, int sms) {
  if (block_size <= 0 || block_size % 8 || block_size > rq::kMaxBlock)
    return 0;
  int per_sm;
  switch (packed_threads(block_size)) {
    case 256: per_sm = packed_ctas_per_sm<256>(); break;
    case 512: per_sm = packed_ctas_per_sm<512>(); break;
    default: per_sm = packed_ctas_per_sm<1024>(); break;
  }
  return rq_walk_ctas(n_blocks, sms, per_sm);
}

template <int ALGO, int THREADS, bool STOCH, bool SENT>
int launch_packed(const Args& a, cudaStream_t stream) {
  const int smem = packed_smem_bytes(a.block_size, a.bits_m, a.bits_r,
                                     rq::AlgoTraits<ALGO>::kTwoStates);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_update_packed_kernel<ALGO, THREADS, STOCH, SENT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(a.ctas), block(THREADS);
  fused_update_packed_kernel<ALGO, THREADS, STOCH, SENT><<<grid, block, smem, stream>>>(
      a.p, a.g, a.codes_m, a.absmax_m, a.codes_r, a.absmax_r, a.qmap_m,
      a.qmap_r, a.tensor_scale, a.block_seeds, a.block_offsets, a.health,
      a.seed, a.n_blocks, a.block_size, a.bits_m, a.bits_r, a.s);
  return static_cast<int>(cudaGetLastError());
}

template <int ALGO, bool STOCH, bool SENT>
int launch_packed_threads(const Args& a, cudaStream_t stream) {
  switch (packed_threads(a.block_size)) {
    case 256: return launch_packed<ALGO, 256, STOCH, SENT>(a, stream);
    case 512: return launch_packed<ALGO, 512, STOCH, SENT>(a, stream);
    default: return launch_packed<ALGO, 1024, STOCH, SENT>(a, stream);
  }
}

template <int ALGO>
int launch_packed_algo(const Args& a, bool stochastic, cudaStream_t stream) {
  const bool sent = a.health != nullptr;
  if (stochastic)
    return sent ? launch_packed_threads<ALGO, true, true>(a, stream)
                : launch_packed_threads<ALGO, true, false>(a, stream);
  return sent ? launch_packed_threads<ALGO, false, true>(a, stream)
              : launch_packed_threads<ALGO, false, false>(a, stream);
}

bool valid_bits(int b) { return b == 4 || b == 5 || b == 6 || b == 8; }

int run(int algo, const Args& a, int stochastic, cudaStream_t stream) {
  if (a.n_blocks == 0) return 0;
  const bool two = algo == rq::kAdam || algo == rq::kLamb;
  const bool norms = algo == rq::kLamb || algo == rq::kLars;
  if ((two && (!a.codes_r || !a.absmax_r || !a.qmap_r)) ||
      (norms && !a.tensor_scale))
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

int run_packed(int algo, const Args& a, int stochastic, cudaStream_t stream) {
  if (a.n_blocks == 0) return 0;
  const bool two = algo == rq::kAdam || algo == rq::kLamb;
  const bool norms = algo == rq::kLamb || algo == rq::kLars;
  if ((two && (!a.codes_r || !a.absmax_r || !a.qmap_r ||
               !valid_bits(a.bits_r))) ||
      (norms && !a.tensor_scale) || !valid_bits(a.bits_m) ||
      a.block_size % 8 || a.block_size <= 0 ||
      a.block_size > rq::kMaxBlock || a.ctas <= 0)
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

rq::Scalars scalars(float lr, float beta1, float one_minus_beta1,
                    float beta2, float one_minus_beta2, float eps,
                    float weight_decay, float c1, float c2,
                    float gnorm_scale) {
  return rq::Scalars{lr, beta1, one_minus_beta1, beta2, one_minus_beta2,
                     eps, weight_decay, c1, c2, gnorm_scale};
}

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
  const Args a{p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r,
               tensor_scale, block_seeds, block_offsets, nullptr, seed,
               n_blocks, block_size, 8, 8, 0,
               scalars(lr, beta1, one_minus_beta1, beta2, one_minus_beta2,
                       eps, weight_decay, c1, c2, gnorm_scale)};
  return run(algo, a, stochastic, stream);
}

// With the sentinel: as fused_update, plus health, the (n_blocks, 8) f32
// output of per-block health counts (16-byte aligned, not null).
extern "C" int fused_update_sentinel(
    int algo, float* p, const float* g, uint8_t* codes_m, float* absmax_m,
    uint8_t* codes_r, float* absmax_r, const float* qmap_m,
    const float* qmap_r, const float* tensor_scale, const int* block_seeds,
    const int* block_offsets, float* health, int stochastic, int seed,
    int n_blocks, int block_size, float lr, float beta1,
    float one_minus_beta1, float beta2, float one_minus_beta2, float eps,
    float weight_decay, float c1, float c2, float gnorm_scale,
    cudaStream_t stream) {
  if (!health) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r,
               tensor_scale, block_seeds, block_offsets, health, seed,
               n_blocks, block_size, 8, 8, 0,
               scalars(lr, beta1, one_minus_beta1, beta2, one_minus_beta2,
                       eps, weight_decay, c1, c2, gnorm_scale)};
  return run(algo, a, stochastic, stream);
}

// The packed variant: as fused_update, with codes_m / codes_r stored as
// packed bits_m- / bits_r-bit rows of block_size * bits / 8 bytes, and
// qmaps of 2^bits entries.  Widths in {4, 5, 6, 8}; block_size a multiple
// of 8 and at most rq::kMaxBlock.  health: null, or the sentinel's output
// (as in fused_update_sentinel).  ctas: the grid, from
// fused_update_packed_ctas; each CTA walks the blocks blockIdx.x,
// blockIdx.x + ctas, ...
extern "C" int fused_update_packed_grid(
    int algo, float* p, const float* g, uint8_t* codes_m, float* absmax_m,
    uint8_t* codes_r, float* absmax_r, const float* qmap_m,
    const float* qmap_r, const float* tensor_scale, const int* block_seeds,
    const int* block_offsets, float* health, int stochastic, int seed,
    int n_blocks, int block_size, int bits_m, int bits_r, int ctas, float lr,
    float beta1, float one_minus_beta1, float beta2, float one_minus_beta2,
    float eps, float weight_decay, float c1, float c2, float gnorm_scale,
    cudaStream_t stream) {
  const Args a{p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r,
               tensor_scale, block_seeds, block_offsets, health, seed,
               n_blocks, block_size, bits_m, bits_r, ctas,
               scalars(lr, beta1, one_minus_beta1, beta2, one_minus_beta2,
                       eps, weight_decay, c1, c2, gnorm_scale)};
  return run_packed(algo, a, stochastic, stream);
}

// The grid of fused_update_packed_grid on a card of `sms` SMs (the same
// for every algorithm and width); 0 for an invalid shape.
extern "C" int fused_update_packed_ctas(int n_blocks, int block_size,
                                        int sms) {
  return packed_ctas(n_blocks, block_size, sms);
}

// Dynamic shared memory per CTA of fused_update_packed_grid (its ring).
extern "C" int fused_update_packed_smem(int algo, int block_size, int bits_m,
                                        int bits_r) {
  return packed_smem_bytes(block_size, bits_m, bits_r,
                           algo == rq::kAdam || algo == rq::kLamb);
}

// fused_update_packed_grid with one CTA per block and no sentinel output.
extern "C" int fused_update_packed(
    int algo, float* p, const float* g, uint8_t* codes_m, float* absmax_m,
    uint8_t* codes_r, float* absmax_r, const float* qmap_m,
    const float* qmap_r, const float* tensor_scale, const int* block_seeds,
    const int* block_offsets, int stochastic, int seed, int n_blocks,
    int block_size, int bits_m, int bits_r, float lr, float beta1,
    float one_minus_beta1, float beta2, float one_minus_beta2, float eps,
    float weight_decay, float c1, float c2, float gnorm_scale,
    cudaStream_t stream) {
  return fused_update_packed_grid(
      algo, p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r,
      tensor_scale, block_seeds, block_offsets, nullptr, stochastic, seed,
      n_blocks, block_size, bits_m, bits_r, n_blocks, lr, beta1,
      one_minus_beta1, beta2, one_minus_beta2, eps, weight_decay, c1, c2,
      gnorm_scale, stream);
}

// fused_update_packed_grid with one CTA per block and the sentinel output
// (health not null).
extern "C" int fused_update_packed_sentinel(
    int algo, float* p, const float* g, uint8_t* codes_m, float* absmax_m,
    uint8_t* codes_r, float* absmax_r, const float* qmap_m,
    const float* qmap_r, const float* tensor_scale, const int* block_seeds,
    const int* block_offsets, float* health, int stochastic, int seed,
    int n_blocks, int block_size, int bits_m, int bits_r, float lr,
    float beta1, float one_minus_beta1, float beta2, float one_minus_beta2,
    float eps, float weight_decay, float c1, float c2, float gnorm_scale,
    cudaStream_t stream) {
  if (!health) return static_cast<int>(cudaErrorInvalidValue);
  return fused_update_packed_grid(
      algo, p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r,
      tensor_scale, block_seeds, block_offsets, health, stochastic, seed,
      n_blocks, block_size, bits_m, bits_r, n_blocks, lr, beta1,
      one_minus_beta1, beta2, one_minus_beta2, eps, weight_decay, c1, c2,
      gnorm_scale, stream);
}
