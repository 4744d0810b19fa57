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
// 8-step searches in shared memory, the hash when rounding stochastically)
// stay below the f32 rate, but not below the rate at which an SM issues
// instructions: the two-state and stochastic updates are bound by issue
// (PERF.md), so the design cuts instructions per element.
//
// Design of the 8-bit kernel (the packed kernel's is below; the two share
// their skeleton): a streaming kernel whose CTAs walk the blocks.
//   * Each thread owns one group of 8 consecutive elements of a block
//     (thread v: elements 8v .. 8v + 7; a CTA of THREADS = 256, 512 or
//     1024 threads, the fewest that cover the block).  Its 8 codes per
//     state are one aligned 8-byte word (row * B + 8v is a multiple of 8),
//     loaded and stored whole; at a block size of 8k + 4 (B = 260) the
//     words are read and written as 4-byte halves and the row ends in a
//     half group of 4 elements (rq::load_codes8 / store_codes8).  The
//     thread keeps its new states in registers across the absmax
//     reduction.  Every quantity that depends on the mapping of elements
//     to threads is order-free: the absmax is a NaN-propagating max, the
//     sentinel counts are integers, the stochastic uniform is indexed by
//     the element's position in its leaf.
//   * CTAs walk the blocks (block blockIdx.x, then + gridDim.x, ...) on a
//     grid of 16 waves of the CTAs resident at once (fused_update_ctas,
//     rq_walk_ctas): each CTA loads the codebooks and builds their
//     midpoints once for the ~4 blocks it walks at the main path's 40960.
//   * Two-state algorithms: a two-slot ring of shared-memory stages, each
//     one block's p and g rows, filled by 16-byte cp.async pieces: the next
//     block's p and g are in flight while the current block updates,
//     reduces and encodes.  One-state ones (short, memory-bound updates)
//     load p and g straight into registers.  The next block's code words,
//     absmax and trust ratio are loaded into registers at the top of the
//     current block, so they too arrive while it works.  Codes are not
//     staged: a warp's 8-byte words are 256 contiguous bytes, and the ring
//     stays at 2 x 16 KB per CTA at B = 2048, so that 5 CTAs of 256
//     threads fit in an SM (4 for the two-state instances with the
//     sentinel, which spill at 48 registers).
//   * Fewer instructions per element: the encode walks the 255 midpoints
//     in Eytzinger order with the node kept as its byte offset
//     (rq::encode_tree<8>: 8 steps of a shared load, a compare and a
//     shift-add; the first five levels free of bank conflicts), the decode
//     shifts a code's byte straight to its table offset (rq::decode8);
//     the divisions by c1, c2 and the block scales take rq::div_fast (two
//     fmas and a multiply on a reciprocal computed once, exact: common.cuh)
//     for a group of 8 whose values lie in its range, where __fdiv_rn
//     computes the reciprocal, checks its operands and branches for every
//     element; the NaN-propagating max is one max.NaN; the sentinel
//     counts nonfinite values only in a group whose max of |g| or |p| is
//     nonfinite, and codebook-edge codes four at a time (rq::edge_bytes).
// The codebooks and their midpoints sit in shared memory; adagrad's single
// state uses the unsigned codebook, which the wrapper passes as qmap_m.
// The kernel is a template on the algorithm (one- or two-state, trust
// ratio or not), the CTA size, stochastic rounding and the sentinel, so
// each variant carries only its own work.
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
// same single pass (the 8-bit kernel counts nonfinite g and p only in a
// group whose largest |g| or |p| is nonfinite, and edge codes four to a
// word).  Each thread keeps four integer counters packed two to
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
// thread reads a block's old absmax (with its code words, a block ahead in
// the 8-bit kernel) before the barriers of that block's reduction, after
// which thread 0 writes the new one.
//
// Order of operations: update_math.cuh, held bit-exactly against the plain
// version, repro_torch/kernels/fused_update.py::fused_update_plain.
//
// Element type of p (ROADMAP A14b-1: bf16 masters): the kernels are
// templates on it, T = float or __nv_bfloat16; g is f32 in both, as the
// reference feeds its kernel an f32 gradient (blockopt.py flattens it to
// f32) and writes the master in its own dtype (fused_update.py:348).  A
// bf16 thread loads its 8 elements of p as one 16-byte word (two for g)
// through the same cp.async ring (the ring of the two-state 8-bit
// instances is 24 KB at B = 2048), computes in f32 exactly as the f32
// instance does, and stores its new p with __float2bfloat16_rn (rq::Elem).
// bf16 rows need a block size that is a multiple of 8.  The source builds
// one library per element type of p (PElem, common.cuh): the same C
// entries, compiled in parallel.
// Bound of a bf16 instance: p read and written at 2 B, g read at 4 B, the
// codes as above: 10 B/element for the one-state algorithms, 12 B for the
// two-state ones.
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

// Resident CTAs per SM of the update kernels, whose CTAs walk the blocks:
// 5 of 256 threads (the launch bound caps registers at 48), 2 of 512 and 1
// of 1024 (64 registers).  Their shared memory fits: at B = 2048 the 8-bit
// kernel's ring is 32 KB and the packed kernel's 38,976 B at (4, 8), plus
// 4.6 KB of codebooks, midpoints and reduction slots, 5 x 37-44 KB of an
// H100 SM's 228 KB.
template <int THREADS>
constexpr int walk_ctas_per_sm() {
  return THREADS == 256 ? 5 : 1024 / THREADS;
}

// Encode a group's 8 new values x of one state at 8 bits (x / scale, the
// nearest code, with a uniform from element idx0 + c the stochastic
// choice) into rq::load_codes8's layout; lo and hi: the least and largest
// |x| of the group's elements (rq::div8).
template <bool STOCH>
__device__ __forceinline__ uint2 encode_codes8(const float (&x)[8],
                                               const rq::DivBy& scale,
                                               float lo, float hi,
                                               const float* lut,
                                               const float* tree,
                                               uint32_t idx0, uint32_t seed) {
  float xn[8];
  rq::div8(x, scale, lo, hi, xn);
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    uint32_t code = rq::encode_tree<8>(xn[c], tree);
    if (STOCH)
      code = rq::stochastic_code(xn[c], code, lut,
                                 rq::hash_uniform(idx0 + c, seed), 255u);
    w[c >> 2] |= code << (8 * (c & 3));
  }
  uint2 out;
  out.x = w[0];
  out.y = w[1];
  return out;
}

// Codes of a group's word at a codebook edge (0 or 255), the first 4 of a
// half group.
__device__ __forceinline__ int edges8(uint2 w, bool half) {
  return rq::edge_bytes(w.x) + (half ? 0 : rq::edge_bytes(w.y));
}

// Resident CTAs per SM of the 8-bit kernel: walk_ctas_per_sm, but 4 of 256
// threads for the two-state instances with the sentinel or with bf16 p
// (whose f32 g and conversions add registers), which spill at 48 registers
// (the launch bound at 5) and fit in 64.
template <typename T, int ALGO, int THREADS, bool SENT>
constexpr int update8_ctas_per_sm() {
  return THREADS == 256 && (SENT || sizeof(T) == 2) &&
                 rq::AlgoTraits<ALGO>::kTwoStates
             ? 4
             : walk_ctas_per_sm<THREADS>();
}

// What a thread reads of a block before its stage arrives: its code words
// and the block's absmax, trust ratio, seed and leaf offset.
struct BlockHead {
  uint2 cm, cr;
  float am, ar, ts;
  uint32_t seed, off;
};

template <typename T, int ALGO, int THREADS, bool STOCH, bool SENT>
__global__ void __launch_bounds__(THREADS,
                                  update8_ctas_per_sm<T, ALGO, THREADS,
                                                      SENT>())
fused_update_kernel(T* p, const float* g, uint8_t* codes_m,
                    float* absmax_m, uint8_t* codes_r, float* absmax_r,
                    const float* qmap_m, const float* qmap_r,
                    const float* tensor_scale, const int* block_seeds,
                    const int* block_offsets, float* health, int seed,
                    int n_blocks, int block_size, rq::Scalars s) {
  constexpr bool kTwo = rq::AlgoTraits<ALGO>::kTwoStates;
  constexpr bool kNorms = rq::AlgoTraits<ALGO>::kNeedsNorms;
  __shared__ float lut_m[rq::kCodebookSize], tree_m[rq::kCodebookSize];
  __shared__ float lut_r[kTwo ? rq::kCodebookSize : 1];
  __shared__ float tree_r[kTwo ? rq::kCodebookSize : 1];
  __shared__ float red[66];
  __shared__ int hred[SENT ? 64 : 1];
  RQ_DYNAMIC_SHARED(float4, ring);

  // 16-byte pieces of a row of p and of g (f32), and of a ring slot
  const int bsz = block_size, nvp = bsz * sizeof(T) / 16, nvg = bsz >> 2;
  const int nslot = nvp + nvg;
  const size_t nb = static_cast<size_t>(n_blocks);
  const size_t stride = gridDim.x;
  const int v = threadIdx.x;              // this thread's group
  const bool live = 8 * v < bsz;
  const bool half = 8 * v + 4 == bsz;     // a block of 8k + 4 ends in one
  const bool wide = (bsz & 7) == 0;       // 8-byte aligned code words
  // issue (and commit, also when empty) the copies of block row's p and g
  // rows into ring slot `slot` (two-state instances; the one-state ones,
  // whose update is short and memory-bound, load p and g straight into
  // registers: through the ring they ran 4% slower on an H100)
  auto stage = [&](size_t row, int slot) {
    if (kTwo && row < nb) {
      float4* d = ring + nslot * slot;
      const float4* sp = reinterpret_cast<const float4*>(p + row * bsz);
      const float4* sg = reinterpret_cast<const float4*>(g + row * bsz);
      for (int c = threadIdx.x; c < nvg; c += THREADS) {
        if (sizeof(T) == 4 || c < nvp) cp_async_16(d + c, sp + c, true);
        cp_async_16(d + nvp + c, sg + c, true);
      }
    }
    cp_async_commit();
  };
  auto head = [&](size_t row) {
    BlockHead h{};
    h.ts = 1.f;
    if (row < nb) {
      if (live) {
        h.cm = rq::load_codes8(codes_m + row * bsz + 8 * v, wide, half);
        if (kTwo)
          h.cr = rq::load_codes8(codes_r + row * bsz + 8 * v, wide, half);
      }
      h.am = absmax_m[row];
      if (kTwo) h.ar = absmax_r[row];
      if (kNorms) h.ts = tensor_scale[row];
      if (STOCH) {
        h.seed = static_cast<uint32_t>(block_seeds ? block_seeds[row] : seed);
        h.off = static_cast<uint32_t>(block_offsets ? block_offsets[row]
                                                    : static_cast<int>(row));
      }
    }
    return h;
  };
  size_t row = blockIdx.x;
  stage(row, 0);
  stage(row + stride, 1);
  BlockHead next = head(row);
  rq::load_codebook_tree(qmap_m, lut_m, tree_m, 8);
  if (kTwo) rq::load_codebook_tree(qmap_r, lut_r, tree_r, 8);
  const rq::DivBy c1 = rq::div_by(s.c1), c2 = rq::div_by(s.c2);

  for (int slot = 0; row < nb; row += stride, slot ^= 1) {
    const BlockHead cur = next;
    next = head(row + stride);   // in flight while this block works
    cp_async_wait<1>();   // this block's stage (the next one may still fly)
    if (kTwo) __syncthreads();
    // this block's p and g rows: the ring's stage, or global memory
    const float4* sp = kTwo ? ring + nslot * slot
                            : reinterpret_cast<const float4*>(p + row * bsz);
    const float4* sg = kTwo ? sp + nvp
                            : reinterpret_cast<const float4*>(g + row * bsz);
    float xm[8], xr[8];   // the new states, kept across the absmax
    float mx_m = 0.f, mx_r = 0.f;            // the group's largest |state|
    float mn_m = INFINITY, mn_r = INFINITY;  // and least (rq::div8's range)
    int cnt[2] = {0, 0};  // sentinel counts (see kHigh)
    if (live) {
      float pe[8], ge[8], pn[8];
      rq::Elem<T>::load8_pair(sp, sg, v, half, pe, ge);
      float mx_g = 0.f, mx_p = 0.f;  // the sentinel's: NaN or inf if any
      if constexpr (kTwo) {
        // the 8 elements' moments first, then their quotients by c1 and c2
        // (rq::div_fast when the group lies in both ranges) and the step
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          rq::adam_moments(__fmul_rn(ge[c], s.gnorm_scale),
                           __fmul_rn(rq::decode8(cur.cm, c, lut_m), cur.am),
                           __fmul_rn(rq::decode8(cur.cr, c, lut_r), cur.ar),
                           s, xm[c], xr[c]);
          if (c < 4 || !half) {
            mx_m = rq::nanmax(mx_m, fabsf(xm[c]));
            mx_r = rq::nanmax(mx_r, fabsf(xr[c]));
            mn_m = fminf(mn_m, fabsf(xm[c]));
            mn_r = fminf(mn_r, fabsf(xr[c]));
            if (SENT) mx_g = rq::nanmax(mx_g, fabsf(ge[c]));
          }
        }
        if (mn_m >= c1.x_min && mx_m <= c1.x_max && mn_r >= c2.x_min &&
            mx_r <= c2.x_max) {
#pragma unroll
          for (int c = 0; c < 8; ++c)
            pn[c] = rq::adam_param<ALGO>(pe[c], rq::div_fast(xm[c], c1),
                                         rq::div_fast(xr[c], c2), cur.ts, s);
        } else {
#pragma unroll
          for (int c = 0; c < 8; ++c)
            pn[c] = rq::adam_param<ALGO>(pe[c], __fdiv_rn(xm[c], s.c1),
                                         __fdiv_rn(xr[c], s.c2), cur.ts, s);
        }
        if (SENT) {
#pragma unroll
          for (int c = 0; c < 8; ++c)
            if (c < 4 || !half) mx_p = rq::nanmax(mx_p, fabsf(pn[c]));
        }
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const rq::Update o = rq::update<ALGO>(
              pe[c], __fmul_rn(ge[c], s.gnorm_scale),
              __fmul_rn(rq::decode8(cur.cm, c, lut_m), cur.am), 0.f, cur.ts,
              s);
          pn[c] = o.p2;
          xm[c] = o.m2;
          if (c < 4 || !half) {
            mx_m = rq::nanmax(mx_m, fabsf(o.m2));
            mn_m = fminf(mn_m, fabsf(o.m2));
            if (SENT) {
              mx_g = rq::nanmax(mx_g, fabsf(ge[c]));
              mx_p = rq::nanmax(mx_p, fabsf(o.p2));
            }
          }
        }
      }
      // count the nonfinite g and new p only in a group that has one (g
      // read again, from the stage, which holds it until the reduction)
      if (SENT && !(rq::is_finite(mx_g) && rq::is_finite(mx_p))) {
        float gr[8];
        rq::Elem<float>::load8(sg, v, half, gr);
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (c < 4 || !half)
            cnt[0] += (rq::is_finite(gr[c]) ? 0 : 1) +
                      (rq::is_finite(pn[c]) ? 0 : kHigh);
      }
      rq::Elem<T>::store8(p + row * bsz, v, half, pn);
    }
    // every thread has read this stage before the reduction's first
    // barrier: refill it with the block two ahead
    const float2 mx = rq::block_max2(mx_m, mx_r, red);
    stage(row + 2 * stride, slot);
    if (live) {
      // element index in the block's own leaf, as uint32 (wraps)
      const uint32_t idx0 = cur.off * static_cast<uint32_t>(bsz) +
                            static_cast<uint32_t>(8 * v);
      const size_t at = row * bsz + 8 * v;
      const uint2 nm = encode_codes8<STOCH>(
          xm, rq::div_by(rq::block_scale(mx.x)), mn_m, mx_m, lut_m, tree_m,
          idx0, cur.seed + rq::kState1Salt);
      rq::store_codes8(codes_m + at, nm, wide, half);
      if (SENT) cnt[1] += edges8(nm, half);
      if (kTwo) {
        const uint2 nr = encode_codes8<STOCH>(
            xr, rq::div_by(rq::block_scale(mx.y)), mn_r, mx_r, lut_r,
            tree_r, idx0, cur.seed + rq::kState2Salt);
        rq::store_codes8(codes_r + at, nr, wide, half);
        if (SENT) cnt[1] += edges8(nr, half) * kHigh;
      }
    }
    if (SENT) rq::block_sum2(cnt, hred);
    if (threadIdx.x == 0) {
      absmax_m[row] = mx.x;
      if (kTwo) absmax_r[row] = mx.y;
      if (SENT) store_health<kTwo>(health, row, cnt, mx);
    }
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
// midpoints; resident CTAs per SM as the 8-bit kernel's
// (walk_ctas_per_sm).

// Bytes of one stage of the packed kernel's ring (a multiple of 16): the
// row of p of elem-byte elements and the f32 row of g, then the packed
// rows.
__host__ __device__ inline int packed_stage_bytes(int block_size, int wm,
                                                  int wr, int elem) {
  return (elem + 4) * block_size + rq::staged_row_bytes(wm) +
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

template <typename T, int ALGO, int THREADS, bool STOCH, bool SENT>
__global__ void __launch_bounds__(THREADS, walk_ctas_per_sm<THREADS>())
fused_update_packed_kernel(T* p, const float* g, uint8_t* codes_m,
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

  constexpr int kElem = static_cast<int>(sizeof(T));
  // 16-byte pieces of a row of p and of g (f32)
  const int bsz = block_size, nvp = bsz * kElem / 16, nvg = bsz >> 2;
  const int wm = bsz * bits_m / 8, wr = kTwo ? bsz * bits_r / 8 : 0;
  const int stage_bytes = packed_stage_bytes(bsz, wm, wr, kElem);
  const int pg_bytes = (kElem + 4) * bsz;     // a stage's rows of p and g
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
      for (int c = threadIdx.x; c < nvg; c += THREADS) {
        if (sizeof(T) == 4 || c < nvp) cp_async_16(d + c, sp + c, true);
        cp_async_16(d + nvp + c, sg + c, true);
      }
      rq::stage_packed_row(dst + pg_bytes, codes_m, row * wm, wm, nb * wm);
      if (kTwo)
        rq::stage_packed_row(dst + pg_bytes + rq::staged_row_bytes(wm),
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
      const float4* sg = sp + nvp;
      const uint8_t* rows = st + pg_bytes;   // the packed rows
      const uint64_t om = rq::load_group(
          rows + ((row * wm) & 15) + bits_m * v, bits_m);
      const uint64_t orr =
          kTwo ? rq::load_group(rows + rq::staged_row_bytes(wm) +
                                    ((row * wr) & 15) + bits_r * v,
                                bits_r)
               : 0u;
      float pe[8], ge[8], pn[8];
      rq::Elem<T>::load8(sp, v, false, pe);
      rq::Elem<float>::load8(sg, v, false, ge);
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
      rq::Elem<T>::store8(p + row * bsz, v, false, pn);
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
  PElem* p;
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
  int ctas;       // the grid: CTAs that walk the blocks
  rq::Scalars s;
};

constexpr int kElem = static_cast<int>(sizeof(PElem));
// Rows of p start 16-byte aligned: the 8-bit kernel's block size is a
// multiple of 4 (f32 p) or 8 (bf16 p)
constexpr int kRowMultiple = 16 / kElem;

// Dynamic shared memory of the 8-bit kernel: the two-state instances'
// two-slot ring of p and g rows.
int update8_smem_bytes(bool two, int block_size) {
  return two ? 2 * (kElem + 4) * block_size : 0;
}

// Dynamic shared memory of the packed kernel: its two-slot ring.
int packed_smem_bytes(int block_size, int bits_m, int bits_r, bool two) {
  return 2 * packed_stage_bytes(block_size, block_size * bits_m / 8,
                                two ? block_size * bits_r / 8 : 0, kElem);
}

// CTAs of an update kernel for n_blocks blocks on a card of `sms` SMs
// (rq_walk_ctas); 0 for a block size that is not a multiple of `multiple`
// (8 for packed rows, 4 for 8-bit ones) or above rq::kMaxBlock.  lean:
// the 8-bit kernel's two-state instances with the sentinel or bf16 p
// (update8_ctas_per_sm).
int walk_ctas(int n_blocks, int block_size, int sms, int multiple,
              bool lean = false) {
  if (block_size <= 0 || block_size % multiple || block_size > rq::kMaxBlock)
    return 0;
  int per_sm;
  switch (rq_walk_threads(block_size)) {
    case 256:
      per_sm = lean ? update8_ctas_per_sm<PElem, rq::kAdam, 256, true>()
                    : walk_ctas_per_sm<256>();
      break;
    case 512: per_sm = walk_ctas_per_sm<512>(); break;
    default: per_sm = walk_ctas_per_sm<1024>(); break;
  }
  return rq_walk_ctas(n_blocks, sms, per_sm);
}

template <bool PACKED, int ALGO, int THREADS, bool STOCH, bool SENT>
int launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.ctas), block(THREADS);
  if constexpr (PACKED) {
    const int smem = packed_smem_bytes(a.block_size, a.bits_m, a.bits_r,
                                       rq::AlgoTraits<ALGO>::kTwoStates);
    const cudaError_t e = rq_allow_smem(
        fused_update_packed_kernel<PElem, ALGO, THREADS, STOCH, SENT>,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    fused_update_packed_kernel<PElem, ALGO, THREADS, STOCH, SENT><<<grid, block, smem, stream>>>(
        a.p, a.g, a.codes_m, a.absmax_m, a.codes_r, a.absmax_r, a.qmap_m,
        a.qmap_r, a.tensor_scale, a.block_seeds, a.block_offsets, a.health,
        a.seed, a.n_blocks, a.block_size, a.bits_m, a.bits_r, a.s);
  } else {
    const int smem = update8_smem_bytes(rq::AlgoTraits<ALGO>::kTwoStates,
                                        a.block_size);
    const cudaError_t e = rq_allow_smem(
        fused_update_kernel<PElem, ALGO, THREADS, STOCH, SENT>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    fused_update_kernel<PElem, ALGO, THREADS, STOCH, SENT><<<grid, block, smem, stream>>>(
        a.p, a.g, a.codes_m, a.absmax_m, a.codes_r, a.absmax_r, a.qmap_m,
        a.qmap_r, a.tensor_scale, a.block_seeds, a.block_offsets, a.health,
        a.seed, a.n_blocks, a.block_size, a.s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool PACKED, int ALGO, bool STOCH, bool SENT>
int launch_threads(const Args& a, cudaStream_t stream) {
  switch (rq_walk_threads(a.block_size)) {
    case 256: return launch<PACKED, ALGO, 256, STOCH, SENT>(a, stream);
    case 512: return launch<PACKED, ALGO, 512, STOCH, SENT>(a, stream);
    default: return launch<PACKED, ALGO, 1024, STOCH, SENT>(a, stream);
  }
}

template <bool PACKED, int ALGO>
int launch_algo(const Args& a, bool stochastic, cudaStream_t stream) {
  const bool sent = a.health != nullptr;
  if (stochastic)
    return sent ? launch_threads<PACKED, ALGO, true, true>(a, stream)
                : launch_threads<PACKED, ALGO, true, false>(a, stream);
  return sent ? launch_threads<PACKED, ALGO, false, true>(a, stream)
              : launch_threads<PACKED, ALGO, false, false>(a, stream);
}

bool valid_bits(int b) { return b == 4 || b == 5 || b == 6 || b == 8; }

// The 8-bit kernel (packed false) or the packed one, on a.ctas CTAs.
template <bool PACKED>
int run(int algo, const Args& a, int stochastic, cudaStream_t stream) {
  if (a.n_blocks == 0) return 0;
  const bool two = algo == rq::kAdam || algo == rq::kLamb;
  const bool norms = algo == rq::kLamb || algo == rq::kLars;
  if ((two && (!a.codes_r || !a.absmax_r || !a.qmap_r)) ||
      (norms && !a.tensor_scale) ||
      (PACKED && (!valid_bits(a.bits_m) || (two && !valid_bits(a.bits_r)))) ||
      a.block_size <= 0 || a.block_size % (PACKED ? 8 : kRowMultiple) ||
      a.block_size > rq::kMaxBlock || a.ctas <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool sr = stochastic != 0;
  switch (algo) {
    case rq::kAdam: return launch_algo<PACKED, rq::kAdam>(a, sr, stream);
    case rq::kLamb: return launch_algo<PACKED, rq::kLamb>(a, sr, stream);
    case rq::kMomentum: return launch_algo<PACKED, rq::kMomentum>(a, sr, stream);
    case rq::kLars: return launch_algo<PACKED, rq::kLars>(a, sr, stream);
    case rq::kAdagrad: return launch_algo<PACKED, rq::kAdagrad>(a, sr, stream);
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

// p: PElem (f32, or bf16 in the RQ_P_BF16 library, whose block size is a
// multiple of 8); g: f32.  algo: rq::Algo (adam and adamw are both
// kAdam).  codes_r, absmax_r and qmap_r are null for one-state algorithms, tensor_scale for block-local
// ones; block_seeds and block_offsets may be null (see above).  health:
// null, or the sentinel's (n_blocks, 8) f32 output (16-byte aligned).
// block_size a multiple of 4 and at most rq::kMaxBlock.  ctas: the grid,
// from fused_update_ctas; each CTA walks the blocks blockIdx.x,
// blockIdx.x + ctas, ...
extern "C" int fused_update_grid(
    int algo, PElem* p, const float* g, uint8_t* codes_m, float* absmax_m,
    uint8_t* codes_r, float* absmax_r, const float* qmap_m,
    const float* qmap_r, const float* tensor_scale, const int* block_seeds,
    const int* block_offsets, float* health, int stochastic, int seed,
    int n_blocks, int block_size, int ctas, float lr, float beta1,
    float one_minus_beta1, float beta2, float one_minus_beta2, float eps,
    float weight_decay, float c1, float c2, float gnorm_scale,
    cudaStream_t stream) {
  const Args a{p, g, codes_m, absmax_m, codes_r, absmax_r, qmap_m, qmap_r,
               tensor_scale, block_seeds, block_offsets, health, seed,
               n_blocks, block_size, 8, 8, ctas,
               scalars(lr, beta1, one_minus_beta1, beta2, one_minus_beta2,
                       eps, weight_decay, c1, c2, gnorm_scale)};
  return run<false>(algo, a, stochastic, stream);
}

// The grid of fused_update_grid for algorithm `algo`, with the sentinel
// output or not, on a card of `sms` SMs; 0 for an invalid shape.
extern "C" int fused_update_ctas(int algo, int sentinel, int n_blocks,
                                 int block_size, int sms) {
  const bool two = algo == rq::kAdam || algo == rq::kLamb;
  return walk_ctas(n_blocks, block_size, sms, kRowMultiple,
                   two && (sentinel || kElem == 2));
}

// Dynamic shared memory per CTA of fused_update_grid (its ring; 0 for the
// one-state algorithms).
extern "C" int fused_update_smem(int algo, int block_size) {
  return update8_smem_bytes(algo == rq::kAdam || algo == rq::kLamb,
                            block_size);
}

// fused_update_grid with one CTA per block and no sentinel output.
extern "C" int fused_update(
    int algo, PElem* p, const float* g, uint8_t* codes_m, float* absmax_m,
    uint8_t* codes_r, float* absmax_r, const float* qmap_m,
    const float* qmap_r, const float* tensor_scale, const int* block_seeds,
    const int* block_offsets, int stochastic, int seed, int n_blocks,
    int block_size, float lr, float beta1, float one_minus_beta1, float beta2,
    float one_minus_beta2, float eps, float weight_decay, float c1, float c2,
    float gnorm_scale, cudaStream_t stream) {
  return fused_update_grid(algo, p, g, codes_m, absmax_m, codes_r, absmax_r,
                           qmap_m, qmap_r, tensor_scale, block_seeds,
                           block_offsets, nullptr, stochastic, seed, n_blocks,
                           block_size, n_blocks, lr, beta1, one_minus_beta1,
                           beta2, one_minus_beta2, eps, weight_decay, c1, c2,
                           gnorm_scale, stream);
}

// fused_update_grid with one CTA per block and the sentinel output
// (health not null).
extern "C" int fused_update_sentinel(
    int algo, PElem* p, const float* g, uint8_t* codes_m, float* absmax_m,
    uint8_t* codes_r, float* absmax_r, const float* qmap_m,
    const float* qmap_r, const float* tensor_scale, const int* block_seeds,
    const int* block_offsets, float* health, int stochastic, int seed,
    int n_blocks, int block_size, float lr, float beta1,
    float one_minus_beta1, float beta2, float one_minus_beta2, float eps,
    float weight_decay, float c1, float c2, float gnorm_scale,
    cudaStream_t stream) {
  if (!health) return static_cast<int>(cudaErrorInvalidValue);
  return fused_update_grid(algo, p, g, codes_m, absmax_m, codes_r, absmax_r,
                           qmap_m, qmap_r, tensor_scale, block_seeds,
                           block_offsets, health, stochastic, seed, n_blocks,
                           block_size, n_blocks, lr, beta1, one_minus_beta1,
                           beta2, one_minus_beta2, eps, weight_decay, c1, c2,
                           gnorm_scale, stream);
}

// The packed variant: as fused_update_grid, with codes_m / codes_r stored
// as packed bits_m- / bits_r-bit rows of block_size * bits / 8 bytes, and
// qmaps of 2^bits entries.  Widths in {4, 5, 6, 8}; block_size a multiple
// of 8 and at most rq::kMaxBlock.  ctas: from fused_update_packed_ctas.
extern "C" int fused_update_packed_grid(
    int algo, PElem* p, const float* g, uint8_t* codes_m, float* absmax_m,
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
  return run<true>(algo, a, stochastic, stream);
}

// The grid of fused_update_packed_grid on a card of `sms` SMs (the same
// for every algorithm and width); 0 for an invalid shape.
extern "C" int fused_update_packed_ctas(int n_blocks, int block_size,
                                        int sms) {
  return walk_ctas(n_blocks, block_size, sms, 8);
}

// Dynamic shared memory per CTA of fused_update_packed_grid (its ring).
extern "C" int fused_update_packed_smem(int algo, int block_size, int bits_m,
                                        int bits_r) {
  return packed_smem_bytes(block_size, bits_m, bits_r,
                           algo == rq::kAdam || algo == rq::kLamb);
}

// fused_update_packed_grid with one CTA per block and no sentinel output.
extern "C" int fused_update_packed(
    int algo, PElem* p, const float* g, uint8_t* codes_m, float* absmax_m,
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
    int algo, PElem* p, const float* g, uint8_t* codes_m, float* absmax_m,
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

// The check of rq::div_fast: for each of the n divisors, every f32 bit
// pattern x in its range [x_min, x_max] (both signs) against __fdiv_rn;
// mismatches[i] counts the x that differ for divisor i and checked[i] the
// x in range.  One thread per x of a 2^32 sweep, grid-strided.  On the
// card only (the CPU tests' emulation runs no such sweep), and in the f32
// library only.
#if defined(__CUDACC__) && !defined(RQ_P_BF16)
__global__ void div_check_kernel(const float* divisors, int n,
                                 unsigned long long* mismatches,
                                 unsigned long long* checked) {
  for (int i = 0; i < n; ++i) {
    const rq::DivBy d = rq::div_by(divisors[i]);
    unsigned long long bad = 0, seen = 0;
    for (unsigned long long b = blockIdx.x * 256ull + threadIdx.x;
         b < (1ull << 32); b += 256ull * gridDim.x) {
      const float x = __uint_as_float(static_cast<uint32_t>(b));
      if (!(fabsf(x) >= d.x_min && fabsf(x) <= d.x_max)) continue;
      ++seen;
      const float a = rq::div_fast(x, d), want = __fdiv_rn(x, d.c);
      bad += __float_as_uint(a) != __float_as_uint(want) ? 1 : 0;
    }
    atomicAdd(mismatches + i, bad);
    atomicAdd(checked + i, seen);
  }
}

extern "C" int fused_update_div_check(const float* divisors, int n,
                                      unsigned long long* mismatches,
                                      unsigned long long* checked,
                                      cudaStream_t stream) {
  const dim3 grid(132 * 16), block(256);
  div_check_kernel<<<grid, block, 0, stream>>>(divisors, n, mismatches, checked);
  return static_cast<int>(cudaGetLastError());
}
#endif  // __CUDACC__

#ifdef __CUDACC__
namespace {

// The occupancy query of one instance (rq_occupancy): the template
// arguments as the launch picks them, the dynamic shared memory given.
template <bool PACKED, int ALGO, int THREADS, bool STOCH, bool SENT>
int occupancy(int smem, int* out) {
  if constexpr (PACKED)
    return rq_occupancy(
        fused_update_packed_kernel<PElem, ALGO, THREADS, STOCH, SENT>,
        THREADS, smem, out);
  else
    return rq_occupancy(fused_update_kernel<PElem, ALGO, THREADS, STOCH, SENT>,
                        THREADS, smem, out);
}

template <bool PACKED, int ALGO, int THREADS>
int occupancy_flags(int stochastic, int sentinel, int smem, int* out) {
  if (stochastic)
    return sentinel ? occupancy<PACKED, ALGO, THREADS, true, true>(smem, out)
                    : occupancy<PACKED, ALGO, THREADS, true, false>(smem, out);
  return sentinel ? occupancy<PACKED, ALGO, THREADS, false, true>(smem, out)
                  : occupancy<PACKED, ALGO, THREADS, false, false>(smem, out);
}

template <bool PACKED, int ALGO>
int occupancy_threads(int threads, int stochastic, int sentinel, int smem,
                      int* out) {
  switch (threads) {
    case 256: return occupancy_flags<PACKED, ALGO, 256>(stochastic, sentinel, smem, out);
    case 512: return occupancy_flags<PACKED, ALGO, 512>(stochastic, sentinel, smem, out);
    case 1024: return occupancy_flags<PACKED, ALGO, 1024>(stochastic, sentinel, smem, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool PACKED>
int occupancy_algo(int algo, int threads, int stochastic, int sentinel,
                   int smem, int* out) {
  switch (algo) {
    case rq::kAdam: return occupancy_threads<PACKED, rq::kAdam>(threads, stochastic, sentinel, smem, out);
    case rq::kLamb: return occupancy_threads<PACKED, rq::kLamb>(threads, stochastic, sentinel, smem, out);
    case rq::kMomentum: return occupancy_threads<PACKED, rq::kMomentum>(threads, stochastic, sentinel, smem, out);
    case rq::kLars: return occupancy_threads<PACKED, rq::kLars>(threads, stochastic, sentinel, smem, out);
    case rq::kAdagrad: return occupancy_threads<PACKED, rq::kAdagrad>(threads, stochastic, sentinel, smem, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// rq_occupancy of fused_update_kernel (packed 0) or
// fused_update_packed_kernel (packed 1) <PElem, algo, threads, stochastic,
// sentinel> at `smem` bytes of dynamic shared memory; out: 5 ints.
extern "C" int fused_update_occupancy(int packed, int algo, int threads,
                                      int stochastic, int sentinel, int smem,
                                      int* out) {
  return packed ? occupancy_algo<true>(algo, threads, stochastic, sentinel,
                                       smem, out)
                : occupancy_algo<false>(algo, threads, stochastic, sentinel,
                                        smem, out);
}
#endif
