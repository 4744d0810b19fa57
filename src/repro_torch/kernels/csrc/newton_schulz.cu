// Newton–Schulz orthogonalization of Muon: the two matrix products of one
// quintic iteration X <- a X + (b A + c A A) X with A = X X^T, on a
// zero-padded (m, n) f32 matrix, m <= n (the caller transposes a tall
// matrix), m a multiple of 4 and n of 64.
//
// Replaces the TPU kernels of src/repro/kernels/newton_schulz.py:
//   ns_gram  -> _gram (pallas_call at :103): A = X X^T, (m, m), which the
//               TPU accumulates over 256-wide n-tiles in grid order;
//   ns_apply -> _ns_apply (pallas_call at :127): X' = a X + B X, (m, n),
//               B = b A + c A A formed outside the kernel (an m x m product,
//               left to the library as the JAX package leaves it to XLA).
//
// Bound on an H100: operations.  The apply is 2 m^2 n operations, the gram's
// symmetric result m (m + 1) n (1.06e11 and 5.29e10 at m = 1024, n = 50432:
// 1.58 / 0.79 ms at 67 TFLOP/s, the f32 rate outside the tensor cores; 0.64
// / 0.32 ms for the three TF32 products of each below at 495 TFLOP/s); each
// reads and writes only (m n + m^2) * 4 bytes once (0.25 ms at 3.35 TB/s).
//
// Design: products on the tensor cores in 3xTF32 (mma.sync m16n8k8, through
// mma_sm90.cuh).  Each f32 operand x is split into hi = x rounded to TF32
// (to nearest) and lo = x - hi, an f32 whose TF32 part the tensor core
// reads; per 8-wide contraction step the warp adds lo*hi, then hi*lo, then
// hi*hi into its f32 accumulator (the order of CUTLASS's "fast accurate"
// f32 mode; lo*lo is dropped).  wgmma would need both operands
// K-major in shared memory, and the apply contracts X over its rows;
// mma.sync takes fragments that the threads read from shared memory in any
// layout.
//   * Tiles: a 256-thread CTA (8 warps, 2 x 4, each 64 x 32) per 128 x 128
//     output tile; the contraction is staged 32 columns at a time through a
//     ring of 4 shared-memory stages filled by 16-byte cp.async (rows or
//     columns past the matrix are zero-filled, so partial tiles need no
//     other care: zeros add exact zeros), 128-130 KiB of dynamic shared
//     memory, one CTA per SM.  On at most 32 rows (the stacked norm
//     vectors') both kernels take 32 x 128 tiles instead (80-82 KiB; the
//     gram then has one tile), and a warp whose 16 x 32 block lies wholly past the
//     output (rows past m; for the gram also columns past m) skips its
//     products.  K-major tiles are stored with a 16-byte-chunk XOR
//     swizzle, so that each thread reads its two values of a fragment as one
//     conflict-free 8-byte load: the contraction index is relabelled within
//     each 8-column step (fragment k = t -> column 2t, k = t + 4 -> 2t + 1)
//     on both operands alike.  The apply's X tile is stored N-major with a
//     row stride of 132 floats (conflict-free scalar loads).
//   * Summation order: within one stage (4 steps x 3 products = 12 mma
//     calls) the tensor core accumulates; after each stage the warp adds the
//     stage's sum into a second accumulator with __fadd_rn and restarts from
//     zero.  So no chain of mma calls on one accumulator is longer than 12.
//   * Gram: only the upper output tiles (i <= j; 36 of 64 at m = 1024) are
//     computed, and the contraction is split into S contiguous chunks of
//     256-column tiles (TILE_N, as the JAX grid walks them; chunk s covers
//     tiles [s T / S, (s + 1) T / S) of T), one CTA per (tile, chunk), each
//     writing its partial to a workspace of S x m x m floats.  A second
//     kernel adds the S partials of each entry in chunk order and writes
//     A[i][j] and A[j][i] from the same sum; on a diagonal tile it takes the
//     upper entry for both (the tensor core's sum for (i, j) need not equal
//     its sum for (j, i)).  The result is exactly symmetric, and with no
//     atomics and a fixed order a run gives the same bits every time.  S is
//     chosen so that the CTAs fill whole waves of the SMs (the C entry
//     ns_gram_splits, which the wrapper calls: S = 11 at m = 1024, n =
//     50432, 396 CTAs = 3 waves of 132).
//   * Apply: no split; the epilogue adds (alpha * x) + acc, each rounded, as
//     the JAX package orders it.  CTAs walk the row tiles fastest, so the
//     CTAs that read one column block of X run together and it comes from
//     DRAM once.
//
// Parity bound.  Per product, the dropped lo*lo term costs at most
// 2^-22 |x y| (|lo| <= 2^-11 |x|) and the truncation of each lo to TF32 at
// most 2^-21 |x y|: |x y - computed| <= 5 * 2^-22 |x y|.  Within one mma the
// tensor core is not guaranteed to round its sum to nearest (it may align
// to the largest term and truncate), so take each mma call as adding up to
// one unit in the last place, 2^-23, of the magnitude of its result, biased
// towards zero: at most 12 * 2^-23 of the stage's sum of |x_k y_k| over a
// 12-call chain.  The adds of stage sums and of chunk partials round to
// nearest: (K / 32 + S) * 2^-24 in the worst case, ~sqrt(K / 32 + S) *
// 2^-24 in practice.  So an entry is off by at most ~(5 * 2^-22 + 12 * 2^-23
// + (K / 32 + S) * 2^-24) * sum_k |x_k y_k| (a worst case of 1.2e-5 at the
// head's K = 4608 per chunk, S = 11, with an expected size near 2e-6), and
// sum_k |x_ik x_jk| <= max_i A_ii, the largest entry of A; for the apply
// K = m.  The checks hold the kernels to 1e-5 of the output's largest
// magnitude against the tile-replaying plain versions.
#include "common.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;            // 8 warps: 2 (rows) x 4 (columns)
constexpr int kWarpCols = 32;            // columns of a warp's output tile
constexpr int kNi = kWarpCols / 8;       // n8 fragments per warp
constexpr int kTileCols = 4 * kWarpCols; // CTA output tile columns (128)
constexpr int kDepth = 32;               // contraction columns per stage
constexpr int kStages = 4;               // cp.async ring
constexpr int kColumnTile = 256;         // the gram's split unit (TILE_N)
constexpr int kNLd = kTileCols + 4;      // row stride of the N-major tile
constexpr int kNMajor = kDepth * kNLd;   // floats of an N-major stage tile
constexpr int kBKMajor = kTileCols * kDepth;  // floats of the gram's B tile
constexpr int kReduceTile = 32;

// A CTA's output tile has 2 kMi 16 rows: 128 (kMi = 4) or 32 (kMi = 1: at
// most 32 rows, such as the stacked norm vectors' 16, where a 128-row tile
// would be seven-eighths zeros).
template <int kMi>
struct Tile {
  static constexpr int kRows = 2 * kMi * 16;
  static constexpr int kKMajor = kRows * kDepth;  // floats of a K-major tile
};
template <int kMi>
using Acc = float[kMi][kNi][4];

template <int kMi>
constexpr int gram_smem() {
  return kStages * (Tile<kMi>::kKMajor + kBKMajor) * 4;
}
template <int kMi>
constexpr int apply_smem() {
  return kStages * (Tile<kMi>::kKMajor + kNMajor) * 4;
}

// Offset of column 4 * chunk of row `row` in a swizzled K-major tile (rows
// of kDepth floats): the 16-byte chunk index XOR 2 (row % 4).
__device__ __forceinline__ int kmajor_at(int row, int chunk) {
  return row * kDepth + ((chunk ^ ((row & 3) << 1)) << 2);
}

// s <- M[r0 .. r0 + rows_tile)[k0 .. k0 + 32) (row-major, stride ld; rows
// >= rows or columns >= cols read as zero).  cols % 4 == 0.
template <int kRowsTile>
__device__ __forceinline__ void load_kmajor(float* s, const float* M,
                                            int ld, int rows, int cols,
                                            int r0, int k0) {
#pragma unroll
  for (int i = 0; i < kRowsTile * kDepth / 4 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads, r = idx >> 3, c = idx & 7;
    const bool ok = r0 + r < rows && k0 + 4 * c < cols;
    const float* src = ok ? M + static_cast<size_t>(r0 + r) * ld + k0 + 4 * c
                          : M;
    cp_async_16(s + kmajor_at(r, c), src, ok);
  }
}

// s <- M[k0 .. k0 + 32)[c0 .. c0 + 128) with row stride kNLd (zeros outside
// rows x cols).  cols % 4 == 0.
__device__ __forceinline__ void load_nmajor(float* s, const float* M,
                                            int ld, int rows, int cols,
                                            int k0, int c0) {
#pragma unroll
  for (int i = 0; i < kDepth * kTileCols / 4 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads, r = idx >> 5, c = idx & 31;
    const bool ok = k0 + r < rows && c0 + 4 * c < cols;
    const float* src = ok ? M + static_cast<size_t>(k0 + r) * ld + c0 + 4 * c
                          : M;
    cp_async_16(s + r * kNLd + 4 * c, src, ok);
  }
}

// x = hi + lo exactly: hi = x rounded to TF32, lo = x - hi as an f32, of
// which the tensor core reads the TF32 part (it drops lo's last 2 of 13
// significant bits).  For a NaN x, lo is NaN.
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32_round(x);
  lo = __fsub_rn(x, hi);
}

// acc += (the stage's A rows) x (its B columns) over the kDepth columns of
// one stage, in 3xTF32; the columns past k_left are zeros, and the 32-row
// tile skips their steps.  sa: K-major rows of A; sb: K-major rows of B (the
// gram) or the N-major tile of B (the apply).  Fragment k = t is column
// 8 step + 2t of the stage and k = t + 4 column 8 step + 2t + 1, so that a
// thread reads both from a swizzled row as one 8-byte load, at
// row * kDepth + 2t + 8 (step ^ (g % 4)) (row % 8 == g).
template <int kMi, bool kBNMajor>
__device__ __forceinline__ void stage_product(const float* sa, const float* sb,
                                              Acc<kMi>& acc, int k_left,
                                              int wm, int wn, int g, int t) {
  const int a_at = (wm * kMi * 16 + g) * kDepth + 2 * t;
  const int b_at = kBNMajor ? 2 * t * kNLd + wn * kWarpCols + g
                            : (wn * kWarpCols + g) * kDepth + 2 * t;
#pragma unroll
  for (int step = 0; step < kDepth / 8; ++step) {
    // (only the 32-row tile, whose contraction m <= 32 is one stage: the
    // 128-row tiles keep the branch out of their scheduled loop)
    if constexpr (kMi == 1)
      if (8 * step >= k_left) break;
    const int swz = 8 * (step ^ (g & 3));
    float ah[kMi][4], al[kMi][4], bh[kNi][2], bl[kNi][2];
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi) {
      const float* row = sa + a_at + mi * 16 * kDepth + swz;
      const float2 top = *reinterpret_cast<const float2*>(row);
      const float2 bottom = *reinterpret_cast<const float2*>(row + 8 * kDepth);
      split(top.x, ah[mi][0], al[mi][0]);
      split(bottom.x, ah[mi][1], al[mi][1]);
      split(top.y, ah[mi][2], al[mi][2]);
      split(bottom.y, ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni) {
      float2 v;
      if constexpr (kBNMajor) {
        const float* col = sb + b_at + 8 * step * kNLd + ni * 8;
        v = make_float2(col[0], col[kNLd]);
      } else {
        v = *reinterpret_cast<const float2*>(sb + b_at + ni * 8 * kDepth +
                                             swz);
      }
      split(v.x, bh[ni][0], bl[ni][0]);
      split(v.y, bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni)
        mma_tf32_m16n8k8(acc[mi][ni], al[mi], bh[ni]);
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni)
        mma_tf32_m16n8k8(acc[mi][ni], ah[mi], bl[ni]);
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni)
        mma_tf32_m16n8k8(acc[mi][ni], ah[mi], bh[ni]);
  }
}

// tot = sum over the contraction's k_total columns, in stages of kDepth, of
// the 3xTF32 products, each stage summed on the tensor cores and added into
// tot with __fadd_rn, in stage order.  load(stage, slot) issues the
// cp.async copies of a stage into the ring slot at `slot`: A's K-major
// tile, then B's (K-major, or N-major for the apply).  In a 32-row tile, a
// warp that is not `active` takes part in the loads only, and its tot stays
// zero.
template <int kMi, bool kBNMajor, class Load>
__device__ __forceinline__ void product(Acc<kMi>& tot, int k_total,
                                        float* smem, bool active, Load load) {
  constexpr int kA = Tile<kMi>::kKMajor;
  constexpr int kSlot = kA + (kBNMajor ? kNMajor : kBKMajor);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  const int n_stages = (k_total + kDepth - 1) / kDepth;
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[mi][ni][e] = 0.f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) load(s, smem + s * kSlot);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_stages; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; slot (kt - 1) % kStages is free
    const int next = kt + kStages - 1;
    if (next < n_stages) load(next, smem + next % kStages * kSlot);
    cp_async_commit();
    // (only the 32-row tile skips: the 128-row tiles keep the branch out of
    // their scheduled loop)
    if constexpr (kMi == 1)
      if (!active) continue;
    const float* sa = smem + kt % kStages * kSlot;
    Acc<kMi> acc;
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    stage_product<kMi, kBNMajor>(sa, sa + kA, acc, k_total - kt * kDepth, wm,
                                 wn, g, t);
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tot[mi][ni][e] = __fadd_rn(tot[mi][ni][e], acc[mi][ni][e]);
  }
  cp_async_wait<0>();
}

// Whether this thread's warp's block of the CTA tile at (i0, j0) holds an
// entry of the rows x cols output (warp-uniform).
template <int kMi>
__device__ __forceinline__ bool warp_active(int i0, int j0, int rows,
                                            int cols) {
  const int warp = threadIdx.x >> 5;
  return i0 + (warp >> 2) * kMi * 16 < rows &&
         j0 + (warp & 3) * kWarpCols < cols;
}

// Calls f(mi, ni, h, row, col) for each of this thread's output pairs
// (row, col), (row, col + 1) of the CTA tile at (i0, j0): entries 2h and
// 2h + 1 of fragment (mi, ni).
template <int kMi, class F>
__device__ __forceinline__ void for_each_pair(int i0, int j0, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(mi, ni, h, i0 + (wm * kMi + mi) * 16 + g + 8 * h,
          j0 + wn * kWarpCols + ni * 8 + 2 * t);
}

// Partial gram of one upper tile pair (blockIdx.x, row-major over i <= j)
// over one contraction chunk (blockIdx.y of `splits`), into
// work[chunk][m][m].  kMi = 1 (32 x 128 tiles) only for m <= 32: one tile.
template <int kMi>
__global__ void __launch_bounds__(kThreads, 1)
ns_gram_kernel(const float* x, float* work, int m, int n, int splits) {
  using T = Tile<kMi>;
  RQ_DYNAMIC_SHARED(float, smem);
  const int tiles = (m + T::kRows - 1) / T::kRows;
  int ti = 0, rest = blockIdx.x;
  while (rest >= tiles - ti) rest -= tiles - ti++;
  const int tj = ti + rest, i0 = ti * T::kRows, j0 = tj * T::kRows;
  const int col_tiles = (n + kColumnTile - 1) / kColumnTile;
  const int chunk = blockIdx.y;
  const int k_begin = chunk * col_tiles / splits * kColumnTile;
  const int k_stop = (chunk + 1) * col_tiles / splits * kColumnTile;
  const int k_end = k_stop < n ? k_stop : n;
  Acc<kMi> tot;
  product<kMi, false>(tot, k_end - k_begin, smem,
                      warp_active<kMi>(i0, j0, m, m), [&](int s, float* slot) {
    const int k0 = k_begin + s * kDepth;
    load_kmajor<T::kRows>(slot, x, n, m, k_end, i0, k0);
    load_kmajor<kTileCols>(slot + T::kKMajor, x, n, m, k_end, j0, k0);
  });
  float* out = work + static_cast<size_t>(chunk) * m * m;
  for_each_pair<kMi>(i0, j0, [&](int mi, int ni, int h, int row, int col) {
    if (row < m && col < m)
      *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * m + col) =
          make_float2(tot[mi][ni][2 * h], tot[mi][ni][2 * h + 1]);
  });
}

// A[i][j] = A[j][i] = sum over chunks (in order) of work[chunk][i][j] for
// i <= j; one 32 x 32 block of the upper triangle per CTA (blockIdx.y <=
// blockIdx.x), written to both halves through shared memory.  On a
// diagonal block the entry below the diagonal takes the one above it.
__global__ void __launch_bounds__(kThreads)
ns_gram_reduce_kernel(const float* work, float* a, int m, int splits) {
  __shared__ float sum[kReduceTile][kReduceTile + 1];
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (bi > bj) return;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const size_t mm = static_cast<size_t>(m) * m;
  for (int r = ty; r < kReduceTile; r += kThreads / 32) {
    const int i = bi * kReduceTile + r, j = bj * kReduceTile + tx;
    float s = 0.f;
    if (i < m && j < m) {
      const float* w = work + static_cast<size_t>(i) * m + j;
      s = w[0];
      for (int c = 1; c < splits; ++c) s = __fadd_rn(s, w[c * mm]);
    }
    sum[r][tx] = s;
  }
  __syncthreads();
  for (int r = ty; r < kReduceTile; r += kThreads / 32) {
    const int i = bi * kReduceTile + r, j = bj * kReduceTile + tx;
    if (i < m && j < m)
      a[static_cast<size_t>(i) * m + j] =
          bi == bj && r > tx ? sum[tx][r] : sum[r][tx];
    const int it = bj * kReduceTile + r, jt = bi * kReduceTile + tx;
    if (bi != bj && it < m && jt < m)
      a[static_cast<size_t>(it) * m + jt] = sum[tx][r];
  }
}

// out = alpha X + B X: CTA (blockIdx.x, blockIdx.y) covers the row tile
// blockIdx.x (fastest) and the 128 columns from 128 blockIdx.y; the
// epilogue adds alpha * X as the JAX package orders it, (alpha * x) +
// (B X), each rounded.
template <int kMi>
__global__ void __launch_bounds__(kThreads, 1)
ns_apply_kernel(const float* x, const float* b, float* out, float alpha,
                int m, int n) {
  using T = Tile<kMi>;
  RQ_DYNAMIC_SHARED(float, smem);
  const int i0 = blockIdx.x * T::kRows, j0 = blockIdx.y * kTileCols;
  float2 xs[kMi][kNi][2];  // this thread's values of X for the epilogue
  const auto load_x = [&](int mi, int ni, int h, int row, int col) {
    xs[mi][ni][h] = row < m && col < n
                        ? *reinterpret_cast<const float2*>(
                              x + static_cast<size_t>(row) * n + col)
                        : make_float2(0.f, 0.f);
  };
  // a 32-row tile has few: read them before the product, so that the two
  // reads from device memory overlap
  if constexpr (kMi == 1) for_each_pair<kMi>(i0, j0, load_x);
  Acc<kMi> tot;
  product<kMi, true>(tot, m, smem, warp_active<kMi>(i0, j0, m, n),
                     [&](int s, float* slot) {
    load_kmajor<T::kRows>(slot, b, m, m, m, i0, s * kDepth);
    load_nmajor(slot + T::kKMajor, x, n, m, n, s * kDepth, j0);
  });
  if constexpr (kMi != 1) for_each_pair<kMi>(i0, j0, load_x);
  for_each_pair<kMi>(i0, j0, [&](int mi, int ni, int h, int row, int col) {
    if (row >= m || col >= n) return;
    const size_t at = static_cast<size_t>(row) * n + col;
    const float2 xv = xs[mi][ni][h];
    const float* v = tot[mi][ni] + 2 * h;
    *reinterpret_cast<float2*>(out + at) =
        make_float2(__fadd_rn(__fmul_rn(alpha, xv.x), v[0]),
                    __fadd_rn(__fmul_rn(alpha, xv.y), v[1]));
  });
}

template <int kMi>
int launch_gram(const float* x, float* work, int m, int n, int splits,
                cudaStream_t stream) {
  constexpr int smem = gram_smem<kMi>();
  const cudaError_t err = cudaFuncSetAttribute(
      ns_gram_kernel<kMi>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (m + Tile<kMi>::kRows - 1) / Tile<kMi>::kRows;
  const dim3 grid(tiles * (tiles + 1) / 2, splits), block(kThreads);
  ns_gram_kernel<kMi><<<grid, block, smem, stream>>>(x, work, m, n, splits);
  return static_cast<int>(cudaGetLastError());
}

template <int kMi>
int launch_apply(const float* x, const float* b, float* out, float alpha,
                 int m, int n, cudaStream_t stream) {
  constexpr int smem = apply_smem<kMi>();
  const cudaError_t err = cudaFuncSetAttribute(
      ns_apply_kernel<kMi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + Tile<kMi>::kRows - 1) / Tile<kMi>::kRows,
                  (n + kTileCols - 1) / kTileCols),
      block(kThreads);
  ns_apply_kernel<kMi><<<grid, block, smem, stream>>>(x, b, out, alpha, m, n);
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int m, int n) {
  return m > 0 && n > 0 && m % 4 == 0 && n % 64 == 0 && m <= n;
}

// Rows of the CTA tiles of both kernels for an m-row matrix.
int row_tile(int m) {
  return m <= Tile<1>::kRows ? Tile<1>::kRows : Tile<4>::kRows;
}

}  // namespace

// The gram's chunk count S for an (m, n) matrix on a card of `sms` SMs (0
// for a shape the kernels refuse).  The kernel runs one CTA per SM, for
// each upper tile pair (p = t (t + 1) / 2 of t row tiles) and chunk of
// whole 256-column tiles (T of them): S minimizes waves x tiles per chunk,
// ceil(p S / sms) ceil(T / S), the smallest S on a tie, so that the CTAs
// fill whole waves with even chunks.  S = 11 at (1024, 50432) on 132 SMs:
// 396 CTAs, 3 waves, chunks of 17-18 tiles.
extern "C" int ns_gram_splits(int m, int n, int sms) {
  if (!valid_shape(m, n) || sms < 1) return 0;
  const long t = (m + row_tile(m) - 1) / row_tile(m), pairs = t * (t + 1) / 2;
  const long col_tiles = (n + kColumnTile - 1) / kColumnTile;
  int best = 1;
  long best_cost = -1;
  for (int s = 1; s <= col_tiles; ++s) {
    const long cost = (pairs * s + sms - 1) / sms * ((col_tiles + s - 1) / s);
    if (best_cost < 0 || cost < best_cost) best = s, best_cost = cost;
  }
  return best;
}

// a: (m, m) f32 = x x^T for x (m, n) f32 row-major; work: splits x m x m
// f32 scratch, 1 <= splits <= ceil(n / 256).
extern "C" int ns_gram(const float* x, float* work, float* a, int m, int n,
                       int splits, cudaStream_t stream) {
  const int col_tiles = (n + kColumnTile - 1) / kColumnTile;
  if (!valid_shape(m, n) || splits < 1 || splits > col_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = row_tile(m) == Tile<1>::kRows
                      ? launch_gram<1>(x, work, m, n, splits, stream)
                      : launch_gram<4>(x, work, m, n, splits, stream);
  if (err != 0) return err;
  const int blocks = (m + kReduceTile - 1) / kReduceTile;
  const dim3 grid(blocks, blocks), block(kThreads);
  ns_gram_reduce_kernel<<<grid, block, 0, stream>>>(work, a, m, splits);
  return static_cast<int>(cudaGetLastError());
}

// out: (m, n) f32 = alpha x + b x for x (m, n), b (m, m), f32 row-major;
// out must not alias x.
extern "C" int ns_apply(const float* x, const float* b, float* out,
                        float alpha, int m, int n, cudaStream_t stream) {
  if (!valid_shape(m, n) || out == x)
    return static_cast<int>(cudaErrorInvalidValue);
  return row_tile(m) == Tile<1>::kRows
             ? launch_apply<1>(x, b, out, alpha, m, n, stream)
             : launch_apply<4>(x, b, out, alpha, m, n, stream);
}

#ifdef __CUDACC__
// rq_occupancy of the gram (which 0: ns_gram_kernel<kmi>), the apply (1:
// ns_apply_kernel<kmi>) or the gram's reduction (2: ns_gram_reduce_kernel),
// each with the dynamic shared memory it launches with; out: 5 ints.
extern "C" int ns_occupancy(int which, int kmi, int* out) {
  if (which == 2)
    return rq_occupancy(ns_gram_reduce_kernel, kThreads, 0, out);
  if (kmi != 1 && kmi != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (which == 0)
    return kmi == 1 ? rq_occupancy(ns_gram_kernel<1>, kThreads, gram_smem<1>(), out)
                    : rq_occupancy(ns_gram_kernel<4>, kThreads, gram_smem<4>(), out);
  if (which == 1)
    return kmi == 1 ? rq_occupancy(ns_apply_kernel<1>, kThreads, apply_smem<1>(), out)
                    : rq_occupancy(ns_apply_kernel<4>, kThreads, apply_smem<4>(), out);
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif
