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
// Bound on an H100: operations.  Each product is 2 m^2 n f32 operations
// (1.06e11 at m = 1024, n = 50432: 1.58 ms at 67 TFLOP/s, the f32 rate
// outside the tensor cores); it reads and writes only (m n + m^2) * 4 bytes
// once (0.25 ms at 3.35 TB/s).  The gram matrix is symmetric; this kernel
// computes all of it, not half.
//
// Design: a plain SIMT GEMM, full f32 (no TF32, no tensor cores; 3xTF32
// or wgmma are later work).  One 256-thread CTA per 64 x 64 output tile;
// per step the CTA stages a 64 x 16 slice of each operand in shared
// memory, transposed so that every thread reads four consecutive values of
// each as one float4, and each thread accumulates a 4 x 4 micro-tile in
// registers with explicit fmaf (the build's --fmad=false forbids only
// contraction the source did not ask for).  The CTA loops over the whole
// contraction dimension in one fixed order and no sum crosses CTAs (no
// split-K, no atomics), so a run gives the same bits every time.  Zero
// padding is exact: padded rows and columns add exact zeros.  Within a
// product the terms are added in another order than the plain version's
// library GEMM, so the results agree with the tile-replaying plain version
// to rounding, not bit for bit.
#include "common.cuh"

namespace {

constexpr int kTile = 64;   // output tile, rows and columns
constexpr int kDepth = 16;  // contraction slice staged per step
constexpr int kLd = kTile + 4;  // staged row stride (keeps float4 alignment)
constexpr int kColumnTile = 256;  // the gram's partial sums (TILE_N)

// acc[r][c] += sum_k s_a[k][4 ty + r] * s_b[k][4 tx + c] over one slice.
__device__ __forceinline__ void mma_slice(const float (*s_a)[kLd],
                                          const float (*s_b)[kLd],
                                          float (&acc)[4][4], int ty,
                                          int tx) {
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&s_a[k][4 * ty]);
    const float4 b = *reinterpret_cast<const float4*>(&s_b[k][4 * tx]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// s[k][r] = M[r0 + r][k0 + k] for r < 64, k < 16 (row-major M with row
// stride ld, `rows` x `cols` valid; zero outside).  cols % 4 == 0.
__device__ __forceinline__ void stage_transposed(const float* M, int ld,
                                                 int rows, int cols, int r0,
                                                 int k0, float (*s)[kLd]) {
  const int r = threadIdx.x >> 2, k = (threadIdx.x & 3) * 4;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r0 + r < rows && k0 + k < cols)
    v = *reinterpret_cast<const float4*>(M + static_cast<size_t>(r0 + r) * ld +
                                         k0 + k);
  s[k][r] = v.x;
  s[k + 1][r] = v.y;
  s[k + 2][r] = v.z;
  s[k + 3][r] = v.w;
}

// s[k][c] = M[k0 + k][c0 + c] for k < 16, c < 64 (row-major M with row
// stride ld, `rows` valid rows, all 64 columns valid; zero past the rows).
__device__ __forceinline__ void stage_direct(const float* M, int ld, int rows,
                                             int k0, int c0,
                                             float (*s)[kLd]) {
  const int k = threadIdx.x >> 4, c = (threadIdx.x & 15) * 4;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (k0 + k < rows)
    v = *reinterpret_cast<const float4*>(M + static_cast<size_t>(k0 + k) * ld +
                                         c0 + c);
  *reinterpret_cast<float4*>(&s[k][c]) = v;
}

// A = X X^T: CTA (bx, by) computes A[64 by.., 64 bx..] over all n, as the
// TPU kernel does: a partial sum per 256-column tile (FMAs in column
// order), the partials added in tile order — which also keeps the rounding
// error of a sum over n = 50432 near that of 256 + n / 256 terms.
__global__ void __launch_bounds__(256)
ns_gram_kernel(const float* x, float* a, int m, int n) {
  __shared__ __align__(16) float s_a[kDepth][kLd];
  __shared__ __align__(16) float s_b[kDepth][kLd];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  float acc[4][4] = {}, part[4][4] = {};
  for (int k0 = 0; k0 < n; k0 += kDepth) {
    stage_transposed(x, n, m, n, i0, k0, s_a);
    stage_transposed(x, n, m, n, j0, k0, s_b);
    __syncthreads();
    mma_slice(s_a, s_b, part, ty, tx);
    __syncthreads();
    if ((k0 + kDepth) % kColumnTile == 0 || k0 + kDepth >= n) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[r][c] = __fadd_rn(acc[r][c], part[r][c]);
          part[r][c] = 0.f;
        }
    }
  }
  const int col = j0 + 4 * tx;
  if (col >= m) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = i0 + 4 * ty + r;
    if (row < m)
      *reinterpret_cast<float4*>(a + static_cast<size_t>(row) * m + col) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// out = alpha X + B X: CTA (bx, by) computes out[64 by.., 64 bx..] over
// all m; the epilogue adds alpha * X as the JAX package orders it,
// (alpha * x) + (B X), each rounded.
__global__ void __launch_bounds__(256)
ns_apply_kernel(const float* x, const float* b, float* out, float alpha,
                int m, int n) {
  __shared__ __align__(16) float s_a[kDepth][kLd];
  __shared__ __align__(16) float s_b[kDepth][kLd];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < m; k0 += kDepth) {
    stage_transposed(b, m, m, m, i0, k0, s_a);
    stage_direct(x, n, m, k0, j0, s_b);
    __syncthreads();
    mma_slice(s_a, s_b, acc, ty, tx);
    __syncthreads();
  }
  const int col = j0 + 4 * tx;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = i0 + 4 * ty + r;
    if (row >= m) continue;
    const size_t at = static_cast<size_t>(row) * n + col;
    const float4 xv = *reinterpret_cast<const float4*>(x + at);
    *reinterpret_cast<float4*>(out + at) = make_float4(
        __fadd_rn(__fmul_rn(alpha, xv.x), acc[r][0]),
        __fadd_rn(__fmul_rn(alpha, xv.y), acc[r][1]),
        __fadd_rn(__fmul_rn(alpha, xv.z), acc[r][2]),
        __fadd_rn(__fmul_rn(alpha, xv.w), acc[r][3]));
  }
}

bool valid_shape(int m, int n) {
  return m > 0 && n > 0 && m % 4 == 0 && n % kTile == 0 && m <= n;
}

}  // namespace

// a: (m, m) f32 = x x^T for x (m, n) f32 row-major.
extern "C" int ns_gram(const float* x, float* a, int m, int n,
                       cudaStream_t stream) {
  if (!valid_shape(m, n)) return static_cast<int>(cudaErrorInvalidValue);
  const int t = (m + kTile - 1) / kTile;
  const dim3 grid(t, t), block(256);
  ns_gram_kernel<<<grid, block, 0, stream>>>(x, a, m, n);
  return static_cast<int>(cudaGetLastError());
}

// out: (m, n) f32 = alpha x + b x for x (m, n), b (m, m), f32 row-major;
// out must not alias x.
extern "C" int ns_apply(const float* x, const float* b, float* out,
                        float alpha, int m, int n, cudaStream_t stream) {
  if (!valid_shape(m, n) || out == x)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n / kTile, (m + kTile - 1) / kTile), block(256);
  ns_apply_kernel<<<grid, block, 0, stream>>>(x, b, out, alpha, m, n);
  return static_cast<int>(cudaGetLastError());
}
