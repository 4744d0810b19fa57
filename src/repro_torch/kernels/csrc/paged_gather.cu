// Paged gather-dequant of the serving KV cache: for every (slot b, logical
// page p), read physical page clip(table[b, p], 0, n_pages - 1), decode its
// (position, head) rows of 8-bit or packed 4-bit codes against the signed
// dynamic codebook and scale each row by its f32 absmax, written as f32 or
// bf16 to out[b, p * page : (p + 1) * page].
//
// Replaces the TPU kernel src/repro/kernels/paged_kv.py::_gather_kernel
// (pallas_call in _gather_pallas), where the page table rides scalar
// prefetch so each grid step DMAs one physical page into VMEM and the
// codebook lookup is a one-hot contraction on the MXU.
//
// Bound on an H100: memory.  Per (slot, page) it reads page * KV * W bytes
// of codes (W = Dh * bits / 8) and page * KV * 4 of absmax and writes
// page * KV * Dh values, 2 to 4 times the bytes it reads; no arithmetic to
// speak of (one multiply a value).
//
// Design: the output is what streams.  One CTA of 256 threads per (slot,
// logical page), grid B * P.  A physical page is one contiguous run of
// rows = page * KV rows and its output one contiguous run of rows * Dh
// values, so a page is a flat array of 16-byte output vectors (8 bf16 or 4
// f32 values) and thread t produces vectors t, t + 256, ...: one warp store
// covers 512 contiguous bytes.  A vector's codes are 8, 4 or 2 contiguous
// bytes (8-bit -> bf16, 4-bit -> bf16 or 8-bit -> f32, 4-bit -> f32), so a
// warp's loads are contiguous too, and its row is the vector's index
// shifted right by log2(Dh / values) (no division).  The pointers are
// __restrict__ and a thread loads the codes and row absmax of 8 vectors (a
// chunk) through the read-only path before it decodes any of them, and
// the next chunk's before it stores the current one: at the serve shapes
// every load of a page is in flight at once.  (A copy of the page into
// shared memory by one cp.async.bulk, and CTAs walking several pages with
// the next page's loads ahead, both ran slower on an H100: PERF.md.)
// Shapes outside the 16-byte mapping (Dh not a multiple of the values per
// vector, or Dh / values not a power of two) take a plain kernel that
// stores one value a thread.
//
// The table entry is clipped as the JAX package does (an unallocated -1
// reads page 0, masked downstream); the codebook (2^bits entries) sits in
// shared memory.  Codes at 4 bits are MSB-first: the high nibble is the
// first code.  The product is __fmul_rn in f32, then __float2bfloat16_rn
// for bf16 output: the plain version's (cb[idx] * absmax).to(dtype), bit
// for bit.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kUnroll = 8;      // vectors of a thread's chunk

// Values in one 16-byte output vector.
template <typename OutT>
__host__ __device__ constexpr int vals() {
  return 16 / static_cast<int>(sizeof(OutT));
}

// A vector's codes (CB = 8, 4 or 2 bytes) as one little-endian word pair,
// one word or the low half of one, through the read-only path.
template <int CB>
__device__ __forceinline__ uint2 load_codes(const uint8_t* p) {
  uint2 w;
  w.y = 0u;
  if constexpr (CB == 8)
    w = __ldg(reinterpret_cast<const uint2*>(p));
  else if constexpr (CB == 4)
    w.x = __ldg(reinterpret_cast<const unsigned*>(p));
  else
    w.x = __ldg(reinterpret_cast<const unsigned short*>(p));
  return w;
}

// Codebook value of code j of a vector's words: at 8 bits byte j; at 4
// bits the high nibble of byte j / 2 for even j, the low one for odd j.
// The code is shifted straight to its byte offset in the table.
template <int BITS>
__device__ __forceinline__ float code_value(uint2 w, int j, const float* lut) {
  if constexpr (BITS == 8) {
    return rq::decode8(w, j, lut);
  } else {
    const int sh = 8 * (j >> 1) + ((j & 1) ? 0 : 4);
    const uint32_t off = (sh ? w.x >> (sh - 2) : w.x << 2) & 0x3Cu;
    return *reinterpret_cast<const float*>(
        reinterpret_cast<const char*>(lut) + off);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
          << 16);
}

// Decode one vector, scale it by its row's absmax and store it (16 bytes).
template <int BITS>
__device__ __forceinline__ void put_vector(float* dst, uint2 w, float a,
                                           const float* lut) {
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = __fmul_rn(code_value<BITS>(w, j, lut), a);
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

template <int BITS>
__device__ __forceinline__ void put_vector(__nv_bfloat16* dst, uint2 w,
                                           float a, const float* lut) {
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __fmul_rn(code_value<BITS>(w, j, lut), a);
  uint4 q;
  q.x = pack_bf16(v[0], v[1]);
  q.y = pack_bf16(v[2], v[3]);
  q.z = pack_bf16(v[4], v[5]);
  q.w = pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(dst) = q;
}

__device__ __forceinline__ int clip_page(int page, int n_pages) {
  return page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
}

// Issue the loads of a thread's chunk, vectors v0, v0 + 256, ... of the
// page at src / am: codes and row absmax.
template <int CB>
__device__ __forceinline__ void fetch_chunk(const uint8_t* __restrict__ src,
                                            const float* __restrict__ am,
                                            int shift, int n_vec, int v0,
                                            uint2 (&w)[kUnroll],
                                            float (&a)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int v = v0 + u * rq::kThreads;
    if (v < n_vec) {
      w[u] = load_codes<CB>(src + static_cast<size_t>(v) * CB);
      a[u] = __ldg(am + (v >> shift));
    }
  }
}

// One CTA per item b * P + p; the page in chunks of 256 * kUnroll vectors,
// each chunk's loads issued before the previous chunk is decoded.  At most
// 64 registers, so that 4 CTAs fit on an SM: the serve path's 512 pages
// are then one wave on an H100's 132 SMs.
template <typename OutT, int BITS>
__global__ void __launch_bounds__(rq::kThreads, 4)
paged_gather_kernel(const uint8_t* __restrict__ codes,
                    const float* __restrict__ absmax,
                    const int32_t* __restrict__ table,
                    const float* __restrict__ qmap, OutT* __restrict__ out,
                    int n_pages, int rows, int shift) {
  constexpr int V = vals<OutT>(), CB = V * BITS / 8;
  constexpr int kChunk = rq::kThreads * kUnroll;
  __shared__ float lut[1 << BITS];
  const int n_vec = rows << shift;
  const int item = blockIdx.x;
  const int page = clip_page(__ldg(table + item), n_pages);
  const uint8_t* src = codes + static_cast<size_t>(page) * n_vec * CB;
  const float* am = absmax + static_cast<size_t>(page) * rows;
  OutT* dst = out + static_cast<size_t>(item) * n_vec * V;
  uint2 w[kUnroll];
  float a[kUnroll];
  fetch_chunk<CB>(src, am, shift, n_vec, threadIdx.x, w, a);
  for (int i = threadIdx.x; i < (1 << BITS); i += rq::kThreads)
    lut[i] = __ldg(qmap + i);
  __syncthreads();
  for (int v0 = threadIdx.x;; v0 += kChunk) {
    const bool more = v0 + kChunk < n_vec;
    uint2 nw[kUnroll];
    float na[kUnroll];
    if (more) fetch_chunk<CB>(src, am, shift, n_vec, v0 + kChunk, nw, na);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * rq::kThreads;
      if (v < n_vec)
        put_vector<BITS>(dst + static_cast<size_t>(v) * V, w[u], a[u], lut);
    }
    if (!more) break;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      w[u] = nw[u];
      a[u] = na[u];
    }
  }
}

__device__ __forceinline__ void put_value(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void put_value(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// Any row width: one CTA per item, one value a thread.
template <typename OutT, int BITS>
__global__ void __launch_bounds__(rq::kThreads)
paged_gather_any_kernel(const uint8_t* __restrict__ codes,
                        const float* __restrict__ absmax,
                        const int32_t* __restrict__ table,
                        const float* __restrict__ qmap,
                        OutT* __restrict__ out, int n_pages, int rows,
                        int row_width) {
  __shared__ float lut[1 << BITS];
  for (int i = threadIdx.x; i < (1 << BITS); i += blockDim.x)
    lut[i] = qmap[i];
  const int item = blockIdx.x;
  const int page = clip_page(table[item], n_pages);
  const int dh = row_width * 8 / BITS, n = rows * dh;
  const uint8_t* src =
      codes + static_cast<size_t>(page) * rows * row_width;
  const float* am = absmax + static_cast<size_t>(page) * rows;
  OutT* dst = out + static_cast<size_t>(item) * n;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / dh, d = i - r * dh;
    uint32_t c = src[static_cast<size_t>(r) * row_width + d * BITS / 8];
    if (BITS == 4) c = (d & 1) ? (c & 15u) : (c >> 4);
    put_value(dst + i, __fmul_rn(lut[c], am[r]));
  }
}

// log2(Dh / values) of the 16-byte mapping, or -1 where it does not fit.
int vector_shift(int row_width, int bits, int values) {
  const int dh = row_width * 8 / bits;
  if (dh % values) return -1;
  const int g = dh / values;
  if (g & (g - 1)) return -1;
  int s = 0;
  while ((1 << s) < g) ++s;
  return s;
}

template <typename OutT, int BITS>
int launch(const uint8_t* codes, const float* absmax, const int32_t* table,
           const float* qmap, void* out_v, int n_pages, int rows,
           int row_width, int n_items, cudaStream_t stream) {
  OutT* out = static_cast<OutT*>(out_v);
  const dim3 grid(n_items), block(rq::kThreads);
  const int shift = vector_shift(row_width, BITS, vals<OutT>());
  if (shift < 0) {
    paged_gather_any_kernel<OutT, BITS><<<grid, block, 0, stream>>>(
        codes, absmax, table, qmap, out, n_pages, rows, row_width);
    return static_cast<int>(cudaGetLastError());
  }
  paged_gather_kernel<OutT, BITS><<<grid, block, 0, stream>>>(
      codes, absmax, table, qmap, out, n_pages, rows, shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// codes: (n_pages, rows, row_width) uint8 with rows = page * KV and
// row_width = Dh * bits / 8; absmax: (n_pages, rows) f32; table:
// (n_slots, pages_per_seq) int32; qmap: 2^bits entries; out:
// (n_slots, pages_per_seq * rows, Dh) f32 or bf16.
extern "C" int paged_gather(const uint8_t* codes, const float* absmax,
                            const int32_t* table, const float* qmap,
                            void* out, int out_bf16, int n_pages, int rows,
                            int row_width, int bits, int n_slots,
                            int pages_per_seq, cudaStream_t stream) {
  if (n_slots == 0 || pages_per_seq == 0 || rows == 0) return 0;
  if (n_pages <= 0 || row_width <= 0 || n_slots > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_items = n_slots * pages_per_seq;
  if (bits == 8)
    return out_bf16 ? launch<__nv_bfloat16, 8>(codes, absmax, table, qmap,
                                               out, n_pages, rows, row_width,
                                               n_items, stream)
                    : launch<float, 8>(codes, absmax, table, qmap, out,
                                       n_pages, rows, row_width, n_items,
                                       stream);
  if (bits == 4)
    return out_bf16 ? launch<__nv_bfloat16, 4>(codes, absmax, table, qmap,
                                               out, n_pages, rows, row_width,
                                               n_items, stream)
                    : launch<float, 4>(codes, absmax, table, qmap, out,
                                       n_pages, rows, row_width, n_items,
                                       stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef __CUDACC__
namespace {

template <typename OutT, int BITS>
int occupancy(int any, int* out) {
  return any ? rq_occupancy(paged_gather_any_kernel<OutT, BITS>, rq::kThreads, 0, out)
             : rq_occupancy(paged_gather_kernel<OutT, BITS>, rq::kThreads, 0, out);
}

}  // namespace

// rq_occupancy of paged_gather_kernel (any 0) or paged_gather_any_kernel
// (any 1) <f32 or bf16 (out_bf16), bits 8 or 4>; out: 5 ints.
extern "C" int paged_gather_occupancy(int any, int out_bf16, int bits,
                                      int* out) {
  if (bits == 8)
    return out_bf16 ? occupancy<__nv_bfloat16, 8>(any, out)
                    : occupancy<float, 8>(any, out);
  if (bits == 4)
    return out_bf16 ? occupancy<__nv_bfloat16, 4>(any, out)
                    : occupancy<float, 4>(any, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif
