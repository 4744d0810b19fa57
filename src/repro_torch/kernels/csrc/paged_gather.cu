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
// page * KV * Dh values; no arithmetic to speak of (one multiply a value).
//
// Design: one 256-thread CTA per (slot, logical page), grid (P, B).  The
// CTA loads its table entry once (one uniform load), clips it as the JAX
// package does (an unallocated -1 reads page 0, masked downstream), and
// keeps the 2^bits codebook in shared memory.  A physical page is one
// contiguous run of page * KV rows, and its output is one contiguous run of
// page * KV * Dh values, so the CTA streams it as a flat array: each thread
// takes VEC bytes of codes at a time (VEC = 16, one 16-byte load, when
// W is a multiple of 16 so that a load stays inside one row; else 1), looks
// up the row's absmax, and stores 16 or 32 values with vector stores.
// Codes at 4 bits are MSB-first: the high nibble is the first code.  The
// product is __fmul_rn in f32, then __float2bfloat16_rn for bf16 output:
// the plain version's (cb[idx] * absmax).to(dtype), bit for bit.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

template <int N>
__device__ __forceinline__ void store_vals(float* out, const float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(out + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = v[i];
  }
}

template <int N>
__device__ __forceinline__ void store_vals(__nv_bfloat16* out,
                                           const float* v) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = static_cast<uint32_t>(
                   __bfloat16_as_ushort(__float2bfloat16_rn(v[i + 2 * j]))) |
               (static_cast<uint32_t>(__bfloat16_as_ushort(
                    __float2bfloat16_rn(v[i + 2 * j + 1])))
                << 16);
      uint4 q;
      q.x = w[0];
      q.y = w[1];
      q.z = w[2];
      q.w = w[3];
      *reinterpret_cast<uint4*>(out + i) = q;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __float2bfloat16_rn(v[i]);
  }
}

template <typename OutT, int BITS, int VEC>
__global__ void __launch_bounds__(rq::kThreads)
paged_gather_kernel(const uint8_t* codes, const float* absmax,
                    const int32_t* table, const float* qmap, OutT* out,
                    int n_pages, int rows, int row_width, int pages_per_seq) {
  constexpr int kLevels = 1 << BITS;
  constexpr int kPerByte = 8 / BITS;
  __shared__ float lut[kLevels];
  for (int i = threadIdx.x; i < kLevels; i += blockDim.x) lut[i] = qmap[i];
  const int p = blockIdx.x, b = blockIdx.y;
  int page = table[static_cast<size_t>(b) * pages_per_seq + p];
  page = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
  __syncthreads();

  const size_t page_bytes = static_cast<size_t>(rows) * row_width;
  const uint8_t* src = codes + static_cast<size_t>(page) * page_bytes;
  const float* am = absmax + static_cast<size_t>(page) * rows;
  OutT* dst = out + (static_cast<size_t>(b) * pages_per_seq + p) *
                        page_bytes * kPerByte;
  const int n_vec = static_cast<int>(page_bytes / VEC);
  for (int v = threadIdx.x; v < n_vec; v += blockDim.x) {
    const int byte0 = v * VEC;
    const float a = am[byte0 / row_width];
    uint32_t c[VEC];
    if constexpr (VEC == 16) {
      const uint4 q = *reinterpret_cast<const uint4*>(src + byte0);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 16; ++i)
        c[i] = (w[i >> 2] >> (8 * (i & 3))) & 0xFFu;   // little-endian
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) c[i] = src[byte0 + i];
    }
    float vals[VEC * kPerByte];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if constexpr (BITS == 8) {
        vals[i] = __fmul_rn(rq::decode(c[i], lut), a);
      } else {
        vals[2 * i] = __fmul_rn(rq::decode(c[i] >> 4, lut), a);
        vals[2 * i + 1] = __fmul_rn(rq::decode(c[i] & 15u, lut), a);
      }
    }
    store_vals<VEC * kPerByte>(dst + static_cast<size_t>(byte0) * kPerByte,
                               vals);
  }
}

template <int BITS, int VEC>
int launch(const uint8_t* codes, const float* absmax, const int32_t* table,
           const float* qmap, void* out, int out_bf16, int n_pages, int rows,
           int row_width, int n_slots, int pages_per_seq,
           cudaStream_t stream) {
  const dim3 grid(pages_per_seq, n_slots), block(rq::kThreads);
  if (out_bf16)
    paged_gather_kernel<__nv_bfloat16, BITS, VEC><<<grid, block, 0, stream>>>(
        codes, absmax, table, qmap, static_cast<__nv_bfloat16*>(out), n_pages,
        rows, row_width, pages_per_seq);
  else
    paged_gather_kernel<float, BITS, VEC><<<grid, block, 0, stream>>>(
        codes, absmax, table, qmap, static_cast<float*>(out), n_pages, rows,
        row_width, pages_per_seq);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS>
int dispatch(const uint8_t* codes, const float* absmax, const int32_t* table,
             const float* qmap, void* out, int out_bf16, int n_pages,
             int rows, int row_width, int n_slots, int pages_per_seq,
             cudaStream_t stream) {
  if (row_width % 16 == 0)
    return launch<BITS, 16>(codes, absmax, table, qmap, out, out_bf16,
                            n_pages, rows, row_width, n_slots, pages_per_seq,
                            stream);
  return launch<BITS, 1>(codes, absmax, table, qmap, out, out_bf16, n_pages,
                         rows, row_width, n_slots, pages_per_seq, stream);
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
  if (bits == 8)
    return dispatch<8>(codes, absmax, table, qmap, out, out_bf16, n_pages,
                       rows, row_width, n_slots, pages_per_seq, stream);
  if (bits == 4)
    return dispatch<4>(codes, absmax, table, qmap, out, out_bf16, n_pages,
                       rows, row_width, n_slots, pages_per_seq, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
