// Helpers for the tensor-core kernels (newton_schulz.cu): 16-byte cp.async
// copies into shared memory, TF32 rounding and the TF32 mma.sync.m16n8k8
// product.  Every use of inline PTX in those kernels goes through these
// helpers, so that the kernels' logic can be checked on a host with a
// version of this header that copies synchronously and computes the product
// in plain f32 (tests/test_torch_kernels_emulated.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// dst (shared) <- 16 bytes at src (global), asynchronously; zeros when
// !valid (src is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Close the group of this thread's cp.async copies issued since the last
// commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
// from zero, as cvt.rna.tf32.f32 rounds a finite x (+-inf stay), in two
// integer operations (the cvt compiles to a longer sequence with a NaN
// test); the low 13 bits of the result are zero.  A NaN may come out as another value: x - tf32_round(x)
// is then NaN, so a NaN still reaches the product through it.
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// d += a b for one warp: a the 16 x 8 row-major A fragment, b the 8 x 8
// column-major B fragment, d the 16 x 8 f32 accumulator, each as the PTX ISA
// lays mma.m16n8k8 .tf32 fragments over the lanes (g = lane / 4, t = lane %
// 4): a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]}, b = {B[t][g],
// B[t+4][g]}, d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.  The
// tensor core reads the TF32 part of each f32 register of a and b (sign,
// exponent and the top 10 mantissa bits: an f32 is truncated), forms the
// products exactly, and need not round its sum of eight products and d to
// nearest.
__device__ __forceinline__ void mma_tf32_m16n8k8(float (&d)[4],
                                                 const float (&a)[4],
                                                 const float (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
        "r"(__float_as_uint(b[0])), "r"(__float_as_uint(b[1])));
}
