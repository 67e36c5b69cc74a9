// Pieces shared by the tensor-core kernels (flash_attention.cu,
// fused_effnet.cu): rounding to the compute type, cp.async copies into
// shared memory, and the two mma.sync shapes they issue.
//
//   * mma_tf32: m16n8k8, TF32 operands, float32 accumulate.  A float32
//     product to float32 accuracy is three of them (3xTF32: a_lo b_hi +
//     a_hi b_lo + a_hi b_hi, with the split below).
//   * mma_bf16: m16n8k16, bf16 operands, float32 accumulate: what a product
//     of bf16 operands with a float32 sum is, at the card's bf16 rate.
// The tensor cores round their float32 sums toward zero: a long sum carried
// in their accumulator drifts (1e-4 of its size over 16512 terms), so the
// float32 kernels sum each chunk from zero and add chunks with float32 adds.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// round to the input type, back in float32
template <typename T>
__device__ __forceinline__ float round_as(float x);
template <>
__device__ __forceinline__ float round_as<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// two neighbouring elements (i even: one 8- or 4-byte read)
__device__ __forceinline__ float2 ld_f32x2(const float* s, int i) {
  return *reinterpret_cast<const float2*>(s + i);
}
__device__ __forceinline__ float2 ld_f32x2(const __nv_bfloat16* s, int i) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s + i));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cvt.rna.tf32.f32 (to 10 mantissa bits, ties away from zero) in integer
// arithmetic, bit for bit the same for finite x: the split is the kernels'
// busiest arithmetic, and an integer add and a logical and issue at a
// higher rate than the conversion instruction.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo in TF32.  With SPLIT false (bf16 inputs, and p / ds already
// rounded to bf16) x is exact in TF32: hi is x and lo is never read.
template <bool SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (SPLIT) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// c += a * b for one m16n8k8 TF32 tile (float32 accumulate)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b for one m16n8k16 bf16 tile (float32 accumulate).  Each
// register holds two neighbouring bf16 of a row: a0 = A[g][2t..2t+1],
// a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]; b0 =
// B[2t..2t+1][g], b1 = B[2t+8..][g]; c0, c1 = C[g][2t..2t+1], c2, c3 =
// C[g+8][2t..2t+1] (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
