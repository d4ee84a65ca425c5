// Split-TF32 matrix products on the tensor cores (sm_90a), shared by the
// kernels that hold f32 accuracy with TF32 MMAs (moe_gemm.cu, swa.cu):
// asynchronous tile copies, the hi/lo split of an f32 operand, and the
// warp-level m16n8k8 TF32 MMA with f32 accumulation.
//
// Fragment layouts of mma.sync.m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16x8, row):  a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
//                   a3 = A[g+8][t+4]
//   B (8x8, col):   b0 = B[t][g], b1 = B[t+4][g]
//   C (16x8):       c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t],
//                   c3 = C[g+8][2t+1]
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32mma {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 or 4 bytes from gmem to smem; valid == false writes zeros.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem,
                                         bool valid) {
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(smem)),
                 "l"(gmem), "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(smem)),
                 "l"(gmem), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N_PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N_PENDING) : "memory");
}

// tf32(a): a rounded to 10 mantissa bits, to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds finite values, in two integer operations
// (the conversion instruction issues at a quarter of their rate).
__device__ __forceinline__ unsigned tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}

// hi = tf32(a), lo = tf32(a - hi); a - hi is exact in f32.
__device__ __forceinline__ void split_tf32(float a, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// c += a (16x8, row) * b (8x8, col) in TF32 with f32 accumulation.
__device__ __forceinline__ void mma_tf32(float* c, const unsigned* a,
                                         const unsigned* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b as three TF32 products of the split operands, small terms
// first (lo·hi, hi·lo, hi·hi); lo·lo (2^-22 |a||b|) is dropped.
__device__ __forceinline__ void mma_split3(float* c, const unsigned* ahi,
                                           const unsigned* alo,
                                           const unsigned* bhi,
                                           const unsigned* blo) {
  mma_tf32(c, alo, bhi);
  mma_tf32(c, ahi, blo);
  mma_tf32(c, ahi, bhi);
}

}  // namespace tf32mma
