// Tensor-core and asynchronous-copy helpers of the bf16 kernels (K3 and
// K4): 16-byte cp.async with zero fill, ldmatrix, and the bf16 -> f32
// mma.sync.m16n8k16.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 g + t):
//   A 16 x 16, 4 regs:  a0 (row g, cols 2t, 2t+1)  a1 (row g+8, same)
//                        a2 (row g, cols 2t+8, +9)  a3 (row g+8, same)
//   B 16 x 8,  2 regs:  b0 (rows 2t, 2t+1, col g)   b1 (rows 2t+8, +9, col g)
//   C 16 x 8,  4 f32:   c0, c1 (row g, cols 2t, 2t+1)  c2, c3 (row g+8, same)
// ldmatrix.x4 loads four 8 x 8 matrices, lanes 8i..8i+7 giving the row
// addresses of matrix i; lane 4 g + t receives (row g, cols 2t, 2t+1) of
// each, or with .trans (rows 2t, 2t+1, col g).  The accumulator of two
// adjacent n8 tiles, rounded to bf16 in pairs, is an A fragment.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid false nothing is read and the
// destination is zero-filled (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16 x 16, bf16) @ b (16 x 8, bf16), in f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace
