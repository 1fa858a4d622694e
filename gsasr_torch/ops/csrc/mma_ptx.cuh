// The warp-level tensor-core and copy instructions of the window attention
// bodies on the tensor cores (window_attn_long_mma.cuh,
// window_attn_long_mma_bwd.cuh, window_attn_short_mma*.cuh and the fp32
// window_attn_long_tf32_bwd.cuh), as inline PTX for sm_90a: mma.sync
// m16n8k16 with bf16 operands and m16n8k8 with tf32 operands, both with f32
// sums, ldmatrix (plain and transposed) from shared memory, and cp.async
// with zero fill. No library headers beyond CUDA's own.
//
// Fragments of mma.sync.m16n8k16.row.col (g = lane / 4, t = lane % 4; each
// 32-bit register holds two bf16, the lower column in the low half):
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                           a3 (g+8, 2t+8..)
//   B (16 x 8, "col"):      b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C, D (16 x 8, f32):     c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
//                           c3 (g+8, 2t+1)
// So the accumulators of two neighbouring 8-column tiles, packed in pairs,
// are the A fragment of the next product over those 16 columns.
//
// Fragments of mma.sync.m16n8k8.row.col with tf32 operands (one value a
// register):
//   A (16 x 8, row-major): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, "col"):      b0 (k t, n g), b1 (k t+4, n g)
//   C, D (16 x 8, f32):    as m16n8k16's
// So an accumulator tile is the next product's A fragment only with its
// contraction index permuted (window_attn_long_tf32_bwd.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace gsasr {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices: lanes 8i..8i+7 give the 16-byte row addresses of
// matrix i, register i gets lane l's (row l / 4, columns 2 (l % 4), +1) of
// it; transposed, (rows 2 (l % 4), +1, column l / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b on the tensor cores: bf16 products, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b on the tensor cores: tf32 products, f32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Asynchronous copies of 16 or 4 bytes into shared memory; of `bytes` (the
// full size or 0) the rest is filled with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n of this thread's copy groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// Two f32 values rounded to bf16 (to the nearest even) in one register, lo
// in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace gsasr
