// The 3xTF32 fragments of the fp32 attention bodies on Hopper's tensor
// cores (window_attn_long_tf32.cuh, the forward, and
// window_attn_long_tf32_bwd.cuh, the backward): mma.sync m16n8k8 with tf32
// operands and f32 sums, each f32 operand x taken as a pair of tf32 values,
// big = tf32(x) and small = tf32(x - big), rounded to the nearest with ties
// away from zero by two integer operations, and a b summed as small_a big_b
// + big_a small_b + big_a big_b (the dropped small_a small_b is about
// 2^-22 of |a b|). The bodies' precision is fp32-class whatever
// torch.backends.cuda.matmul.allow_tf32 says: they never read it.
//
// The m16n8k8 accumulator holds columns 2t and 2t + 1 of rows g and g + 8,
// where the A fragment takes columns t and t + 4, so each product's
// contraction index is permuted, A and B alike. The scores (a row tile
// against staged rows, tf32_rows): slots t and t + 4 of k-step j are head
// columns 8t + 2j and 8t + 2j + 1, so a lane's fragments of a row are its
// own 8 contiguous columns, two 16-byte loads for all four k-steps. The
// products over keys (tf32_cols): slot t of an 8-key step is key 2t, slot
// t + 4 key 2t + 1, so an accumulator tile of scores or probabilities is
// the next product's A fragment as it stands; column n of output tile jn
// is head column 4n + jn, so the B fragments of a key pair for all four
// output tiles are two 16-byte loads, and lane t ends up owning head
// columns 8t .. 8t + 7 of its rows (tf32_store). Tiles are f32 in shared
// memory at a row stride of 36 floats (4 banks mod 32): every one of these
// loads is free of bank conflicts and rows stay on 16 bytes for cp.async.
// Head widths below 32 are padded with zeros.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "mma_ptx.cuh"
#include "window_attn_long_mma.cuh"

namespace gsasr {

constexpr int kTLd = 36;  // row stride in shared memory, floats

// Floats per copy of a head row: 4 when every operand's head rows start on
// 16 bytes, else 1. Rows are C (or, head-major, hd) floats apart and head h
// starts at float h hd, so hd decides.
inline int tf32_vec(int hd, const void* const* ptrs, int n) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return 1;
  return hd % 4 == 0 ? 4 : 1;
}

// Rows [row0, row0 + rows) of a head's columns [n0, n0 + hd) (rows ldg
// apart) into `pad` rows of kTLd floats, rows past `rows` and columns past
// hd zeros, by a block of nthr threads: cp.async copies of vec floats,
// which the caller commits and waits for.
__device__ __forceinline__ void tf32_stage(float* dst,
                                           const float* __restrict__ src,
                                           size_t row0, int rows, int pad,
                                           int ldg, int n0, int hd, int vec,
                                           int nthr = kMThreads) {
  const int per = kLMaxHd / vec;
  for (int e = threadIdx.x; e < pad * per; e += nthr) {
    const int r = e / per;
    const int d = (e - r * per) * vec;
    const bool ok = r < rows && d < hd;
    const float* s = src + (row0 + (ok ? r : 0)) * ldg + n0 + (ok ? d : 0);
    if (vec == 4)
      cp_async16(dst + r * kTLd + d, s, ok ? 16 : 0);
    else
      cp_async4(dst + r * kTLd + d, s, ok ? 4 : 0);
  }
}

// x rounded to tf32 (a 10-bit mantissa, to the nearest, ties away from
// zero: cvt.rna.tf32.f32's bits for finite x) as an f32 bit pattern with
// its low 13 bits zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as a 3xTF32 pair: big = tf32(x), small = tf32(x - big).
__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

__device__ __forceinline__ void tf32_split4(const float (&a)[4],
                                            uint32_t (&big)[4],
                                            uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) tf32_split(a[i], big[i], small[i]);
}

// d += a b in 3xTF32: the A fragment as its pair (ab, as), the B
// fragment's two f32 values split here; the small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], float b0,
                                           float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  tf32_split(b0, bb0, bs0);
  tf32_split(b1, bb1, bs1);
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

// This lane's A fragments of rows r0 .. r0 + 15 of a tile for the four
// k-steps over the head's columns, as their pairs (ab, as): fragment j
// holds (row g, column 8t + 2j), (g + 8, 8t + 2j), (g, 8t + 2j + 1), (g +
// 8, 8t + 2j + 1).
__device__ __forceinline__ void tf32_load_a(uint32_t (&ab)[4][4],
                                            uint32_t (&as)[4][4],
                                            const float* tile, int r0) {
  const int lane = threadIdx.x & 31;
  const float* p = tile + (r0 + (lane >> 2)) * kTLd + 8 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 x =
          *reinterpret_cast<const float4*>(p + 8 * r * kTLd + 4 * h);
      tf32_split(x.x, ab[2 * h][r], as[2 * h][r]);
      tf32_split(x.y, ab[2 * h][2 + r], as[2 * h][2 + r]);
      tf32_split(x.z, ab[2 * h + 1][r], as[2 * h + 1][r]);
      tf32_split(x.w, ab[2 * h + 1][2 + r], as[2 * h + 1][2 + r]);
    }
}

// acc[n] = a . (rows r0 + 8 n .. r0 + 8 n + 7 of a tile)^T over the head's
// columns in 3xTF32, n < kN, a given as the pairs of tf32_load_a: the
// scores of 16 rows against 8 kN staged rows, in the accumulator layout
// (row g, key 8 n + 2t, + 1).
template <int kN>
__device__ __forceinline__ void tf32_rows(float (&acc)[kN][4],
                                          const uint32_t (&ab)[4][4],
                                          const uint32_t (&as)[4][4],
                                          const float* tile, int r0) {
  const int lane = threadIdx.x & 31;
  const float* p = tile + (r0 + (lane >> 2)) * kTLd + 8 * (lane & 3);
#pragma unroll
  for (int n = 0; n < kN; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // columns 8t + 4h .. 8t + 4h + 3 of each row: k-steps 2h and 2h + 1
    float4 b[kN];
#pragma unroll
    for (int n = 0; n < kN; ++n)
      b[n] = *reinterpret_cast<const float4*>(p + 8 * n * kTLd + 4 * h);
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int n = 0; n < kN; ++n)
        mma_3xtf32(acc[n], ab[2 * h + s], as[2 * h + s],
                   s ? b[n].z : b[n].x, s ? b[n].w : b[n].y);
  }
}

// acc[jn] += x . (rows r0 .. r0 + 7 of a tile) in 3xTF32, where x is an
// accumulator tile over 8 keys (launch 2: queries): slot t of the step is
// row r0 + 2t of the tile, slot t + 4 row r0 + 2t + 1, and column n of
// acc[jn] is head column 4n + jn.
__device__ __forceinline__ void tf32_cols(float (&acc)[4][4],
                                          const float (&x)[4],
                                          const float* tile, int r0) {
  const int lane = threadIdx.x & 31;
  const float a[4] = {x[0], x[2], x[1], x[3]};
  uint32_t ab[4], as[4];
  tf32_split4(a, ab, as);
  const float* p = tile + (r0 + 2 * (lane & 3)) * kTLd + 4 * (lane >> 2);
  const float4 b0 = *reinterpret_cast<const float4*>(p);
  const float4 b1 = *reinterpret_cast<const float4*>(p + kTLd);
  mma_3xtf32(acc[0], ab, as, b0.x, b1.x);
  mma_3xtf32(acc[1], ab, as, b0.y, b1.y);
  mma_3xtf32(acc[2], ab, as, b0.z, b1.z);
  mma_3xtf32(acc[3], ab, as, b0.w, b1.w);
}

// A product of tf32_cols times f into rows r0 + g and r0 + g + 8 (those
// below `rows`) of dst, rows ldg apart from row0, dst at the head's first
// column: lane t holds head columns 8t .. 8t + 7.
__device__ __forceinline__ void tf32_store(float* __restrict__ dst,
                                           const float (&acc)[4][4],
                                           size_t row0, int r0, int rows,
                                           int ldg, int hd, float f,
                                           int vec) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + (lane >> 2) + 8 * r;
    if (row >= rows) continue;
    float* o = dst + (row0 + row) * ldg + 8 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = 8 * t + 4 * e;
      const float x[4] = {acc[0][2 * r + e] * f, acc[1][2 * r + e] * f,
                          acc[2][2 * r + e] * f, acc[3][2 * r + e] * f};
      if (vec == 4) {
        if (d < hd)
          *reinterpret_cast<float4*>(o + 4 * e) =
              make_float4(x[0], x[1], x[2], x[3]);
      } else {
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
          if (d + jn < hd) o[4 * e + jn] = x[jn];
      }
    }
  }
}

}  // namespace gsasr
