// Shared pieces of the window-attention kernels (window_attn_fwd.cu,
// window_attn_bwd.cu, in their plain and masked forms): their limits, the
// shared-memory layout of one head's operands, staging a head from the
// packed layout, and the softmax numerators of one score row held by a
// warp.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

#include "tile_gemm.cuh"

namespace gsasr {

// A warp holds kQRows query rows of scores at once; lane l owns keys
// l + 32 m for m < kKeysPer, so Tk <= kMaxT.
constexpr int kKeysPer = 5;
constexpr int kMaxT = 32 * kKeysPer;  // 160
constexpr int kMaxHd = 32;
constexpr int kQRows = 4;

// One head's q (Tq rows) and k, v (Tk rows) of hd columns in shared memory,
// rows padded to an odd stride.
struct HeadLayout {
  int ld, q_floats, kv_floats;
  __host__ __device__ HeadLayout(int Tq, int Tk, int hd)
      : ld(hd | 1), q_floats(Tq * (hd | 1)), kv_floats(Tk * (hd | 1)) {}
};

// The (Tq, Tk) mask of window `win`: window win of a (B, ...) batch takes
// class win % nW of the (nW, Tq, Tk) mask (the Swin SW-MSA convention).
__device__ __forceinline__ const float* window_mask(const float* mask,
                                                   int win, int nW, int Tq,
                                                   int Tk) {
  return mask + static_cast<size_t>(win % nW) * Tq * Tk;
}

// dst[r * ld + d] = src[(row0 + r) * C + n0 + d] for r < rows, d < hd.
__device__ __forceinline__ void stage_head(const float* __restrict__ src,
                                           size_t row0, int rows, int C,
                                           int n0, int hd, float* dst,
                                           int ld) {
  for (int e = threadIdx.x; e < rows * hd; e += kThreads) {
    const int r = e / hd;
    const int d = e - r * hd;
    dst[r * ld + d] = src[(row0 + r) * C + n0 + d];
  }
}

// Turns one row of raw scores s (this lane's keys) into the softmax's
// numerators, exp(s * scale + bias_row[j] (+ mask_row[j]) - row max), and
// returns their sum over the row; the caller divides by it. The mask is a
// compile-time form (kMask), so the unmasked kernels compile as without it.
// Entries of keys j >= Tk are left as they are. Called by a whole warp.
template <bool kMask = false>
__device__ __forceinline__ float softmax_exp_row(float (&s)[kKeysPer],
                                                 const float* bias_row,
                                                 int Tk, float scale,
                                                 const float* mask_row = nullptr) {
  const int lane = threadIdx.x & 31;
  float mx = -INFINITY;
#pragma unroll
  for (int m = 0; m < kKeysPer; ++m) {
    const int j = lane + 32 * m;
    if (j < Tk) {
      s[m] = s[m] * scale;
      if (bias_row) s[m] += bias_row[j];
      if constexpr (kMask) s[m] += mask_row[j];
      mx = fmaxf(mx, s[m]);
    }
  }
  mx = warp_max(mx);
  float sum = 0.f;
#pragma unroll
  for (int m = 0; m < kKeysPer; ++m) {
    const int j = lane + 32 * m;
    if (j < Tk) {
      s[m] = expf(s[m] - mx);
      sum += s[m];
    }
  }
  return warp_sum(sum);
}

}  // namespace gsasr
