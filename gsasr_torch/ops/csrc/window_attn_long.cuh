// The window-16 limits and the FMA helpers of AB-long's backward body
// (window_attn_long_bwd.cuh): the shapes the window-16 forms take (any Tq and
// Tk, a head width up to 32), head-column staging, the scores of a warp's
// query rows against a staged key tile on the CUDA cores (long_scores: scaled,
// then the bias, each step rounded on its own, so that every pass forms the
// same bits) and Swin's per-window-class mask, which the tensor-core bodies
// add after the bias. The forward forms (W-long, WM-long, W4-long, A-long's
// attention) run tensor-core bodies: window_attn_long_tf32.cuh in fp32,
// window_attn_long_mma.cuh in bf16; the fp32 backward beyond 160 tokens runs
// window_attn_long_tf32_bwd.cuh.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

#include "tile_gemm.cuh"

namespace gsasr {

// Its own names throughout: ln_attn.cu, which includes it, keeps limits of
// its own under window_attn.cuh's names.
constexpr int kLMaxHd = 32;           // head width: lane d owns column d
constexpr int kLQ = 64;               // query rows per block
constexpr int kLRows = kLQ / kWarps;  // 8 query rows per warp
constexpr int kLK = 128;              // keys per staged tile
constexpr int kLKeysPer = kLK / 32;   // lane l owns keys l + 32 m of a tile

// The grid of AB-long's dq launch: (heads, windows, query-row tiles).
inline dim3 long_grid(int nh, int B, int Tq) {
  return dim3(nh, B, (Tq + kLQ - 1) / kLQ);
}

// What the long body takes: any Tq, Tk >= 1, a head width <= kLMaxHd, and
// a window count the grid's y dimension holds.
inline bool long_shape_ok(int B, int Tq, int Tk, int C, int nh) {
  return B >= 1 && B <= 65535 && Tq >= 1 && Tk >= 1 && nh >= 1 &&
         C % nh == 0 && C / nh <= kLMaxHd;
}

// dst[r * ld + d] = src[(row0 + r) * C + n0 + d] for r < rows, d < hd,
// widened to f32.
template <typename T>
__device__ __forceinline__ void long_stage(const T* __restrict__ src,
                                           size_t row0, int rows, int C,
                                           int n0, int hd, float* dst,
                                           int ld) {
  for (int e = threadIdx.x; e < rows * hd; e += kThreads) {
    const int r = e / hd;
    const int d = e - r * hd;
    dst[r * ld + d] = to_f32(src[(row0 + r) * C + n0 + d]);
  }
}

// s[r][m] = the scaled (biased) score of this warp's query row r (rows qw
// + r * ld of the staged tile) against key l + 32 m of the staged k tile:
// (q . k) * scale + bias, each step rounded on its own (no contraction), so
// that every pass computes the same bits. hb is the head's bias at column
// k0 or null. The bias row of query row i0 + r is clamped to Tq - 1. Keys
// at or beyond kb read the tile's last key; the callers ignore them.
__device__ __forceinline__ void long_scores(const float* qw, const float* ks,
                                            int ld, int hd, int kb,
                                            const float* hb, int i0, int Tq,
                                            int Tk, float scale,
                                            float (&s)[kLRows][kLKeysPer]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kLRows; ++r)
#pragma unroll
    for (int m = 0; m < kLKeysPer; ++m) s[r][m] = 0.f;
  for (int d = 0; d < hd; ++d) {
    float qd[kLRows];
#pragma unroll
    for (int r = 0; r < kLRows; ++r) qd[r] = qw[r * ld + d];
#pragma unroll
    for (int m = 0; m < kLKeysPer; ++m) {
      const float kd = ks[min(lane + 32 * m, kb - 1) * ld + d];
#pragma unroll
      for (int r = 0; r < kLRows; ++r) s[r][m] = fmaf(qd[r], kd, s[r][m]);
    }
  }
#pragma unroll
  for (int r = 0; r < kLRows; ++r) {
    const size_t row = static_cast<size_t>(min(i0 + r, Tq - 1)) * Tk;
    const float* brow = hb ? hb + row : nullptr;
#pragma unroll
    for (int m = 0; m < kLKeysPer; ++m) {
      s[r][m] = __fmul_rn(s[r][m], scale);
      if (brow) s[r][m] = __fadd_rn(s[r][m], brow[min(lane + 32 * m, kb - 1)]);
    }
  }
}

// The (Tq, Tk) mask of window `win`: class win % nW of the (nW, Tq, Tk)
// mask (the Swin SW-MSA convention); null without one.
__device__ __forceinline__ const float* long_window_mask(const float* mask,
                                                        int win, int nW,
                                                        int Tq, int Tk) {
  return mask ? mask + static_cast<size_t>(win % nW) * Tq * Tk : nullptr;
}

}  // namespace gsasr
