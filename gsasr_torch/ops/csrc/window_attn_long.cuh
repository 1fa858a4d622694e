// The window-16 form of kernel W's body: packed multi-head window attention
// for any Tq and Tk (HAT's 256-token windows and OCAB's 256 x 576
// rectangles), shared by window_attn_fwd.cu (W-long, WM-long, W4-long) and
// ln_attn.cu (the attention of A-long), all in fp32: their bf16 forms run
// the tensor-core body of window_attn_long_mma.cuh. Per window w and head
// h, on the packed (B, T, C) layout where head h is columns [h*hd,
// (h+1)*hd):
//
//   s = q_h k_h^T * scale (+ bias[h]) (+ mask[w % nW])   (Tq x Tk, f32)
//   p = softmax(s) with the row max subtracted, rounded to T
//   out[w, :, h*hd:(h+1)*hd] = p v_h      (f32 sums, stored as T)
//
// The mask (kMask, the masked form WM-long of window_attn_fwd.cu and the
// backward's WMB-long) is the per-window-class
// additive mask of Swin's shifted windows at window 16 (the paper HAT's
// 256-token windows), added after the bias. It is a template flag, so the
// unmasked forms (W-long, A-long) compile as without it. So is kHM, the
// head-major (B, nh, T, hd) layout of the 4D form W4-long: head h of window
// w is then rows (w nh + h) T of hd instead of columns h hd of the packed
// rows.
//
// W's T <= 160 body holds a whole score row in a warp's registers and one
// head's q, k and v in shared memory: 186 KB at 256 x 576. Here a block
// takes kLQ query rows of one (window, head) and walks the keys in staged
// tiles of kLK, in two passes: the first keeps each row's running max and
// sum of exponentials (the sum rescaled when the max grows), the second
// recomputes the scores, forms p = exp(s - max) / sum, rounds it to the
// operand type once (the Pallas body's p.astype(v.dtype)) and accumulates
// p v with lane d owning output column d. Recomputing the scores costs half
// again the products of one pass, but p is the normalized probability the
// Pallas body rounds, and both passes walk the tiles in one fixed order: no
// atomics, the same bits every launch.
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

// q rows, a k tile and a v tile (rows padded to an odd stride) and each
// warp's probability rows.
inline size_t long_smem_bytes(int hd) {
  return sizeof(float) * (static_cast<size_t>(kLQ + 2 * kLK) * (hd | 1) +
                          static_cast<size_t>(kWarps) * kLRows * kLK);
}

// The grid of the long body: (heads, windows, query-row tiles).
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

// s[r][m] = the scaled (biased, masked) score of this warp's query row r
// (rows qw + r * ld of the staged tile) against key l + 32 m of the staged
// k tile: (q . k) * scale + bias + mask, each step rounded on its own (no
// contraction), so that every pass computes the same bits. hb is the
// head's bias at column k0 or null; with kMask, mb is the window class's
// mask at column k0. The bias and mask rows of query row i0 + r are
// clamped to Tq - 1. Keys at or beyond kb read the tile's last key; the
// callers ignore them.
template <bool kMask = false>
__device__ __forceinline__ void long_scores(const float* qw, const float* ks,
                                            int ld, int hd, int kb,
                                            const float* hb, int i0, int Tq,
                                            int Tk, float scale,
                                            float (&s)[kLRows][kLKeysPer],
                                            const float* mb = nullptr) {
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
      if constexpr (kMask)
        s[r][m] = __fadd_rn(s[r][m], mb[row + min(lane + 32 * m, kb - 1)]);
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

// The body, one block of kThreads per (head, window, query tile) of
// long_grid. q, k, v and out are T (float or __nv_bfloat16) in the packed
// layout, or with kHM in the head-major (B, nh, T, hd) layout (W4-long);
// bias (nh, Tq, Tk) f32 or null; with kMask, mask (nW, Tq, Tk) f32, window
// w taking mask[w % nW].
template <typename T, bool kMask = false, bool kHM = false>
__device__ __forceinline__ void window_attn_fwd_long_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ out, int Tq, int Tk,
    int C, int nh, float scale, const float* __restrict__ mask = nullptr,
    int nW = 1) {
  extern __shared__ float smem[];
  const int hd = C / nh;
  const int ld = hd | 1;
  float* qs = smem;
  float* ks = qs + kLQ * ld;
  float* vs = ks + kLK * ld;
  const int head = blockIdx.x;
  const int win = blockIdx.y;
  const int q0 = blockIdx.z * kLQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = kHM ? 0 : head * hd;
  const int ldg = kHM ? hd : C;
  const int rows = min(kLQ, Tq - q0);
  const int r0 = warp * kLRows;
  const float* qw = qs + r0 * ld;
  float* pb = vs + kLK * ld + warp * kLRows * kLK;
  const float* hb =
      bias ? bias + static_cast<size_t>(head) * Tq * Tk : nullptr;
  const float* wm =
      kMask ? long_window_mask(mask, win, nW, Tq, Tk) : nullptr;
  const size_t wrow = kHM ? static_cast<size_t>(win) * nh + head : win;

  // the tile's query rows; rows past Tq are zeros, computed and not stored
  long_stage(q, wrow * Tq + q0, rows, ldg, n0, hd, qs, ld);
  for (int e = rows * hd + threadIdx.x; e < kLQ * hd; e += kThreads) {
    const int r = e / hd;
    qs[r * ld + e - r * hd] = 0.f;
  }

  // pass 1: each row's running max and sum of exponentials
  float mrow[kLRows], lrow[kLRows];
#pragma unroll
  for (int r = 0; r < kLRows; ++r) {
    mrow[r] = -INFINITY;
    lrow[r] = 0.f;
  }
  for (int k0 = 0; k0 < Tk; k0 += kLK) {
    const int kb = min(kLK, Tk - k0);
    __syncthreads();
    long_stage(k, wrow * Tk + k0, kb, ldg, n0, hd, ks, ld);
    __syncthreads();
    float s[kLRows][kLKeysPer];
    long_scores<kMask>(qw, ks, ld, hd, kb, hb ? hb + k0 : nullptr, q0 + r0,
                       Tq, Tk, scale, s, kMask ? wm + k0 : nullptr);
#pragma unroll
    for (int r = 0; r < kLRows; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int m = 0; m < kLKeysPer; ++m)
        if (lane + 32 * m < kb) mx = fmaxf(mx, s[r][m]);
      const float mnew = fmaxf(mrow[r], warp_max(mx));
      float e = 0.f;
#pragma unroll
      for (int m = 0; m < kLKeysPer; ++m)
        if (lane + 32 * m < kb) e += expf(s[r][m] - mnew);
      lrow[r] = lrow[r] * expf(mrow[r] - mnew) + warp_sum(e);
      mrow[r] = mnew;
    }
  }

  // pass 2: p = exp(s - max) / sum, rounded to T, times v
  float o[kLRows];
#pragma unroll
  for (int r = 0; r < kLRows; ++r) o[r] = 0.f;
  for (int k0 = 0; k0 < Tk; k0 += kLK) {
    const int kb = min(kLK, Tk - k0);
    __syncthreads();
    long_stage(k, wrow * Tk + k0, kb, ldg, n0, hd, ks, ld);
    long_stage(v, wrow * Tk + k0, kb, ldg, n0, hd, vs, ld);
    __syncthreads();
    float s[kLRows][kLKeysPer];
    long_scores<kMask>(qw, ks, ld, hd, kb, hb ? hb + k0 : nullptr, q0 + r0,
                       Tq, Tk, scale, s, kMask ? wm + k0 : nullptr);
#pragma unroll
    for (int r = 0; r < kLRows; ++r)
#pragma unroll
      for (int m = 0; m < kLKeysPer; ++m) {
        const int j = lane + 32 * m;
        if (j < kb) pb[r * kLK + j] = rnd<T>(expf(s[r][m] - mrow[r]) / lrow[r]);
      }
    __syncwarp();
    if (lane < hd) {
      for (int j = 0; j < kb; ++j) {
        const float vj = vs[j * ld + lane];
#pragma unroll
        for (int r = 0; r < kLRows; ++r) o[r] = fmaf(pb[r * kLK + j], vj, o[r]);
      }
    }
    __syncwarp();
  }
  if (lane < hd) {
#pragma unroll
    for (int r = 0; r < kLRows; ++r) {
      if (r0 + r < rows)
        out[(wrow * Tq + q0 + r0 + r) * ldg + n0 + lane] =
            from_f32<T>(o[r]);
    }
  }
}

}  // namespace gsasr
