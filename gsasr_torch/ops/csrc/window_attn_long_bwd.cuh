// The FMA body of the window-16 attention backward for any Tq and Tk, the
// attention step of AB-long (ln_attn_bwd.cu, the backward of A-long at the
// Ultra decoder's windows of 256 seeds; WB-long, WMB-long and WB4-long run
// the tensor-core body of window_attn_long_tf32_bwd.cuh, their bf16 forms
// window_attn_long_mma_bwd.cuh's). Per window w and head h, on the packed
// (B, T, C) layout, with the softmax recomputed from q, k and bias as
// W-long computes it:
//
//   p = softmax(q_h k_h^T * scale (+ bias[h]))   (f32, not rounded)
//   dv = p^T g_h      dp = g_h v_h^T      ds = p (dp - rowsum(dp p))
//   dq = ds k_h * scale                   dk = ds^T q_h * scale
//
// WB's body holds a whole score row in a warp's registers and one head's q,
// k, v and g in shared memory; neither fits at 256 x 576. This one keeps
// W-long's staging (64 query rows per block, keys in tiles of 128, scores
// from long_scores, so every pass computes the same bits) and splits the
// work in two launches, each owning its outputs:
//
// 1. Per (head, window, 64-query tile): pass 1 walks the key tiles for each
//    row's running max and sum of exponentials (W-long's first pass); pass
//    2 recomputes p and dp and sums D = sum_j p dp in key-tile order; pass
//    3 recomputes them again, forms ds = p (dp - D) and accumulates dq =
//    ds k with lane d owning column d. Each row's (max, sum, D) goes to a
//    small scratch (B, nh, Tq, 3), and with a bias ds to ds_w (B, nh, Tq,
//    Tk) for the ordered sum over windows.
// 2. Per (head, window, 128-key tile): walk the query tiles in order,
//    recompute p and dp from the stored rows' statistics, and accumulate
//    dv = p^T g and then dk = ds^T q from one shared (64, 128) tile, warp w
//    owning keys 16 w .. 16 w + 15 and lane d column d.
//
// Ten products of 2 Tq Tk hd per (window, head) where the Pallas body forms
// five: the scores four times, dp three times, dq, dk and dv once. D comes
// from p and dp, as in the Pallas body, not from g . out (out is rounded in
// the bf16 form). Every sum runs in a fixed order and no float atomics are
// used: two launches give the same bits. stats, ds_w and dbias are f32.
//
// AB-long runs both launches on f32 scratch with two template flags. kAtt:
// launch 1's pass 2 also forms att = p v (the forward's attention output,
// which AB's dwo needs) from the same p and v tile, p rounded before the
// product as W-long's body rounds it. kRnd (AB-long's
// bfloat16 form, whose operands are f32 tiles holding bf16 values) rounds
// where _k_ln_attn_bwd rounds: p as the operand of att and dv, ds as the
// operand of dq and dk (D, ds_w and dbias take them unrounded), and att as
// it is stored; dq, dk and dv stay f32.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

#include "window_attn_bwd.cuh"
#include "window_attn_long.cuh"

namespace gsasr {

constexpr int kLBKeysPerWarp = kLK / kWarps;  // 16 keys of a tile per warp

// q, g tiles (kLQ rows), a k and a v tile (kLK rows), rows padded to an odd
// stride, and the (kLQ, kLK) probability / ds tile.
inline size_t long_bwd_smem_bytes(int hd) {
  return sizeof(float) * (static_cast<size_t>(2 * kLQ + 2 * kLK) * (hd | 1) +
                          static_cast<size_t>(kLQ) * kLK);
}

// Rows [row0, row0 + rows) of head columns [n0, n0 + hd) into dst (kLQ
// rows of stride ld), widened to f32; rows past `rows` are zeros, computed
// and never stored.
template <typename T>
__device__ __forceinline__ void long_stage_tile(const T* __restrict__ src,
                                                size_t row0, int rows, int C,
                                                int n0, int hd, float* dst,
                                                int ld) {
  long_stage(src, row0, rows, C, n0, hd, dst, ld);
  for (int e = rows * hd + threadIdx.x; e < kLQ * hd; e += kThreads) {
    const int r = e / hd;
    dst[r * ld + e - r * hd] = 0.f;
  }
}

// dp[r][m] = g row r of this warp (rows gw + r * ld) . v key lane + 32 m of
// the staged tile, summed over d in order; keys at or beyond kb read the
// tile's last key and are ignored by the callers.
__device__ __forceinline__ void long_dots(const float* gw, const float* vs,
                                          int ld, int hd, int kb,
                                          float (&dp)[kLRows][kLKeysPer]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kLRows; ++r)
#pragma unroll
    for (int m = 0; m < kLKeysPer; ++m) dp[r][m] = 0.f;
  for (int d = 0; d < hd; ++d) {
    float gd[kLRows];
#pragma unroll
    for (int r = 0; r < kLRows; ++r) gd[r] = gw[r * ld + d];
#pragma unroll
    for (int m = 0; m < kLKeysPer; ++m) {
      const float vd = vs[min(lane + 32 * m, kb - 1) * ld + d];
#pragma unroll
      for (int r = 0; r < kLRows; ++r) dp[r][m] = fmaf(gd[r], vd, dp[r][m]);
    }
  }
}

// p = exp(s - max) / sum of this warp's rows against the staged key tile,
// unrounded, into prow[r * kLK + j] for keys j < kb (the arguments of
// long_scores, and each row's max and sum).
__device__ __forceinline__ void long_probs(const float* qw, const float* ks,
                                           int ld, int hd, int kb,
                                           const float* hb, int i0, int Tq,
                                           int Tk, float scale,
                                           const float (&mrow)[kLRows],
                                           const float (&lrow)[kLRows],
                                           float* prow) {
  const int lane = threadIdx.x & 31;
  float s[kLRows][kLKeysPer];
  long_scores(qw, ks, ld, hd, kb, hb, i0, Tq, Tk, scale, s);
#pragma unroll
  for (int r = 0; r < kLRows; ++r)
#pragma unroll
    for (int m = 0; m < kLKeysPer; ++m) {
      const int j = lane + 32 * m;
      if (j < kb) prow[r * kLK + j] = expf(s[r][m] - mrow[r]) / lrow[r];
    }
}

// ds = p (dp - D) over this warp's rows of the tile, in place of p in prow
// (keys j < kb), where dp is recomputed from the staged g rows and v tile.
__device__ __forceinline__ void long_ds(const float* gw, const float* vs,
                                        int ld, int hd, int kb,
                                        const float (&drow)[kLRows],
                                        float* prow) {
  const int lane = threadIdx.x & 31;
  float dp[kLRows][kLKeysPer];
  long_dots(gw, vs, ld, hd, kb, dp);
#pragma unroll
  for (int r = 0; r < kLRows; ++r)
#pragma unroll
    for (int m = 0; m < kLKeysPer; ++m) {
      const int j = lane + 32 * m;
      if (j < kb) prow[r * kLK + j] *= dp[r][m] - drow[r];
    }
}

// Launch 1, one block of kThreads per (head, window, query tile) of
// long_grid: dq, each row's (max, sum, D) into stats, and ds into ds_w when
// it is not null. With kAtt, att (B, Tq, C) = p v; with kRnd, AB-long's
// bf16 rounding.
template <typename T, bool kAtt = false, bool kRnd = false>
__global__ void __launch_bounds__(kThreads)
window_attn_bwd_long_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v,
                              const float* __restrict__ bias,
                              const T* __restrict__ g, T* __restrict__ dq,
                              float* __restrict__ stats,
                              float* __restrict__ ds_w, int Tq, int Tk, int C,
                              int nh, float scale, float* __restrict__ att) {
  extern __shared__ float smem[];
  const int hd = C / nh;
  const int ld = hd | 1;
  float* qs = smem;
  float* gs = qs + kLQ * ld;
  float* ks = gs + kLQ * ld;
  float* vs = ks + kLK * ld;
  float* tile = vs + kLK * ld;
  const int head = blockIdx.x;
  const int win = blockIdx.y;
  const int q0 = blockIdx.z * kLQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = head * hd;
  const int ldg = C;
  const int rows = min(kLQ, Tq - q0);
  const int r0 = warp * kLRows;
  const float* qw = qs + r0 * ld;
  const float* gw = gs + r0 * ld;
  float* prow = tile + r0 * kLK;
  const float* hb =
      bias ? bias + static_cast<size_t>(head) * Tq * Tk : nullptr;
  const size_t wrow = win;
  const size_t qrow0 = wrow * Tq + q0;
  const size_t krow0 = wrow * Tk;
  const size_t srow0 = (static_cast<size_t>(win) * nh + head) * Tq + q0 + r0;

  long_stage_tile(q, qrow0, rows, ldg, n0, hd, qs, ld);
  long_stage_tile(g, qrow0, rows, ldg, n0, hd, gs, ld);

  // pass 1: each row's running max and sum of exponentials (W-long's)
  float mrow[kLRows], lrow[kLRows];
#pragma unroll
  for (int r = 0; r < kLRows; ++r) {
    mrow[r] = -INFINITY;
    lrow[r] = 0.f;
  }
  for (int k0 = 0; k0 < Tk; k0 += kLK) {
    const int kb = min(kLK, Tk - k0);
    __syncthreads();
    long_stage(k, krow0 + k0, kb, ldg, n0, hd, ks, ld);
    __syncthreads();
    float s[kLRows][kLKeysPer];
    long_scores(qw, ks, ld, hd, kb, hb ? hb + k0 : nullptr, q0 + r0, Tq, Tk,
                scale, s);
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

  // pass 2: D = sum_j p dp, key tiles in order; with kAtt also att = p v
  // (lane d owning column d, as W-long's body sums it)
  float drow[kLRows];
  float orow[kLRows];
#pragma unroll
  for (int r = 0; r < kLRows; ++r) drow[r] = orow[r] = 0.f;
  for (int k0 = 0; k0 < Tk; k0 += kLK) {
    const int kb = min(kLK, Tk - k0);
    __syncthreads();
    long_stage(k, krow0 + k0, kb, ldg, n0, hd, ks, ld);
    long_stage(v, krow0 + k0, kb, ldg, n0, hd, vs, ld);
    __syncthreads();
    long_probs(qw, ks, ld, hd, kb, hb ? hb + k0 : nullptr, q0 + r0, Tq, Tk,
               scale, mrow, lrow, prow);
    float dp[kLRows][kLKeysPer];
    long_dots(gw, vs, ld, hd, kb, dp);
#pragma unroll
    for (int r = 0; r < kLRows; ++r) {
      float e = 0.f;
#pragma unroll
      for (int m = 0; m < kLKeysPer; ++m) {
        const int j = lane + 32 * m;
        if (j < kb) e += prow[r * kLK + j] * dp[r][m];
      }
      drow[r] += warp_sum(e);
    }
    if constexpr (kAtt) {
      __syncwarp();
      if (lane < hd) {
        for (int j = 0; j < kb; ++j) {
          const float vj = vs[j * ld + lane];
#pragma unroll
          for (int r = 0; r < kLRows; ++r) {
            const float p = prow[r * kLK + j];
            orow[r] = fmaf(kRnd ? rnd<__nv_bfloat16>(p) : p, vj, orow[r]);
          }
        }
      }
      __syncwarp();
    }
  }
  if constexpr (kAtt) {
    if (lane < hd) {
#pragma unroll
      for (int r = 0; r < kLRows; ++r) {
        if (r0 + r < rows)
          att[(qrow0 + r0 + r) * ldg + n0 + lane] =
              kRnd ? rnd<__nv_bfloat16>(orow[r]) : orow[r];
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kLRows; ++r) {
      if (r0 + r < rows) {
        float* st = stats + (srow0 + r) * 3;
        st[0] = mrow[r];
        st[1] = lrow[r];
        st[2] = drow[r];
      }
    }
  }

  // pass 3: ds = p (dp - D), then dq = ds k with lane d owning column d
  float acc[kLRows];
#pragma unroll
  for (int r = 0; r < kLRows; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < Tk; k0 += kLK) {
    const int kb = min(kLK, Tk - k0);
    __syncthreads();
    long_stage(k, krow0 + k0, kb, ldg, n0, hd, ks, ld);
    long_stage(v, krow0 + k0, kb, ldg, n0, hd, vs, ld);
    __syncthreads();
    long_probs(qw, ks, ld, hd, kb, hb ? hb + k0 : nullptr, q0 + r0, Tq, Tk,
               scale, mrow, lrow, prow);
    long_ds(gw, vs, ld, hd, kb, drow, prow);
    if (ds_w) {
#pragma unroll
      for (int r = 0; r < kLRows; ++r) {
        if (r0 + r >= rows) continue;
        float* dsr = ds_w + (srow0 + r) * Tk + k0;
        for (int j = lane; j < kb; j += 32) dsr[j] = prow[r * kLK + j];
      }
    }
    if constexpr (kRnd) {
      // ds as the operand of dq (each lane rounds the entries it wrote)
#pragma unroll
      for (int r = 0; r < kLRows; ++r)
        for (int j = lane; j < kb; j += 32)
          prow[r * kLK + j] = rnd<__nv_bfloat16>(prow[r * kLK + j]);
    }
    __syncwarp();
    if (lane < hd) {
      for (int j = 0; j < kb; ++j) {
        const float kj = ks[j * ld + lane];
#pragma unroll
        for (int r = 0; r < kLRows; ++r)
          acc[r] = fmaf(prow[r * kLK + j], kj, acc[r]);
      }
    }
    __syncwarp();
  }
  if (lane < hd) {
#pragma unroll
    for (int r = 0; r < kLRows; ++r) {
      if (r0 + r < rows)
        dq[(qrow0 + r0 + r) * ldg + n0 + lane] = from_f32<T>(acc[r] * scale);
    }
  }
}

// Launch 2, one block of kThreads per (head, window, key tile of kLK): dv
// and dk of the tile's keys, the query tiles walked in order with the
// statistics launch 1 stored. With kRnd, AB-long's bf16 rounding of p and
// ds.
template <typename T, bool kRnd = false>
__global__ void __launch_bounds__(kThreads)
window_attn_bwd_long_kv_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const float* __restrict__ bias,
                               const T* __restrict__ g, T* __restrict__ dk,
                               T* __restrict__ dv,
                               const float* __restrict__ stats, int Tq,
                               int Tk, int C, int nh, float scale) {
  extern __shared__ float smem[];
  const int hd = C / nh;
  const int ld = hd | 1;
  float* qs = smem;
  float* gs = qs + kLQ * ld;
  float* ks = gs + kLQ * ld;
  float* vs = ks + kLK * ld;
  float* tile = vs + kLK * ld;
  const int head = blockIdx.x;
  const int win = blockIdx.y;
  const int k0 = blockIdx.z * kLK;
  const int kb = min(kLK, Tk - k0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = head * hd;
  const int ldg = C;
  const int r0 = warp * kLRows;
  const int jw = warp * kLBKeysPerWarp;
  const float* qw = qs + r0 * ld;
  const float* gw = gs + r0 * ld;
  float* prow = tile + r0 * kLK;
  const float* hb =
      bias ? bias + static_cast<size_t>(head) * Tq * Tk + k0 : nullptr;
  const size_t wrow = win;
  const size_t krow0 = wrow * Tk + k0;
  const size_t srow0 = (static_cast<size_t>(win) * nh + head) * Tq;

  long_stage(k, krow0, kb, ldg, n0, hd, ks, ld);
  long_stage(v, krow0, kb, ldg, n0, hd, vs, ld);

  float adv[kLBKeysPerWarp], adk[kLBKeysPerWarp];
#pragma unroll
  for (int jj = 0; jj < kLBKeysPerWarp; ++jj) adv[jj] = adk[jj] = 0.f;
  for (int q0 = 0; q0 < Tq; q0 += kLQ) {
    const int rows = min(kLQ, Tq - q0);
    __syncthreads();
    long_stage_tile(q, wrow * Tq + q0, rows, ldg, n0, hd, qs, ld);
    long_stage_tile(g, wrow * Tq + q0, rows, ldg, n0, hd, gs, ld);
    __syncthreads();
    // this warp's rows' statistics (rows past Tq read the last row's and
    // are never summed)
    float mrow[kLRows], lrow[kLRows], drow[kLRows];
#pragma unroll
    for (int r = 0; r < kLRows; ++r) {
      const float* st = stats + (srow0 + min(q0 + r0 + r, Tq - 1)) * 3;
      mrow[r] = st[0];
      lrow[r] = st[1];
      drow[r] = st[2];
    }
    long_probs(qw, ks, ld, hd, kb, hb, q0 + r0, Tq, Tk, scale, mrow, lrow,
               prow);
    // dp, held for ds while the tile holds p for dv (ds from the unrounded
    // p; with kRnd, p rounded in place after)
    float dp[kLRows][kLKeysPer];
    long_dots(gw, vs, ld, hd, kb, dp);
#pragma unroll
    for (int r = 0; r < kLRows; ++r)
#pragma unroll
      for (int m = 0; m < kLKeysPer; ++m) {
        const int j = lane + 32 * m;
        if (j < kb) {
          const float p = prow[r * kLK + j];
          dp[r][m] = p * (dp[r][m] - drow[r]);
          if constexpr (kRnd) prow[r * kLK + j] = rnd<__nv_bfloat16>(p);
        }
      }
    __syncthreads();
    // dv += p^T g over the tile's rows in order
    if (lane < hd) {
      for (int i = 0; i < rows; ++i) {
        const float gi = gs[i * ld + lane];
        const float* pi = tile + i * kLK + jw;
#pragma unroll
        for (int jj = 0; jj < kLBKeysPerWarp; ++jj)
          adv[jj] = fmaf(pi[jj], gi, adv[jj]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kLRows; ++r)
#pragma unroll
      for (int m = 0; m < kLKeysPer; ++m) {
        const int j = lane + 32 * m;
        if (j < kb)
          prow[r * kLK + j] = kRnd ? rnd<__nv_bfloat16>(dp[r][m]) : dp[r][m];
      }
    __syncthreads();
    // dk += ds^T q over the tile's rows in order
    if (lane < hd) {
      for (int i = 0; i < rows; ++i) {
        const float qi = qs[i * ld + lane];
        const float* di = tile + i * kLK + jw;
#pragma unroll
        for (int jj = 0; jj < kLBKeysPerWarp; ++jj)
          adk[jj] = fmaf(di[jj], qi, adk[jj]);
      }
    }
  }
  if (lane < hd) {
#pragma unroll
    for (int jj = 0; jj < kLBKeysPerWarp; ++jj) {
      const int j = jw + jj;
      if (j < kb) {
        const size_t o = (krow0 + j) * ldg + n0 + lane;
        dv[o] = from_f32<T>(adv[jj]);
        dk[o] = from_f32<T>(adk[jj] * scale);
      }
    }
  }
}

}  // namespace gsasr

namespace {

// The launches of the FMA body (T float), with kAtt (att (B, Tq, C) f32)
// and kRnd as AB-long's attention backward takes them: dq and the rows'
// statistics per query tile, then dk and dv per key tile, then (dbias
// given) the ordered sum of ds_w over the windows.
template <typename T, bool kAtt = false, bool kRnd = false>
cudaError_t launch_window_attn_bwd_long(const T* q, const T* k, const T* v,
                                        const float* bias, const T* g, T* dq,
                                        T* dk, T* dv, float* stats,
                                        float* ds_w, float* dbias, int B,
                                        int Tq, int Tk, int C, int nh,
                                        float scale, cudaStream_t st,
                                        float* att = nullptr) {
  if (!gsasr::long_shape_ok(B, Tq, Tk, C, nh) || (dbias && !ds_w) ||
      (kAtt && !att))
    return cudaErrorInvalidValue;
  const size_t smem = gsasr::long_bwd_smem_bytes(C / nh);
  cudaError_t err = cudaFuncSetAttribute(
      gsasr::window_attn_bwd_long_q_kernel<T, kAtt, kRnd>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      gsasr::window_attn_bwd_long_kv_kernel<T, kRnd>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  gsasr::window_attn_bwd_long_q_kernel<T, kAtt, kRnd>
      <<<gsasr::long_grid(nh, B, Tq), kThreads, smem, st>>>(
          q, k, v, bias, g, dq, stats, dbias ? ds_w : nullptr, Tq, Tk, C, nh,
          scale, att);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gsasr::window_attn_bwd_long_kv_kernel<T, kRnd>
      <<<dim3(nh, B, (Tk + gsasr::kLK - 1) / gsasr::kLK), kThreads, smem,
         st>>>(q, k, v, bias, g, dk, dv, stats, Tq, Tk, C, nh, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !dbias) return err;
  const int n = nh * Tq * Tk;
  dbias_sum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      ds_w, dbias, B, n);
  return cudaGetLastError();
}

}  // namespace
