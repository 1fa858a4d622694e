// The device code of kernel AB's attention backward (ln_attn_bwd.cu), which
// also needs the recomputed attention output, and the ordered dbias sum
// that every window attention backward shares. (WB, WMB and WB4, which once
// ran this body too, run the 3xTF32 tensor-core body of
// window_attn_long_tf32_bwd.cuh.)
//
// One 256-thread block per (window, head) stages q_h, k_h, v_h and g_h
// (T x hd each) in shared memory. Pass 1: each warp takes four query rows,
// holds their scores and dp in registers (lane l owns keys l + 32 m, so
// Tk <= 160), takes the softmax and ds with warp reductions, keeps p in a
// (Tq, Tk) shared tile, writes ds to the per-window buffer ds_w (B, nh, Tq,
// Tk) and forms its rows of dq from a per-warp ds row buffer. The block
// then forms att_h = p v_h from the p tile. Pass 2 forms dv = p^T g from
// the p tile; the block then loads its ds back from ds_w (the same block
// wrote it) over the p tile and forms dk = ds^T q. The probabilities never
// leave the block. dq, dk, dv and att columns are owned by one (window,
// head). dbias is a sum over windows, and blocks run in no order, so a
// second launch sums ds_w over the windows in ascending order, one thread
// per (h, i, j): no float atomics, and the result is the same bits from run
// to run. With kRnd (the bfloat16 form of AB, whose operands are float
// tiles holding bf16 values) the body rounds where _k_ln_attn_bwd rounds: p
// in the tile (for att and dv), ds as an operand of dq and dk (ds_w and
// dbias keep it unrounded) and att as it is stored; dq, dk and dv stay f32.
#pragma once

#include <cuda_runtime.h>

#include "window_attn.cuh"

namespace {

using gsasr::from_f32;
using gsasr::HeadLayout;
using gsasr::rnd;
using gsasr::kKeysPer;
using gsasr::kMaxHd;
using gsasr::kMaxT;
using gsasr::kQRows;
using gsasr::kThreads;
using gsasr::kWarps;
using gsasr::softmax_exp_row;
using gsasr::stage_head;
using gsasr::warp_sum;

// Head-product micro-tile: 32 output-row groups x 8 head-column groups.
constexpr int kRowGroups = 32;
constexpr int kColGroups = kThreads / kRowGroups;
constexpr int kRowsPer = kMaxT / kRowGroups;   // 5
constexpr int kColsPer = kMaxHd / kColGroups;  // 4

// HeadLayout plus the (Tq, Tk) p / ds tile, rows padded to an odd stride.
struct Layout : HeadLayout {
  int ldp, p_floats;
  __host__ __device__ Layout(int Tq, int Tk, int hd)
      : HeadLayout(Tq, Tk, hd), ldp(Tk | 1), p_floats(Tq * (Tk | 1)) {}
  // q, g (Tq rows); k, v (Tk rows); the p / ds tile; per-warp ds rows.
  __host__ __device__ size_t bytes(int Tk) const {
    return sizeof(float) * (2 * q_floats + 2 * kv_floats + p_floats +
                            static_cast<size_t>(kWarps) * kQRows * Tk);
  }
};

// out[(row0 + o) * C + n0 + d] = mul * sum_i A(i, o) * X[i * ldx + d] for
// o < n_out, d < hd, summing i < n_sum in ascending order, where A(i, o) is
// A[i * lda + o] (A^T X, the column product) or, with kRows, A[o * lda + i]
// (A X, the row product); rounded to bf16 with kRndOut, then stored rounded
// to TO.
template <bool kRows, typename TO, bool kRndOut = false>
__device__ void head_product(const float* A, int lda, const float* X, int ldx,
                             int n_sum, int n_out, int hd, float mul,
                             TO* __restrict__ out, size_t row0, int C,
                             int n0) {
  const int rg = threadIdx.x / kColGroups;
  const int cg = threadIdx.x % kColGroups;
  int os[kRowsPer], cs[kColsPer];
#pragma unroll
  for (int a = 0; a < kRowsPer; ++a) os[a] = min(rg + kRowGroups * a, n_out - 1);
#pragma unroll
  for (int b = 0; b < kColsPer; ++b) cs[b] = min(cg + kColGroups * b, hd - 1);
  float acc[kRowsPer][kColsPer];
#pragma unroll
  for (int a = 0; a < kRowsPer; ++a)
#pragma unroll
    for (int b = 0; b < kColsPer; ++b) acc[a][b] = 0.f;
  for (int i = 0; i < n_sum; ++i) {
    float xv[kColsPer];
#pragma unroll
    for (int b = 0; b < kColsPer; ++b) xv[b] = X[i * ldx + cs[b]];
#pragma unroll
    for (int a = 0; a < kRowsPer; ++a) {
      const float av = kRows ? A[os[a] * lda + i] : A[i * lda + os[a]];
#pragma unroll
      for (int b = 0; b < kColsPer; ++b) acc[a][b] = fmaf(av, xv[b], acc[a][b]);
    }
  }
#pragma unroll
  for (int a = 0; a < kRowsPer; ++a) {
    const int o = rg + kRowGroups * a;
    if (o >= n_out) continue;
#pragma unroll
    for (int b = 0; b < kColsPer; ++b) {
      const int d = cg + kColGroups * b;
      if (d < hd) {
        const float v = acc[a][b] * mul;
        out[(row0 + o) * C + n0 + d] =
            from_f32<TO>(kRndOut ? rnd<__nv_bfloat16>(v) : v);
      }
    }
  }
}

// The body of AB's attention backward, one block per (head, window).
template <typename T, bool kRnd = false>
__device__ __forceinline__ void window_attn_bwd_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const T* __restrict__ g,
    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ ds_w, float* __restrict__ att, int Tq, int Tk, int C,
    int nh, float scale) {
  extern __shared__ float smem[];
  const int hd = C / nh;
  const Layout L(Tq, Tk, hd);
  float* qs = smem;
  float* gs = qs + L.q_floats;
  float* ks = gs + L.q_floats;
  float* vs = ks + L.kv_floats;
  float* ps = vs + L.kv_floats;
  const int head = blockIdx.x;
  const int win = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = head * hd;
  const int ldg = C;
  float* drow = ps + L.p_floats + warp * kQRows * Tk;
  const size_t qrow0 = static_cast<size_t>(win) * Tq;
  const size_t krow0 = static_cast<size_t>(win) * Tk;
  float* dsb = ds_w + (static_cast<size_t>(win) * nh + head) * Tq * Tk;

  stage_head(q, qrow0, Tq, ldg, n0, hd, qs, L.ld);
  stage_head(g, qrow0, Tq, ldg, n0, hd, gs, L.ld);
  stage_head(k, krow0, Tk, ldg, n0, hd, ks, L.ld);
  stage_head(v, krow0, Tk, ldg, n0, hd, vs, L.ld);
  __syncthreads();

  // Pass 1: p, ds and dq, four query rows per warp.
  const float* hbias = bias ? bias + static_cast<size_t>(head) * Tq * Tk : nullptr;
  for (int i0 = warp * kQRows; i0 < Tq; i0 += kWarps * kQRows) {
    float s[kQRows][kKeysPer], dp[kQRows][kKeysPer];
#pragma unroll
    for (int r = 0; r < kQRows; ++r)
#pragma unroll
      for (int m = 0; m < kKeysPer; ++m) s[r][m] = dp[r][m] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qd[kQRows], gd[kQRows];
#pragma unroll
      for (int r = 0; r < kQRows; ++r) {
        const int i = min(i0 + r, Tq - 1);
        qd[r] = qs[i * L.ld + d];
        gd[r] = gs[i * L.ld + d];
      }
#pragma unroll
      for (int m = 0; m < kKeysPer; ++m) {
        const int j = min(lane + 32 * m, Tk - 1);
        const float kd = ks[j * L.ld + d];
        const float vd = vs[j * L.ld + d];
#pragma unroll
        for (int r = 0; r < kQRows; ++r) {
          s[r][m] = fmaf(qd[r], kd, s[r][m]);
          dp[r][m] = fmaf(gd[r], vd, dp[r][m]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kQRows; ++r) {
      const int i = min(i0 + r, Tq - 1);
      const float sum = softmax_exp_row(
          s[r], hbias ? hbias + static_cast<size_t>(i) * Tk : nullptr, Tk,
          scale);
      float rs = 0.f;
#pragma unroll
      for (int m = 0; m < kKeysPer; ++m) {
        const int j = lane + 32 * m;
        if (j < Tk) {
          s[r][m] = s[r][m] / sum;  // p
          rs += dp[r][m] * s[r][m];
        }
      }
      rs = warp_sum(rs);
      const bool live = i0 + r < Tq;
#pragma unroll
      for (int m = 0; m < kKeysPer; ++m) {
        const int j = lane + 32 * m;
        if (j < Tk) {
          const float dsv = s[r][m] * (dp[r][m] - rs);
          drow[r * Tk + j] = kRnd ? rnd<__nv_bfloat16>(dsv) : dsv;
          if (live) {
            ps[i * L.ldp + j] = kRnd ? rnd<__nv_bfloat16>(s[r][m]) : s[r][m];
            dsb[static_cast<size_t>(i) * Tk + j] = dsv;
          }
        }
      }
    }
    __syncwarp();
    if (lane < hd) {
      float acc[kQRows] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < Tk; ++j) {
        const float kj = ks[j * L.ld + lane];
#pragma unroll
        for (int r = 0; r < kQRows; ++r) acc[r] = fmaf(drow[r * Tk + j], kj, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kQRows; ++r) {
        if (i0 + r < Tq)
          dq[(qrow0 + i0 + r) * ldg + n0 + lane] =
              from_f32<T>(acc[r] * scale);
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // att = p v from the p tile (kernel AB's forward recompute).
  head_product<true, float, kRnd>(ps, L.ldp, vs, L.ld, Tk, Tq, hd, 1.0f, att,
                                  qrow0, ldg, n0);
  // Pass 2: dv = p^T g from the p tile.
  head_product<false>(ps, L.ldp, gs, L.ld, Tq, Tk, hd, 1.0f, dv, krow0, ldg,
                      n0);
  __syncthreads();
  // ds of this (window, head), written above by this block, over the tile.
  for (int e = threadIdx.x; e < Tq * Tk; e += kThreads) {
    const int i = e / Tk;
    ps[i * L.ldp + (e - i * Tk)] = kRnd ? rnd<__nv_bfloat16>(dsb[e]) : dsb[e];
  }
  __syncthreads();
  head_product<false>(ps, L.ldp, qs, L.ld, Tq, Tk, hd, scale, dk, krow0, ldg,
                      n0);
}

template <typename T, bool kRnd = false>
__global__ void __launch_bounds__(kThreads)
window_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ bias,
                       const T* __restrict__ g, T* __restrict__ dq,
                       T* __restrict__ dk, T* __restrict__ dv,
                       float* __restrict__ ds_w, float* __restrict__ att,
                       int Tq, int Tk, int C, int nh, float scale) {
  window_attn_bwd_body<T, kRnd>(q, k, v, bias, g, dq, dk, dv, ds_w, att, Tq,
                                Tk, C, nh, scale);
}

// dbias[e] = sum_{w < B} ds_w[w * n + e] in ascending w, e < n = nh Tq Tk.
__global__ void __launch_bounds__(kThreads)
dbias_sum_kernel(const float* __restrict__ ds_w, float* __restrict__ dbias,
                 int B, int n) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int w = 0; w < B; ++w) acc += ds_w[static_cast<size_t>(w) * n + e];
  dbias[e] = acc;
}

// The launches of AB's attention backward (with kRnd, AB-bf16's bfloat16
// rounding): q, g, dq, att (B, Tq, C); k, v, dk, dv (B, Tk, C); bias (nh,
// Tq, Tk) or null; ds_w (B, nh, Tq, Tk) scratch; dbias (nh, Tq, Tk), or
// null to skip the sum over windows; all f32.
template <typename T = float, bool kRnd = false>
cudaError_t launch_window_attn_bwd(const T* q, const T* k, const T* v,
                                   const float* bias, const T* g, T* dq,
                                   T* dk, T* dv, float* ds_w, float* dbias,
                                   float* att, int B, int Tq, int Tk, int C,
                                   int nh, float scale, cudaStream_t st) {
  if (B < 1 || Tq < 1 || Tk < 1 || nh < 1 || C % nh != 0 || C / nh > kMaxHd ||
      Tq > kMaxT || Tk > kMaxT)
    return cudaErrorInvalidValue;
  const Layout L(Tq, Tk, C / nh);
  const size_t smem = L.bytes(Tk);
  const auto kernel = window_attn_bwd_kernel<T, kRnd>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nh, B), kThreads, smem, st>>>(q, k, v, bias, g, dq, dk, dv,
                                              ds_w, att, Tq, Tk, C, nh,
                                              scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !dbias) return err;
  const int n = nh * Tq * Tk;
  dbias_sum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      ds_w, dbias, B, n);
  return cudaGetLastError();
}

}  // namespace
