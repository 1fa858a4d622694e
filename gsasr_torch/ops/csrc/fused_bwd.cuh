// Shared pieces of the fused-layer backward kernels MB (ln_mlp_bwd.cu) and
// AB (ln_attn_bwd.cu): row-tile products with a bias, ReLU or mask
// epilogue, the f32 LayerNorm forward and backward of one row per warp,
// weight-gradient partial sums over fixed groups of rows, and ordered sums
// of partials. There are no float atomics: every output has one owner, and
// every sum over rows, groups or windows runs in ascending order, so two
// launches give the same bits.
#pragma once

#include <cuda_runtime.h>

#include "tile_gemm.cuh"

#define GSASR_TRY(expr)                                   \
  do {                                                    \
    const cudaError_t gsasr_err_ = (expr);                \
    if (gsasr_err_ != cudaSuccess) return gsasr_err_;     \
  } while (0)
// The same in an extern "C" entry point, which returns the code as an int.
#define GSASR_TRY_INT(expr)                                        \
  do {                                                             \
    const cudaError_t gsasr_err_ = (expr);                         \
    if (gsasr_err_ != cudaSuccess) return static_cast<int>(gsasr_err_); \
  } while (0)

namespace gsasr {

// The rows of a weight gradient are cut into at most kMaxGroups groups of a
// multiple of kBK consecutive rows; each group's sum is a partial, and the
// partials are summed in group order.
constexpr int kMaxGroups = 128;

inline int group_rows(int M) {
  const int per = (M + kMaxGroups - 1) / kMaxGroups;
  return (per + kBK - 1) / kBK * kBK;
}

// Up to three products summed into one output.
struct Terms {
  const float* a[3];  // (M, K) row-major
  const float* w[3];  // (N, K) row-major; (K, N) with kTransW
  int count;
};

// out (M, N) = sum_t a_t w_t^T (a_t w_t with kTransW), then + bias[n] when
// bias is given, ReLU when relu, and 0 where mask (M, N) is given and not
// > 0. A block owns 64 rows; the terms pass through its A tile in turn.
template <bool kTransW>
__global__ void __launch_bounds__(kThreads)
linear_rows_kernel(Terms terms, const float* __restrict__ bias,
                   const float* __restrict__ mask, int relu,
                   float* __restrict__ out, int M, int K, int N) {
  extern __shared__ float smem[];
  float* as = smem;          // kBM x K
  float* ws = as + kBM * K;  // weight slab
  const int row0 = blockIdx.x * kBM;
  float acc[kRowsPer][kMaxColsPer];
  for (int t = 0; t < terms.count; ++t) {
    const float* a = terms.a[t];
    for (int e = threadIdx.x; e < kBM * K; e += kThreads) {
      const int g = row0 + e / K;
      as[e] = g < M ? a[static_cast<size_t>(row0) * K + e] : 0.f;
    }
    gemm_rows<kTransW>(as, K, terms.w[t], N, K, ws, acc, t == 0);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kMaxColsPer; ++j) {
    const int n = lane + 32 * j;
    if (n >= N) continue;
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int r = row0 + warp + kWarps * i;
      if (r >= M) continue;
      const size_t o = static_cast<size_t>(r) * N + n;
      float v = acc[i][j];
      if (bias) v += bias[n];
      if (relu) v = fmaxf(v, 0.f);
      if (mask && !(mask[o] > 0.f)) v = 0.f;
      out[o] = v;
    }
  }
}

// out[r] = LN?(x[r] + inj[r / T]) + pos[r % T], each of inj, LN (ln_w and
// ln_b) and pos optional; one warp per row.
__global__ void __launch_bounds__(kThreads)
ln_rows_kernel(const float* __restrict__ x, const float* __restrict__ inj,
               const float* __restrict__ ln_w, const float* __restrict__ ln_b,
               const float* __restrict__ pos, float* __restrict__ out, int M,
               int T, int C) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= M) return;
  float v[kLnPer];
  load_row_ln(x + static_cast<size_t>(r) * C,
              inj ? inj + static_cast<size_t>(r / T) * C : nullptr, ln_w, ln_b,
              C, v);
#pragma unroll
  for (int q = 0; q < kLnPer; ++q) {
    const int c = lane + 32 * q;
    if (c < C)
      out[static_cast<size_t>(r) * C + c] =
          pos ? v[q] + pos[static_cast<size_t>(r % T) * C + c] : v[q];
  }
}

// The LayerNorm backward of 64 rows a block, one warp per row, at
// t = x[r] + inj[r / T] (inj optional):
//   y = (t - mean) inv,  dyh = dh ln_w,
//   dx = inv (dyh - mean(dyh) - y mean(dyh y)) (+ add[r])
// and the block's column sums of dh y and dh, in row order, to
// lnpart[blockIdx.x] (2, C). Without ln_w, dx = dh (+ add) and no partial.
__global__ void __launch_bounds__(kThreads)
ln_bwd_rows_kernel(const float* __restrict__ x, const float* __restrict__ inj,
                   const float* __restrict__ ln_w,
                   const float* __restrict__ dh, const float* __restrict__ add,
                   float* __restrict__ dx, float* __restrict__ lnpart, int M,
                   int T, int C) {
  __shared__ float red[kWarps][2][32 * kLnPer];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float inv_c = 1.0f / static_cast<float>(C);
  float pw[kLnPer], pb[kLnPer];
#pragma unroll
  for (int q = 0; q < kLnPer; ++q) pw[q] = pb[q] = 0.f;
  for (int i = 0; i < kRowsPer; ++i) {
    const int r = blockIdx.x * kBM + warp + kWarps * i;
    if (r >= M) break;
    const size_t o = static_cast<size_t>(r) * C;
    float t[kLnPer], d[kLnPer];
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kLnPer; ++q) {
      const int c = lane + 32 * q;
      t[q] = d[q] = 0.f;
      if (c < C) {
        t[q] = x[o + c];
        if (inj) t[q] += inj[static_cast<size_t>(r / T) * C + c];
        d[q] = dh[o + c];
        s += t[q];
      }
    }
    if (ln_w) {
      const float mean = warp_sum(s) * inv_c;
      float ss = 0.f;
#pragma unroll
      for (int q = 0; q < kLnPer; ++q) {
        if (lane + 32 * q < C) {
          const float e = t[q] - mean;
          ss += e * e;
        }
      }
      const float inv = 1.0f / sqrtf(warp_sum(ss) * inv_c + kLnEps);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < kLnPer; ++q) {
        const int c = lane + 32 * q;
        if (c < C) {
          t[q] = (t[q] - mean) * inv;  // y
          const float dyh = d[q] * ln_w[c];
          s1 += dyh;
          s2 += dyh * t[q];
          pw[q] += d[q] * t[q];
          pb[q] += d[q];
        }
      }
      const float m1 = warp_sum(s1) * inv_c;
      const float m2 = warp_sum(s2) * inv_c;
#pragma unroll
      for (int q = 0; q < kLnPer; ++q) {
        const int c = lane + 32 * q;
        if (c < C) d[q] = inv * (d[q] * ln_w[c] - m1 - t[q] * m2);
      }
    }
#pragma unroll
    for (int q = 0; q < kLnPer; ++q) {
      const int c = lane + 32 * q;
      if (c < C) dx[o + c] = add ? d[q] + add[o + c] : d[q];
    }
  }
  if (!ln_w || !lnpart) return;
#pragma unroll
  for (int q = 0; q < kLnPer; ++q) {
    red[warp][0][lane + 32 * q] = pw[q];
    red[warp][1][lane + 32 * q] = pb[q];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * C; e += kThreads) {
    const int k = e / C;
    const int c = e - k * C;
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += red[w][k][c];
    lnpart[static_cast<size_t>(blockIdx.x) * 2 * C + e] = acc;
  }
}

// part[(g N + n) (K + 1) + k] = sum over the rows r of group g, ascending,
// of D[r N + n] X[r K + k], where column K of X is taken as 1 (so it holds
// the bias gradient). Group g is rows [g R, min(g R + R, M)). A block owns
// 64 columns n of one group; thread (warp, lane) holds n = warp + 8 i and
// k = lane + 32 j, as in gemm_rows.
__global__ void __launch_bounds__(kThreads)
wgrad_partial_kernel(const float* __restrict__ D, const float* __restrict__ X,
                     float* __restrict__ part, int M, int N, int K, int R) {
  __shared__ float ds[kBK][kBM + 1];
  __shared__ float xs[kBK][kLdw];
  const int n0 = blockIdx.x * kBM;
  const int grp = blockIdx.y;
  const int r_begin = grp * R;
  const int r_end = min(r_begin + R, M);
  const int tid = threadIdx.x;
  const int rg = tid >> 5;
  const int cg = tid & 31;
  float acc[kRowsPer][kMaxColsPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
    for (int j = 0; j < kMaxColsPer; ++j) acc[i][j] = 0.f;
  for (int r0 = r_begin; r0 < r_end; r0 += kBK) {
    __syncthreads();
    for (int e = tid; e < kBK * kBM; e += kThreads) {
      const int kk = e / kBM;
      const int nl = e - kk * kBM;
      const int r = r0 + kk;
      ds[kk][nl] = (r < r_end && n0 + nl < N)
                       ? D[static_cast<size_t>(r) * N + n0 + nl]
                       : 0.f;
    }
    for (int e = tid; e < kBK * kMaxN; e += kThreads) {
      const int kk = e / kMaxN;
      const int k = e - kk * kMaxN;
      const int r = r0 + kk;
      float v = 0.f;
      if (r < r_end) {
        if (k < K)
          v = X[static_cast<size_t>(r) * K + k];
        else if (k == K)
          v = 1.f;
      }
      xs[kk][k] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float b[kMaxColsPer];
#pragma unroll
      for (int j = 0; j < kMaxColsPer; ++j) b[j] = xs[kk][cg + 32 * j];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        const float a = ds[kk][rg + kWarps * i];
#pragma unroll
        for (int j = 0; j < kMaxColsPer; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int n = n0 + rg + kWarps * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < kMaxColsPer; ++j) {
      const int k = cg + 32 * j;
      if (k <= K)
        part[(static_cast<size_t>(grp) * N + n) * (K + 1) + k] = acc[i][j];
    }
  }
}

// dw (N, K) and db (N): the G partials of wgrad_partial_kernel summed in
// group order, one thread per entry.
__global__ void __launch_bounds__(kThreads)
wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                    float* __restrict__ db, int G, int N, int K) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int n_all = N * (K + 1);
  if (e >= n_all) return;
  float acc = 0.f;
  for (int g = 0; g < G; ++g) acc += part[static_cast<size_t>(g) * n_all + e];
  const int n = e / (K + 1);
  const int k = e - n * (K + 1);
  if (k < K)
    dw[static_cast<size_t>(n) * K + k] = acc;
  else
    db[n] = acc;
}

// dst[a inner + i] = sum_{t < terms} src[(a terms + t) inner + i], t
// ascending, one thread per output.
__global__ void __launch_bounds__(kThreads)
sum_terms_kernel(const float* __restrict__ src, float* __restrict__ dst,
                 int outer, int terms, int inner) {
  const size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= static_cast<size_t>(outer) * inner) return;
  const size_t a = e / inner;
  const size_t i = e - a * inner;
  const float* s = src + a * terms * inner + i;
  float acc = 0.f;
  for (int t = 0; t < terms; ++t) acc += s[static_cast<size_t>(t) * inner];
  dst[e] = acc;
}

// ---- host-side launches, each returning cudaGetLastError() ---------------

inline int blocks_for(size_t n, int per) {
  return static_cast<int>((n + per - 1) / per);
}

template <bool kTransW>
cudaError_t launch_linear(const Terms& terms, const float* bias,
                          const float* mask, int relu, float* out, int M,
                          int K, int N, cudaStream_t st) {
  if (N > kMaxN || terms.count < 1 || terms.count > 3)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (kBM * K + kWsFloats);
  GSASR_TRY(cudaFuncSetAttribute(linear_rows_kernel<kTransW>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem)));
  linear_rows_kernel<kTransW><<<blocks_for(M, kBM), kThreads, smem, st>>>(
      terms, bias, mask, relu, out, M, K, N);
  return cudaGetLastError();
}

inline cudaError_t launch_ln_rows(const float* x, const float* inj,
                                  const float* ln_w, const float* ln_b,
                                  const float* pos, float* out, int M, int T,
                                  int C, cudaStream_t st) {
  ln_rows_kernel<<<blocks_for(M, kWarps), kThreads, 0, st>>>(
      x, inj, ln_w, ln_b, pos, out, M, T, C);
  return cudaGetLastError();
}

// dx and, with ln_w, the LN parameter gradients dln (2, C) = (d ln_w,
// d ln_b); lnpart holds blocks_for(M, kBM) x 2C floats.
inline cudaError_t launch_ln_bwd(const float* x, const float* inj,
                                 const float* ln_w, const float* dh,
                                 const float* add, float* dx, float* lnpart,
                                 float* dln, int M, int T, int C,
                                 cudaStream_t st) {
  const int tiles = blocks_for(M, kBM);
  ln_bwd_rows_kernel<<<tiles, kThreads, 0, st>>>(x, inj, ln_w, dh, add, dx,
                                                 lnpart, M, T, C);
  GSASR_TRY(cudaGetLastError());
  if (!ln_w) return cudaSuccess;
  sum_terms_kernel<<<blocks_for(2 * C, kThreads), kThreads, 0, st>>>(
      lnpart, dln, 1, tiles, 2 * C);
  return cudaGetLastError();
}

// dw (N, K) = D^T X and db (N) = column sums of D over the M rows; part
// holds kMaxGroups x N x (K + 1) floats.
inline cudaError_t launch_wgrad(const float* D, const float* X, float* part,
                                float* dw, float* db, int M, int N, int K,
                                cudaStream_t st) {
  if (K + 1 > kMaxN) return cudaErrorInvalidValue;
  const int R = group_rows(M);
  const int G = (M + R - 1) / R;
  wgrad_partial_kernel<<<dim3(blocks_for(N, kBM), G), kThreads, 0, st>>>(
      D, X, part, M, N, K, R);
  GSASR_TRY(cudaGetLastError());
  wgrad_reduce_kernel<<<blocks_for(static_cast<size_t>(N) * (K + 1),
                                   kThreads),
                        kThreads, 0, st>>>(part, dw, db, G, N, K);
  return cudaGetLastError();
}

inline cudaError_t launch_sum_terms(const float* src, float* dst, int outer,
                                    int terms, int inner, cudaStream_t st) {
  sum_terms_kernel<<<blocks_for(static_cast<size_t>(outer) * inner,
                                kThreads),
                     kThreads, 0, st>>>(src, dst, outer, terms, inner);
  return cudaGetLastError();
}

}  // namespace gsasr
