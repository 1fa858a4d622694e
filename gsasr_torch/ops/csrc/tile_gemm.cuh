// Shared pieces of the decoder-layer kernels (ln_mlp.cu, ln_attn.cu): warp
// reductions, the f32 LayerNorm of one row per warp, and a 64-row FP32 tile
// product against a weight streamed through shared memory.
#pragma once

#include <cuda_runtime.h>

namespace gsasr {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Row tile of the product: 64 rows x up to kMaxN columns per block. Each
// thread owns 8 rows (rg + 8 i) x 6 columns (cg + 32 j) of accumulators.
constexpr int kBM = 64;
constexpr int kRowsPer = kBM / kWarps;
constexpr int kMaxColsPer = 6;
constexpr int kMaxN = 32 * kMaxColsPer;  // 192
// Depth of one staged weight slab; its row stride is odd so the transposing
// store and the column reads spread over the banks.
constexpr int kBK = 16;
constexpr int kLdw = kMaxN + 1;
constexpr int kWsFloats = kBK * kLdw;
// LayerNorm row width handled per lane: C <= 32 * kLnPer.
constexpr int kLnPer = 6;
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Loads row `row` of x (+ inj_row when given) into v[] and, when ln_w is
// given, normalizes it in f32 (two-pass mean and variance) and applies the
// affine. Lane l holds columns l + 32 q. Called by a whole warp.
__device__ __forceinline__ void load_row_ln(const float* __restrict__ xr,
                                            const float* __restrict__ inj_row,
                                            const float* __restrict__ ln_w,
                                            const float* __restrict__ ln_b,
                                            int C, float v[kLnPer]) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < kLnPer; ++q) {
    const int c = lane + 32 * q;
    v[q] = 0.f;
    if (c < C) {
      v[q] = xr[c];
      if (inj_row) v[q] += inj_row[c];
      s += v[q];
    }
  }
  if (!ln_w) return;
  const float mean = warp_sum(s) / static_cast<float>(C);
  float ss = 0.f;
#pragma unroll
  for (int q = 0; q < kLnPer; ++q) {
    const int c = lane + 32 * q;
    if (c < C) {
      const float d = v[q] - mean;
      ss += d * d;
    }
  }
  const float var = warp_sum(ss) / static_cast<float>(C);
  const float inv = 1.0f / sqrtf(var + kLnEps);
#pragma unroll
  for (int q = 0; q < kLnPer; ++q) {
    const int c = lane + 32 * q;
    if (c < C) v[q] = (v[q] - mean) * inv * ln_w[c] + ln_b[c];
  }
}

// acc[i][j] = sum_k As[(rg + 8 i) * lda + k] * W[(cg + 32 j) * K + k] for
// the block's 64 rows of As (shared memory) and the N <= kMaxN rows of the
// row-major (N, K) weight W (global). The weight passes through Ws in slabs
// of kBK columns, transposed so that a warp reads 32 consecutive columns.
// Accumulators of columns >= N are left unspecified. Starts and ends with a
// barrier, so As may be written just before and reused just after.
__device__ __forceinline__ void gemm_rows(const float* As, int lda,
                                          const float* __restrict__ W, int N,
                                          int K, float* Ws,
                                          float acc[kRowsPer][kMaxColsPer]) {
  const int tid = threadIdx.x;
  const int rg = tid >> 5;
  const int cg = tid & 31;
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
    for (int j = 0; j < kMaxColsPer; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int kb = min(kBK, K - k0);
    __syncthreads();
    for (int e = tid; e < N * kBK; e += kThreads) {
      const int n = e / kBK;
      const int kk = e - n * kBK;
      Ws[kk * kLdw + n] = kk < kb ? W[static_cast<size_t>(n) * K + k0 + kk] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kb; ++kk) {
      float b[kMaxColsPer];
#pragma unroll
      for (int j = 0; j < kMaxColsPer; ++j) b[j] = Ws[kk * kLdw + cg + 32 * j];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        const float a = As[(rg + kWarps * i) * lda + k0 + kk];
#pragma unroll
        for (int j = 0; j < kMaxColsPer; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
      }
    }
  }
  __syncthreads();
}

}  // namespace gsasr
