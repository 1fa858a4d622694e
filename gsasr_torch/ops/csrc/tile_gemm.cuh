// Shared pieces of the decoder-layer kernels (ln_mlp.cu, ln_attn.cu and
// their backward kernels through fused_bwd.cuh): warp reductions, the f32
// LayerNorm of one row per warp, a 64-row FP32 tile product against a
// weight streamed through shared memory (the backward kernels'; the
// forward kernels M and A take the tensor-core product of tile_mma.cuh),
// and the activation types.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gsasr {

// Activations are stored as float or, in the bfloat16 forms of M and A, as
// __nv_bfloat16; either widens to f32 on load. rnd<Act> rounds an f32
// value to Act and back (the identity for float): the casts of the Pallas
// kernels before a product or a store. A product of two bf16 values is
// exact in f32, so f32 FMAs of rounded operands are bf16 products with f32
// accumulation.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename Act>
__device__ __forceinline__ Act from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename Act>
__device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<Act>(v));
}

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
template <typename Act>
__device__ __forceinline__ void load_row_ln(const Act* __restrict__ xr,
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
      v[q] = to_f32(xr[c]);
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
// row-major (N, K) weight W (global). With kTransW, W is the row-major
// (K, N) matrix instead and the product is As W. The weight passes through
// Ws in slabs of kBK columns, transposed so that a warp reads 32
// consecutive columns. zero = false adds to acc instead of overwriting it.
// With kRoundW the weight is rounded to bf16 as it is staged. Accumulators
// of columns >= N are left unspecified. Starts and ends with a barrier, so
// As may be written just before and reused just after.
template <bool kTransW = false, bool kRoundW = false>
__device__ __forceinline__ void gemm_rows(const float* As, int lda,
                                          const float* __restrict__ W, int N,
                                          int K, float* Ws,
                                          float acc[kRowsPer][kMaxColsPer],
                                          bool zero = true) {
  const int tid = threadIdx.x;
  const int rg = tid >> 5;
  const int cg = tid & 31;
  if (zero) {
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < kMaxColsPer; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int kb = min(kBK, K - k0);
    __syncthreads();
    for (int e = tid; e < N * kBK; e += kThreads) {
      int kk, n;
      float w = 0.f;
      if (kTransW) {
        kk = e / N;
        n = e - kk * N;
        if (kk < kb) w = W[static_cast<size_t>(k0 + kk) * N + n];
      } else {
        n = e / kBK;
        kk = e - n * kBK;
        if (kk < kb) w = W[static_cast<size_t>(n) * K + k0 + kk];
      }
      Ws[kk * kLdw + n] = kRoundW ? rnd<__nv_bfloat16>(w) : w;
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
