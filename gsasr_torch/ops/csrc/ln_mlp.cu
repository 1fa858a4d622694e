// Kernel M: fused [LayerNorm] -> fc1 -> ReLU -> fc2 -> residual.
//
// Replaces _k_ln_mlp of gsasr_tpu/ops/fused_layers.py (ln_mlp_residual):
//
//   t   = x + inj[window]                           (inj optional, per window)
//   out = (0 | resi | t) + fc2(relu(fc1(LN?(t))))   (LN statistics in f32)
//
// x, resi and out are float or bfloat16 (the Enhanced family's trunk); inj,
// the weights and biases float. In bfloat16 it rounds where _k_ln_mlp
// rounds: LN?(t), the weights as they are staged, the ReLU output and the
// result; t, the sums and the base stay f32. zero_base returns the bare
// MLP (the Enhanced block tails).
//
// What bounds it on an H100: the two products, 4 * rows * C * hid
// operations (4.2 GFLOP at 225 windows x 144 tokens x 180 channels, 4.8 at
// 192) against 67 TFLOP/s FP32; it moves only 2-3 row tensors (47-70 MB in
// float32, half in bfloat16), about a fifth of the time of the arithmetic
// at 3.35 TB/s. The bfloat16 forms run the same f32 FMAs, so their time is
// the float32 form's: against the bf16 tensor-core peak (989 TFLOP/s) their
// bound is set by the bytes.
//
// Design. Rows are independent, so a 256-thread block owns 64 rows and
// keeps everything between its input and its output in shared memory: the
// normalized rows (one warp per row, f32 warp reductions), then the ReLU
// hidden rows, then the output accumulators in registers. The two weights
// (259 KB at 180 channels) do not fit a block's shared memory, so both pass
// through one 12 KB slab buffer, 16 columns at a time, read from L2 by every
// block (tile_gemm.cuh). Each thread accumulates an 8x6 register tile with
// FP32 FMAs; tensor cores are left to a later change.

#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace {

using namespace gsasr;

template <typename Act>
__global__ void __launch_bounds__(kThreads)
ln_mlp_kernel(const Act* __restrict__ x, const float* __restrict__ inj,
              const Act* __restrict__ resi, const float* __restrict__ ln_w,
              const float* __restrict__ ln_b, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              const float* __restrict__ b2, Act* __restrict__ out, int M,
              int T, int C, int H, int zero_base) {
  constexpr bool kBf16 = sizeof(Act) == 2;
  extern __shared__ float smem[];
  float* hs = smem;            // kBM x C: LN?(x + inj)
  float* zs = hs + kBM * C;    // kBM x H: relu(fc1(.))
  float* ws = zs + kBM * H;    // weight slab
  const int row0 = blockIdx.x * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int r = warp; r < kBM; r += kWarps) {
    const int g = row0 + r;
    float v[kLnPer];
    if (g < M) {
      load_row_ln(x + static_cast<size_t>(g) * C,
                  inj ? inj + static_cast<size_t>(g / T) * C : nullptr, ln_w,
                  ln_b, C, v);
    } else {
#pragma unroll
      for (int q = 0; q < kLnPer; ++q) v[q] = 0.f;
    }
#pragma unroll
    for (int q = 0; q < kLnPer; ++q) {
      const int c = lane + 32 * q;
      if (c < C) hs[r * C + c] = rnd<Act>(v[q]);
    }
  }

  float acc[kRowsPer][kMaxColsPer];
  gemm_rows<false, kBf16>(hs, C, w1, H, C, ws, acc);
#pragma unroll
  for (int j = 0; j < kMaxColsPer; ++j) {
    const int n = lane + 32 * j;
    if (n >= H) continue;
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
      zs[(warp + kWarps * i) * H + n] = rnd<Act>(fmaxf(acc[i][j] + b1[n], 0.f));
  }

  gemm_rows<false, kBf16>(zs, H, w2, C, H, ws, acc);
#pragma unroll
  for (int j = 0; j < kMaxColsPer; ++j) {
    const int n = lane + 32 * j;
    if (n >= C) continue;
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int g = row0 + warp + kWarps * i;
      if (g >= M) continue;
      const size_t o = static_cast<size_t>(g) * C + n;
      float base = 0.f;
      if (!zero_base) {
        if (resi) {
          base = to_f32(resi[o]);
        } else {
          base = to_f32(x[o]);
          if (inj) base += inj[static_cast<size_t>(g / T) * C + n];
        }
      }
      out[o] = from_f32<Act>(base + (acc[i][j] + b2[n]));
    }
  }
}

template <typename Act>
int launch(const void* x, const float* inj, const void* resi,
           const float* ln_w, const float* ln_b, const float* w1,
           const float* b1, const float* w2, const float* b2, void* out, int M,
           int T, int C, int H, int zero_base, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBM * (C + H) + kWsFloats);
  cudaError_t err = cudaFuncSetAttribute(
      ln_mlp_kernel<Act>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (M + kBM - 1) / kBM;
  ln_mlp_kernel<Act><<<blocks, kThreads, smem, stream>>>(
      static_cast<const Act*>(x), inj, static_cast<const Act*>(resi), ln_w,
      ln_b, w1, b1, w2, b2, static_cast<Act*>(out), M, T, C, H, zero_base);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, resi, out (M, C) with M = windows * T, float, or bfloat16 when bf16 is
// set; inj (windows, C) float; ln_w, ln_b, b2 (C); w1 (H, C); b1 (H); w2
// (C, H). inj, resi and ln_w/ln_b may be null; zero_base drops the base.
extern "C" int ln_mlp(const void* x, const float* inj, const void* resi,
                      const float* ln_w, const float* ln_b, const float* w1,
                      const float* b1, const float* w2, const float* b2,
                      void* out, int M, int T, int C, int H, int zero_base,
                      int bf16, void* stream) {
  if (C > kMaxN || H > kMaxN || C > 32 * kLnPer || M < 1 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, inj, resi, ln_w, ln_b, w1, b1, w2,
                                      b2, out, M, T, C, H, zero_base, st)
              : launch<float>(x, inj, resi, ln_w, ln_b, w1, b1, w2, b2, out,
                              M, T, C, H, zero_base, st);
}
