// Kernel MB: backward of kernel M (fused [LayerNorm] -> fc1 -> ReLU -> fc2
// -> residual), with the forward recomputed.
//
// Replaces _k_ln_mlp_bwd of gsasr_tpu/ops/fused_layers.py (the custom VJP
// of ln_mlp_residual). Weights in nn.Linear layout: w1 (H, C), w2 (C, H).
// With t = x + inj[window] and h = LN?(t):
//
//   z1p = h w1^T + b1        z1 = relu(z1p)
//   dw2 = g^T z1             db2 = sum g
//   dz1 = (g w2) [z1p > 0]   dw1 = dz1^T h      db1 = sum dz1
//   dh  = dz1 w1             dt  = LN backward of dh (+ g when the residual
//                                  base is t)
//   dx  = dt                 dinj[w] = sum of dt over the window's rows
//
// (d resi = g is the caller's.) The weight, bias and LN gradients are sums
// over all rows of all windows.
//
// What bounds it on an H100: five products of 2 M C H FP32 operations each
// (the recomputed fc1, dw2, dz1, dw1 and dh: 11.9 GFLOP at 256 windows x
// 144 tokens x 180 channels) against 67 TFLOP/s, 0.18 ms; its bytes (x, g
// and dx, 80 MB) take a seventh of that at 3.35 TB/s.
//
// Design (fused_bwd.cuh). A short sequence of launches, each a 64-row tile
// product or a row pass: h, z1, dz1 and dh go through device-memory scratch
// (a window's rows and both weights do not fit one block's shared memory
// together), the LN backward takes one warp per row, and the weight
// gradients are partial sums over 128 fixed groups of rows followed by a
// sum of the partials in group order. No float atomics, so the result is
// the same bits from run to run.

#include <cuda_runtime.h>

#include "fused_bwd.cuh"

namespace {

using gsasr::blocks_for;
using gsasr::kBM;
using gsasr::kMaxGroups;
using gsasr::kMaxN;
using gsasr::Terms;

}  // namespace

// x, g, dx (M, C) with M = windows * T; inj, dinj (windows, C) or null;
// ln_w, ln_b (C) or null, dln (2, C) = (d ln_w, d ln_b) with them; w1, dw1
// (H, C); b1, db1 (H); w2, dw2 (C, H); db2 (C). base_is_t: the forward's
// residual base was t (no resi), so g also flows to dt. work holds
// work_floats floats of scratch: 2 M (C + H) for h, z1, dz1, dh, then
// kMaxGroups max(H (C + 1), C (H + 1)) for the weight-gradient partials,
// then ceil(M / 64) 2 C for the LN partials.
extern "C" int ln_mlp_bwd(const float* x, const float* inj, const float* ln_w,
                          const float* ln_b, const float* w1, const float* b1,
                          const float* w2, const float* g, float* dx,
                          float* dinj, float* dln, float* dw1, float* db1,
                          float* dw2, float* db2, float* work, int work_floats,
                          int M, int T, int C, int H, int base_is_t,
                          void* stream) {
  if (M < 1 || T < 1 || M % T != 0 || C > kMaxN || H > kMaxN ||
      C > 32 * gsasr::kLnPer || (ln_w == nullptr) != (ln_b == nullptr) ||
      (ln_w == nullptr) != (dln == nullptr) ||
      (inj == nullptr) != (dinj == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t rows = static_cast<size_t>(M);
  const size_t n_part = static_cast<size_t>(kMaxGroups) *
                        (H * (C + 1) > C * (H + 1) ? H * (C + 1) : C * (H + 1));
  const size_t need = 2 * rows * (C + H) + n_part +
                      static_cast<size_t>(blocks_for(M, kBM)) * 2 * C;
  if (static_cast<size_t>(work_floats) < need)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* h = work;
  float* z1 = h + rows * C;
  float* dz1 = z1 + rows * H;
  float* dh = dz1 + rows * H;
  float* part = dh + rows * C;
  float* lnpart = part + n_part;

  // forward recompute: h = LN?(x + inj), z1 = relu(h w1^T + b1)
  GSASR_TRY_INT(gsasr::launch_ln_rows(x, inj, ln_w, ln_b, nullptr, h, M, T, C,
                                      st));
  GSASR_TRY_INT(gsasr::launch_linear<false>(Terms{{h}, {w1}, 1}, b1, nullptr,
                                            1, z1, M, C, H, st));
  // dz1 = (g w2) [z1 > 0], dh = dz1 w1
  GSASR_TRY_INT(gsasr::launch_linear<true>(Terms{{g}, {w2}, 1}, nullptr, z1,
                                           0, dz1, M, C, H, st));
  GSASR_TRY_INT(gsasr::launch_linear<true>(Terms{{dz1}, {w1}, 1}, nullptr,
                                           nullptr, 0, dh, M, H, C, st));
  // dx = LN backward (+ g), the LN gradients, dinj = window sums of dx
  GSASR_TRY_INT(gsasr::launch_ln_bwd(x, inj, ln_w, dh, base_is_t ? g : nullptr,
                                     dx, lnpart, dln, M, T, C, st));
  if (dinj) GSASR_TRY_INT(gsasr::launch_sum_terms(dx, dinj, M / T, T, C, st));
  // weight gradients, one partial buffer in turn (one stream, in order)
  GSASR_TRY_INT(gsasr::launch_wgrad(g, z1, part, dw2, db2, M, C, H, st));
  GSASR_TRY_INT(gsasr::launch_wgrad(dz1, h, part, dw1, db1, M, H, C, st));
  return static_cast<int>(cudaSuccess);
}
