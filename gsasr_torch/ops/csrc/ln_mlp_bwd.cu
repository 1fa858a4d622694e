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
// over all rows of all windows. zero_base (the bare MLP) and a resi base
// are both "base_is_t = 0".
//
// bfloat16 (ln_mlp_bwd_bf16): x, g, dx and dinj are __nv_bfloat16, the rest
// float. It rounds where _k_ln_mlp_bwd rounds: h and z1 as the forward
// does, the weights as they are staged, dz1 as an operand of dw1 and dh
// (db1 sums it unrounded), and dx and dinj (the window sums of the f32 dt)
// as they are stored. x and g are widened to f32 scratch first, and dx and
// dinj narrowed from f32 scratch last.
//
// What bounds it on an H100: five products of 2 M C H FP32 operations each
// (the recomputed fc1, dw2, dz1, dw1 and dh: 11.9 GFLOP at 256 windows x
// 144 tokens x 180 channels, 13.6 at 192) against 67 TFLOP/s, 0.18-0.20
// ms; its bytes (x, g and dx, 80 MB in float32) take a seventh of that at
// 3.35 TB/s. The bfloat16 form runs the same f32 FMAs; against the bf16
// tensor-core peak (989 TFLOP/s) its bound is set by its bytes.
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

// x, g, dx (M, C) with M = windows * T; inj (windows, C) float and dinj
// (windows, C) or null; ln_w, ln_b (C) or null, dln (2, C) = (d ln_w,
// d ln_b) with them; w1, dw1 (H, C); b1, db1 (H); w2, dw2 (C, H); db2 (C).
// base_is_t: the forward's residual base was t (no resi, no zero_base), so
// g also flows to dt. work holds work_floats floats of scratch: 2 M (C + H)
// for h, z1, dz1, dh, then kMaxGroups max(H (C + 1), C (H + 1)) for the
// weight-gradient partials, then ceil(M / 64) 2 C for the LN partials, and
// in bfloat16 3 M C + (M / T) C for x and g widened, dx and dinj in f32.
template <typename Act>
int ln_mlp_bwd_impl(const Act* x, const float* inj, const float* ln_w,
                    const float* ln_b, const float* w1, const float* b1,
                    const float* w2, const Act* g, Act* dx, Act* dinj,
                    float* dln, float* dw1, float* db1, float* dw2, float* db2,
                    float* work, int work_floats, int M, int T, int C, int H,
                    int base_is_t, cudaStream_t st) {
  constexpr bool kBf16 = sizeof(Act) == 2;
  if (M < 1 || T < 1 || M % T != 0 || C > kMaxN || H > kMaxN ||
      C > 32 * gsasr::kLnPer || (ln_w == nullptr) != (ln_b == nullptr) ||
      (ln_w == nullptr) != (dln == nullptr) ||
      (inj == nullptr) != (dinj == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t rows = static_cast<size_t>(M);
  const size_t n_part = static_cast<size_t>(kMaxGroups) *
                        (H * (C + 1) > C * (H + 1) ? H * (C + 1) : C * (H + 1));
  const size_t n_ln = static_cast<size_t>(blocks_for(M, kBM)) * 2 * C;
  const size_t rc = rows * C;
  const size_t n_wide = kBf16 ? 3 * rc + static_cast<size_t>(M / T) * C : 0;
  if (static_cast<size_t>(work_floats) <
      2 * rows * (C + H) + n_part + n_ln + n_wide)
    return static_cast<int>(cudaErrorInvalidValue);
  float* h = work;
  float* z1 = h + rc;
  float* dz1 = z1 + rows * H;
  float* dh = dz1 + rows * H;
  float* part = dh + rc;
  float* lnpart = part + n_part;
  // f32 views of x and g, and f32 targets of dx and dinj
  const float* xf;
  const float* gf;
  float* dxf;
  float* dinjf;
  if constexpr (kBf16) {
    float* wide = lnpart + n_ln;
    GSASR_TRY_INT(gsasr::launch_convert(x, wide, rc, st));
    GSASR_TRY_INT(gsasr::launch_convert(g, wide + rc, rc, st));
    xf = wide;
    gf = wide + rc;
    dxf = wide + 2 * rc;
    dinjf = wide + 3 * rc;
  } else {
    xf = x;
    gf = g;
    dxf = dx;
    dinjf = dinj;
  }
  using gsasr::launch_linear;

  // forward recompute: h = LN?(x + inj), z1 = relu(h w1^T + b1), rounded
  GSASR_TRY_INT(gsasr::launch_ln_rows<kBf16>(xf, inj, ln_w, ln_b, nullptr, h,
                                             M, T, C, st));
  GSASR_TRY_INT(launch_linear<false, kBf16>(Terms{{h}, {w1}, 1}, b1, nullptr,
                                            1, z1, M, C, H, st, 1));
  // dz1 = (g w2) [z1 > 0] (unrounded), dh = dz1 w1
  GSASR_TRY_INT(launch_linear<true, kBf16>(Terms{{gf}, {w2}, 1}, nullptr, z1,
                                           0, dz1, M, C, H, st));
  GSASR_TRY_INT(launch_linear<true, kBf16>(Terms{{dz1}, {w1}, 1}, nullptr,
                                           nullptr, 0, dh, M, H, C, st));
  // dx = LN backward (+ g), the LN gradients, dinj = window sums of dx
  GSASR_TRY_INT(gsasr::launch_ln_bwd(xf, inj, ln_w, dh,
                                     base_is_t ? gf : nullptr, dxf, lnpart,
                                     dln, M, T, C, st));
  if (dinj) GSASR_TRY_INT(gsasr::launch_sum_terms(dxf, dinjf, M / T, T, C, st));
  // weight gradients, one partial buffer in turn (one stream, in order)
  GSASR_TRY_INT(gsasr::launch_wgrad<kBf16>(gf, z1, part, dw2, db2, M, C, H,
                                           st));
  GSASR_TRY_INT(gsasr::launch_wgrad<kBf16>(dz1, h, part, dw1, db1, M, H, C,
                                           st));
  if constexpr (kBf16) {
    GSASR_TRY_INT(gsasr::launch_convert(dxf, dx, rc, st));
    if (dinj)
      GSASR_TRY_INT(gsasr::launch_convert(
          dinjf, dinj, static_cast<size_t>(M / T) * C, st));
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// Kernel MB in float32 and in bfloat16, arguments as ln_mlp_bwd_impl.
extern "C" int ln_mlp_bwd(const float* x, const float* inj, const float* ln_w,
                          const float* ln_b, const float* w1, const float* b1,
                          const float* w2, const float* g, float* dx,
                          float* dinj, float* dln, float* dw1, float* db1,
                          float* dw2, float* db2, float* work, int work_floats,
                          int M, int T, int C, int H, int base_is_t,
                          void* stream) {
  return ln_mlp_bwd_impl(x, inj, ln_w, ln_b, w1, b1, w2, g, dx, dinj, dln,
                         dw1, db1, dw2, db2, work, work_floats, M, T, C, H,
                         base_is_t, static_cast<cudaStream_t>(stream));
}

extern "C" int ln_mlp_bwd_bf16(const __nv_bfloat16* x, const float* inj,
                               const float* ln_w, const float* ln_b,
                               const float* w1, const float* b1,
                               const float* w2, const __nv_bfloat16* g,
                               __nv_bfloat16* dx, __nv_bfloat16* dinj,
                               float* dln, float* dw1, float* db1, float* dw2,
                               float* db2, float* work, int work_floats, int M,
                               int T, int C, int H, int base_is_t,
                               void* stream) {
  return ln_mlp_bwd_impl(x, inj, ln_w, ln_b, w1, b1, w2, g, dx, dinj, dln,
                         dw1, db1, dw2, db2, work, work_floats, M, T, C, H,
                         base_is_t, static_cast<cudaStream_t>(stream));
}
