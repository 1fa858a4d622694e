// Kernel AB: backward of kernel A (fused pre-norm multi-head attention with
// its out-projection), paper form (no RoPE), with the forward recomputed.
//
// Replaces _k_ln_attn_bwd of gsasr_tpu/ops/fused_layers.py (the custom VJP
// of ln_attn_proj). Weights in nn.Linear layout (C, C). Forward as in
// ln_attn.cu: xq = LN(x) (+ pos), src = kv | xq, q = xq wq^T + bq,
// k = src wk^T + bk, v = src wv^T + bv, att_h = softmax(q_h k_h^T scale +
// bias[h]) v_h, out = att wo^T + bo. Backward:
//
//   dwo = g^T att, dbo = sum g, datt = g wo
//   per head: dv, dq, dk and ds as kernel WB computes them; dbias = sum ds
//   dwq = dq^T xq, dwk = dk^T src, dwv = dv^T src (and their bias sums)
//   dxq = dq wq (+ dk wk + dv wv for self-attention; for cross-attention
//         that sum is dkv)
//   dpos = sum over windows of dxq;  dx, d ln_w, d ln_b = LN backward
//
// What bounds it on an H100: eleven products of 2 T C^2 per window (the
// recomputed q, k, v; dwo, datt, dwq, dwk, dwv, dxq and two for dsrc) and
// six of 2 T^2 C (scores, p v, dp, dv, dq, dk): 37.7 GFLOP at 256 windows x
// 144 tokens x 180 channels, 0.56 ms at 67 TFLOP/s FP32; its bytes (x, kv,
// g, dx, dkv: 133 MB) take a quarter of that at 3.35 TB/s.
//
// Design. One window's f32 working set (x, q, k, v: 4 x 104 KB) does not
// fit a block's shared memory, so AB is a short sequence of launches
// through device-memory scratch: the LN rows and the q, k, v and datt tile
// products (fused_bwd.cuh); the per-(window, head) attention backward of
// kernel WB (window_attn_bwd.cuh), which also forms att from its p tile and
// sums dbias over the windows in order; the four weight gradients as
// partial sums over 128 fixed groups of rows, summed in group order; the
// dxq / dkv products; the sum of dxq over the windows for dpos; and the LN
// backward, one warp per row. No float atomics, so the result is the same
// bits from run to run.

#include <cuda_runtime.h>

#include "fused_bwd.cuh"
#include "window_attn_bwd.cuh"

// x, g, dx (B, Tq, C); kv, dkv (B, Tk, C) or null (self-attention, Tk ==
// Tq); pos, dpos (Tq, C) or null; ln_w, ln_b (C); dln (2, C) = (d ln_w,
// d ln_b); weights and their gradients (C, C), biases and theirs (C); bias,
// dbias (nh, Tq, Tk) or null. work holds work_floats floats of scratch:
// (6 B Tq + 4 B Tk) C for xq, q, datt, att, dq, dxq, k, v, dk, dv, then
// B nh Tq Tk for the per-window ds, kMaxGroups C (C + 1) for the
// weight-gradient partials and ceil(B Tq / 64) 2 C for the LN partials.
extern "C" int ln_attn_bwd(const float* x, const float* pos, const float* kv,
                           const float* ln_w, const float* ln_b,
                           const float* wq, const float* bq, const float* wk,
                           const float* bk, const float* wv, const float* bv,
                           const float* wo, const float* bias, const float* g,
                           float* dx, float* dkv, float* dpos, float* dln,
                           float* dwq, float* dbq, float* dwk, float* dbk,
                           float* dwv, float* dbv, float* dwo, float* dbo,
                           float* dbias, float* work, int work_floats, int B,
                           int Tq, int Tk, int C, int nh, float scale,
                           void* stream) {
  if (B < 1 || nh < 1 || C % nh != 0 || C / nh > kMaxHd ||
      C + 1 > gsasr::kMaxN || C > 32 * gsasr::kLnPer || Tq < 1 || Tk < 1 ||
      Tq > kMaxT || Tk > kMaxT || (!kv && Tk != Tq) ||
      (kv == nullptr) != (dkv == nullptr) ||
      (pos == nullptr) != (dpos == nullptr) ||
      (bias == nullptr) != (dbias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Mq = B * Tq;
  const int Mk = B * Tk;
  const size_t rq = static_cast<size_t>(Mq) * C;
  const size_t rk = static_cast<size_t>(Mk) * C;
  const size_t n_ds = static_cast<size_t>(B) * nh * Tq * Tk;
  const size_t n_part = static_cast<size_t>(gsasr::kMaxGroups) * C * (C + 1);
  const size_t n_ln = static_cast<size_t>(gsasr::blocks_for(Mq, gsasr::kBM)) * 2 * C;
  if (static_cast<size_t>(work_floats) < 6 * rq + 4 * rk + n_ds + n_part + n_ln)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* xq = work;
  float* q = xq + rq;
  float* datt = q + rq;
  float* att = datt + rq;
  float* dq = att + rq;
  float* dxq = dq + rq;
  float* k = dxq + rq;
  float* v = k + rk;
  float* dk = v + rk;
  float* dv = dk + rk;
  float* ds = dv + rk;
  float* part = ds + n_ds;
  float* lnpart = part + n_part;
  using gsasr::launch_linear;
  using gsasr::launch_wgrad;
  using gsasr::Terms;

  // forward recompute: xq = LN(x) (+ pos); q, k, v
  GSASR_TRY_INT(gsasr::launch_ln_rows(x, nullptr, ln_w, ln_b, pos, xq, Mq, Tq,
                                      C, st));
  const float* src = kv ? kv : xq;
  GSASR_TRY_INT(launch_linear<false>(Terms{{xq}, {wq}, 1}, bq, nullptr, 0, q,
                                     Mq, C, C, st));
  GSASR_TRY_INT(launch_linear<false>(Terms{{src}, {wk}, 1}, bk, nullptr, 0, k,
                                     Mk, C, C, st));
  GSASR_TRY_INT(launch_linear<false>(Terms{{src}, {wv}, 1}, bv, nullptr, 0, v,
                                     Mk, C, C, st));
  // out-projection: datt = g wo; attention backward, att and dbias
  GSASR_TRY_INT(launch_linear<true>(Terms{{g}, {wo}, 1}, nullptr, nullptr, 0,
                                    datt, Mq, C, C, st));
  GSASR_TRY_INT(launch_window_attn_bwd<true>(q, k, v, bias, datt, dq, dk, dv,
                                             ds, dbias, att, B, Tq, Tk, C, nh,
                                             scale, st));
  // weight gradients, one partial buffer in turn (one stream, in order)
  GSASR_TRY_INT(launch_wgrad(g, att, part, dwo, dbo, Mq, C, C, st));
  GSASR_TRY_INT(launch_wgrad(dq, xq, part, dwq, dbq, Mq, C, C, st));
  GSASR_TRY_INT(launch_wgrad(dk, src, part, dwk, dbk, Mk, C, C, st));
  GSASR_TRY_INT(launch_wgrad(dv, src, part, dwv, dbv, Mk, C, C, st));
  // dxq (and dkv)
  if (kv) {
    GSASR_TRY_INT(launch_linear<true>(Terms{{dq}, {wq}, 1}, nullptr, nullptr,
                                      0, dxq, Mq, C, C, st));
    GSASR_TRY_INT(launch_linear<true>(Terms{{dk, dv}, {wk, wv}, 2}, nullptr,
                                      nullptr, 0, dkv, Mk, C, C, st));
  } else {
    GSASR_TRY_INT(launch_linear<true>(Terms{{dq, dk, dv}, {wq, wk, wv}, 3},
                                      nullptr, nullptr, 0, dxq, Mq, C, C, st));
  }
  if (pos) GSASR_TRY_INT(gsasr::launch_sum_terms(dxq, dpos, 1, B, Tq * C, st));
  GSASR_TRY_INT(gsasr::launch_ln_bwd(x, nullptr, ln_w, dxq, nullptr, dx,
                                     lnpart, dln, Mq, Tq, C, st));
  return static_cast<int>(cudaSuccess);
}
