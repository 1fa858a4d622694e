// Kernel AB: backward of kernel A (fused pre-norm multi-head attention with
// its out-projection), with the forward recomputed: the paper form (bias
// table), the Enhanced RoPE form and the bfloat16 forms of both.
//
// Replaces _k_ln_attn_bwd of gsasr_tpu/ops/fused_layers.py (the custom VJP
// of ln_attn_proj). Weights in nn.Linear layout (C, C). Forward as in
// ln_attn.cu: xq = LN(x) (+ pos), src = kv | xq, q0 = xq wq^T + bq,
// k0 = src wk^T + bk, v = src wv^T + bv, q, k = rope(q0), rope(k0) (or q0,
// k0), att_h = softmax(q_h k_h^T scale + bias[h]) v_h, out = att wo^T + bo.
// Backward:
//
//   dwo = g^T att, dbo = sum g, datt = g wo
//   per head: dv, dq, dk and ds as kernel WB computes them; dbias = sum ds
//   RoPE: d cos_q = sum_windows dq q0, d sin_q = sum_windows dq shuffle(q0)
//         (k likewise), then dq0 = dq cos - shuffle(dq) sin (the tables are
//         pair-duplicated, so the rotation's transpose is a rotation by
//         -sin); without RoPE dq0, dk0 = dq, dk
//   dwq = dq0^T xq, dwk = dk0^T src, dwv = dv^T src (and their bias sums)
//   dxq = dq0 wq (+ dk0 wk + dv wv for self-attention; for cross-attention
//         that sum is dkv)
//   dpos = sum over windows of dxq;  dx, d ln_w, d ln_b = LN backward
//
// with shuffle((e, o) pairs) = (-o, e). bfloat16 (ln_attn_bwd_bf16): x, pos,
// kv, g, dx, dpos and dkv are __nv_bfloat16; weights, biases, tables and
// their gradients float. It rounds where _k_ln_attn_bwd rounds: xq, q, k
// (after the f32 rotation), v, p and att as the forward does, the weights as
// they are staged, g wo^T before the per-head products, ds as an operand of
// dq and dk, and dq0, dk0 and dv as operands of the weight gradients and
// dxq / dkv (the bias sums, the table gradients and dbias take them
// unrounded), and dx, dpos and dkv as they are stored.
//
// What bounds it on an H100: eleven products of 2 T C^2 per window (the
// recomputed q, k, v; dwo, datt, dwq, dwk, dwv, dxq and two for dsrc) and
// six of 2 T^2 C (scores, p v, dp, dv, dq, dk): 37.7 GFLOP at 256 windows x
// 144 tokens x 180 channels (43.0 at 192). In float32 every product runs in
// 3xTF32, three TF32 products: 113 GFLOP against 495 TFLOP/s, 0.228 ms; its
// bytes (x, kv, g, dx, dkv: 133 MB in float32) take 0.04 ms at 3.35 TB/s.
// In bfloat16 the products take 0.043 ms at 989 TFLOP/s.
//
// Design (tile_mma.cuh, tile_mma_bwd.cuh and the attention bodies). A
// window's q, k, v, g and their gradients do not fit one block's shared
// memory beside the weights, so AB is a short sequence of launches through
// device-memory scratch, each on the tensor cores:
//   1. the weights' transposes (one small launch);
//   2. the recompute: kernel A's phase 1 (ln_qkv.cuh) forms q, k and v
//      (rotated and rounded as A forms them) and, for the backward, writes
//      xq and, with RoPE, the unrotated q0 and k0 (f32);
//   3. datt = g wo, rounded, on the row product of tile_mma_bwd.cuh;
//   4. att = p v for dwo: kernel A's attention launch, as the forward runs
//      it (W's or W-long's 3xTF32 body in fp32, W-bf16's or W-long-bf16's
//      in bf16);
//   5. the attention backward on WB's tensor-core bodies: in fp32 the 3xTF32
//      body up to 160 tokens (window_attn_short_tf32_bwd.cuh), WB-long's
//      launches beyond (AB-long); in bf16 WB-bf16's body (AB) or
//      WB-long-bf16's (AB-long) in their TO = float form, which rounds p and
//      ds once to bf16 as the Pallas body does and keeps dq, dk, dv f32;
//      dbias is the ordered sum of the per-window ds over the windows;
//   6. with RoPE, a row pass that rotates dq and dk back (over q0, k0) and
//      writes per-group partials of the four table gradients, summed in
//      group order;
//   7. the four weight gradients in one launch of partials over 128 fixed
//      groups of rows (tile_mma_bwd.cuh) and one of their ordered sums;
//   8. dxq = dq0 wq (+ dk0 wk + dv wv for self-attention) on the row product
//      with the LayerNorm backward in the same block (dx, the LN partials,
//      and dxq itself, f32, where pos needs it), and for cross-attention
//      dkv = dk0 wk + dv wv;
//   9. the ordered sums of the LN partials over the row tiles and of dxq
//      over the windows (dpos).
// No float atomics, so the result is the same bits from run to run.
//
// AB-long (ln_attn_bwd_long, ln_attn_bwd_long_bf16): the same VJP for
// windows of any Tq and Tk, which replaces _k_ln_attn_bwd beyond 160
// tokens (reached from _ln_attn_core_bwd, the custom VJP of ln_attn_proj, in
// the Ultra and SwinIR-Enhanced decoders' windows of 256 seeds): the same
// launches with the window-16 attention bodies in steps 4 and 5. Its bound
// at the Ultra step's 128 windows x 256 tokens x 192 channels: the eleven
// products of 2 T C^2 and six of 2 T^2 C per window are 45.9 GFLOP, 0.278
// ms in 3xTF32 at 495 TFLOP/s and 0.046 ms at the bf16 tensor-core peak;
// its bytes (x, kv, g, dx, dkv) take under 0.02 ms.

#include <cuda_runtime.h>

#include "ln_qkv.cuh"
#include "tile_mma_bwd.cuh"
#include "window_attn_long_mma.cuh"
#include "window_attn_long_mma_bwd.cuh"
#include "window_attn_long_tf32.cuh"
#include "window_attn_long_tf32_bwd.cuh"
#include "window_attn_short_mma.cuh"
#include "window_attn_short_mma_bwd.cuh"
#include "window_attn_short_tf32.cuh"
#include "window_attn_short_tf32_bwd.cuh"

namespace {

using namespace gsasr;

// The RoPE-table gradients are summed over groups of windows: at most
// kRopeGroups partials, summed in group order.
constexpr int kRopeGroups = 32;

// The back-rotation of the (B, T, C) dq given x0 (q0): over the windows of
// group blockIdx.y (per consecutive windows), in ascending order, per lane
// pair (t, c) the partials
//   part[0][grp][t][c] = sum dq x0,  part[1][grp][t][c] = sum dq shuffle(x0)
// of the table gradients, and x0 is overwritten with
//   dq0 = dq cos + shuffle(dq) (-sin)
// (each element is read before it is written, by its own thread). part
// holds 2 G T C floats, G the grid's groups.
__global__ void __launch_bounds__(kThreads)
rope_back_kernel(const float* __restrict__ dq, float* __restrict__ x0,
                 const float* __restrict__ cs, const float* __restrict__ sn,
                 float* __restrict__ part, int B, int T, int C, int per) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int half = C / 2;
  if (e >= T * half) return;
  const int t = e / half;
  const int o = t * C + 2 * (e - t * half);
  const int grp = blockIdx.y;
  const int w_end = min(grp * per + per, B);
  const float ce = cs[o], co = cs[o + 1], se = sn[o], so = sn[o + 1];
  float pc0 = 0.f, pc1 = 0.f, ps0 = 0.f, ps1 = 0.f;
  for (int w = grp * per; w < w_end; ++w) {
    const size_t i = static_cast<size_t>(w) * T * C + o;
    const float ge = dq[i], go = dq[i + 1];
    const float ae = x0[i], ao = x0[i + 1];
    pc0 += ge * ae;
    pc1 += go * ao;
    ps0 += ge * -ao;
    ps1 += go * ae;
    x0[i] = __fadd_rn(__fmul_rn(ge, ce), __fmul_rn(-go, -se));
    x0[i + 1] = __fadd_rn(__fmul_rn(go, co), __fmul_rn(ge, -so));
  }
  const size_t tc = static_cast<size_t>(T) * C;
  float* pc = part + static_cast<size_t>(grp) * tc;
  float* psn = part + (static_cast<size_t>(gridDim.y) + grp) * tc;
  pc[o] = pc0;
  pc[o + 1] = pc1;
  psn[o] = ps0;
  psn[o + 1] = ps1;
}

// dq0 over x0 in place, and the table gradients dcos, dsin (T, C) from the
// partials in `part` (2 kRopeGroups T C floats).
cudaError_t launch_rope_back(const float* dq, float* x0, const float* cs,
                             const float* sn, float* dcos, float* dsin,
                             float* part, int B, int T, int C,
                             cudaStream_t st) {
  const int per = (B + kRopeGroups - 1) / kRopeGroups;
  const int G = (B + per - 1) / per;
  rope_back_kernel<<<dim3((T * (C / 2) + kThreads - 1) / kThreads, G),
                     kThreads, 0, st>>>(dq, x0, cs, sn, part, B, T, C, per);
  GSASR_TRY(cudaGetLastError());
  const size_t tc = static_cast<size_t>(T) * C;
  GSASR_TRY(launch_ordered_sum(part, dcos, G, tc, T * C, st));
  return launch_ordered_sum(part + G * tc, dsin, G, tc, T * C, st);
}

// Arguments as ln_attn_bwd below, in the activation type Act (float, or
// __nv_bfloat16 for x, pos, kv, g, dx, dpos and dkv). work holds
// work_floats floats of scratch, in 16-byte pieces: the four transposed
// weights (4 C^2); q, xq, att, datt (B Tq C each, Act), k, v (B Tk C each,
// Act); dq (B Tq C), dk, dv (B Tk C each, f32); with RoPE q0 (B Tq C) and
// k0 (B Tk C, f32); the rows' softmax statistics (B nh Tq 3); with a bias
// the per-window ds (B nh Tq Tk); the weight-gradient partials (4
// kMaxGroups C (C + 1)); the LN partials (ceil(B Tq / 128) 2 C); with RoPE
// the table partials (2 kRopeGroups (Tq + Tk) C); with pos, dxq (B Tq C).
template <typename Act, bool kLong>
int ln_attn_bwd_impl(const Act* x, const Act* pos, const Act* kv,
                     const float* ln_w, const float* ln_b, const float* wq,
                     const float* bq, const float* wk, const float* bk,
                     const float* wv, const float* bv, const float* wo,
                     const float* bias, const float* cos_q,
                     const float* sin_q, const float* cos_k,
                     const float* sin_k, const Act* g, Act* dx, Act* dkv,
                     Act* dpos, float* dln, float* dwq, float* dbq,
                     float* dwk, float* dbk, float* dwv, float* dbv,
                     float* dwo, float* dbo, float* dbias, float* dcos_q,
                     float* dsin_q, float* dcos_k, float* dsin_k, float* work,
                     int work_floats, int B, int Tq, int Tk, int C, int nh,
                     float scale, cudaStream_t st) {
  constexpr bool kBf16 = sizeof(Act) == 2;
  const bool rope = cos_q != nullptr;
  const bool all_rope = sin_q && cos_k && sin_k && dcos_q && dsin_q &&
                        dcos_k && dsin_k;
  const bool no_rope = !sin_q && !cos_k && !sin_k && !dcos_q && !dsin_q &&
                       !dcos_k && !dsin_k;
  if (!long_shape_ok(B, Tq, Tk, C, nh) || C > kMaxN || C > 32 * kLnPer ||
      (!kLong && (Tq > kMaxT || Tk > kMaxT)) || (!kv && Tk != Tq) ||
      (kv == nullptr) != (dkv == nullptr) ||
      (pos == nullptr) != (dpos == nullptr) ||
      (bias == nullptr) != (dbias == nullptr) || !ln_w || !ln_b ||
      (rope ? !all_rope || (C / nh) % 2 != 0 : !no_rope) ||
      (kBf16 && (C / nh) % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Mq = B * Tq;
  const int Mk = B * Tk;
  const size_t rq = static_cast<size_t>(Mq) * C;
  const size_t rk = static_cast<size_t>(Mk) * C;
  const size_t cc = static_cast<size_t>(C) * C;
  const int tiles = (Mq + kTRows - 1) / kTRows;
  Carve cv{work};
  float* wqt = cv.take<float>(cc);
  float* wkt = cv.take<float>(cc);
  float* wvt = cv.take<float>(cc);
  float* wot = cv.take<float>(cc);
  Act* q = cv.take<Act>(rq);
  Act* xq = cv.take<Act>(rq);
  Act* att = cv.take<Act>(rq);
  Act* datt = cv.take<Act>(rq);
  Act* k = cv.take<Act>(rk);
  Act* v = cv.take<Act>(rk);
  float* dq = cv.take<float>(rq);
  float* dk = cv.take<float>(rk);
  float* dv = cv.take<float>(rk);
  float* q0 = rope ? cv.take<float>(rq) : nullptr;
  float* k0 = rope ? cv.take<float>(rk) : nullptr;
  float* stats = cv.take<float>(static_cast<size_t>(B) * nh * Tq * 3);
  float* ds =
      bias ? cv.take<float>(static_cast<size_t>(B) * nh * Tq * Tk) : nullptr;
  float* part = cv.take<float>(4 * static_cast<size_t>(kMaxGroups) * C *
                               (C + 1));
  float* lnpart = cv.take<float>(static_cast<size_t>(tiles) * 2 * C);
  float* rpart =
      rope ? cv.take<float>(2 * static_cast<size_t>(kRopeGroups) * (Tq + Tk) *
                            C)
           : nullptr;
  float* dxq = pos ? cv.take<float>(rq) : nullptr;
  if (static_cast<size_t>(work_floats) < cv.used)
    return static_cast<int>(cudaErrorInvalidValue);

  // 1. the transposed weights
  WtJobs wt{{wq, wk, wv, wo}, {wqt, wkt, wvt, wot}, {C, C, C, C},
            {C, C, C, C}};
  GSASR_TRY_INT(launch_wt(wt, 4, st));
  // 2. forward recompute: q, k, v (rotated, rounded), xq, q0, k0
  constexpr size_t smem = tile_smem_bytes<typename TileOf<Act>::type>();
  GSASR_TRY_INT(tile_prepare(ln_qkv_kernel<Act, true>, smem));
  const int vec1 = C % 4 == 0 && tile_aligned({kv, bq, bk, bv, cos_q, sin_q,
                                               cos_k, sin_k, q, k, v, q0,
                                               k0, xq});
  ln_qkv_kernel<Act, true>
      <<<dim3((B * (Tq > Tk ? Tq : Tk) + kTRows - 1) / kTRows, 3), kTThreads,
         smem, st>>>(x, pos, kv, ln_w, ln_b, wq, bq, wk, bk, wv, bv, cos_q,
                     sin_q, cos_k, sin_k, q, k, v, B, Tq, Tk, C, vec1, xq, q0,
                     k0);
  GSASR_TRY_INT(cudaGetLastError());
  // 3. datt = g wo, rounded
  GSASR_TRY_INT(launch_rows_bwd<Act, Act>(RowTerms<Act>{{g}, {wot}, 1}, datt,
                                          nullptr, nullptr, nullptr, nullptr,
                                          nullptr, Mq, Tq, C, C, st));
  // 4. att = p v as kernel A forms it; 5. the attention backward and dbias
  float* ds_w = bias ? ds : nullptr;
  if constexpr (kBf16) {
    if constexpr (kLong) {
      GSASR_TRY_INT(launch_fwd_long_mma<false, false>(
          q, k, v, bias, nullptr, att, B, Tq, Tk, C, nh, 1, scale, st));
      GSASR_TRY_INT((launch_window_attn_bwd_long_mma<false, false, float>(
          q, k, v, bias, datt, dq, dk, dv, stats, ds_w, dbias, B, Tq, Tk, C,
          nh, scale, st)));
    } else {
      GSASR_TRY_INT(launch_fwd_short_mma<false, false>(
          q, k, v, bias, nullptr, att, B, Tq, Tk, C, nh, 1, scale, st));
      GSASR_TRY_INT((launch_bwd_short_mma<false, false, float>(
          q, k, v, bias, datt, dq, dk, dv, ds_w, dbias, B, Tq, Tk, C, nh,
          scale, st)));
    }
  } else {
    if constexpr (kLong) {
      GSASR_TRY_INT(launch_fwd_long_tf32<false, false>(
          q, k, v, bias, nullptr, att, B, Tq, Tk, C, nh, 1, scale, st));
      GSASR_TRY_INT((launch_window_attn_bwd_long_tf32<false, false>(
          q, k, v, bias, datt, dq, dk, dv, stats, ds_w, dbias, B, Tq, Tk, C,
          nh, scale, st)));
    } else {
      GSASR_TRY_INT(launch_fwd_short_tf32<false, false>(
          q, k, v, bias, nullptr, att, B, Tq, Tk, C, nh, 1, scale, st));
      GSASR_TRY_INT((launch_window_attn_bwd_short_tf32<false, false>(
          q, k, v, bias, datt, dq, dk, dv, stats, ds_w, dbias, B, Tq, Tk, C,
          nh, scale, st)));
    }
  }
  // 6. RoPE: the table gradients, and dq0, dk0 over q0, k0
  if (rope) {
    GSASR_TRY_INT(launch_rope_back(dq, q0, cos_q, sin_q, dcos_q, dsin_q, rpart,
                                   B, Tq, C, st));
    GSASR_TRY_INT(launch_rope_back(dk, k0, cos_k, sin_k, dcos_k, dsin_k, rpart,
                                   B, Tk, C, st));
  }
  const float* dq0 = rope ? q0 : dq;
  const float* dk0 = rope ? k0 : dk;
  const Act* src = kv ? kv : xq;
  // 7. dwo = g^T att, dwq = dq0^T xq, dwk = dk0^T src, dwv = dv^T src and
  // their bias sums
  const size_t np = static_cast<size_t>(kMaxGroups) * C * (C + 1);
  WgradJobs jobs{};
  jobs.j[0] = WgradJob{g, att, part, dwo, dbo, Mq, C, C, 0, 0, 1};
  jobs.j[1] = WgradJob{dq0, xq, part + np, dwq, dbq, Mq, C, C, 0, 0, 0};
  jobs.j[2] = WgradJob{dk0, src, part + 2 * np, dwk, dbk, Mk, C, C, 0, 0, 0};
  jobs.j[3] = WgradJob{dv, src, part + 3 * np, dwv, dbv, Mk, C, C, 0, 0, 0};
  GSASR_TRY_INT(launch_wgrad_mma<Act>(jobs, 4, st));
  // 8. dxq with the LN backward (dx, its partials, dxq for dpos), and dkv
  if (kv) {
    GSASR_TRY_INT(launch_rows_bwd<Act, float>(
        RowTerms<float>{{dq0}, {wqt}, 1}, nullptr, x, ln_w, dx, dxq, lnpart,
        Mq, Tq, C, C, st));
    GSASR_TRY_INT(launch_rows_bwd<Act, float>(
        RowTerms<float>{{dk0, dv}, {wkt, wvt}, 2}, dkv, nullptr, nullptr,
        nullptr, nullptr, nullptr, Mk, Tk, C, C, st));
  } else {
    GSASR_TRY_INT(launch_rows_bwd<Act, float>(
        RowTerms<float>{{dq0, dk0, dv}, {wqt, wkt, wvt}, 3}, nullptr, x, ln_w,
        dx, dxq, lnpart, Mq, Tq, C, C, st));
  }
  // 9. d ln_w, d ln_b over the row tiles; dpos over the windows
  GSASR_TRY_INT(launch_ordered_sum(lnpart, dln, tiles, 2 * C, 2 * C, st));
  if (pos) GSASR_TRY_INT(launch_ordered_sum(dxq, dpos, B, rq / B, Tq * C, st));
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// x, g, dx (B, Tq, C); kv, dkv (B, Tk, C) or null (self-attention, Tk ==
// Tq); pos, dpos (Tq, C) or null; ln_w, ln_b (C); dln (2, C) = (d ln_w,
// d ln_b); weights and their gradients (C, C), biases and theirs (C); bias,
// dbias (nh, Tq, Tk) or null; cos_q, sin_q, dcos_q, dsin_q (Tq, C) and
// cos_k, sin_k, dcos_k, dsin_k (Tk, C), pair-duplicated, all or none (then
// an even head width). Scratch as ln_attn_bwd_impl.
extern "C" int ln_attn_bwd(const float* x, const float* pos, const float* kv,
                           const float* ln_w, const float* ln_b,
                           const float* wq, const float* bq, const float* wk,
                           const float* bk, const float* wv, const float* bv,
                           const float* wo, const float* bias,
                           const float* cos_q, const float* sin_q,
                           const float* cos_k, const float* sin_k,
                           const float* g, float* dx, float* dkv, float* dpos,
                           float* dln, float* dwq, float* dbq, float* dwk,
                           float* dbk, float* dwv, float* dbv, float* dwo,
                           float* dbo, float* dbias, float* dcos_q,
                           float* dsin_q, float* dcos_k, float* dsin_k,
                           float* work, int work_floats, int B, int Tq, int Tk,
                           int C, int nh, float scale, void* stream) {
  return ln_attn_bwd_impl<float, false>(
      x, pos, kv, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bias, cos_q, sin_q,
      cos_k, sin_k, g, dx, dkv, dpos, dln, dwq, dbq, dwk, dbk, dwv, dbv, dwo,
      dbo, dbias, dcos_q, dsin_q, dcos_k, dsin_k, work, work_floats, B, Tq, Tk,
      C, nh, scale, static_cast<cudaStream_t>(stream));
}

// The bfloat16 form: arguments as ln_attn_bwd, the activations bfloat16.
extern "C" int ln_attn_bwd_bf16(
    const __nv_bfloat16* x, const __nv_bfloat16* pos,
    const __nv_bfloat16* kv, const float* ln_w, const float* ln_b,
    const float* wq, const float* bq, const float* wk, const float* bk,
    const float* wv, const float* bv, const float* wo, const float* bias,
    const float* cos_q, const float* sin_q, const float* cos_k,
    const float* sin_k, const __nv_bfloat16* g, __nv_bfloat16* dx,
    __nv_bfloat16* dkv, __nv_bfloat16* dpos, float* dln, float* dwq,
    float* dbq, float* dwk, float* dbk, float* dwv, float* dbv, float* dwo,
    float* dbo, float* dbias, float* dcos_q, float* dsin_q, float* dcos_k,
    float* dsin_k, float* work, int work_floats, int B, int Tq, int Tk, int C,
    int nh, float scale, void* stream) {
  return ln_attn_bwd_impl<__nv_bfloat16, false>(
      x, pos, kv, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bias, cos_q, sin_q,
      cos_k, sin_k, g, dx, dkv, dpos, dln, dwq, dbq, dwk, dbk, dwv, dbv, dwo,
      dbo, dbias, dcos_q, dsin_q, dcos_k, dsin_k, work, work_floats, B, Tq, Tk,
      C, nh, scale, static_cast<cudaStream_t>(stream));
}

// Kernel AB-long: as ln_attn_bwd for windows of any Tq and Tk (the window-16
// form); scratch as ln_attn_bwd_impl with kLong.
extern "C" int ln_attn_bwd_long(
    const float* x, const float* pos, const float* kv, const float* ln_w,
    const float* ln_b, const float* wq, const float* bq, const float* wk,
    const float* bk, const float* wv, const float* bv, const float* wo,
    const float* bias, const float* cos_q, const float* sin_q,
    const float* cos_k, const float* sin_k, const float* g, float* dx,
    float* dkv, float* dpos, float* dln, float* dwq, float* dbq, float* dwk,
    float* dbk, float* dwv, float* dbv, float* dwo, float* dbo, float* dbias,
    float* dcos_q, float* dsin_q, float* dcos_k, float* dsin_k, float* work,
    int work_floats, int B, int Tq, int Tk, int C, int nh, float scale,
    void* stream) {
  return ln_attn_bwd_impl<float, true>(
      x, pos, kv, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bias, cos_q, sin_q,
      cos_k, sin_k, g, dx, dkv, dpos, dln, dwq, dbq, dwk, dbk, dwv, dbv, dwo,
      dbo, dbias, dcos_q, dsin_q, dcos_k, dsin_k, work, work_floats, B, Tq, Tk,
      C, nh, scale, static_cast<cudaStream_t>(stream));
}

// Kernel AB-long-bf16: as ln_attn_bwd_long, the activations bfloat16.
extern "C" int ln_attn_bwd_long_bf16(
    const __nv_bfloat16* x, const __nv_bfloat16* pos,
    const __nv_bfloat16* kv, const float* ln_w, const float* ln_b,
    const float* wq, const float* bq, const float* wk, const float* bk,
    const float* wv, const float* bv, const float* wo, const float* bias,
    const float* cos_q, const float* sin_q, const float* cos_k,
    const float* sin_k, const __nv_bfloat16* g, __nv_bfloat16* dx,
    __nv_bfloat16* dkv, __nv_bfloat16* dpos, float* dln, float* dwq,
    float* dbq, float* dwk, float* dbk, float* dwv, float* dbv, float* dwo,
    float* dbo, float* dbias, float* dcos_q, float* dsin_q, float* dcos_k,
    float* dsin_k, float* work, int work_floats, int B, int Tq, int Tk, int C,
    int nh, float scale, void* stream) {
  return ln_attn_bwd_impl<__nv_bfloat16, true>(
      x, pos, kv, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bias, cos_q, sin_q,
      cos_k, sin_k, g, dx, dkv, dpos, dln, dwq, dbq, dwk, dbk, dwv, dbv, dwo,
      dbo, dbias, dcos_q, dsin_q, dcos_k, dsin_k, work, work_floats, B, Tq, Tk,
      C, nh, scale, static_cast<cudaStream_t>(stream));
}
