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
// 144 tokens x 180 channels (43.0 at 192), 0.56-0.64 ms at 67 TFLOP/s FP32;
// its bytes (x, kv, g, dx, dkv: 133 MB in float32) take a quarter of that
// at 3.35 TB/s. The bfloat16 forms run the same f32 FMAs; against the bf16
// tensor-core peak their bound is set by their bytes.
//
// Design. One window's f32 working set (x, q, k, v: 4 x 104 KB) does not
// fit a block's shared memory, so AB is a short sequence of launches
// through device-memory scratch: the LN rows and the q, k, v and datt tile
// products (fused_bwd.cuh); with RoPE a rotation pass q0, k0 -> q, k; the
// per-(window, head) attention backward of kernel WB (window_attn_bwd.cuh),
// which also forms att from its p tile and sums dbias over the windows in
// order; with RoPE a back-rotation pass dq, dk -> dq0, dk0 (in place over
// q0, k0) that also writes per-group partials of the four table gradients,
// summed in group order; the four weight gradients as partial sums over 128
// fixed groups of rows, summed in group order; the dxq / dkv products; the
// sum of dxq over the windows for dpos; and the LN backward, one warp per
// row. In bfloat16, x, kv and g are widened to f32 scratch first and dx,
// dpos and dkv narrowed last. No float atomics, so the result is the same
// bits from run to run.
//
// AB-long (ln_attn_bwd_long, ln_attn_bwd_long_bf16): the same VJP for
// windows of any Tq and Tk, which replaces _k_ln_attn_bwd beyond WB's 160
// tokens (reached from _ln_attn_core_bwd, the custom VJP of ln_attn_proj, in
// the Ultra and SwinIR-Enhanced decoders' windows of 256 seeds). It is AB's
// sequence above with its attention step swapped for the two launches of
// the window-16 FMA body (window_attn_long_bwd.cuh): the dq launch keeps
// each row's (max, sum, D) in a (B, nh, Tq, 3) scratch and, with AB's
// flags, forms att = p v in its D pass and rounds as AB-bf16 rounds; the
// dk / dv launch walks the query tiles in order. A bias's gradient is the
// same ordered sum over windows of a per-window ds, which only a bias
// needs. Its bound at the Ultra step's 128 windows x 256 tokens x 192
// channels: the eleven products of 2 T C^2
// and six of 2 T^2 C per window are 45.9 GFLOP, 0.685 ms at the FP32 peak
// and 0.046 ms at the bf16 tensor-core peak; its bytes (x, kv, g, dx, dkv)
// take under 0.02 ms. This first form is the two bodies, already measured,
// joined: simple and right, with speed left for later (it recomputes the
// scores five times where the function needs them once).

#include <cuda_runtime.h>

#include "fused_bwd.cuh"
#include "window_attn_long_bwd.cuh"

namespace {

using gsasr::blocks_for;
using gsasr::kThreads;
using gsasr::launch_linear;
using gsasr::launch_wgrad;
using gsasr::Terms;

// The RoPE-table gradients are summed over groups of windows: at most
// kRopeGroups partials, summed in group order.
constexpr int kRopeGroups = 32;

// out = x0 cos + shuffle(x0) sin (rounded to bf16 with kRnd) for the
// (M, C) rows of x0, row r taking table row r % T; one thread per lane
// pair, products and sum unfused as the plain version forms them.
template <bool kRnd>
__global__ void __launch_bounds__(kThreads)
rope_rows_kernel(const float* __restrict__ x0, const float* __restrict__ cs,
                 const float* __restrict__ sn, float* __restrict__ out, int M,
                 int T, int C) {
  const size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int half = C / 2;
  if (e >= static_cast<size_t>(M) * half) return;
  const size_t r = e / half;
  const size_t o = r * C + 2 * (e - r * half);
  const size_t t = (r % T) * C + (o - r * C);
  const float a = x0[o], b = x0[o + 1];
  float ye = __fadd_rn(__fmul_rn(a, cs[t]), __fmul_rn(-b, sn[t]));
  float yo = __fadd_rn(__fmul_rn(b, cs[t + 1]), __fmul_rn(a, sn[t + 1]));
  if (kRnd) {
    ye = gsasr::rnd<__nv_bfloat16>(ye);
    yo = gsasr::rnd<__nv_bfloat16>(yo);
  }
  out[o] = ye;
  out[o + 1] = yo;
}

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

template <bool kRnd>
cudaError_t launch_rope_rows(const float* x0, const float* cs,
                             const float* sn, float* out, int M, int T, int C,
                             cudaStream_t st) {
  rope_rows_kernel<kRnd>
      <<<blocks_for(static_cast<size_t>(M) * (C / 2), kThreads), kThreads, 0,
         st>>>(x0, cs, sn, out, M, T, C);
  return cudaGetLastError();
}

// dq0 over x0 in place, and the table gradients dcos, dsin (T, C) from the
// partials in `part` (2 kRopeGroups T C floats).
cudaError_t launch_rope_back(const float* dq, float* x0, const float* cs,
                             const float* sn, float* dcos, float* dsin,
                             float* part, int B, int T, int C,
                             cudaStream_t st) {
  const int per = (B + kRopeGroups - 1) / kRopeGroups;
  const int G = (B + per - 1) / per;
  rope_back_kernel<<<dim3(blocks_for(static_cast<size_t>(T) * (C / 2),
                                     kThreads),
                          G),
                     kThreads, 0, st>>>(dq, x0, cs, sn, part, B, T, C, per);
  GSASR_TRY(cudaGetLastError());
  const size_t tc = static_cast<size_t>(T) * C;
  GSASR_TRY(gsasr::launch_sum_terms(part, dcos, 1, G, T * C, st));
  return gsasr::launch_sum_terms(part + G * tc, dsin, 1, G, T * C, st);
}

// Arguments as ln_attn_bwd below, in the activation type Act (float, or
// __nv_bfloat16 for x, pos, kv, g, dx, dpos and dkv). work holds
// work_floats floats of scratch: (6 B Tq + 4 B Tk) C for xq, q, datt, att,
// dq, dxq, k, v, dk, dv, then B nh Tq Tk for the per-window ds (with kLong,
// AB-long: B nh Tq 3 for the rows' statistics, and B nh Tq Tk for ds only
// with a bias), kMaxGroups C (C + 1) for the weight-gradient partials,
// ceil(B Tq / 64) 2 C for the LN partials; with RoPE (B Tq + B Tk) C for q0
// and k0 and 2 kRopeGroups (Tq + Tk) C for the table partials; in bfloat16
// (3 B Tq + 2 B Tk) C + Tq C for x, g and kv widened and dx, dkv and dpos
// in f32.
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
  if (B < 1 || nh < 1 || C % nh != 0 || C / nh > kMaxHd ||
      C > gsasr::kMaxN || C > 32 * gsasr::kLnPer || Tq < 1 || Tk < 1 ||
      (kLong ? !gsasr::long_shape_ok(B, Tq, Tk, C, nh)
             : Tq > kMaxT || Tk > kMaxT) ||
      (!kv && Tk != Tq) ||
      (kv == nullptr) != (dkv == nullptr) ||
      (pos == nullptr) != (dpos == nullptr) ||
      (bias == nullptr) != (dbias == nullptr) ||
      (rope ? !all_rope || (C / nh) % 2 != 0 : !no_rope) ||
      (kBf16 && (C / nh) % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Mq = B * Tq;
  const int Mk = B * Tk;
  const size_t rq = static_cast<size_t>(Mq) * C;
  const size_t rk = static_cast<size_t>(Mk) * C;
  const size_t n_stats = kLong ? static_cast<size_t>(B) * nh * Tq * 3 : 0;
  const size_t n_ds = (!kLong || bias) ? static_cast<size_t>(B) * nh * Tq * Tk
                                       : 0;
  const size_t n_part = static_cast<size_t>(gsasr::kMaxGroups) * C * (C + 1);
  const size_t n_ln = static_cast<size_t>(blocks_for(Mq, gsasr::kBM)) * 2 * C;
  const size_t n_rope =
      rope ? rq + rk + 2 * static_cast<size_t>(kRopeGroups) * (Tq + Tk) * C
           : 0;
  const size_t n_wide =
      kBf16 ? 3 * rq + 2 * rk + static_cast<size_t>(Tq) * C : 0;
  if (static_cast<size_t>(work_floats) <
      6 * rq + 4 * rk + n_stats + n_ds + n_part + n_ln + n_rope + n_wide)
    return static_cast<int>(cudaErrorInvalidValue);
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
  float* stats = dv + rk;
  float* ds = stats + n_stats;
  float* part = ds + n_ds;
  float* lnpart = part + n_part;
  float* q0 = q;  // without RoPE q0 is q, and dq0 is dq
  float* k0 = k;
  float* rpart = nullptr;
  if (rope) {
    q0 = lnpart + n_ln;
    k0 = q0 + rq;
    rpart = k0 + rk;
  }
  // f32 views of x, kv and g, and f32 targets of dx, dkv and dpos
  const float* xf;
  const float* kvf;
  const float* gf;
  float* dxf;
  float* dkvf;
  float* dposf;
  if constexpr (kBf16) {
    float* wide = lnpart + n_ln + n_rope;
    xf = wide;
    gf = wide + rq;
    dxf = wide + 2 * rq;
    kvf = kv ? wide + 3 * rq : nullptr;
    dkvf = kv ? wide + 3 * rq + rk : nullptr;
    dposf = pos ? wide + 3 * rq + 2 * rk : nullptr;
    GSASR_TRY_INT(gsasr::launch_convert(x, wide, rq, st));
    GSASR_TRY_INT(gsasr::launch_convert(g, wide + rq, rq, st));
    if (kv) GSASR_TRY_INT(gsasr::launch_convert(kv, wide + 3 * rq, rk, st));
  } else {
    xf = x;
    kvf = kv;
    gf = g;
    dxf = dx;
    dkvf = dkv;
    dposf = dpos;
  }
  // pos widens as the LN rows read it: a small (Tq, C) copy in bfloat16
  const float* posf = nullptr;
  if (pos) {
    if constexpr (kBf16) {
      GSASR_TRY_INT(gsasr::launch_convert(pos, dposf,
                                          static_cast<size_t>(Tq) * C, st));
      posf = dposf;
    } else {
      posf = pos;
    }
  }

  // forward recompute: xq = LN(x) (+ pos); q0, k0, v; with RoPE q, k
  GSASR_TRY_INT(gsasr::launch_ln_rows<kBf16>(xf, nullptr, ln_w, ln_b, posf,
                                             xq, Mq, Tq, C, st));
  const float* src = kv ? kvf : xq;
  const int rnd_qk = kBf16 && !rope;
  GSASR_TRY_INT(launch_linear<false, kBf16>(Terms{{xq}, {wq}, 1}, bq, nullptr,
                                            0, q0, Mq, C, C, st, rnd_qk));
  GSASR_TRY_INT(launch_linear<false, kBf16>(Terms{{src}, {wk}, 1}, bk,
                                            nullptr, 0, k0, Mk, C, C, st,
                                            rnd_qk));
  GSASR_TRY_INT(launch_linear<false, kBf16>(Terms{{src}, {wv}, 1}, bv,
                                            nullptr, 0, v, Mk, C, C, st, 1));
  if (rope) {
    GSASR_TRY_INT(launch_rope_rows<kBf16>(q0, cos_q, sin_q, q, Mq, Tq, C, st));
    GSASR_TRY_INT(launch_rope_rows<kBf16>(k0, cos_k, sin_k, k, Mk, Tk, C, st));
  }
  // out-projection: datt = g wo (rounded); attention backward, att, dbias
  GSASR_TRY_INT(launch_linear<true, kBf16>(Terms{{gf}, {wo}, 1}, nullptr,
                                           nullptr, 0, datt, Mq, C, C, st, 1));
  if constexpr (kLong)
    GSASR_TRY_INT(launch_window_attn_bwd_long<float, true, kBf16>(
        q, k, v, bias, datt, dq, dk, dv, stats, bias ? ds : nullptr, dbias, B,
        Tq, Tk, C, nh, scale, st, att));
  else
    GSASR_TRY_INT(launch_window_attn_bwd<true, false, float, kBf16>(
        q, k, v, bias, datt, dq, dk, dv, ds, dbias, att, B, Tq, Tk, C, nh,
        scale, st));
  // RoPE: the table gradients, and dq0, dk0 over q0, k0
  if (rope) {
    GSASR_TRY_INT(launch_rope_back(dq, q0, cos_q, sin_q, dcos_q, dsin_q, rpart,
                                   B, Tq, C, st));
    GSASR_TRY_INT(launch_rope_back(dk, k0, cos_k, sin_k, dcos_k, dsin_k, rpart,
                                   B, Tk, C, st));
  }
  const float* dq0 = rope ? q0 : dq;
  const float* dk0 = rope ? k0 : dk;
  // weight gradients, one partial buffer in turn (one stream, in order)
  GSASR_TRY_INT(launch_wgrad<kBf16>(gf, att, part, dwo, dbo, Mq, C, C, st));
  GSASR_TRY_INT(launch_wgrad<kBf16>(dq0, xq, part, dwq, dbq, Mq, C, C, st));
  GSASR_TRY_INT(launch_wgrad<kBf16>(dk0, src, part, dwk, dbk, Mk, C, C, st));
  GSASR_TRY_INT(launch_wgrad<kBf16>(dv, src, part, dwv, dbv, Mk, C, C, st));
  // dxq (and dkv)
  if (kv) {
    GSASR_TRY_INT(launch_linear<true, kBf16>(Terms{{dq0}, {wq}, 1}, nullptr,
                                             nullptr, 0, dxq, Mq, C, C, st));
    GSASR_TRY_INT(launch_linear<true, kBf16>(Terms{{dk0, dv}, {wk, wv}, 2},
                                             nullptr, nullptr, 0, dkvf, Mk, C,
                                             C, st));
  } else {
    GSASR_TRY_INT(launch_linear<true, kBf16>(
        Terms{{dq0, dk0, dv}, {wq, wk, wv}, 3}, nullptr, nullptr, 0, dxq, Mq,
        C, C, st));
  }
  if (pos) GSASR_TRY_INT(gsasr::launch_sum_terms(dxq, dposf, 1, B, Tq * C, st));
  GSASR_TRY_INT(gsasr::launch_ln_bwd(xf, nullptr, ln_w, dxq, nullptr, dxf,
                                     lnpart, dln, Mq, Tq, C, st));
  if constexpr (kBf16) {
    GSASR_TRY_INT(gsasr::launch_convert(dxf, dx, rq, st));
    if (kv) GSASR_TRY_INT(gsasr::launch_convert(dkvf, dkv, rk, st));
    if (pos)
      GSASR_TRY_INT(gsasr::launch_convert(dposf, dpos,
                                          static_cast<size_t>(Tq) * C, st));
  }
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
