// The bf16 window attention backward up to 160 tokens on Hopper's tensor
// cores: the body of WB-bf16 (window_attn_bwd_bf16), with its template
// flags WMB-bf16 (kMask) and WB4-bf16 (kHM). It replaces the bf16 operand
// forms of _attn_kernel_packed_bwd (gsasr_tpu/ops/attention.py, Pallas
// K12), of _attn_kernel_packed_masked_bwd (K13b) and of _attn_kernel_bwd
// (K14b) at Tq, Tk <= 160, and kernel AB-bf16's attention (its TO = float
// form). The fp32 forms run window_attn_short_tf32_bwd.cuh. Per window w and head h, with the softmax
// recomputed as the forward forms it:
//
//   p = softmax(q_h k_h^T * scale (+ bias[h]) (+ mask[w % nW]))   (f32)
//   dv = p^T g_h      dp = g_h v_h^T      ds = p (dp - D),  D = sum_j p dp
//   dq = ds k_h * scale                   dk = ds^T q_h * scale
//   dbias[h] = sum over the windows of ds
//
// Bound on an H100: at the Enhanced step's 256 windows x 6 heads x 144 x
// 144 x 32 the five products are 10.2 GFLOP (10 us at 989 TFLOP/s) against
// 99 MB of bf16 q, k, v, g, dq, dk and dv (30 us at 3.35 TB/s): bound by
// bytes. This body forms 11 such products (below: the scores twice, dp
// three times, dq, dk, dv as hi/lo pairs), 22 GFLOP, and 2 x 32 M
// exponentials, about 15 us on the MUFU.
//
// Precision. As in the Pallas body and the plain version, p and ds are f32
// and never rounded: each enters a bf16 product (p for dv, ds for dq and
// dk) as a pair hi = bf16(x), lo = bf16(x - hi), two products into one f32
// sum (mma_split, as window_attn_long_mma_bwd.cuh does). dq, dk and dv are
// rounded to bf16 once, as they are stored; dbias stays f32.
//
// Design. One block per (head, window) stages q, g, k and v once (bf16 at
// the 80-byte stride, rows padded with zeros to a multiple of 16; 46 KB at
// 144 tokens, 51 KB at 160, dynamic shared memory), with one warp per 16
// rows of the longer side, in two phases split by a __syncthreads:
//
// 1. Query rows, 16 a warp: p of the whole row in registers, as the
//    forward forms it (short_probs: one exponential per score, the row max
//    and sum joined over the quad); D = sum_j p dp from dp = g v^T formed
//    chunk by chunk (each lane its own columns in chunk order, joined over
//    the quad); then dp again, ds = p (dp - D) and dq += ds k, with k's B
//    fragments by ldmatrix.trans. Each row's max, 1 / sum and D go to
//    shared memory, not to device memory; with a bias, ds also goes to ds_w
//    (B, nh, Tq, Tk) for dbias's ordered sum over the windows.
// 2. Key rows, 16 a warp: the transposed scores s^T = k q^T and dp^T = v
//    g^T with k and v as the A operand, chunk by chunk of 16 queries; p^T
//    from the rows' statistics (a second exponential per score), ds^T = p^T
//    (dp^T - D); both sit in the accumulator layout, which is the A layout
//    of dv += p^T g and dk += ds^T q (q's and g's B fragments by
//    ldmatrix.trans), so neither passes through shared memory, and ds
//    never goes to device memory without a bias.
//
// kNC, the register array's chunks, is 4, 9 or 10 by max(Tq, Tk) and bounds
// the block's threads (32 kNC); windows of up to 64 tokens (SwinIR's) are
// held to four blocks of four warps an SM (128 registers, no spills; three
// blocks at 130 unbounded). The longer windows' 164-168 registers keep one
// block of nine or ten warps an SM: a query row's 72-80 scores stay in
// registers through phase 1.
//
// Each output is owned by one block and every sum runs in one fixed order,
// with no float atomics, so two launches give the same bits. dbias is
// window_attn_bwd.cuh's second launch, the sum of ds_w over the windows in
// ascending order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mma_ptx.cuh"
#include "window_attn_bwd.cuh"
#include "window_attn_long_mma_bwd.cuh"
#include "window_attn_short_mma.cuh"

namespace gsasr {

// Dynamic shared memory of the backward: q, g (Tq rows), k, v (Tk rows) at
// kMLd, then each query row's max, 1 / sum and D.
inline size_t short_bwd_smem_bytes(int Tq, int Tk) {
  const int tq16 = short_rows(Tq);
  return sizeof(__nv_bfloat16) * kMLd * (2 * tq16 + 2 * short_rows(Tk)) +
         sizeof(float) * 3 * tq16;
}

// The backward, one block of 2 max(short_rows(Tq), short_rows(Tk)) threads
// per (head, window): dq, dk, dv (TO) in the operands' layout, and ds into
// ds_w when it is not null. Layouts and flags as the forward's. TO = float
// is kernel AB-bf16's form: p and ds enter their products rounded once to
// bf16 (as _k_ln_attn_bwd rounds them), not as hi/lo pairs, and dq, dk,
// dv stay f32 for the RoPE back-rotation and the bias sums.
template <bool kMask, bool kHM, int kNC, typename TO = __nv_bfloat16>
__global__ void __launch_bounds__(32 * kNC, kNC == 4 ? 4 : 1)
window_attn_bwd_short_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 const float* __restrict__ bias,
                                 const __nv_bfloat16* __restrict__ g,
                                 TO* __restrict__ dq, TO* __restrict__ dk,
                                 TO* __restrict__ dv,
                                 float* __restrict__ ds_w, int Tq, int Tk,
                                 int C, int nh, float scale,
                                 const float* __restrict__ mask, int nW,
                                 int vec) {
  constexpr bool kOne = sizeof(TO) == 4;
  extern __shared__ __align__(16) unsigned char short_smem[];
  const int tq16 = short_rows(Tq);
  const int tk16 = short_rows(Tk);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(short_smem);
  __nv_bfloat16* gs = qs + tq16 * kMLd;
  __nv_bfloat16* ks = gs + tq16 * kMLd;
  __nv_bfloat16* vs = ks + tk16 * kMLd;
  // each query row's max, 1 / sum and D
  float* st_mx = reinterpret_cast<float*>(vs + tk16 * kMLd);
  float* st_inv = st_mx + tq16;
  float* st_d = st_inv + tq16;
  const int hd = C / nh;
  const int head = blockIdx.x;
  const int win = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gi = lane >> 2;
  const int t = lane & 3;
  const int n0 = kHM ? 0 : head * hd;
  const int ldg = kHM ? hd : C;
  const size_t wrow = kHM ? static_cast<size_t>(win) * nh + head : win;
  const int step = blockDim.x / 2;  // rows of all warps: 16 a warp
  const float* hb =
      bias ? bias + static_cast<size_t>(head) * Tq * Tk : nullptr;
  const float* mb = kMask ? long_window_mask(mask, win, nW, Tq, Tk) : nullptr;
  const size_t srow0 = (static_cast<size_t>(win) * nh + head) * Tq;
  const int nc = tk16 / 16;

  mma_stage_n(qs, q, wrow * Tq, Tq, tq16, ldg, n0, hd, vec, blockDim.x);
  mma_stage_n(gs, g, wrow * Tq, Tq, tq16, ldg, n0, hd, vec, blockDim.x);
  mma_stage_n(ks, k, wrow * Tk, Tk, tk16, ldg, n0, hd, vec, blockDim.x);
  mma_stage_n(vs, v, wrow * Tk, Tk, tk16, ldg, n0, hd, vec, blockDim.x);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // Phase 1: query rows r0 .. r0 + 15 of this warp.
  for (int r0 = warp * 16; r0 < tq16; r0 += step) {
    const size_t off0 = static_cast<size_t>(min(r0 + gi, Tq - 1)) * Tk;
    const size_t off1 = static_cast<size_t>(min(r0 + gi + 8, Tq - 1)) * Tk;
    uint32_t qa[2][4], ga[2][4];
    mma_load_a(qa, qs, r0);
    mma_load_a(ga, gs, r0);
    float p[kNC][2][4], mx[2], inv[2];
    short_probs<kMask>(p, mx, inv, qa, ks, nc, Tk, scale, hb, mb, off0,
                       off1);
    float dd[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      if (c < nc) {
        float dp[2][4];
        mma_rows(dp, ga, vs, 16 * c);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dd[e >> 1] += p[c][n][e] * dp[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dd[r] = quad_sum(dd[r]);
      if (t == 0) {
        const int row = r0 + gi + 8 * r;
        st_mx[row] = mx[r];
        st_inv[row] = inv[r];
        st_d[row] = dd[r];
      }
    }
    float acc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      if (c < nc) {
        float ds[2][4];
        mma_rows(ds, ga, vs, 16 * c);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ds[n][e] = p[c][n][e] * (ds[n][e] - dd[e >> 1]);
            const int row = r0 + gi + 8 * (e >> 1);
            const int j = 16 * c + 8 * n + 2 * t + (e & 1);
            if (ds_w && row < Tq && j < Tk)
              ds_w[(srow0 + row) * Tk + j] = ds[n][e];
          }
        if constexpr (kOne) {
          uint32_t da[1][4];
          mma_pack(da[0], ds[0], ds[1]);
          mma_cols(acc, da, ks, 16 * c);
        } else {
          uint32_t da[2][4];
          mma_split(da, ds[0], ds[1]);
          mma_cols(acc, da, ks, 16 * c);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + gi + 8 * r;
      if (row >= Tq) continue;
      TO* dst = dq + (wrow * Tq + row) * ldg + n0;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * n + 2 * t + e;
          if (d < hd) dst[d] = from_f32<TO>(acc[n][2 * r + e] * scale);
        }
    }
  }
  __syncthreads();

  // Phase 2: key rows r0 .. r0 + 15 of this warp, the query chunks in
  // order.
  for (int r0 = warp * 16; r0 < tk16; r0 += step) {
    // this lane's keys gi and gi + 8 (past Tk: the last, computed, not
    // stored)
    const int j0 = min(r0 + gi, Tk - 1);
    const int j1 = min(r0 + gi + 8, Tk - 1);
    uint32_t ka[2][4], va[2][4];
    mma_load_a(ka, ks, r0);
    mma_load_a(va, vs, r0);
    float adk[4][4], adv[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
#pragma unroll 1
    for (int c = 0; c < tq16 / 16; ++c) {
      float s[2][4], dp[2][4];
      mma_rows(s, ka, qs, 16 * c);
      mma_rows(dp, va, gs, 16 * c);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * c + 8 * n + 2 * t + (e & 1);
          float pv = 0.f, ds = 0.f;
          if (i < Tq) {
            // the score as phase 1 forms it: scaled, then the bias, then
            // the mask (row i, column j)
            const size_t o = static_cast<size_t>(i) * Tk + (e < 2 ? j0 : j1);
            float x = __fmul_rn(s[n][e], scale);
            if (hb) x = __fadd_rn(x, hb[o]);
            if constexpr (kMask) x = __fadd_rn(x, mb[o]);
            pv = __expf(x - st_mx[i]) * st_inv[i];
            ds = pv * (dp[n][e] - st_d[i]);
          }
          s[n][e] = pv;
          dp[n][e] = ds;
        }
      if constexpr (kOne) {
        uint32_t pa[1][4], da[1][4];
        mma_pack(pa[0], s[0], s[1]);
        mma_pack(da[0], dp[0], dp[1]);
        mma_cols(adv, pa, gs, 16 * c);
        mma_cols(adk, da, qs, 16 * c);
      } else {
        uint32_t pa[2][4], da[2][4];
        mma_split(pa, s[0], s[1]);
        mma_split(da, dp[0], dp[1]);
        mma_cols(adv, pa, gs, 16 * c);
        mma_cols(adk, da, qs, 16 * c);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + gi + 8 * r;
      if (row >= Tk) continue;
      const size_t o = (wrow * Tk + row) * ldg + n0;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * n + 2 * t + e;
          if (d < hd) {
            dv[o + d] = from_f32<TO>(adv[n][2 * r + e]);
            dk[o + d] = from_f32<TO>(adk[n][2 * r + e] * scale);
          }
        }
    }
  }
}

// The kernel of a flag pair for windows of at most t tokens (max(Tq, Tk)):
// its kNC bucket, which bounds its threads (32 kNC) and sizes the register
// array of a query row's scores.
template <bool kMask, bool kHM, typename TO = __nv_bfloat16>
inline auto short_bwd_kernel(int t) {
  const int nc = short_chunks(t);
  return nc == 4 ? window_attn_bwd_short_mma_kernel<kMask, kHM, 4, TO>
         : nc == 9 ? window_attn_bwd_short_mma_kernel<kMask, kHM, 9, TO>
                   : window_attn_bwd_short_mma_kernel<kMask, kHM, 10, TO>;
}

}  // namespace gsasr

namespace {

// The launches of WB-bf16, or with kMask WMB-bf16 (mask (nW, Tq, Tk), B a
// multiple of nW), or with kHM WB4-bf16 on the head-major layout, at Tq, Tk
// <= kMaxT: the body, then (dbias given) the ordered sum of ds_w over the
// windows. ds_w (B, nh, Tq, Tk) f32 is needed, and written, only with
// dbias. TO = float: kernel AB-bf16's form of the body.
template <bool kMask, bool kHM, typename TO = __nv_bfloat16>
cudaError_t launch_bwd_short_mma(const __nv_bfloat16* q,
                                 const __nv_bfloat16* k,
                                 const __nv_bfloat16* v, const float* bias,
                                 const __nv_bfloat16* g, TO* dq, TO* dk,
                                 TO* dv,
                                 float* ds_w, float* dbias, int B, int Tq,
                                 int Tk, int C, int nh, float scale,
                                 cudaStream_t st, const float* mask = nullptr,
                                 int nW = 1) {
  if (!gsasr::short_shape_ok(B, Tq, Tk, C, nh, nW) || (dbias && !ds_w) ||
      (kMask && !mask))
    return cudaErrorInvalidValue;
  const void* ops[] = {q, k, v, g};
  const int vec = gsasr::mma_vec(C / nh, ops, 4);
  const size_t smem = gsasr::short_bwd_smem_bytes(Tq, Tk);
  const auto kernel =
      gsasr::short_bwd_kernel<kMask, kHM, TO>(Tq > Tk ? Tq : Tk);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int threads =
      2 * (Tq > Tk ? gsasr::short_rows(Tq) : gsasr::short_rows(Tk));
  err = gsasr::for_window_chunks(B, nW, [&](int w0, int nb, int c0) {
    const size_t oq = gsasr::window_offset(w0, Tq, C);
    const size_t ok = gsasr::window_offset(w0, Tk, C);
    kernel<<<dim3(nh, nb), threads, smem, st>>>(
        q + oq, k + ok, v + ok, bias, g + oq, dq + oq, dk + ok, dv + ok,
        dbias ? ds_w + gsasr::window_offset(w0, nh * Tq, Tk) : nullptr, Tq,
        Tk, C, nh, scale, gsasr::window_mask_from(mask, c0, Tq, Tk), nW,
        vec);
  });
  if (err != cudaSuccess || !dbias) return err;
  const int n = nh * Tq * Tk;
  dbias_sum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      ds_w, dbias, B, n);
  return cudaGetLastError();
}

}  // namespace
