// The fp32 window attention backward up to 160 tokens on Hopper's tensor
// cores in 3xTF32: the body of WB (window_attn_bwd), with its template
// flags WMB (kMask) and WB4 (kHM). It replaces the fp32 forms of
// _attn_kernel_packed_bwd (gsasr_tpu/ops/attention.py, Pallas K12: the
// paper decoder's 144-token windows, SwinIR's 64), of
// _attn_kernel_packed_masked_bwd (K13b, SwinIR's shifted windows) and of
// _attn_kernel_bwd (K14b, the 4D layout) at Tq, Tk <= 160, and it is
// kernel AB's fp32 attention (ln_attn_bwd.cu). The bf16 forms run
// window_attn_short_mma_bwd.cuh, and beyond 160 tokens WB-long's two
// launches (window_attn_long_tf32_bwd.cuh) run. Per window w and head h, with the
// softmax recomputed as the forward forms it:
//
//   p = softmax(q_h k_h^T * scale (+ bias[h]) (+ mask[w % nW]))   (f32)
//   dv = p^T g_h      dp = g_h v_h^T      ds = p (dp - D),  D = sum_j p dp
//   dq = ds k_h * scale                   dk = ds^T q_h * scale
//   dbias[h] = sum over the windows of ds
//
// Bound on an H100: at the paper step's 256 windows x 6 heads x 144 x 144
// x 30 the five products are 9.6 GFLOP, three TF32 products each in
// 3xTF32: 28.7 GFLOP, 0.058 ms at 495 TFLOP/s, against 187 MB of q, k, v,
// g, dq, dk, dv, bias and dbias (0.056 ms at 3.35 TB/s).
//
// Precision and arithmetic: WB-long's (3xTF32 products in the permuted
// slots of tf32_frag.cuh, p and ds f32 and rounded nowhere), in the same
// order, so the two bodies give the same bits on the same operands.
//
// Design: WB-long's two launches fused into one block per (head, window),
// as the bf16 body up to 160 tokens (window_attn_short_mma_bwd.cuh) does.
// The block stages q, g, k and v once, f32 at the stride of 36 floats
// (rows padded with zeros to a multiple of 16), and the head's bias rows
// and the window class's mask rows (f32, at a row stride of 4 mod 32
// floats), all in dynamic shared memory, with one warp per 16 rows of the
// longer side, in two phases split by a __syncthreads:
//
// 1. Query rows, 16 a warp, q and g as tf32 pairs in registers: one sweep
//    over the keys in 16-key chunks for each row's max, sum of
//    exponentials and D = sum_j p dp (each lane its own columns, rescaled
//    online when the max grows, joined over the quad in a butterfly),
//    kept in shared memory; a second sweep forms ds = p (dp - D) and dq +=
//    ds k (the accumulator tile is the A fragment as it stands); with a
//    bias, ds also goes to ds_w (B, nh, Tq, Tk) for dbias.
// 2. Key rows, 16 a warp, k and v as pairs: the transposed scores s^T = k
//    q^T and dp^T = v g^T in steps of 8 queries, p^T from the rows'
//    statistics and ds^T, which feed dv += p^T g and dk += ds^T q from
//    registers.
//
// Against WB-long's launches at these lengths the block reads each operand
// once, keeps the statistics on the chip, reads the bias and mask from
// shared memory, and wastes no rows on a 64-row tile (at 144 tokens the
// third tile holds 16). Where the bias and mask rows do not fit (a mask
// with more than about 120 tokens), the launcher runs WB-long's launches.
// Each output is owned by one block and every sum runs in one fixed order,
// no float atomics: two launches give the same bits. dbias is
// window_attn_bwd.cuh's ordered sum of ds_w over the windows.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tf32_frag.cuh"
#include "window_attn_bwd.cuh"
#include "window_attn_long_tf32_bwd.cuh"

namespace gsasr {

// Floats of the short body's dynamic shared memory: q, g (Tq rows), k, v
// (Tk rows) at kTLd, padded to 16 rows; the bias and mask rows (those
// given) at ldb; each query row's max, 1 / sum and D.
struct ShortTf32Layout {
  int tq16, tk16, ldb;
  size_t bias, mask, stats, floats;
  __host__ __device__ ShortTf32Layout(int Tq, int Tk, bool has_bias,
                                      bool has_mask)
      : tq16((Tq + 15) / 16 * 16),
        tk16((Tk + 15) / 16 * 16),
        ldb((Tk + 31) / 32 * 32 + 4) {
    bias = static_cast<size_t>(2 * tq16 + 2 * tk16) * kTLd;
    mask = bias + (has_bias ? static_cast<size_t>(Tq) * ldb : 0);
    stats = mask + (has_mask ? static_cast<size_t>(Tq) * ldb : 0);
    floats = stats + 3 * static_cast<size_t>(tq16);
  }
};

// rows x cols floats (rows cols apart) into shared rows ld apart, by a
// block of nthr threads: cp.async copies of 4 floats where cols and src
// allow, else of 1, which the caller commits and waits for.
__device__ __forceinline__ void short_stage_rows(float* dst, int ld,
                                                 const float* __restrict__ src,
                                                 int rows, int cols, int nthr) {
  if (cols % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int per = cols / 4;
    for (int e = threadIdx.x; e < rows * per; e += nthr) {
      const int r = e / per;
      const int c = (e - r * per) * 4;
      cp_async16(dst + r * ld + c, src + static_cast<size_t>(r) * cols + c,
                 16);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += nthr) {
      const int r = e / cols;
      const int c = e - r * cols;
      cp_async4(dst + r * ld + c, src + e, 4);
    }
  }
}

// The backward, one block of 32 max(tq16, tk16) / 16 threads per (head,
// window): dq, dk, dv in the operands' layout, and ds into ds_w when it is
// not null. Layouts and flags as WB-long's; kBig for more than four warps
// (one block an SM), else three blocks of at most four warps an SM.
template <bool kMask, bool kHM, bool kBig>
__global__ void __launch_bounds__(kBig ? 32 * kMaxT / 16 : kMThreads,
                                  kBig ? 1 : 3)
window_attn_bwd_short_tf32_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  const float* __restrict__ bias,
                                  const float* __restrict__ g,
                                  float* __restrict__ dq,
                                  float* __restrict__ dk,
                                  float* __restrict__ dv,
                                  float* __restrict__ ds_w, int Tq, int Tk,
                                  int C, int nh, float scale,
                                  const float* __restrict__ mask, int nW,
                                  int vec) {
  extern __shared__ __align__(16) float short_tf32_smem[];
  const ShortTf32Layout L(Tq, Tk, bias != nullptr, kMask);
  float* qs = short_tf32_smem;
  float* gs = qs + L.tq16 * kTLd;
  float* ks = gs + L.tq16 * kTLd;
  float* vs = ks + L.tk16 * kTLd;
  float* bs = bias ? short_tf32_smem + L.bias : nullptr;
  float* ms = kMask ? short_tf32_smem + L.mask : nullptr;
  float* st_mx = short_tf32_smem + L.stats;
  float* st_inv = st_mx + L.tq16;
  float* st_d = st_inv + L.tq16;
  const int nthr = blockDim.x;
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
  const int r0 = warp * 16;

  tf32_stage(qs, q, wrow * Tq, Tq, L.tq16, ldg, n0, hd, vec, nthr);
  tf32_stage(gs, g, wrow * Tq, Tq, L.tq16, ldg, n0, hd, vec, nthr);
  tf32_stage(ks, k, wrow * Tk, Tk, L.tk16, ldg, n0, hd, vec, nthr);
  tf32_stage(vs, v, wrow * Tk, Tk, L.tk16, ldg, n0, hd, vec, nthr);
  if (bias)
    short_stage_rows(bs, L.ldb, bias + static_cast<size_t>(head) * Tq * Tk,
                     Tq, Tk, nthr);
  if constexpr (kMask)
    short_stage_rows(ms, L.ldb, long_window_mask(mask, win, nW, Tq, Tk), Tq,
                     Tk, nthr);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 1. query rows r0 .. r0 + 15: the rows' statistics, ds and dq
  if (r0 < Tq) {
    uint32_t qb[4][4], qsm[4][4], gb[4][4], gsm[4][4];
    tf32_load_a(qb, qsm, qs, r0);
    tf32_load_a(gb, gsm, gs, r0);
    // this lane's rows g and g + 8 in the bias and mask (past Tq: the last)
    const size_t off0 = static_cast<size_t>(min(r0 + gi, Tq - 1)) * L.ldb;
    const size_t off1 = static_cast<size_t>(min(r0 + gi + 8, Tq - 1)) * L.ldb;
    // this lane's rows in ds_w
    const size_t srow =
        (static_cast<size_t>(win) * nh + head) * Tq + r0 + gi;
    const int nc = (Tk + 15) / 16;
    float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f};
    float dd[2] = {0.f, 0.f}, inv[2];
    // each lane's running max of its columns, with the sum of exponentials
    // and D rescaled when it grows
#pragma unroll 1
    for (int c = 0; c < nc; ++c) {
      float s[2][4], dp[2][4];
      tf32_rows(s, qb, qsm, ks, 16 * c);
      mma_fix<kMask>(s, 16 * c, Tk, scale, bs, ms, off0, off1);
      tf32_rows(dp, gb, gsm, vs, 16 * c);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m = mx[r];
#pragma unroll
        for (int n = 0; n < 2; ++n)
          m = fmaxf(m, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        const float base = m == -INFINITY ? 0.f : m;
        const float f = __expf(mx[r] - base);
        float a = sm[r] * f, d = dd[r] * f;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = __expf(s[n][2 * r + e] - base);
            a += p;
            d += p * dp[n][2 * r + e];
          }
        sm[r] = a;
        dd[r] = d;
        mx[r] = m;
      }
    }
    // the rows' max, sum and D over the quad, in a butterfly
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = mx[r];
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const float f = mx[r] == -INFINITY ? 0.f : __expf(mx[r] - m);
      float l = sm[r] * f, d = dd[r] * f;
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      mx[r] = m;
      inv[r] = 1.f / l;
      dd[r] = d * inv[r];
      const int row = r0 + gi + 8 * r;
      if (t == 0 && row < Tq) {
        st_mx[row] = mx[r];
        st_inv[row] = inv[r];
        st_d[row] = dd[r];
      }
    }
    float acc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll 1
    for (int c = 0; c < nc; ++c) {
      float s[2][4], dp[2][4];
      tf32_rows(s, qb, qsm, ks, 16 * c);
      mma_fix<kMask>(s, 16 * c, Tk, scale, bs, ms, off0, off1);
      tf32_rows(dp, gb, gsm, vs, 16 * c);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = __expf(s[n][e] - mx[e >> 1]) * inv[e >> 1];
          s[n][e] = p * (dp[n][e] - dd[e >> 1]);
        }
      if (ds_w) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 16 * c + 8 * n + 2 * t + (e & 1);
            if (j < Tk && r0 + gi + 8 * (e >> 1) < Tq)
              ds_w[(srow + 8 * (e >> 1)) * Tk + j] = s[n][e];
          }
      }
      tf32_cols(acc, s[0], ks, 16 * c);
      tf32_cols(acc, s[1], ks, 16 * c + 8);
    }
    tf32_store(dq + n0, acc, wrow * Tq, r0, Tq, ldg, hd, scale, vec);
  }
  __syncthreads();

  // 2. keys r0 .. r0 + 15: dk and dv, the queries in steps of 8
  if (r0 < Tk) {
    uint32_t kbg[4][4], ksm[4][4], vbg[4][4], vsm[4][4];
    tf32_load_a(kbg, ksm, ks, r0);
    tf32_load_a(vbg, vsm, vs, r0);
    // this lane's keys g and g + 8 (past Tk: the last, computed, not
    // stored)
    const int j0 = min(r0 + gi, Tk - 1);
    const int j1 = min(r0 + gi + 8, Tk - 1);
    float adk[4][4], adv[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
    const int nq = (Tq + 7) / 8;
#pragma unroll 1
    for (int c = 0; c < nq; ++c) {
      float s[1][4], dp[1][4];
      tf32_rows(s, kbg, ksm, qs, 8 * c);
      tf32_rows(dp, vbg, vsm, gs, 8 * c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * c + 2 * t + (e & 1);
        float p = 0.f, ds = 0.f;
        if (i < Tq) {
          // the score as phase 1 forms it: scaled, then the bias, then the
          // mask (row i, column j)
          const size_t o = static_cast<size_t>(i) * L.ldb + (e < 2 ? j0 : j1);
          float x = __fmul_rn(s[0][e], scale);
          if (bs) x = __fadd_rn(x, bs[o]);
          if constexpr (kMask) x = __fadd_rn(x, ms[o]);
          p = __expf(x - st_mx[i]) * st_inv[i];
          ds = p * (dp[0][e] - st_d[i]);
        }
        s[0][e] = p;
        dp[0][e] = ds;
      }
      tf32_cols(adv, s[0], gs, 8 * c);
      tf32_cols(adk, dp[0], qs, 8 * c);
    }
    tf32_store(dv + n0, adv, wrow * Tk, r0, Tk, ldg, hd, 1.f, vec);
    tf32_store(dk + n0, adk, wrow * Tk, r0, Tk, ldg, hd, scale, vec);
  }
}

}  // namespace gsasr

namespace {

// The short body's kernel of a flag pair: three blocks of up to four warps
// an SM, or one of up to ten.
template <bool kMask, bool kHM>
constexpr auto short_tf32_bwd_kernel(bool big) {
  return big ? gsasr::window_attn_bwd_short_tf32_kernel<kMask, kHM, true>
             : gsasr::window_attn_bwd_short_tf32_kernel<kMask, kHM, false>;
}

// WB, or with kMask WMB (mask (nW, Tq, Tk), B a multiple of nW), or with
// kHM WB4 on the head-major layout, at Tq, Tk <= kMaxT: the short body, then
// (dbias given) the ordered sum of ds_w over the windows; where its shared
// memory would not fit, WB-long's launches. Arguments as WB-long's: q, g,
// dq (B, Tq, C); k, v, dk, dv (B, Tk, C); bias (nh, Tq, Tk) or null; stats
// (B, nh, Tq, 3) scratch, used by WB-long's launches only; ds_w (B, nh,
// Tq, Tk) scratch with dbias; all f32.
template <bool kMask, bool kHM>
cudaError_t launch_window_attn_bwd_short_tf32(
    const float* q, const float* k, const float* v, const float* bias,
    const float* g, float* dq, float* dk, float* dv, float* stats,
    float* ds_w, float* dbias, int B, int Tq, int Tk, int C, int nh,
    float scale, cudaStream_t st, const float* mask = nullptr, int nW = 1) {
  if (!gsasr::long_shape_ok(B, Tq, Tk, C, nh) || Tq > kMaxT || Tk > kMaxT ||
      (dbias && !ds_w) || nW < 1 || B % nW != 0 || (kMask && !mask))
    return cudaErrorInvalidValue;
  const gsasr::ShortTf32Layout L(Tq, Tk, bias != nullptr, kMask);
  const size_t smem = sizeof(float) * L.floats;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(optin))
    return launch_window_attn_bwd_long_tf32<kMask, kHM>(
        q, k, v, bias, g, dq, dk, dv, stats, ds_w, dbias, B, Tq, Tk, C, nh,
        scale, st, mask, nW);
  const void* ops[] = {q, k, v, g, dq, dk, dv};
  const int vec = gsasr::tf32_vec(C / nh, ops, 7);
  const int warps = (L.tq16 > L.tk16 ? L.tq16 : L.tk16) / 16;
  const auto kernel = short_tf32_bwd_kernel<kMask, kHM>(warps > 4);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = gsasr::for_window_chunks(B, nW, [&](int w0, int nb, int c0) {
    const size_t oq = gsasr::window_offset(w0, Tq, C);
    const size_t ok = gsasr::window_offset(w0, Tk, C);
    kernel<<<dim3(nh, nb), 32 * warps, smem, st>>>(
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
