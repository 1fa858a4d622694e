// The bf16 window-16 attention backward on Hopper's tensor cores: the body
// of WB-long-bf16 (window_attn_bwd_long_bf16), with its template flags
// WMB-long-bf16 (kMask) and WB4-long-bf16 (kHM). It replaces the bf16
// operand forms of _attn_kernel_packed_bwd (gsasr_tpu/ops/attention.py,
// Pallas K12 at window 16: HAT-L Ultra's 256 x 256 windows and OCAB's 256 x
// 576), of _attn_kernel_packed_masked_bwd (K13b, the paper HAT's shifted
// windows) and of _attn_kernel_bwd (K14b, the 4D layout) beyond 160 tokens.
// The fp32 forms run window_attn_long_tf32_bwd.cuh, the same design in
// 3xTF32, and AB-long keeps window_attn_long_bwd.cuh's FMA body. Per
// window w and head h, with the softmax recomputed as the forward forms it:
//
//   p = softmax(q_h k_h^T * scale (+ bias[h]) (+ mask[w % nW]))   (f32)
//   dv = p^T g_h      dp = g_h v_h^T      ds = p (dp - D),  D = sum_j p dp
//   dq = ds k_h * scale                   dk = ds^T q_h * scale
//
// Bound on an H100: at the Ultra step's 128 windows x 6 heads x 256 x 256 x
// 32 the function's five products are 16.1 GFLOP (16 us at 989 TFLOP/s)
// against 88 MB of bf16 q, k, v, g, dq, dk, dv (26 us at 3.35 TB/s): bound
// by bytes. This body forms 13 such products (the scores three times in
// launch 1 and once in launch 2, dp twice and once, and dq, dk, dv each
// twice as hi/lo pairs, below), 42 GFLOP, 42 us at the peak, and 4 x 50 M
// exponentials, about 48 us on the MUFU.
//
// Precision. As in the Pallas body and the plain version, p and ds are f32
// and never rounded. q, k, v and g are exact in bf16, so s = q k^T and dp
// = g v^T are single bf16 mma.sync products. Each f32 operand (p for dv, ds
// for dq and dk) goes in as a pair, hi = bf16(x), lo = bf16(x - hi), two
// products into one f32 sum: x = hi + lo to 2^-16 of |x|. Against a
// float64 reference on random bf16 operands (64 windows of 256 x 576 at hd
// 32) one bf16 rounding of p and ds left dq 3.2e-3 of max|dq| off, at the
// 2^-8 term of the bf16 tolerance itself; the pair leaves 4.5e-6.
//
// Design. Two launches, each owning its outputs, every sum in one fixed
// order and no float atomics, so two launches give the same bits:
//
// 1. A block of four warps per (head, window, 64 query rows), 16 rows a
//    warp, with its q and g rows in shared memory, walks the key tiles of
//    64 three times in one loop over a cp.async double buffer (k tiles,
//    then k and v tiles): the rows' max and sum of exponentials as the
//    forward's pass 1 forms them; D = sum_j p dp in key order (each lane
//    its own columns, joined across the quad at the end); then ds = p (dp
//    - D) and dq += ds k, with k's B fragments by ldmatrix.trans. The rows'
//    (max, sum, D) go to stats (B, nh, Tq, 3), and with a bias ds to ds_w
//    (B, nh, Tq, Tk) for dbias, the ordered sum over the windows.
// 2. A block of four warps per (head, window, 64 keys), 16 keys a warp,
//    with its k and v rows in shared memory, walks the query tiles of 64 in
//    order (q, g and their stats double-buffered) and forms the transposed
//    scores s^T = k q^T and dp^T = v g^T directly, with k and v as the A
//    operand: p^T and ds^T then sit in the accumulator layout, which is
//    the A layout of dv += p^T g and dk += ds^T q (q's and g's B fragments
//    by ldmatrix.trans), so neither passes through shared memory.
//
// mma.sync m16n8k16 throughout, as in the forward (window_attn_long_mma.cuh,
// whose staging, fragments and score fix-up this shares): a warp owns 16
// rows, its softmax and its accumulators, and the work is bound by bytes
// and exponentials, not by the tensor cores. Shapes as the forward's.
//
// ptxas (sm_90a): launch 1 126 registers (128 with the mask or the
// head-major flag), launch 2 125 (128), no spills, 30.7 and 32.3 KB of
// static shared memory: four blocks of 128 threads an SM. Launch 1 takes
// its first sweep in halves of 32 keys and both launches keep their
// 16-row chunk loops rolled; unrolled, or with whole 64-key tiles, ptxas
// spilled 4 to 52 bytes at the 128-register cap, and a cap of 168 (three
// blocks an SM) ran 5-14% longer.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mma_ptx.cuh"
#include "window_attn_bwd.cuh"
#include "window_attn_long_mma.cuh"

namespace gsasr {

// The hi and lo A fragments of 16 f32 columns (accumulator tiles x0, x1):
// hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void mma_split(uint32_t (&a)[2][4],
                                          const float (&x0)[4],
                                          const float (&x1)[4]) {
  float r[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* x = i < 2 ? x0 : x1;
    r[i][0] = x[2 * (i & 1)];
    r[i][1] = x[2 * (i & 1) + 1];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float h0 = __bfloat162float(__float2bfloat16_rn(r[i][0]));
    const float h1 = __bfloat162float(__float2bfloat16_rn(r[i][1]));
    a[0][i] = pack_bf16(h0, h1);
    a[1][i] = pack_bf16(r[i][0] - h0, r[i][1] - h1);
  }
}

// Launch 1, one block of kMThreads per (head, window, 64 query rows): dq
// (bf16), each row's (max, sum, D) into stats, and ds into ds_w when it is
// not null. Layouts and flags as the forward's.
template <bool kMask, bool kHM>
__global__ void __launch_bounds__(kMThreads, 4)
window_attn_bwd_long_mma_q_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v,
                                  const float* __restrict__ bias,
                                  const __nv_bfloat16* __restrict__ g,
                                  __nv_bfloat16* __restrict__ dq,
                                  float* __restrict__ stats,
                                  float* __restrict__ ds_w, int Tq, int Tk,
                                  int C, int nh, float scale,
                                  const float* __restrict__ mask, int nW,
                                  int vec) {
  __shared__ __align__(16) __nv_bfloat16 qs[kMRows * kMLd];
  __shared__ __align__(16) __nv_bfloat16 gs[kMRows * kMLd];
  __shared__ __align__(16) __nv_bfloat16 ks[2][kMTile * kMLd];
  __shared__ __align__(16) __nv_bfloat16 vs[2][kMTile * kMLd];
  const int hd = C / nh;
  const int head = blockIdx.x;
  const int win = blockIdx.y;
  const int q0 = blockIdx.z * kMRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gi = lane >> 2;
  const int t = lane & 3;
  const int n0 = kHM ? 0 : head * hd;
  const int ldg = kHM ? hd : C;
  const size_t wrow = kHM ? static_cast<size_t>(win) * nh + head : win;
  const int rows = min(kMRows, Tq - q0);
  const int r0 = warp * 16;
  const float* hb =
      bias ? bias + static_cast<size_t>(head) * Tq * Tk : nullptr;
  const float* mb = kMask ? long_window_mask(mask, win, nW, Tq, Tk) : nullptr;
  const size_t off0 = static_cast<size_t>(min(q0 + r0 + gi, Tq - 1)) * Tk;
  const size_t off1 = static_cast<size_t>(min(q0 + r0 + gi + 8, Tq - 1)) * Tk;
  // this lane's rows in stats and ds_w
  const size_t srow = (static_cast<size_t>(win) * nh + head) * Tq + q0 + r0 +
                      gi;
  const int nk = (Tk + kMTile - 1) / kMTile;

  mma_stage<kMRows>(qs, q, wrow * Tq + q0, rows, ldg, n0, hd, vec);
  mma_stage<kMRows>(gs, g, wrow * Tq + q0, rows, ldg, n0, hd, vec);
  mma_stage<kMTile>(ks[0], k, wrow * Tk, min(kMTile, Tk), ldg, n0, hd, vec);
  cp_async_commit();

  uint32_t qa[2][4], ga[2][4];
  float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f}, inv[2];
  float dd[2] = {0.f, 0.f};
  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // sweep 0 (steps 0 .. nk - 1): the rows' max and sum on k tiles; sweep 1:
  // D on k and v tiles; sweep 2: ds and dq. The next step's tiles load
  // while this one runs.
  for (int it = 0; it < 3 * nk; ++it) {
    const int nx = it + 1;
    if (nx < 3 * nk) {
      const int k0 = (nx % nk) * kMTile;
      const int kb = min(kMTile, Tk - k0);
      mma_stage<kMTile>(ks[nx & 1], k, wrow * Tk + k0, kb, ldg, n0, hd, vec);
      if (nx >= nk)
        mma_stage<kMTile>(vs[nx & 1], v, wrow * Tk + k0, kb, ldg, n0, hd,
                          vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
      mma_load_a(qa, qs, r0);
      mma_load_a(ga, gs, r0);
    }
    const int sweep = it / nk;
    const int k0 = (it % nk) * kMTile;
    const __nv_bfloat16* kt = ks[it & 1];
    const __nv_bfloat16* vt = vs[it & 1];
    if (sweep == 0) {
      // in halves of 32 keys: with dq's sums live, a whole tile's scores
      // would spill
#pragma unroll
      for (int h = 0; h < kMTile; h += 32) {
        float s[4][4];
        mma_rows(s, qa, kt, h);
        mma_fix<kMask>(s, k0 + h, Tk, scale, hb, mb, off0, off1);
        mma_online(s, mx, sm);
      }
    } else {
      if (it == nk) {
        mma_row_stats(mx, sm);
        inv[0] = 1.f / sm[0];
        inv[1] = 1.f / sm[1];
      }
      if (it == 2 * nk) {
        // D over the quad, in a butterfly; the rows' statistics out
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dd[r] += __shfl_xor_sync(0xffffffffu, dd[r], 1);
          dd[r] += __shfl_xor_sync(0xffffffffu, dd[r], 2);
          if (t == 0 && r0 + gi + 8 * r < rows) {
            float* st = stats + (srow + 8 * r) * 3;
            st[0] = mx[r];
            st[1] = sm[r];
            st[2] = dd[r];
          }
        }
      }
#pragma unroll 1
      for (int c = 0; c < kMTile / 16; ++c) {
        float s[2][4], dp[2][4];
        mma_rows(s, qa, kt, 16 * c);
        mma_fix<kMask>(s, k0 + 16 * c, Tk, scale, hb, mb, off0, off1);
        mma_rows(dp, ga, vt, 16 * c);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = __expf(s[n][e] - mx[e >> 1]) * inv[e >> 1];
            if (sweep == 1)
              dd[e >> 1] += p * dp[n][e];
            else
              s[n][e] = p * (dp[n][e] - dd[e >> 1]);
          }
        if (sweep == 2) {
          if (ds_w) {
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int j = k0 + 16 * c + 8 * n + 2 * t + (e & 1);
                if (j < Tk && r0 + gi + 8 * (e >> 1) < rows)
                  ds_w[(srow + 8 * (e >> 1)) * Tk + j] = s[n][e];
              }
          }
          uint32_t da[2][4];
          mma_split(da, s[0], s[1]);
          mma_cols(acc, da, kt, 16 * c);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + gi + 8 * r;
    if (row >= rows) continue;
    __nv_bfloat16* dst = dq + (wrow * Tq + q0 + row) * ldg + n0;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * t + e;
        if (d < hd) dst[d] = __float2bfloat16_rn(acc[n][2 * r + e] * scale);
      }
  }
}

// Launch 2, one block of kMThreads per (head, window, 64 keys): dk and dv
// (bf16) of its keys, the query tiles walked in order with the statistics
// launch 1 stored.
template <bool kMask, bool kHM>
__global__ void __launch_bounds__(kMThreads, 4)
window_attn_bwd_long_mma_kv_kernel(const __nv_bfloat16* __restrict__ q,
                                   const __nv_bfloat16* __restrict__ k,
                                   const __nv_bfloat16* __restrict__ v,
                                   const float* __restrict__ bias,
                                   const __nv_bfloat16* __restrict__ g,
                                   __nv_bfloat16* __restrict__ dk,
                                   __nv_bfloat16* __restrict__ dv,
                                   const float* __restrict__ stats, int Tq,
                                   int Tk, int C, int nh, float scale,
                                   const float* __restrict__ mask, int nW,
                                   int vec) {
  __shared__ __align__(16) __nv_bfloat16 ks[kMRows * kMLd];
  __shared__ __align__(16) __nv_bfloat16 vs[kMRows * kMLd];
  __shared__ __align__(16) __nv_bfloat16 qs[2][kMTile * kMLd];
  __shared__ __align__(16) __nv_bfloat16 gs[2][kMTile * kMLd];
  // each query's max, 1 / sum and D
  __shared__ float sts[2][3][kMTile];
  const int hd = C / nh;
  const int head = blockIdx.x;
  const int win = blockIdx.y;
  const int k0 = blockIdx.z * kMRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gi = lane >> 2;
  const int t = lane & 3;
  const int n0 = kHM ? 0 : head * hd;
  const int ldg = kHM ? hd : C;
  const size_t wrow = kHM ? static_cast<size_t>(win) * nh + head : win;
  const int kb = min(kMRows, Tk - k0);
  const int r0 = warp * 16;
  const float* hb =
      bias ? bias + static_cast<size_t>(head) * Tq * Tk : nullptr;
  const float* mb = kMask ? long_window_mask(mask, win, nW, Tq, Tk) : nullptr;
  const size_t srow0 = (static_cast<size_t>(win) * nh + head) * Tq;
  // this lane's keys g and g + 8 (past Tk: the last, computed, not stored)
  const int j0 = min(k0 + r0 + gi, Tk - 1);
  const int j1 = min(k0 + r0 + gi + 8, Tk - 1);
  const int nq = (Tq + kMTile - 1) / kMTile;

  auto stage_q = [&](int i, int b) {
    const int i0 = i * kMTile;
    const int ib = min(kMTile, Tq - i0);
    mma_stage<kMTile>(qs[b], q, wrow * Tq + i0, ib, ldg, n0, hd, vec);
    mma_stage<kMTile>(gs[b], g, wrow * Tq + i0, ib, ldg, n0, hd, vec);
    for (int e = threadIdx.x; e < kMTile; e += kMThreads) {
      const float* st = stats + (srow0 + min(i0 + e, Tq - 1)) * 3;
      sts[b][0][e] = st[0];
      sts[b][1][e] = 1.f / st[1];
      sts[b][2][e] = st[2];
    }
  };
  mma_stage<kMRows>(ks, k, wrow * Tk + k0, kb, ldg, n0, hd, vec);
  mma_stage<kMRows>(vs, v, wrow * Tk + k0, kb, ldg, n0, hd, vec);
  stage_q(0, 0);
  cp_async_commit();

  uint32_t ka[2][4], va[2][4];
  float adk[4][4], adv[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
  for (int it = 0; it < nq; ++it) {
    if (it + 1 < nq) stage_q(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
      mma_load_a(ka, ks, r0);
      mma_load_a(va, vs, r0);
    }
    const int b = it & 1;
    const int i0 = it * kMTile;
#pragma unroll 1
    for (int c = 0; c < kMTile / 16; ++c) {
      float s[2][4], dp[2][4];
      mma_rows(s, ka, qs[b], 16 * c);
      mma_rows(dp, va, gs[b], 16 * c);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = 16 * c + 8 * n + 2 * t + (e & 1);
          const int i = i0 + il;
          float p = 0.f, ds = 0.f;
          if (i < Tq) {
            // the score as launch 1 forms it: scaled, then the bias, then
            // the mask (row i, column j)
            const size_t o = static_cast<size_t>(i) * Tk + (e < 2 ? j0 : j1);
            float x = __fmul_rn(s[n][e], scale);
            if (hb) x = __fadd_rn(x, hb[o]);
            if constexpr (kMask) x = __fadd_rn(x, mb[o]);
            p = __expf(x - sts[b][0][il]) * sts[b][1][il];
            ds = p * (dp[n][e] - sts[b][2][il]);
          }
          s[n][e] = p;
          dp[n][e] = ds;
        }
      uint32_t pa[2][4], da[2][4];
      mma_split(pa, s[0], s[1]);
      mma_split(da, dp[0], dp[1]);
      mma_cols(adv, pa, gs[b], 16 * c);
      mma_cols(adk, da, qs[b], 16 * c);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + gi + 8 * r;
    if (row >= kb) continue;
    const size_t o = (wrow * Tk + k0 + row) * ldg + n0;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * t + e;
        if (d < hd) {
          dv[o + d] = __float2bfloat16_rn(adv[n][2 * r + e]);
          dk[o + d] = __float2bfloat16_rn(adk[n][2 * r + e] * scale);
        }
      }
  }
}

}  // namespace gsasr

namespace {

// The launches of WB-long-bf16, or with kMask WMB-long-bf16 (mask (nW, Tq,
// Tk), B a multiple of nW), or with kHM WB4-long-bf16 on the head-major
// layout: dq and the rows' statistics per query tile, then dk and dv per
// key tile, then (dbias given) the ordered sum of ds_w over the windows.
// Arguments as launch_window_attn_bwd_long's.
template <bool kMask, bool kHM>
cudaError_t launch_window_attn_bwd_long_mma(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const float* bias, const __nv_bfloat16* g, __nv_bfloat16* dq,
    __nv_bfloat16* dk, __nv_bfloat16* dv, float* stats, float* ds_w,
    float* dbias, int B, int Tq, int Tk, int C, int nh, float scale,
    cudaStream_t st, const float* mask = nullptr, int nW = 1) {
  if (!gsasr::long_shape_ok(B, Tq, Tk, C, nh) || (dbias && !ds_w) ||
      nW < 1 || B % nW != 0 || (kMask && !mask))
    return cudaErrorInvalidValue;
  const void* ops[] = {q, k, v, g};
  const int vec = gsasr::mma_vec(C / nh, ops, 4);
  constexpr int kR = gsasr::kMRows;
  gsasr::window_attn_bwd_long_mma_q_kernel<kMask, kHM>
      <<<dim3(nh, B, (Tq + kR - 1) / kR), gsasr::kMThreads, 0, st>>>(
          q, k, v, bias, g, dq, stats, dbias ? ds_w : nullptr, Tq, Tk, C, nh,
          scale, mask, nW, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gsasr::window_attn_bwd_long_mma_kv_kernel<kMask, kHM>
      <<<dim3(nh, B, (Tk + kR - 1) / kR), gsasr::kMThreads, 0, st>>>(
          q, k, v, bias, g, dk, dv, stats, Tq, Tk, C, nh, scale, mask, nW,
          vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || !dbias) return err;
  const int n = nh * Tq * Tk;
  dbias_sum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      ds_w, dbias, B, n);
  return cudaGetLastError();
}

}  // namespace
