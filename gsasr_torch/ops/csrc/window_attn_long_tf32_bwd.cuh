// The fp32 window-16 attention backward on Hopper's tensor cores in 3xTF32:
// the body of WB-long (window_attn_bwd_long), with its template flags
// WMB-long (kMask) and WB4-long (kHM). It replaces the fp32 forms of
// _attn_kernel_packed_bwd (gsasr_tpu/ops/attention.py, Pallas K12 at window
// 16: HAT-L Ultra's 256 x 256 windows and OCAB's 256 x 576 at model_dtype
// float32), of _attn_kernel_packed_masked_bwd (K13b, the paper HAT's shifted
// windows) and of _attn_kernel_bwd (K14b, the 4D layout) beyond 160 tokens.
// Up to 160 tokens WB, WMB and WB4 run the same arithmetic fused into one
// launch (window_attn_short_tf32_bwd.cuh), and these launches only where
// its shared memory would not fit. The bf16 forms run
// window_attn_long_mma_bwd.cuh; AB-long's fp32 attention runs these
// launches. Per window w and head h, with the softmax recomputed as the
// forward forms it:
//
//   p = softmax(q_h k_h^T * scale (+ bias[h]) (+ mask[w % nW]))   (f32)
//   dv = p^T g_h      dp = g_h v_h^T      ds = p (dp - D),  D = sum_j p dp
//   dq = ds k_h * scale                   dk = ds^T q_h * scale
//
// Bound on an H100: at the Ultra step's 128 windows x 6 heads x 256 x 256 x
// 32 the function's five products are 16.1 GFLOP, three TF32 products each
// in 3xTF32: 48.3 GFLOP, 0.098 ms at 495 TFLOP/s, against 176 MB of f32 q,
// k, v, g, dq, dk, dv (0.053 ms at 3.35 TB/s): bound by operations. This
// body forms nine such products (the scores and dp twice in launch 1 and
// once in launch 2, dq, dk and dv once) and 3 x 50 M exponentials.
//
// Precision. Every product takes each f32 operand x as a pair of tf32
// values, big = tf32(x) and small = tf32(x - big), each rounded to the
// nearest with ties away from zero (cvt.rna's rounding, done with two
// integer operations on the f32 word), and sums a b = small_a big_b +
// big_a small_b + big_a big_b in f32 (3xTF32; the dropped small_a small_b
// is about 2^-22 of |a b|). p and ds stay f32 and are rounded nowhere
// else. In a torch emulation of this arithmetic
// (tests/test_torch_attention.py) against a float64 reference, 3xTF32
// stays as close as the plain fp32 version, while one tf32 rounding of
// each operand is 4-9x outside the 1e-4 of max|ref| that the card tests
// hold WB-long to. The body ignores
// torch.backends.cuda.matmul.allow_tf32: its precision is fp32-class under
// any setting.
//
// Design (the bf16 body's, window_attn_long_mma_bwd.cuh, with m16n8k8
// tf32 fragments). Two launches, each owning its outputs, every sum in one
// fixed order and no float atomics, so two launches give the same bits:
//
// 1. A block of four warps per (head, window, 64 query rows), 16 rows a
//    warp, takes its q and g rows into registers (as their tf32 pairs) and
//    walks the k and v tiles of 64 twice in one loop over a cp.async double
//    buffer: first each lane's running max of its scores with the sum of
//    exponentials and D = sum_j p dp rescaled online whenever the max grows
//    (joined across the quad at the end, in a butterfly, and D divided by
//    the sum), then ds = p (dp - D) and dq += ds k. One sweep fewer than
//    the bf16 body's three, in one fixed order all the same. The rows'
//    (max, sum, D) go to stats (B, nh, Tq, 3), and with a bias ds to ds_w
//    (B, nh, Tq, Tk) for dbias, the ordered sum over the windows.
// 2. A block of four warps per (head, window, 64 keys), 16 keys a warp,
//    with its k and v rows in registers (as pairs), walks the query tiles
//    of 64 in order (q, g and their stats double-buffered) and forms the
//    transposed scores s^T = k q^T and dp^T = v g^T, so p^T and ds^T sit in
//    the accumulator layout and feed dv += p^T g and dk += ds^T q from
//    registers.
//
// Fragments (tf32_frag.cuh, shared with the forward). The scores and dp
// take the head columns in the permuted slots of tf32_rows; the products
// over keys (launch 2: over queries) take an accumulator tile of p or ds as
// their A fragment as it stands (tf32_cols), and lane t ends up owning head
// columns 8t .. 8t + 7 of its rows. Keys past Tk get -inf scores and
// queries past Tq zero p.
//
// Shapes as the bf16 body's: any Tq, Tk >= 1, a head width up to 32, any
// window count (in pieces of for_window_chunks), the packed layout or with kHM
// the head-major (B, nh, T, hd) one. Rows go in as 16-byte copies when
// every head row starts on 16 bytes (hd a multiple of 4), else as 4-byte
// copies (the paper HAT's C = 180).
//
// Measured against other designs of the same body at the Ultra step's 128
// x 256 x 256 (scripts/ab_torch_sources.py, builds in turns on one H100):
// three sweeps in launch 1 instead of the online one, 14% slower; the
// pairs of q, g, k and v split again at every use instead of held, 2-11%
// slower; cvt.rna.tf32.f32 instead of the integer rounding, 10% slower;
// the k, v, q and g tiles split once where they land (big in place, small
// in a second shared array) instead of in registers, 9% slower (twice the
// shared-memory loads); small left to the tensor core's truncation
// instead of rounded, 5% faster, not taken: the rounding is the precision
// design the CPU emulation checks. ptxas (sm_90a): 152-168 registers, no
// spills, three blocks of 128 threads an SM; capped at 128 (four blocks)
// the launches spilled 228-512 bytes and ran 8% longer, and launch 2 in
// steps of 16 queries spilled 16 bytes at 168 (steps of 8 cost 4%).
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tf32_frag.cuh"
#include "window_attn_bwd.cuh"

namespace gsasr {

// Launch 1, one block of kMThreads per (head, window, 64 query rows): dq,
// each row's (max, sum, D) into stats, and ds into ds_w when it is not
// null. Layouts and flags as the bf16 body's; vec as tf32_vec gives it.
template <bool kMask, bool kHM>
__global__ void __launch_bounds__(kMThreads, 3)
window_attn_bwd_long_tf32_q_kernel(const float* __restrict__ q,
                                   const float* __restrict__ k,
                                   const float* __restrict__ v,
                                   const float* __restrict__ bias,
                                   const float* __restrict__ g,
                                   float* __restrict__ dq,
                                   float* __restrict__ stats,
                                   float* __restrict__ ds_w, int Tq, int Tk,
                                   int C, int nh, float scale,
                                   const float* __restrict__ mask, int nW,
                                   int vec) {
  __shared__ __align__(16) float ks[2][kMTile * kTLd];
  __shared__ __align__(16) float vs[2][kMTile * kTLd];
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

  // the q and g rows pass through the second buffers into registers
  tf32_stage(ks[1], q, wrow * Tq + q0, rows, kMRows, ldg, n0, hd, vec);
  tf32_stage(vs[1], g, wrow * Tq + q0, rows, kMRows, ldg, n0, hd, vec);
  tf32_stage(ks[0], k, wrow * Tk, min(kMTile, Tk), kMTile, ldg, n0, hd, vec);
  tf32_stage(vs[0], v, wrow * Tk, min(kMTile, Tk), kMTile, ldg, n0, hd, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qb[4][4], qsm[4][4], gb[4][4], gsm[4][4];
  tf32_load_a(qb, qsm, ks[1], r0);
  tf32_load_a(gb, gsm, vs[1], r0);
  __syncthreads();

  float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f}, inv[2];
  float dd[2] = {0.f, 0.f};
  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // sweep 0 (steps 0 .. nk - 1): the rows' max, sum and D; sweep 1: ds and
  // dq. The next step's k and v tiles load while this one runs.
  for (int it = 0; it < 2 * nk; ++it) {
    const int nx = it + 1;
    if (nx < 2 * nk) {
      const int k0 = (nx % nk) * kMTile;
      const int kb = min(kMTile, Tk - k0);
      tf32_stage(ks[nx & 1], k, wrow * Tk + k0, kb, kMTile, ldg, n0, hd,
                 vec);
      tf32_stage(vs[nx & 1], v, wrow * Tk + k0, kb, kMTile, ldg, n0, hd,
                 vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = (it % nk) * kMTile;
    const float* kt = ks[it & 1];
    const float* vt = vs[it & 1];
    if (it == nk) {
      // the rows' max, sum and D over the quad, in a butterfly; the
      // statistics out
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
        sm[r] = l;
        inv[r] = 1.f / l;
        dd[r] = d * inv[r];
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
      tf32_rows(s, qb, qsm, kt, 16 * c);
      mma_fix<kMask>(s, k0 + 16 * c, Tk, scale, hb, mb, off0, off1);
      tf32_rows(dp, gb, gsm, vt, 16 * c);
      if (it < nk) {
        // each lane's running max of its columns, with the sum of
        // exponentials and D rescaled when it grows
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
        continue;
      }
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
            const int j = k0 + 16 * c + 8 * n + 2 * t + (e & 1);
            if (j < Tk && r0 + gi + 8 * (e >> 1) < rows)
              ds_w[(srow + 8 * (e >> 1)) * Tk + j] = s[n][e];
          }
      }
      tf32_cols(acc, s[0], kt, 16 * c);
      tf32_cols(acc, s[1], kt, 16 * c + 8);
    }
    __syncthreads();
  }
  tf32_store(dq + n0, acc, wrow * Tq + q0, r0, rows, ldg, hd, scale, vec);
}

// Launch 2, one block of kMThreads per (head, window, 64 keys): dk and dv
// of its keys, the query tiles walked in order with the statistics launch
// 1 stored.
template <bool kMask, bool kHM>
__global__ void __launch_bounds__(kMThreads, 3)
window_attn_bwd_long_tf32_kv_kernel(const float* __restrict__ q,
                                    const float* __restrict__ k,
                                    const float* __restrict__ v,
                                    const float* __restrict__ bias,
                                    const float* __restrict__ g,
                                    float* __restrict__ dk,
                                    float* __restrict__ dv,
                                    const float* __restrict__ stats, int Tq,
                                    int Tk, int C, int nh, float scale,
                                    const float* __restrict__ mask, int nW,
                                    int vec) {
  __shared__ __align__(16) float qs[2][kMTile * kTLd];
  __shared__ __align__(16) float gs[2][kMTile * kTLd];
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
    tf32_stage(qs[b], q, wrow * Tq + i0, ib, kMTile, ldg, n0, hd, vec);
    tf32_stage(gs[b], g, wrow * Tq + i0, ib, kMTile, ldg, n0, hd, vec);
    for (int e = threadIdx.x; e < kMTile; e += kMThreads) {
      const float* st = stats + (srow0 + min(i0 + e, Tq - 1)) * 3;
      sts[b][0][e] = st[0];
      sts[b][1][e] = 1.f / st[1];
      sts[b][2][e] = st[2];
    }
  };
  // the k and v rows pass through the second buffers into registers
  tf32_stage(qs[1], k, wrow * Tk + k0, kb, kMRows, ldg, n0, hd, vec);
  tf32_stage(gs[1], v, wrow * Tk + k0, kb, kMRows, ldg, n0, hd, vec);
  stage_q(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t kbg[4][4], ksm[4][4], vbg[4][4], vsm[4][4];
  tf32_load_a(kbg, ksm, qs[1], r0);
  tf32_load_a(vbg, vsm, gs[1], r0);
  __syncthreads();

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
    const int b = it & 1;
    const int i0 = it * kMTile;
    // 8 queries a step: with the pairs of k and v and both sums held,
    // a step of 16 spilled
#pragma unroll 1
    for (int c = 0; c < kMTile / 8; ++c) {
      float s[1][4], dp[1][4];
      tf32_rows(s, kbg, ksm, qs[b], 8 * c);
      tf32_rows(dp, vbg, vsm, gs[b], 8 * c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = 8 * c + 2 * t + (e & 1);
        const int i = i0 + il;
        float p = 0.f, ds = 0.f;
        if (i < Tq) {
          // the score as launch 1 forms it: scaled, then the bias, then the
          // mask (row i, column j)
          const size_t o = static_cast<size_t>(i) * Tk + (e < 2 ? j0 : j1);
          float x = __fmul_rn(s[0][e], scale);
          if (hb) x = __fadd_rn(x, hb[o]);
          if constexpr (kMask) x = __fadd_rn(x, mb[o]);
          p = __expf(x - sts[b][0][il]) * sts[b][1][il];
          ds = p * (dp[0][e] - sts[b][2][il]);
        }
        s[0][e] = p;
        dp[0][e] = ds;
      }
      tf32_cols(adv, s[0], gs[b], 8 * c);
      tf32_cols(adk, dp[0], qs[b], 8 * c);
    }
    __syncthreads();
  }
  tf32_store(dv + n0, adv, wrow * Tk + k0, r0, kb, ldg, hd, 1.f, vec);
  tf32_store(dk + n0, adk, wrow * Tk + k0, r0, kb, ldg, hd, scale, vec);
}

}  // namespace gsasr

namespace {

// The launches of WB-long, or with kMask WMB-long (mask (nW, Tq, Tk), B a
// multiple of nW), or with kHM WB4-long on the head-major layout: dq and
// the rows' statistics per query tile, then dk and dv per key tile, then
// (dbias given) the ordered sum of ds_w over the windows. q, g, dq (B, Tq,
// C); k, v, dk, dv (B, Tk, C); bias (nh, Tq, Tk) or null; stats (B, nh,
// Tq, 3) and, with dbias, ds_w (B, nh, Tq, Tk) scratch; all f32.
template <bool kMask, bool kHM>
cudaError_t launch_window_attn_bwd_long_tf32(
    const float* q, const float* k, const float* v, const float* bias,
    const float* g, float* dq, float* dk, float* dv, float* stats,
    float* ds_w, float* dbias, int B, int Tq, int Tk, int C, int nh,
    float scale, cudaStream_t st, const float* mask = nullptr, int nW = 1) {
  if (!gsasr::long_shape_ok(B, Tq, Tk, C, nh) || (dbias && !ds_w) ||
      nW < 1 || B % nW != 0 || (kMask && !mask))
    return cudaErrorInvalidValue;
  const void* ops[] = {q, k, v, g, dq, dk, dv};
  const int vec = gsasr::tf32_vec(C / nh, ops, 7);
  constexpr int kR = gsasr::kMRows;
  // the q launch of a piece writes the stats that its kv launch reads
  const cudaError_t err =
      gsasr::for_window_chunks(B, nW, [&](int w0, int nb, int c0) {
        const size_t oq = gsasr::window_offset(w0, Tq, C);
        const size_t ok = gsasr::window_offset(w0, Tk, C);
        float* st_w = stats + gsasr::window_offset(w0, nh * Tq, 3);
        const float* m = gsasr::window_mask_from(mask, c0, Tq, Tk);
        gsasr::window_attn_bwd_long_tf32_q_kernel<kMask, kHM>
            <<<dim3(nh, nb, (Tq + kR - 1) / kR), gsasr::kMThreads, 0, st>>>(
                q + oq, k + ok, v + ok, bias, g + oq, dq + oq, st_w,
                dbias ? ds_w + gsasr::window_offset(w0, nh * Tq, Tk)
                      : nullptr,
                Tq, Tk, C, nh, scale, m, nW, vec);
        gsasr::window_attn_bwd_long_tf32_kv_kernel<kMask, kHM>
            <<<dim3(nh, nb, (Tk + kR - 1) / kR), gsasr::kMThreads, 0, st>>>(
                q + oq, k + ok, v + ok, bias, g + oq, dk + ok, dv + ok, st_w,
                Tq, Tk, C, nh, scale, m, nW, vec);
      });
  if (err != cudaSuccess || !dbias) return err;
  const int n = nh * Tq * Tk;
  dbias_sum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      ds_w, dbias, B, n);
  return cudaGetLastError();
}

}  // namespace
