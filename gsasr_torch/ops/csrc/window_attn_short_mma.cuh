// The bf16 window attention forward up to 160 tokens on Hopper's tensor
// cores: the body of W-bf16 (window_attn_fwd_bf16), with its template flags
// WM-bf16 (kMask) and W4-bf16 (kHM). It replaces the bf16 operand forms of
// _attn_kernel_packed (gsasr_tpu/ops/attention.py, Pallas K11: the Enhanced
// decoder's 144-token windows, SwinIR's 64), of _attn_kernel_packed_masked
// (K13, SwinIR's shifted windows at the bf16 recipe) and of _attn_kernel
// (K14, the 4D layout) at Tq, Tk <= 160. The fp32 forms run the 3xTF32
// body of window_attn_short_tf32.cuh. Per window w and head h:
//
//   s = q_h k_h^T * scale (+ bias[h]) (+ mask[w % nW])   (Tq x Tk, f32)
//   p = exp(s - max) / sum, normalized, then rounded to bf16
//   out[w, :, h*hd:(h+1)*hd] = p v_h    (f32 sums, rounded once, stored)
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): at the Enhanced step's
// 256 windows x 6 heads x 144 x 144 x 32 the two products are 4.1 GFLOP (4
// us) against 57 MB of bf16 q, k, v and out (17 us): bound by bytes. The
// 32 M exponentials take about 8 us on the MUFU (16 a clock per SM).
//
// Design. A window of up to 160 tokens fits on chip whole, so a block
// stages one (head, window)'s q, k and v once (bf16, rows of 32 columns at
// window_attn_long_mma.cuh's 80-byte stride, rows padded with zeros to a
// multiple of 16): at most 38.4 KB, 34.6 KB at 144 tokens. Beyond 64 keys
// the grid is persistent, as many blocks as run at once, each walking
// (head, window) units with the next unit's copy in flight (cp.async) into
// a second buffer while it works on this one, so the staging hides behind
// the products (short_pipelined); up to 64 keys one block takes one unit.
// The block has one warp per 16 query rows (nine at 144 tokens, four at
// 64), so no warp waits on another's second tile. A warp forms its 16
// rows' scores against every key in n8 tiles up to ceil(Tk / 16) chunks of
// 16 keys (144 is 9 chunks, 64 is 4: no padding to a 64-key tile), with
// mma.sync m16n8k16 (bf16 operands, f32 sums) on ldmatrix
// fragments, and fixes them up as the window-16 body does (mma_fix: the
// scale, then the bias, then the mask, each rounded on its own; -inf past
// Tk). The whole row stays in registers (kNC x 8 scores a thread: 72 at 144
// keys, 80 at 160), so the softmax takes one pass: the row max and the sum
// of exponentials from registers (each lane its own columns, joined across
// the quad in a butterfly), one exponential per score, then p normalized,
// rounded to bf16 and used straight from the accumulators as the A operand
// of PV (two 8-key tiles make one 16-key A fragment), with v's B fragments
// from ldmatrix.trans. The window-16 body needs two passes and two
// exponentials per score, since its rows do not fit. kNC, the register
// array's chunks, is 4 (Tk <= 64), 9 (<= 144) or 10 (<= 160), so SwinIR's
// 64 tokens hold 32 scores a thread and not 80. At 144 tokens (126
// registers, nine warps) one block runs an SM; held to two (96 registers,
// the cap of five warps a quarter-SM register file) the 9-chunk kernel took
// 26% less time but spilled 100 bytes, so it is left free and the second
// buffer takes the second block's place (PERF.md, Findings).
//
// Rounding: products of bf16 values are exact in f32, so the scores differ
// from the plain version's only in the order of their f32 sums; p is
// rounded at the same point, and out once. Every sum runs in one order, so
// two launches give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mma_ptx.cuh"
#include "window_attn.cuh"
#include "window_attn_long_mma.cuh"

namespace gsasr {

// One warp per 16 rows of a window of at most kMaxT tokens.
constexpr int kSMaxThreads = 2 * kMaxT;  // 320

// Rows of a staged operand of t tokens: t rounded up to 16, an mma's m and
// k.
__host__ __device__ __forceinline__ int short_rows(int t) {
  return (t + 15) & ~15;
}

// The register array's 16-key chunks for Tk keys: 4, 9 or 10.
inline int short_chunks(int Tk) {
  const int nc = short_rows(Tk) / 16;
  return nc <= 4 ? 4 : nc <= 9 ? 9 : 10;
}

// What the short bodies take: Tq, Tk in [1, kMaxT], a head width up to
// kMaxHd, and a window count the grid's y dimension holds.
inline bool short_shape_ok(int B, int Tq, int Tk, int C, int nh, int nW) {
  return B >= 1 && B <= 65535 && Tq >= 1 && Tk >= 1 && Tq <= kMaxT &&
         Tk <= kMaxT && nh >= 1 && C % nh == 0 && C / nh <= kMaxHd &&
         nW >= 1 && B % nW == 0;
}

// The rows' max and sum over the quad (the four lanes of a row, in a
// butterfly, so all four get the same bits).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The normalized softmax p of this warp's 16 query rows r0 .. r0 + 15
// against nc chunks of 16 keys, in this lane's accumulator entries: p[c][n]
// holds rows g, g + 8 (entries 0, 1 and 2, 3) and keys 16 c + 8 n + 2 t, + 1.
// inv gets each row's 1 / sum, mx its max. Keys past Tk get p = 0.
template <bool kMask, int kNC>
__device__ __forceinline__ void short_probs(float (&p)[kNC][2][4],
                                            float (&mx)[2], float (&inv)[2],
                                            const uint32_t (&qa)[2][4],
                                            const __nv_bfloat16* ks, int nc,
                                            int Tk, float scale,
                                            const float* hb, const float* mb,
                                            size_t off0, size_t off1) {
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int c = 0; c < kNC; ++c) {
    if (c < nc) {
      mma_rows(p[c], qa, ks, 16 * c);
      mma_fix<kMask>(p[c], 16 * c, Tk, scale, hb, mb, off0, off1);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], p[c][n][e]);
    }
  }
  float sm[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) mx[r] = quad_max(mx[r]);
#pragma unroll
  for (int c = 0; c < kNC; ++c) {
    if (c < nc) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[c][n][e] = __expf(p[c][n][e] - mx[e >> 1]);
          sm[e >> 1] += p[c][n][e];
        }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / quad_sum(sm[r]);
#pragma unroll
  for (int c = 0; c < kNC; ++c) {
    if (c < nc) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[c][n][e] *= inv[e >> 1];
    }
  }
}

// The forward of one unit, (head, window), on its q, k and v staged in qs,
// ks, vs, by a block of 2 short_rows(Tq) threads: q, k, v and
// out bf16, packed (B, T, C) or with kHM head-major (B, nh, T, hd); bias
// (nh, Tq, Tk) f32 or null; with kMask, mask (nW, Tq, Tk) f32, window w
// taking mask[w % nW].
template <bool kMask, bool kHM, int kNC>
__device__ __forceinline__ void short_fwd_unit(
    const __nv_bfloat16* qs, const __nv_bfloat16* ks,
    const __nv_bfloat16* vs, const float* __restrict__ bias,
    const float* __restrict__ mask, __nv_bfloat16* __restrict__ out,
    int head, int win, int Tq, int Tk, int C, int nh, int nW, float scale) {
  const int hd = C / nh;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = kHM ? 0 : head * hd;
  const int ldg = kHM ? hd : C;
  const size_t wrow = kHM ? static_cast<size_t>(win) * nh + head : win;
  const int r0 = warp * 16;
  const float* hb =
      bias ? bias + static_cast<size_t>(head) * Tq * Tk : nullptr;
  const float* mb = kMask ? long_window_mask(mask, win, nW, Tq, Tk) : nullptr;
  // this lane's rows g and g + 8 in the bias and mask (past Tq: the last)
  const size_t off0 = static_cast<size_t>(min(r0 + g, Tq - 1)) * Tk;
  const size_t off1 = static_cast<size_t>(min(r0 + g + 8, Tq - 1)) * Tk;
  const int nc = short_rows(Tk) / 16;

  uint32_t qa[2][4];
  mma_load_a(qa, qs, r0);
  float p[kNC][2][4], mx[2], inv[2];
  short_probs<kMask>(p, mx, inv, qa, ks, nc, Tk, scale, hb, mb, off0, off1);
  float o[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int c = 0; c < kNC; ++c) {
    if (c < nc) {
      uint32_t pa[1][4];
      mma_pack(pa[0], p[c][0], p[c][1]);
      mma_cols(o, pa, vs, 16 * c);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= Tq) continue;
    __nv_bfloat16* dst = out + (wrow * Tq + row) * ldg + n0;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * t + e;
        if (d < hd) dst[d] = __float2bfloat16_rn(o[n][2 * r + e]);
      }
  }
}

// Whether the kernel of nc chunks takes the persistent grid. Windows of
// more than 64 keys (kNC 9 and 10: one block of up to ten warps an SM) do:
// block b takes units b, b + gridDim.x, ... with the next unit's q, k and v
// in flight (cp.async) into the second of two buffers while this one's are
// used. Windows of up to 64 keys (kNC 4: seven blocks an SM) take one block
// per unit, grid (nh, B), and one buffer; pipelined they ran 6-9% slower
// (the grid's last wave of units; PERF.md, Findings).
__host__ __device__ constexpr bool short_pipelined(int nc) { return nc > 4; }

// The forward over the B nh units (head u % nh, window u / nh);
// operands as short_fwd_unit's. vec as mma_vec gives it.
template <bool kMask, bool kHM, int kNC>
__global__ void __launch_bounds__(kSMaxThreads)
window_attn_fwd_short_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 const float* __restrict__ bias,
                                 const float* __restrict__ mask,
                                 __nv_bfloat16* __restrict__ out, int B,
                                 int Tq, int Tk, int C, int nh, int nW,
                                 float scale, int vec) {
  extern __shared__ __align__(16) unsigned char short_smem[];
  const int tq16 = short_rows(Tq);
  const int tk16 = short_rows(Tk);
  __nv_bfloat16* buf = reinterpret_cast<__nv_bfloat16*>(short_smem);
  const int hd = C / nh;
  const int ldg = kHM ? hd : C;
  // the operands of (head, window) into the buffer at qs
  auto stage = [&](int head, int win, __nv_bfloat16* qs) {
    const size_t wrow = kHM ? static_cast<size_t>(win) * nh + head : win;
    const int n0 = kHM ? 0 : head * hd;
    mma_stage_n(qs, q, wrow * Tq, Tq, tq16, ldg, n0, hd, vec, blockDim.x);
    mma_stage_n(qs + tq16 * kMLd, k, wrow * Tk, Tk, tk16, ldg, n0, hd, vec,
                blockDim.x);
    mma_stage_n(qs + (tq16 + tk16) * kMLd, v, wrow * Tk, Tk, tk16, ldg, n0,
                hd, vec, blockDim.x);
  };

  if constexpr (!short_pipelined(kNC)) {
    stage(blockIdx.x, blockIdx.y, buf);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    short_fwd_unit<kMask, kHM, kNC>(buf, buf + tq16 * kMLd,
                                    buf + (tq16 + tk16) * kMLd, bias, mask,
                                    out, blockIdx.x, blockIdx.y, Tq, Tk, C,
                                    nh, nW, scale);
  } else {
    const int per = (tq16 + 2 * tk16) * kMLd;  // one buffer: q, k, v
    const int units = B * nh;
    int u = blockIdx.x;
    if (u < units) stage(u % nh, u / nh, buf);
    cp_async_commit();
    for (int it = 0; u < units; ++it, u += gridDim.x) {
      const __nv_bfloat16* qs = buf + (it & 1) * per;
      // the next unit's operands into the other buffer, which the block
      // left at the end of the step before
      const int nx = u + gridDim.x;
      if (nx < units) stage(nx % nh, nx / nh, buf + ((it + 1) & 1) * per);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      short_fwd_unit<kMask, kHM, kNC>(qs, qs + tq16 * kMLd,
                                      qs + (tq16 + tk16) * kMLd, bias, mask,
                                      out, u % nh, u / nh, Tq, Tk, C, nh, nW,
                                      scale);
      __syncthreads();
    }
  }
}

// The kernel of a flag pair for Tk keys: its kNC bucket.
template <bool kMask, bool kHM>
inline auto short_fwd_kernel(int Tk) {
  const int nc = short_chunks(Tk);
  return nc == 4 ? window_attn_fwd_short_mma_kernel<kMask, kHM, 4>
         : nc == 9 ? window_attn_fwd_short_mma_kernel<kMask, kHM, 9>
                   : window_attn_fwd_short_mma_kernel<kMask, kHM, 10>;
}

}  // namespace gsasr

namespace {

// W-bf16, or with kMask WM-bf16 (mask (nW, Tq, Tk), B a multiple of nW), or
// with kHM W4-bf16 on the head-major layout, at Tq, Tk <= kMaxT.
template <bool kMask, bool kHM>
cudaError_t launch_fwd_short_mma(const __nv_bfloat16* q,
                                 const __nv_bfloat16* k,
                                 const __nv_bfloat16* v, const float* bias,
                                 const float* mask, __nv_bfloat16* out, int B,
                                 int Tq, int Tk, int C, int nh, int nW,
                                 float scale, cudaStream_t st) {
  if (!gsasr::short_shape_ok(B, Tq, Tk, C, nh, nW) || (kMask && !mask))
    return cudaErrorInvalidValue;
  const void* ops[] = {q, k, v};
  const int vec = gsasr::mma_vec(C / nh, ops, 3);
  const int threads = 2 * gsasr::short_rows(Tq);
  const int units = B * nh;
  // one buffer of q, k and v, or two with the persistent grid
  const bool piped = gsasr::short_pipelined(gsasr::short_chunks(Tk));
  const size_t smem = (piped ? 2 : 1) * sizeof(__nv_bfloat16) *
                      gsasr::kMLd *
                      (gsasr::short_rows(Tq) + 2 * gsasr::short_rows(Tk));
  const auto kernel = gsasr::short_fwd_kernel<kMask, kHM>(Tk);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(nh, B);
  if (piped) {
    // as many blocks as run at once on the card, none idle
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return err;
    const int most = sms * per_sm;
    grid = dim3(most < 1 ? 1 : units < most ? units : most);
  }
  kernel<<<grid, threads, smem, st>>>(q, k, v, bias, mask, out, B, Tq, Tk, C,
                                      nh, nW, scale, vec);
  return cudaGetLastError();
}

}  // namespace
