// The bf16 window-16 attention forward on Hopper's tensor cores: the body
// of W-long-bf16 (window_attn_fwd_long_bf16), with its template flags
// WM-long-bf16 (kMask) and W4-long-bf16 (kHM), and the attention launch of
// A-long-bf16 (ln_attn.cu). It replaces the bf16 operand forms of
// _attn_kernel_packed (gsasr_tpu/ops/attention.py, Pallas K11 at window 16:
// HAT-L Ultra's 256 x 256 windows and OCAB's 256 x 576 rectangles), of
// _attn_kernel_packed_masked (K13, the paper HAT's shifted windows) and of
// _attn_kernel (K14, the 4D layout) beyond 160 tokens. The fp32 forms run
// the 3xTF32 body of window_attn_long_tf32.cuh. Per window w and head h:
//
//   s = q_h k_h^T * scale (+ bias[h]) (+ mask[w % nW])   (Tq x Tk, f32)
//   p = exp(s - max) / sum, normalized, then rounded to bf16
//   out[w, :, h*hd:(h+1)*hd] = p v_h    (f32 sums, rounded once, stored)
//
// Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): at the Ultra step's 128
// windows x 6 heads x 256 x 256 x 32 the two products are 6.4 GFLOP (6.5
// us) against 50 MB of bf16 q, k, v and out (15 us): bound by bytes. The
// two passes below add 2 x 50 M exponentials, about 24 us on the MUFU (16
// a clock per SM), and a third product; the tensor cores are never the
// limit.
//
// Design. A block of four warps takes 64 query rows of one (head, window),
// 16 rows a warp, and walks the keys in tiles of 64, in two passes that
// form the same score bits: pass 1 keeps each row's running max and sum of
// exponentials (each lane its own columns, joined across the quad once at
// the end), pass 2 recomputes the scores, forms p = exp(s - max) / sum,
// rounds it to bf16 (the Pallas body's p.astype(v.dtype)) and multiplies
// by v. No single online-softmax pass replaces them: it would round an
// unnormalized p. Both passes are one loop of 2 nT steps over a double
// buffer: q, k and v stay bf16 in shared memory (rows of 32 columns, the
// head width padded with zeros, at an 80-byte stride, so the eight row
// addresses of an ldmatrix fall in eight bank groups), and the tile of
// step i + 1 is in flight (cp.async) while step i multiplies. Scores come
// from mma.sync m16n8k16 (bf16 operands, f32 sums) on ldmatrix fragments;
// the scale, bias and mask are applied to the accumulators, each step
// rounded on its own (__fmul_rn, then __fadd_rn of the bias, then of the
// mask), keys past Tk get -inf, and in pass 2 the rounded p fragment is
// the A operand of the PV product straight from registers (the
// accumulator layout of two 8-key tiles is the A layout of 16 keys), with
// v's B fragments from ldmatrix.trans. mma.sync rather than wgmma: a warp
// owns 16 rows and its softmax, the products are a small share of the time
// and of the 64-row wgmma's gain, and the fragment reuse above stays in one
// warp's registers.
//
// Shapes: any Tq, Tk >= 1 (rows past Tq are zeros, computed and not
// stored), a head width up to 32, any window count (in pieces of
// for_window_chunks), the packed layout or with kHM the head-major (B, nh, T,
// hd) one. Rows go in as 16-byte copies when every head row starts on 16
// bytes (hd a multiple of 8, as at C = 192), as 4-byte copies when on 4
// bytes (the paper HAT's C = 180: head h starts at byte 60 h, which neither
// TMA nor a 16-byte cp.async can address), else element by element.
//
// Rounding: products of bf16 values are exact in f32, so the scores differ
// from the plain version's only in the order of their f32 sums; p is
// rounded at the same point, and out once. Two launches give the same bits.
//
// ptxas (sm_90a): 94 registers (96 with the mask or the head-major flag),
// no spills, 25.6 KB of static shared memory: five blocks of 128 threads
// an SM. Each tile is taken in halves of 32 keys; whole 64-key tiles took
// 112-126 registers, four blocks an SM, and 4-7% longer at 256 x 256.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mma_ptx.cuh"
#include "window_attn_long.cuh"

namespace gsasr {

constexpr int kMThreads = 128;  // four warps
constexpr int kMRows = 64;      // query (backward: key) rows a block owns
constexpr int kMTile = 64;      // rows of a staged key (or query) tile
constexpr int kMLd = 40;        // row stride in shared memory, bf16
// Head widths up to long_shape_ok's kLMaxHd are padded with zeros to it:
// the products take it in two k-steps of 16.
static_assert(kLMaxHd == 32, "the fragments hold 32 columns");

// Elements per copy of a head row: 8 when every operand's head rows start
// on 16 bytes, 2 when on 4 bytes, else 1. Rows are C (or, head-major, hd)
// elements apart and head h starts at element h hd, so hd decides.
inline int mma_vec(int hd, const void* const* ptrs, int n) {
  auto on = [&](uintptr_t a) {
    for (int i = 0; i < n; ++i)
      if (reinterpret_cast<uintptr_t>(ptrs[i]) % a) return false;
    return true;
  };
  if (hd % 8 == 0 && on(16)) return 8;
  if (hd % 2 == 0 && on(4)) return 2;
  return 1;
}

// Rows [row0, row0 + rows) of a head's columns [n0, n0 + hd) (rows ldg
// apart) into `pad` rows of kMLd in shared memory, rows past `rows` and
// columns past hd zeros, by a block of nthr threads: cp.async copies of vec
// elements, which the caller commits and waits for, or with vec 1 plain
// stores.
__device__ __forceinline__ void mma_stage_n(__nv_bfloat16* dst,
                                            const __nv_bfloat16* __restrict__ src,
                                            size_t row0, int rows, int pad,
                                            int ldg, int n0, int hd, int vec,
                                            int nthr) {
  if (vec == 1) {
    for (int e = threadIdx.x; e < pad * kLMaxHd; e += nthr) {
      const int r = e / kLMaxHd;
      const int d = e % kLMaxHd;
      dst[r * kMLd + d] = r < rows && d < hd
                              ? src[(row0 + r) * ldg + n0 + d]
                              : __float2bfloat16_rn(0.f);
    }
    return;
  }
  const int per = kLMaxHd / vec;
  for (int e = threadIdx.x; e < pad * per; e += nthr) {
    const int r = e / per;
    const int d = (e - r * per) * vec;
    const bool ok = r < rows && d < hd;
    const __nv_bfloat16* s =
        src + (row0 + (ok ? r : 0)) * ldg + n0 + (ok ? d : 0);
    if (vec == 8)
      cp_async16(dst + r * kMLd + d, s, ok ? 16 : 0);
    else
      cp_async4(dst + r * kMLd + d, s, ok ? 4 : 0);
  }
}

// mma_stage_n into kR rows by the window-16 bodies' kMThreads.
template <int kR>
__device__ __forceinline__ void mma_stage(__nv_bfloat16* dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          size_t row0, int rows, int ldg,
                                          int n0, int hd, int vec) {
  mma_stage_n(dst, src, row0, rows, kR, ldg, n0, hd, vec, kMThreads);
}

// The A fragments of rows r0 .. r0 + 15 of a tile, both k-steps of its 32
// columns.
__device__ __forceinline__ void mma_load_a(uint32_t (&a)[2][4],
                                           const __nv_bfloat16* tile,
                                           int r0) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p = tile + (r0 + (lane & 15)) * kMLd + (lane >> 4) * 8;
  ldsm_x4(a[0], p);
  ldsm_x4(a[1], p + 16);
}

// acc[n] = a . (rows r0 + 8 n .. r0 + 8 n + 7 of a tile)^T over the 32
// columns, n < kN: the scores of 16 rows against 8 kN staged rows.
template <int kN>
__device__ __forceinline__ void mma_rows(float (&acc)[kN][4],
                                         const uint32_t (&a)[2][4],
                                         const __nv_bfloat16* tile, int r0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    uint32_t b[4];
    ldsm_x4(b, tile + (r0 + 8 * n + (lane & 7)) * kMLd + (lane >> 3) * 8);
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    mma_bf16(acc[n], a[0], b[0], b[1]);
    mma_bf16(acc[n], a[1], b[2], b[3]);
  }
}

// acc[n] += sum over the parts of a[part] . rows r0 .. r0 + 15 of a tile
// (the k dimension), columns 8 n .. 8 n + 7, n < 4: the products p v and,
// with two parts (hi and lo), ds k and the backward's transposed ones.
template <int kParts>
__device__ __forceinline__ void mma_cols(float (&acc)[4][4],
                                         const uint32_t (&a)[kParts][4],
                                         const __nv_bfloat16* tile, int r0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 4; n += 2) {
    uint32_t b[4];
    ldsm_x4_t(b, tile + (r0 + (lane & 15)) * kMLd + 8 * n + (lane >> 4) * 8);
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      mma_bf16(acc[n], a[part], b[0], b[1]);
      mma_bf16(acc[n + 1], a[part], b[2], b[3]);
    }
  }
}

// The scores s[n] of mma_rows (this lane's rows g and g + 8, keys j0 + 8 n
// + 2 t, + 1) as the softmax takes them: times the scale, plus the bias
// and then the mask (rows off0 and off1 of them, row-major with Tk
// columns), each step rounded on its own; -inf at keys past Tk.
template <bool kMask, int kN>
__device__ __forceinline__ void mma_fix(float (&s)[kN][4], int j0, int Tk,
                                        float scale, const float* hb,
                                        const float* mb, size_t off0,
                                        size_t off1) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + 8 * n + 2 * t + (e & 1);
      const size_t o = (e < 2 ? off0 : off1) + j;
      float x = __fmul_rn(s[n][e], scale);
      if (j < Tk) {
        if (hb) x = __fadd_rn(x, hb[o]);
        if constexpr (kMask) x = __fadd_rn(x, mb[o]);
      } else {
        x = -INFINITY;
      }
      s[n][e] = x;
    }
}

// One tile's scores into this lane's running max and sum of exponentials
// of its rows (its own columns only; mma_row_stats joins the quad).
template <int kN>
__device__ __forceinline__ void mma_online(const float (&s)[kN][4],
                                           float (&mx)[2], float (&sm)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = mx[r];
#pragma unroll
    for (int n = 0; n < kN; ++n)
      m = fmaxf(m, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
    const float base = m == -INFINITY ? 0.f : m;
    float acc = sm[r] * __expf(mx[r] - base);
#pragma unroll
    for (int n = 0; n < kN; ++n)
      acc += __expf(s[n][2 * r] - base) + __expf(s[n][2 * r + 1] - base);
    sm[r] = acc;
    mx[r] = m;
  }
}

// The rows' max and sum joined over the quad (the four lanes of a row, in
// a butterfly, so all four get the same bits): mx becomes the row max and
// sm the row sum.
__device__ __forceinline__ void mma_row_stats(float (&mx)[2], float (&sm)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = mx[r];
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float l = mx[r] == -INFINITY ? 0.f : sm[r] * __expf(mx[r] - m);
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    mx[r] = m;
    sm[r] = l;
  }
}

// The A fragment of 16 columns (two 8-column accumulator tiles x[0], x[1])
// rounded to bf16.
__device__ __forceinline__ void mma_pack(uint32_t (&a)[4],
                                         const float (&x0)[4],
                                         const float (&x1)[4]) {
  a[0] = pack_bf16(x0[0], x0[1]);
  a[1] = pack_bf16(x0[2], x0[3]);
  a[2] = pack_bf16(x1[0], x1[1]);
  a[3] = pack_bf16(x1[2], x1[3]);
}

// The forward, one block of kMThreads per (head, window, 64 query rows):
// q, k, v and out bf16, packed (B, T, C) or with kHM head-major (B, nh, T,
// hd); bias (nh, Tq, Tk) f32 or null; with kMask, mask (nW, Tq, Tk) f32,
// window w taking mask[w % nW]. vec as mma_vec gives it.
template <bool kMask, bool kHM>
__global__ void __launch_bounds__(kMThreads, 5)
window_attn_fwd_long_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const float* __restrict__ bias,
                                const float* __restrict__ mask,
                                __nv_bfloat16* __restrict__ out, int Tq,
                                int Tk, int C, int nh, int nW, float scale,
                                int vec) {
  __shared__ __align__(16) __nv_bfloat16 qs[kMRows * kMLd];
  __shared__ __align__(16) __nv_bfloat16 ks[2][kMTile * kMLd];
  __shared__ __align__(16) __nv_bfloat16 vs[2][kMTile * kMLd];
  const int hd = C / nh;
  const int head = blockIdx.x;
  const int win = blockIdx.y;
  const int q0 = blockIdx.z * kMRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = kHM ? 0 : head * hd;
  const int ldg = kHM ? hd : C;
  const size_t wrow = kHM ? static_cast<size_t>(win) * nh + head : win;
  const int rows = min(kMRows, Tq - q0);
  const int r0 = warp * 16;
  const float* hb =
      bias ? bias + static_cast<size_t>(head) * Tq * Tk : nullptr;
  const float* mb = kMask ? long_window_mask(mask, win, nW, Tq, Tk) : nullptr;
  // this lane's rows g and g + 8 in the bias and mask (past Tq: the last)
  const size_t off0 = static_cast<size_t>(min(q0 + r0 + g, Tq - 1)) * Tk;
  const size_t off1 = static_cast<size_t>(min(q0 + r0 + g + 8, Tq - 1)) * Tk;
  const int nk = (Tk + kMTile - 1) / kMTile;

  mma_stage<kMRows>(qs, q, wrow * Tq + q0, rows, ldg, n0, hd, vec);
  mma_stage<kMTile>(ks[0], k, wrow * Tk, min(kMTile, Tk), ldg, n0, hd, vec);
  cp_async_commit();

  uint32_t qa[2][4];
  float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f}, inv[2];
  float o[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // steps 0 .. nk - 1: pass 1 on k tile i; nk .. 2 nk - 1: pass 2 on k
  // and v tile i - nk. The next step's tiles load while this one runs.
  for (int it = 0; it < 2 * nk; ++it) {
    const int nx = it + 1;
    if (nx < 2 * nk) {
      const int k0 = (nx < nk ? nx : nx - nk) * kMTile;
      const int kb = min(kMTile, Tk - k0);
      mma_stage<kMTile>(ks[nx & 1], k, wrow * Tk + k0, kb, ldg, n0, hd, vec);
      if (nx >= nk)
        mma_stage<kMTile>(vs[nx & 1], v, wrow * Tk + k0, kb, ldg, n0, hd,
                          vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) mma_load_a(qa, qs, r0);
    const int k0 = (it < nk ? it : it - nk) * kMTile;
    if (it == nk) {
      mma_row_stats(mx, sm);
      inv[0] = 1.f / sm[0];
      inv[1] = 1.f / sm[1];
    }
    // in halves of 32 keys, so that five blocks fit an SM's registers
#pragma unroll
    for (int h = 0; h < kMTile; h += 32) {
      float s[4][4];
      mma_rows(s, qa, ks[it & 1], h);
      mma_fix<kMask>(s, k0 + h, Tk, scale, hb, mb, off0, off1);
      if (it < nk) {
        mma_online(s, mx, sm);
      } else {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
#pragma unroll
          for (int n = 2 * c; n < 2 * c + 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[n][e] = __expf(s[n][e] - mx[e >> 1]) * inv[e >> 1];
          uint32_t pa[1][4];
          mma_pack(pa[0], s[2 * c], s[2 * c + 1]);
          mma_cols(o, pa, vs[it & 1], h + 16 * c);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= rows) continue;
    __nv_bfloat16* dst = out + (wrow * Tq + q0 + row) * ldg + n0;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * t + e;
        if (d < hd) dst[d] = __float2bfloat16_rn(o[n][2 * r + e]);
      }
  }
}

}  // namespace gsasr

namespace {

// W-long-bf16, or with kMask WM-long-bf16 (mask (nW, Tq, Tk), B a multiple
// of nW), or with kHM W4-long-bf16 on the head-major layout; also
// A-long-bf16's attention launch.
template <bool kMask, bool kHM>
cudaError_t launch_fwd_long_mma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                const __nv_bfloat16* v, const float* bias,
                                const float* mask, __nv_bfloat16* out, int B,
                                int Tq, int Tk, int C, int nh, int nW,
                                float scale, cudaStream_t st) {
  if (!gsasr::long_shape_ok(B, Tq, Tk, C, nh) || nW < 1 || B % nW != 0 ||
      (kMask && !mask))
    return cudaErrorInvalidValue;
  const void* ops[] = {q, k, v};
  const int vec = gsasr::mma_vec(C / nh, ops, 3);
  return gsasr::for_window_chunks(B, nW, [&](int w0, int nb, int c0) {
    const size_t oq = gsasr::window_offset(w0, Tq, C);
    const size_t ok = gsasr::window_offset(w0, Tk, C);
    gsasr::window_attn_fwd_long_mma_kernel<kMask, kHM>
        <<<dim3(nh, nb, (Tq + gsasr::kMRows - 1) / gsasr::kMRows),
           gsasr::kMThreads, 0, st>>>(
            q + oq, k + ok, v + ok, bias,
            gsasr::window_mask_from(mask, c0, Tq, Tk), out + oq, Tq, Tk, C,
            nh, nW, scale, vec);
  });
}

}  // namespace
