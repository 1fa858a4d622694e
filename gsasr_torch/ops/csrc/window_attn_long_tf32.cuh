// The fp32 window-16 attention forward on Hopper's tensor cores in 3xTF32:
// the body of W-long (window_attn_fwd_long), with its template flags
// WM-long (kMask) and W4-long (kHM), and the fp32 attention launch of
// A-long (ln_attn.cu). It replaces the fp32 forms of _attn_kernel_packed
// (gsasr_tpu/ops/attention.py, Pallas K11 at window 16: HAT-L Ultra's 256 x
// 256 windows and OCAB's 256 x 576 at model_dtype float32, the paper HAT's
// unshifted windows), of _attn_kernel_packed_masked (K13, the paper HAT's
// shifted windows), of _attn_kernel (K14, the 4D layout) beyond 160 tokens,
// and the attention of _k_ln_attn (ops/fused_layers.py, K8) at windows of
// 256 tokens. The bf16 forms run window_attn_long_mma.cuh. Per window w and
// head h:
//
//   s = q_h k_h^T * scale (+ bias[h]) (+ mask[w % nW])   (Tq x Tk, f32)
//   p = exp(s - max) / sum                               (f32, not rounded)
//   out[w, :, h*hd:(h+1)*hd] = p v_h                     (f32)
//
// Bound on an H100: at the Ultra image's 144 windows x 6 heads x 256 x 256
// x 32 the two products are 7.2 GFLOP, three TF32 products each in 3xTF32:
// 21.7 GFLOP, 0.044 ms at 495 TFLOP/s, against 113 MB of f32 q, k, v and
// out (0.034 ms at 3.35 TB/s): bound by operations; OCAB's 256 x 576 0.098
// ms against 0.058. The exponentials (38 M at 256 x 256) take about 0.02 ms
// on the MUFU (16 a clock per SM).
//
// Precision: every product in 3xTF32 (tf32_frag.cuh), p and the sums in
// f32 and rounded nowhere. In a torch emulation of this arithmetic
// (tests/test_torch_attention.py) against a float64 reference, 3xTF32 stays
// as close as the plain fp32 version, while one tf32 rounding of each
// operand is outside the 1e-4 that the card tests hold W-long to. The body
// ignores torch.backends.cuda.matmul.allow_tf32.
//
// Design (the bf16 body's block layout, window_attn_long_mma.cuh, with
// the backward's m16n8k8 tf32 fragments, window_attn_long_tf32_bwd.cuh). A
// block of four warps takes 64 query rows of one (head, window), 16 rows a
// warp, holds its q rows in registers as their tf32 pairs and walks the k
// and v tiles of 64 keys once, over a cp.async double buffer (f32 rows at
// the stride of 36 floats), in halves of 32 keys: the scores of the half
// (scaled, then the bias, then the mask, each step rounded on its own, as
// mma_fix forms them; -inf past Tk), the rows' max joined over the quad,
// the row sums and the output rescaled when the max grows, p = exp(s -
// max), and o += p v from registers (the accumulator tile of 8 keys is the
// A fragment of the next product as it stands). One sweep, each score
// formed once: the fp32 forward rounds no p, so no second sweep over a
// normalized p is needed (the bf16 body's two). At the end the quad's
// sums are joined and out = o / sum is stored. Every sum runs in one fixed
// order, so two launches give the same bits.
//
// Shapes: any Tq, Tk >= 1 (a warp whose 16 rows all lie past Tq, and the
// halves past Tk, skip their products, which would add nothing), a head
// width up to 32 (hd 30 for HAT-L and the paper HAT, padded with zeros),
// any window count (in pieces of for_window_chunks), the packed layout or with
// kHM the head-major (B, nh, T, hd) one. Rows go in as 16-byte copies when
// every head row starts on 16 bytes (hd a multiple of 4), else as 4-byte
// copies (the paper HAT's C = 180).
//
// Measured against other designs of the same body (scripts/
// ab_torch_sources.py, builds in turns on one H100): two sweeps (the bf16
// body's, p formed from the row's final max and sum) 1.40-1.56x slower;
// capped at 128 registers (four blocks an SM) it spilled 16-48 bytes and
// ran 0-5% faster, not taken. ptxas (sm_90a): 143 registers (147 with the
// mask), no spills, three blocks of 128 threads an SM.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tf32_frag.cuh"

namespace gsasr {

// The forward, one block of kMThreads per (head, window, 64 query rows): q,
// k, v and out f32, packed (B, T, C) or with kHM head-major (B, nh, T, hd);
// bias (nh, Tq, Tk) or null; with kMask, mask (nW, Tq, Tk), window w taking
// mask[w % nW]. vec as tf32_vec gives it.
template <bool kMask, bool kHM>
__global__ void __launch_bounds__(kMThreads, 3)
window_attn_fwd_long_tf32_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 const float* __restrict__ bias,
                                 const float* __restrict__ mask,
                                 float* __restrict__ out, int Tq, int Tk,
                                 int C, int nh, int nW, float scale,
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
  const int n0 = kHM ? 0 : head * hd;
  const int ldg = kHM ? hd : C;
  const size_t wrow = kHM ? static_cast<size_t>(win) * nh + head : win;
  const int rows = min(kMRows, Tq - q0);
  const int r0 = warp * 16;
  const float* hb =
      bias ? bias + static_cast<size_t>(head) * Tq * Tk : nullptr;
  const float* mb = kMask ? long_window_mask(mask, win, nW, Tq, Tk) : nullptr;
  // this lane's rows g and g + 8 in the bias and mask (past Tq: the last)
  const size_t off0 = static_cast<size_t>(min(q0 + r0 + gi, Tq - 1)) * Tk;
  const size_t off1 = static_cast<size_t>(min(q0 + r0 + gi + 8, Tq - 1)) * Tk;
  const int nk = (Tk + kMTile - 1) / kMTile;

  // the q rows pass through the second v buffer into registers
  tf32_stage(vs[1], q, wrow * Tq + q0, rows, kMRows, ldg, n0, hd, vec);
  tf32_stage(ks[0], k, wrow * Tk, min(kMTile, Tk), kMTile, ldg, n0, hd, vec);
  tf32_stage(vs[0], v, wrow * Tk, min(kMTile, Tk), kMTile, ldg, n0, hd, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qb[4][4], qsm[4][4];
  tf32_load_a(qb, qsm, vs[1], r0);
  __syncthreads();

  float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f};
  float o[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // the next tile's k and v load while this one runs
  for (int it = 0; it < nk; ++it) {
    if (it + 1 < nk) {
      const int k1 = (it + 1) * kMTile;
      const int kb = min(kMTile, Tk - k1);
      tf32_stage(ks[(it + 1) & 1], k, wrow * Tk + k1, kb, kMTile, ldg, n0, hd,
                 vec);
      tf32_stage(vs[(it + 1) & 1], v, wrow * Tk + k1, kb, kMTile, ldg, n0, hd,
                 vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = it * kMTile;
    const float* kt = ks[it & 1];
    const float* vt = vs[it & 1];
    // the halves that hold keys, for a warp with rows below Tq: the rest
    // would add nothing (p = 0 past Tk) and are skipped
    const int nh2 = r0 < rows ? min(kMTile, Tk - k0 + 31) / 32 : 0;
#pragma unroll 1
    for (int h = 0; h < 32 * nh2; h += 32) {
      float s[4][4];
      tf32_rows(s, qb, qsm, kt, h);
      mma_fix<kMask>(s, k0 + h, Tk, scale, hb, mb, off0, off1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the rows' max over the quad (a butterfly: all four lanes get the
        // same bits), the sum and the output rescaled to it
        float m = mx[r];
#pragma unroll
        for (int n = 0; n < 4; ++n)
          m = fmaxf(m, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        const float base = m == -INFINITY ? 0.f : m;
        const float f = __expf(mx[r] - base);
        float l = sm[r] * f;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          o[n][2 * r] *= f;
          o[n][2 * r + 1] *= f;
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float p = __expf(s[n][e] - base);
            l += p;
            s[n][e] = p;
          }
        sm[r] = l;
        mx[r] = m;
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) tf32_cols(o, s[n], vt, h + 8 * n);
    }
    __syncthreads();
  }
  // the rows' sums over the quad, in a butterfly; out = o / sum
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = sm[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      o[n][2 * r] *= inv;
      o[n][2 * r + 1] *= inv;
    }
  }
  tf32_store(out + n0, o, wrow * Tq + q0, r0, rows, ldg, hd, 1.f, vec);
}

}  // namespace gsasr

namespace {

// W-long, or with kMask WM-long (mask (nW, Tq, Tk), B a multiple of nW), or
// with kHM W4-long on the head-major layout; also A-long's fp32 attention
// launch. All f32.
template <bool kMask, bool kHM>
cudaError_t launch_fwd_long_tf32(const float* q, const float* k,
                                 const float* v, const float* bias,
                                 const float* mask, float* out, int B, int Tq,
                                 int Tk, int C, int nh, int nW, float scale,
                                 cudaStream_t st) {
  if (!gsasr::long_shape_ok(B, Tq, Tk, C, nh) || nW < 1 || B % nW != 0 ||
      (kMask && !mask))
    return cudaErrorInvalidValue;
  const void* ops[] = {q, k, v, out};
  const int vec = gsasr::tf32_vec(C / nh, ops, 4);
  return gsasr::for_window_chunks(B, nW, [&](int w0, int nb, int c0) {
    const size_t oq = gsasr::window_offset(w0, Tq, C);
    const size_t ok = gsasr::window_offset(w0, Tk, C);
    gsasr::window_attn_fwd_long_tf32_kernel<kMask, kHM>
        <<<dim3(nh, nb, (Tq + gsasr::kMRows - 1) / gsasr::kMRows),
           gsasr::kMThreads, 0, st>>>(
            q + oq, k + ok, v + ok, bias,
            gsasr::window_mask_from(mask, c0, Tq, Tk), out + oq, Tq, Tk, C,
            nh, nW, scale, vec);
  });
}

}  // namespace
