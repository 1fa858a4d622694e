// The fp32 window attention forward up to 160 tokens on Hopper's tensor
// cores in 3xTF32: the body of W (window_attn_fwd), with its template flags
// WM (kMask) and W4 (kHM), and kernel A's fp32 attention launch (ln_attn.cu,
// which AB's att reuses). It replaces the fp32 forms of _attn_kernel_packed
// (gsasr_tpu/ops/attention.py, Pallas K11: the paper decoder's 144-token
// windows, SwinIR's 64), of _attn_kernel_packed_masked (K13, SwinIR's
// shifted windows), of _attn_kernel (K14, the 4D layout) and the attention
// of _k_ln_attn (ops/fused_layers.py, K8) at Tq, Tk <= 160. Beyond 160
// tokens W-long's body (window_attn_long_tf32.cuh) runs; the bf16 forms
// run window_attn_short_mma.cuh. Per window w and head h:
//
//   s = q_h k_h^T * scale (+ bias[h]) (+ mask[w % nW])   (Tq x Tk, f32)
//   p = exp(s - max)                                     (f32, not rounded)
//   out[w, :, h*hd:(h+1)*hd] = (p v_h) / sum_j p          (f32)
//
// Bound on an H100: at the paper step's 256 windows x 6 heads x 144 x 144 x
// 30 the two products are 3.8 GFLOP, three TF32 products each in 3xTF32:
// 11.5 GFLOP, 0.023 ms at 495 TFLOP/s, against 106 MB of f32 q, k, v and
// out and 0.5 MB of bias (0.032 ms at 3.35 TB/s): bound by bytes; SwinIR's
// 576 windows x 64 tokens move 106 MB (and up to 9.4 MB of mask) for 5.1
// GFLOP of TF32: bound by bytes.
//
// Precision: W-long's (every product in 3xTF32 on the slots of
// tf32_frag.cuh, p and the sums f32 and rounded nowhere, the same online
// softmax); its steps of 32 keys start at other keys than W-long's 64-key
// tiles do past the first, so the two bodies' bits may differ in the last
// places. Every sum runs in one fixed order: two launches give the same
// bits. The body ignores torch.backends.cuda.matmul.allow_tf32.
//
// Design: W-bf16's short body (window_attn_short_mma.cuh) on the 3xTF32
// fragments, with W-long's online softmax. A block stages one (head,
// window)'s q, k and v whole, f32 at the stride of 36 floats (rows padded
// with zeros to a multiple of 16, head columns to 32): 62 KB at 144
// tokens. One warp takes 16 query rows (nine warps at 144 tokens, four at
// 64). Each warp splits its q rows once into their tf32 pairs and keeps
// them in shared memory in fragment order (4 KB a warp; a lane reads its
// big and small fragment of a k-step as two 16-byte loads). It then sweeps
// the keys once, 32 at a time with a 16-key tail (144 keys are four
// steps and a tail, 64 two steps: no padding to 64-key tiles): the scores
// (tf32_rows' products in the same order), fixed up as mma_fix forms them
// (the scale, then the bias, then the mask, each rounded on its own; -inf
// past Tk; bias and mask read from L2 in the accumulator layout), the
// rows' max joined over the quad in a butterfly, the sums and the output
// rescaled when it grows, p = exp(s - max), and o += p v from registers
// (tf32_cols: p's accumulator tile is the A fragment as it stands). At the
// end the quad's sums are joined and out = o / sum is stored (tf32_store).
// Each block takes one unit, grid (nh, B), heads fastest, so a window's
// rows are read by neighbouring blocks; every head's bias (0.5 MB at 144
// tokens) stays in L2.
//
// Registers and blocks: measured against other splits of the same
// function on one H100 (scripts/ab_torch_sources.py --fp32-only, builds in
// turns, back to back, the paper step's 256 x 6 x 144 x 30 with a bias):
// the whole score row in registers with q's pairs (148-166 registers, one
// block of nine warps an SM, a persistent grid and a second buffer) 0.271
// ms; the online sweep with q's pairs in registers, left free (120-124
// registers, one block an SM) 0.245 ms; the same held to two blocks an SM
// (96 registers) 0.186 ms, but it spilled 16-40 bytes. So q's pairs moved
// to shared memory and the kernel is held to two blocks of up to ten warps
// an SM (0.178 ms, 94 registers, no spill). The mask's flag (WM) still
// spilled 20 bytes there, so WM is held to one block: it runs SwinIR's
// windows of 64 tokens, four warps a block, where the registers, not that
// bound, set how many blocks share an SM. The ptxas counts of the final
// build are in PERF.md (K11's row).
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tf32_frag.cuh"
#include "window_attn_short_mma.cuh"

namespace gsasr {

// 16-byte fragments a warp keeps of its q rows: for each of the four
// k-steps, the big and the small tf32 values of every lane.
constexpr int kQFrag = 2 * 4 * 32;

// Floats of the short forward's shared memory: q (Tq rows), k and v (Tk
// rows) at kTLd, padded to 16 rows, then each warp's q fragments.
__host__ __device__ __forceinline__ size_t short_tf32_fwd_floats(int Tq,
                                                                int Tk) {
  return static_cast<size_t>(kTLd) * (short_rows(Tq) + 2 * short_rows(Tk)) +
         static_cast<size_t>(short_rows(Tq) / 16) * kQFrag * 4;
}

// tf32_rows with the A fragments read from this warp's q fragments in
// shared memory (qf: big of k-step j at j * 32 + lane, small at (4 + j) *
// 32 + lane): the same products in the same order.
template <int kN>
__device__ __forceinline__ void tf32_rows_qf(float (&acc)[kN][4],
                                             const uint4* qf,
                                             const float* tile, int r0) {
  const int lane = threadIdx.x & 31;
  const float* p = tile + (r0 + (lane >> 2)) * kTLd + 8 * (lane & 3);
#pragma unroll
  for (int n = 0; n < kN; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float4 b[kN];
#pragma unroll
    for (int n = 0; n < kN; ++n)
      b[n] = *reinterpret_cast<const float4*>(p + 8 * n * kTLd + 4 * h);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int j = 2 * h + s;
      const uint4 big = qf[j * 32 + lane];
      const uint4 small = qf[(4 + j) * 32 + lane];
      const uint32_t ab[4] = {big.x, big.y, big.z, big.w};
      const uint32_t as[4] = {small.x, small.y, small.z, small.w};
#pragma unroll
      for (int n = 0; n < kN; ++n)
        mma_3xtf32(acc[n], ab, as, s ? b[n].z : b[n].x,
                   s ? b[n].w : b[n].y);
    }
  }
}

// One step of the online sweep over 8 kN keys from key h: the scores, the
// rows' max joined over the quad, the sums and o rescaled when it grows,
// p = exp(s - max), o += p v.
template <bool kMask, int kN>
__device__ __forceinline__ void short_online_step(
    float (&o)[4][4], float (&mx)[2], float (&sm)[2], const uint4* qf,
    const float* ks, const float* vs, int h, int Tk, float scale,
    const float* hb, const float* mb, size_t off0, size_t off1) {
  float s[kN][4];
  tf32_rows_qf(s, qf, ks, h);
  mma_fix<kMask>(s, h, Tk, scale, hb, mb, off0, off1);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = mx[r];
#pragma unroll
    for (int n = 0; n < kN; ++n)
      m = fmaxf(m, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
    m = quad_max(m);
    const float base = m == -INFINITY ? 0.f : m;
    const float f = __expf(mx[r] - base);
    float l = sm[r] * f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      o[n][2 * r] *= f;
      o[n][2 * r + 1] *= f;
    }
#pragma unroll
    for (int n = 0; n < kN; ++n)
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
  for (int n = 0; n < kN; ++n) tf32_cols(o, s[n], vs, h + 8 * n);
}

// The forward, one block of 2 short_rows(Tq) threads per (head, window):
// q, k, v and out f32, packed (B, T, C) or with kHM head-major (B, nh, T,
// hd); bias (nh, Tq, Tk) or null; with kMask, mask (nW, Tq, Tk), window w
// taking mask[w % nW]. vec as tf32_vec gives it.
template <bool kMask, bool kHM>
__global__ void __launch_bounds__(kSMaxThreads, kMask ? 1 : 2)
window_attn_fwd_short_tf32_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  const float* __restrict__ bias,
                                  const float* __restrict__ mask,
                                  float* __restrict__ out, int Tq, int Tk,
                                  int C, int nh, int nW, float scale,
                                  int vec) {
  extern __shared__ __align__(16) float short_tf32_fwd_smem[];
  const int tq16 = short_rows(Tq);
  const int tk16 = short_rows(Tk);
  float* qs = short_tf32_fwd_smem;
  float* ks = qs + tq16 * kTLd;
  float* vs = ks + tk16 * kTLd;
  const int hd = C / nh;
  const int head = blockIdx.x;
  const int win = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int n0 = kHM ? 0 : head * hd;
  const int ldg = kHM ? hd : C;
  const size_t wrow = kHM ? static_cast<size_t>(win) * nh + head : win;
  const int r0 = warp * 16;
  uint4* qf = reinterpret_cast<uint4*>(vs + tk16 * kTLd) + warp * kQFrag;

  tf32_stage(qs, q, wrow * Tq, Tq, tq16, ldg, n0, hd, vec, blockDim.x);
  tf32_stage(ks, k, wrow * Tk, Tk, tk16, ldg, n0, hd, vec, blockDim.x);
  tf32_stage(vs, v, wrow * Tk, Tk, tk16, ldg, n0, hd, vec, blockDim.x);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  {
    // this warp's q rows as their tf32 pairs, in fragment order
    uint32_t qb[4][4], qsm[4][4];
    tf32_load_a(qb, qsm, qs, r0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      qf[j * 32 + lane] = make_uint4(qb[j][0], qb[j][1], qb[j][2], qb[j][3]);
      qf[(4 + j) * 32 + lane] =
          make_uint4(qsm[j][0], qsm[j][1], qsm[j][2], qsm[j][3]);
    }
    __syncwarp();
  }

  const float* hb =
      bias ? bias + static_cast<size_t>(head) * Tq * Tk : nullptr;
  const float* mb = kMask ? long_window_mask(mask, win, nW, Tq, Tk) : nullptr;
  // this lane's rows g and g + 8 in the bias and mask (past Tq: the last)
  const size_t off0 = static_cast<size_t>(min(r0 + g, Tq - 1)) * Tk;
  const size_t off1 = static_cast<size_t>(min(r0 + g + 8, Tq - 1)) * Tk;
  float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f};
  float o[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  int h = 0;
#pragma unroll 1
  for (; h + 32 <= tk16; h += 32)
    short_online_step<kMask, 4>(o, mx, sm, qf, ks, vs, h, Tk, scale, hb, mb,
                                off0, off1);
  if (h < tk16)
    short_online_step<kMask, 2>(o, mx, sm, qf, ks, vs, h, Tk, scale, hb, mb,
                                off0, off1);
  // out = o / sum, the quad's sums joined in a butterfly
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / quad_sum(sm[r]);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      o[n][2 * r] *= inv;
      o[n][2 * r + 1] *= inv;
    }
  }
  tf32_store(out + n0, o, wrow * Tq, r0, Tq, ldg, hd, 1.f, vec);
}

}  // namespace gsasr

namespace {

// W, or with kMask WM (mask (nW, Tq, Tk), B a multiple of nW), or with kHM
// W4 on the head-major layout, at Tq, Tk <= kMaxT; also A's fp32 attention
// launch. All f32.
template <bool kMask, bool kHM>
cudaError_t launch_fwd_short_tf32(const float* q, const float* k,
                                  const float* v, const float* bias,
                                  const float* mask, float* out, int B,
                                  int Tq, int Tk, int C, int nh, int nW,
                                  float scale, cudaStream_t st) {
  if (!gsasr::short_shape_ok(B, Tq, Tk, C, nh, nW) || (kMask && !mask))
    return cudaErrorInvalidValue;
  const void* ops[] = {q, k, v, out};
  const int vec = gsasr::tf32_vec(C / nh, ops, 4);
  const size_t smem = sizeof(float) * gsasr::short_tf32_fwd_floats(Tq, Tk);
  const auto kernel = gsasr::window_attn_fwd_short_tf32_kernel<kMask, kHM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return gsasr::for_window_chunks(B, nW, [&](int w0, int nb, int c0) {
    const size_t oq = gsasr::window_offset(w0, Tq, C);
    const size_t ok = gsasr::window_offset(w0, Tk, C);
    kernel<<<dim3(nh, nb), 2 * gsasr::short_rows(Tq), smem, st>>>(
        q + oq, k + ok, v + ok, bias,
        gsasr::window_mask_from(mask, c0, Tq, Tk), out + oq, Tq, Tk, C, nh,
        nW, scale, vec);
  });
}

}  // namespace
