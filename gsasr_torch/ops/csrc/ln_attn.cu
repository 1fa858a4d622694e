// Kernel A: fused pre-norm multi-head attention with its out-projection.
//
// Replaces _k_ln_attn of gsasr_tpu/ops/fused_layers.py (ln_attn_proj):
//
//   xq  = LN(x) (+ pos)                       LN statistics in f32
//   src = kv (cross-attention, un-normed) | xq (self-attention)
//   q = rope?(xq Wq^T + bq), k = rope?(src Wk^T + bk), v = src Wv^T + bv
//   att_h = softmax(q_h k_h^T * scale + bias[h]) v_h
//   out = att Wo^T + bo
//
// rope (the Enhanced family) rotates each (even, odd) column pair in f32,
// x * cos + (-odd, even) * sin, with pair-duplicated (T, C) tables. x, pos,
// kv and out are float or bfloat16; in bfloat16 the kernel rounds where
// _k_ln_attn rounds: xq, the weights as they are staged, q and k after the
// rotation, v, the probabilities, att and the result. Scores, softmax and
// sums stay f32.
//
// What bounds it on an H100: the products, 2 * windows * (4 T C^2 + 2 T^2
// C) operations (11.8 GFLOP at 225 windows x 144 tokens x 180 channels,
// 13.4 at 192). In float32 every product runs in 3xTF32, three TF32
// products each: 35.4 GFLOP against 495 TFLOP/s, 0.071 ms, beside 70 MB of
// row tensors (0.021 ms). In bfloat16 the products take 14 us at 989
// TFLOP/s and the bytes (x, kv, out and the bias) about as long.
//
// Design: three launches, the same for A (windows of up to 160 tokens) and
// A-long (any length; the Ultra and SwinIR-Enhanced decoders' 256 seeds in
// windows of 16). (1) One block per 128 rows and projection (grid.y: q,
// k, v) normalizes its rows once (+ pos; the kv rows of cross-attention are
// read as they are), forms that projection for all heads at once on the
// tensor cores (tile_mma.cuh: 3xTF32 in fp32, bf16 operands in bf16), adds
// the bias, rotates q and k (RoPE: the pair partner sits in the same
// thread) and rounds q, k, v to the activation type into scratch. The LN
// and the reads of x happen once per projection, not once per head as in
// the fused per-(window, head) kernel this replaces. (2) The attention of
// each (window, head) on that scratch runs an existing tensor-core body:
// in fp32 W-long's 3xTF32 body (window_attn_long_tf32.cuh) at every
// length; in bf16 W-bf16's body up to 160 tokens
// (window_attn_short_mma.cuh) and W-long-bf16's beyond
// (window_attn_long_mma.cuh), both rounding the normalized p before the PV
// product and att as it is stored. (3) The out-projection is the same tile
// product over the att rows, plus the bias. The rounding points are those
// of _k_ln_attn.

#include <cuda_runtime.h>

#include <type_traits>

#include "ln_qkv.cuh"
#include "tile_mma.cuh"
#include "window_attn_long_mma.cuh"
#include "window_attn_long_tf32.cuh"
#include "window_attn_short_mma.cuh"

namespace {

using namespace gsasr;

// Phase 3: out = att Wo^T + bo over 128 rows of att (the activation type).
template <typename Act>
__global__ void __launch_bounds__(kTThreads, 1)
out_proj_kernel(const Act* __restrict__ att, const float* __restrict__ wo,
                const float* __restrict__ bo, Act* __restrict__ out, int M,
                int C, int vec) {
  using P = typename TileOf<Act>::type;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  auto* rows = reinterpret_cast<typename P::Row*>(tile_smem);
  const int row0 = blockIdx.x * kTRows;
  tile_load_rows<P>(rows, att, row0, M, C, vec);
  float acc[kTNT][4];
  tile_mma<P>(rows, wo, C, C, tile_smem, acc);
  float* stage = tile_stage<P>(tile_smem);
  tile_stage_acc(acc, stage);
  __syncthreads();
  const int nr = M - row0 < kTRows ? M - row0 : kTRows;
  if (vec) {
    const int q4 = C / 4;
#pragma unroll 4
    for (int e = threadIdx.x; e < nr * q4; e += kTThreads) {
      const int r = e / q4;
      const int c = 4 * (e - r * q4);
      const float4 v = ld4(stage + r * kTLdS + c);
      const float4 bb = ld4(bo + c);
      st4(out + static_cast<size_t>(row0 + r) * C + c,
          make_float4(v.x + bb.x, v.y + bb.y, v.z + bb.z, v.w + bb.w));
    }
    return;
  }
  for (int e = threadIdx.x; e < nr * C; e += kTThreads) {
    const int r = e / C;
    const int n = e - r * C;
    out[static_cast<size_t>(row0 + r) * C + n] =
        from_f32<Act>(stage[r * kTLdS + n] + bo[n]);
  }
}

// The three launches; `short_body` takes W-bf16's body for the bf16
// attention (A: Tq, Tk <= kMaxT), else W-long-bf16's.
template <typename Act>
int launch(const Act* x, const Act* pos, const Act* kv, const float* ln_w,
           const float* ln_b, const float* wq, const float* bq,
           const float* wk, const float* bk, const float* wv, const float* bv,
           const float* wo, const float* bo, const float* bias,
           const float* cos_q, const float* sin_q, const float* cos_k,
           const float* sin_k, Act* qs, Act* ks, Act* vs, Act* att, Act* out,
           int B, int Tq, int Tk, int C, int nh, float scale, bool short_body,
           cudaStream_t st) {
  constexpr size_t smem = tile_smem_bytes<typename TileOf<Act>::type>();
  cudaError_t err = tile_prepare(ln_qkv_kernel<Act>, smem);
  if (err == cudaSuccess) err = tile_prepare(out_proj_kernel<Act>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (B * (Tq > Tk ? Tq : Tk) + kTRows - 1) / kTRows;
  const int vec1 =
      C % 4 == 0 && tile_aligned({kv, bq, bk, bv, cos_q, sin_q, cos_k, sin_k,
                                  qs, ks, vs});
  ln_qkv_kernel<Act><<<dim3(tiles, 3), kTThreads, smem, st>>>(
      x, pos, kv, ln_w, ln_b, wq, bq, wk, bk, wv, bv, cos_q, sin_q, cos_k,
      sin_k, qs, ks, vs, B, Tq, Tk, C, vec1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (std::is_same_v<Act, __nv_bfloat16>) {
    err = short_body
              ? launch_fwd_short_mma<false, false>(qs, ks, vs, bias, nullptr,
                                                   att, B, Tq, Tk, C, nh, 1,
                                                   scale, st)
              : launch_fwd_long_mma<false, false>(qs, ks, vs, bias, nullptr,
                                                  att, B, Tq, Tk, C, nh, 1,
                                                  scale, st);
  } else {
    err = launch_fwd_long_tf32<false, false>(qs, ks, vs, bias, nullptr, att,
                                             B, Tq, Tk, C, nh, 1, scale, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = B * Tq;
  const int vec3 = C % 4 == 0 && tile_aligned({att, bo, out});
  out_proj_kernel<Act><<<(M + kTRows - 1) / kTRows, kTThreads, smem, st>>>(
      att, wo, bo, out, M, C, vec3);
  return static_cast<int>(cudaGetLastError());
}

// What both entry points take, beside the window length.
bool shape_ok(int B, int Tq, int Tk, int C, int nh, const void* kv,
              const float* cos_q, const float* sin_q, const float* cos_k,
              const float* sin_k, int bf16) {
  const bool rope = cos_q != nullptr;
  return long_shape_ok(B, Tq, Tk, C, nh) && C <= kMaxN &&
         C <= 32 * kLnPer && (kv || Tk == Tq) && rope == (sin_q != nullptr) &&
         rope == (cos_k != nullptr) && rope == (sin_k != nullptr) &&
         !((rope || bf16) && (C / nh) % 2 != 0);
}

int dispatch(const void* x, const void* pos, const void* kv,
             const float* ln_w, const float* ln_b, const float* wq,
             const float* bq, const float* wk, const float* bk,
             const float* wv, const float* bv, const float* wo,
             const float* bo, const float* bias, const float* cos_q,
             const float* sin_q, const float* cos_k, const float* sin_k,
             void* qs, void* ks, void* vs, void* att, void* out, int B,
             int Tq, int Tk, int C, int nh, int bf16, float scale,
             bool short_body, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    return launch<T>(static_cast<const T*>(x), static_cast<const T*>(pos),
                     static_cast<const T*>(kv), ln_w, ln_b, wq, bq, wk, bk,
                     wv, bv, wo, bo, bias, cos_q, sin_q, cos_k, sin_k,
                     static_cast<T*>(qs), static_cast<T*>(ks),
                     static_cast<T*>(vs), static_cast<T*>(att),
                     static_cast<T*>(out), B, Tq, Tk, C, nh, scale,
                     short_body, st);
  }
  return launch<float>(
      static_cast<const float*>(x), static_cast<const float*>(pos),
      static_cast<const float*>(kv), ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo,
      bo, bias, cos_q, sin_q, cos_k, sin_k, static_cast<float*>(qs),
      static_cast<float*>(ks), static_cast<float*>(vs),
      static_cast<float*>(att), static_cast<float*>(out), B, Tq, Tk, C, nh,
      scale, short_body, st);
}

}  // namespace

// x, out (B, Tq, C) and kv (B, Tk, C) or null (self-attention, Tk == Tq),
// pos (Tq, C) or null: float, or bfloat16 when bf16 is set, Tq, Tk <=
// kMaxT (160). bias (nh, Tq, Tk) or null; cos_q, sin_q (Tq, C) and cos_k,
// sin_k (Tk, C), all four or none, pair-duplicated; weights (C, C)
// row-major as nn.Linear stores them: float. qs (B, Tq, C), ks and vs (B,
// Tk, C) and att (B, Tq, C), of the activation type, are scratch the
// caller allocates.
extern "C" int ln_attn(const void* x, const void* pos, const void* kv,
                       const float* ln_w, const float* ln_b, const float* wq,
                       const float* bq, const float* wk, const float* bk,
                       const float* wv, const float* bv, const float* wo,
                       const float* bo, const float* bias, const float* cos_q,
                       const float* sin_q, const float* cos_k,
                       const float* sin_k, void* qs, void* ks, void* vs,
                       void* att, void* out, int B, int Tq, int Tk, int C,
                       int nh, int bf16, float scale, void* stream) {
  if (!shape_ok(B, Tq, Tk, C, nh, kv, cos_q, sin_q, cos_k, sin_k, bf16) ||
      Tq > kMaxT || Tk > kMaxT)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(x, pos, kv, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo,
                  bias, cos_q, sin_q, cos_k, sin_k, qs, ks, vs, att, out, B,
                  Tq, Tk, C, nh, bf16, scale, true, stream);
}

// Kernel A-long: as ln_attn for windows of any Tq and Tk (the window-16
// form).
extern "C" int ln_attn_long(const void* x, const void* pos, const void* kv,
                            const float* ln_w, const float* ln_b,
                            const float* wq, const float* bq, const float* wk,
                            const float* bk, const float* wv, const float* bv,
                            const float* wo, const float* bo,
                            const float* bias, const float* cos_q,
                            const float* sin_q, const float* cos_k,
                            const float* sin_k, void* qs, void* ks, void* vs,
                            void* att, void* out, int B, int Tq, int Tk,
                            int C, int nh, int bf16, float scale,
                            void* stream) {
  if (!shape_ok(B, Tq, Tk, C, nh, kv, cos_q, sin_q, cos_k, sin_k, bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(x, pos, kv, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo,
                  bias, cos_q, sin_q, cos_k, sin_k, qs, ks, vs, att, out, B,
                  Tq, Tk, C, nh, bf16, scale, false, stream);
}
