// Kernel W: packed multi-head window attention, forward; with kMask, kernel
// WM, its masked form; with bfloat16 operands, kernels W-bf16 and WM-bf16;
// and W-long, W-long-bf16, WM-long and WM-long-bf16, the window-16 forms
// of all four; and W4 and W4-bf16, W's and W-long's bodies on the
// head-major layout (the 4D form).
//
// W replaces _attn_kernel_packed of gsasr_tpu/ops/attention.py (reached
// from _attention_packed_pallas, the forward of window_attention_packed
// without a mask) with float32 operands, and W-bf16 the same body with
// bfloat16 operands (the Enhanced decoder's bf16 module path, through
// _sdpa_packed); WM replaces _attn_kernel_packed_masked (reached from
// _attention_packed_pallas_masked, the forward with a window_mask), and
// WM-bf16 the same body with bfloat16 operands (SwinIR's shifted blocks at
// the bf16 recipe, train_swinir_amp.yml). Per
// window w and head h, on the packed (B, T, C) layout where head h is
// columns [h*hd, (h+1)*hd):
//
//   s = q_h k_h^T * scale + bias[h] (+ mask[w % nW])    (Tq x Tk, f32)
//   p = softmax(s) with the row max subtracted
//   out[w, :, h*hd:(h+1)*hd] = p v_h
//
// In bfloat16 the scores, the row max and the softmax are f32 (products
// of bf16 values are exact in f32), p is rounded to bfloat16 once, to the
// nearest even, before the PV product (`p.astype(v.dtype)` of the Pallas
// body), the product accumulates in f32 and out is rounded to bfloat16.
//
// What bounds it on an H100: the two products, 4 * B * nh * Tq * Tk * hd
// FP32 operations (3.8 GFLOP at 256 windows x 6 heads x 144 x 144 x 30)
// against 67 TFLOP/s; the bytes (q, k, v and out, 106 MB) take less than
// half as long at 3.35 TB/s, and the exps (32 M) far less. WM at a Swin
// shape (576 windows x 6 heads x 64 x 64 x 30) does 1.7 GFLOP on 106 MB
// plus the 9.4 MB mask, so it is bound by bytes. W-bf16 at the Enhanced
// training shape (256 windows x 6 heads x 144 x 144 x 32) does 4.1 GFLOP,
// 0.004 ms at the bf16 tensor-core peak, on 57 MB of bf16 q, k, v and out,
// 0.017 ms: bound by bytes. It runs the same f32 FMAs on the CUDA cores as
// W, so its time is W's less the halved loads.
//
// Design. One 256-thread block per (window, head), so heads are sliced by
// column offset straight from the packed layout and no head transpose is
// written to memory. The block stages its q_h, k_h and v_h (Tq, Tk x hd,
// rows padded to an odd stride) in shared memory as f32 (bfloat16 widened
// as it is staged), about 54 KB at T = 144.
// Each warp takes four query rows at a time and holds their scores in
// registers (lane l owns keys l + 32 m, so Tk <= 160), takes the softmax
// with warp reductions, writes the probabilities to a per-warp row buffer
// (rounded to the operand type) and multiplies them by v_h with lane d
// owning output column d. Each (window, head) writes only its own columns,
// so no atomics are needed and the result is deterministic. WM reads its
// window class's mask rows from device memory beside the bias rows (the
// six heads of a window read the same rows, which stay in L2); the JAX
// kernel's padding of the window-class period is not needed, since a block
// takes one window, not a block of them. The mask and the operand type are
// template parameters of the body that W, W-bf16 and WM share; they are
// three kernels, each with its own launch bounds, so W compiles as without
// the mask or the rounding.
//
// W-long and W-long-bf16 are the window-16 form (HAT's 144 windows x 6
// heads x 256 x 256, and OCAB's 256 queries x 576 keys, head width 32,
// no bias), for any Tq and Tk. W-long runs the body of
// window_attn_long.cuh, which walks the keys in tiles in two passes and
// recomputes the scores in the second, three products of 2 * B * nh * Tq *
// Tk * hd operations each where the bound counts two: 7.2 GFLOP (HAB) and
// 16.3 GFLOP (OCAB) against 67 TFLOP/s, 0.108 and 0.243 ms, over 113 and
// 193 MB of q, k, v and out at 3.35 TB/s, 0.034 and 0.058 ms. Bound by
// operations. W-long-bf16 (and WM-long-bf16, W4-long-bf16 by its flags)
// runs the same two passes on the tensor cores, bf16 operands staged in
// bf16 (window_attn_long_mma.cuh): bound by bytes.
//
// WM-long and WM-long-bf16 replace _attn_kernel_packed_masked beyond 160
// tokens: the paper HAT's shifted windows of 16 (144 windows x 6 heads x
// 256 x 256 x 30, with a bias and the SW-MSA mask of period 9 or 144), the
// same body with the mask added after the bias in each pass (a template
// flag, so W-long and A-long keep their code). WM-long does 6.8 GFLOP,
// 0.10 ms at the FP32 peak; WM-long-bf16 moves 53 MB of bf16 q, k, v and
// out, 1.6 MB of bias and up to 38 MB of mask (period 144), 0.027 ms:
// bound by bytes. WM-bf16 at SwinIR's shape (576 windows, T 64) moves 53
// MB of bf16 operands and up to 9.4 MB of mask: bound by bytes too.
//
// W4 and W4-bf16 (window_attn_fwd_4d[_bf16]) replace _attn_kernel of
// gsasr_tpu/ops/attention.py (reached from _attention_pallas, the forward
// of window_attention and fused_window_attention): the same function on
// the JAX package's 4D layout, q and out (B, nh, Tq, hd), k and v (B, nh,
// Tk, hd), with the rounding of K11's body (p to v's type before the PV
// product, out in q's type). Its bounds are W's and W-long's at the same
// shapes: operations in fp32, bytes in bf16. The head-major flag (kHM) of
// the bodies changes only where a head lies: head h of window w is rows
// (w nh + h) T of hd, contiguous, instead of columns h hd of every packed
// row, so the kernels read the 4D operands in place and no transpose to
// the packed layout is made; up to 160 tokens W's body, beyond it
// W-long's. Each is a kernel of its own, so W's and W-long's code does
// not move.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "window_attn.cuh"
#include "window_attn_long.cuh"
#include "window_attn_long_mma.cuh"

namespace {

using gsasr::HeadLayout;
using gsasr::kKeysPer;
using gsasr::kMaxHd;
using gsasr::kMaxT;
using gsasr::kQRows;
using gsasr::kThreads;
using gsasr::kWarps;
using gsasr::from_f32;
using gsasr::rnd;
using gsasr::softmax_exp_row;
using gsasr::stage_head;
using gsasr::window_mask;

// q_h, k_h, v_h and the per-warp probability rows.
__host__ __device__ size_t smem_bytes(const HeadLayout& L, int Tk) {
  return sizeof(float) *
         (L.q_floats + 2 * L.kv_floats + static_cast<size_t>(kWarps) * kQRows * Tk);
}

// The body of W (kMask false, T float), W-bf16 (T __nv_bfloat16), WM
// (kMask true, T float) and WM-bf16 (kMask true, T __nv_bfloat16), one
// block per (head, window); with kHM, of W4 and W4-bf16 on the head-major
// (B, nh, T, hd) layout.
template <bool kMask, typename T, bool kHM = false>
__device__ __forceinline__ void window_attn_fwd_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ mask,
    T* __restrict__ out, int Tq, int Tk, int C, int nh, int nW, float scale) {
  extern __shared__ float smem[];
  const int hd = C / nh;
  const HeadLayout L(Tq, Tk, hd);
  float* qs = smem;
  float* ks = qs + L.q_floats;
  float* vs = ks + L.kv_floats;
  const int head = blockIdx.x;
  const int win = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = kHM ? 0 : head * hd;
  const int ldg = kHM ? hd : C;
  const size_t wrow = kHM ? static_cast<size_t>(win) * nh + head : win;
  float* prow = vs + L.kv_floats + warp * kQRows * Tk;

  stage_head(q, wrow * Tq, Tq, ldg, n0, hd, qs, L.ld);
  stage_head(k, wrow * Tk, Tk, ldg, n0, hd, ks, L.ld);
  stage_head(v, wrow * Tk, Tk, ldg, n0, hd, vs, L.ld);
  __syncthreads();

  const float* hbias = bias ? bias + static_cast<size_t>(head) * Tq * Tk : nullptr;
  const float* wmask = kMask ? window_mask(mask, win, nW, Tq, Tk) : nullptr;
  for (int i0 = warp * kQRows; i0 < Tq; i0 += kWarps * kQRows) {
    float s[kQRows][kKeysPer];
#pragma unroll
    for (int r = 0; r < kQRows; ++r)
#pragma unroll
      for (int m = 0; m < kKeysPer; ++m) s[r][m] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qd[kQRows];
#pragma unroll
      for (int r = 0; r < kQRows; ++r) qd[r] = qs[min(i0 + r, Tq - 1) * L.ld + d];
#pragma unroll
      for (int m = 0; m < kKeysPer; ++m) {
        const float kd = ks[min(lane + 32 * m, Tk - 1) * L.ld + d];
#pragma unroll
        for (int r = 0; r < kQRows; ++r) s[r][m] = fmaf(qd[r], kd, s[r][m]);
      }
    }
#pragma unroll
    for (int r = 0; r < kQRows; ++r) {
      const int i = min(i0 + r, Tq - 1);
      const float sum = softmax_exp_row<kMask>(
          s[r], hbias ? hbias + static_cast<size_t>(i) * Tk : nullptr, Tk,
          scale, kMask ? wmask + static_cast<size_t>(i) * Tk : nullptr);
#pragma unroll
      for (int m = 0; m < kKeysPer; ++m) {
        const int j = lane + 32 * m;
        if (j < Tk) prow[r * Tk + j] = rnd<T>(s[r][m] / sum);
      }
    }
    __syncwarp();
    if (lane < hd) {
      float o[kQRows] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < Tk; ++j) {
        const float vj = vs[j * L.ld + lane];
#pragma unroll
        for (int r = 0; r < kQRows; ++r) o[r] = fmaf(prow[r * Tk + j], vj, o[r]);
      }
#pragma unroll
      for (int r = 0; r < kQRows; ++r) {
        if (i0 + r < Tq)
          out[(wrow * Tq + i0 + r) * ldg + n0 + lane] = from_f32<T>(o[r]);
      }
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
window_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ bias,
                       const float* __restrict__ mask, float* __restrict__ out,
                       int Tq, int Tk, int C, int nh, int nW, float scale) {
  window_attn_fwd_body<false, float>(q, k, v, bias, mask, out, Tq, Tk, C,
                                     nh, nW, scale);
}

__global__ void __launch_bounds__(kThreads)
window_attn_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const float* __restrict__ bias,
                            const float* __restrict__ mask,
                            __nv_bfloat16* __restrict__ out, int Tq, int Tk,
                            int C, int nh, int nW, float scale) {
  window_attn_fwd_body<false, __nv_bfloat16>(q, k, v, bias, mask, out, Tq, Tk,
                                             C, nh, nW, scale);
}

// WM is held to four blocks per SM (64 registers): left free, the
// compiler gives it 105 registers, two blocks per SM, and a slower kernel.
// W keeps its own bounds, so its code does not move.
__global__ void __launch_bounds__(kThreads, 4)
window_attn_fwd_masked_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ bias,
                              const float* __restrict__ mask,
                              float* __restrict__ out, int Tq, int Tk, int C,
                              int nh, int nW, float scale) {
  window_attn_fwd_body<true, float>(q, k, v, bias, mask, out, Tq, Tk, C, nh,
                                    nW, scale);
}

// WM-bf16, held to four blocks per SM as WM is.
__global__ void __launch_bounds__(kThreads, 4)
window_attn_fwd_masked_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                   const __nv_bfloat16* __restrict__ k,
                                   const __nv_bfloat16* __restrict__ v,
                                   const float* __restrict__ bias,
                                   const float* __restrict__ mask,
                                   __nv_bfloat16* __restrict__ out, int Tq,
                                   int Tk, int C, int nh, int nW,
                                   float scale) {
  window_attn_fwd_body<true, __nv_bfloat16>(q, k, v, bias, mask, out, Tq, Tk,
                                            C, nh, nW, scale);
}

// W4 (T float) and W4-bf16 (T __nv_bfloat16): W's body on the head-major
// (B, nh, T, hd) layout, a kernel of its own, so W's code does not move.
template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attn_fwd_4d_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ bias,
                          const float* __restrict__ mask, T* __restrict__ out,
                          int Tq, int Tk, int C, int nh, int nW, float scale) {
  window_attn_fwd_body<false, T, true>(q, k, v, bias, mask, out, Tq, Tk, C,
                                       nh, nW, scale);
}

// The kernel of a form: W, W-bf16, WM or WM-bf16; with kHM, W4 or W4-bf16.
template <bool kMask, typename T, bool kHM = false>
constexpr auto fwd_kernel() {
  constexpr bool kF32 = std::is_same_v<T, float>;
  if constexpr (kHM)
    return window_attn_fwd_4d_kernel<T>;
  else if constexpr (kMask && kF32)
    return window_attn_fwd_masked_kernel;
  else if constexpr (kMask)
    return window_attn_fwd_masked_bf16_kernel;
  else if constexpr (kF32)
    return window_attn_fwd_kernel;
  else
    return window_attn_fwd_bf16_kernel;
}

template <bool kMask, typename T, bool kHM = false>
cudaError_t launch_fwd(const T* q, const T* k, const T* v, const float* bias,
                       const float* mask, T* out, int B, int Tq, int Tk, int C,
                       int nh, int nW, float scale, cudaStream_t st) {
  if (B < 1 || Tq < 1 || Tk < 1 || nh < 1 || C % nh != 0 || C / nh > kMaxHd ||
      Tq > kMaxT || Tk > kMaxT || nW < 1 || B % nW != 0)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(HeadLayout(Tq, Tk, C / nh), Tk);
  const auto kernel = fwd_kernel<kMask, T, kHM>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nh, B), kThreads, smem, st>>>(
      q, k, v, bias, mask, out, Tq, Tk, C, nh, nW, scale);
  return cudaGetLastError();
}

// W-long (fp32; W-long-bf16 is window_attn_long_mma.cuh's kernel).
template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attn_fwd_long_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const float* __restrict__ bias,
                            T* __restrict__ out, int Tq, int Tk, int C, int nh,
                            float scale) {
  gsasr::window_attn_fwd_long_body<T>(q, k, v, bias, out, Tq, Tk, C, nh,
                                      scale);
}

// WM-long (fp32): W-long's body with the mask; a kernel of its own, so
// W-long's does not move.
template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attn_fwd_long_masked_kernel(const T* __restrict__ q,
                                   const T* __restrict__ k,
                                   const T* __restrict__ v,
                                   const float* __restrict__ bias,
                                   const float* __restrict__ mask,
                                   T* __restrict__ out, int Tq, int Tk, int C,
                                   int nh, int nW, float scale) {
  gsasr::window_attn_fwd_long_body<T, true>(q, k, v, bias, out, Tq, Tk, C,
                                            nh, scale, mask, nW);
}

// W4-long (fp32): W-long's body on the head-major (B, nh, T, hd) layout, a
// kernel of its own.
template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attn_fwd_4d_long_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const float* __restrict__ bias,
                               T* __restrict__ out, int Tq, int Tk, int C,
                               int nh, float scale) {
  gsasr::window_attn_fwd_long_body<T, false, true>(q, k, v, bias, out, Tq, Tk,
                                                   C, nh, scale);
}

// The unmasked window-16 kernel: W-long's, or with kHM W4-long's.
template <typename T, bool kHM>
constexpr auto long_kernel() {
  if constexpr (kHM)
    return window_attn_fwd_4d_long_kernel<T>;
  else
    return window_attn_fwd_long_kernel<T>;
}

// W-long, or with a mask (nW, Tq, Tk; B a multiple of nW) WM-long; with
// kHM, W4-long on the head-major layout.
template <typename T, bool kHM = false>
cudaError_t launch_fwd_long(const T* q, const T* k, const T* v,
                            const float* bias, T* out, int B, int Tq, int Tk,
                            int C, int nh, float scale, cudaStream_t st,
                            const float* mask = nullptr, int nW = 1) {
  if (!gsasr::long_shape_ok(B, Tq, Tk, C, nh) || nW < 1 || B % nW != 0)
    return cudaErrorInvalidValue;
  const size_t smem = gsasr::long_smem_bytes(C / nh);
  const dim3 grid = gsasr::long_grid(nh, B, Tq);
  cudaError_t err;
  if (mask) {
    err = cudaFuncSetAttribute(window_attn_fwd_long_masked_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    window_attn_fwd_long_masked_kernel<T><<<grid, kThreads, smem, st>>>(
        q, k, v, bias, mask, out, Tq, Tk, C, nh, nW, scale);
    return cudaGetLastError();
  }
  const auto kernel = long_kernel<T, kHM>();
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(q, k, v, bias, out, Tq, Tk, C, nh,
                                       scale);
  return cudaGetLastError();
}

}  // namespace

// q, out (B, Tq, C); k, v (B, Tk, C); bias (nh, Tq, Tk) or null; all float32,
// contiguous, on the device.
extern "C" int window_attn_fwd(const float* q, const float* k, const float* v,
                               const float* bias, float* out, int B, int Tq,
                               int Tk, int C, int nh, float scale,
                               void* stream) {
  return static_cast<int>(launch_fwd<false, float>(
      q, k, v, bias, nullptr, out, B, Tq, Tk, C, nh, 1, scale,
      static_cast<cudaStream_t>(stream)));
}

// Kernel W-bf16: as window_attn_fwd with q, k, v and out bfloat16; bias
// (nh, Tq, Tk) float32 or null.
extern "C" int window_attn_fwd_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, const float* bias,
                                    __nv_bfloat16* out, int B, int Tq, int Tk,
                                    int C, int nh, float scale, void* stream) {
  return static_cast<int>(launch_fwd<false, __nv_bfloat16>(
      q, k, v, bias, nullptr, out, B, Tq, Tk, C, nh, 1, scale,
      static_cast<cudaStream_t>(stream)));
}

// Kernel WM: as window_attn_fwd, plus mask (nW, Tq, Tk) float32, window w
// taking mask[w % nW]; B must be a multiple of nW.
extern "C" int window_attn_fwd_masked(const float* q, const float* k,
                                      const float* v, const float* bias,
                                      const float* mask, float* out, int B,
                                      int Tq, int Tk, int C, int nh, int nW,
                                      float scale, void* stream) {
  return static_cast<int>(launch_fwd<true, float>(
      q, k, v, bias, mask, out, B, Tq, Tk, C, nh, nW, scale,
      static_cast<cudaStream_t>(stream)));
}

// Kernel WM-bf16: as window_attn_fwd_masked with q, k, v and out
// bfloat16; bias and mask float32.
extern "C" int window_attn_fwd_masked_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const float* bias, const float* mask, __nv_bfloat16* out, int B, int Tq,
    int Tk, int C, int nh, int nW, float scale, void* stream) {
  return static_cast<int>(launch_fwd<true, __nv_bfloat16>(
      q, k, v, bias, mask, out, B, Tq, Tk, C, nh, nW, scale,
      static_cast<cudaStream_t>(stream)));
}

// Kernel W-long: as window_attn_fwd for any Tq and Tk (the window-16 form).
extern "C" int window_attn_fwd_long(const float* q, const float* k,
                                    const float* v, const float* bias,
                                    float* out, int B, int Tq, int Tk, int C,
                                    int nh, float scale, void* stream) {
  return static_cast<int>(launch_fwd_long<float>(
      q, k, v, bias, out, B, Tq, Tk, C, nh, scale,
      static_cast<cudaStream_t>(stream)));
}

// Kernel W-long-bf16: as window_attn_fwd_bf16 for any Tq and Tk (the
// tensor-core body).
extern "C" int window_attn_fwd_long_bf16(const __nv_bfloat16* q,
                                         const __nv_bfloat16* k,
                                         const __nv_bfloat16* v,
                                         const float* bias,
                                         __nv_bfloat16* out, int B, int Tq,
                                         int Tk, int C, int nh, float scale,
                                         void* stream) {
  return static_cast<int>(launch_fwd_long_mma<false, false>(
      q, k, v, bias, nullptr, out, B, Tq, Tk, C, nh, 1, scale,
      static_cast<cudaStream_t>(stream)));
}

// Kernel WM-long: as window_attn_fwd_masked for any Tq and Tk.
extern "C" int window_attn_fwd_long_masked(const float* q, const float* k,
                                           const float* v, const float* bias,
                                           const float* mask, float* out,
                                           int B, int Tq, int Tk, int C,
                                           int nh, int nW, float scale,
                                           void* stream) {
  if (!mask) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_fwd_long<float>(
      q, k, v, bias, out, B, Tq, Tk, C, nh, scale,
      static_cast<cudaStream_t>(stream), mask, nW));
}

// Kernel WM-long-bf16: as window_attn_fwd_masked_bf16 for any Tq and Tk
// (the tensor-core body with its mask flag).
extern "C" int window_attn_fwd_long_masked_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const float* bias, const float* mask, __nv_bfloat16* out, int B, int Tq,
    int Tk, int C, int nh, int nW, float scale, void* stream) {
  if (!mask) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_fwd_long_mma<true, false>(
      q, k, v, bias, mask, out, B, Tq, Tk, C, nh, nW, scale,
      static_cast<cudaStream_t>(stream)));
}

// Kernel W4 (K14): window attention on the head-major layout, q, out (B, nh,
// Tq, hd); k, v (B, nh, Tk, hd); bias (nh, Tq, Tk) or null; C = nh * hd.
// All float32, contiguous, on the device. W's body up to kMaxT tokens,
// W-long's (W4-long) beyond.
extern "C" int window_attn_fwd_4d(const float* q, const float* k,
                                  const float* v, const float* bias,
                                  float* out, int B, int Tq, int Tk, int C,
                                  int nh, float scale, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (Tq > kMaxT || Tk > kMaxT)
    return static_cast<int>(launch_fwd_long<float, true>(
        q, k, v, bias, out, B, Tq, Tk, C, nh, scale, st));
  return static_cast<int>(launch_fwd<false, float, true>(
      q, k, v, bias, nullptr, out, B, Tq, Tk, C, nh, 1, scale, st));
}

// Kernel W4-bf16: as window_attn_fwd_4d with q, k, v and out bfloat16; bias
// float32 or null.
extern "C" int window_attn_fwd_4d_bf16(const __nv_bfloat16* q,
                                       const __nv_bfloat16* k,
                                       const __nv_bfloat16* v,
                                       const float* bias, __nv_bfloat16* out,
                                       int B, int Tq, int Tk, int C, int nh,
                                       float scale, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (Tq > kMaxT || Tk > kMaxT)
    return static_cast<int>(launch_fwd_long_mma<false, true>(
        q, k, v, bias, nullptr, out, B, Tq, Tk, C, nh, 1, scale, st));
  return static_cast<int>(launch_fwd<false, __nv_bfloat16, true>(
      q, k, v, bias, nullptr, out, B, Tq, Tk, C, nh, 1, scale, st));
}
