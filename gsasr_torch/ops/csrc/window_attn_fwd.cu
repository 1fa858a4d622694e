// Kernel W: packed multi-head window attention, forward; with kMask, kernel
// WM, its masked form; with bfloat16 operands, kernels W-bf16 and WM-bf16;
// and W-long, W-long-bf16, WM-long and WM-long-bf16, the window-16 forms
// of all four; and W4 and W4-bf16, W's and W-long's bodies on the
// head-major layout (the 4D form).
//
// W replaces _attn_kernel_packed of gsasr_tpu/ops/attention.py (reached
// from _attention_packed_pallas, the forward of window_attention_packed
// without a mask) with float32 operands, and W-bf16 with bfloat16 operands
// (the Enhanced decoder's bf16 module path, through _sdpa_packed); WM
// replaces _attn_kernel_packed_masked (reached from
// _attention_packed_pallas_masked, the forward with a window_mask), and
// WM-bf16 with bfloat16 operands (SwinIR's shifted blocks at the bf16
// recipe, train_swinir_amp.yml). Up to 160 tokens W and WM run the 3xTF32
// tensor-core body of window_attn_short_tf32.cuh, W-bf16 and WM-bf16 the
// bf16 one of window_attn_short_mma.cuh. Per window w and head h, on the
// packed (B, T, C) layout where head h is columns [h*hd, (h+1)*hd):
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
// What bounds it on an H100: W at the paper step's 256 windows x 6 heads x
// 144 x 144 x 30 does two products of 1.9 GFLOP, 11.5 GFLOP of TF32 in
// 3xTF32 (0.023 ms at 495 TFLOP/s), on 106 MB of q, k, v and out (0.032
// ms at 3.35 TB/s): bound by bytes. WM at a Swin shape (576 windows x 6
// heads x 64 x 64 x 30) moves 106 MB plus the 9.4 MB mask: bound by bytes.
// W-bf16 at the Enhanced training shape (256 windows x 6 heads x 144 x 144
// x 32) does 4.1 GFLOP, 0.004 ms at the bf16 tensor-core peak, on 57 MB of
// bf16 q, k, v and out, 0.017 ms: bound by bytes.
//
// Every form takes one (head, window) per block or per step of a
// persistent block, so heads are sliced by column offset straight from the
// packed layout and no head transpose is written to memory; each (window,
// head) writes only its own columns, so no atomics are needed and the
// result is deterministic. The masked forms read their window class's mask
// rows from device memory beside the bias rows (the heads of a window read
// the same rows, which stay in L2); the JAX kernel's padding of the
// window-class period is not needed. The mask is a template flag of each
// body, so the unmasked forms compile as without it.
//
// W-long and W-long-bf16 are the window-16 form (HAT's 144 windows x 6
// heads x 256 x 256, and OCAB's 256 queries x 576 keys, head width 32,
// no bias), for any Tq and Tk. W-long runs the tensor-core body of
// window_attn_long_tf32.cuh in 3xTF32: one sweep over the keys with the
// online softmax, two products of 2 * B * nh * Tq * Tk * hd operations, each
// three TF32 products: 21.7 GFLOP (HAB) and 48.9 GFLOP (OCAB) against 495
// TFLOP/s, 0.044 and 0.098 ms, over 113 and 193 MB of q, k, v and out at
// 3.35 TB/s, 0.034 and 0.058 ms. Bound by operations. W-long-bf16 (and
// WM-long-bf16, W4-long-bf16 by its flags) runs two sweeps on the tensor
// cores, bf16 operands staged in bf16 (window_attn_long_mma.cuh): bound by
// bytes.
//
// WM-long and WM-long-bf16 replace _attn_kernel_packed_masked beyond 160
// tokens: the paper HAT's shifted windows of 16 (144 windows x 6 heads x 256 x
// 256 x 30, with a bias and the SW-MSA mask of period 9 or 144), the same body
// with the mask added after the bias (a template flag, so W-long and A-long
// keep their code). WM-long does 6.8 GFLOP, 20.4 GFLOP of TF32 in 3xTF32,
// 0.041 ms at 495 TFLOP/s; WM-long-bf16 moves 53 MB of bf16 q, k, v and out,
// 1.6 MB of bias and up to 38 MB of mask (period 144), 0.027 ms: bound by
// bytes. WM-bf16 at SwinIR's shape (576 windows, T 64) moves 53 MB of bf16
// operands and up to 9.4 MB of mask: bound by bytes too.
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
// the packed layout is made; up to 160 tokens W's body (W4-bf16: W-bf16's),
// beyond it W-long's (W-long-bf16's), each a template instance of its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "window_attn.cuh"
#include "window_attn_long_mma.cuh"
#include "window_attn_long_tf32.cuh"
#include "window_attn_short_mma.cuh"
#include "window_attn_short_tf32.cuh"

using gsasr::kMaxT;

// q, out (B, Tq, C); k, v (B, Tk, C); bias (nh, Tq, Tk) or null; all float32,
// contiguous, on the device.
extern "C" int window_attn_fwd(const float* q, const float* k, const float* v,
                               const float* bias, float* out, int B, int Tq,
                               int Tk, int C, int nh, float scale,
                               void* stream) {
  return static_cast<int>(launch_fwd_short_tf32<false, false>(
      q, k, v, bias, nullptr, out, B, Tq, Tk, C, nh, 1, scale,
      static_cast<cudaStream_t>(stream)));
}

// Kernel W-bf16: as window_attn_fwd with q, k, v and out bfloat16; bias
// (nh, Tq, Tk) float32 or null (the tensor-core body).
extern "C" int window_attn_fwd_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, const float* bias,
                                    __nv_bfloat16* out, int B, int Tq, int Tk,
                                    int C, int nh, float scale, void* stream) {
  return static_cast<int>(launch_fwd_short_mma<false, false>(
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
  return static_cast<int>(launch_fwd_short_tf32<true, false>(
      q, k, v, bias, mask, out, B, Tq, Tk, C, nh, nW, scale,
      static_cast<cudaStream_t>(stream)));
}

// Kernel WM-bf16: as window_attn_fwd_masked with q, k, v and out
// bfloat16; bias and mask float32 (the tensor-core body with its mask
// flag).
extern "C" int window_attn_fwd_masked_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const float* bias, const float* mask, __nv_bfloat16* out, int B, int Tq,
    int Tk, int C, int nh, int nW, float scale, void* stream) {
  return static_cast<int>(launch_fwd_short_mma<true, false>(
      q, k, v, bias, mask, out, B, Tq, Tk, C, nh, nW, scale,
      static_cast<cudaStream_t>(stream)));
}

// Kernel W-long: as window_attn_fwd for any Tq and Tk (the window-16 form).
extern "C" int window_attn_fwd_long(const float* q, const float* k,
                                    const float* v, const float* bias,
                                    float* out, int B, int Tq, int Tk, int C,
                                    int nh, float scale, void* stream) {
  return static_cast<int>(launch_fwd_long_tf32<false, false>(
      q, k, v, bias, nullptr, out, B, Tq, Tk, C, nh, 1, scale,
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
  return static_cast<int>(launch_fwd_long_tf32<true, false>(
      q, k, v, bias, mask, out, B, Tq, Tk, C, nh, nW, scale,
      static_cast<cudaStream_t>(stream)));
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
// All float32, contiguous, on the device. W's 3xTF32 body up to kMaxT
// tokens, W-long's (W4-long) beyond.
extern "C" int window_attn_fwd_4d(const float* q, const float* k,
                                  const float* v, const float* bias,
                                  float* out, int B, int Tq, int Tk, int C,
                                  int nh, float scale, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (Tq > kMaxT || Tk > kMaxT)
    return static_cast<int>(launch_fwd_long_tf32<false, true>(
        q, k, v, bias, nullptr, out, B, Tq, Tk, C, nh, 1, scale, st));
  return static_cast<int>(launch_fwd_short_tf32<false, true>(
      q, k, v, bias, nullptr, out, B, Tq, Tk, C, nh, 1, scale, st));
}

// Kernel W4-bf16: as window_attn_fwd_4d with q, k, v and out bfloat16; bias
// float32 or null. The tensor-core bodies with their head-major flag: W-bf16's
// up to kMaxT tokens, W-long-bf16's beyond.
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
  return static_cast<int>(launch_fwd_short_mma<false, true>(
      q, k, v, bias, nullptr, out, B, Tq, Tk, C, nh, 1, scale, st));
}
