// Kernel WB: packed multi-head window attention, backward; kernel WMB, its
// masked form; kernels WB-bf16 and WMB-bf16, their forms with bfloat16
// operands; and WB-long, WB-long-bf16, WMB-long and WMB-long-bf16, the
// window-16 forms of all four for any Tq and Tk; and WB4 and WB4-bf16, the
// 4D form.
//
// WB replaces _attn_kernel_packed_bwd of gsasr_tpu/ops/attention.py
// (reached from _attention_packed_pallas_bwd, the custom VJP of
// window_attention_packed); WMB replaces _attn_kernel_packed_masked_bwd
// (reached from _attention_packed_pallas_masked_bwd, the VJP with a
// window_mask); WB-bf16 replaces _attn_kernel_packed_bwd with bfloat16
// operands (the Enhanced decoder's bf16 module path); WB-long and
// WB-long-bf16 replace it at windows beyond WB's 160 keys (HAT-L Ultra
// training: 256 x 256 and OCAB's 256 x 576). WMB-bf16 replaces
// _attn_kernel_packed_masked_bwd with bfloat16 operands (SwinIR's shifted
// blocks at the bf16 recipe, train_swinir_amp.yml), and WMB-long and
// WMB-long-bf16 replace it at windows beyond 160 keys (the paper HAT's
// shifted 256-token windows, fp32 and bf16). Per window w and
// head h, with the softmax recomputed from
// q, k, bias (and mask[w % nW]) as kernels W and WM compute it:
//
//   dv = p^T g_h          dp = g_h v_h^T      ds = p (dp - rowsum(dp p))
//   dq = ds k_h * scale   dk = ds^T q_h * scale
//   dbias[h] = sum over the windows of ds
//
// What bounds it on an H100: the five products (the recomputed scores, dp, dv,
// dq and dk), 10 * B * nh * Tq * Tk * hd operations (9.6 GFLOP at 256 windows
// x 6 heads x 144 x 144 x 30), each three TF32 products in 3xTF32: 28.7 GFLOP,
// 0.058 ms at 495 TFLOP/s, against 187 MB of q, k, v, g, dq, dk, dv, bias and
// dbias (0.056 ms at 3.35 TB/s). WMB at a Swin shape (576 windows x 6 heads x
// 64 x 64 x 30) does 4.2 GFLOP, 12.7 in 3xTF32, against 195 MB (with the mask
// and dbias): bound by bytes. WB-bf16 at the Enhanced training shape (256
// windows x 6 heads x 144 x 144 x 32) does 10.2 GFLOP, 0.010 ms at the bf16
// tensor-core peak, against 99 MB (bf16 q, k, v, g, dq, dk, dv): 0.030 ms,
// bound by bytes.
//
// Design of WB, WMB and WB4: the 3xTF32 tensor-core body up to 160 tokens
// (window_attn_short_tf32_bwd.cuh), WB-long's arithmetic fused into one block
// per (window, head) that stages q, g, k, v, the bias and the mask once in
// shared memory, forms dq and each query row's (max, 1 / sum, D) over the
// query rows and then dk and dv over the keys; where its shared memory would
// not fit (a mask beyond about 120 tokens) WB-long's two launches run, with
// the statistics in the stats scratch; kernel AB's fp32 attention runs the
// same body (ln_attn_bwd.cu). With a bias ds goes to ds_w, and dbias, a
// sum over windows, is summed by another launch in ascending window order: no
// float atomics, and the result is the same bits from run to run. The mask
// gets no gradient (a constant at every call site; the JAX VJP returns zeros
// for it). WB-bf16, WMB-bf16 and WB4-bf16 run a tensor-core body of their own
// (window_attn_short_mma_bwd.cuh) with the same ownership, order and dbias
// sum: p, dp and ds are f32 and p is not rounded (the Pallas body's f32 dots);
// dq, dk and dv are rounded once as they are stored; ds goes to device memory
// only for dbias, in f32.
//
// WB-long at the HAT-L Ultra training shape (128 windows x 6 heads x 256 x
// 256 x 32): the five products of the function are 16.1 GFLOP, 0.016 ms at
// the bf16 tensor-core peak, against 88 MB of bf16 q, k, v, g, dq, dk, dv
// (0.026 ms at 3.35 TB/s): bound by bytes in bf16; in fp32 by the
// operations, three TF32 products each in 3xTF32 (0.098 ms at 495 TFLOP/s,
// against 176 MB, 0.053 ms). Both keep every output owned by one block and
// every sum in one order, forming ten such products, twice the
// function's, on the tensor cores: WB-long (and WMB-long, WB4-long by its
// flags) in 3xTF32 on f32 tiles (window_attn_long_tf32_bwd.cuh),
// WB-long-bf16 (and WMB-long-bf16, WB4-long-bf16) on bf16 tiles with p and
// ds fed as hi/lo bf16 pairs (window_attn_long_mma_bwd.cuh).
//
// WMB-bf16 at SwinIR's training shape (576 windows x 6 heads x 64 x 64 x
// 30) does 4.2 GFLOP, 0.004 ms at the bf16 tensor-core peak, against 58 MB
// (bf16 q, k, v, g, dq, dk, dv; f32 bias, dbias, mask): bound by bytes.
// WMB-long at the paper HAT's training shape (144 windows x 6 heads x 256
// x 256 x 30) does 17 GFLOP, 51 GFLOP of TF32 in 3xTF32, 0.103 ms at 495
// TFLOP/s; WMB-long-bf16 the same products against about 98 MB of bf16
// operands and f32 bias, dbias and mask: bound by bytes. The masked forms
// read one mask entry per score, from the window class's rows, which stay
// in L2.
//
// WB4 and WB4-bf16 (window_attn_bwd_4d[_bf16]) replace _attn_kernel_bwd of
// gsasr_tpu/ops/attention.py (reached from _attention_pallas_bwd, the VJP
// of fused_window_attention and so of window_attention): in fp32 WB's
// 3xTF32 body up to 160 tokens and WB-long's two launches beyond, on the
// head-major (B, nh, T, hd) layout in place (their kHM flag; in bf16
// WB-bf16's and WB-long-bf16's tensor-core bodies), with dbias WB's ordered
// sum over the windows, f32;
// dq, dk, dv are formed in f32 and stored in the operands' type, as K14b
// stores them. Bounds as WB's and WB-long's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "window_attn_long_mma_bwd.cuh"
#include "window_attn_long_tf32_bwd.cuh"
#include "window_attn_short_mma_bwd.cuh"
#include "window_attn_short_tf32_bwd.cuh"

// q, g, dq (B, Tq, C); k, v, dk, dv (B, Tk, C), Tq, Tk <= kMaxT; bias (nh,
// Tq, Tk) or null; stats (B, nh, Tq, 3) scratch the caller allocates; ds_w
// (B, nh, Tq, Tk) scratch, needed (and written) only with dbias; dbias (nh,
// Tq, Tk), or null to skip the sum over windows. All float32, contiguous,
// on the device. The 3xTF32 tensor-core body up to 160 tokens (stats used
// only where WB-long's launches stand in for it).
extern "C" int window_attn_bwd(const float* q, const float* k, const float* v,
                               const float* bias, const float* g, float* dq,
                               float* dk, float* dv, float* stats,
                               float* ds_w, float* dbias, int B, int Tq,
                               int Tk, int C, int nh, float scale,
                               void* stream) {
  return static_cast<int>(launch_window_attn_bwd_short_tf32<false, false>(
      q, k, v, bias, g, dq, dk, dv, stats, ds_w, dbias, B, Tq, Tk, C, nh,
      scale, static_cast<cudaStream_t>(stream)));
}

// Kernel WMB: as window_attn_bwd, plus mask (nW, Tq, Tk) float32, window w
// taking mask[w % nW]; B must be a multiple of nW (the body's mask flag).
extern "C" int window_attn_bwd_masked(const float* q, const float* k,
                                      const float* v, const float* bias,
                                      const float* mask, const float* g,
                                      float* dq, float* dk, float* dv,
                                      float* stats, float* ds_w, float* dbias,
                                      int B, int Tq, int Tk, int C, int nh,
                                      int nW, float scale, void* stream) {
  return static_cast<int>(launch_window_attn_bwd_short_tf32<true, false>(
      q, k, v, bias, g, dq, dk, dv, stats, ds_w, dbias, B, Tq, Tk, C, nh,
      scale, static_cast<cudaStream_t>(stream), mask, nW));
}

// Kernel WMB-bf16: as window_attn_bwd_masked with q, k, v, g, dq, dk and
// dv bfloat16; bias, mask, ds_w and dbias float32, ds_w needed (and
// written) only with dbias (the tensor-core body with its mask flag).
extern "C" int window_attn_bwd_masked_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const float* bias, const float* mask, const __nv_bfloat16* g,
    __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, float* ds_w,
    float* dbias, int B, int Tq, int Tk, int C, int nh, int nW, float scale,
    void* stream) {
  return static_cast<int>(launch_bwd_short_mma<true, false>(
      q, k, v, bias, g, dq, dk, dv, ds_w, dbias, B, Tq, Tk, C, nh, scale,
      static_cast<cudaStream_t>(stream), mask, nW));
}

// Kernel WB-bf16: as window_attn_bwd with q, k, v, g, dq, dk and dv
// bfloat16; bias (nh, Tq, Tk), ds_w and dbias float32, ds_w needed (and
// written) only with dbias (the tensor-core body).
extern "C" int window_attn_bwd_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, const float* bias,
                                    const __nv_bfloat16* g, __nv_bfloat16* dq,
                                    __nv_bfloat16* dk, __nv_bfloat16* dv,
                                    float* ds_w, float* dbias, int B, int Tq,
                                    int Tk, int C, int nh, float scale,
                                    void* stream) {
  return static_cast<int>(launch_bwd_short_mma<false, false>(
      q, k, v, bias, g, dq, dk, dv, ds_w, dbias, B, Tq, Tk, C, nh, scale,
      static_cast<cudaStream_t>(stream)));
}

// Kernel WB-long: as window_attn_bwd for any Tq and Tk (the window-16
// form), plus stats (B, nh, Tq, 3) float32 scratch the caller allocates;
// ds_w (B, nh, Tq, Tk) is needed, and written, only with dbias (the
// tensor-core body in 3xTF32).
extern "C" int window_attn_bwd_long(const float* q, const float* k,
                                    const float* v, const float* bias,
                                    const float* g, float* dq, float* dk,
                                    float* dv, float* stats, float* ds_w,
                                    float* dbias, int B, int Tq, int Tk,
                                    int C, int nh, float scale,
                                    void* stream) {
  return static_cast<int>(launch_window_attn_bwd_long_tf32<false, false>(
      q, k, v, bias, g, dq, dk, dv, stats, ds_w, dbias, B, Tq, Tk, C, nh,
      scale, static_cast<cudaStream_t>(stream)));
}

// Kernel WB-long-bf16: as window_attn_bwd_long with q, k, v, g, dq, dk and
// dv bfloat16; bias, stats, ds_w and dbias float32 (the tensor-core body).
extern "C" int window_attn_bwd_long_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const float* bias, const __nv_bfloat16* g, __nv_bfloat16* dq,
    __nv_bfloat16* dk, __nv_bfloat16* dv, float* stats, float* ds_w,
    float* dbias, int B, int Tq, int Tk, int C, int nh, float scale,
    void* stream) {
  return static_cast<int>(launch_window_attn_bwd_long_mma<false, false>(
      q, k, v, bias, g, dq, dk, dv, stats, ds_w, dbias, B, Tq, Tk, C, nh,
      scale, static_cast<cudaStream_t>(stream)));
}

// Kernel WMB-long: as window_attn_bwd_long, plus mask (nW, Tq, Tk) float32,
// window w taking mask[w % nW]; B must be a multiple of nW (WB-long's body
// with its mask flag).
extern "C" int window_attn_bwd_long_masked(
    const float* q, const float* k, const float* v, const float* bias,
    const float* mask, const float* g, float* dq, float* dk, float* dv,
    float* stats, float* ds_w, float* dbias, int B, int Tq, int Tk, int C,
    int nh, int nW, float scale, void* stream) {
  return static_cast<int>(launch_window_attn_bwd_long_tf32<true, false>(
      q, k, v, bias, g, dq, dk, dv, stats, ds_w, dbias, B, Tq, Tk, C, nh,
      scale, static_cast<cudaStream_t>(stream), mask, nW));
}

// Kernel WMB-long-bf16: as window_attn_bwd_long_masked with q, k, v, g, dq,
// dk and dv bfloat16; bias, mask, stats, ds_w and dbias float32.
extern "C" int window_attn_bwd_long_masked_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const float* bias, const float* mask, const __nv_bfloat16* g,
    __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, float* stats,
    float* ds_w, float* dbias, int B, int Tq, int Tk, int C, int nh, int nW,
    float scale, void* stream) {
  return static_cast<int>(launch_window_attn_bwd_long_mma<true, false>(
      q, k, v, bias, g, dq, dk, dv, stats, ds_w, dbias, B, Tq, Tk, C, nh,
      scale, static_cast<cudaStream_t>(stream), mask, nW));
}

// Kernel WB4 (K14b): the backward of window attention on the head-major
// layout, q, g, dq (B, nh, Tq, hd); k, v, dk, dv (B, nh, Tk, hd); bias and
// dbias (nh, Tq, Tk) or null; C = nh * hd; stats (B, nh, Tq, 3) scratch,
// ds_w (B, nh, Tq, Tk) scratch only with dbias. WB's 3xTF32 body up to
// kMaxT tokens, WB-long's two launches beyond (WB4-long), both with the
// head-major flag. All float32, contiguous, on the device.
extern "C" int window_attn_bwd_4d(const float* q, const float* k,
                                  const float* v, const float* bias,
                                  const float* g, float* dq, float* dk,
                                  float* dv, float* stats, float* ds_w,
                                  float* dbias, int B, int Tq, int Tk, int C,
                                  int nh, float scale, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (!stats) return static_cast<int>(cudaErrorInvalidValue);
  if (Tq > kMaxT || Tk > kMaxT)
    return static_cast<int>(launch_window_attn_bwd_long_tf32<false, true>(
        q, k, v, bias, g, dq, dk, dv, stats, ds_w, dbias, B, Tq, Tk, C, nh,
        scale, st));
  return static_cast<int>(launch_window_attn_bwd_short_tf32<false, true>(
      q, k, v, bias, g, dq, dk, dv, stats, ds_w, dbias, B, Tq, Tk, C, nh,
      scale, st));
}

// Kernel WB4-bf16: as window_attn_bwd_4d with q, k, v, g, dq, dk and dv
// bfloat16; bias, stats, ds_w and dbias float32. The tensor-core bodies
// with their head-major flag: WB-bf16's up to kMaxT tokens (stats unused,
// ds_w needed only with dbias), WB-long-bf16's two launches beyond.
extern "C" int window_attn_bwd_4d_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const float* bias, const __nv_bfloat16* g, __nv_bfloat16* dq,
    __nv_bfloat16* dk, __nv_bfloat16* dv, float* stats, float* ds_w,
    float* dbias, int B, int Tq, int Tk, int C, int nh, float scale,
    void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (Tq > kMaxT || Tk > kMaxT)
    return static_cast<int>(
        stats ? launch_window_attn_bwd_long_mma<false, true>(
                    q, k, v, bias, g, dq, dk, dv, stats, ds_w, dbias, B, Tq,
                    Tk, C, nh, scale, st)
              : cudaErrorInvalidValue);
  return static_cast<int>(launch_bwd_short_mma<false, true>(
      q, k, v, bias, g, dq, dk, dv, ds_w, dbias, B, Tq, Tk, C, nh, scale,
      st));
}
