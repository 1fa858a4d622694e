// Kernel WB: packed multi-head window attention, backward; and kernel WMB,
// its masked form.
//
// WB replaces _attn_kernel_packed_bwd of gsasr_tpu/ops/attention.py
// (reached from _attention_packed_pallas_bwd, the custom VJP of
// window_attention_packed); WMB replaces _attn_kernel_packed_masked_bwd
// (reached from _attention_packed_pallas_masked_bwd, the VJP with a
// window_mask). Per window w and head h, with the softmax recomputed from
// q, k, bias (and mask[w % nW]) as kernels W and WM compute it:
//
//   dv = p^T g_h          dp = g_h v_h^T      ds = p (dp - rowsum(dp p))
//   dq = ds k_h * scale   dk = ds^T q_h * scale
//   dbias[h] = sum over the windows of ds
//
// What bounds it on an H100: the five products (the recomputed scores, dp,
// dv, dq and dk), 10 * B * nh * Tq * Tk * hd FP32 operations (9.6 GFLOP at
// 256 windows x 6 heads x 144 x 144 x 30) against 67 TFLOP/s; the bytes
// (q, k, v, g, dq, dk, dv: 186 MB) take about 40% as long at 3.35 TB/s.
// WMB at a Swin shape (576 windows x 6 heads x 64 x 64 x 30) does 4.2
// GFLOP against 195 MB (with the mask and dbias): operations and bytes
// take about as long.
//
// Design: the device code lives in window_attn_bwd.cuh, which kernel AB
// shares. One block per (window, head) recomputes p in shared memory and
// forms dq, dk and dv; dbias, a sum over windows, is summed by a second
// launch in ascending window order: no float atomics, and the result is
// the same bits from run to run. The mask gets no gradient (a constant at
// every call site; the JAX VJP returns zeros for it).

#include <cuda_runtime.h>

#include "window_attn_bwd.cuh"

// q, g, dq (B, Tq, C); k, v, dk, dv (B, Tk, C); bias (nh, Tq, Tk) or null;
// ds_w (B, nh, Tq, Tk) scratch the caller allocates; dbias (nh, Tq, Tk), or
// null to skip the sum over windows. All float32, contiguous, on the device.
extern "C" int window_attn_bwd(const float* q, const float* k, const float* v,
                               const float* bias, const float* g, float* dq,
                               float* dk, float* dv, float* ds_w, float* dbias,
                               int B, int Tq, int Tk, int C, int nh,
                               float scale, void* stream) {
  return static_cast<int>(launch_window_attn_bwd<false>(
      q, k, v, bias, g, dq, dk, dv, ds_w, dbias, nullptr, B, Tq, Tk, C, nh,
      scale, static_cast<cudaStream_t>(stream)));
}

// Kernel WMB: as window_attn_bwd, plus mask (nW, Tq, Tk) float32, window w
// taking mask[w % nW]; B must be a multiple of nW.
extern "C" int window_attn_bwd_masked(const float* q, const float* k,
                                      const float* v, const float* bias,
                                      const float* mask, const float* g,
                                      float* dq, float* dk, float* dv,
                                      float* ds_w, float* dbias, int B, int Tq,
                                      int Tk, int C, int nh, int nW,
                                      float scale, void* stream) {
  return static_cast<int>(launch_window_attn_bwd<false, true>(
      q, k, v, bias, g, dq, dk, dv, ds_w, dbias, nullptr, B, Tq, Tk, C, nh,
      scale, static_cast<cudaStream_t>(stream), mask, nW));
}
