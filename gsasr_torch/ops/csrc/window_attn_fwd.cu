// Kernel W: packed multi-head window attention, forward; with kMask, kernel
// WM, its masked form.
//
// W replaces _attn_kernel_packed of gsasr_tpu/ops/attention.py (reached
// from _attention_packed_pallas, the forward of window_attention_packed
// without a mask); WM replaces _attn_kernel_packed_masked (reached from
// _attention_packed_pallas_masked, the forward with a window_mask). Per
// window w and head h, on the packed (B, T, C) layout where head h is
// columns [h*hd, (h+1)*hd):
//
//   s = q_h k_h^T * scale + bias[h] (+ mask[w % nW])    (Tq x Tk, f32)
//   p = softmax(s) with the row max subtracted
//   out[w, :, h*hd:(h+1)*hd] = p v_h
//
// What bounds it on an H100: the two products, 4 * B * nh * Tq * Tk * hd
// FP32 operations (3.8 GFLOP at 256 windows x 6 heads x 144 x 144 x 30)
// against 67 TFLOP/s; the bytes (q, k, v and out, 106 MB) take less than
// half as long at 3.35 TB/s, and the exps (32 M) far less. WM at a Swin
// shape (576 windows x 6 heads x 64 x 64 x 30) does 1.7 GFLOP on 106 MB
// plus the 9.4 MB mask, so it is bound by bytes.
//
// Design. One 256-thread block per (window, head), so heads are sliced by
// column offset straight from the packed layout and no head transpose is
// written to memory. The block stages its q_h, k_h and v_h (Tq, Tk x hd,
// rows padded to an odd stride) in shared memory, about 54 KB at T = 144.
// Each warp takes four query rows at a time and holds their scores in
// registers (lane l owns keys l + 32 m, so Tk <= 160), takes the softmax
// with warp reductions, writes the probabilities to a per-warp row buffer
// and multiplies them by v_h with lane d owning output column d. Each
// (window, head) writes only its own columns, so no atomics are needed and
// the result is deterministic. WM reads its window class's mask rows from
// device memory beside the bias rows (the six heads of a window read the
// same rows, which stay in L2); the JAX kernel's padding of the window-class
// period is not needed, since a block takes one window, not a block of
// them. The mask is a template flag of the body that W and WM share; they
// are two kernels, each with its own launch bounds, so W compiles as
// without the mask.

#include <cuda_runtime.h>

#include "window_attn.cuh"

namespace {

using gsasr::HeadLayout;
using gsasr::kKeysPer;
using gsasr::kMaxHd;
using gsasr::kMaxT;
using gsasr::kQRows;
using gsasr::kThreads;
using gsasr::kWarps;
using gsasr::softmax_exp_row;
using gsasr::stage_head;
using gsasr::window_mask;

// q_h, k_h, v_h and the per-warp probability rows.
__host__ __device__ size_t smem_bytes(const HeadLayout& L, int Tk) {
  return sizeof(float) *
         (L.q_floats + 2 * L.kv_floats + static_cast<size_t>(kWarps) * kQRows * Tk);
}

// The body of W (kMask false) and WM (kMask true), one block per (head,
// window).
template <bool kMask>
__device__ __forceinline__ void window_attn_fwd_body(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    const float* __restrict__ mask, float* __restrict__ out, int Tq, int Tk,
    int C, int nh, int nW, float scale) {
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
  const int n0 = head * hd;
  float* prow = vs + L.kv_floats + warp * kQRows * Tk;

  stage_head(q, static_cast<size_t>(win) * Tq, Tq, C, n0, hd, qs, L.ld);
  stage_head(k, static_cast<size_t>(win) * Tk, Tk, C, n0, hd, ks, L.ld);
  stage_head(v, static_cast<size_t>(win) * Tk, Tk, C, n0, hd, vs, L.ld);
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
        if (j < Tk) prow[r * Tk + j] = s[r][m] / sum;
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
          out[(static_cast<size_t>(win) * Tq + i0 + r) * C + n0 + lane] = o[r];
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
  window_attn_fwd_body<false>(q, k, v, bias, mask, out, Tq, Tk, C, nh, nW,
                              scale);
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
  window_attn_fwd_body<true>(q, k, v, bias, mask, out, Tq, Tk, C, nh, nW,
                             scale);
}

template <bool kMask>
cudaError_t launch_fwd(const float* q, const float* k, const float* v,
                       const float* bias, const float* mask, float* out, int B,
                       int Tq, int Tk, int C, int nh, int nW, float scale,
                       cudaStream_t st) {
  if (B < 1 || Tq < 1 || Tk < 1 || nh < 1 || C % nh != 0 || C / nh > kMaxHd ||
      Tq > kMaxT || Tk > kMaxT || nW < 1 || B % nW != 0)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(HeadLayout(Tq, Tk, C / nh), Tk);
  const auto kernel = kMask ? window_attn_fwd_masked_kernel
                            : window_attn_fwd_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nh, B), kThreads, smem, st>>>(
      q, k, v, bias, mask, out, Tq, Tk, C, nh, nW, scale);
  return cudaGetLastError();
}

}  // namespace

// q, out (B, Tq, C); k, v (B, Tk, C); bias (nh, Tq, Tk) or null; all float32,
// contiguous, on the device.
extern "C" int window_attn_fwd(const float* q, const float* k, const float* v,
                               const float* bias, float* out, int B, int Tq,
                               int Tk, int C, int nh, float scale,
                               void* stream) {
  return static_cast<int>(launch_fwd<false>(
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
  return static_cast<int>(launch_fwd<true>(
      q, k, v, bias, mask, out, B, Tq, Tk, C, nh, nW, scale,
      static_cast<cudaStream_t>(stream)));
}
