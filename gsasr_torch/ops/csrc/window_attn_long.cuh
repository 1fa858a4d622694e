// The window-16 limits of the tensor-core attention bodies: the shapes the
// window-16 forms take (any Tq and Tk, a head width up to 32) and Swin's
// per-window-class mask, which the bodies add after the bias. The forward
// forms (W-long, WM-long, W4-long, A-long's attention) run
// window_attn_long_tf32.cuh in fp32 and window_attn_long_mma.cuh in bf16,
// the backward forms (WB-long, WMB-long, WB4-long, AB-long's attention)
// window_attn_long_tf32_bwd.cuh and window_attn_long_mma_bwd.cuh.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

#include "tile_gemm.cuh"

namespace gsasr {

constexpr int kLMaxHd = 32;  // head width

// The window attention bodies take their window from blockIdx.y, which
// CUDA caps at 65,535 blocks. So their launchers run the windows in pieces
// of at most kMaxGridY through for_window_chunks, on their operands and
// scratch offset by the piece's first window (64-bit offsets). Every window
// keeps its block and its order of summation, and up to 65,535 windows the
// one launch is the launch it was.
constexpr int kMaxGridY = 65535;

// Calls launch(w0, nb, c0) for each piece of the B windows: windows w0 ..
// w0 + nb - 1, the first of mask class c0 = w0 % nW, with the bodies' mask
// from class c0 on (window_mask_from). With nW <= kMaxGridY a piece holds
// whole periods of the mask and starts at class 0, so window w of it keeps
// its class w % nW. With a longer period each period is cut into pieces of
// at most kMaxGridY windows, and window w of a piece, below nW - c0, keeps
// class c0 + w. Returns the first launch error.
template <class F>
cudaError_t for_window_chunks(int B, int nW, F launch) {
  for (int w0 = 0; w0 < B;) {
    const int c0 = w0 % nW;
    int nb = nW > kMaxGridY ? (nW - c0 < kMaxGridY ? nW - c0 : kMaxGridY)
                            : kMaxGridY / nW * nW;
    if (nb > B - w0) nb = B - w0;
    launch(w0, nb, c0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    w0 += nb;
  }
  return cudaSuccess;
}

// The offset of window w0 in a (B, T, C) or (B, nh, T, hd) operand.
inline size_t window_offset(int w0, int T, int C) {
  return static_cast<size_t>(w0) * T * C;
}

// The (nW, Tq, Tk) mask from class c0 on; null without one.
inline const float* window_mask_from(const float* mask, int c0, int Tq,
                                     int Tk) {
  return mask ? mask + window_offset(c0, Tq, Tk) : nullptr;
}

// What the long body takes: any Tq, Tk >= 1, a head width <= kLMaxHd, and
// any window count (for_window_chunks).
inline bool long_shape_ok(int B, int Tq, int Tk, int C, int nh) {
  return B >= 1 && Tq >= 1 && Tk >= 1 && nh >= 1 && C % nh == 0 &&
         C / nh <= kLMaxHd;
}

// The (Tq, Tk) mask of window `win`: class win % nW of the (nW, Tq, Tk)
// mask (the Swin SW-MSA convention); null without one.
__device__ __forceinline__ const float* long_window_mask(const float* mask,
                                                        int win, int nW,
                                                        int Tq, int Tk) {
  return mask ? mask + static_cast<size_t>(win % nW) * Tq * Tk : nullptr;
}

}  // namespace gsasr
