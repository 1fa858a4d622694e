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

// What the long body takes: any Tq, Tk >= 1, a head width <= kLMaxHd, and
// a window count the grid's y dimension holds.
inline bool long_shape_ok(int B, int Tq, int Tk, int C, int nh) {
  return B >= 1 && B <= 65535 && Tq >= 1 && Tk >= 1 && nh >= 1 &&
         C % nh == 0 && C / nh <= kLMaxHd;
}

// The (Tq, Tk) mask of window `win`: class win % nW of the (nW, Tq, Tk)
// mask (the Swin SW-MSA convention); null without one.
__device__ __forceinline__ const float* long_window_mask(const float* mask,
                                                        int win, int nW,
                                                        int Tq, int Tk) {
  return mask ? mask + static_cast<size_t>(win % nW) * Tq * Tk : nullptr;
}

}  // namespace gsasr
