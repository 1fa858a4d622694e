// The limits of the window-attention kernels up to 160 tokens
// (window_attn_fwd.cu, window_attn_bwd.cu, ln_attn.cu, ln_attn_bwd.cu):
// the bodies that hold a whole window on the chip (window_attn_short_*.cuh)
// take Tq, Tk <= kMaxT and a head width up to kMaxHd; beyond kMaxT tokens
// the window-16 bodies run.
#pragma once

#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace gsasr {

constexpr int kMaxT = 160;
constexpr int kMaxHd = 32;

}  // namespace gsasr
