// The ordered sum over windows of a per-window ds that every window
// attention backward shares for its bias gradient (dbias), and the limits
// of window_attn.cuh that the backward bodies' launchers
// (window_attn_short_tf32_bwd.cuh, window_attn_long_tf32_bwd.cuh,
// window_attn_short_mma_bwd.cuh, window_attn_long_mma_bwd.cuh) take from it. Blocks run in no order, so
// dbias is a launch of its own, one thread per (h, i, j), summing the
// windows in ascending order: no float atomics, and the result is the same
// bits from run to run.
#pragma once

#include <cuda_runtime.h>

#include "window_attn.cuh"

namespace {

using gsasr::kMaxT;
using gsasr::kThreads;

// dbias[e] = sum_{w < B} ds_w[w * n + e] in ascending w, e < n = nh Tq Tk.
__global__ void __launch_bounds__(kThreads)
dbias_sum_kernel(const float* __restrict__ ds_w, float* __restrict__ dbias,
                 int B, int n) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int w = 0; w < B; ++w) acc += ds_w[static_cast<size_t>(w) * n + e];
  dbias[e] = acc;
}

}  // namespace
