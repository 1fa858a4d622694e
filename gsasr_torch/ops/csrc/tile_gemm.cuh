// Shared pieces of the decoder-layer and window-attention kernels: warp
// reductions, the limits of the decoder-layer kernels' rows (their
// products are tile_mma.cuh's and tile_mma_bwd.cuh's), and the activation
// types.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gsasr {

// Activations are stored as float or, in the bfloat16 forms of M and A, as
// __nv_bfloat16; either widens to f32 on load. rnd<Act> rounds an f32
// value to Act and back (the identity for float): the casts of the Pallas
// kernels before a product or a store.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename Act>
__device__ __forceinline__ Act from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename Act>
__device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<Act>(v));
}

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Widest row of the decoder-layer kernels' products: C, hidden <= kMaxN.
constexpr int kMaxN = 192;
// LayerNorm row width handled per lane: C <= 32 * kLnPer.
constexpr int kLnPer = 6;
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace gsasr
