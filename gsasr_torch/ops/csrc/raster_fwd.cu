// Kernel R: tile rasterizer forward for 2D Gaussian splatting.
//
// Replaces the Pallas forward of gsasr_tpu/ops/rasterizer.py, which comes in
// three forms computing one function: _fwd_kernel_list (the default, over a
// list of engaged (tile, chunk) pairs), _fwd_kernel_windowed (per-tile chunk
// ranges) and _fwd_kernel (dense tiles x chunks with a chunk-box skip).
//
//   out[p, c] = sum_g [p in box_g] * exp(w1 * (w2 dx^2 - 2 rho w3 dx dy
//               + w4 dy^2)) * col[g, c]
//
// with w1 = -0.5 / (1 - rho^2), w2 = 1/sx^2, w3 = 1/(sx sy), w4 = 1/sy^2 and
// the inclusive pixel-unit cull box xlo <= x <= xhi, ylo <= y <= yhi.
//
// What bounds it on an H100: the arithmetic on the (pixel, Gaussian) pairs
// inside the cull boxes, about 24 FP32 operations and one exp each; the
// geometry (64 bytes a Gaussian) and the image are read and written once.
//
// Design. One 256-thread block owns one 16x16 pixel tile, one thread per
// pixel, and keeps the pixel's three sums in registers. The block walks the
// chunks in ascending order: 256 chunk boxes at a time are tested against the
// tile, the engaged ones are listed in ascending order through a warp ballot
// and a prefix over the warps, then each engaged chunk's Gaussians are staged
// in shared memory (their quadratic-form coefficients computed once while
// staging) and every thread evaluates them against its pixel, skipping those
// whose box misses it. The walk order fixes the summation order, so the
// result is deterministic without atomics and needs no list capacity and no
// fallback. Chunks that miss the tile cost one box test.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kMaxGc = kThreads;
constexpr int kGeomCols = 16;

__global__ void __launch_bounds__(kThreads)
raster_fwd_kernel(const float* __restrict__ geom,
                  const float* __restrict__ col,
                  const float* __restrict__ bbox, float* __restrict__ out,
                  int kc, int gc, int h, int w) {
  __shared__ float s_cx[kMaxGc], s_cy[kMaxGc], s_w1[kMaxGc], s_w2[kMaxGc],
      s_c2[kMaxGc], s_w4[kMaxGc], s_xlo[kMaxGc], s_xhi[kMaxGc],
      s_ylo[kMaxGc], s_yhi[kMaxGc], s_r[kMaxGc], s_g[kMaxGc], s_b[kMaxGc];
  __shared__ int s_list[kThreads];
  __shared__ int s_wcount[kThreads / 32];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int px = x0 + (tid % kTile);
  const int py = y0 + (tid / kTile);
  const float fx = static_cast<float>(px);
  const float fy = static_cast<float>(py);
  const float tx0 = static_cast<float>(x0);
  const float ty0 = static_cast<float>(y0);
  const float tx1 = static_cast<float>(x0 + kTile - 1);
  const float ty1 = static_cast<float>(y0 + kTile - 1);

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f;

  for (int base = 0; base < kc; base += kThreads) {
    const int k = base + tid;
    bool hit = false;
    if (k < kc) {
      hit = bbox[k] <= tx1 && bbox[kc + k] >= tx0 && bbox[2 * kc + k] <= ty1 &&
            bbox[3 * kc + k] >= ty0;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_wcount[warp] = __popc(mask);
    __syncthreads();
    int offset = 0, total = 0;
    for (int i = 0; i < kThreads / 32; ++i) {
      const int c = s_wcount[i];
      if (i < warp) offset += c;
      total += c;
    }
    if (hit) s_list[offset + __popc(mask & ((1u << lane) - 1u))] = k;
    __syncthreads();

    for (int e = 0; e < total; ++e) {
      const int chunk = s_list[e];
      if (tid < gc) {
        const float* g = geom + (static_cast<size_t>(chunk) * gc + tid) * kGeomCols;
        const float sx = g[0], sy = g[1], rho = g[2];
        const float inv_sx = 1.0f / sx;
        const float inv_sy = 1.0f / sy;
        const float w3 = inv_sx * inv_sy;
        s_w1[tid] = -0.5f / (1.0f - rho * rho);
        s_w2[tid] = inv_sx * inv_sx;
        s_c2[tid] = 2.0f * rho * w3;
        s_w4[tid] = inv_sy * inv_sy;
        s_cx[tid] = g[3];
        s_cy[tid] = g[4];
        s_xlo[tid] = g[5];
        s_xhi[tid] = g[6];
        s_ylo[tid] = g[7];
        s_yhi[tid] = g[8];
        const float* c = col + (static_cast<size_t>(chunk) * gc + tid) * 3;
        s_r[tid] = c[0];
        s_g[tid] = c[1];
        s_b[tid] = c[2];
      }
      __syncthreads();
      for (int i = 0; i < gc; ++i) {
        if (fx >= s_xlo[i] && fx <= s_xhi[i] && fy >= s_ylo[i] &&
            fy <= s_yhi[i]) {
          const float dx = fx - s_cx[i];
          const float dy = fy - s_cy[i];
          const float quad =
              s_w2[i] * (dx * dx) - s_c2[i] * (dx * dy) + s_w4[i] * (dy * dy);
          const float v = expf(s_w1[i] * quad);
          acc_r += v * s_r[i];
          acc_g += v * s_g[i];
          acc_b += v * s_b[i];
        }
      }
      __syncthreads();
    }
  }
  if (px < w && py < h) {
    float* o = out + (static_cast<size_t>(py) * w + px) * 3;
    o[0] = acc_r;
    o[1] = acc_g;
    o[2] = acc_b;
  }
}

}  // namespace

// geom (kc*gc, 16), col (kc*gc, 3), bbox (4, kc) [xlo, xhi, ylo, yhi] chunk
// unions, out (h, w, 3); all float32, contiguous, on the device.
extern "C" int raster_fwd(const float* geom, const float* col,
                          const float* bbox, float* out, int kc, int gc, int h,
                          int w, void* stream) {
  if (gc < 1 || gc > kMaxGc) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  raster_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      geom, col, bbox, out, kc, gc, h, w);
  return static_cast<int>(cudaGetLastError());
}
