// Kernel RB: analytic backward of the tile rasterizer (kernel R).
//
// Replaces the Pallas backward of gsasr_tpu/ops/rasterizer.py, which comes
// in two forms computing one function, both reached from _raster_bwd_call:
// _bwd_kernel (dense chunks x tiles with a chunk-box skip, body _bwd_body)
// and _bwd_kernel_windowed (each chunk walks its tile rectangle). For the
// output cotangent g (H, W, 3), per Gaussian with v its masked kernel value
// at pixel p (see raster_fwd.cu) and dx, dy the pixel's offset from its
// center:
//
//   dcol[c] = sum_p g[p, c] v
//   at      = (sum_c g[p, c] col[c]) v
//   S = sum_p at * {dx, dy, dx^2, dy^2, dx dy}
//
// and the per-Gaussian coefficients turn S into d(sx, sy, rho, cx, cy) after
// the walk, exactly as _bwd_body does. Geometry columns 5-15 (the cull boxes
// and the zero pad) get exactly zero.
//
// What bounds it on an H100: the arithmetic on the (pixel, Gaussian) pairs
// inside the cull boxes, about 35 FP32 operations and one exp each; the
// geometry, colors and their gradients (88 bytes a Gaussian) and g are read
// or written once.
//
// Design. One 256-thread block owns one chunk of at most 256 Gaussians, one
// Gaussian per thread, and keeps its eight sums in registers. The block
// walks, in ascending row-major order, the 16x16 pixel tiles that the
// chunk's box union touches on the canvas, staging each tile's g in shared
// memory; each thread then visits the pixels of the tile inside its own box,
// row by row. Every sum has one owner and a fixed order, so the result is
// deterministic without atomics, and there is no window capacity and no
// overflow fallback: one kernel covers the dense and the windowed forms.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kMaxGc = kThreads;
constexpr int kGeomCols = 16;

__global__ void __launch_bounds__(kThreads)
raster_bwd_kernel(const float* __restrict__ geom, const float* __restrict__ col,
                  const float* __restrict__ bbox, const float* __restrict__ g,
                  float* __restrict__ dgeom, float* __restrict__ dcol, int kc,
                  int gc, int h, int w) {
  __shared__ float s_g[3][kThreads];
  const int chunk = blockIdx.x;
  const int tid = threadIdx.x;
  const bool live = tid < gc;
  const size_t gi = static_cast<size_t>(chunk) * gc + tid;

  float sx = 1.f, sy = 1.f, rho = 0.f, cx = 0.f, cy = 0.f;
  float xlo = 1.f, xhi = 0.f, ylo = 1.f, yhi = 0.f;
  float cr = 0.f, cg = 0.f, cb = 0.f;
  if (live) {
    const float* gr = geom + gi * kGeomCols;
    sx = gr[0];
    sy = gr[1];
    rho = gr[2];
    cx = gr[3];
    cy = gr[4];
    xlo = gr[5];
    xhi = gr[6];
    ylo = gr[7];
    yhi = gr[8];
    cr = col[gi * 3];
    cg = col[gi * 3 + 1];
    cb = col[gi * 3 + 2];
  }
  const float inv_sx = 1.0f / sx;
  const float inv_sy = 1.0f / sy;
  const float w2 = inv_sx * inv_sx;
  const float w3 = inv_sx * inv_sy;
  const float w4 = inv_sy * inv_sy;
  const float w1 = -0.5f / (1.0f - rho * rho);
  const float c2 = 2.0f * rho * w3;

  float d_r = 0.f, d_g = 0.f, d_b = 0.f;
  float s_x = 0.f, s_y = 0.f, s_xx = 0.f, s_yy = 0.f, s_xy = 0.f;

  // The chunk's box union clipped to the canvas (uniform over the block).
  const float bx0 = fmaxf(ceilf(bbox[chunk]), 0.f);
  const float bx1 = fminf(floorf(bbox[kc + chunk]), static_cast<float>(w - 1));
  const float by0 = fmaxf(ceilf(bbox[2 * kc + chunk]), 0.f);
  const float by1 = fminf(floorf(bbox[3 * kc + chunk]), static_cast<float>(h - 1));
  if (bx0 <= bx1 && by0 <= by1) {
    const int tx0 = static_cast<int>(bx0) / kTile;
    const int tx1 = static_cast<int>(bx1) / kTile;
    const int ty0 = static_cast<int>(by0) / kTile;
    const int ty1 = static_cast<int>(by1) / kTile;
    for (int ty = ty0; ty <= ty1; ++ty) {
      for (int tx = tx0; tx <= tx1; ++tx) {
        const int px0 = tx * kTile;
        const int py0 = ty * kTile;
        {
          const int px = px0 + (tid % kTile);
          const int py = py0 + (tid / kTile);
          const bool in = px < w && py < h;
          const float* gp = g + (static_cast<size_t>(py) * w + px) * 3;
          __syncthreads();  // the previous tile's g is no longer read
          s_g[0][tid] = in ? gp[0] : 0.f;
          s_g[1][tid] = in ? gp[1] : 0.f;
          s_g[2][tid] = in ? gp[2] : 0.f;
          __syncthreads();
        }
        if (!live) continue;
        // This Gaussian's box inside the tile and the canvas.
        const float x0 = fmaxf(ceilf(xlo), static_cast<float>(px0));
        const float x1 = fminf(floorf(xhi),
                               static_cast<float>(min(px0 + kTile, w) - 1));
        const float y0 = fmaxf(ceilf(ylo), static_cast<float>(py0));
        const float y1 = fminf(floorf(yhi),
                               static_cast<float>(min(py0 + kTile, h) - 1));
        if (!(x0 <= x1 && y0 <= y1)) continue;
        const int ix0 = static_cast<int>(x0), ix1 = static_cast<int>(x1);
        const int iy0 = static_cast<int>(y0), iy1 = static_cast<int>(y1);
        for (int y = iy0; y <= iy1; ++y) {
          const float fy = static_cast<float>(y);
          const float dy = fy - cy;
          const float dy2 = dy * dy;
          const int row = (y - py0) * kTile - px0;
          for (int x = ix0; x <= ix1; ++x) {
            const float fx = static_cast<float>(x);
            if (!(fx >= xlo && fx <= xhi && fy >= ylo && fy <= yhi)) continue;
            const float dx = fx - cx;
            const float dx2 = dx * dx;
            const float dxdy = dx * dy;
            const float quad = w2 * dx2 - c2 * dxdy + w4 * dy2;
            const float v = expf(w1 * quad);
            const float g0 = s_g[0][row + x];
            const float g1 = s_g[1][row + x];
            const float g2 = s_g[2][row + x];
            d_r = fmaf(g0, v, d_r);
            d_g = fmaf(g1, v, d_g);
            d_b = fmaf(g2, v, d_b);
            const float at = (g0 * cr + g1 * cg + g2 * cb) * v;
            s_x = fmaf(at, dx, s_x);
            s_y = fmaf(at, dy, s_y);
            s_xx = fmaf(at, dx2, s_xx);
            s_yy = fmaf(at, dy2, s_yy);
            s_xy = fmaf(at, dxdy, s_xy);
          }
        }
      }
    }
  }
  if (!live) return;
  const float c1 = 2.0f * w1;
  const float rw3 = rho * w3;
  const float s_q = w2 * s_xx - 2.0f * rw3 * s_xy + w4 * s_yy;
  float* dg = dgeom + gi * kGeomCols;
  dg[0] = c1 * inv_sx * (rw3 * s_xy - w2 * s_xx);
  dg[1] = c1 * inv_sy * (rw3 * s_xy - w4 * s_yy);
  dg[2] = -c1 * (2.0f * w1 * rho * s_q + w3 * s_xy);
  dg[3] = c1 * (rw3 * s_y - w2 * s_x);
  dg[4] = c1 * (rw3 * s_x - w4 * s_y);
#pragma unroll
  for (int c = 5; c < kGeomCols; ++c) dg[c] = 0.f;
  dcol[gi * 3] = d_r;
  dcol[gi * 3 + 1] = d_g;
  dcol[gi * 3 + 2] = d_b;
}

}  // namespace

// geom (kc*gc, 16), col (kc*gc, 3), bbox (4, kc) [xlo, xhi, ylo, yhi] chunk
// unions, g (h, w, 3); dgeom (kc*gc, 16) and dcol (kc*gc, 3) are written
// whole. All float32, contiguous, on the device.
extern "C" int raster_bwd(const float* geom, const float* col,
                          const float* bbox, const float* g, float* dgeom,
                          float* dcol, int kc, int gc, int h, int w,
                          void* stream) {
  if (kc < 1 || gc < 1 || gc > kMaxGc || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  raster_bwd_kernel<<<kc, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      geom, col, bbox, g, dgeom, dcol, kc, gc, h, w);
  return static_cast<int>(cudaGetLastError());
}
