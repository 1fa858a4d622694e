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
// or written once. The exp is the SFU's ex2 on w1 log2(e) quad: one
// instruction where expf takes eight (about 35 instructions a pair in all,
// 15% less time on the card).
//
// Design. One warp owns one Gaussian (eight a 256-thread block, in the
// order of the rows). The lanes deal out the pixels of its box, clipped to
// the canvas, in row-major order: lane j takes pixels j, j + 32, j + 64, ...,
// stepping through the rows with no division, and reads their cotangent
// from global memory (neighbouring lanes, neighbouring pixels; the block's
// eight Gaussians are neighbours, so their boxes share most of their lines
// in L1). Every lane but the last few does the same number of pairs, so the
// work is balanced whatever the box's size or position, and no barrier is
// needed. Each lane keeps eight partial sums in a fixed order; a fixed xor
// shuffle tree adds them once per Gaussian, and sixteen lanes write the
// geometry row, three the colors. Every sum has one owner and a fixed order:
// deterministic without atomics, every output written once. The chunk
// boxes that R walks are not needed: each warp reads only its own box.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kGeomCols = 16;
constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

// 2^x on the SFU: one MUFU.EX2 (relative error about 2^-22; results below
// 2^-126 flushed to 0), where expf takes eight instructions.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
raster_bwd_kernel(const float* __restrict__ geom, const float* __restrict__ col,
                  const float* __restrict__ g, float* __restrict__ dgeom,
                  float* __restrict__ dcol, int n, int h, int w) {
  const int lane = threadIdx.x & 31;
  const int gi = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (gi >= n) return;  // the whole warp
  const float* gr = geom + static_cast<size_t>(gi) * kGeomCols;
  const float sx = __ldg(gr), sy = __ldg(gr + 1), rho = __ldg(gr + 2);
  const float cx = __ldg(gr + 3), cy = __ldg(gr + 4);
  const float xlo = __ldg(gr + 5), xhi = __ldg(gr + 6);
  const float ylo = __ldg(gr + 7), yhi = __ldg(gr + 8);
  const float* cp = col + static_cast<size_t>(gi) * 3;
  const float cr = __ldg(cp), cg = __ldg(cp + 1), cb = __ldg(cp + 2);
  const float inv_sx = 1.0f / sx;
  const float inv_sy = 1.0f / sy;
  const float w2 = inv_sx * inv_sx;
  const float w3 = inv_sx * inv_sy;
  const float w4 = inv_sy * inv_sy;
  const float w1 = -0.5f / (1.0f - rho * rho);
  const float c2 = 2.0f * rho * w3;
  // the exponent in base 2, for the SFU's ex2
  const float w1l = w1 * 1.44269504088896341f;

  float d_r = 0.f, d_g = 0.f, d_b = 0.f;
  float s_x = 0.f, s_y = 0.f, s_xx = 0.f, s_yy = 0.f, s_xy = 0.f;

  // The box's integer pixels on the canvas: x0 <= x <= x1, y0 <= y <= y1
  // (empty for an inverted box or a NaN bound, which hold no pixel).
  const float x0 = fmaxf(ceilf(xlo), 0.f);
  const float x1 = fminf(floorf(xhi), static_cast<float>(w - 1));
  const float y0 = fmaxf(ceilf(ylo), 0.f);
  const float y1 = fminf(floorf(yhi), static_cast<float>(h - 1));
  if (xlo <= xhi && ylo <= yhi && x0 <= x1 && y0 <= y1) {
    const int bw = static_cast<int>(x1 - x0) + 1;
    const int npix = bw * (static_cast<int>(y1 - y0) + 1);
    // 32 pixels on: q rows and r columns, one row more when the column
    // passes x1; fx and fy stay exact integers
    const int q = 32 / bw, r = 32 - q * bw;
    const int ly = lane / bw;
    float fx = x0 + static_cast<float>(lane - ly * bw);
    float fy = y0 + static_cast<float>(ly);
    const float* gp =
        g + (static_cast<size_t>(fy) * w + static_cast<size_t>(fx)) * 3;
    const ptrdiff_t step = (static_cast<ptrdiff_t>(q) * w + r) * 3;
    const ptrdiff_t wrap = static_cast<ptrdiff_t>(w - bw) * 3;
    const float fr = static_cast<float>(r), fq = static_cast<float>(q);
    const float fbw = static_cast<float>(bw);
    for (int k = lane; k < npix; k += 32) {
      const float g0 = __ldg(gp), g1 = __ldg(gp + 1), g2 = __ldg(gp + 2);
      const float dx = fx - cx;
      const float dy = fy - cy;
      const float dx2 = dx * dx;
      const float dy2 = dy * dy;
      const float dxdy = dx * dy;
      const float quad = w2 * dx2 - c2 * dxdy + w4 * dy2;
      const float v = ex2(w1l * quad);
      d_r = fmaf(g0, v, d_r);
      d_g = fmaf(g1, v, d_g);
      d_b = fmaf(g2, v, d_b);
      const float at = (g0 * cr + g1 * cg + g2 * cb) * v;
      s_x = fmaf(at, dx, s_x);
      s_y = fmaf(at, dy, s_y);
      s_xx = fmaf(at, dx2, s_xx);
      s_yy = fmaf(at, dy2, s_yy);
      s_xy = fmaf(at, dxdy, s_xy);
      fx += fr;
      fy += fq;
      gp += step;
      if (fx > x1) {
        fx -= fbw;
        fy += 1.f;
        gp += wrap;
      }
    }
  }
  d_r = warp_sum(d_r);
  d_g = warp_sum(d_g);
  d_b = warp_sum(d_b);
  s_x = warp_sum(s_x);
  s_y = warp_sum(s_y);
  s_xx = warp_sum(s_xx);
  s_yy = warp_sum(s_yy);
  s_xy = warp_sum(s_xy);

  const float c1 = 2.0f * w1;
  const float rw3 = rho * w3;
  const float s_q = w2 * s_xx - 2.0f * rw3 * s_xy + w4 * s_yy;
  float v = 0.f;
  if (lane == 0) v = c1 * inv_sx * (rw3 * s_xy - w2 * s_xx);
  if (lane == 1) v = c1 * inv_sy * (rw3 * s_xy - w4 * s_yy);
  if (lane == 2) v = -c1 * (2.0f * w1 * rho * s_q + w3 * s_xy);
  if (lane == 3) v = c1 * (rw3 * s_y - w2 * s_x);
  if (lane == 4) v = c1 * (rw3 * s_x - w4 * s_y);
  if (lane < kGeomCols) dgeom[static_cast<size_t>(gi) * kGeomCols + lane] = v;
  if (lane >= 16 && lane < 19)
    dcol[static_cast<size_t>(gi) * 3 + lane - 16] =
        lane == 16 ? d_r : lane == 17 ? d_g : d_b;
}

}  // namespace

// geom (n, 16), col (n, 3), g (h, w, 3); dgeom (n, 16) and dcol (n, 3) are
// written whole. All float32, contiguous, on the device.
extern "C" int raster_bwd(const float* geom, const float* col, const float* g,
                          float* dgeom, float* dcol, int n, int h, int w,
                          void* stream) {
  if (n < 1 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  raster_bwd_kernel<<<(n + kWarps - 1) / kWarps, kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(geom, col, g, dgeom,
                                                           dcol, n, h, w);
  return static_cast<int>(cudaGetLastError());
}
