// Kernel R: tile rasterizer forward for 2D Gaussian splatting, and kernel
// R-exact, its form over exact per-tile Gaussian lists.
//
// R replaces the Pallas forward of gsasr_tpu/ops/rasterizer.py, which comes
// in three forms computing one function: _fwd_kernel_list (the default, over
// a list of engaged (tile, chunk) pairs), _fwd_kernel_windowed (per-tile
// chunk ranges) and _fwd_kernel (dense tiles x chunks with a chunk-box
// skip). R-exact replaces _raster_fwd_call_exact (gs_render(...,
// binning="exact")), the same _fwd_kernel_list body over the per-tile lists
// that _exact_tables builds.
//
//   out[p, c] = sum_g [p in box_g] * exp(w1 * (w2 dx^2 - 2 rho w3 dx dy
//               + w4 dy^2)) * col[g, c]
//
// with w1 = -0.5 / (1 - rho^2), w2 = 1/sx^2, w3 = 1/(sx sy), w4 = 1/sy^2 and
// the inclusive pixel-unit cull box xlo <= x <= xhi, ylo <= y <= yhi.
//
// What bounds both on an H100: the arithmetic on the (pixel, Gaussian) pairs
// inside the cull boxes, about 24 FP32 operations and one exp each; the
// geometry (64 bytes a Gaussian) and the image are read and written once.
//
// Design of R. One 256-thread block owns one 16x16 pixel tile, one thread per
// pixel, and keeps the pixel's three sums in registers. The block walks the
// chunks in ascending order: 256 chunk boxes at a time are tested against the
// tile, the engaged ones are listed in ascending order through a warp ballot
// and a prefix over the warps, then each engaged chunk's Gaussians are staged
// in shared memory (their quadratic-form coefficients computed once while
// staging) and every thread evaluates them against its pixel, skipping those
// whose box misses it. The walk order fixes the summation order, so the
// result is deterministic without atomics and needs no list capacity and no
// fallback. Chunks that miss the tile cost one box test.
//
// Design of R-exact. The lists keep the JAX package's bins: tiles of 8 x 128
// pixels, each owning a segment of 256-slot chunks of indices into the
// Gaussians sorted by their corner tile (tab[k] = tile * 4 + flag + 1, flag
// 1 for a segment's first chunk, 0 for the rest, -1 for unused capacity;
// slots past a tile's members hold the pad index, an empty box). One
// 256-thread block per list tile, 4 pixels a thread: the block finds its
// segment by a binary search of tab (tiles never decrease along it), stages
// each chunk through the list indices with R's staging (the gather of the
// Gaussians happens there, so no list-ordered copy of the geometry is
// written) and evaluates it with R's per-pixel code. Each warp owns a 16 x 8
// sub-rectangle of the tile and skips a Gaussian whose box misses it with a
// test that is uniform over the warp: a trained box (about 32 px) misses
// most of a tile's 128 columns. Each pixel sums its segment in slot order in
// registers and is written once: no atomics, the same bits every launch.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kMaxGc = kThreads;
constexpr int kGeomCols = 16;
// R-exact: the list tiles of the JAX package (8 x 128 pixels), chunks of one
// slot a thread, 4 pixels a thread, and each warp's 16 x 8 sub-rectangle.
constexpr int kListTh = 8;
constexpr int kListTw = 128;
constexpr int kListGc = kThreads;
constexpr int kPixPer = kListTh * kListTw / kThreads;
constexpr int kSubW = 16;
static_assert(kSubW * (kThreads / 32) == kListTw &&
                  kPixPer * (32 / kSubW) == kListTh,
              "the warps' sub-rectangles tile the list tile");

// One staged chunk: each Gaussian's quadratic-form coefficients, its
// inclusive cull box and its color, the coefficients computed once.
struct Chunk {
  float cx[kMaxGc], cy[kMaxGc], w1[kMaxGc], w2[kMaxGc], c2[kMaxGc],
      w4[kMaxGc], xlo[kMaxGc], xhi[kMaxGc], ylo[kMaxGc], yhi[kMaxGc],
      r[kMaxGc], g[kMaxGc], b[kMaxGc];
};

// Stages the geometry row g (16 floats) and color c (3) into slot i.
__device__ __forceinline__ void stage_gaussian(Chunk& s, int i,
                                               const float* __restrict__ g,
                                               const float* __restrict__ c) {
  const float sx = g[0], sy = g[1], rho = g[2];
  const float inv_sx = 1.0f / sx;
  const float inv_sy = 1.0f / sy;
  const float w3 = inv_sx * inv_sy;
  s.w1[i] = -0.5f / (1.0f - rho * rho);
  s.w2[i] = inv_sx * inv_sx;
  s.c2[i] = 2.0f * rho * w3;
  s.w4[i] = inv_sy * inv_sy;
  s.cx[i] = g[3];
  s.cy[i] = g[4];
  s.xlo[i] = g[5];
  s.xhi[i] = g[6];
  s.ylo[i] = g[7];
  s.yhi[i] = g[8];
  s.r[i] = c[0];
  s.g[i] = c[1];
  s.b[i] = c[2];
}

// Stages an empty slot i: the lists' pad index (the JAX package's appended
// pad column), unit sigmas and an inverted box, so it adds nothing.
__device__ __forceinline__ void stage_empty(Chunk& s, int i) {
  s.w1[i] = -0.5f;
  s.w2[i] = s.w4[i] = 1.f;
  s.c2[i] = s.cx[i] = s.cy[i] = 0.f;
  s.xlo[i] = s.ylo[i] = 1e9f;
  s.xhi[i] = s.yhi[i] = -1e9f;
  s.r[i] = s.g[i] = s.b[i] = 0.f;
}

// Adds staged Gaussian i at pixel (fx, fy) to the sums when the pixel lies
// in its inclusive box.
__device__ __forceinline__ void add_gaussian(const Chunk& s, int i, float fx,
                                             float fy, float& acc_r,
                                             float& acc_g, float& acc_b) {
  if (fx >= s.xlo[i] && fx <= s.xhi[i] && fy >= s.ylo[i] && fy <= s.yhi[i]) {
    const float dx = fx - s.cx[i];
    const float dy = fy - s.cy[i];
    const float quad =
        s.w2[i] * (dx * dx) - s.c2[i] * (dx * dy) + s.w4[i] * (dy * dy);
    const float v = expf(s.w1[i] * quad);
    acc_r += v * s.r[i];
    acc_g += v * s.g[i];
    acc_b += v * s.b[i];
  }
}

__global__ void __launch_bounds__(kThreads)
raster_fwd_kernel(const float* __restrict__ geom,
                  const float* __restrict__ col,
                  const float* __restrict__ bbox, float* __restrict__ out,
                  int kc, int gc, int h, int w) {
  __shared__ Chunk s;
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
        const size_t row = static_cast<size_t>(chunk) * gc + tid;
        stage_gaussian(s, tid, geom + row * kGeomCols, col + row * 3);
      }
      __syncthreads();
      for (int i = 0; i < gc; ++i)
        add_gaussian(s, i, fx, fy, acc_r, acc_g, acc_b);
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

__global__ void __launch_bounds__(kThreads)
raster_fwd_exact_kernel(const float* __restrict__ geom,
                        const float* __restrict__ col,
                        const int* __restrict__ list_idx,
                        const int* __restrict__ tab, float* __restrict__ out,
                        int n, int nchunks, int h, int w, int n_tw) {
  __shared__ Chunk s;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ti = t / n_tw;
  // the warp's 16 x 8 sub-rectangle; lane l owns column l % 16 of rows
  // l / 16 + 2 p
  const int x0 = (t - ti * n_tw) * kListTw + warp * kSubW;
  const int y0 = ti * kListTh;
  const float wx0 = static_cast<float>(x0);
  const float wx1 = static_cast<float>(x0 + kSubW - 1);
  const float wy0 = static_cast<float>(y0);
  const float wy1 = static_cast<float>(y0 + kListTh - 1);
  const int px = x0 + lane % kSubW;
  const float fx = static_cast<float>(px);
  float fy[kPixPer], acc[kPixPer][3];
#pragma unroll
  for (int p = 0; p < kPixPer; ++p) {
    fy[p] = static_cast<float>(y0 + lane / kSubW + 2 * p);
    acc[p][0] = acc[p][1] = acc[p][2] = 0.f;
  }

  // the segment's first chunk: the first k with tab[k] / 4 >= t
  int lo = 0, hi = nchunks;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((tab[mid] >> 2) < t)
      lo = mid + 1;
    else
      hi = mid;
  }
  // its first chunk has flag 1 (code t * 4 + 2), the rest flag 0 (t * 4 + 1)
  for (int k = lo; k < nchunks && tab[k] == t * 4 + (k == lo ? 2 : 1); ++k) {
    __syncthreads();
    const int idx = list_idx[static_cast<size_t>(k) * kListGc + tid];
    if (idx >= 0 && idx < n)
      stage_gaussian(s, tid, geom + static_cast<size_t>(idx) * kGeomCols,
                     col + static_cast<size_t>(idx) * 3);
    else
      stage_empty(s, tid);
    __syncthreads();
    for (int i = 0; i < kListGc; ++i) {
      if (s.xlo[i] > wx1 || s.xhi[i] < wx0 || s.ylo[i] > wy1 || s.yhi[i] < wy0)
        continue;
#pragma unroll
      for (int p = 0; p < kPixPer; ++p)
        add_gaussian(s, i, fx, fy[p], acc[p][0], acc[p][1], acc[p][2]);
    }
  }
#pragma unroll
  for (int p = 0; p < kPixPer; ++p) {
    const int py = y0 + lane / kSubW + 2 * p;
    if (px < w && py < h) {
      float* o = out + (static_cast<size_t>(py) * w + px) * 3;
      o[0] = acc[p][0];
      o[1] = acc[p][1];
      o[2] = acc[p][2];
    }
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

// Kernel R-exact: geom (n, 16) and col (n, 3) the Gaussians sorted by corner
// tile; list_idx (nchunks * 256) int32 indices into them (n or more: an
// empty slot); tab (nchunks) int32 the packed chunk table; out (h, w, 3). All
// contiguous, on the device.
extern "C" int raster_fwd_exact(const float* geom, const float* col,
                                const int* list_idx, const int* tab,
                                float* out, int n, int nchunks, int h, int w,
                                void* stream) {
  if (n < 0 || nchunks < 1 || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_th = (h + kListTh - 1) / kListTh;
  const int n_tw = (w + kListTw - 1) / kListTw;
  raster_fwd_exact_kernel<<<n_th * n_tw, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      geom, col, list_idx, tab, out, n, nchunks, h, w, n_tw);
  return static_cast<int>(cudaGetLastError());
}
