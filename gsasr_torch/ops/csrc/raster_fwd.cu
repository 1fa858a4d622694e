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
// Design of R. One 128-thread block owns one 16 x 16 pixel tile; each of
// its four warps owns an 8 x 8 sub-rectangle, two pixels a lane (one
// column, rows four apart), and keeps each pixel's three sums in
// registers. The block walks the chunks in ascending order: 128 chunk
// boxes at a time are tested against the tile and the engaged ones listed
// in ascending order (a warp ballot and a prefix over the warps). Of each
// engaged chunk, each thread reads two Gaussians' boxes (two aligned
// 16-byte loads each) and tests them against the tile; the hits are
// compacted, again in ascending order, into a staging list in shared
// memory, their quadratic-form coefficients computed once there. Several
// chunks' hits share one list (up to kStageCap), so the pixel loop and its
// two barriers run once per list and not once per chunk. In the pixel loop
// each warp tests 32 staged boxes at once against its sub-rectangle (one
// ballot) and visits only the hits, in ascending order; a group of four
// rows that the box misses is skipped by the whole warp, and a lane adds a
// Gaussian whose box holds its pixel. A staged Gaussian's 13 values and its
// dx are read and computed once for two pixels: with one pixel a lane the
// loads of the staged values alone kept the shared-memory pipe busy, and
// with four (8 x 16 sub-rectangles) a 720 x 720 canvas has too few tiles
// to fill the card evenly (PERF.md). A Gaussian skipped by any cull has a box
// that misses every pixel it is skipped for, so every pixel adds the same
// terms in the same order, with the same arithmetic (add_at), as a walk
// over every staged Gaussian would: the culls change no bit of the image.
// The walk order fixes the summation order, so the result is deterministic
// without atomics and needs no list capacity and no fallback.
//
// Design of R-exact. The lists keep the JAX package's bins: tiles of 8 x 128
// pixels, each owning a segment of 256-slot chunks of indices into the
// Gaussians sorted by their corner tile (tab[k] = tile * 4 + flag + 1, flag
// 1 for a segment's first chunk, 0 for the rest, -1 for unused capacity;
// slots past a tile's members hold the pad index, an empty box). One
// 256-thread block per list tile: the block finds its segment by a binary
// search of tab (tiles never decrease along it) and walks its chunks in
// order, R's design on exact lists. Each chunk's occupied slots (index
// below n; pad slots are dropped) go in slot order into R's staging list
// (a ballot and a prefix over the warps, one barrier a chunk), their
// coefficients computed once there, and several chunks share one list (up
// to kStageCap), so the pixel loop and its two barriers run once a list.
// Each warp owns a 16 x 8 sub-rectangle of the tile, lane l column l % 16
// and four pixels down it (rows l / 16 + 2 p), and culls 32 staged boxes at
// once against the sub-rectangle (one ballot), visiting only the hits in
// ascending order; a pair of rows that the box misses is skipped by the
// whole warp, and a staged Gaussian's 13 values and its dx are read and
// computed once for the lane's four pixels (raster_list, shared with R).
// A Gaussian is skipped for a pixel only where its box misses the pixel,
// so every pixel adds the same Gaussians in the same slot order, through
// add_at, as the one-thread-a-pixel walk over every slot did: that walk's
// bits, no atomics, and the same bits every launch. The lists come from
// kernel XB (exact_build.cu).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kGeomCols = 16;
constexpr int kMaxGc = 256;
// R: blocks of kRThreads; each warp's sub-rectangle of kRectW columns and
// kRectH rows, kPix pixels a lane (one column, rows kLaneRows apart), two
// across and two down a tile of kTileW x kTileH; a chunk's Gaussians
// culled in kSlices slices of kRThreads; the staging list's capacity in
// Gaussians.
constexpr int kRThreads = 128;
constexpr int kRWarps = kRThreads / 32;
constexpr int kPix = 2;
constexpr int kRectW = 8;
constexpr int kLaneRows = 32 / kRectW;
constexpr int kRectH = kLaneRows * kPix;
constexpr int kRectCols = 2;
constexpr int kTileW = kRectCols * kRectW;
constexpr int kTileH = (kRWarps / kRectCols) * kRectH;
constexpr int kSlices = kMaxGc / kRThreads;
constexpr int kStageCap = 512;
static_assert(kStageCap >= kMaxGc, "a chunk's hits fit an empty list");
// R-exact: the list tiles of the JAX package (8 x 128 pixels), chunks of one
// slot a thread, 4 pixels a thread, and each warp's 16 x 8 sub-rectangle.
constexpr int kThreads = 256;
constexpr int kListTh = 8;
constexpr int kListTw = 128;
constexpr int kListGc = kThreads;
constexpr int kPixPer = kListTh * kListTw / kThreads;
constexpr int kSubW = 16;
static_assert(kSubW * (kThreads / 32) == kListTw &&
                  kPixPer * (32 / kSubW) == kListTh,
              "the warps' sub-rectangles tile the list tile");

// The quadratic-form coefficients of a Gaussian: w1, w2, 2 rho w3 and w4.
struct Coeffs {
  float w1, w2, c2, w4;
};

__device__ __forceinline__ Coeffs coeffs(float sx, float sy, float rho) {
  const float inv_sx = 1.0f / sx;
  const float inv_sy = 1.0f / sy;
  const float w3 = inv_sx * inv_sy;
  return {-0.5f / (1.0f - rho * rho), inv_sx * inv_sx, 2.0f * rho * w3,
          inv_sy * inv_sy};
}

// Adds a Gaussian (coefficients w1, w2, c2, w4; color r, g, b) at a pixel
// dx, dy from its center (dxx = dx^2), which lies in its box, to the sums:
//   acc += exp(w1 * (w2 dx^2 - c2 dx dy + w4 dy^2)) * color.
// Each rounding is written out (the products, then fma(dx^2, w2, -c2 dx
// dy), fma(dy^2, w4, .), and fma for the sums), so the bits do not depend
// on which products the compiler would contract into which FMA: these are
// the ones it chose for the one-pixel-a-thread walk this kernel replaced,
// so the image keeps that walk's bits. R and R-exact share add_at, so both
// give the bits of one arithmetic.
__device__ __forceinline__ void add_at(float dx, float dxx, float dy,
                                       float w1, float w2, float c2, float w4,
                                       float r, float g, float b,
                                       float& acc_r, float& acc_g,
                                       float& acc_b) {
  const float cross = __fmul_rn(__fmul_rn(dx, dy), c2);
  float quad = __fmaf_rn(dxx, w2, -cross);
  quad = __fmaf_rn(__fmul_rn(dy, dy), w4, quad);
  const float v = expf(__fmul_rn(quad, w1));
  acc_r = __fmaf_rn(v, r, acc_r);
  acc_g = __fmaf_rn(v, g, acc_g);
  acc_b = __fmaf_rn(v, b, acc_b);
}

// The staging list of R and R-exact: per staged Gaussian its inclusive box
// (xlo, xhi, ylo, yhi), center and first coefficients (cx, cy, w1, w2),
// the rest and the color (c2, w4, r, g) and blue, each a 16-byte row a lane
// reads whole.
struct Stage {
  float4 box[kStageCap], quad[kStageCap], coef[kStageCap];
  float blue[kStageCap];
};

// The pixel loop of R and R-exact over the n staged Gaussians, between two
// barriers (the list is complete before it and not restaged until every
// warp is done). Each warp owns a sub-rectangle [rx0, rx1] x [ry0, ry1] of
// kRW columns, lane l column l % kRW and kP pixels down it, rows l / kRW +
// kLR p with kLR = 32 / kRW; a warp whose sub-rectangle lies beyond the
// canvas (`live` false) has nothing to add.
template <int kRW, int kP>
__device__ __forceinline__ void raster_list(const Stage& s, int n, bool live,
                                            int lane, float rx0, float rx1,
                                            float ry0, float ry1, float fx,
                                            const float (&fy)[kP],
                                            float (&acc)[kP][3]) {
  constexpr int kLR = 32 / kRW;
  __syncthreads();
  if (live) {
    for (int base = 0; base < n; base += 32) {
      const int j = base + lane;
      bool hit = false;
      if (j < n) {
        const float4 b = s.box[j];
        hit = b.x <= rx1 && b.y >= rx0 && b.z <= ry1 && b.w >= ry0;
      }
      unsigned m = __ballot_sync(0xffffffffu, hit);
      while (m) {
        const int i = base + __ffs(m) - 1;
        m &= m - 1;
        const float4 b = s.box[i];
        const float4 q = s.quad[i];
        const float4 c = s.coef[i];
        const float blue = s.blue[i];
        const bool in_x = fx >= b.x && fx <= b.y;
        // the lane's column: dx and dx^2 once for its kPix pixels
        const float dx = __fsub_rn(fx, q.x);
        const float dxx = __fmul_rn(dx, dx);
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          // the rows of pixel p's group of lanes: skipped by the whole
          // warp when the box misses them
          const float g0 = ry0 + static_cast<float>(kLR * p);
          if (b.z > g0 + static_cast<float>(kLR - 1) || b.w < g0)
            continue;
          if (in_x && fy[p] >= b.z && fy[p] <= b.w)
            add_at(dx, dxx, __fsub_rn(fy[p], q.y), q.z, q.w, c.x, c.y, c.z,
                   c.w, blue, acc[p][0], acc[p][1], acc[p][2]);
        }
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kRThreads)
raster_fwd_kernel(const float* __restrict__ geom,
                  const float* __restrict__ col,
                  const float* __restrict__ bbox, float* __restrict__ out,
                  int kc, int gc, int h, int w) {
  __shared__ Stage s;
  __shared__ int s_list[kRThreads];
  __shared__ int s_ccount[kRWarps];
  __shared__ int s_gcount[2][kSlices][kRWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  // the tile and the warp's sub-rectangle, clipped to the canvas: a
  // Gaussian whose box misses the clipped tile adds to no written pixel
  const float tx0 = static_cast<float>(x0);
  const float ty0 = static_cast<float>(y0);
  const float tx1 = static_cast<float>(min(x0 + kTileW, w) - 1);
  const float ty1 = static_cast<float>(min(y0 + kTileH, h) - 1);
  const int rx = x0 + (warp % kRectCols) * kRectW;
  const int ry = y0 + (warp / kRectCols) * kRectH;
  const bool live = rx < w && ry < h;
  const float rx0 = static_cast<float>(rx);
  const float ry0 = static_cast<float>(ry);
  const float rx1 = static_cast<float>(min(rx + kRectW, w) - 1);
  const float ry1 = static_cast<float>(min(ry + kRectH, h) - 1);
  const int px = rx + lane % kRectW;
  const float fx = static_cast<float>(px);
  float fy[kPix], acc[kPix][3];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    fy[p] = static_cast<float>(ry + lane / kRectW + kLaneRows * p);
    acc[p][0] = acc[p][1] = acc[p][2] = 0.f;
  }

  int n = 0, par = 0;
  for (int base = 0; base < kc; base += kRThreads) {
    const int k = base + tid;
    bool hit = false;
    if (k < kc) {
      hit = bbox[k] <= tx1 && bbox[kc + k] >= tx0 && bbox[2 * kc + k] <= ty1 &&
            bbox[3 * kc + k] >= ty0;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_ccount[warp] = __popc(mask);
    __syncthreads();
    int offset = 0, total = 0;
    for (int i = 0; i < kRWarps; ++i) {
      const int c = s_ccount[i];
      if (i < warp) offset += c;
      total += c;
    }
    if (hit) s_list[offset + __popc(mask & below)] = k;
    __syncthreads();

    for (int e = 0; e < total; ++e) {
      // cull the chunk's Gaussians against the tile, a slice of kRThreads
      // at a time: columns 4-7 (cy, xlo, xhi, ylo) and 8-11 (yhi, pad) of
      // the geometry rows
      const size_t row0 = static_cast<size_t>(s_list[e]) * gc + tid;
      bool in[kSlices];
      unsigned gm[kSlices];
      float4 a1[kSlices], a2[kSlices];
#pragma unroll
      for (int sl = 0; sl < kSlices; ++sl) {
        const float4* gr = reinterpret_cast<const float4*>(geom) +
                           (row0 + sl * kRThreads) * 4;
        in[sl] = false;
        a1[sl] = a2[sl] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (sl * kRThreads + tid < gc) {
          a1[sl] = __ldg(gr + 1);
          a2[sl] = __ldg(gr + 2);
          in[sl] = a1[sl].y <= tx1 && a1[sl].z >= tx0 && a1[sl].w <= ty1 &&
                   a2[sl].x >= ty0;
        }
        gm[sl] = __ballot_sync(0xffffffffu, in[sl]);
        if (lane == 0) s_gcount[par][sl][warp] = __popc(gm[sl]);
      }
      __syncthreads();
      // the hits in ascending order: slice by slice, warp by warp
      int goff[kSlices], cnt = 0;
#pragma unroll
      for (int sl = 0; sl < kSlices; ++sl) {
        for (int i = 0; i < kRWarps; ++i) {
          if (i == warp) goff[sl] = cnt;
          cnt += s_gcount[par][sl][i];
        }
      }
      // the counts of the next chunk go to the other buffer: this one is
      // read until every thread has passed the next chunk's barrier
      par ^= 1;
      if (n + cnt > kStageCap) {
        raster_list<kRectW, kPix>(s, n, live, lane, rx0, rx1, ry0, ry1, fx,
                                  fy, acc);
        n = 0;
      }
#pragma unroll
      for (int sl = 0; sl < kSlices; ++sl) {
        if (!in[sl]) continue;
        const size_t row = row0 + sl * kRThreads;
        const int i = n + goff[sl] + __popc(gm[sl] & below);
        const float4 a0 = __ldg(reinterpret_cast<const float4*>(geom) +
                                row * 4);
        const Coeffs cf = coeffs(a0.x, a0.y, a0.z);
        const float* c = col + row * 3;
        s.box[i] = make_float4(a1[sl].y, a1[sl].z, a1[sl].w, a2[sl].x);
        s.quad[i] = make_float4(a0.w, a1[sl].x, cf.w1, cf.w2);
        s.coef[i] = make_float4(cf.c2, cf.w4, __ldg(c), __ldg(c + 1));
        s.blue[i] = __ldg(c + 2);
      }
      n += cnt;
    }
  }
  if (n > 0)
    raster_list<kRectW, kPix>(s, n, live, lane, rx0, rx1, ry0, ry1, fx, fy,
                              acc);
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int py = ry + lane / kRectW + kLaneRows * p;
    if (px < w && py < h) {
      float* o = out + (static_cast<size_t>(py) * w + px) * 3;
      o[0] = acc[p][0];
      o[1] = acc[p][1];
      o[2] = acc[p][2];
    }
  }
}

// Stages Gaussian `row` of geom (16 floats, 16-byte aligned) and col (3)
// into slot i of the staging list: its box, center, coefficients and color.
__device__ __forceinline__ void stage_row(Stage& s, int i,
                                          const float* __restrict__ geom,
                                          const float* __restrict__ col,
                                          size_t row) {
  const float4* gr = reinterpret_cast<const float4*>(geom) + row * 4;
  const float4 a0 = __ldg(gr);
  const float4 a1 = __ldg(gr + 1);
  const float4 a2 = __ldg(gr + 2);
  const Coeffs cf = coeffs(a0.x, a0.y, a0.z);
  const float* c = col + row * 3;
  s.box[i] = make_float4(a1.y, a1.z, a1.w, a2.x);
  s.quad[i] = make_float4(a0.w, a1.x, cf.w1, cf.w2);
  s.coef[i] = make_float4(cf.c2, cf.w4, __ldg(c), __ldg(c + 1));
  s.blue[i] = __ldg(c + 2);
}

__global__ void __launch_bounds__(kThreads)
raster_fwd_exact_kernel(const float* __restrict__ geom,
                        const float* __restrict__ col,
                        const int* __restrict__ list_idx,
                        const int* __restrict__ tab, float* __restrict__ out,
                        int n, int nchunks, int h, int w, int n_tw) {
  __shared__ Stage s;
  __shared__ int s_count[2][kThreads / 32];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int ti = t / n_tw;
  // the warp's 16 x 8 sub-rectangle, clipped to the canvas; lane l owns
  // column l % 16 of rows l / 16 + 2 p
  const int x0 = (t - ti * n_tw) * kListTw + warp * kSubW;
  const int y0 = ti * kListTh;
  const bool live = x0 < w && y0 < h;
  const float rx0 = static_cast<float>(x0);
  const float ry0 = static_cast<float>(y0);
  const float rx1 = static_cast<float>(min(x0 + kSubW, w) - 1);
  const float ry1 = static_cast<float>(min(y0 + kListTh, h) - 1);
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
  // its first chunk has flag 1 (code t * 4 + 2), the rest flag 0 (t * 4 +
  // 1); each chunk's occupied slots (index below n) go to the staging list
  // in slot order, the pad slots are dropped
  int ns = 0, par = 0;
  for (int k = lo; k < nchunks && tab[k] == t * 4 + (k == lo ? 2 : 1); ++k) {
    const int idx = list_idx[static_cast<size_t>(k) * kListGc + tid];
    const bool in = idx >= 0 && idx < n;
    const unsigned m = __ballot_sync(0xffffffffu, in);
    if (lane == 0) s_count[par][warp] = __popc(m);
    __syncthreads();
    int off = 0, cnt = 0;
    for (int i = 0; i < kThreads / 32; ++i) {
      const int c = s_count[par][i];
      if (i < warp) off += c;
      cnt += c;
    }
    // the next chunk's counts go to the other buffer: this one is read
    // until every thread has passed the next chunk's barrier
    par ^= 1;
    if (ns + cnt > kStageCap) {
      raster_list<kSubW, kPixPer>(s, ns, live, lane, rx0, rx1, ry0, ry1, fx,
                                  fy, acc);
      ns = 0;
    }
    if (in) stage_row(s, ns + off + __popc(m & below), geom, col, idx);
    ns += cnt;
  }
  if (ns > 0)
    raster_list<kSubW, kPixPer>(s, ns, live, lane, rx0, rx1, ry0, ry1, fx,
                                fy, acc);
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
// unions, out (h, w, 3); all float32, contiguous, on the device, geom
// 16-byte aligned.
extern "C" int raster_fwd(const float* geom, const float* col,
                          const float* bbox, float* out, int kc, int gc, int h,
                          int w, void* stream) {
  if (kc < 1 || gc < 1 || gc > kMaxGc || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<std::uintptr_t>(geom) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  raster_fwd_kernel<<<grid, kRThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(geom, col, bbox,
                                                           out, kc, gc, h, w);
  return static_cast<int>(cudaGetLastError());
}

// Kernel R-exact: geom (n, 16) and col (n, 3) the Gaussians sorted by corner
// tile; list_idx (nchunks * 256) int32 indices into them (n or more: an
// empty slot); tab (nchunks) int32 the packed chunk table; out (h, w, 3). All
// contiguous, on the device, geom 16-byte aligned.
extern "C" int raster_fwd_exact(const float* geom, const float* col,
                                const int* list_idx, const int* tab,
                                float* out, int n, int nchunks, int h, int w,
                                void* stream) {
  if (n < 0 || nchunks < 1 || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<std::uintptr_t>(geom) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int n_th = (h + kListTh - 1) / kListTh;
  const int n_tw = (w + kListTw - 1) / kListTw;
  raster_fwd_exact_kernel<<<n_th * n_tw, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      geom, col, list_idx, tab, out, n, nchunks, h, w, n_tw);
  return static_cast<int>(cudaGetLastError());
}
