// Kernel XB: the exact per-tile Gaussian lists of R-exact, built on the
// card. It replaces no Pallas kernel: it is the CUDA form of _exact_tables
// (gsasr_tpu/ops/rasterizer.py, XLA ops in the JAX package) and of its port
// `exact_tables` (ops/rasterizer.py, torch ops, the plain version), and
// gives their (list_idx, tab, ok) integer for integer.
//
// The input is the geometry (S, 16) sorted by the (th, tw) tile of each
// cull box's corner (y-major; invisible boxes last, corner key n_th n_tw).
// Tile t = (ty, tx) holds, for each offset q = (r, c) of the (mr, mc)
// lattice in order (q = r mc + c), the members i of the run of corner tile
// (ty - r, tx - c) whose box spans more than r tile rows and c tile
// columns, in index order: that is, the Gaussians whose membership at
// offset q lands on t. Its segment is those Q runs' members, padded with
// the index S to whole chunks of gc slots (at least one chunk); segments
// follow each other in tile order. tab[k] = tile * 4 + flag + 1 (flag 1 for
// a segment's first chunk, 0 for the rest, -1 for capacity past the
// segments, tile n_tiles - 1 there); slots past the capacity are dropped;
// ok says that no box spans more than (mr, mc) tiles and that the
// segments fit the capacity. As in exact_tables, a box spanning more
// tiles than the lattice still lists its memberships inside the lattice.
//
// What bounds it on an H100: bytes. It reads the geometry once (S x 64 B,
// 33 MB at 519,168 Gaussians) and writes the lists and the table (cap x 4
// B, 21 MB at phase 37's capacity): 0.016 ms at 3.35 TB/s. The plain
// version is about 50 torch launches (searchsorted, prefix sums, scatters
// over (Q, S) lattices).
//
// Design: three launches, integer arithmetic only, each slot and table
// entry written by exactly one thread, no atomics, so the result is the
// same every launch.
//   1. corner_kernel, a thread a Gaussian: its corner key (the float tile
//      arithmetic of _corner_tiles: clamp, torch's floor division), its
//      spans packed as nrows | ncols << 16 (0 when invisible), and the run
//      starts by corner key (thread i writes the keys between its
//      predecessor's and its own: a searchsorted of every key at once).
//   2. count_kernel, a block a tile: the valid members of its Q runs,
//      summed over the block; and a slice of the Gaussians checked for a
//      span beyond (mr, mc).
//   3. write_kernel, a block a tile: its segment's start (the chunks of the
//      tiles before it) and the total, from the counts; then the Q runs in
//      order, 256 members at a time, each valid member's slot from a ballot
//      and a prefix over the warps; the pad slots and the segment's tab
//      entries; and a share of the capacity past the segments.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Grid {
  int h, w, th, tw, n_th, n_tw, nt, mr, mc;
};

// torch.div(x.clamp(0, hi), n, rounding_mode="floor") in float32 (fmod,
// then the quotient rounded as PyTorch's div_floor does), as an int.
__device__ __forceinline__ int tile_of(float x, float hi, float n) {
  const float a = fminf(fmaxf(x, 0.f), hi);
  const float mod = fmodf(a, n);
  const float div = (a - mod) / n;
  float fl = floorf(div);
  if (div - fl > 0.5f) fl += 1.f;
  return static_cast<int>(fl);
}

// Gaussian i's corner key (n_th n_tw when its box misses the canvas or is
// inverted) and its spans, nrows | ncols << 16 (0 when invisible): the
// arithmetic of _corner_tiles.
__device__ __forceinline__ int corner(const float* __restrict__ geom,
                                      size_t i, const Grid& G, int* spans) {
  const float* g = geom + i * 16;
  const float xlo = g[5], xhi = g[6], ylo = g[7], yhi = g[8];
  const float wm = static_cast<float>(G.w - 1);
  const float hm = static_cast<float>(G.h - 1);
  const bool vis = xhi >= 0.f && xlo <= wm && yhi >= 0.f && ylo <= hm &&
                   xhi >= xlo && yhi >= ylo;
  if (!vis) {
    *spans = 0;
    return G.nt;
  }
  const float th = static_cast<float>(G.th), tw = static_cast<float>(G.tw);
  const int fx0 = tile_of(xlo, wm, tw), fx1 = tile_of(xhi, wm, tw);
  const int fy0 = tile_of(ylo, hm, th), fy1 = tile_of(yhi, hm, th);
  *spans = (fy1 - fy0 + 1) | ((fx1 - fx0 + 1) << 16);
  return fy0 * G.n_tw + fx0;
}

__global__ void __launch_bounds__(kThreads)
corner_kernel(const float* __restrict__ geom, int* __restrict__ spans,
              int* __restrict__ run_start, int sp, Grid G) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (sp == 0) {
    if (i == 0)
      for (int key = 0; key <= G.nt + 1; ++key) run_start[key] = 0;
    return;
  }
  if (i >= sp) return;
  int sp_i, dummy;
  const int key = corner(geom, i, G, &sp_i);
  spans[i] = sp_i;
  const int prev = i == 0 ? -1 : corner(geom, i - 1, G, &dummy);
  // run_start[key] = the first Gaussian whose corner key is key or more
  for (int kk = prev + 1; kk <= key; ++kk) run_start[kk] = i;
  if (i == sp - 1)
    for (int kk = key + 1; kk <= G.nt + 1; ++kk) run_start[kk] = sp;
}

// The run [a, b) of corner tile (cy, cx), clamped to [0, sp] in case the
// input was not sorted.
__device__ __forceinline__ void run_of(const int* __restrict__ run_start,
                                       int cy, int cx, const Grid& G, int sp,
                                       int& a, int& b) {
  const int key = cy * G.n_tw + cx;
  a = min(max(run_start[key], 0), sp);
  b = min(max(run_start[key + 1], a), sp);
}

// A block's sum of one int a thread (every thread gets it).
__device__ __forceinline__ int block_sum(int x, int* s_red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = x;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) total += s_red[i];
  return total;
}

__device__ __forceinline__ bool member(int spans, int r, int c) {
  return r < (spans & 0xffff) && c < (spans >> 16);
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const int* __restrict__ spans, const int* __restrict__ run_start,
             int* __restrict__ counts, int* __restrict__ span_bad, int sp,
             Grid G) {
  __shared__ int s_red[kWarps];
  const int t = blockIdx.x;
  const int ty = t / G.n_tw, tx = t - ty * G.n_tw;
  int cnt = 0;
  for (int r = 0; r < G.mr; ++r)
    for (int c = 0; c < G.mc; ++c) {
      if (ty < r || tx < c) continue;
      int a, b;
      run_of(run_start, ty - r, tx - c, G, sp, a, b);
      for (int i = a + threadIdx.x; i < b; i += kThreads)
        cnt += member(spans[i], r, c);
    }
  cnt = block_sum(cnt, s_red);
  // a slice of the Gaussians: a box spanning more than (mr, mc) tiles
  int bad = 0;
  for (int i = t * kThreads + threadIdx.x; i < sp; i += G.nt * kThreads) {
    const int s = spans[i];
    bad |= (s & 0xffff) > G.mr || (s >> 16) > G.mc;
  }
  bad = block_sum(bad, s_red);
  if (threadIdx.x == 0) {
    counts[t] = cnt;
    span_bad[t] = bad;
  }
}

__global__ void __launch_bounds__(kThreads)
write_kernel(const int* __restrict__ spans, const int* __restrict__ run_start,
             const int* __restrict__ counts, const int* __restrict__ span_bad,
             int* __restrict__ list_idx, int* __restrict__ tab,
             unsigned char* __restrict__ ok, int sp, int gc, int cap,
             Grid G) {
  __shared__ int s_red[kWarps];
  __shared__ int s_warp[2][kWarps];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int nchunks = cap / gc;
  auto chunks = [&](int n) { return n > gc ? (n + gc - 1) / gc : 1; };
  // the segment's first chunk (the chunks of the tiles before t), the
  // chunks in use, and whether any box spans beyond the lattice
  int before = 0, all = 0, bad = 0;
  for (int u = tid; u < G.nt; u += kThreads) {
    const int ch = chunks(counts[u]);
    all += ch;
    if (u < t) before += ch;
    bad |= span_bad[u];
  }
  const int seg = block_sum(before, s_red);
  const int used = block_sum(all, s_red);
  bad = block_sum(bad, s_red);
  if (t == 0 && tid == 0) ok[0] = !bad && used <= nchunks;
  const int ty = t / G.n_tw, tx = t - ty * G.n_tw;
  const int base = seg * gc;

  // the members, run by run in q order, each run in index order
  int run = 0, par = 0;
  for (int r = 0; r < G.mr; ++r)
    for (int c = 0; c < G.mc; ++c) {
      if (ty < r || tx < c) continue;
      int a, b;
      run_of(run_start, ty - r, tx - c, G, sp, a, b);
      for (int i0 = a; i0 < b; i0 += kThreads) {
        const int i = i0 + tid;
        const bool in = i < b && member(spans[i], r, c);
        const unsigned m = __ballot_sync(0xffffffffu, in);
        if (lane == 0) s_warp[par][warp] = __popc(m);
        __syncthreads();
        int off = 0, n = 0;
#pragma unroll
        for (int k = 0; k < kWarps; ++k) {
          const int x = s_warp[par][k];
          if (k < warp) off += x;
          n += x;
        }
        // the next step's counts go to the other buffer: this one is read
        // until every thread has passed the next step's barrier
        par ^= 1;
        if (in) {
          const int slot = base + run + off + __popc(m & below);
          if (slot < cap) list_idx[slot] = i;
        }
        run += n;
      }
    }
  // the segment's pad slots and its table entries
  const int nch = chunks(run);
  for (int j = run + tid; j < nch * gc; j += kThreads)
    if (base + j < cap) list_idx[base + j] = sp;
  for (int j = tid; j < nch; j += kThreads)
    if (seg + j < nchunks) tab[seg + j] = t * 4 + (j == 0 ? 2 : 1);
  // the capacity past the segments, dealt over the blocks
  if (used < nchunks) {
    const int stride = G.nt * kThreads;
    for (int e = t * kThreads + tid; e < (nchunks - used) * gc; e += stride)
      list_idx[used * gc + e] = sp;
    for (int e = t * kThreads + tid; e < nchunks - used; e += stride)
      tab[used + e] = (G.nt - 1) * 4;
  }
}

}  // namespace

// geom (sp, 16) float32, sorted by corner key; canvas h x w; tiles th x tw;
// chunks of gc slots; lattice mr x mc; cap slots (a multiple of gc).
// Scratch: spans (sp), run_start (n_tiles + 2), counts and span_bad
// (n_tiles), int32. Out: list_idx (cap) and tab (cap / gc) int32, ok one
// byte (a torch.bool). All contiguous, on the device.
extern "C" int exact_build(const float* geom, int* spans, int* run_start,
                           int* counts, int* span_bad, int* list_idx,
                           int* tab, void* ok, int sp, int h, int w, int th,
                           int tw, int gc, int mr, int mc, int cap,
                           void* stream) {
  if (sp < 0 || h < 1 || w < 1 || th < 1 || tw < 1 || gc < 1 || mr < 1 ||
      mc < 1 || mr >= (1 << 15) || cap < gc || cap % gc != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Grid G;
  G.h = h;
  G.w = w;
  G.th = th;
  G.tw = tw;
  G.n_th = (h + th - 1) / th;
  G.n_tw = (w + tw - 1) / tw;
  G.nt = G.n_th * G.n_tw;
  G.mr = mr;
  G.mc = mc;
  const auto st = static_cast<cudaStream_t>(stream);
  const int blocks = sp > 0 ? (sp + kThreads - 1) / kThreads : 1;
  corner_kernel<<<blocks, kThreads, 0, st>>>(geom, spans, run_start, sp, G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  count_kernel<<<G.nt, kThreads, 0, st>>>(spans, run_start, counts, span_bad,
                                          sp, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  write_kernel<<<G.nt, kThreads, 0, st>>>(
      spans, run_start, counts, span_bad, list_idx, tab,
      static_cast<unsigned char*>(ok), sp, gc, cap, G);
  return static_cast<int>(cudaGetLastError());
}
