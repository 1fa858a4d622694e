// Kernel MB: backward of kernel M (fused [LayerNorm] -> fc1 -> ReLU -> fc2
// -> residual), with the forward recomputed.
//
// Replaces _k_ln_mlp_bwd of gsasr_tpu/ops/fused_layers.py (the custom VJP
// of ln_mlp_residual). Weights in nn.Linear layout: w1 (H, C), w2 (C, H).
// With t = x + inj[window] and h = LN?(t):
//
//   z1p = h w1^T + b1        z1 = relu(z1p)
//   dw2 = g^T z1             db2 = sum g
//   dz1 = (g w2) [z1p > 0]   dw1 = dz1^T h      db1 = sum dz1
//   dh  = dz1 w1             dt  = LN backward of dh (+ g when the residual
//                                  base is t)
//   dx  = dt                 dinj[w] = sum of dt over the window's rows
//
// (d resi = g is the caller's.) The weight, bias and LN gradients are sums
// over all rows of all windows. zero_base (the bare MLP) and a resi base
// are both "base_is_t = 0".
//
// bfloat16 (ln_mlp_bwd_bf16): x, g, dx and dinj are __nv_bfloat16, the rest
// float. It rounds where _k_ln_mlp_bwd rounds: h and z1 as the forward
// does, the weights as they are staged, dz1 as an operand of dw1 and dh
// (db1 sums it unrounded), and dx and dinj (the window sums of the f32 dt)
// as they are stored. The bf16 rows go into the products as they are.
//
// What bounds it on an H100: five products of 2 M C H operations each (the
// recomputed fc1, dw2, dz1, dw1 and dh: 11.9 GFLOP at 256 windows x 144
// tokens x 180 channels, 13.6 at 192). In float32 each runs in 3xTF32,
// three TF32 products: 35.8 GFLOP against 495 TFLOP/s, 0.072 ms. In
// bfloat16 the products take 14 us at 989 TFLOP/s, about as long as the
// bytes (x, g and dx).
//
// Design (tile_mma.cuh, tile_mma_bwd.cuh). One launch writes the weights'
// transposes; then two launches of one block of sixteen warps per 128 rows
// run the chain of kernel M on the tensor cores, the rows on chip. Launch
// 1: LN?(x + inj) -> h (to scratch, for dw1), fc1 -> z1p, whose relu,
// rounded, goes to scratch (for dw2) and whose signs each thread keeps as
// two words in scratch (48 bits: its accumulator entries). A sign decides
// a whole entry of dz1, so where 3xTF32 cannot decide it (a pre-activation
// within its rounding bound of 0, about 15 of the 23,040 of a tile at the
// paper width) an f32 FMA chain over the columns in order decides it, as
// the plain version's f32 product does. Launch 2: g's
// rows, g w2 masked by those signs -> dz1 (f32 to scratch, for dw1 and
// db1), rounded over the rows; dz1 w1 -> dh, staged; the LN backward of the
// staged rows, one warp a row -> dx, the block's LN partials and its
// partial window sums of dt (a window of 144 rows crosses the 128-row
// tiles). One launch holding the signs across g w2 spilled 52-352 bytes at
// the 128 registers of sixteen warps; two launches spill nothing (ptxas:
// 114 and 118 registers in fp32, 102 and 126 in bf16). Then the two weight
// gradients in one launch of partials over 128 fixed groups of rows and
// one of their ordered sums, and the ordered sums of the LN and window
// partials. No float atomics, so the result is the same bits from run to
// run.

#include <cuda_runtime.h>

#include "tile_mma_bwd.cuh"

namespace {

using namespace gsasr;

// Windows a 128-row tile can touch: the slots of its partial window sums.
inline int inj_slots(int T) { return (kTRows - 1 + T - 1) / T + 1; }

// A pre-activation within kSignTol ||h_r|| ||w1_n|| of 0 (about 16 times
// the worst rounding error of its 3xTF32 sum and of an f32 sum of its C
// products, by Cauchy-Schwarz) has its sign decided again from an f32 FMA
// chain over the columns in order, as an f32 product forms it.
constexpr float kSignTol = 1.0f / 65536;

// out[n] = the norm of row n of the (rows, cols) w as the products take it
// (rounded to Act), one warp a row.
template <typename Act>
__global__ void __launch_bounds__(256)
row_norms_kernel(const float* __restrict__ w, float* __restrict__ out,
                 int rows, int cols) {
  const int n = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (n >= rows) return;  // the whole warp
  float a = 0.f;
  for (int c = lane; c < cols; c += 32) {
    const float v = rnd<Act>(w[static_cast<size_t>(n) * cols + c]);
    a += v * v;
  }
  a = warp_sum(a);
  if (lane == 0) out[n] = sqrtf(a);
}

// Whether pre-activation z of row r, column n of the tile is decided by
// the FMA chain: the same test, on the same values, in both its places.
__device__ __forceinline__ bool near_zero(float z, float hn, float wn) {
  return fabsf(z) <= kSignTol * hn * wn;
}

// Launch 1 of the chain: the block's 128 rows of h = LN?(x + inj) (to
// scratch, for dw1) and z1p = h w1^T + b1: relu(z1p), rounded, to scratch
// (for dw2), and each thread's 48 signs of z1p as two words of `live`.
// w1n: the norms of w1's rows (row_norms_kernel). vec: C and H multiples of
// 4 and the pointers on 16 bytes, four columns a store.
template <typename Act>
__global__ void __launch_bounds__(kTThreads, 1)
ln_fc1_kernel(const Act* __restrict__ x, const float* __restrict__ inj,
              const float* __restrict__ ln_w, const float* __restrict__ ln_b,
              const float* __restrict__ w1, const float* __restrict__ b1,
              const float* __restrict__ w1n, Act* __restrict__ hs,
              Act* __restrict__ z1s, uint32_t* __restrict__ live_out, int M,
              int T, int C, int H, int vec) {
  using P = typename TileOf<Act>::type;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  __shared__ float b1s[kMaxN], wn[kMaxN], hn[kTRows];
  auto* rows = reinterpret_cast<typename P::Row*>(tile_smem);
  const int row0 = blockIdx.x * kTRows;
  const int nr = M - row0 < kTRows ? M - row0 : kTRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int n = threadIdx.x; n < kMaxN; n += kTThreads) {
    b1s[n] = n < H ? b1[n] : 0.f;
    wn[n] = n < H ? w1n[n] : 0.f;
  }
  tile_ln_rows<P>(rows, x, inj, static_cast<const Act*>(nullptr), ln_w, ln_b,
                  row0, M, T, C);
  __syncthreads();
  if (vec) {
    const int q4 = C / 4;
    for (int e = threadIdx.x; e < nr * q4; e += kTThreads) {
      const int r = e / q4;
      const int c = 4 * (e - r * q4);
      st4(hs + static_cast<size_t>(row0 + r) * C + c,
          ld4(rows + r * P::kLd + c));
    }
  } else {
    for (int e = threadIdx.x; e < nr * C; e += kTThreads) {
      const int r = e / C;
      const int c = e - r * C;
      hs[static_cast<size_t>(row0 + r) * C + c] =
          from_f32<Act>(to_f32(rows[r * P::kLd + c]));
    }
  }
  // the norms of h's rows (as the product takes them)
  for (int r = warp; r < kTRows; r += kTWarps) {
    float a = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = to_f32(rows[r * P::kLd + c]);
      a += v * v;
    }
    a = warp_sum(a);
    if (lane == 0) hn[r] = sqrtf(a);
  }
  float acc[kTNT][4];
  tile_mma<P>(rows, w1, H, C, tile_smem, acc);
  const int rr = 16 * (warp & 7) + (lane >> 2);
  const int cc = kTWarpCols * (warp >> 3) + 2 * (lane & 3);
  uint64_t live = 0, near = 0;
#pragma unroll
  for (int j = 0; j < kTNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rr + 8 * (e >> 1);
      const int n = cc + 8 * j + (e & 1);
      const float z = acc[j][e] + b1s[n];
      if (n < H && r < nr && near_zero(z, hn[r], wn[n]))
        near |= uint64_t{1} << (4 * j + e);
      else if (z > 0.f)
        live |= uint64_t{1} << (4 * j + e);
    }
  // the few near 0: an f32 FMA chain over the columns in order, stored
  // here (the pass below skips them)
  while (near) {
    const int b = __ffsll(static_cast<long long>(near)) - 1;
    near &= near - 1;
    const int r = rr + 8 * ((b & 3) >> 1);
    const int n = cc + 8 * (b >> 2) + (b & 1);
    const float* wr = w1 + static_cast<size_t>(n) * C;
    const auto* hr = rows + r * P::kLd;
    float a = 0.f;
    if (vec) {
#pragma unroll 4
      for (int k = 0; k < C; k += 4) {
        const float4 h4 = ld4(hr + k);
        const float4 w4 = ld4(wr + k);
        a = fmaf(h4.x, rnd<Act>(w4.x), a);
        a = fmaf(h4.y, rnd<Act>(w4.y), a);
        a = fmaf(h4.z, rnd<Act>(w4.z), a);
        a = fmaf(h4.w, rnd<Act>(w4.w), a);
      }
    } else {
      for (int k = 0; k < C; ++k) a = fmaf(to_f32(hr[k]), rnd<Act>(wr[k]), a);
    }
    const float z = a + b1s[n];
    if (z > 0.f) live |= uint64_t{1} << b;
    z1s[static_cast<size_t>(row0 + r) * H + n] = from_f32<Act>(fmaxf(z, 0.f));
  }
  // relu(z1p) rounded through the staged results, four columns a thread
  __syncthreads();
  float* stage = tile_stage<P>(tile_smem);
  tile_stage_acc(acc, stage);
  __syncthreads();
  if (vec) {
    const int q4 = H / 4;
    for (int e = threadIdx.x; e < nr * q4; e += kTThreads) {
      const int r = e / q4;
      const int c = 4 * (e - r * q4);
      const float4 a = ld4(stage + r * kTLdS + c);
      const float z[4] = {a.x + b1s[c], a.y + b1s[c + 1], a.z + b1s[c + 2],
                          a.w + b1s[c + 3]};
      bool any = false;
#pragma unroll
      for (int i = 0; i < 4; ++i) any |= near_zero(z[i], hn[r], wn[c + i]);
      Act* dst = z1s + static_cast<size_t>(row0 + r) * H + c;
      if (!any) {
        st4(dst, make_float4(fmaxf(z[0], 0.f), fmaxf(z[1], 0.f),
                             fmaxf(z[2], 0.f), fmaxf(z[3], 0.f)));
        continue;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (!near_zero(z[i], hn[r], wn[c + i]))
          dst[i] = from_f32<Act>(fmaxf(z[i], 0.f));
    }
  } else {
    for (int e = threadIdx.x; e < nr * H; e += kTThreads) {
      const int r = e / H;
      const int c = e - r * H;
      const float z = stage[r * kTLdS + c] + b1s[c];
      if (!near_zero(z, hn[r], wn[c]))
        z1s[static_cast<size_t>(row0 + r) * H + c] =
            from_f32<Act>(fmaxf(z, 0.f));
    }
  }
  uint32_t* lw = live_out + (static_cast<size_t>(blockIdx.x) * kTThreads +
                             threadIdx.x) * 2;
  lw[0] = static_cast<uint32_t>(live);
  lw[1] = static_cast<uint32_t>(live >> 32);
}

// Launch 2: the block's 128 rows of g, dz1 = (g w2) [z1p > 0] (the signs
// launch 1 kept), dh = dz1 w1 and the LN backward; lnpart (2, C) and
// injpart (slots, C) are the block's own partials.
template <typename Act>
__global__ void __launch_bounds__(kTThreads, 1)
ln_mlp_bwd_kernel(const Act* __restrict__ x, const float* __restrict__ inj,
                  const float* __restrict__ ln_w,
                  const uint32_t* __restrict__ live_in,
                  const float* __restrict__ w1t,
                  const float* __restrict__ w2t, const Act* __restrict__ g,
                  float* __restrict__ dz1s, Act* __restrict__ dx,
                  float* __restrict__ lnpart, float* __restrict__ injpart,
                  int M, int T, int C, int H, int base_is_t, int vec,
                  int vech, int slots) {
  using P = typename TileOf<Act>::type;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  auto* rows = reinterpret_cast<typename P::Row*>(tile_smem);
  const int row0 = blockIdx.x * kTRows;
  const int nr = M - row0 < kTRows ? M - row0 : kTRows;
  float acc[kTNT][4];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rr = 16 * (warp & 7) + (lane >> 2);
  const int cc = kTWarpCols * (warp >> 3) + 2 * (lane & 3);

  // dz1 = (g w2) [z1p > 0]: f32 to scratch, rounded over the rows
  tile_load_rows<P>(rows, g, row0, M, C, vec);
  tile_mma<P>(rows, w2t, H, C, tile_smem, acc);
  const uint32_t* lw = live_in + (static_cast<size_t>(blockIdx.x) *
                                  kTThreads + threadIdx.x) * 2;
  const uint64_t live = lw[0] | uint64_t{lw[1]} << 32;
#pragma unroll
  for (int j = 0; j < kTNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rr + 8 * (e >> 1);
      const int n = cc + 8 * j + (e & 1);
      const float d = (live >> (4 * j + e)) & 1 ? acc[j][e] : 0.f;
      acc[j][e] = d;
      tile_put(rows, r * P::kLd + n, n < H ? d : 0.f);
    }
  // dz1 (f32) to scratch, four columns a thread: in fp32 the rows hold it,
  // in bf16 (rows rounded) the staged results
  const float* dsrc = reinterpret_cast<const float*>(tile_smem);
  int ld = P::kLd;
  if (sizeof(typename P::Row) == 2) {
    float* stage = tile_stage<P>(tile_smem);
    tile_stage_acc(acc, stage);
    dsrc = stage;
    ld = kTLdS;
  }
  __syncthreads();
  if (vech) {
    const int q4 = H / 4;
    for (int e = threadIdx.x; e < nr * q4; e += kTThreads) {
      const int r = e / q4;
      const int c = 4 * (e - r * q4);
      st4(dz1s + static_cast<size_t>(row0 + r) * H + c,
          ld4(dsrc + r * ld + c));
    }
  } else {
    for (int e = threadIdx.x; e < nr * H; e += kTThreads) {
      const int r = e / H;
      const int c = e - r * H;
      dz1s[static_cast<size_t>(row0 + r) * H + c] = dsrc[r * ld + c];
    }
  }
  __syncthreads();  // the staged results are tile_mma's ring in bf16

  // dh = dz1 w1, staged; the LN backward of the block's rows
  tile_mma<P>(rows, w1t, C, H, tile_smem, acc);
  float* stage = tile_stage<P>(tile_smem);
  tile_stage_acc(acc, stage);
  __syncthreads();
  tile_ln_bwd<Act>(stage, tile_comb<P>(tile_smem), x, inj, ln_w,
                   base_is_t ? g : nullptr, dx, nullptr,
                   ln_w ? lnpart + static_cast<size_t>(blockIdx.x) * 2 * C
                        : nullptr,
                   row0, M, T, C);
  if (!injpart) return;
  // the partial window sums of dt (staged by tile_ln_bwd), rows in order:
  // slot s holds window row0 / T + s
  const int wf = row0 / T;
  const int nw = (row0 + nr - 1) / T - wf + 1;
  float* ip = injpart + static_cast<size_t>(blockIdx.x) * slots * C;
  for (int e = threadIdx.x; e < nw * C; e += kTThreads) {
    const int s = e / C;
    const int c = e - s * C;
    const int w = wf + s;
    const int r_lo = max(w * T, row0) - row0;
    const int r_hi = min((w + 1) * T, row0 + nr) - row0;
    float a = 0.f;
    for (int r = r_lo; r < r_hi; ++r) a += stage[r * kTLdS + c];
    ip[e] = a;
  }
}

// dinj[w, c] (Act) = the partials of the tiles that window w touches,
// summed in tile order, one thread an entry.
template <typename Act>
__global__ void __launch_bounds__(256)
inj_sum_kernel(const float* __restrict__ injpart, Act* __restrict__ dinj,
               int B, int T, int C, int slots) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= B * C) return;
  const int w = e / C;
  const int c = e - w * C;
  const int t0 = w * T / kTRows;
  const int t1 = ((w + 1) * T - 1) / kTRows;
  float a = 0.f;
  for (int t = t0; t <= t1; ++t)
    a += injpart[(static_cast<size_t>(t) * slots + w - t * kTRows / T) * C +
                 c];
  dinj[e] = from_f32<Act>(a);
}

// x, g, dx (M, C) with M = windows * T; inj (windows, C) float and dinj
// (windows, C) or null; ln_w, ln_b (C) or null, dln (2, C) = (d ln_w,
// d ln_b) with them; w1, dw1 (H, C); b1, db1 (H); w2, dw2 (C, H); db2 (C).
// base_is_t: the forward's residual base was t (no resi, no zero_base), so
// g also flows to dt. work holds work_floats floats of scratch, in 16-byte
// pieces: the transposed w1 and w2 (C H each); h (M C, Act), z1 (M H, Act)
// and dz1 (M H, f32); the weight-gradient partials, kMaxGroups H (C + 1)
// and kMaxGroups C (H + 1); the LN partials, ceil(M / 128) 2 C; with inj,
// the window partials, ceil(M / 128) inj_slots(T) C; the norms of w1's rows
// (H); the signs of z1p, ceil(M / 128) 1024 words.
template <typename Act>
int ln_mlp_bwd_impl(const Act* x, const float* inj, const float* ln_w,
                    const float* ln_b, const float* w1, const float* b1,
                    const float* w2, const Act* g, Act* dx, Act* dinj,
                    float* dln, float* dw1, float* db1, float* dw2, float* db2,
                    float* work, int work_floats, int M, int T, int C, int H,
                    int base_is_t, cudaStream_t st) {
  if (M < 1 || T < 1 || M % T != 0 || C > kMaxN || H > kMaxN ||
      C > 32 * kLnPer || (ln_w == nullptr) != (ln_b == nullptr) ||
      (ln_w == nullptr) != (dln == nullptr) ||
      (inj == nullptr) != (dinj == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t rows = static_cast<size_t>(M);
  const int tiles = (M + kTRows - 1) / kTRows;
  const int slots = inj_slots(T);
  Carve cv{work};
  float* w1t = cv.take<float>(static_cast<size_t>(C) * H);
  float* w2t = cv.take<float>(static_cast<size_t>(C) * H);
  Act* hs = cv.take<Act>(rows * C);
  Act* z1s = cv.take<Act>(rows * H);
  float* dz1s = cv.take<float>(rows * H);
  float* part1 = cv.take<float>(static_cast<size_t>(kMaxGroups) * H * (C + 1));
  float* part2 = cv.take<float>(static_cast<size_t>(kMaxGroups) * C * (H + 1));
  float* lnpart = cv.take<float>(static_cast<size_t>(tiles) * 2 * C);
  float* w1n = cv.take<float>(H);
  float* injpart =
      inj ? cv.take<float>(static_cast<size_t>(tiles) * slots * C) : nullptr;
  uint32_t* live = cv.take<uint32_t>(static_cast<size_t>(tiles) * kTThreads *
                                     2);
  if (static_cast<size_t>(work_floats) < cv.used)
    return static_cast<int>(cudaErrorInvalidValue);

  WtJobs wt{{w1, w2}, {w1t, w2t}, {H, C}, {C, H}};
  GSASR_TRY_INT(launch_wt(wt, 2, st));
  using P = typename TileOf<Act>::type;
  constexpr size_t smem = tile_smem_bytes<P>();
  GSASR_TRY_INT(tile_prepare(ln_fc1_kernel<Act>, smem));
  GSASR_TRY_INT(tile_prepare(ln_mlp_bwd_kernel<Act>, smem));
  row_norms_kernel<Act><<<(H + 7) / 8, 256, 0, st>>>(w1, w1n, H, C);
  GSASR_TRY_INT(cudaGetLastError());
  const int vec = C % 4 == 0 && tile_aligned({x, g});
  const int vech = vec && H % 4 == 0 && tile_aligned({w1, hs, z1s, dz1s});
  ln_fc1_kernel<Act><<<tiles, kTThreads, smem, st>>>(
      x, inj, ln_w, ln_b, w1, b1, w1n, hs, z1s, live, M, T, C, H, vech);
  GSASR_TRY_INT(cudaGetLastError());
  ln_mlp_bwd_kernel<Act><<<tiles, kTThreads, smem, st>>>(
      x, inj, ln_w, live, w1t, w2t, g, dz1s, dx, lnpart, injpart, M, T, C,
      H, base_is_t, vec, vech, slots);
  GSASR_TRY_INT(cudaGetLastError());
  if (ln_w)
    GSASR_TRY_INT(launch_ordered_sum(lnpart, dln, tiles, 2 * C, 2 * C, st));
  if (inj) {
    const int B = M / T;
    inj_sum_kernel<Act><<<(B * C + 255) / 256, 256, 0, st>>>(injpart, dinj,
                                                             B, T, C, slots);
    GSASR_TRY_INT(cudaGetLastError());
  }
  // dw2 = g^T z1, db2 = sum g; dw1 = dz1^T h, db1 = sum dz1
  WgradJobs jobs{};
  jobs.j[0] = WgradJob{g, z1s, part2, dw2, db2, M, C, H, 0, 0, 1};
  jobs.j[1] = WgradJob{dz1s, hs, part1, dw1, db1, M, H, C, 0, 0, 0};
  GSASR_TRY_INT(launch_wgrad_mma<Act>(jobs, 2, st));
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// Kernel MB in float32 and in bfloat16, arguments as ln_mlp_bwd_impl.
extern "C" int ln_mlp_bwd(const float* x, const float* inj, const float* ln_w,
                          const float* ln_b, const float* w1, const float* b1,
                          const float* w2, const float* g, float* dx,
                          float* dinj, float* dln, float* dw1, float* db1,
                          float* dw2, float* db2, float* work, int work_floats,
                          int M, int T, int C, int H, int base_is_t,
                          void* stream) {
  return ln_mlp_bwd_impl(x, inj, ln_w, ln_b, w1, b1, w2, g, dx, dinj, dln,
                         dw1, db1, dw2, db2, work, work_floats, M, T, C, H,
                         base_is_t, static_cast<cudaStream_t>(stream));
}

extern "C" int ln_mlp_bwd_bf16(const __nv_bfloat16* x, const float* inj,
                               const float* ln_w, const float* ln_b,
                               const float* w1, const float* b1,
                               const float* w2, const __nv_bfloat16* g,
                               __nv_bfloat16* dx, __nv_bfloat16* dinj,
                               float* dln, float* dw1, float* db1, float* dw2,
                               float* db2, float* work, int work_floats, int M,
                               int T, int C, int H, int base_is_t,
                               void* stream) {
  return ln_mlp_bwd_impl(x, inj, ln_w, ln_b, w1, b1, w2, g, dx, dinj, dln,
                         dw1, db1, dw2, db2, work, work_floats, M, T, C, H,
                         base_is_t, static_cast<cudaStream_t>(stream));
}
