// The tensor-core products of the decoder-layer backward kernels MB
// (ln_mlp_bwd.cu) and AB (ln_attn_bwd.cu), beside the row-tile product of
// tile_mma.cuh that they share with the forward kernels M and A:
//
//   - Row products against a transposed nn.Linear weight, out = rows W for
//     W (K, N): g w2, dz1 w1, g wo, and up to three terms into one
//     accumulator (dq0 wq + dk0 wk + dv wv). tile_mma multiplies by an (N,
//     K) weight; the weights are (C, C) or (C, H), under 150 KB, so one
//     launch first writes their transposes to scratch (wt_kernel), and the
//     row products are tile_mma's 128-row tiles as they are, 3xTF32 in fp32
//     and bf16 m16n8k16 in bf16, terms added into one accumulator (kAcc).
//     A tile holds whole rows, so the LayerNorm backward of the rows runs
//     in the same block (tile_ln_bwd): dx, and the block's column sums of
//     the LN gradients, summed over the blocks in order by a second launch.
//   - The weight gradients dW = D^T X (wgrad_mma_kernel), contracted over
//     the rows, with the bias gradient db = the column sums of D: the rows
//     are cut into at most kMaxGroups groups of group_rows(M) rows, a block
//     owns one group and 96 rows of dW (the whole K), walks its rows in
//     stages of 32 through a ring of cp.async buffers (bf16: three, two
//     blocks an SM, which took a fifth off against one block of six; fp32:
//     four, one block of 178 registers), and writes its partial
//     dW and db; wgrad_sum_kernel sums the partials in group order. In
//     fp32 each k-step is m16n8k8 in 3xTF32 (the operands split as they
//     are read from shared memory, tf32_frag.cuh's rounding); in bf16,
//     m16n8k16 with D rounded to bf16 as its fragments are built and X's
//     fragments by ldmatrix.trans. db sums D unrounded, in f32, row by row,
//     so the bf16 forms' bias sums take the unrounded values, as the Pallas
//     bodies do, and no column of ones pads K.
//
// Shared memory of the weight gradient: D's stage (32 rows x 96 columns of
// f32) at a row stride of 8 (fp32) or 4 (bf16) mod 32 floats, and X's (32
// rows x 192 columns, f32 or bf16) at 200 words or 200 bf16: every fragment
// load is free of bank conflicts (fp32: lane (g, t) reads row t, column g;
// bf16: rows 2t and 2t + 1, column g, and ldmatrix's eight 16-byte rows
// in eight bank groups).
//
// Every sum runs in one fixed order (slab by slab or stage by stage, k-step
// by k-step, group by group), with no float atomics, so two launches give
// the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_ptx.cuh"
#include "tf32_frag.cuh"
#include "tile_mma.cuh"

// Variadic, so a template argument list's commas stay inside the call.
#define GSASR_TRY(...)                                    \
  do {                                                    \
    const cudaError_t gsasr_err_ = (__VA_ARGS__);         \
    if (gsasr_err_ != cudaSuccess) return gsasr_err_;     \
  } while (0)
// The same in an extern "C" entry point, which returns the code as an int.
#define GSASR_TRY_INT(...)                                         \
  do {                                                             \
    const cudaError_t gsasr_err_ = (__VA_ARGS__);                  \
    if (gsasr_err_ != cudaSuccess) return static_cast<int>(gsasr_err_); \
  } while (0)

namespace gsasr {

// Scratch carved from a caller's f32 buffer in 16-byte pieces.
struct Carve {
  float* base;
  size_t used = 0;
  template <typename T>
  T* take(size_t n) {
    T* p = reinterpret_cast<T*>(base + used);
    used += (n * sizeof(T) + 15) / 16 * 4;
    return p;
  }
};

// ---- transposed weights --------------------------------------------------

// Up to four (rows, cols) row-major f32 matrices and their transposes.
struct WtJobs {
  const float* src[4];
  float* dst[4];
  int rows[4], cols[4];
};

// dst[c rows + r] = src[r cols + c] of job blockIdx.y, one thread an entry.
__global__ void __launch_bounds__(256)
wt_kernel(WtJobs jobs) {
  const int j = blockIdx.y;
  const int e = blockIdx.x * 256 + threadIdx.x;
  const int rows = jobs.rows[j], cols = jobs.cols[j];
  if (e >= rows * cols) return;
  const int c = e / rows;
  const int r = e - c * rows;
  jobs.dst[j][e] = jobs.src[j][static_cast<size_t>(r) * cols + c];
}

inline cudaError_t launch_wt(const WtJobs& jobs, int n, cudaStream_t st) {
  int most = 0;
  for (int j = 0; j < n; ++j)
    most = jobs.rows[j] * jobs.cols[j] > most ? jobs.rows[j] * jobs.cols[j]
                                              : most;
  wt_kernel<<<dim3((most + 255) / 256, n), 256, 0, st>>>(jobs);
  return cudaGetLastError();
}

// ---- the LayerNorm backward of a row tile --------------------------------

// Where tile_ln_bwd combines the warps' LN partials (kTWarps x 2 x kMaxN
// floats): shared memory that the staged results do not hold.
template <class P>
__device__ __forceinline__ float* tile_comb(unsigned char* smem) {
  return reinterpret_cast<float*>(
      sizeof(typename P::Row) == 4 ? smem + tile_rows_bytes<P>() : smem);
}
static_assert(sizeof(float) * kTWarps * 2 * kMaxN <=
                  tile_rows_bytes<TileBf16>() &&
              sizeof(float) * kTWarps * 2 * kMaxN <=
                  sizeof(float) * TileF32::kStages * kTRaw,
              "the LN partials fit beside the staged results");

// The LayerNorm backward of the block's rows [row0, row0 + kTRows) from dh
// staged at `stage` (row r at r kTLdS), one warp a row: at t = x[g] +
// inj[g / T] (inj optional), y = (t - mean) inv and dyh = dh ln_w,
//   dt = inv (dyh - mean(dyh) - y mean(dyh y)) (+ add[g])
// (dt = dh (+ add[g]) without ln_w). dh goes to dh32 (f32) when given; dt
// goes to dx (Act) and over the staged row (f32) for the caller's window
// sums; with ln_w and lnpart, the block's column sums of dh y and dh, over
// its rows in order, to lnpart (2, C), through `comb`. Starts with the
// rows staged and ends with a barrier.
template <typename Act>
__device__ __forceinline__ void tile_ln_bwd(
    float* stage, float* comb, const Act* __restrict__ x,
    const float* __restrict__ inj, const float* __restrict__ ln_w,
    const Act* __restrict__ add, Act* __restrict__ dx,
    float* __restrict__ dh32, float* __restrict__ lnpart, int row0, int M,
    int T, int C) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float inv_c = 1.0f / static_cast<float>(C);
  float lw[kLnPer], pw[kLnPer], pb[kLnPer];
#pragma unroll
  for (int q = 0; q < kLnPer; ++q) {
    const int c = lane + 32 * q;
    lw[q] = ln_w && c < C ? ln_w[c] : 0.f;
    pw[q] = pb[q] = 0.f;
  }
  for (int r = warp; r < kTRows; r += kTWarps) {
    const int g = row0 + r;
    if (g >= M) break;
    const size_t o = static_cast<size_t>(g) * C;
    float* srow = stage + r * kTLdS;
    float t[kLnPer], d[kLnPer];
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kLnPer; ++q) {
      const int c = lane + 32 * q;
      t[q] = d[q] = 0.f;
      if (c < C) {
        t[q] = to_f32(x[o + c]);
        if (inj) t[q] += inj[static_cast<size_t>(g / T) * C + c];
        d[q] = srow[c];
        if (dh32) dh32[o + c] = d[q];
        s += t[q];
      }
    }
    if (ln_w) {
      const float mean = warp_sum(s) * inv_c;
      float ss = 0.f;
#pragma unroll
      for (int q = 0; q < kLnPer; ++q) {
        if (lane + 32 * q < C) {
          const float e = t[q] - mean;
          ss += e * e;
        }
      }
      const float inv = 1.0f / sqrtf(warp_sum(ss) * inv_c + kLnEps);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < kLnPer; ++q) {
        if (lane + 32 * q < C) {
          t[q] = (t[q] - mean) * inv;  // y
          const float dyh = d[q] * lw[q];
          s1 += dyh;
          s2 += dyh * t[q];
          pw[q] += d[q] * t[q];
          pb[q] += d[q];
        }
      }
      const float m1 = warp_sum(s1) * inv_c;
      const float m2 = warp_sum(s2) * inv_c;
#pragma unroll
      for (int q = 0; q < kLnPer; ++q)
        if (lane + 32 * q < C) d[q] = inv * (d[q] * lw[q] - m1 - t[q] * m2);
    }
#pragma unroll
    for (int q = 0; q < kLnPer; ++q) {
      const int c = lane + 32 * q;
      if (c < C) {
        const float v = add ? d[q] + to_f32(add[o + c]) : d[q];
        dx[o + c] = from_f32<Act>(v);
        srow[c] = v;
      }
    }
  }
  if (ln_w && lnpart) {
#pragma unroll
    for (int q = 0; q < kLnPer; ++q) {
      comb[(warp * 2) * kMaxN + lane + 32 * q] = pw[q];
      comb[(warp * 2 + 1) * kMaxN + lane + 32 * q] = pb[q];
    }
  }
  __syncthreads();
  if (ln_w && lnpart) {
    for (int e = threadIdx.x; e < 2 * C; e += kTThreads) {
      const int k = e / C;
      const int c = e - k * C;
      float acc = 0.f;
      for (int w = 0; w < kTWarps; ++w) acc += comb[(w * 2 + k) * kMaxN + c];
      lnpart[e] = acc;
    }
  }
  __syncthreads();
}

// ---- AB's row products -----------------------------------------------------

// Up to three terms a_t (M, K) times transposed weights w_t (N, K), summed.
template <typename Src>
struct RowTerms {
  const Src* a[3];
  const float* w[3];
  int count;
};

// acc = sum_t a_t w_t^T over 128 rows of the a_t (of type Src, rounded to
// the row type as they are loaded), then either out (Act) = acc, or, with
// x given (N = C), the LayerNorm backward of tile_ln_bwd at dh = acc: dx,
// dh itself to dh32 (when given) and the block's LN partials to
// lnpart[blockIdx.x].
template <typename Act, typename Src>
__global__ void __launch_bounds__(kTThreads, 1)
rows_bwd_kernel(RowTerms<Src> terms, Act* __restrict__ out,
                const Act* __restrict__ x, const float* __restrict__ ln_w,
                Act* __restrict__ dx, float* __restrict__ dh32,
                float* __restrict__ lnpart, int M, int T, int K, int N,
                int vec) {
  using P = typename TileOf<Act>::type;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  auto* rows = reinterpret_cast<typename P::Row*>(tile_smem);
  const int row0 = blockIdx.x * kTRows;
  float acc[kTNT][4];
#pragma unroll
  for (int j = 0; j < kTNT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int t = 0; t < terms.count; ++t) {
    tile_load_rows<P>(rows, terms.a[t], row0, M, K, vec);
    tile_mma<P, true>(rows, terms.w[t], N, K, tile_smem, acc);
  }
  float* stage = tile_stage<P>(tile_smem);
  tile_stage_acc(acc, stage);
  __syncthreads();
  const int nr = M - row0 < kTRows ? M - row0 : kTRows;
  if (x) {
    tile_ln_bwd<Act>(stage, tile_comb<P>(tile_smem), x, nullptr, ln_w,
                     static_cast<const Act*>(nullptr), dx, dh32,
                     lnpart ? lnpart + static_cast<size_t>(blockIdx.x) * 2 * N
                            : nullptr,
                     row0, M, T, N);
    return;
  }
  if (vec) {
    const int q4 = N / 4;
    for (int e = threadIdx.x; e < nr * q4; e += kTThreads) {
      const int r = e / q4;
      const int c = 4 * (e - r * q4);
      st4(out + static_cast<size_t>(row0 + r) * N + c,
          ld4(stage + r * kTLdS + c));
    }
    return;
  }
  for (int e = threadIdx.x; e < nr * N; e += kTThreads) {
    const int r = e / N;
    const int c = e - r * N;
    out[static_cast<size_t>(row0 + r) * N + c] =
        from_f32<Act>(stage[r * kTLdS + c]);
  }
}

template <typename Act, typename Src>
cudaError_t launch_rows_bwd(const RowTerms<Src>& terms, Act* out,
                            const Act* x, const float* ln_w, Act* dx,
                            float* dh32, float* lnpart, int M, int T, int K,
                            int N, cudaStream_t st) {
  if (terms.count < 1 || terms.count > 3 || K > kMaxN || N > kMaxN)
    return cudaErrorInvalidValue;
  constexpr size_t smem = tile_smem_bytes<typename TileOf<Act>::type>();
  const cudaError_t err = tile_prepare(rows_bwd_kernel<Act, Src>, smem);
  if (err != cudaSuccess) return err;
  bool al = tile_aligned({out, x, dx, dh32});
  for (int t = 0; t < terms.count; ++t) al = al && tile_aligned({terms.a[t]});
  const int vec = K % 4 == 0 && N % 4 == 0 && al;
  rows_bwd_kernel<Act, Src>
      <<<(M + kTRows - 1) / kTRows, kTThreads, smem, st>>>(
          terms, out, x, ln_w, dx, dh32, lnpart, M, T, K, N, vec);
  return cudaGetLastError();
}

// ---- sums over blocks and windows -----------------------------------------

// dst[i] (Act) = sum_{a < n} src[a stride + i] in ascending a, i < len, one
// thread an entry: the LN partials over the row tiles, dpos over windows.
template <typename Act>
__global__ void __launch_bounds__(256)
ordered_sum_kernel(const float* __restrict__ src, Act* __restrict__ dst,
                   int n, size_t stride, int len) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= len) return;
  float acc = 0.f;
  for (int a = 0; a < n; ++a) acc += src[static_cast<size_t>(a) * stride + i];
  dst[i] = from_f32<Act>(acc);
}

template <typename Act>
cudaError_t launch_ordered_sum(const float* src, Act* dst, int n,
                               size_t stride, int len, cudaStream_t st) {
  ordered_sum_kernel<Act><<<(len + 255) / 256, 256, 0, st>>>(src, dst, n,
                                                             stride, len);
  return cudaGetLastError();
}

// ---- weight gradients ---------------------------------------------------

// The rows of a weight gradient are cut into at most kMaxGroups groups of a
// multiple of 16 consecutive rows; each group's sum is a partial, and the
// partials are summed in group order.
constexpr int kMaxGroups = 128;

inline int group_rows(int M) {
  const int per = (M + kMaxGroups - 1) / kMaxGroups;
  return (per + 15) / 16 * 16;
}

constexpr int kWThreads = 256;  // eight warps
constexpr int kWRows = 32;      // rows a stage
constexpr int kWN = 96;         // rows of dW a block owns

// One gradient: dw (N, K) = D^T X and db (N) = the column sums of D over
// the M rows; D (M, N) f32, or of the activation type with d_act; X (M, K)
// of the activation type. part holds G (N, K + 1) partials (column K: db's)
// for the G groups of R rows.
struct WgradJob {
  const void* D;
  const void* X;
  float* part;
  float* dw;
  float* db;
  int M, N, K, R, G, d_act;
};
struct WgradJobs {
  WgradJob j[4];
};

template <class P>
struct WgradTile;
template <>
struct WgradTile<TileF32> {
  static constexpr int kLdD = kWN + 8;     // 104 floats: 8 mod 32
  static constexpr int kLdX = kMaxN + 8;   // 200 floats
  static constexpr int kStages = 4;        // 152 KB in flight
  static constexpr int kBlocks = 1;        // 178 registers
  using XRow = float;
};
template <>
struct WgradTile<TileBf16> {
  static constexpr int kLdD = kWN + 4;     // 100 floats: 4 mod 32
  static constexpr int kLdX = kMaxN + 8;   // 200 bf16: 400 bytes a row
  static constexpr int kStages = 3;        // 75 KB: two blocks an SM
  static constexpr int kBlocks = 2;        // within 128 registers
  using XRow = __nv_bfloat16;
};

template <class P>
constexpr size_t wgrad_smem_bytes() {
  using W = WgradTile<P>;
  return W::kStages * kWRows * (sizeof(float) * W::kLdD +
                                sizeof(typename W::XRow) * W::kLdX);
}

// The stage of rows [r0, r0 + 32) (rows at or past r_end zeros): D's
// columns [n0, n0 + 96) widened to f32 (columns past N zeros) and X's
// columns [0, kMaxN) in its own type (columns past K zeros); cp.async where
// the rows allow 16-byte copies (committed by the caller), else loads.
template <class P, typename Act>
__device__ __forceinline__ void wgrad_stage(float* ds,
                                            typename WgradTile<P>::XRow* xs,
                                            const WgradJob& J, int n0,
                                            int r0, int r_end, bool dvec,
                                            bool xvec) {
  using W = WgradTile<P>;
  using XRow = typename W::XRow;
  const int N = J.N, K = J.K;
  if (J.d_act && sizeof(Act) == 2) {
    const Act* D = static_cast<const Act*>(J.D);
    for (int e = threadIdx.x; e < kWRows * kWN; e += kWThreads) {
      const int rr = e / kWN;
      const int c = e - rr * kWN;
      const int r = r0 + rr;
      ds[rr * W::kLdD + c] =
          r < r_end && n0 + c < N
              ? to_f32(D[static_cast<size_t>(r) * N + n0 + c])
              : 0.f;
    }
  } else if (dvec) {
    const float* D = static_cast<const float*>(J.D);
    constexpr int kQ = kWN / 4;
    for (int e = threadIdx.x; e < kWRows * kQ; e += kWThreads) {
      const int rr = e / kQ;
      const int c = 4 * (e - rr * kQ);
      const int r = r0 + rr;
      const bool ok = r < r_end && n0 + c < N;
      cp_async16(ds + rr * W::kLdD + c,
                 D + (ok ? static_cast<size_t>(r) * N + n0 + c : 0),
                 ok ? 16 : 0);
    }
  } else {
    const float* D = static_cast<const float*>(J.D);
    for (int e = threadIdx.x; e < kWRows * kWN; e += kWThreads) {
      const int rr = e / kWN;
      const int c = e - rr * kWN;
      const int r = r0 + rr;
      ds[rr * W::kLdD + c] =
          r < r_end && n0 + c < N ? D[static_cast<size_t>(r) * N + n0 + c]
                                  : 0.f;
    }
  }
  const XRow* X = static_cast<const XRow*>(J.X);
  if (xvec) {
    constexpr int kPer = 16 / sizeof(XRow);  // values a 16-byte copy
    constexpr int kQ = kMaxN / kPer;
    for (int e = threadIdx.x; e < kWRows * kQ; e += kWThreads) {
      const int rr = e / kQ;
      const int c = kPer * (e - rr * kQ);
      const int r = r0 + rr;
      const bool ok = r < r_end && c < K;
      cp_async16(xs + rr * W::kLdX + c,
                 X + (ok ? static_cast<size_t>(r) * K + c : 0), ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kWRows * kMaxN; e += kWThreads) {
      const int rr = e / kMaxN;
      const int c = e - rr * kMaxN;
      const int r = r0 + rr;
      xs[rr * W::kLdX + c] = r < r_end && c < K
                                 ? X[static_cast<size_t>(r) * K + c]
                                 : from_f32<XRow>(0.f);
    }
  }
}

// One stage's products (32 rows) into acc: warp w owns dW rows 48 (w % 2)
// .. + 47 of the block's 96 (three m-tiles i) and columns 48 (w / 2) ..
// + 47 (six n-tiles j); tiles past N or K are skipped.
__device__ __forceinline__ void wgrad_step(TileF32, const float* ds,
                                           const float* xs, int mr, int nc,
                                           int nm, int K,
                                           float (&acc)[3][6][4]) {
  using W = WgradTile<TileF32>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int kb = 0; kb < kWRows; kb += 8) {
    // A (m16n8k8): (m g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of
    // D^T, i.e. D's rows kb + t, kb + t + 4 at columns mr + 16 i + g, + 8
    uint32_t ab[3][4], as[3][4];
    const float* d0 = ds + (kb + t) * W::kLdD + mr + g;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      tf32_split(d0[16 * i], ab[i][0], as[i][0]);
      tf32_split(d0[16 * i + 8], ab[i][1], as[i][1]);
      tf32_split(d0[4 * W::kLdD + 16 * i], ab[i][2], as[i][2]);
      tf32_split(d0[4 * W::kLdD + 16 * i + 8], ab[i][3], as[i][3]);
    }
    const float* x0 = xs + (kb + t) * W::kLdX + nc + g;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      if (nc + 8 * j >= K) continue;
      uint32_t bb0, bs0, bb1, bs1;
      tf32_split(x0[8 * j], bb0, bs0);
      tf32_split(x0[4 * W::kLdX + 8 * j], bb1, bs1);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (16 * i >= nm) continue;
        mma_tf32(acc[i][j], as[i], bb0, bb1);
        mma_tf32(acc[i][j], ab[i], bs0, bs1);
        mma_tf32(acc[i][j], ab[i], bb0, bb1);
      }
    }
  }
}

__device__ __forceinline__ void wgrad_step(TileBf16, const float* ds,
                                           const __nv_bfloat16* xs, int mr,
                                           int nc, int nm, int K,
                                           float (&acc)[3][6][4]) {
  using W = WgradTile<TileBf16>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int kb = 0; kb < kWRows; kb += 16) {
    // A (m16n8k16): (m g, k 2t..2t+1), (g + 8, ..), (g, 2t + 8..), (g + 8,
    // 2t + 8..) of D^T: D's rows kb + 2t, + 1 (and + 8) at columns mr + 16
    // i + g, + 8, rounded to bf16
    uint32_t a[3][4];
    const float* d0 = ds + (kb + 2 * t) * W::kLdD + mr + g;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float* d = d0 + 16 * i;
      a[i][0] = pack_bf16(d[0], d[W::kLdD]);
      a[i][1] = pack_bf16(d[8], d[W::kLdD + 8]);
      a[i][2] = pack_bf16(d[8 * W::kLdD], d[9 * W::kLdD]);
      a[i][3] = pack_bf16(d[8 * W::kLdD + 8], d[9 * W::kLdD + 8]);
    }
    // B: matrices (rows kb .. + 7, columns n), (kb + 8 .., n), (kb .., n +
    // 8), (kb + 8 .., n + 8), transposed: two n-tiles a load
    const __nv_bfloat16* p =
        xs + (kb + (lane & 15)) * W::kLdX + nc + (lane >> 4) * 8;
#pragma unroll
    for (int j = 0; j < 6; j += 2) {
      if (nc + 8 * j >= K) continue;
      uint32_t b[4];
      ldsm_x4_t(b, p + 8 * j);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (16 * i >= nm) continue;
        mma_bf16(acc[i][j], a[i], b[0], b[1]);
        if (nc + 8 * j + 8 < K) mma_bf16(acc[i][j + 1], a[i], b[2], b[3]);
      }
    }
  }
}

// Partial dW and db of job blockIdx.z over group blockIdx.x, dW rows
// [96 blockIdx.y, + 96): the group's rows in stages of 32 through a ring of
// kStages buffers, kStages - 1 stages in flight (cp.async) while one is
// multiplied, db's column sums by the block's first 96 threads, each over
// the stage's rows in order.
template <class P, typename Act>
__global__ void __launch_bounds__(kWThreads, WgradTile<P>::kBlocks)
wgrad_mma_kernel(WgradJobs jobs) {
  using W = WgradTile<P>;
  using XRow = typename W::XRow;
  extern __shared__ __align__(16) unsigned char wgrad_smem[];
  const WgradJob J = jobs.j[blockIdx.z];
  const int grp = blockIdx.x;
  const int n0 = blockIdx.y * kWN;
  if (grp >= J.G || n0 >= J.N) return;  // the whole block
  constexpr int kS = W::kStages;
  float* ds = reinterpret_cast<float*>(wgrad_smem);
  XRow* xs = reinterpret_cast<XRow*>(ds + kS * kWRows * W::kLdD);
  const int r_begin = grp * J.R;
  const int r_end = min(r_begin + J.R, J.M);
  const int nst = (r_end - r_begin + kWRows - 1) / kWRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mr = 48 * (warp & 1);  // the warp's dW rows in the block's 96
  const int nc = 48 * (warp >> 1);
  const int nm = J.N - n0 - mr;    // its rows below N
  const bool dvec = J.N % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(J.D) % 16 == 0;
  const bool xvec = J.K % (16 / sizeof(XRow)) == 0 &&
                    reinterpret_cast<uintptr_t>(J.X) % 16 == 0;
  float acc[3][6][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  float bsum = 0.f;

#pragma unroll
  for (int f = 0; f < kS - 1; ++f) {
    if (f < nst)
      wgrad_stage<P, Act>(ds + f * kWRows * W::kLdD, xs + f * kWRows * W::kLdX,
                          J, n0, r_begin + f * kWRows, r_end, dvec, xvec);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    // into the buffer of stage s - 1, which the last barrier freed
    const int f = s + kS - 1;
    if (f < nst)
      wgrad_stage<P, Act>(ds + (f % kS) * kWRows * W::kLdD,
                          xs + (f % kS) * kWRows * W::kLdX, J, n0,
                          r_begin + f * kWRows, r_end, dvec, xvec);
    cp_async_commit();
    cp_async_wait<kS - 1>();  // stage s has landed
    __syncthreads();
    const int b = s % kS;
    const float* dsb = ds + b * kWRows * W::kLdD;
    if (threadIdx.x < kWN) {
#pragma unroll 8
      for (int r = 0; r < kWRows; ++r) bsum += dsb[r * W::kLdD + threadIdx.x];
    }
    if (nm > 0)
      wgrad_step(P{}, dsb, xs + b * kWRows * W::kLdX, mr, nc, nm, J.K, acc);
    __syncthreads();
  }
  // the partials: dW rows n0 + mr + 16 i + g (+ 8), columns nc + 8 j + 2t
  // (+ 1); db in column K
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t ld = static_cast<size_t>(J.K) + 1;
  float* part = J.part + static_cast<size_t>(grp) * J.N * ld;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + mr + 16 * i + g + 8 * (e >> 1);
        const int k = nc + 8 * j + 2 * t + (e & 1);
        if (n < J.N && k < J.K) part[n * ld + k] = acc[i][j][e];
      }
  if (threadIdx.x < kWN && n0 + threadIdx.x < J.N)
    part[(n0 + threadIdx.x) * ld + J.K] = bsum;
}

// dw (N, K) and db (N) of job blockIdx.y: its G partials summed in group
// order, one thread an entry.
__global__ void __launch_bounds__(256)
wgrad_sum_kernel(WgradJobs jobs) {
  const WgradJob& J = jobs.j[blockIdx.y];
  const int e = blockIdx.x * 256 + threadIdx.x;
  const int n_all = J.N * (J.K + 1);
  if (e >= n_all) return;
  float acc = 0.f;
  for (int g = 0; g < J.G; ++g)
    acc += J.part[static_cast<size_t>(g) * n_all + e];
  const int n = e / (J.K + 1);
  const int k = e - n * (J.K + 1);
  if (k < J.K)
    J.dw[static_cast<size_t>(n) * J.K + k] = acc;
  else
    J.db[n] = acc;
}

// Fills in each job's R and G from its M.
inline void wgrad_groups(WgradJob& J) {
  J.R = group_rows(J.M);
  J.G = (J.M + J.R - 1) / J.R;
}

// The n jobs' weight gradients: one launch of partials, one of their sums.
template <typename Act>
cudaError_t launch_wgrad_mma(WgradJobs jobs, int n, cudaStream_t st) {
  using P = typename TileOf<Act>::type;
  int most = 0, g_most = 0;
  for (int j = 0; j < n; ++j) {
    WgradJob& J = jobs.j[j];
    if (J.N > 2 * kWN || J.K > kMaxN || J.M < 1) return cudaErrorInvalidValue;
    wgrad_groups(J);
    most = J.N * (J.K + 1) > most ? J.N * (J.K + 1) : most;
    g_most = J.G > g_most ? J.G : g_most;
  }
  constexpr size_t smem = wgrad_smem_bytes<P>();
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_mma_kernel<P, Act>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  wgrad_mma_kernel<P, Act>
      <<<dim3(g_most, 2, n), kWThreads, smem, st>>>(jobs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wgrad_sum_kernel<<<dim3((most + 255) / 256, n), 256, 0, st>>>(jobs);
  return cudaGetLastError();
}

}  // namespace gsasr
