// Kernel A: fused pre-norm multi-head attention with its out-projection.
//
// Replaces _k_ln_attn of gsasr_tpu/ops/fused_layers.py (ln_attn_proj):
//
//   xq  = LN(x) (+ pos)                       LN statistics in f32
//   src = kv (cross-attention, un-normed) | xq (self-attention)
//   q = rope?(xq Wq^T + bq), k = rope?(src Wk^T + bk), v = src Wv^T + bv
//   att_h = softmax(q_h k_h^T * scale + bias[h]) v_h
//   out = att Wo^T + bo
//
// rope (the Enhanced family) rotates each (even, odd) column pair in f32,
// x * cos + (-odd, even) * sin, with pair-duplicated (T, C) tables. x, pos,
// kv and out are float or bfloat16; in bfloat16 the kernel rounds where
// _k_ln_attn rounds: xq, the weights as they are staged, q and k after the
// rotation, v, the probabilities, att and the result. Scores, softmax and
// sums stay f32.
//
// What bounds it on an H100: the products, 2 * windows * (4 T C^2 + 2 T^2 C)
// FP32 operations (11.8 GFLOP at 225 windows x 144 tokens x 180 channels,
// 13.4 at 192) against 67 TFLOP/s; the exps (28 M) and the bytes (3 row
// tensors, 70 MB in float32) take far less. The bfloat16 forms run the same
// f32 FMAs; against the bf16 tensor-core peak their bound is the bytes.
//
// Design. One window's f32 working set (LN rows, q, k, v: 4 x 104 KB, plus
// one head's 144x144 scores) does not fit a block's 227 KB of shared memory,
// so phase 1 runs one 256-thread block per (window, head): it normalizes the
// window's rows into shared memory, forms that head's q, k and v (T x hd)
// with the head's weight rows staged in shared memory, then each warp takes
// four query rows at a time, holds their scores in registers (lane l owns
// keys l + 32 m), takes the softmax with warp reductions and multiplies by v
// through a per-warp row of probabilities. Each head writes its own columns
// of the attention output, so heads are summed by the out-projection and not
// by atomics. RoPE and the bfloat16 rounding of q, k and v are one pass
// over the head's columns between the projections and the softmax: with an
// even head width no pair straddles two heads. Phase 2, the
// out-projection, is the 64-row FP32 tile product of tile_gemm.cuh over the
// attention rows, plus the bias.
//
// A-long, the form for windows of more than 160 tokens (the Ultra and
// SwinIR-Enhanced decoders' 256 seeds and 256 keys in windows of 16): at T
// = 256 one (window, head)'s LN rows, weight rows and q, k, v would take
// 323 KB of shared memory, so phase 1 splits in two launches. (1a) One
// block per 64 rows normalizes them (+ pos) and forms q, or k and v, for
// all heads at once with the tile product, adds the bias, rotates q and k
// (RoPE, the pair partner from the neighbouring lane) and rounds q, k, v to
// the activation type into scratch. (1b) The attention of each (window,
// head) is W-long's body on that scratch (the 3xTF32 tensor-core body of
// window_attn_long_tf32.cuh in fp32; in bf16 W-long-bf16's tensor-core
// body, window_attn_long_mma.cuh, where p is rounded before the PV product
// and att as it is stored). Phase 2 is
// the out-projection above, reading att in the activation type. The
// rounding points are those of _k_ln_attn. Bound at 144 windows, T = 256,
// C = 192: 2 * windows * (4 T C^2 + 2 T^2 C) = 18.1 GFLOP, 0.27 ms at the
// FP32 peak; in bf16 the bytes (x, kv, out) take longer than the products
// at the tensor-core peak. A-long's projections run f32 FMAs on the CUDA
// cores; its fp32 attention runs on the tensor cores in 3xTF32.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <type_traits>

#include "tile_gemm.cuh"
#include "window_attn_long_mma.cuh"
#include "window_attn_long_tf32.cuh"

namespace {

using namespace gsasr;

// Phase-1 limits: tokens per lane of the score rows and head width per lane.
constexpr int kKeysPer = 5;
constexpr int kMaxT = 32 * kKeysPer;  // 160
constexpr int kMaxHd = 32;
constexpr int kQRows = 4;  // query rows a warp holds at once
// Projection micro-tile: 32 row groups x 8 column groups.
constexpr int kPRowGroups = 32;
constexpr int kPColGroups = kThreads / kPRowGroups;
constexpr int kPRowsPer = kMaxT / kPRowGroups;   // 5
constexpr int kPColsPer = kMaxHd / kPColGroups;  // 4

struct Phase1Layout {
  int ldx, ldw, ldq, x_floats, w_floats, q_floats;
  __host__ __device__ Phase1Layout(int T, int C, int hd) {
    ldx = C | 1;
    ldw = C | 1;
    ldq = hd | 1;
    // the x rows, later the warps' probability rows (kQRows x T each)
    x_floats = T * ldx > kWarps * kQRows * T ? T * ldx : kWarps * kQRows * T;
    w_floats = hd * ldw;
    q_floats = T * ldq;
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * (x_floats + w_floats + 3 * q_floats);
  }
};

// dst[t * ldq + n] = sum_c xs[t * ldx + c] * W[(n0 + n) * C + c] + b[n0 + n]
// for t < T, n < hd. The head's weight rows are staged in ws first, rounded
// to bf16 with kRoundW.
template <bool kRoundW>
__device__ void project_head(const float* xs, int ldx, int T,
                             const float* __restrict__ W,
                             const float* __restrict__ b, int n0, int hd,
                             int C, float* ws, int ldw, float* dst, int ldq) {
  const int tid = threadIdx.x;
  __syncthreads();
  for (int e = tid; e < hd * C; e += kThreads) {
    const int n = e / C;
    const int c = e - n * C;
    const float w = W[static_cast<size_t>(n0 + n) * C + c];
    ws[n * ldw + c] = kRoundW ? rnd<__nv_bfloat16>(w) : w;
  }
  __syncthreads();
  const int rg = tid / kPColGroups;
  const int cg = tid % kPColGroups;
  float acc[kPRowsPer][kPColsPer];
#pragma unroll
  for (int a = 0; a < kPRowsPer; ++a)
#pragma unroll
    for (int j = 0; j < kPColsPer; ++j) acc[a][j] = 0.f;
  int rows[kPRowsPer], cols[kPColsPer];
#pragma unroll
  for (int a = 0; a < kPRowsPer; ++a)
    rows[a] = min(rg + kPRowGroups * a, T - 1);
#pragma unroll
  for (int j = 0; j < kPColsPer; ++j)
    cols[j] = min(cg + kPColGroups * j, hd - 1);
  for (int c = 0; c < C; ++c) {
    float wv[kPColsPer];
#pragma unroll
    for (int j = 0; j < kPColsPer; ++j) wv[j] = ws[cols[j] * ldw + c];
#pragma unroll
    for (int a = 0; a < kPRowsPer; ++a) {
      const float xv = xs[rows[a] * ldx + c];
#pragma unroll
      for (int j = 0; j < kPColsPer; ++j) acc[a][j] = fmaf(xv, wv[j], acc[a][j]);
    }
  }
#pragma unroll
  for (int a = 0; a < kPRowsPer; ++a) {
    const int t = rg + kPRowGroups * a;
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < kPColsPer; ++j) {
      const int n = cg + kPColGroups * j;
      if (n < hd) dst[t * ldq + n] = acc[a][j] + b[n0 + n];
    }
  }
}

// p[0], p[1] := the pair rotated by the table entries c and s (when c is
// given), then rounded to Act. The products and the sum round one by one,
// as x * cos + shuffle(x) * sin does, with no contraction into an FMA.
template <typename Act>
__device__ __forceinline__ void rotate_pair(float* p, const float* c,
                                            const float* s) {
  float a = p[0], b = p[1];
  if (c) {
    const float ra = __fadd_rn(__fmul_rn(a, c[0]), __fmul_rn(-b, s[0]));
    b = __fadd_rn(__fmul_rn(b, c[1]), __fmul_rn(a, s[1]));
    a = ra;
  }
  p[0] = rnd<Act>(a);
  p[1] = rnd<Act>(b);
}

template <typename Act>
__global__ void __launch_bounds__(kThreads)
attn_heads_kernel(const Act* __restrict__ x, const Act* __restrict__ pos,
                  const Act* __restrict__ kv, const float* __restrict__ ln_w,
                  const float* __restrict__ ln_b, const float* __restrict__ wq,
                  const float* __restrict__ bq, const float* __restrict__ wk,
                  const float* __restrict__ bk, const float* __restrict__ wv,
                  const float* __restrict__ bv, const float* __restrict__ bias,
                  const float* __restrict__ cos_q,
                  const float* __restrict__ sin_q,
                  const float* __restrict__ cos_k,
                  const float* __restrict__ sin_k, float* __restrict__ att,
                  int Tq, int Tk, int C, int nh, float scale) {
  constexpr bool kBf16 = sizeof(Act) == 2;
  extern __shared__ float smem[];
  const int hd = C / nh;
  const int T = max(Tq, Tk);
  const Phase1Layout L(T, C, hd);
  float* xs = smem;
  float* ws = xs + L.x_floats;
  float* qs = ws + L.w_floats;
  float* ks = qs + L.q_floats;
  float* vs = ks + L.q_floats;
  const int head = blockIdx.x;
  const int win = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n0 = head * hd;

  // xq = LN(x) (+ pos)
  for (int r = warp; r < Tq; r += kWarps) {
    float v[kLnPer];
    load_row_ln(x + (static_cast<size_t>(win) * Tq + r) * C, nullptr, ln_w,
                ln_b, C, v);
#pragma unroll
    for (int q = 0; q < kLnPer; ++q) {
      const int c = lane + 32 * q;
      if (c < C)
        xs[r * L.ldx + c] = rnd<Act>(
            pos ? v[q] + to_f32(pos[static_cast<size_t>(r) * C + c]) : v[q]);
    }
  }
  project_head<kBf16>(xs, L.ldx, Tq, wq, bq, n0, hd, C, ws, L.ldw, qs, L.ldq);

  if (kv) {
    __syncthreads();
    for (int e = threadIdx.x; e < Tk * C; e += kThreads) {
      const int r = e / C;
      const int c = e - r * C;
      xs[r * L.ldx + c] = to_f32(kv[static_cast<size_t>(win) * Tk * C + e]);
    }
  }
  project_head<kBf16>(xs, L.ldx, Tk, wk, bk, n0, hd, C, ws, L.ldw, ks, L.ldq);
  project_head<kBf16>(xs, L.ldx, Tk, wv, bv, n0, hd, C, ws, L.ldw, vs, L.ldq);
  __syncthreads();

  // RoPE on q and k in f32 (rows 0..T-1, columns n0..n0+hd of the tables),
  // then q, k and v rounded to the activation type; one thread per pair
  if (cos_q || kBf16) {
    const int pairs = hd / 2;
    for (int e = threadIdx.x; e < T * pairs; e += kThreads) {
      const int t = e / pairs;
      const int n = 2 * (e - t * pairs);
      if (t < Tq) {
        const size_t o = static_cast<size_t>(t) * C + n0 + n;
        rotate_pair<Act>(qs + t * L.ldq + n, cos_q ? cos_q + o : nullptr,
                         cos_q ? sin_q + o : nullptr);
      }
      if (t < Tk) {
        const size_t o = static_cast<size_t>(t) * C + n0 + n;
        rotate_pair<Act>(ks + t * L.ldq + n, cos_k ? cos_k + o : nullptr,
                         cos_k ? sin_k + o : nullptr);
        rotate_pair<Act>(vs + t * L.ldq + n, nullptr, nullptr);
      }
    }
    __syncthreads();
  }

  // Softmax rows; the per-warp probability rows reuse the x buffer.
  float* prow = xs + warp * kQRows * Tk;
  const float* hbias = bias ? bias + static_cast<size_t>(head) * Tq * Tk : nullptr;
  for (int i0 = warp * kQRows; i0 < Tq; i0 += kWarps * kQRows) {
    float s[kQRows][kKeysPer];
#pragma unroll
    for (int r = 0; r < kQRows; ++r)
#pragma unroll
      for (int m = 0; m < kKeysPer; ++m) s[r][m] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qd[kQRows];
#pragma unroll
      for (int r = 0; r < kQRows; ++r) qd[r] = qs[min(i0 + r, Tq - 1) * L.ldq + d];
#pragma unroll
      for (int m = 0; m < kKeysPer; ++m) {
        const int j = min(lane + 32 * m, Tk - 1);
        const float kd = ks[j * L.ldq + d];
#pragma unroll
        for (int r = 0; r < kQRows; ++r) s[r][m] = fmaf(qd[r], kd, s[r][m]);
      }
    }
#pragma unroll
    for (int r = 0; r < kQRows; ++r) {
      const int i = min(i0 + r, Tq - 1);
      float mx = -INFINITY;
#pragma unroll
      for (int m = 0; m < kKeysPer; ++m) {
        const int j = lane + 32 * m;
        if (j < Tk) {
          s[r][m] = s[r][m] * scale;
          if (hbias) s[r][m] += hbias[static_cast<size_t>(i) * Tk + j];
          mx = fmaxf(mx, s[r][m]);
        }
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int m = 0; m < kKeysPer; ++m) {
        const int j = lane + 32 * m;
        if (j < Tk) {
          s[r][m] = expf(s[r][m] - mx);
          sum += s[r][m];
        }
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int m = 0; m < kKeysPer; ++m) {
        const int j = lane + 32 * m;
        if (j < Tk) prow[r * Tk + j] = rnd<Act>(s[r][m] / sum);
      }
    }
    __syncwarp();
    if (lane < hd) {
      float o[kQRows] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < Tk; ++j) {
        const float vj = vs[j * L.ldq + lane];
#pragma unroll
        for (int r = 0; r < kQRows; ++r) o[r] = fmaf(prow[r * Tk + j], vj, o[r]);
      }
#pragma unroll
      for (int r = 0; r < kQRows; ++r) {
        if (i0 + r < Tq)
          att[(static_cast<size_t>(win) * Tq + i0 + r) * C + n0 + lane] =
              rnd<Act>(o[r]);
      }
    }
    __syncwarp();
  }
}

// att is float (A) or the activation type (A-long).
template <typename Act, typename Att = float>
__global__ void __launch_bounds__(kThreads)
out_proj_kernel(const Att* __restrict__ att, const float* __restrict__ wo,
                const float* __restrict__ bo, Act* __restrict__ out, int M,
                int C) {
  extern __shared__ float smem[];
  float* as = smem;
  float* ws = as + kBM * C;
  const int row0 = blockIdx.x * kBM;
  for (int e = threadIdx.x; e < kBM * C; e += kThreads) {
    const int g = row0 + e / C;
    as[e] = g < M ? to_f32(att[static_cast<size_t>(row0) * C + e]) : 0.f;
  }
  float acc[kRowsPer][kMaxColsPer];
  gemm_rows<false, sizeof(Act) == 2>(as, C, wo, C, C, ws, acc);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kMaxColsPer; ++j) {
    const int n = lane + 32 * j;
    if (n >= C) continue;
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int g = row0 + warp + kWarps * i;
      if (g < M)
        out[static_cast<size_t>(g) * C + n] = from_f32<Act>(acc[i][j] + bo[n]);
    }
  }
}

// dst[g, n] = acc + b[n] for the block's rows g = row0 + warp + 8 i < M (the
// tile product's layout), rotated by the (T, C) tables ct, st at token
// g % T when given, rounded to Act. The pair partner n ^ 1 of column n
// lives in lane ^ 1 of the same warp.
template <typename Act>
__device__ __forceinline__ void store_proj(
    const float (&acc)[kRowsPer][kMaxColsPer], const float* __restrict__ b,
    const float* __restrict__ ct, const float* __restrict__ st,
    Act* __restrict__ dst, int row0, int M, int T, int C) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int g = row0 + warp + kWarps * i;
#pragma unroll
    for (int j = 0; j < kMaxColsPer; ++j) {
      const int n = lane + 32 * j;
      float val = n < C ? acc[i][j] + b[n] : 0.f;
      const float other = __shfl_xor_sync(0xffffffffu, val, 1);
      if (n >= C || g >= M) continue;
      if (ct) {
        const size_t o = static_cast<size_t>(g % T) * C + n;
        val = (n & 1) ? __fadd_rn(__fmul_rn(val, ct[o]),
                                  __fmul_rn(other, st[o]))
                      : __fadd_rn(__fmul_rn(val, ct[o]),
                                  __fmul_rn(-other, st[o]));
      }
      dst[static_cast<size_t>(g) * C + n] = from_f32<Act>(val);
    }
  }
}

// A-long phase 1a: blockIdx.y 0 forms q from 64 rows of LN(x) (+ pos);
// blockIdx.y 1 forms k and v from 64 rows of kv (cross-attention) or of
// LN(x) (+ pos) (self-attention). Each projection adds its bias, rotates
// q and k by the (T, C) tables at the row's token (in f32 with no
// contraction, as rotate_pair) and rounds to Act as it stores.
template <typename Act>
__global__ void __launch_bounds__(kThreads)
ln_qkv_kernel(const Act* __restrict__ x, const Act* __restrict__ pos,
              const Act* __restrict__ kv, const float* __restrict__ ln_w,
              const float* __restrict__ ln_b, const float* __restrict__ wq,
              const float* __restrict__ bq, const float* __restrict__ wk,
              const float* __restrict__ bk, const float* __restrict__ wv,
              const float* __restrict__ bv, const float* __restrict__ cos_q,
              const float* __restrict__ sin_q,
              const float* __restrict__ cos_k,
              const float* __restrict__ sin_k, Act* __restrict__ qo,
              Act* __restrict__ ko, Act* __restrict__ vo, int B, int Tq,
              int Tk, int C) {
  constexpr bool kBf16 = sizeof(Act) == 2;
  extern __shared__ float smem[];
  float* as = smem;
  float* ws = as + kBM * C;
  const bool is_q = blockIdx.y == 0;
  const int T = is_q ? Tq : Tk;
  const int M = B * T;
  const int row0 = blockIdx.x * kBM;
  if (row0 >= M) return;  // the whole block: no barrier is skipped
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (is_q || !kv) {
    for (int r = warp; r < kBM; r += kWarps) {
      const int g = row0 + r;
      float v[kLnPer];
      if (g < M)
        load_row_ln(x + static_cast<size_t>(g) * C, nullptr, ln_w, ln_b, C,
                    v);
#pragma unroll
      for (int q = 0; q < kLnPer; ++q) {
        const int c = lane + 32 * q;
        if (c >= C) continue;
        as[r * C + c] =
            g < M ? rnd<Act>(pos ? v[q] + to_f32(pos[static_cast<size_t>(
                                                      g % Tq) * C + c])
                                 : v[q])
                  : 0.f;
      }
    }
  } else {
    for (int e = threadIdx.x; e < kBM * C; e += kThreads) {
      const int g = row0 + e / C;
      as[e] = g < M ? to_f32(kv[static_cast<size_t>(row0) * C + e]) : 0.f;
    }
  }

  float acc[kRowsPer][kMaxColsPer];
  if (is_q) {
    gemm_rows<false, kBf16>(as, C, wq, C, C, ws, acc);
    store_proj(acc, bq, cos_q, sin_q, qo, row0, M, T, C);
  } else {
    gemm_rows<false, kBf16>(as, C, wk, C, C, ws, acc);
    store_proj(acc, bk, cos_k, sin_k, ko, row0, M, T, C);
    gemm_rows<false, kBf16>(as, C, wv, C, C, ws, acc);
    store_proj(acc, bv, nullptr, nullptr, vo, row0, M, T, C);
  }
}

template <typename Act>
int launch_long(const Act* x, const Act* pos, const Act* kv,
                const float* ln_w, const float* ln_b, const float* wq,
                const float* bq, const float* wk, const float* bk,
                const float* wv, const float* bv, const float* wo,
                const float* bo, const float* bias, const float* cos_q,
                const float* sin_q, const float* cos_k, const float* sin_k,
                Act* qs, Act* ks, Act* vs, Act* att, Act* out, int B, int Tq,
                int Tk, int C, int nh, float scale, cudaStream_t st) {
  const size_t smem1 = sizeof(float) * (kBM * C + kWsFloats);
  cudaError_t err = cudaFuncSetAttribute(
      ln_qkv_kernel<Act>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (B * std::max(Tq, Tk) + kBM - 1) / kBM;
  ln_qkv_kernel<Act><<<dim3(tiles, 2), kThreads, smem1, st>>>(
      x, pos, kv, ln_w, ln_b, wq, bq, wk, bk, wv, bv, cos_q, sin_q, cos_k,
      sin_k, qs, ks, vs, B, Tq, Tk, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (std::is_same_v<Act, __nv_bfloat16>) {
    // the bf16 form: W-long-bf16's tensor-core body
    err = launch_fwd_long_mma<false, false>(qs, ks, vs, bias, nullptr, att,
                                            B, Tq, Tk, C, nh, 1, scale, st);
  } else {
    // the fp32 form: W-long's tensor-core body in 3xTF32
    err = launch_fwd_long_tf32<false, false>(qs, ks, vs, bias, nullptr, att,
                                             B, Tq, Tk, C, nh, 1, scale, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem3 = sizeof(float) * (kBM * C + kWsFloats);
  err = cudaFuncSetAttribute(out_proj_kernel<Act, Act>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem3));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = B * Tq;
  out_proj_kernel<Act, Act><<<(M + kBM - 1) / kBM, kThreads, smem3, st>>>(
      att, wo, bo, out, M, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename Act>
int launch(const void* x, const void* pos, const void* kv, const float* ln_w,
           const float* ln_b, const float* wq, const float* bq,
           const float* wk, const float* bk, const float* wv, const float* bv,
           const float* wo, const float* bo, const float* bias,
           const float* cos_q, const float* sin_q, const float* cos_k,
           const float* sin_k, float* att, void* out, int B, int Tq, int Tk,
           int C, int nh, float scale, cudaStream_t st) {
  const Phase1Layout L(std::max(Tq, Tk), C, C / nh);
  cudaError_t err = cudaFuncSetAttribute(
      attn_heads_kernel<Act>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.bytes()));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_heads_kernel<Act><<<dim3(nh, B), kThreads, L.bytes(), st>>>(
      static_cast<const Act*>(x), static_cast<const Act*>(pos),
      static_cast<const Act*>(kv), ln_w, ln_b, wq, bq, wk, bk, wv, bv, bias,
      cos_q, sin_q, cos_k, sin_k, att, Tq, Tk, C, nh, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem2 = sizeof(float) * (kBM * C + kWsFloats);
  err = cudaFuncSetAttribute(out_proj_kernel<Act>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = B * Tq;
  out_proj_kernel<Act><<<(M + kBM - 1) / kBM, kThreads, smem2, st>>>(
      att, wo, bo, static_cast<Act*>(out), M, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out (B, Tq, C) and kv (B, Tk, C) or null (self-attention, Tk == Tq),
// pos (Tq, C) or null: float, or bfloat16 when bf16 is set. bias (nh, Tq,
// Tk) or null; cos_q, sin_q (Tq, C) and cos_k, sin_k (Tk, C), all four or
// none, pair-duplicated; weights (C, C) row-major as nn.Linear stores them:
// float. att (B, Tq, C) float is scratch the caller allocates.
extern "C" int ln_attn(const void* x, const void* pos, const void* kv,
                       const float* ln_w, const float* ln_b, const float* wq,
                       const float* bq, const float* wk, const float* bk,
                       const float* wv, const float* bv, const float* wo,
                       const float* bo, const float* bias, const float* cos_q,
                       const float* sin_q, const float* cos_k,
                       const float* sin_k, float* att, void* out, int B,
                       int Tq, int Tk, int C, int nh, int bf16, float scale,
                       void* stream) {
  const bool rope = cos_q != nullptr;
  if (B < 1 || nh < 1 || C % nh != 0 || C / nh > kMaxHd || C > kMaxN ||
      C > 32 * kLnPer || Tq > kMaxT || Tk > kMaxT || (!kv && Tk != Tq) ||
      rope != (sin_q != nullptr) || rope != (cos_k != nullptr) ||
      rope != (sin_k != nullptr) || ((rope || bf16) && (C / nh) % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, pos, kv, ln_w, ln_b, wq, bq, wk, bk,
                                      wv, bv, wo, bo, bias, cos_q, sin_q,
                                      cos_k, sin_k, att, out, B, Tq, Tk, C,
                                      nh, scale, st)
              : launch<float>(x, pos, kv, ln_w, ln_b, wq, bq, wk, bk, wv, bv,
                              wo, bo, bias, cos_q, sin_q, cos_k, sin_k, att,
                              out, B, Tq, Tk, C, nh, scale, st);
}

// Kernel A-long: as ln_attn for windows of any Tq and Tk (the window-16
// form), with x, pos, kv and out of the activation type; qs (B, Tq, C), ks
// and vs (B, Tk, C) and att (B, Tq, C), of the activation type too, are
// scratch the caller allocates.
extern "C" int ln_attn_long(const void* x, const void* pos, const void* kv,
                            const float* ln_w, const float* ln_b,
                            const float* wq, const float* bq, const float* wk,
                            const float* bk, const float* wv, const float* bv,
                            const float* wo, const float* bo,
                            const float* bias, const float* cos_q,
                            const float* sin_q, const float* cos_k,
                            const float* sin_k, void* qs, void* ks, void* vs,
                            void* att, void* out, int B, int Tq, int Tk,
                            int C, int nh, int bf16, float scale,
                            void* stream) {
  const bool rope = cos_q != nullptr;
  if (!long_shape_ok(B, Tq, Tk, C, nh) || C > kMaxN || C > 32 * kLnPer ||
      (!kv && Tk != Tq) || rope != (sin_q != nullptr) ||
      rope != (cos_k != nullptr) || rope != (sin_k != nullptr) ||
      ((rope || bf16) && (C / nh) % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    return launch_long<T>(
        static_cast<const T*>(x), static_cast<const T*>(pos),
        static_cast<const T*>(kv), ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo,
        bias, cos_q, sin_q, cos_k, sin_k, static_cast<T*>(qs),
        static_cast<T*>(ks), static_cast<T*>(vs), static_cast<T*>(att),
        static_cast<T*>(out), B, Tq, Tk, C, nh, scale, st);
  }
  return launch_long<float>(
      static_cast<const float*>(x), static_cast<const float*>(pos),
      static_cast<const float*>(kv), ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo,
      bo, bias, cos_q, sin_q, cos_k, sin_k, static_cast<float*>(qs),
      static_cast<float*>(ks), static_cast<float*>(vs),
      static_cast<float*>(att), static_cast<float*>(out), B, Tq, Tk, C, nh,
      scale, st);
}
