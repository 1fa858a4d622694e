// Kernel A: fused pre-norm multi-head attention with its out-projection.
//
// Replaces _k_ln_attn of gsasr_tpu/ops/fused_layers.py (ln_attn_proj) in
// its paper form (no RoPE):
//
//   xq  = LN(x) (+ pos)                       LN statistics in f32
//   src = kv (cross-attention, un-normed) | xq (self-attention)
//   att_h = softmax(q_h k_h^T * scale + bias[h]) v_h,
//           q = xq Wq^T + bq, k = src Wk^T + bk, v = src Wv^T + bv
//   out = att Wo^T + bo
//
// What bounds it on an H100: the products, 2 * windows * (4 T C^2 + 2 T^2 C)
// FP32 operations (11.8 GFLOP at 225 windows x 144 tokens x 180 channels)
// against 67 TFLOP/s; the exps (28 M) and the bytes (3 row tensors, 70 MB)
// take far less.
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
// by atomics. Phase 2, the out-projection, is the 64-row FP32 tile product
// of tile_gemm.cuh over the attention rows, plus the bias.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>

#include "tile_gemm.cuh"

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
// for t < T, n < hd. The head's weight rows are staged in ws first.
__device__ void project_head(const float* xs, int ldx, int T,
                             const float* __restrict__ W,
                             const float* __restrict__ b, int n0, int hd,
                             int C, float* ws, int ldw, float* dst, int ldq) {
  const int tid = threadIdx.x;
  __syncthreads();
  for (int e = tid; e < hd * C; e += kThreads) {
    const int n = e / C;
    const int c = e - n * C;
    ws[n * ldw + c] = W[static_cast<size_t>(n0 + n) * C + c];
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

__global__ void __launch_bounds__(kThreads)
attn_heads_kernel(const float* __restrict__ x, const float* __restrict__ pos,
                  const float* __restrict__ kv, const float* __restrict__ ln_w,
                  const float* __restrict__ ln_b, const float* __restrict__ wq,
                  const float* __restrict__ bq, const float* __restrict__ wk,
                  const float* __restrict__ bk, const float* __restrict__ wv,
                  const float* __restrict__ bv, const float* __restrict__ bias,
                  float* __restrict__ att, int Tq, int Tk, int C, int nh,
                  float scale) {
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
        xs[r * L.ldx + c] = pos ? v[q] + pos[static_cast<size_t>(r) * C + c] : v[q];
    }
  }
  project_head(xs, L.ldx, Tq, wq, bq, n0, hd, C, ws, L.ldw, qs, L.ldq);

  if (kv) {
    __syncthreads();
    for (int e = threadIdx.x; e < Tk * C; e += kThreads) {
      const int r = e / C;
      const int c = e - r * C;
      xs[r * L.ldx + c] = kv[static_cast<size_t>(win) * Tk * C + e];
    }
  }
  project_head(xs, L.ldx, Tk, wk, bk, n0, hd, C, ws, L.ldw, ks, L.ldq);
  project_head(xs, L.ldx, Tk, wv, bv, n0, hd, C, ws, L.ldw, vs, L.ldq);
  __syncthreads();

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
        if (j < Tk) prow[r * Tk + j] = s[r][m] / sum;
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
          att[(static_cast<size_t>(win) * Tq + i0 + r) * C + n0 + lane] = o[r];
      }
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
out_proj_kernel(const float* __restrict__ att, const float* __restrict__ wo,
                const float* __restrict__ bo, float* __restrict__ out, int M,
                int C) {
  extern __shared__ float smem[];
  float* as = smem;
  float* ws = as + kBM * C;
  const int row0 = blockIdx.x * kBM;
  for (int e = threadIdx.x; e < kBM * C; e += kThreads) {
    const int g = row0 + e / C;
    as[e] = g < M ? att[static_cast<size_t>(row0) * C + e] : 0.f;
  }
  float acc[kRowsPer][kMaxColsPer];
  gemm_rows(as, C, wo, C, C, ws, acc);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kMaxColsPer; ++j) {
    const int n = lane + 32 * j;
    if (n >= C) continue;
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int g = row0 + warp + kWarps * i;
      if (g < M) out[static_cast<size_t>(g) * C + n] = acc[i][j] + bo[n];
    }
  }
}

}  // namespace

// x, out, att (B, Tq, C); kv (B, Tk, C) or null (self-attention, Tk == Tq);
// pos (Tq, C) or null; bias (nh, Tq, Tk) or null; weights (C, C) row-major
// as nn.Linear stores them; att is scratch the caller allocates.
extern "C" int ln_attn(const float* x, const float* pos, const float* kv,
                       const float* ln_w, const float* ln_b, const float* wq,
                       const float* bq, const float* wk, const float* bk,
                       const float* wv, const float* bv, const float* wo,
                       const float* bo, const float* bias, float* att,
                       float* out, int B, int Tq, int Tk, int C, int nh,
                       float scale, void* stream) {
  if (B < 1 || nh < 1 || C % nh != 0 || C / nh > kMaxHd || C > kMaxN ||
      C > 32 * kLnPer || Tq > kMaxT || Tk > kMaxT || (!kv && Tk != Tq))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Phase1Layout L(std::max(Tq, Tk), C, C / nh);
  cudaError_t err = cudaFuncSetAttribute(
      attn_heads_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.bytes()));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_heads_kernel<<<dim3(nh, B), kThreads, L.bytes(), st>>>(
      x, pos, kv, ln_w, ln_b, wq, bq, wk, bk, wv, bv, bias, att, Tq, Tk, C, nh,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem2 = sizeof(float) * (kBM * C + kWsFloats);
  err = cudaFuncSetAttribute(out_proj_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = B * Tq;
  out_proj_kernel<<<(M + kBM - 1) / kBM, kThreads, smem2, st>>>(att, wo, bo,
                                                                 out, M, C);
  return static_cast<int>(cudaGetLastError());
}
