// Phase 1 of kernel A (ln_attn.cu), which kernel AB's recompute
// (ln_attn_bwd.cu) shares: the q, k and v projections of 128 rows of
// LN(x) (+ pos) or of kv on the tensor cores (tile_mma.cuh), with the
// bias, the RoPE rotation and the activation type's rounding.
#pragma once

#include <cuda_runtime.h>

#include "tile_mma.cuh"

namespace gsasr {

// A projection's output over the staged rows, four columns (two pairs) a
// thread: dst = rope?(acc + b) in f32 with no contraction, rounded to Act;
// with kBwd and raw given, acc + b before the rotation also to raw (f32).
template <bool kRope, typename Act, bool kBwd = false>
__device__ __forceinline__ void qkv4(const float* stage,
                                     const float* __restrict__ b,
                                     const float* __restrict__ ct,
                                     const float* __restrict__ st,
                                     Act* __restrict__ dst, int row0, int nr,
                                     int C, int T,
                                     float* __restrict__ raw = nullptr) {
  const int q4 = C / 4;
#pragma unroll 4
  for (int e = threadIdx.x; e < nr * q4; e += kTThreads) {
    const int r = e / q4;
    const int c = 4 * (e - r * q4);
    const int g = row0 + r;
    float4 v = ld4(stage + r * kTLdS + c);
    const float4 bb = ld4(b + c);
    v.x += bb.x;
    v.y += bb.y;
    v.z += bb.z;
    v.w += bb.w;
    if (kBwd && raw) st4(raw + static_cast<size_t>(g) * C + c, v);
    if (kRope) {
      const size_t to = static_cast<size_t>(g % T) * C + c;
      const float4 cs = ld4(ct + to);
      const float4 sn = ld4(st + to);
      v = make_float4(__fadd_rn(__fmul_rn(v.x, cs.x), __fmul_rn(-v.y, sn.x)),
                      __fadd_rn(__fmul_rn(v.y, cs.y), __fmul_rn(v.x, sn.y)),
                      __fadd_rn(__fmul_rn(v.z, cs.z), __fmul_rn(-v.w, sn.z)),
                      __fadd_rn(__fmul_rn(v.w, cs.w), __fmul_rn(v.z, sn.w)));
    }
    st4(dst + static_cast<size_t>(g) * C + c, v);
  }
}

// Phase 1: blockIdx.y 0 forms q from 128 rows of LN(x) (+ pos); 1 and 2
// form k and v from 128 rows of kv (cross-attention) or of LN(x) (+ pos)
// (self-attention). Each adds its bias, rotates q and k by the (T, C)
// tables at the row's token (in f32 with no contraction: each product and
// the sum rounded on its own, as x * cos + shuffle(x) * sin) and rounds
// to Act as it stores, four columns (two pairs) a thread when vec. With
// kBwd (kernel AB's recompute) the q blocks also store their LN rows to
// xq_out (Act), and q0_out and k0_out (f32, given with RoPE) take q and k
// before the rotation.
template <typename Act, bool kBwd = false>
__global__ void __launch_bounds__(kTThreads, 1)
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
              int Tk, int C, int vec, Act* __restrict__ xq_out = nullptr,
              float* __restrict__ q0_out = nullptr,
              float* __restrict__ k0_out = nullptr) {
  using P = typename TileOf<Act>::type;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  auto* rows = reinterpret_cast<typename P::Row*>(tile_smem);
  const int which = blockIdx.y;  // 0 q, 1 k, 2 v
  const int T = which ? Tk : Tq;
  const int M = B * T;
  const int row0 = blockIdx.x * kTRows;
  if (row0 >= M) return;  // the whole block: no barrier is skipped

  if (which == 0 || !kv)
    tile_ln_rows<P>(rows, x, nullptr, pos, ln_w, ln_b, row0, M, Tq, C);
  else
    tile_load_rows<P>(rows, kv, row0, M, C, vec);
  if (kBwd && which == 0) {
    __syncthreads();
    const int nr = M - row0 < kTRows ? M - row0 : kTRows;
    if (vec) {
      const int q4 = C / 4;
      for (int e = threadIdx.x; e < nr * q4; e += kTThreads) {
        const int r = e / q4;
        const int c = 4 * (e - r * q4);
        st4(xq_out + static_cast<size_t>(row0 + r) * C + c,
            ld4(rows + r * P::kLd + c));
      }
    } else {
      for (int e = threadIdx.x; e < nr * C; e += kTThreads) {
        const int r = e / C;
        const int c = e - r * C;
        xq_out[static_cast<size_t>(row0 + r) * C + c] =
            from_f32<Act>(to_f32(rows[r * P::kLd + c]));
      }
    }
  }
  const float* __restrict__ W = which == 0 ? wq : which == 1 ? wk : wv;
  const float* __restrict__ b = which == 0 ? bq : which == 1 ? bk : bv;
  const float* __restrict__ ct =
      which == 0 ? cos_q : which == 1 ? cos_k : nullptr;
  const float* __restrict__ st =
      which == 0 ? sin_q : which == 1 ? sin_k : nullptr;
  Act* __restrict__ dst = which == 0 ? qo : which == 1 ? ko : vo;
  float* __restrict__ raw =
      kBwd ? (which == 0 ? q0_out : which == 1 ? k0_out : nullptr) : nullptr;
  float acc[kTNT][4];
  tile_mma<P>(rows, W, C, C, tile_smem, acc);
  float* stage = tile_stage<P>(tile_smem);
  tile_stage_acc(acc, stage);
  __syncthreads();
  const int nr = M - row0 < kTRows ? M - row0 : kTRows;
  if (vec) {
    if (ct)
      qkv4<true, Act, kBwd>(stage, b, ct, st, dst, row0, nr, C, T, raw);
    else
      qkv4<false, Act, kBwd>(stage, b, ct, st, dst, row0, nr, C, T, raw);
    return;
  }
  for (int e = threadIdx.x; e < nr * C; e += kTThreads) {
    const int r = e / C;
    const int n = e - r * C;
    const int g = row0 + r;
    float v = stage[r * kTLdS + n] + b[n];
    if (kBwd && raw) raw[static_cast<size_t>(g) * C + n] = v;
    if (ct) {  // an even width: the partner n ^ 1 lies in the row
      const int p = n ^ 1;
      const float w = stage[r * kTLdS + p] + b[p];
      const size_t to = static_cast<size_t>(g % T) * C + n;
      v = __fadd_rn(__fmul_rn(v, ct[to]),
                    __fmul_rn((n & 1) ? w : -w, st[to]));
    }
    dst[static_cast<size_t>(g) * C + n] = from_f32<Act>(v);
  }
}

}  // namespace gsasr
