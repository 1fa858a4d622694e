// Kernel M: fused [LayerNorm] -> fc1 -> ReLU -> fc2 -> residual.
//
// Replaces _k_ln_mlp of gsasr_tpu/ops/fused_layers.py (ln_mlp_residual):
//
//   t   = x + inj[window]                           (inj optional, per window)
//   out = (0 | resi | t) + fc2(relu(fc1(LN?(t))))   (LN statistics in f32)
//
// x, resi and out are float or bfloat16 (the Enhanced family's trunk); inj,
// the weights and biases float. In bfloat16 it rounds where _k_ln_mlp
// rounds: LN?(t), the weights as they are staged, the ReLU output and the
// result; t, the sums and the base stay f32. zero_base returns the bare
// MLP (the Enhanced block tails).
//
// What bounds it on an H100: in float32 the two products, 4 * rows * C *
// hid operations (4.2 GFLOP at 225 windows x 144 tokens x 180 channels),
// taken in 3xTF32: three TF32 products each, 12.6 GFLOP against 495
// TFLOP/s, 0.026 ms, beside 47-70 MB of row tensors (0.014-0.021 ms at
// 3.35 TB/s). In bfloat16 the products are 4.8 GFLOP at 192 channels (5
// us at 989 TFLOP/s) against 25-37 MB (7.5-11 us): bound by the bytes.
//
// Design. Rows are independent, so a block of sixteen warps owns 128 rows
// and keeps everything between its input and its output on chip:
// LN?(x + inj) once per row (f32, two-pass, four rows a warp at a time)
// into the row buffer, fc1 on the tensor cores (tile_mma.cuh: 3xTF32 in
// fp32, bf16 operands in bf16, the weight streamed through a ring of raw
// slabs and split or rounded once as it is staged), + b1, ReLU and the
// activation type's rounding written over the same row buffer, fc2
// likewise, then the results through shared memory to one coalesced pass
// that adds b2 and the base (0 | resi | x + inj) and stores. 200 KB of
// shared memory in fp32 and 164 KB in bf16: one block an SM.

#include <cuda_runtime.h>

#include "tile_mma.cuh"

namespace {

using namespace gsasr;

// M's output over the staged rows, four columns a thread: out = base + (z
// w2^T + b2) for base 0 (kMode 0), src (1: resi; 2: x) or src + inj[g /
// T] (3), one loop for each, so that several iterations' loads are in
// flight together.
template <int kMode, typename Act>
__device__ __forceinline__ void out4(const float* stage,
                                     const Act* __restrict__ src,
                                     const float* __restrict__ inj,
                                     const float* __restrict__ b2,
                                     Act* __restrict__ out, int row0, int nr,
                                     int C, int T) {
  const int q4 = C / 4;
#pragma unroll 4
  for (int e = threadIdx.x; e < nr * q4; e += kTThreads) {
    const int r = e / q4;
    const int c = 4 * (e - r * q4);
    const size_t o = static_cast<size_t>(row0 + r) * C + c;
    float4 base = make_float4(0.f, 0.f, 0.f, 0.f);
    if (kMode) base = ld4(src + o);
    if (kMode == 3) {
      const float4 ij = ld4(inj + static_cast<size_t>((row0 + r) / T) * C + c);
      base.x += ij.x;
      base.y += ij.y;
      base.z += ij.z;
      base.w += ij.w;
    }
    const float4 a = ld4(stage + r * kTLdS + c);
    const float4 bb = ld4(b2 + c);
    st4(out + o, make_float4(base.x + (a.x + bb.x), base.y + (a.y + bb.y),
                             base.z + (a.z + bb.z), base.w + (a.w + bb.w)));
  }
}

template <typename Act>
__global__ void __launch_bounds__(kTThreads, 1)
ln_mlp_kernel(const Act* __restrict__ x, const float* __restrict__ inj,
              const Act* __restrict__ resi, const float* __restrict__ ln_w,
              const float* __restrict__ ln_b, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ w2,
              const float* __restrict__ b2, Act* __restrict__ out, int M,
              int T, int C, int H, int zero_base, int vec) {
  using P = typename TileOf<Act>::type;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  __shared__ float b1s[kMaxN];
  auto* rows = reinterpret_cast<typename P::Row*>(tile_smem);
  const int row0 = blockIdx.x * kTRows;
  for (int n = threadIdx.x; n < kMaxN; n += kTThreads)
    b1s[n] = n < H ? b1[n] : 0.f;

  // h = LN?(x + inj), rounded to Act
  tile_ln_rows<P>(rows, x, inj, static_cast<const Act*>(nullptr), ln_w, ln_b,
                  row0, M, T, C);
  float acc[kTNT][4];
  tile_mma<P>(rows, w1, H, C, tile_smem, acc);
  // z = relu(h w1^T + b1), rounded to Act, over h; columns past H zeros
  tile_each(acc, [&](int r, int n, float v0, float v1) {
    tile_put(rows, r * P::kLd + n,
             n < H ? rnd<Act>(fmaxf(v0 + b1s[n], 0.f)) : 0.f);
    tile_put(rows, r * P::kLd + n + 1,
             n + 1 < H ? rnd<Act>(fmaxf(v1 + b1s[n + 1], 0.f)) : 0.f);
  });

  tile_mma<P>(rows, w2, C, H, tile_smem, acc);
  float* stage = tile_stage<P>(tile_smem);
  tile_stage_acc(acc, stage);
  __syncthreads();
  // out = base + (z w2^T + b2), base = 0 | resi | x + inj, four columns a
  // thread (or one), coalesced; each option's loop on its own, so that the
  // loads of several iterations are in flight together
  const int nr = M - row0 < kTRows ? M - row0 : kTRows;
  if (vec) {
    if (zero_base)
      out4<0>(stage, x, inj, b2, out, row0, nr, C, T);
    else if (resi)
      out4<1>(stage, resi, inj, b2, out, row0, nr, C, T);
    else if (inj)
      out4<3>(stage, x, inj, b2, out, row0, nr, C, T);
    else
      out4<2>(stage, x, inj, b2, out, row0, nr, C, T);
    return;
  }
  for (int e = threadIdx.x; e < nr * C; e += kTThreads) {
    const int r = e / C;
    const int c = e - r * C;
    const int g = row0 + r;
    const size_t o = static_cast<size_t>(g) * C + c;
    float base = 0.f;
    if (!zero_base) {
      if (resi) {
        base = to_f32(resi[o]);
      } else {
        base = to_f32(x[o]);
        if (inj) base += inj[static_cast<size_t>(g / T) * C + c];
      }
    }
    out[o] = from_f32<Act>(base + (stage[r * kTLdS + c] + b2[c]));
  }
}

template <typename Act>
int launch(const void* x, const float* inj, const void* resi,
           const float* ln_w, const float* ln_b, const float* w1,
           const float* b1, const float* w2, const float* b2, void* out, int M,
           int T, int C, int H, int zero_base, cudaStream_t stream) {
  constexpr size_t smem = tile_smem_bytes<typename TileOf<Act>::type>();
  const cudaError_t err = tile_prepare(ln_mlp_kernel<Act>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = C % 4 == 0 && tile_aligned({x, inj, resi, b2, out});
  const int blocks = (M + kTRows - 1) / kTRows;
  ln_mlp_kernel<Act><<<blocks, kTThreads, smem, stream>>>(
      static_cast<const Act*>(x), inj, static_cast<const Act*>(resi), ln_w,
      ln_b, w1, b1, w2, b2, static_cast<Act*>(out), M, T, C, H, zero_base,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, resi, out (M, C) with M = windows * T, float, or bfloat16 when bf16 is
// set; inj (windows, C) float; ln_w, ln_b, b2 (C); w1 (H, C); b1 (H); w2
// (C, H). inj, resi and ln_w/ln_b may be null; zero_base drops the base.
extern "C" int ln_mlp(const void* x, const float* inj, const void* resi,
                      const float* ln_w, const float* ln_b, const float* w1,
                      const float* b1, const float* w2, const float* b2,
                      void* out, int M, int T, int C, int H, int zero_base,
                      int bf16, void* stream) {
  if (C > kMaxN || H > kMaxN || C > 32 * kLnPer || M < 1 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, inj, resi, ln_w, ln_b, w1, b1, w2,
                                      b2, out, M, T, C, H, zero_base, st)
              : launch<float>(x, inj, resi, ln_w, ln_b, w1, b1, w2, b2, out,
                              M, T, C, H, zero_base, st);
}
