// The row-tile product of the decoder-layer forward kernels on Hopper's
// tensor cores: kernel M's two products (ln_mlp.cu) and A's and A-long's
// projections (ln_attn.cu). A block of kTThreads (sixteen warps) holds
// kTRows = 128 rows of an activation in shared memory and multiplies them
// by an nn.Linear weight W (N, K), f32 in device memory, N, K <= kMaxN
// (192):
//
//   acc[row, n] = sum_k rows[row, k] W[n, k]          (f32 sums)
//
// Two arithmetics, one tiling:
//   - fp32 (TileF32): 3xTF32 on mma.sync m16n8k8, each f32 operand x taken
//     as big = tf32(x), small = tf32(x - big) (tf32_frag.cuh's split), and
//     a b summed as small_a big_b + big_a small_b + big_a big_b. It never
//     reads torch.backends.cuda.matmul.allow_tf32: one tf32 product per
//     step (1xTF32) lands at 7e-5 to 5e-4 of max|ref| in the CPU emulation
//     (tests/test_torch_fused_tf32.py), outside the fp32 kernels' 1e-4.
//   - bf16 (TileBf16): mma.sync m16n8k16 on bf16 rows and the weight rounded
//     to bf16: each product is exact in f32, so only the order of the f32
//     sums differs from the plain version's.
//
// Tiling. Warp w owns rows 16 (w % 8) .. + 15 and columns 96 (w / 8) .. +
// 95 (12 n-tiles of 8; tiles at or past N are skipped), so its accumulator
// tile is 48 f32 registers a thread in mma's layout: acc[j] holds rows g
// and g + 8 (g = lane / 4) and columns 8 j + 2 t, + 1 (t = lane % 4) of the
// warp's; a column pair (2 i, 2 i + 1), a RoPE pair, lies in one thread.
// The weight goes through shared memory in slabs of kTK = 16 columns of k,
// all kMaxN rows of n: a ring of P::kStages raw f32 slabs filled by
// cp.async (16-byte copies where K % 4 == 0), kStages - 1 slabs ahead of
// the one in use, each thread converting its own words (no barrier) into
// one of two slab buffers, rounded to bf16 or split into its tf32 pair once
// per block and not at every use; one __syncthreads a slab. Rows of W at or
// past N and columns at or past K are zeros, so nothing stale enters a
// sum; the rows' columns from K up to the next multiple of 16 must be
// zeros (or finite) in the caller's buffer.
//
// Layouts (bank-conflict-free fragment loads). fp32: the rows at a stride
// of 208 floats (16 banks apart), the slab's big and small halves as (n,
// 16) words each. A lane reads four consecutive k (a float4) of a row for
// two k-steps, so each k-step's contraction is permuted as in
// tf32_frag.cuh: slot t of k-step s takes column 4 t + 2 s of the slab,
// slot t + 4 column 4 t + 2 s + 1, for the rows and the weight alike. bf16:
// the rows at 200 bf16 (400 bytes) and the slab's rows at 24 bf16 (48
// bytes), so each ldmatrix's eight row addresses fall in eight bank groups;
// one ldmatrix.x4 gives a warp the A fragment of a k-step and another the B
// fragments of two n-tiles. The results go through shared memory (staged,
// 200 floats a row) to one coalesced pass of four columns a thread that
// adds the bias and the base and stores; the LayerNorm rows are formed
// four at a time a warp, their loads in flight together.
//
// Measured on an H100 (scripts/ab_torch_sources.py --fused-only; PERF.md,
// Findings): the first form of this body, 64-row blocks of eight warps,
// two an SM, the weight staged through registers one slab ahead and the
// results stored from the accumulators, was slower in turns; clock64
// probes put the fp32 products at about ten cycles an m16n8k8 a
// sub-partition, mma.sync's rate, and found the rest in the LayerNorm's
// and the epilogue's serialized loads, which the batched loads and the
// staged pass removed. At mma.sync's rate the fp32 forms stay several
// times their 3xTF32 bound at 495 TFLOP/s.
//
// Every sum runs in one fixed order (slab by slab, k-step by k-step, the
// three 3xTF32 terms small-first), so two launches give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "mma_ptx.cuh"
#include "tf32_frag.cuh"
#include "tile_gemm.cuh"

namespace gsasr {

constexpr int kTRows = 128;                    // rows a block owns
constexpr int kTThreads = 512;                 // sixteen warps
constexpr int kTWarps = kTThreads / 32;
constexpr int kTK = 16;                        // depth of one weight slab
constexpr int kTWarpCols = 96;                 // columns a warp owns
constexpr int kTNT = kTWarpCols / 8;           // its n-tiles
constexpr int kTRaw = kMaxN * kTK;             // f32 words of a raw slab
constexpr int kTPre = kTRaw / kTThreads;       // words a thread fetches
static_assert(kTWarps == 2 * kTRows / 16 && kMaxN == 2 * kTWarpCols,
              "sixteen warps: 8 row groups of 16 x 2 column halves of 96");

// The 3xTF32 form: rows f32, the slab as its tf32 pair (big, then small).
struct TileF32 {
  using Row = float;
  static constexpr int kLd = kMaxN + 16;            // 208 floats a row
  static constexpr int kSlabWords = 2 * kTRaw;      // big, small
  static constexpr int kStages = 4;                 // raw slabs in flight
};

// The bf16 form: rows and the slab bf16.
struct TileBf16 {
  using Row = __nv_bfloat16;
  static constexpr int kLd = kMaxN + 8;          // 200 bf16
  static constexpr int kLdW = kTK + 8;           // 24 bf16 a slab row
  static constexpr int kSlabWords = kMaxN * kLdW / 2;
  static constexpr int kStages = 8;
};

template <typename Act>
struct TileOf {
  using type = TileF32;
};
template <>
struct TileOf<__nv_bfloat16> {
  using type = TileBf16;
};

// Bytes of shared memory a tile kernel takes: the rows, then tile_mma's
// ring of raw slabs and its two slabs.
template <class P>
__host__ __device__ constexpr size_t tile_rows_bytes() {
  return sizeof(typename P::Row) * kTRows * P::kLd;
}
template <class P>
constexpr size_t tile_smem_bytes() {
  return tile_rows_bytes<P>() + sizeof(float) * P::kStages * kTRaw +
         sizeof(uint32_t) * 2 * P::kSlabWords;
}

// Sets a tile kernel's dynamic shared memory and asks for the largest
// shared-memory carveout, so that two blocks share an SM.
template <typename Kernel>
inline cudaError_t tile_prepare(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

__device__ __forceinline__ void tile_put(float* rows, int i, float v) {
  rows[i] = v;
}
__device__ __forceinline__ void tile_put(__nv_bfloat16* rows, int i,
                                         float v) {
  rows[i] = __float2bfloat16_rn(v);
}

// Four consecutive values widened to f32, and stored from f32 (rounded to
// bf16 for a bf16 pointer): 16 bytes of float or 8 of bfloat16.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  uint2 w;
  w.x = pack_bf16(v.x, v.y);
  w.y = pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = w;
}

// Whether every pointer given (null or not) lies on 16 bytes: the kernels'
// vector paths (4 columns a thread) take C % 4 == 0 and this.
inline bool tile_aligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// Rows [row0, row0 + kTRows) of the row-major (M, C) src (the activation
// type) into the row buffer, widened; rows past M and columns C .. kMaxN - 1
// zeros. vec: four columns a load (C % 4 == 0, src on 16 bytes).
template <class P, typename Act>
__device__ __forceinline__ void tile_load_rows(typename P::Row* rows,
                                               const Act* __restrict__ src,
                                               int row0, int M, int C,
                                               bool vec) {
  if (vec) {
    constexpr int kQ = kMaxN / 4;
#pragma unroll 4
    for (int e = threadIdx.x; e < kTRows * kQ; e += kTThreads) {
      const int r = e / kQ;
      const int c = 4 * (e - r * kQ);
      const int g = row0 + r;
      const float4 v = g < M && c < C
                           ? ld4(src + static_cast<size_t>(g) * C + c)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      typename P::Row* d = rows + r * P::kLd + c;
      tile_put(d, 0, v.x);
      tile_put(d, 1, v.y);
      tile_put(d, 2, v.z);
      tile_put(d, 3, v.w);
    }
    return;
  }
  for (int e = threadIdx.x; e < kTRows * kMaxN; e += kTThreads) {
    const int r = e / kMaxN;
    const int c = e - r * kMaxN;
    const int g = row0 + r;
    tile_put(rows, r * P::kLd + c,
             g < M && c < C ? to_f32(src[static_cast<size_t>(g) * C + c])
                            : 0.f);
  }
}

// LN?(x + inj) (+ pos), rounded to Act, of rows [row0, row0 + kTRows) into
// the row buffer: row g takes inj[g / T] and pos[g % T], each optional;
// without ln_w the rows are x + inj as they are. The statistics in f32 as
// load_row_ln forms them (two-pass; lane l holds columns l + 32 q): one
// warp a row, four rows at a time, so that their loads are in flight
// together. Rows past M and columns past C are zeros.
template <class P, typename Act>
__device__ __forceinline__ void tile_ln_rows(
    typename P::Row* rows, const Act* __restrict__ x,
    const float* __restrict__ inj, const Act* __restrict__ pos,
    const float* __restrict__ ln_w, const float* __restrict__ ln_b, int row0,
    int M, int T, int C) {
  constexpr int kB = 4;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float lw[kLnPer], lb[kLnPer];
#pragma unroll
  for (int q = 0; q < kLnPer; ++q) {
    const int c = lane + 32 * q;
    lw[q] = ln_w && c < C ? ln_w[c] : 0.f;
    lb[q] = ln_w && c < C ? ln_b[c] : 0.f;
  }
  for (int r0 = warp; r0 < kTRows; r0 += kB * kTWarps) {
    // the rows' loads first, each option's under one branch, so that they
    // are in flight together
    float v[kB][kLnPer];
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int g = row0 + r0 + kTWarps * i;
#pragma unroll
      for (int q = 0; q < kLnPer; ++q) {
        const int c = lane + 32 * q;
        v[i][q] = g < M && c < C ? to_f32(x[static_cast<size_t>(g) * C + c])
                                 : 0.f;
      }
    }
    if (inj) {
      float u[kB][kLnPer];
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        const int g = row0 + r0 + kTWarps * i;
        const float* ir = inj + static_cast<size_t>(g / T) * C;
#pragma unroll
        for (int q = 0; q < kLnPer; ++q) {
          const int c = lane + 32 * q;
          u[i][q] = g < M && c < C ? ir[c] : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kB; ++i)
#pragma unroll
        for (int q = 0; q < kLnPer; ++q) v[i][q] += u[i][q];
    }
    if (ln_w) {
      float m[kB], d[kB];
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        m[i] = 0.f;
#pragma unroll
        for (int q = 0; q < kLnPer; ++q)
          if (lane + 32 * q < C) m[i] += v[i][q];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < kB; ++i)
          m[i] += __shfl_xor_sync(0xffffffffu, m[i], o);
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        m[i] /= static_cast<float>(C);
        d[i] = 0.f;
#pragma unroll
        for (int q = 0; q < kLnPer; ++q) {
          if (lane + 32 * q < C) {
            const float e = v[i][q] - m[i];
            d[i] += e * e;
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < kB; ++i)
          d[i] += __shfl_xor_sync(0xffffffffu, d[i], o);
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        const float inv =
            1.0f / sqrtf(d[i] / static_cast<float>(C) + kLnEps);
#pragma unroll
        for (int q = 0; q < kLnPer; ++q)
          if (lane + 32 * q < C)
            v[i][q] = (v[i][q] - m[i]) * inv * lw[q] + lb[q];
      }
    }
    if (pos) {
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        const int g = row0 + r0 + kTWarps * i;
        const Act* pr = pos + static_cast<size_t>(g % T) * C;
#pragma unroll
        for (int q = 0; q < kLnPer; ++q) {
          const int c = lane + 32 * q;
          if (g < M && c < C) v[i][q] += to_f32(pr[c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      const int r = r0 + kTWarps * i;
      const int g = row0 + r;
#pragma unroll
      for (int q = 0; q < kLnPer; ++q) {
        const int c = lane + 32 * q;
        tile_put(rows, r * P::kLd + c,
                 g < M && c < C ? rnd<Act>(v[i][q]) : 0.f);
      }
    }
  }
}

// This thread's words of slab s of W (N, K) into its own words of a raw
// slab (kMaxN x kTK f32, row n at n kTK), by cp.async, which the caller
// commits; zeros outside W. With vec (K a multiple of 4, W on 16 bytes)
// thread i owns the 16-byte chunks q = i + kTThreads j, else the words e
// = i + kTThreads j. Only this thread reads them back (tile_store), so no
// barrier guards the raw slabs.
__device__ __forceinline__ void tile_fetch(float* raw,
                                           const float* __restrict__ W,
                                           int N, int K, int s, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < kTPre / 4 + 1; ++i) {
      const int q = threadIdx.x + kTThreads * i;
      if (q >= kTRaw / 4) break;
      const int n = q / (kTK / 4);
      const int k = kTK * s + 4 * (q % (kTK / 4));
      const bool ok = n < N && k < K;
      cp_async16(raw + 4 * q, W + (ok ? static_cast<size_t>(n) * K + k : 0),
                 ok ? 16 : 0);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kTPre; ++i) {
    const int e = threadIdx.x + kTThreads * i;
    const int n = e / kTK;
    const int k = kTK * s + (e & (kTK - 1));
    const bool ok = n < N && k < K;
    cp_async4(raw + e, W + (ok ? static_cast<size_t>(n) * K + k : 0),
              ok ? 4 : 0);
  }
}

// This thread's fetched words into a slab buffer (the same ownership as
// tile_fetch's): split into their tf32 pair, big words at n kTK + k and
// small ones kTRaw further, or rounded to bf16 at n kLdW + k.
__device__ __forceinline__ void tile_put4(TileF32, uint32_t* slab, int e,
                                          float4 v) {
  uint4 big, small;
  tf32_split(v.x, big.x, small.x);
  tf32_split(v.y, big.y, small.y);
  tf32_split(v.z, big.z, small.z);
  tf32_split(v.w, big.w, small.w);
  *reinterpret_cast<uint4*>(slab + e) = big;
  *reinterpret_cast<uint4*>(slab + kTRaw + e) = small;
}

__device__ __forceinline__ void tile_put4(TileBf16, uint32_t* slab, int e,
                                          float4 v) {
  uint2 w;
  w.x = pack_bf16(v.x, v.y);
  w.y = pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(slab) +
                            (e / kTK) * TileBf16::kLdW + (e & (kTK - 1))) = w;
}

__device__ __forceinline__ void tile_put1(TileF32, uint32_t* slab, int e,
                                          float v) {
  uint32_t big, small;
  tf32_split(v, big, small);
  slab[e] = big;
  slab[kTRaw + e] = small;
}

__device__ __forceinline__ void tile_put1(TileBf16, uint32_t* slab, int e,
                                          float v) {
  reinterpret_cast<__nv_bfloat16*>(slab)[(e / kTK) * TileBf16::kLdW +
                                         (e & (kTK - 1))] =
      __float2bfloat16_rn(v);
}

template <class P>
__device__ __forceinline__ void tile_store(uint32_t* slab, const float* raw,
                                           bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < kTPre / 4 + 1; ++i) {
      const int q = threadIdx.x + kTThreads * i;
      if (q >= kTRaw / 4) break;
      tile_put4(P{}, slab, 4 * q,
                *reinterpret_cast<const float4*>(raw + 4 * q));
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kTPre; ++i) {
    const int e = threadIdx.x + kTThreads * i;
    tile_put1(P{}, slab, e, raw[e]);
  }
}

// One slab's products into acc: columns k0 .. k0 + 15 of the rows, the
// warp's row group r0 and n-tiles j with c0 + 8 j < N.
__device__ __forceinline__ void tile_slab(TileF32, const float* rows,
                                          const uint32_t* slab, int k0,
                                          int r0, int c0, int N,
                                          float (&acc)[kTNT][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float4 x = *reinterpret_cast<const float4*>(
      rows + (r0 + g) * TileF32::kLd + k0 + 4 * t);
  const float4 y = *reinterpret_cast<const float4*>(
      rows + (r0 + g + 8) * TileF32::kLd + k0 + 4 * t);
  // k-step s: slot t is column 4 t + 2 s, slot t + 4 column 4 t + 2 s + 1
  uint32_t ab[2][4], as[2][4];
  tf32_split(x.x, ab[0][0], as[0][0]);
  tf32_split(y.x, ab[0][1], as[0][1]);
  tf32_split(x.y, ab[0][2], as[0][2]);
  tf32_split(y.y, ab[0][3], as[0][3]);
  tf32_split(x.z, ab[1][0], as[1][0]);
  tf32_split(y.z, ab[1][1], as[1][1]);
  tf32_split(x.w, ab[1][2], as[1][2]);
  tf32_split(y.w, ab[1][3], as[1][3]);
  const uint32_t* wb = slab + (c0 + g) * kTK + 4 * t;
#pragma unroll
  for (int j = 0; j < kTNT; ++j) {
    if (c0 + 8 * j >= N) continue;
    const uint4 bb = *reinterpret_cast<const uint4*>(wb + 8 * j * kTK);
    const uint4 bs =
        *reinterpret_cast<const uint4*>(wb + kMaxN * kTK + 8 * j * kTK);
    mma_tf32(acc[j], as[0], bb.x, bb.y);
    mma_tf32(acc[j], ab[0], bs.x, bs.y);
    mma_tf32(acc[j], ab[0], bb.x, bb.y);
    mma_tf32(acc[j], as[1], bb.z, bb.w);
    mma_tf32(acc[j], ab[1], bs.z, bs.w);
    mma_tf32(acc[j], ab[1], bb.z, bb.w);
  }
}

__device__ __forceinline__ void tile_slab(TileBf16,
                                          const __nv_bfloat16* rows,
                                          const uint32_t* slab, int k0,
                                          int r0, int c0, int N,
                                          float (&acc)[kTNT][4]) {
  const int lane = threadIdx.x & 31;
  uint32_t a[4];
  ldsm_x4(a, rows + (r0 + (lane & 15)) * TileBf16::kLd + k0 +
                 (lane >> 4) * 8);
  const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(slab);
  // matrices (tile j, k 0..7), (j, 8..15), (j + 1, 0..7), (j + 1, 8..15)
  const __nv_bfloat16* p = w + (c0 + 8 * (lane >> 4) + (lane & 7)) *
                                   TileBf16::kLdW +
                           ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int j = 0; j < kTNT; j += 2) {
    if (c0 + 8 * j >= N) continue;
    uint32_t b[4];
    ldsm_x4(b, p + 8 * j * TileBf16::kLdW);
    mma_bf16(acc[j], a, b[0], b[1]);
    if (c0 + 8 * j + 8 < N) mma_bf16(acc[j + 1], a, b[2], b[3]);
  }
}

// acc = rows W^T for the block's kTRows rows (the row buffer, written
// before the call) and W (N, K), f32 in device memory, through the ring of
// P::kStages raw slabs and the two slabs that follow the rows in `smem`:
// slab s + kStages - 1 is in flight (cp.async) while slab s is split or
// rounded into its slab buffer and multiplied. acc is zeroed first; its
// entries of columns >= N are zeros. Starts and ends with a barrier, so
// the rows may be written just before and rewritten just after.
template <class P>
__device__ __forceinline__ void tile_mma(const typename P::Row* rows,
                                         const float* __restrict__ W, int N,
                                         int K, unsigned char* smem,
                                         float (&acc)[kTNT][4]) {
  constexpr int kS = P::kStages;
  float* raw = reinterpret_cast<float*>(smem + tile_rows_bytes<P>());
  uint32_t* slabs = reinterpret_cast<uint32_t*>(raw + kS * kTRaw);
  const int warp = threadIdx.x >> 5;
  const int r0 = 16 * (warp & 7);
  const int c0 = kTWarpCols * (warp >> 3);
#pragma unroll
  for (int j = 0; j < kTNT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int ns = (K + kTK - 1) / kTK;
  const bool vec =
      (K & 3) == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0;
#pragma unroll
  for (int f = 0; f < kS - 1; ++f) {
    if (f < ns) tile_fetch(raw + f * kTRaw, W, N, K, f, vec);
    cp_async_commit();
  }
  for (int s = 0; s < ns; ++s) {
    // into the ring stage of slab s - 1, which this thread has stored
    const int f = s + kS - 1;
    if (f < ns) tile_fetch(raw + (f % kS) * kTRaw, W, N, K, f, vec);
    cp_async_commit();
    cp_async_wait<kS - 1>();  // slab s has landed
    uint32_t* slab = slabs + (s & 1) * P::kSlabWords;
    tile_store<P>(slab, raw + (s % kS) * kTRaw, vec);
    __syncthreads();
    tile_slab(P{}, rows, slab, kTK * s, r0, c0, N, acc);
  }
  __syncthreads();
}

// f(row, col, v0, v1) for each of this thread's accumulator pairs: rows
// row (of the block's kTRows) and columns col, col + 1 (col even, both
// below the warp's 96 columns' end; callers test col < N themselves).
template <class F>
__device__ __forceinline__ void tile_each(const float (&acc)[kTNT][4], F f) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (warp & 7) + (lane >> 2);
  const int c0 = kTWarpCols * (warp >> 3) + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < kTNT; ++j) {
    f(r0, c0 + 8 * j, acc[j][0], acc[j][1]);
    f(r0 + 8, c0 + 8 * j, acc[j][2], acc[j][3]);
  }
}

// The staged results: tile_stage_acc writes acc there (row r at r
// kTLdS), over the rows in fp32 and over the raw ring and slabs in bf16,
// all free once tile_mma has returned; the caller's barrier, then one
// coalesced pass of four columns a thread (or one) adds the bias and
// stores.
constexpr int kTLdS = kMaxN + 8;  // 200 floats: float2 stores conflict-free
static_assert(sizeof(float) * kTRows * kTLdS <= tile_rows_bytes<TileF32>() &&
                  sizeof(float) * kTRows * kTLdS <=
                      sizeof(float) * TileBf16::kStages * kTRaw +
                          sizeof(uint32_t) * 2 * TileBf16::kSlabWords,
              "the staged results fit where they are put");

template <class P>
__device__ __forceinline__ float* tile_stage(unsigned char* smem) {
  return reinterpret_cast<float*>(
      sizeof(typename P::Row) == 4 ? smem : smem + tile_rows_bytes<P>());
}

__device__ __forceinline__ void tile_stage_acc(const float (&acc)[kTNT][4],
                                               float* stage) {
  tile_each(acc, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<float2*>(stage + r * kTLdS + c) = make_float2(v0, v1);
  });
}

}  // namespace gsasr
