// Kernel T: gradient of the relative-position bias gather.
//
// The window attentions read their bias as bias[h, p] = table[index[p], h]
// for the Tq Tk flat positions p of a (Tq, Tk) score tile. Its gradient is
// a scatter-add of g (nh, Tq Tk) into the table, which PyTorch's indexing
// backward takes with atomics on the card, so its bits change from run to
// run. Here one thread per (row, head) sums the entries of its row in
// ascending position p, from an inverse index that lists, for each table
// row, the positions that read it, padded with n = Tq Tk. The JAX package
// leaves this gather to XLA, which is deterministic on the TPU; there is no
// Pallas kernel behind it.
//
// What bounds it on an H100: the bytes, g (nh Tq Tk floats), the inverse
// index and the table (0.6 MB for 6 heads of 144 x 144), a fraction of a
// microsecond at 3.35 TB/s; the launch itself takes longer.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bias_table_bwd_kernel(const float* __restrict__ g, const int* __restrict__ inv,
                      float* __restrict__ dtable, int rows, int maxc, int nh,
                      int n) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= rows * nh) return;
  const int row = e / nh;
  const int h = e - row * nh;
  const int* list = inv + static_cast<size_t>(row) * maxc;
  const float* gh = g + static_cast<size_t>(h) * n;
  float acc = 0.f;
  for (int m = 0; m < maxc; ++m) {
    const int p = list[m];
    if (p >= n) break;
    acc += gh[p];
  }
  dtable[e] = acc;
}

}  // namespace

// g (nh, n) with n = Tq Tk; inv (rows, maxc) int32, each row's positions in
// ascending order padded with n; dtable (rows, nh).
extern "C" int bias_table_bwd(const float* g, const int* inv, float* dtable,
                              int rows, int maxc, int nh, int n,
                              void* stream) {
  if (rows < 1 || maxc < 1 || nh < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int total = rows * nh;
  bias_table_bwd_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      g, inv, dtable, rows, maxc, nh, n);
  return static_cast<int>(cudaGetLastError());
}
