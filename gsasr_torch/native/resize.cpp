// Native MATLAB-faithful separable bicubic resize core.
//
// The training data pipeline calls imresize_new once per sample
// (`continuous_bicubic_downsample_dataset.py:72`); this C++ core keeps the
// host-side loader off the critical path on multi-core VMs (the reference
// relies on torch DataLoader's native workers for the same reason).
//
// Semantics are identical to gsasr_torch/data/matlab_resize.py (and therefore
// to `TrainTestGSASR/basicsr/utils/matlab_functions.py:184-268`): cubic
// a=-0.5 with antialias widening, u = x/scale + 0.5(1-1/scale), per-row
// weight normalization, boundary-tap trimming, symmetric padding.
//
// Build (gsasr_torch/native/__init__.py does it at first use):
//   g++ -O3 -march=native -shared -fPIC -o libgsasr_resize.so resize.cpp -lpthread
// ABI: resize_hwc(src, H, W, C, dst, outH, outW, scale_h, scale_w, antialias, nthreads)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline double cubic(double x) {
  double ax = std::fabs(x), ax2 = ax * ax, ax3 = ax2 * ax;
  if (ax <= 1.0) return 1.5 * ax3 - 2.5 * ax2 + 1.0;
  if (ax <= 2.0) return -0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0;
  return 0.0;
}

struct Taps {
  std::vector<float> weights;  // out_len * p
  std::vector<int> indices;    // out_len * p (0-based into padded axis)
  int p = 0;
  int sym_s = 0, sym_e = 0;
};

Taps make_taps(int in_len, int out_len, double scale, bool antialias) {
  double kw = 4.0;
  bool shrink = scale < 1.0 && antialias;
  if (shrink) kw /= scale;
  int p = static_cast<int>(std::ceil(kw)) + 2;

  std::vector<double> w(static_cast<size_t>(out_len) * p);
  std::vector<double> idx(static_cast<size_t>(out_len) * p);
  for (int i = 0; i < out_len; ++i) {
    double u = (i + 1) / scale + 0.5 * (1.0 - 1.0 / scale);
    double left = std::floor(u - kw / 2.0);
    double row_sum = 0.0;
    for (int t = 0; t < p; ++t) {
      double ind = left + t;  // 1-based
      double d = u - ind;
      double wv = shrink ? scale * cubic(d * scale) : cubic(d);
      w[(size_t)i * p + t] = wv;
      idx[(size_t)i * p + t] = ind;
      row_sum += wv;
    }
    for (int t = 0; t < p; ++t) w[(size_t)i * p + t] /= row_sum;
  }

  // trim first/last tap when any row has an exact zero there
  // (matlab_functions.py:72-78; the two reference branches reduce to one
  // trim — see gsasr_torch/data/matlab_resize.py)
  int zeros_first = 0, zeros_last = 0;
  for (int i = 0; i < out_len; ++i) {
    if (w[(size_t)i * p] == 0.0) ++zeros_first;
    if (w[(size_t)i * p + p - 1] == 0.0) ++zeros_last;
  }
  int t0 = 0, t1 = p;
  if (zeros_first != 0) { t0 = 1; t1 = p - 1; }
  else if (zeros_last != 0) { t0 = 0; t1 = p - 2; }
  int np = t1 - t0;

  double imin = 1e30, imax = -1e30;
  for (int i = 0; i < out_len; ++i)
    for (int t = t0; t < t1; ++t) {
      imin = std::min(imin, idx[(size_t)i * p + t]);
      imax = std::max(imax, idx[(size_t)i * p + t]);
    }
  Taps taps;
  taps.p = np;
  taps.sym_s = static_cast<int>(-imin + 1);
  taps.sym_e = static_cast<int>(imax - in_len);
  taps.weights.resize((size_t)out_len * np);
  taps.indices.resize((size_t)out_len * np);
  for (int i = 0; i < out_len; ++i)
    for (int t = 0; t < np; ++t) {
      taps.weights[(size_t)i * np + t] =
          static_cast<float>(w[(size_t)i * p + t0 + t]);
      taps.indices[(size_t)i * np + t] = static_cast<int>(
          idx[(size_t)i * p + t0 + t] + taps.sym_s - 1);
    }
  return taps;
}

// symmetric-pad index into [0, len): mirrors including the edge
inline int sym_index(int i, int pad, int len) {
  int j = i - pad;
  if (j < 0) j = -j - 1;
  if (j >= len) j = 2 * len - j - 1;
  return j;
}

void resize_axis0(const float* src, int H, int W, float* dst, int outH,
                  const Taps& taps, int nthreads) {
  // dst[o, x] = sum_t w[o,t] * src_sym[idx[o,t], x]; W includes channels.
  auto work = [&](int lo, int hi) {
    for (int o = lo; o < hi; ++o) {
      float* out_row = dst + (size_t)o * W;
      std::memset(out_row, 0, sizeof(float) * W);
      for (int t = 0; t < taps.p; ++t) {
        float wv = taps.weights[(size_t)o * taps.p + t];
        int src_row = sym_index(taps.indices[(size_t)o * taps.p + t],
                                taps.sym_s, H);
        const float* in_row = src + (size_t)src_row * W;
        for (int x = 0; x < W; ++x) out_row[x] += wv * in_row[x];
      }
    }
  };
  if (nthreads <= 1) { work(0, outH); return; }
  std::vector<std::thread> th;
  int per = (outH + nthreads - 1) / nthreads;
  for (int k = 0; k < nthreads; ++k) {
    int lo = k * per, hi = std::min(outH, lo + per);
    if (lo < hi) th.emplace_back(work, lo, hi);
  }
  for (auto& t : th) t.join();
}

void transpose_hwc(const float* src, int H, int W, int C, float* dst) {
  // (H, W, C) -> (W, H, C)
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x)
      std::memcpy(dst + ((size_t)x * H + y) * C, src + ((size_t)y * W + x) * C,
                  sizeof(float) * C);
}

}  // namespace

extern "C" int resize_hwc(const float* src, int H, int W, int C, float* dst,
                          int outH, int outW, double scale_h, double scale_w,
                          int antialias, int nthreads) {
  Taps th_taps = make_taps(H, outH, scale_h, antialias != 0);
  Taps tw_taps = make_taps(W, outW, scale_w, antialias != 0);

  std::vector<float> tmp1((size_t)outH * W * C);
  resize_axis0(src, H, W * C, tmp1.data(), outH, th_taps, nthreads);

  std::vector<float> tmp2((size_t)W * outH * C);
  transpose_hwc(tmp1.data(), outH, W, C, tmp2.data());

  std::vector<float> tmp3((size_t)outW * outH * C);
  resize_axis0(tmp2.data(), W, outH * C, tmp3.data(), outW, tw_taps,
               nthreads);

  transpose_hwc(tmp3.data(), outW, outH, C, dst);
  return 0;
}
