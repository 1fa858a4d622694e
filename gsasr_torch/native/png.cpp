// PNG scanline unfilter (PNG 1.2, section 6) for gsasr_torch/utils/png.py.
//
// Files on disk carry libpng's adaptive filtering: each scanline takes
// whichever of None, Sub, Up, Average and Paeth gives the smallest sum of
// absolute bytes (cv2.imwrite at IMWRITE_PNG_COMPRESSION 3, as BasicSR's
// extract_subimages writes the DIV2K sub-images, mostly Average and Paeth).
// Average and Paeth make each byte depend on its left neighbour's result, a
// serial loop along the row that numpy cannot vectorise, so it is done here.
// A ctypes call releases the GIL, so batch_iterator's threads decode in
// parallel.
//
// ABI: png_unfilter(raw, height, stride, bpp, out) undoes the filters of
// `raw` (height scanlines of 1 + stride bytes, each led by its filter type)
// into `out` (height x stride bytes); bpp is the bytes a pixel, 1 below 8
// bits a pixel. Returns 0, or 1 + the row whose filter type is not 0-4.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" int png_unfilter(const uint8_t* raw, int height, int stride,
                            int bpp, uint8_t* out) {
  const std::vector<uint8_t> zeros(stride, 0);  // the row above row 0
  for (int r = 0; r < height; ++r) {
    const uint8_t* f = raw + (size_t)r * (stride + 1) + 1;
    uint8_t* x = out + (size_t)r * stride;
    const uint8_t* up = r ? x - stride : zeros.data();
    const int n = bpp < stride ? bpp : stride;  // bytes with no left pixel
    switch (f[-1]) {
      case 0:
        std::memcpy(x, f, stride);
        break;
      case 1:
        std::memcpy(x, f, n);
        for (int i = n; i < stride; ++i) x[i] = f[i] + x[i - bpp];
        break;
      case 2:
        for (int i = 0; i < stride; ++i) x[i] = f[i] + up[i];
        break;
      case 3:
        for (int i = 0; i < n; ++i) x[i] = f[i] + (up[i] >> 1);
        for (int i = n; i < stride; ++i)
          x[i] = f[i] + ((x[i - bpp] + up[i]) >> 1);
        break;
      case 4:
        // with no left pixel a = c = 0, and Paeth predicts b
        for (int i = 0; i < n; ++i) x[i] = f[i] + up[i];
        for (int i = n; i < stride; ++i) {
          const int a = x[i - bpp], b = up[i], c = up[i - bpp];
          const int pa = std::abs(b - c), pb = std::abs(a - c),
                    pc = std::abs(a + b - 2 * c);
          x[i] = f[i] + (pa <= pb && pa <= pc ? a : pb <= pc ? b : c);
        }
        break;
      default:
        return 1 + r;
    }
  }
  return 0;
}
