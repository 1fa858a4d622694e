#!/usr/bin/env python3
"""Which PNG scanline filters cv2.imwrite writes, and how fast the port's
read_png reads such files beside cv2.imread, on the host's CPU.

  python3 scripts/png_filter_census.py [--hw 480] [--reads 20]

Three seeded RGB images of --hw x --hw (uniform noise; chip_smoke.py's
_natural_image, a random walk down and across each channel; a smooth
gradient) go through cv2.imwrite at its default level and at
IMWRITE_PNG_COMPRESSION 3, the level at which BasicSR's extract_subimages
writes DIV2K's 480x480 training sub-images. For each file it prints the
rows under None/Sub/Up/Average/Paeth, the file's size, and the median of
--reads reads by read_png (zlib, then the C++ unfilter of
gsasr_torch/native/png.cpp) and by cv2.imread. Needs cv2, which the card's
machine lacks.
"""

import argparse
import os
import sys
import tempfile
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _median_ms(fn, n):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def main():
    import cv2

    from chip_smoke import _natural_image, _png_filter_counts
    from gsasr_torch.utils.png import _chunks, read_png

    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", type=int, default=480)
    ap.add_argument("--reads", type=int, default=20)
    a = ap.parse_args()
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:a.hw, 0:a.hw]
    images = {
        "noise": rng.integers(0, 256, (a.hw, a.hw, 3), dtype=np.uint8),
        "walk": _natural_image(rng, a.hw),
        "smooth": np.stack([xx * 255 // (a.hw - 1), yy * 255 // (a.hw - 1),
                            (xx + yy) * 255 // (2 * a.hw - 2)],
                           -1).astype(np.uint8),
    }
    print(f"cv2 {cv2.__version__}; {a.hw}x{a.hw} RGB; rows under "
          "None/Sub/Up/Average/Paeth; median of "
          f"{a.reads} reads")
    with tempfile.TemporaryDirectory() as tmp:
        for name, img in images.items():
            for level in (None, 3):
                path = os.path.join(tmp, f"{name}_{level}.png")
                cv2.imwrite(path, img, [] if level is None else
                            [cv2.IMWRITE_PNG_COMPRESSION, level])
                assert np.array_equal(read_png(path), img[:, :, ::-1])
                data = open(path, "rb").read()
                idat = b"".join(b for k, b in _chunks(data, path)
                                if k == b"IDAT")
                print(f"{name:6s} level {str(level or 'default'):7s} rows "
                      f"{_png_filter_counts(path).tolist()}, "
                      f"{len(data)} bytes; read_png "
                      f"{_median_ms(lambda: read_png(path), a.reads):.2f} "
                      "ms (zlib "
                      f"{_median_ms(lambda: zlib.decompress(idat), a.reads):.2f}"
                      "), cv2.imread "
                      f"{_median_ms(lambda: cv2.imread(path), a.reads):.2f} ms",
                      flush=True)


if __name__ == "__main__":
    main()
