"""Native (C++) components of the host side, one library.

`resize.cpp` is the MATLAB-faithful bicubic resize core of the training
data loader (a copy of the JAX package's); `png.cpp` undoes the scanline
filters of the PNGs that `utils/png.py` reads. The library is built with
g++ at its first use into `build/gsasr_torch_native/` at the root of the
checkout, keyed by a hash of the sources, the flags and the host's CPU.
`load()` returns None where it cannot be built (`build_error()` says why):
the resize then takes its numpy path, and `png_unfilter` raises. A ctypes
call releases the GIL, so `batch_iterator`'s threads resize and decode in
parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

_SRCS = [Path(__file__).resolve().parent / f for f in ("resize.cpp",
                                                       "png.cpp")]
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "gsasr_torch_native"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
_lib = None
_tried = False
_error = None
_lock = threading.Lock()


def _cpu() -> str:
    """The host CPU's instruction sets, which -march=native compiles for
    (a library built on another host may not run here)."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("flags")),
                        "")
    except OSError:
        return platform.processor()


def library_path() -> Path:
    """Where the library of these sources, these flags and this host's
    CPU is built."""
    h = hashlib.sha256(b"".join(src.read_bytes() for src in _SRCS))
    h.update(" ".join(FLAGS).encode())
    h.update(platform.machine().encode() + _cpu().encode())
    return BUILD_DIR / f"libgsasr_host-{h.hexdigest()[:16]}.so"


def load():
    """The ctypes library with `resize_hwc` and `png_unfilter`, built
    first if need be; None when it cannot be built."""
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        try:
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["g++", *FLAGS, "-o", str(tmp),
                                *map(str, _SRCS), "-lpthread"], check=True,
                               capture_output=True, text=True)
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
            lib.resize_hwc.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int,
                ctypes.c_int]
            lib.resize_hwc.restype = ctypes.c_int
            lib.png_unfilter.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            lib.png_unfilter.restype = ctypes.c_int
            _lib = lib
        except OSError as e:
            _error = str(e)
        except subprocess.CalledProcessError as e:
            _error = f"g++ failed: {e.stderr.strip()}"
        return _lib


def build_error():
    """Why `load()` returned None (None while it has not failed)."""
    return _error


def resize_hwc_native(img, out_h: int, out_w: int, scale_h: float,
                      scale_w: float, antialias: bool = True,
                      nthreads: int = 4):
    """C++ bicubic resize of an (H, W) or (H, W, C) array; None if the
    native library is unavailable."""
    import numpy as np

    lib = load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.float32)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    h, w, c = img.shape
    out = np.empty((out_h, out_w, c), np.float32)
    rc = lib.resize_hwc(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w, c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out_h, out_w,
        scale_h, scale_w, int(antialias), nthreads)
    if rc != 0:
        return None
    return out[:, :, 0] if squeeze else out


def png_unfilter(raw: bytes, height: int, stride: int, bpp: int):
    """The scanlines of a PNG's decompressed image data (height rows of
    1 + stride bytes, each led by its filter type) with their filters
    undone: (height, stride) uint8. bpp is the bytes a pixel, 1 below 8
    bits a pixel. Raises ValueError on a filter type past 4, RuntimeError
    when the library cannot be built."""
    import numpy as np

    lib = load()
    if lib is None:
        raise RuntimeError("reading a PNG needs gsasr_torch's native "
                           f"library, which could not be built: {_error}")
    out = np.empty((height, stride), np.uint8)
    rc = lib.png_unfilter(raw, height, stride, bpp, out.ctypes.data)
    if rc:
        raise ValueError(f"unknown PNG filter type in row {rc - 1}")
    return out
