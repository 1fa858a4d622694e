"""MATLAB-faithful bicubic resize (vectorized numpy), a copy of
`gsasr_tpu/data/matlab_resize.py` (host-only code, kept in the port).

Numerically equivalent to the reference's
`TrainTestGSASR/basicsr/utils/matlab_functions.py:88-268` (`imresize`,
`imresize_new`), which itself reproduces MATLAB's `imresize`:

- cubic kernel a=-0.5 with antialias widening (kernel_width/scale) when
  downscaling;
- output-space to input-space mapping ``u = x/scale + 0.5*(1 - 1/scale)``;
- per-output-pixel weight rows normalized to 1, with first/last taps trimmed
  when any row has a zero weight there;
- symmetric (mirror-including-edge) boundary extension;
- `imresize` uses ceil(in*scale) output size; `imresize_new` uses
  round(in*scale) and allows distinct h/w scales (the realized training
  scale_modify depends on this rounding).

The reference computes in float32 loops; we compute the same weights in
float32 and contract with einsum — same math, vectorized.
"""

from __future__ import annotations

import math

import numpy as np


def _cubic(x):
    absx = np.abs(x)
    absx2 = absx * absx
    absx3 = absx2 * absx
    f1 = 1.5 * absx3 - 2.5 * absx2 + 1.0
    f2 = -0.5 * absx3 + 2.5 * absx2 - 4.0 * absx + 2.0
    return f1 * (absx <= 1) + f2 * ((absx > 1) & (absx <= 2))


def _weights_indices(in_length: int, out_length: int, scale: float,
                     antialiasing: bool):
    kernel_width = 4.0
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale

    x = np.arange(1, out_length + 1, dtype=np.float32)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = math.ceil(kernel_width) + 2

    indices = left[:, None] + np.arange(p, dtype=np.float32)[None, :]
    dist = u[:, None] - indices
    if scale < 1 and antialiasing:
        weights = scale * _cubic(dist * scale)
    else:
        weights = _cubic(dist)
    weights = weights / weights.sum(axis=1, keepdims=True)

    # Trim first/last tap when any output row has zero weight there
    # (matlab_functions.py:72-78).
    zeros_per_col = (weights == 0).sum(axis=0)
    if not math.isclose(float(zeros_per_col[0]), 0, rel_tol=1e-6):
        indices = indices[:, 1:p - 1]
        weights = weights[:, 1:p - 1]
    elif not math.isclose(float(zeros_per_col[-1]), 0, rel_tol=1e-6):
        indices = indices[:, 0:p - 2]
        weights = weights[:, 0:p - 2]

    sym_len_s = int(-indices.min() + 1)
    sym_len_e = int(indices.max() - in_length)
    indices = (indices + sym_len_s - 1).astype(np.int64)
    return weights.astype(np.float32), indices, sym_len_s, sym_len_e


def _resize_axis(img: np.ndarray, axis: int, weights, indices, sym_s, sym_e):
    """Apply one separable resize pass along `axis` of an (..., L, ...) f32
    array with symmetric padding."""
    img = np.moveaxis(img, axis, 0)
    pad_width = [(sym_s, sym_e)] + [(0, 0)] * (img.ndim - 1)
    aug = np.pad(img, pad_width, mode="symmetric")
    gathered = aug[indices]  # (out, taps, ...)
    out = np.einsum("ot,ot...->o...", weights, gathered)
    return np.moveaxis(out.astype(np.float32), 0, axis)


def _resize_hw(img: np.ndarray, out_h: int, out_w: int, scale_h: float,
               scale_w: float, antialiasing: bool) -> np.ndarray:
    """(H, W, C) or (H, W) float32 resize."""
    in_h, in_w = img.shape[:2]
    wh, ih, ss_h, se_h = _weights_indices(in_h, out_h, scale_h, antialiasing)
    ww, iw, ss_w, se_w = _weights_indices(in_w, out_w, scale_w, antialiasing)
    out = _resize_axis(img.astype(np.float32), 0, wh, ih, ss_h, se_h)
    out = _resize_axis(out, 1, ww, iw, ss_w, se_w)
    return out


def imresize(img: np.ndarray, scale: float, antialiasing: bool = True):
    """MATLAB imresize, output size = ceil(in * scale) (HWC or HW numpy)."""
    in_h, in_w = img.shape[:2]
    out_h, out_w = math.ceil(in_h * scale), math.ceil(in_w * scale)
    return _resize_hw(img, out_h, out_w, scale, scale, antialiasing)


def imresize_new(img: np.ndarray, scale_h: float, scale_w: float,
                 antialiasing: bool = True, use_native: bool = True):
    """Reference `imresize_new`: round() output sizes, per-axis scales.

    Uses the C++ core (gsasr_torch/native/resize.cpp) when available —
    identical math, multithreaded; falls back to the numpy path.
    """
    in_h, in_w = img.shape[:2]
    out_h, out_w = round(in_h * scale_h), round(in_w * scale_w)
    if use_native:
        from gsasr_torch.native import resize_hwc_native
        out = resize_hwc_native(img, out_h, out_w, scale_h, scale_w,
                                antialiasing)
        if out is not None:
            return out
    return _resize_hw(img, out_h, out_w, scale_h, scale_w, antialiasing)
