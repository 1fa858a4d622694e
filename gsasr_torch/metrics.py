"""Evaluation metrics (PSNR / SSIM; NIQE, LPIPS and DISTS through
`calculate_metric`) matching the reference protocol (a copy
of `gsasr_tpu/metrics.py`, host-only numpy code).

Mirrors `TrainTestGSASR/basicsr/metrics/psnr_ssim.py` and the eval protocol
from the reference README (`README.md:349-355`): metrics on the Y channel of
YCbCr, `crop_border = scale` if scale <= 8 else 8.

Conventions (identical to BasicSR):
- images are uint8-range [0, 255] HWC numpy arrays in **BGR** channel order
  (the reference reads with cv2 and `to_y_channel` applies bgr2ycbcr,
  `metric_util.py:32-45`); pass `channel_order='rgb'` for RGB inputs;
- Y = dot(img/255, [65.481, 128.553, 24.966]_rgb) + 16, scaled back to
  [0, 255] float (ITU-R BT.601, `color_util.py:5-35`);
- SSIM uses an 11x11 Gaussian window (sigma 1.5), valid-mode convolution,
  C1=(0.01*255)^2, C2=(0.03*255)^2, averaged over channels.
"""

from __future__ import annotations

import math

import numpy as np


def _gaussian_kernel_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    # Matches cv2.getGaussianKernel: exp(-(i-(n-1)/2)^2 / (2 sigma^2)), L1
    # normalized.
    xs = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def rgb2y(img01: np.ndarray) -> np.ndarray:
    """RGB [0,1] -> Y [16,235]-ish (BT.601), float64."""
    return img01 @ np.array([65.481, 128.553, 24.966]) + 16.0


def to_y_channel(img255: np.ndarray, channel_order: str = "bgr") -> np.ndarray:
    """[0,255] HWC -> Y channel [0,255] float (metric_util.py:32-45)."""
    img = img255.astype(np.float64) / 255.0
    if img.ndim == 3 and img.shape[2] == 3:
        if channel_order == "bgr":
            img = img[..., ::-1]
        img = rgb2y(img) / 255.0
        img = img[..., None]
    return img * 255.0


def _prep(img, img2, crop_border, test_y_channel, channel_order):
    assert img.shape == img2.shape, f"shape mismatch {img.shape} {img2.shape}"
    img = np.asarray(img, np.float64)
    img2 = np.asarray(img2, np.float64)
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img = to_y_channel(img, channel_order)
        img2 = to_y_channel(img2, channel_order)
    return img, img2


def calculate_psnr(img, img2, crop_border, test_y_channel=False,
                   channel_order="bgr", **kwargs) -> float:
    """PSNR on [0,255] HWC images (`psnr_ssim.py:12-49`)."""
    img, img2 = _prep(img, img2, crop_border, test_y_channel, channel_order)
    mse = np.mean((img - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 10.0 * math.log10(255.0 * 255.0 / mse)


def _ssim_single(img: np.ndarray, img2: np.ndarray) -> float:
    """SSIM for one channel, [0,255] (`psnr_ssim.py:171-199`)."""
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    k = _gaussian_kernel_1d(11, 1.5)

    def sep_valid(x):
        # valid-mode separable convolution; kernel is symmetric so
        # correlation == convolution.
        out = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="valid"), 0, x)
        out = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="valid"), 1, out)
        return out

    mu1 = sep_valid(img)
    mu2 = sep_valid(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = sep_valid(img ** 2) - mu1_sq
    sigma2_sq = sep_valid(img2 ** 2) - mu2_sq
    sigma12 = sep_valid(img * img2) - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return float(ssim_map.mean())


def calculate_ssim(img, img2, crop_border, test_y_channel=False,
                   channel_order="bgr", **kwargs) -> float:
    """SSIM on [0,255] HWC images (`psnr_ssim.py:86-128`)."""
    img, img2 = _prep(img, img2, crop_border, test_y_channel, channel_order)
    if img.ndim == 2:
        img, img2 = img[..., None], img2[..., None]
    ssims = [
        _ssim_single(img[..., i], img2[..., i]) for i in range(img.shape[2])
    ]
    return float(np.mean(ssims))


def crop_border_for_scale(scale: float) -> int:
    """Reference protocol: crop = scale if scale <= 8 else 8
    (`README.md:349-355`), integer scales rounded."""
    s = int(round(scale))
    return s if s <= 8 else 8


def calculate_metric(data: dict, opt: dict) -> float:
    """Registry-style dispatcher (`basicsr/metrics/__init__.py:13-23`):
    ``opt`` carries a ``type`` key naming the metric function, the rest are
    its kwargs; ``data`` holds the images. NIQE/LPIPS/DISTS resolve lazily
    (they need bundled params / loaded weights)."""
    opt = dict(opt)
    metric_type = opt.pop("type")
    if metric_type == "calculate_psnr":
        return calculate_psnr(**data, **opt)
    if metric_type == "calculate_ssim":
        return calculate_ssim(**data, **opt)
    if metric_type == "calculate_niqe":
        from gsasr_torch.metrics_niqe import calculate_niqe
        return calculate_niqe(**data, **opt)
    if metric_type in ("calculate_lpips", "calculate_dists"):
        from gsasr_torch import metrics_perceptual as mp
        return getattr(mp, metric_type)(**data, **opt)
    raise ValueError(f"unknown metric type {metric_type!r}")
