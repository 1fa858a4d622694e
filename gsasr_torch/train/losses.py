"""Training losses (counterpart of `gsasr_tpu/train/losses.py`): the
per-sample masked L1 over a slot canvas, its size mask and SSIM.

The reference computes the loss per sample on the crop to gt_size; the
canvas render is padded, and the mask makes the masked mean equal that
crop's L1.
"""

from __future__ import annotations

import torch


def masked_l1(pred, target, mask):
    """Per-sample masked-mean L1, averaged over the batch.

    pred/target: (B, H, W, C); mask: (B, H, W, 1) of {0, 1}. Per sample the
    mean runs over mask * C elements (the L1 over the gt_size crop)."""
    diff = (pred - target).abs() * mask
    c = pred.shape[-1]
    per = diff.sum(dim=(1, 2, 3)) / (mask.sum(dim=(1, 2, 3)) * c + 1e-12)
    return per.mean()


def size_mask(h_sizes, w_sizes, hmax: int, wmax: int):
    """(B,) effective sizes -> (B, hmax, wmax, 1) {0, 1} float masks."""
    dev = h_sizes.device
    rows = torch.arange(hmax, device=dev)[None, :, None]
    cols = torch.arange(wmax, device=dev)[None, None, :]
    m = (rows < h_sizes[:, None, None]) & (cols < w_sizes[:, None, None])
    return m[..., None].to(torch.float32)


def _ssim_window(size: int = 11, sigma: float = 1.5, device=None):
    xs = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2
    k = torch.exp(-(xs ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def _blur(x, k):
    """Separable valid Gaussian blur of (B, H, W, C) over H then W, as sums
    of shifted slices (full float32, no convolution library)."""
    n = k.shape[0]
    h, w = x.shape[1], x.shape[2]
    x = sum(x[:, i:i + h - n + 1] * k[i] for i in range(n))
    return sum(x[:, :, i:i + w - n + 1] * k[i] for i in range(n))


def ssim(pred, target, data_range: float = 1.0, size: int = 11,
         sigma: float = 1.5, reduce: bool = True):
    """Mean SSIM over a (B, H, W, C) batch with valid-mode Gaussian windows
    (pytorch_msssim.ssim with size_average=True). reduce=False returns the
    per-window map (B, H-size+1, W-size+1, C)."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    k = _ssim_window(size, sigma, pred.device)
    mu1, mu2 = _blur(pred, k), _blur(target, k)
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = _blur(pred * pred, k) - mu1_sq
    s2 = _blur(target * target, k) - mu2_sq
    s12 = _blur(pred * target, k) - mu12
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return ssim_map.mean() if reduce else ssim_map
