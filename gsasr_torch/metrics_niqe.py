"""NIQE (Natural Image Quality Evaluator), a no-reference metric: a copy of
`gsasr_tpu/metrics_niqe.py` (host-only numpy code, kept in the port).

Equivalent of `TrainTestGSASR/basicsr/metrics/niqe.py`: MSCN coefficients
via local gaussian normalization, AGGD fits of the coefficient map and four
pairwise-product maps per 96x96 block at two scales, then the Mahalanobis-
style distance to pristine MVG statistics.

The pristine parameters (mu/cov over 36 AGGD features + the 7x7 gaussian
window) are fitted constants shipped by BasicSR as `niqe_pris_params.npz`
(`TrainTestGSASR/basicsr/metrics/niqe_pris_params.npz`); a copy of that
constant table is bundled at `gsasr_torch/assets/niqe_pris_params.npz` so
the metric is self-contained. GSASR_NIQE_PARAMS overrides the path.
"""

from __future__ import annotations

import math
import os

import numpy as np

_PARAMS_PATHS = [
    os.environ.get("GSASR_NIQE_PARAMS", ""),
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                 "niqe_pris_params.npz"),
]

_GAM = np.arange(0.2, 10.001, 0.001)
_GAM_RECIP = 1.0 / _GAM
_R_GAM = (np.exp(2 * np.array([math.lgamma(2 * g) for g in _GAM_RECIP]))
          / (np.exp(np.array([math.lgamma(g) for g in _GAM_RECIP]))
             * np.exp(np.array([math.lgamma(3 * g) for g in _GAM_RECIP]))))


def _load_params():
    for p in _PARAMS_PATHS:
        if p and os.path.exists(p):
            d = np.load(p)
            return (d["mu_pris_param"], d["cov_pris_param"],
                    d["gaussian_window"])
    raise FileNotFoundError(
        "niqe_pris_params.npz not found; set GSASR_NIQE_PARAMS")


def _aggd_fit(block):
    """Fit an asymmetric generalized gaussian: (alpha, beta_l, beta_r)."""
    block = block.flatten()
    neg = block[block < 0]
    pos = block[block > 0]
    left_std = np.sqrt(np.mean(neg ** 2)) if neg.size else 0.0
    right_std = np.sqrt(np.mean(pos ** 2)) if pos.size else 0.0
    gammahat = left_std / right_std if right_std > 0 else np.inf
    m2 = np.mean(block ** 2)
    rhat = (np.mean(np.abs(block)) ** 2) / m2 if m2 > 0 else 0.0
    rhatnorm = (rhat * (gammahat ** 3 + 1) * (gammahat + 1)) / (
        (gammahat ** 2 + 1) ** 2)
    alpha = _GAM[np.argmin((_R_GAM - rhatnorm) ** 2)]
    ratio = math.sqrt(math.gamma(1 / alpha) / math.gamma(3 / alpha))
    return alpha, left_std * ratio, right_std * ratio


def _block_features(mscn):
    alpha, bl, br = _aggd_fit(mscn)
    feats = [alpha, (bl + br) / 2]
    for shift in ((0, 1), (1, 0), (1, 1), (1, -1)):
        shifted = np.roll(mscn, shift, axis=(0, 1))
        alpha, bl, br = _aggd_fit(mscn * shifted)
        mean = (br - bl) * (math.gamma(2 / alpha) / math.gamma(1 / alpha))
        feats.extend([alpha, mean, bl, br])
    return feats


def _mscn(img, window):
    from scipy.ndimage import convolve

    mu = convolve(img, window, mode="nearest")
    sigma = np.sqrt(np.abs(convolve(img ** 2, window, mode="nearest")
                           - mu ** 2))
    return (img - mu) / (sigma + 1.0)


def calculate_niqe(img, crop_border: int = 0, convert_to: str = "y",
                   channel_order: str = "bgr", **kwargs) -> float:
    """NIQE on a [0, 255] HWC (or HW) image; lower is better."""
    from gsasr_torch.data.matlab_resize import imresize
    from gsasr_torch.metrics import to_y_channel

    mu_pris, cov_pris, window = _load_params()
    window = window / window.sum()

    img = np.asarray(img, np.float64)
    if img.ndim == 3 and img.shape[2] == 3 and convert_to == "y":
        img = to_y_channel(img, channel_order)[..., 0]
    elif img.ndim == 3:
        img = img[..., 0]
    if crop_border:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    img = np.round(img.astype(np.float64))

    block = 96
    h, w = img.shape
    nbh, nbw = h // block, w // block
    img = img[: nbh * block, : nbw * block]

    feats_all = []
    for scale in (1, 2):
        mscn = _mscn(img, window)
        bs = block // scale
        feats_scale = [
            _block_features(mscn[by * bs:(by + 1) * bs,
                                 bx * bs:(bx + 1) * bs])
            for by in range(nbh) for bx in range(nbw)
        ]
        feats_all.append(np.asarray(feats_scale))
        if scale == 1:
            img = imresize(img[..., None] / 255.0, 0.5)[..., 0] * 255.0

    feats = np.concatenate(feats_all, axis=1)
    mu_dist = np.nanmean(feats, axis=0)
    dist_cov = np.cov(feats, rowvar=False)
    cov = (cov_pris + dist_cov) / 2
    diff = (mu_pris - mu_dist).reshape(1, -1)
    quality = diff @ np.linalg.pinv(cov) @ diff.T
    return float(np.sqrt(quality[0, 0]))
