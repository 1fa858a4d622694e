"""Perceptual similarity metrics: LPIPS, DISTS, FID (counterpart of
`gsasr_tpu/metrics_perceptual.py`).

Equivalents of the reference metric wrappers
(`basicsr/metrics/lpips.py:11-63`, `basicsr/metrics/dists.py:35-56`,
`basicsr/metrics/fid.py:10-88`). The pretrained weights of the `lpips`,
`DISTS_pytorch` and Inception packages are not in the repository, so the
networks are written here as `nn.Module`s on NCHW tensors (cuDNN
convolutions on the card), and the official checkpoints load through
`load_lpips` and `load_dists` when a user supplies them.

LPIPS (richzhang/PerceptualSimilarity): scaling layer -> AlexNet / VGG16
features at 5 taps -> channel-unit-normalize -> squared difference ->
learned 1x1 "lin" heads -> spatial mean -> sum over taps.

DISTS (dingkeyan93/DISTS): VGG16 trunk with L2 (Hann-windowed) pooling;
per-stage mean and covariance statistics weighted by learned alpha and
beta into structure + texture similarity.

A metric is a number that users compare across papers and against the
CPU, so the protocol wrappers (`calculate_lpips`, `calculate_dists`) and
the FID feature function of `cli/metrics.py` run in float32 with TF32 off
for the duration of the call (`fp32_math`), and restore the caller's
settings after it. The modules themselves run under whatever settings the
caller has.

The port's layouts: each backbone is torchvision's `features` Sequential
(`net.features.{idx}`, idx the torchvision index), the LPIPS heads
`lins.{k}.weight`, DISTS's `alpha` and `beta` flat as in the JAX package.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gsasr_torch import resolve_device

# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------

LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)

# torchvision AlexNet `features` layout; taps after each ReLU.
_ALEX_CFG = [
    # (out_ch, kernel, stride, padding)
    (64, 11, 4, 2), "relu", "pool",
    (192, 5, 1, 2), "relu", "pool",
    (384, 3, 1, 1), "relu",
    (256, 3, 1, 1), "relu",
    (256, 3, 1, 1), "relu", "pool",
]
ALEX_CHNS = (64, 192, 384, 256, 256)

# VGG16 taps: relu1_2, relu2_2, relu3_3, relu4_3, relu5_3.
_VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512]
VGG16_CHNS = (64, 128, 256, 512, 512)
_VGG16_TAPS = (3, 8, 15, 22, 29)  # feature indices of the tap ReLUs


@contextlib.contextmanager
def fp32_math():
    """TF32 off in cuDNN's convolutions and cuBLAS's products inside the
    block; the caller's settings are restored after it."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def _vgg16_layers(pool):
    """torchvision VGG16.features up to relu5_3 (index 29), `pool(ch)` at
    each "M"."""
    layers, ch = [], 3
    for item in _VGG16_CFG:
        if item == "M":
            layers.append(pool(ch))
        else:
            layers += [nn.Conv2d(ch, item, 3, padding=1), nn.ReLU()]
            ch = item
    return layers


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet.features with taps after each ReLU (the 5
    LPIPS slices), up to the last ReLU (index 11): the last pooling feeds
    no tap, and is left out as the lpips package leaves it out."""

    def __init__(self):
        super().__init__()
        layers, ch = [], 3
        for item in _ALEX_CFG[:-1]:
            if item == "relu":
                layers.append(nn.ReLU())
            elif item == "pool":
                layers.append(nn.MaxPool2d(3, 2))
            else:
                out, k, s, p = item
                layers.append(nn.Conv2d(ch, out, k, stride=s, padding=p))
                ch = out
        self.features = nn.Sequential(*layers)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        taps = []
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                taps.append(x)
        return tuple(taps)


class VGG16Features(nn.Module):
    """torchvision VGG16.features with the LPIPS taps."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            *_vgg16_layers(lambda ch: nn.MaxPool2d(2, 2)))

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in _VGG16_TAPS:
                taps.append(x)
        return tuple(taps)


def _normalize_tensor(x, eps=1e-10):
    """Unit-normalize along channels (lpips.normalize_tensor)."""
    norm = torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True))
    return x / (norm + eps)


class LPIPS(nn.Module):
    """LPIPS distance. Inputs (B, 3, H, W) RGB; `normalize=True` treats
    them as [0, 1] (else [-1, 1], the package's native range). Returns
    (B,)."""

    def __init__(self, net: str = "alex"):
        super().__init__()
        self.net = AlexNetFeatures() if net == "alex" else VGG16Features()
        chns = ALEX_CHNS if net == "alex" else VGG16_CHNS
        self.lins = nn.ModuleList(nn.Conv2d(ch, 1, 1, bias=False)
                                  for ch in chns)
        self.register_buffer("shift", torch.tensor(LPIPS_SHIFT).view(
            1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(LPIPS_SCALE).view(
            1, 3, 1, 1), persistent=False)

    def forward(self, x, y, normalize: bool = True):
        if normalize:
            x = 2.0 * x - 1.0
            y = 2.0 * y - 1.0
        fx = self.net((x - self.shift) / self.scale)
        fy = self.net((y - self.shift) / self.scale)
        total = 0.0
        for k, lin in enumerate(self.lins):
            d = (_normalize_tensor(fx[k]) - _normalize_tensor(fy[k])) ** 2
            total = total + lin(d).mean(dim=(1, 2, 3))
        return total


def convert_lpips(sd) -> Dict[str, torch.Tensor]:
    """An official `lpips` state_dict (`net.slice{s}.{idx}.*` from the
    backbone, `lins.{k}.model.1.weight` or `lin{k}.model.1.weight` heads)
    or the port's -> the port's layout. The scaling layer's buffers are
    dropped (constants here)."""
    out = {}
    for key, val in sd.items():
        m = re.fullmatch(r"net\.(?:slice\d+|features)\.(\d+)\.(weight|bias)",
                         key)
        h = re.fullmatch(r"lins?\.?(\d+)(?:\.model\.1)?\.weight", key)
        if m:
            out[f"net.features.{m[1]}.{m[2]}"] = torch.as_tensor(val)
        elif h:
            out[f"lins.{h[1]}.weight"] = torch.as_tensor(val)
    return out


def load_lpips(sd, net: str = "alex", device=None) -> LPIPS:
    """An LPIPS module in eval mode on `device` (default: the CUDA card)
    holding `sd` (`convert_lpips`' layouts); every weight must be given."""
    with torch.random.fork_rng(devices=[]):  # the init is overwritten
        model = LPIPS(net)
    model.load_state_dict(convert_lpips(sd))
    return model.requires_grad_(False).eval().to(resolve_device(device))


# ---------------------------------------------------------------------------
# DISTS
# ---------------------------------------------------------------------------

DISTS_CHNS = (3, 64, 128, 256, 512, 512)
_DISTS_MEAN = (0.485, 0.456, 0.406)
_DISTS_STD = (0.229, 0.224, 0.225)


class L2Pool(nn.Module):
    """DISTS L2pooling: the square root of the Hann-windowed average of x^2
    per channel. hanning(5)[1:-1] => 3x3 window, padding 1, stride 2."""

    def __init__(self, channels: int, filter_size: int = 5, stride: int = 2):
        super().__init__()
        a = np.hanning(filter_size)[1:-1]
        g = np.outer(a, a)
        g = torch.from_numpy((g / g.sum()).astype(np.float32))
        self.stride = stride
        self.padding = (filter_size - 2) // 2
        self.register_buffer("window", g.expand(channels, 1, *g.shape)
                             .contiguous(), persistent=False)

    def forward(self, x):
        out = F.conv2d(x * x, self.window, stride=self.stride,
                       padding=self.padding, groups=x.shape[1])
        return torch.sqrt(out + 1e-12)


def l2_pool(x, channels: int, filter_size: int = 5, stride: int = 2):
    """`L2Pool` on (B, C, H, W) `x`."""
    return L2Pool(channels, filter_size, stride).to(x.device)(x)


class DISTSNet(nn.Module):
    """VGG16 trunk with L2 pooling; returns the 6 DISTS feature stages
    (input + 5 relu taps)."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(*_vgg16_layers(L2Pool))
        self.register_buffer("mean", torch.tensor(_DISTS_MEAN).view(
            1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(_DISTS_STD).view(
            1, 3, 1, 1), persistent=False)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        h = (x - self.mean) / self.std
        feats = [x]
        for i, layer in enumerate(self.features):
            h = layer(h)
            if i in _VGG16_TAPS:
                feats.append(h)
        return tuple(feats)


class DISTS(nn.Module):
    """DISTS score (lower = more similar); inputs (B, 3, H, W) RGB in
    [0, 1]. Returns (B,)."""

    def __init__(self):
        super().__init__()
        self.net = DISTSNet()
        total = sum(DISTS_CHNS)
        self.alpha = nn.Parameter(torch.randn(total) * 0.01)
        self.beta = nn.Parameter(torch.randn(total) * 0.01)

    def forward(self, x, y):
        fx = self.net(x)
        fy = self.net(y)
        w_sum = self.alpha.sum() + self.beta.sum()
        alphas = torch.split(self.alpha / w_sum, DISTS_CHNS)
        betas = torch.split(self.beta / w_sum, DISTS_CHNS)
        c1 = c2 = 1e-6
        dist1 = 0.0
        dist2 = 0.0
        for k in range(len(DISTS_CHNS)):
            xm = fx[k].mean(dim=(2, 3))          # (B, C)
            ym = fy[k].mean(dim=(2, 3))
            s1 = (2 * xm * ym + c1) / (xm ** 2 + ym ** 2 + c1)
            dist1 = dist1 + torch.sum(alphas[k] * s1, dim=-1)
            xv = ((fx[k] - xm[:, :, None, None]) ** 2).mean(dim=(2, 3))
            yv = ((fy[k] - ym[:, :, None, None]) ** 2).mean(dim=(2, 3))
            xy_cov = (fx[k] * fy[k]).mean(dim=(2, 3)) - xm * ym
            s2 = (2 * xy_cov + c2) / (xv + yv + c2)
            dist2 = dist2 + torch.sum(betas[k] * s2, dim=-1)
        return 1.0 - (dist1 + dist2)


def convert_dists(sd) -> Dict[str, torch.Tensor]:
    """The official DISTS `weights.pt` (alpha and beta, shaped (1, C, 1,
    1)) merged with the VGG16 backbone, as the DISTS package stores it
    (`stage{i}.{idx}`, torchvision feature indices) or as torchvision does
    (`features.{idx}`), or the port's -> the port's layout. The pooling
    filters and the normalisation buffers are dropped (constants here)."""
    out = {}
    for key, val in sd.items():
        m = re.fullmatch(
            r"(?:stage\d+|features|net\.features)\.(\d+)\.(weight|bias)", key)
        if m:
            out[f"net.features.{m[1]}.{m[2]}"] = torch.as_tensor(val)
        elif key in ("alpha", "beta"):
            out[key] = torch.as_tensor(val).reshape(-1)
    return out


def load_dists(sd, device=None) -> DISTS:
    """A DISTS module in eval mode on `device` (default: the CUDA card)
    holding `sd` (`convert_dists`' layouts); every weight must be given."""
    with torch.random.fork_rng(devices=[]):  # the init is overwritten
        model = DISTS()
    model.load_state_dict(convert_dists(sd))
    return model.requires_grad_(False).eval().to(resolve_device(device))


# ---------------------------------------------------------------------------
# Metric protocol wrappers (reference basicsr/metrics signatures)
# ---------------------------------------------------------------------------


def _model_input(img, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        img.transpose(2, 0, 1)[None], np.float32)).to(device)


def calculate_lpips(img, img2, crop_border, params, net: str = "alex",
                    input_order: str = "HWC", **kwargs) -> float:
    """`basicsr/metrics/lpips.py:11-63` protocol: BGR uint8-range images,
    crop border, [0,1] -> [-1,1], LPIPS, in float32 with TF32 off, on the
    device of `params`: the `LPIPS` module holding the weights
    (`load_lpips`; JAX's converted params), whose backbone `net` names."""
    model = params
    if isinstance(model.net, AlexNetFeatures) != (net == "alex"):
        raise ValueError(f"calculate_lpips: net={net!r}, but the model's "
                         f"backbone is {type(model.net).__name__}")
    if input_order == "CHW":
        img = img.transpose(1, 2, 0)
        img2 = img2.transpose(1, 2, 0)
    img = img.astype(np.float64) / 255.0
    img2 = img2.astype(np.float64) / 255.0
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    # BGR -> RGB (reference img2tensor(bgr2rgb=True))
    dev = model.lins[0].weight.device
    with torch.no_grad(), fp32_math():
        val = model(_model_input(img[..., ::-1], dev),
                    _model_input(img2[..., ::-1], dev), normalize=True)
    return float(val[0])


def calculate_dists(img, img2, crop_border, params,
                    color_order: str = "BGR", **kwargs) -> float:
    """`basicsr/metrics/dists.py:35-56` protocol (note the reference calls
    model(img2, img), i.e. GT first), in float32 with TF32 off, on the
    device of `params`: the `DISTS` module holding the weights
    (`load_dists`; JAX's converted params)."""
    model = params
    if color_order == "BGR":
        img = img[..., ::-1]
        img2 = img2[..., ::-1]
    img = img.astype(np.float64) / 255.0
    img2 = img2.astype(np.float64) / 255.0
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    dev = model.alpha.device
    with torch.no_grad(), fp32_math():
        val = model(_model_input(img2, dev), _model_input(img, dev))
    return float(val[0])


# ---------------------------------------------------------------------------
# FID (host numpy and scipy, as in the JAX package)
# ---------------------------------------------------------------------------


def compute_feature_stats(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mu, sigma) sample statistics."""
    feats = np.asarray(feats, dtype=np.float64)
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def calculate_fid(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussians
    (`basicsr/metrics/fid.py:50-88`):
    d^2 = ||mu1 - mu2||^2 + Tr(C1 + C2 - 2 sqrt(C1 C2))."""
    from scipy import linalg
    assert mu1.shape == mu2.shape
    assert sigma1.shape == sigma2.shape
    # (the JAX package's `disp=False` is gone from newer SciPy; the root is
    # the same)
    cov_sqrt = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(cov_sqrt).all():
        offset = np.eye(sigma1.shape[0]) * eps
        cov_sqrt = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(cov_sqrt):
        if not np.allclose(np.diagonal(cov_sqrt).imag, 0, atol=1e-3):
            m = np.max(np.abs(cov_sqrt.imag))
            raise ValueError(f"Imaginary component {m}")
        cov_sqrt = cov_sqrt.real
    mean_diff = mu1 - mu2
    mean_norm = mean_diff @ mean_diff
    trace = np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(cov_sqrt)
    return float(mean_norm + trace)


def extract_features(images: Sequence[np.ndarray], feature_fn) -> np.ndarray:
    """Run a feature extractor over a sequence of (H, W, 3) images and
    stack (N, D) features; `feature_fn` is e.g. an InceptionV3-FID network
    (`cli/metrics.py::_inception_feature_fn`)."""
    out = [np.asarray(feature_fn(img)).reshape(-1) for img in images]
    return np.stack(out)
