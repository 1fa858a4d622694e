"""VGG feature extractor and the perceptual loss (counterpart of
`gsasr_tpu/models/vgg.py`).

Equivalent of the reference `basicsr/archs/vgg_arch.py:10-161`
(`VGGFeatureExtractor`): a truncated VGG trunk on (B, 3, H, W) tensors
that returns a dict of intermediate activations named `conv{b}_{i}` /
`relu{b}_{i}` / `pool{b}`, with optional ImageNet input normalization and
[-1,1]->[0,1] range normalization; and of `basic_loss.py:148-254`
(`PerceptualLoss`). The trunk's layout is the reference's
(`vgg_net.{name}.weight`); convolutions run in cuDNN on the card, and the
gradient with respect to the input is plain autograd.

Pretrained torchvision weights are not in the repository; `load_vgg` loads
a `vgg19-*.pth` state_dict when a user supplies one.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

NAMES = {
    "vgg11": [
        "conv1_1", "relu1_1", "pool1", "conv2_1", "relu2_1", "pool2",
        "conv3_1", "relu3_1", "conv3_2", "relu3_2", "pool3", "conv4_1",
        "relu4_1", "conv4_2", "relu4_2", "pool4", "conv5_1", "relu5_1",
        "conv5_2", "relu5_2", "pool5"
    ],
    "vgg13": [
        "conv1_1", "relu1_1", "conv1_2", "relu1_2", "pool1", "conv2_1",
        "relu2_1", "conv2_2", "relu2_2", "pool2", "conv3_1", "relu3_1",
        "conv3_2", "relu3_2", "pool3", "conv4_1", "relu4_1", "conv4_2",
        "relu4_2", "pool4", "conv5_1", "relu5_1", "conv5_2", "relu5_2",
        "pool5"
    ],
    "vgg16": [
        "conv1_1", "relu1_1", "conv1_2", "relu1_2", "pool1", "conv2_1",
        "relu2_1", "conv2_2", "relu2_2", "pool2", "conv3_1", "relu3_1",
        "conv3_2", "relu3_2", "conv3_3", "relu3_3", "pool3", "conv4_1",
        "relu4_1", "conv4_2", "relu4_2", "conv4_3", "relu4_3", "pool4",
        "conv5_1", "relu5_1", "conv5_2", "relu5_2", "conv5_3", "relu5_3",
        "pool5"
    ],
    "vgg19": [
        "conv1_1", "relu1_1", "conv1_2", "relu1_2", "pool1", "conv2_1",
        "relu2_1", "conv2_2", "relu2_2", "pool2", "conv3_1", "relu3_1",
        "conv3_2", "relu3_2", "conv3_3", "relu3_3", "conv3_4", "relu3_4",
        "pool3", "conv4_1", "relu4_1", "conv4_2", "relu4_2", "conv4_3",
        "relu4_3", "conv4_4", "relu4_4", "pool4", "conv5_1", "relu5_1",
        "conv5_2", "relu5_2", "conv5_3", "relu5_3", "conv5_4", "relu5_4",
        "pool5"
    ],
}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _conv_features(name: str) -> int:
    """conv{b}_{i} -> output channels (64 * 2^(b-1), capped at 512)."""
    block = int(name[4])
    return min(64 * 2 ** (block - 1), 512)


class VGGFeatureExtractor(nn.Module):
    """(B, 3, H, W) in [0,1] -> {layer_name: (B, c, h, w)} features."""

    def __init__(self, layer_name_list: Sequence[str],
                 vgg_type: str = "vgg19", use_input_norm: bool = True,
                 range_norm: bool = False, remove_pooling: bool = False,
                 pooling_stride: int = 2):
        super().__init__()
        self.layer_name_list = tuple(layer_name_list)
        self.vgg_type = vgg_type
        self.use_input_norm = use_input_norm
        self.range_norm = range_norm
        names = NAMES[vgg_type]
        max_idx = max(names.index(v) for v in self.layer_name_list)
        layers, ch = OrderedDict(), 3
        for name in names[:max_idx + 1]:
            if name.startswith("conv"):
                layers[name] = nn.Conv2d(ch, _conv_features(name), 3,
                                         padding=1)
                ch = _conv_features(name)
            elif name.startswith("relu"):
                layers[name] = nn.ReLU()
            elif not remove_pooling:
                layers[name] = nn.MaxPool2d(2, stride=pooling_stride)
        self.vgg_net = nn.Sequential(layers)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(
            1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(
            1, 3, 1, 1), persistent=False)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        if self.range_norm:
            x = (x + 1.0) / 2.0
        if self.use_input_norm:
            x = (x - self.mean) / self.std
        out = {}
        for name, layer in self.vgg_net.named_children():
            x = layer(x)
            if name in self.layer_name_list:
                out[name] = x
        return out


def convert_vgg(sd, vgg_type: str = "vgg19") -> Dict[str, torch.Tensor]:
    """A torch VGG state_dict -> the port's layout (`vgg_net.{name}.*`).

    Accepts torchvision layout (`features.{idx}.weight`), a bare
    `{idx}.weight` Sequential, or the reference's extracted layout
    (`vgg_net.{name}.weight`, vgg_arch.py:112-124), which is the port's.
    """
    names = NAMES[vgg_type]
    out = {}
    for key, val in sd.items():
        m = re.fullmatch(r"(?:features\.)?(\d+)\.(weight|bias)", key)
        if m and int(m[1]) < len(names) and names[int(m[1])][:4] == "conv":
            out[f"vgg_net.{names[int(m[1])]}.{m[2]}"] = torch.as_tensor(val)
        elif re.fullmatch(r"vgg_net\.conv\d_\d\.(weight|bias)", key):
            out[key] = torch.as_tensor(val)
    return out


def load_vgg(extractor: VGGFeatureExtractor, sd) -> VGGFeatureExtractor:
    """Load `sd` (`convert_vgg`'s layouts) into `extractor`: the layers it
    has must all be given; the deeper ones of the file are left out."""
    own = extractor.state_dict()
    got = convert_vgg(sd, extractor.vgg_type)
    extractor.load_state_dict({k: got[k] for k in own if k in got})
    return extractor


def gram_matrix(feat: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, C) Gram matrix, matching the reference's
    normalization by c*h*w (basic_loss.py:241-254)."""
    b, c, h, w = feat.shape
    f = feat.reshape(b, c, h * w)
    return torch.bmm(f, f.transpose(1, 2)) / (c * h * w)


class PerceptualLoss(nn.Module):
    """Perceptual + style loss (`basic_loss.py:148-254`). The VGG trunk
    (`self.vgg`, loaded with `load_vgg`) is frozen, and the GT branch runs
    without a gradient."""

    def __init__(self, layer_weights: Dict[str, float],
                 vgg_type: str = "vgg19", use_input_norm: bool = True,
                 range_norm: bool = False, perceptual_weight: float = 1.0,
                 style_weight: float = 0.0, criterion: str = "l1"):
        super().__init__()
        if criterion not in ("l1", "l2", "fro"):
            raise NotImplementedError(f"{criterion} criterion not supported")
        self.layer_weights = dict(layer_weights)
        self.perceptual_weight = perceptual_weight
        self.style_weight = style_weight
        self.criterion = criterion
        self.vgg = VGGFeatureExtractor(
            layer_name_list=tuple(layer_weights.keys()), vgg_type=vgg_type,
            use_input_norm=use_input_norm,
            range_norm=range_norm).requires_grad_(False)

    def _dist(self, a, b):
        if self.criterion == "l1":
            return F.l1_loss(a, b)
        if self.criterion == "l2":
            return F.mse_loss(a, b)
        return torch.linalg.norm((a - b).reshape(-1))  # 'fro', full tensor

    def forward(self, x, gt):
        """x, gt: (B, 3, H, W). Returns (percep_loss, style_loss); entries
        are None when the corresponding weight is 0 (reference
        behavior)."""
        fx = self.vgg(x)
        with torch.no_grad():
            fg = self.vgg(gt.detach())

        percep = None
        if self.perceptual_weight > 0:
            percep = sum(self._dist(fx[k], fg[k]) * w
                         for k, w in self.layer_weights.items())
            percep = percep * self.perceptual_weight

        style = None
        if self.style_weight > 0:
            style = sum(
                self._dist(gram_matrix(fx[k]), gram_matrix(fg[k])) * w
                for k, w in self.layer_weights.items())
            style = style * self.style_weight
        return percep, style
