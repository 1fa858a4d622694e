"""Shared model building blocks (counterpart of `gsasr_tpu/models/common.py`).

Linear, Conv2d and LayerNorm take a compute `dtype` with flax's `dtype=`
semantics, not `torch.autocast`'s: parameters stay float32 (Adam and the
EMA run on them), and each call casts at use. In float32 (the default)
they are nn.Linear, nn.Conv2d and nn.LayerNorm themselves, the same bits,
after casting a narrower input up (flax promotes it). In bfloat16 a Linear
or Conv2d casts its input, weight and bias to bfloat16, rounds the product
to bfloat16 and adds the bias in bfloat16 (flax's dot_general or
conv_general_dilated, then `y += bias`); a LayerNorm takes its statistics
and normalises in float32 with the float32 scale and bias and rounds the
result once. Their `state_dict` keys are those of the torch modules.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_F32 = torch.float32


def linear(x, weight, bias, dtype=_F32):
    """`nn.Dense(dtype=dtype)` on (out, in) weights."""
    x = x.to(dtype)
    if dtype == _F32:
        return F.linear(x, weight, bias)
    y = F.linear(x, weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


def conv2d(x, conv, dtype=_F32):
    """`nn.Conv(dtype=dtype)` with `conv`'s weights on NCHW x."""
    x = x.to(dtype)
    if dtype == _F32:
        return F.conv2d(x, conv.weight, conv.bias, conv.stride, conv.padding)
    y = F.conv2d(x, conv.weight.to(dtype), None, conv.stride, conv.padding)
    return y + conv.bias.to(dtype)[:, None, None]


class Linear(nn.Linear):
    """nn.Linear computing in `dtype` (see the module docstring)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype=_F32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x):
        return linear(x, self.weight, self.bias, self.compute_dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d (NCHW, stride 1) computing in `dtype`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int = 0, dtype=_F32):
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=padding)
        self.compute_dtype = dtype

    def forward(self, x):
        return conv2d(x, self, self.compute_dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with the reference's eps of 1e-5, its result in `dtype`."""

    def __init__(self, dim: int, dtype=_F32):
        super().__init__(dim, eps=1e-5)
        self.compute_dtype = dtype

    def forward(self, x):
        if x.dtype == _F32 and self.compute_dtype == _F32:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


def seq_apply(seq, x, dtype=_F32):
    """An nn.Sequential of Linears, Conv2ds and activations applied in
    `dtype`, whatever dtype its layers were built with."""
    for layer in seq:
        if isinstance(layer, nn.Linear):
            x = linear(x, layer.weight, layer.bias, dtype)
        elif isinstance(layer, nn.Conv2d):
            x = conv2d(x, layer, dtype)
        else:
            x = layer(x)
    return x


def pixel_shuffle(x, factor: int):
    """NHWC pixel shuffle in torch.nn.PixelShuffle channel order: channel
    c_out * r^2 + i * r + j lands at spatial offset (i, j)."""
    b, h, w, c = x.shape
    r = factor
    x = x.reshape(b, h, w, c // (r * r), r, r)
    return x.permute(0, 1, 4, 2, 5, 3).reshape(b, h * r, w * r, c // (r * r))


class MLP(nn.Module):
    """fc1 -> act -> fc2 (reference `utils/fea2gs.py:102-113`; SwinIR's Mlp
    with act=F.gelu), in `dtype`."""

    def __init__(self, in_dim: int, hidden: int, out: int, act=torch.relu,
                 dtype=_F32):
        super().__init__()
        self.act = act
        self.fc1 = Linear(in_dim, hidden, dtype)
        self.fc2 = Linear(hidden, out, dtype)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class DropPath(nn.Module):
    """Stochastic depth (reference `utils/swinir.py:96-122`): in training
    mode each sample's residual branch is dropped with probability `rate`
    and the survivors are scaled by 1/keep; the identity in eval mode or at
    rate 0. The keep mask is drawn from the generator passed to forward
    (on the input's device), which training mode at a rate above 0 needs."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator=None):
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("DropPath in training mode draws its keep mask "
                             "from an explicit generator; none was given")
        keep = 1.0 - self.rate
        mask = torch.empty((x.shape[0],) + (1,) * (x.dim() - 1),
                           device=x.device).bernoulli_(keep,
                                                       generator=generator)
        return torch.where(mask.bool(), x / keep, 0.0)
