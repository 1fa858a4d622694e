"""Shared model building blocks (counterpart of `gsasr_tpu/models/common.py`)."""

from __future__ import annotations

import torch
from torch import nn


def pixel_shuffle(x, factor: int):
    """NHWC pixel shuffle in torch.nn.PixelShuffle channel order: channel
    c_out * r^2 + i * r + j lands at spatial offset (i, j)."""
    b, h, w, c = x.shape
    r = factor
    x = x.reshape(b, h, w, c // (r * r), r, r)
    return x.permute(0, 1, 4, 2, 5, 3).reshape(b, h * r, w * r, c // (r * r))


class MLP(nn.Module):
    """fc1 -> act -> fc2 (reference `utils/fea2gs.py:102-113`; SwinIR's Mlp
    with act=F.gelu)."""

    def __init__(self, in_dim: int, hidden: int, out: int, act=torch.relu):
        super().__init__()
        self.act = act
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


def LayerNorm(dim: int) -> nn.LayerNorm:
    """LayerNorm with the reference's eps of 1e-5."""
    return nn.LayerNorm(dim, eps=1e-5)


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
