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
    """fc1 -> ReLU -> fc2 (reference `utils/fea2gs.py:102-113`)."""

    def __init__(self, in_dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def LayerNorm(dim: int) -> nn.LayerNorm:
    """LayerNorm with the reference's eps of 1e-5."""
    return nn.LayerNorm(dim, eps=1e-5)
