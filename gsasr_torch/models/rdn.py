"""RDN encoder without upsampler (counterpart of `gsasr_tpu/models/rdn.py`):
shallow features (SFENet1, SFENet2), residual dense blocks with local
feature fusion, global feature fusion over every block's output and a long
residual to the first shallow feature. Config B: 16 blocks of 8 dense 3x3
convs, growth 64. Convolutions only (cuDNN); NHWC in and out, under the
reference `state_dict` keys (`SFENet1`, `RDBs.{i}.convs.{c}.conv.0`,
`RDBs.{i}.LFF`, `GFF.{0,1}`). With `dtype=torch.bfloat16` the convolutions,
ReLUs, concatenations and residual adds run in bfloat16 on float32
parameters (flax's `dtype=`; the RDN-Enhanced recipe's encoder)."""

from __future__ import annotations

import torch
from torch import nn

from gsasr_torch.models.common import Conv2d

_CONFIGS = {"A": (20, 6, 32), "B": (16, 8, 64)}


class _DenseConv(nn.Module):
    """A 3x3 conv + ReLU whose output is concatenated to its input."""

    def __init__(self, in_ch: int, growth: int, dtype=torch.float32):
        super().__init__()
        self.conv = nn.Sequential(Conv2d(in_ch, growth, 3, padding=1,
                                         dtype=dtype), nn.ReLU())

    def forward(self, x):
        return torch.cat([x, self.conv(x)], dim=1)


class RDB(nn.Module):
    """Residual dense block (reference `rdn.py:27-43`), NCHW."""

    def __init__(self, g0: int, growth: int, n_layers: int,
                 dtype=torch.float32):
        super().__init__()
        self.convs = nn.ModuleList(_DenseConv(g0 + c * growth, growth, dtype)
                                   for c in range(n_layers))
        self.LFF = Conv2d(g0 + n_layers * growth, g0, 1, dtype=dtype)

    def forward(self, x):
        y = x
        for conv in self.convs:
            y = conv(y)
        return self.LFF(y) + x


class RDNNOUP(nn.Module):
    """(B, H, W, 3) -> (B, H, W, g0) NHWC in `dtype`."""

    def __init__(self, g0: int = 64, config: str = "B", dtype=torch.float32):
        super().__init__()
        d, c, g = _CONFIGS[config]
        self.dtype = dtype
        self.SFENet1 = Conv2d(3, g0, 3, padding=1, dtype=dtype)
        self.SFENet2 = Conv2d(g0, g0, 3, padding=1, dtype=dtype)
        self.RDBs = nn.ModuleList(RDB(g0, g, c, dtype) for _ in range(d))
        self.GFF = nn.Sequential(Conv2d(d * g0, g0, 1, dtype=dtype),
                                 Conv2d(g0, g0, 3, padding=1, dtype=dtype))

    def forward(self, x):
        f1 = self.SFENet1(x.permute(0, 3, 1, 2))
        y = self.SFENet2(f1)
        outs = []
        for rdb in self.RDBs:
            y = rdb(y)
            outs.append(y)
        return (self.GFF(torch.cat(outs, dim=1)) + f1).permute(0, 2, 3, 1)
