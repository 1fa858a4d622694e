"""EDSR-baseline encoder without upsampler (counterpart of
`gsasr_tpu/models/edsr.py`): conv_first -> residual blocks -> conv_after_body,
returning the residual branch `res`, not `res + x`, as the reference does.
With `dtype=torch.bfloat16` the convolutions, ReLUs and residual adds run in
bfloat16 on float32 parameters (flax's `dtype=`), and the output is
bfloat16."""

from __future__ import annotations

import torch
from torch import nn

from gsasr_torch.models.common import Conv2d


class ResidualBlockNoBN(nn.Module):
    def __init__(self, num_feat: int = 64, res_scale: float = 1.0,
                 dtype=torch.float32):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = Conv2d(num_feat, num_feat, 3, padding=1, dtype=dtype)
        self.conv2 = Conv2d(num_feat, num_feat, 3, padding=1, dtype=dtype)

    def forward(self, x):
        return x + self.conv2(torch.relu(self.conv1(x))) * self.res_scale


class EDSRNOUP(nn.Module):
    """(B, H, W, 3) NHWC -> (B, H, W, num_feat) NHWC in `dtype`."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64,
                 num_block: int = 16, res_scale: float = 1.0,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv_first = Conv2d(num_in_ch, num_feat, 3, padding=1,
                                 dtype=dtype)
        self.body = nn.ModuleList(ResidualBlockNoBN(num_feat, res_scale,
                                                    dtype)
                                  for _ in range(num_block))
        self.conv_after_body = Conv2d(num_feat, num_feat, 3, padding=1,
                                      dtype=dtype)

    def forward(self, x):
        res = self.conv_first(x.permute(0, 3, 1, 2))
        for blk in self.body:
            res = blk(res)
        return self.conv_after_body(res).permute(0, 2, 3, 1)
