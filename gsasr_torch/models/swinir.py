"""SwinIR encoder without upsampler (counterpart of
`gsasr_tpu/models/swinir.py`): conv_first -> patch_embed.norm -> RSTBs
(each a group of Swin blocks, a conv and a residual) -> norm ->
conv_after_body + long residual -> conv_before_upsample (conv to num_feat,
LeakyReLU 0.01). NHWC in and out, under the reference `state_dict` keys
(`layers.{i}.residual_group.blocks.{j}.attn.qkv`, `patch_embed.norm`,
`conv_before_upsample.0`, ...).

Every window attention goes through `window_attention_packed`: the
unshifted blocks' through kernels W and WB on the card, the shifted
blocks' with the SW-MSA mask through WM and WMB (W-bf16, WB-bf16, WM-bf16
and WMB-bf16 in bfloat16). The mask is built on the device with torch ops,
once per (h, w, ws, shift, device). The bias tables'
gradients are kernel T's ordered sums. Stochastic depth (DropPath, a
linspace of rates over all blocks) is active in training mode and draws
from the generator passed to `forward`.

With `dtype=torch.bfloat16` (configs/train_swinir_amp.yml's GSASRAMPModel)
every module computes in bfloat16 on float32 parameters with flax's
`dtype=` semantics (`models/common.py`): each Dense and Conv rounds its
product, then adds its bias; a LayerNorm rounds once; exact GELU, the
residual adds, the rolls and DropPath run in bfloat16. The bias tables and
the mask stay float32, as in the JAX module.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gsasr_torch.models.common import (MLP, Conv2d, DropPath, LayerNorm,
                                       Linear)
from gsasr_torch.models.fea2gs import (conv_nhwc, self_attn_rel_pos_index,
                                       to_lattice, window_partition)
from gsasr_torch.ops.attention import window_attention_packed
from gsasr_torch.ops.bias_table import (register_bias_index,
                                        relative_position_bias)


@functools.lru_cache(maxsize=16)
def swin_attn_mask(h: int, w: int, ws: int, shift: int,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """SW-MSA 9-region mask of an (h, w) map: (nW, ws*ws, ws*ws) float32, 0
    where two tokens of a window come from the same region, -100 where not.
    Built on `device` and cached per arguments: callers must not write to
    it."""
    edges = lambda n: (torch.arange(n, device=device) >= n - ws).long() + (  # noqa: E731
        torch.arange(n, device=device) >= n - shift).long()
    img = edges(h)[:, None] * 3 + edges(w)[None, :]
    m = window_partition(img[None, :, :, None], ws)[..., 0]
    diff = m[:, None, :] - m[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0).to(torch.float32)


class WindowAttention(nn.Module):
    """W-MSA with a relative-position bias (reference `swinir.py:177-259`):
    one qkv projection split into contiguous thirds, then proj."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        rows = (2 * window_size - 1) ** 2
        index = self_attn_rel_pos_index(window_size)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty(rows, num_heads))
        register_bias_index(self, index, rows)
        self.qkv = Linear(dim, 3 * dim, dtype)
        self.proj = Linear(dim, dim, dtype)

    def forward(self, x, mask=None):
        """x: (B_, ws*ws, C) windows; mask: (nW, ws*ws, ws*ws) or None."""
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        bias = relative_position_bias(self.relative_position_bias_table,
                                      self.relative_position_index,
                                      self.relative_position_inverse)
        return self.proj(window_attention_packed(
            q, k, v, bias, num_heads=self.num_heads, window_mask=mask))


class SwinBlock(nn.Module):
    """SwinTransformerBlock (reference `swinir.py:276-434`), NHWC: pre-norm
    (shifted) window attention and a GELU MLP, each a residual branch gated
    by the same DropPath."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift_size: int, mlp_ratio: float, drop_path: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = WindowAttention(dim, window_size, num_heads, dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = MLP(dim, int(dim * mlp_ratio), dim, act=F.gelu,
                       dtype=dtype)

    def forward(self, x, generator=None):
        b, h, w, _ = x.shape
        if min(h, w) < self.window_size:
            raise ValueError(f"a {h}x{w} map is smaller than the window "
                             f"{self.window_size} the bias table is sized for")
        ws = self.window_size
        shift = 0 if min(h, w) <= ws else self.shift_size
        y = self.norm1(x)
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        mask = swin_attn_mask(h, w, ws, shift, x.device) if shift else None
        y = self.attn(window_partition(y, ws), mask)
        y = to_lattice(y, b, h // ws, w // ws, ws)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + self.drop_path(y, generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), generator)


class RSTB(nn.Module):
    """Residual Swin Transformer Block (reference `swinir.py:562-652`):
    blocks alternating unshifted and shifted by window_size // 2, a 3x3
    conv, and a residual."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, drop_path: Sequence[float],
                 dtype=torch.float32):
        super().__init__()
        self.residual_group = nn.ModuleDict({"blocks": nn.ModuleList(
            SwinBlock(dim, num_heads, window_size,
                      0 if i % 2 == 0 else window_size // 2, mlp_ratio,
                      drop_path[i], dtype) for i in range(depth))})
        self.conv = Conv2d(dim, dim, 3, padding=1, dtype=dtype)

    def forward(self, x, generator=None):
        y = x
        for blk in self.residual_group["blocks"]:
            y = blk(y, generator)
        return conv_nhwc(self.conv, y) + x


class SwinIRNOUP(nn.Module):
    """(B, H, W, 3) -> (B, H, W, num_feat) NHWC in `dtype`; H and W
    multiples of window_size (sr_forward pads to 24: `DENOMINATORS
    ["swinir"]`)."""

    def __init__(self, embed_dim: int = 180,
                 depths: Sequence[int] = (6, 6, 6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6, 6, 6),
                 window_size: int = 8, mlp_ratio: float = 2.0,
                 num_feat: int = 64, drop_path_rate: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.window_size = window_size
        self.drop_path_rate = drop_path_rate
        self.dtype = dtype
        # stochastic depth: a linspace over all blocks (`swinir.py:877`)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.conv_first = Conv2d(3, embed_dim, 3, padding=1, dtype=dtype)
        self.patch_embed = nn.ModuleDict({"norm": LayerNorm(embed_dim,
                                                            dtype)})
        offs = np.cumsum([0, *depths])
        self.layers = nn.ModuleList(
            RSTB(embed_dim, d, num_heads[i], window_size, mlp_ratio,
                 dpr[offs[i]:offs[i + 1]], dtype)
            for i, d in enumerate(depths))
        self.norm = LayerNorm(embed_dim, dtype)
        self.conv_after_body = Conv2d(embed_dim, embed_dim, 3, padding=1,
                                      dtype=dtype)
        self.conv_before_upsample = nn.Sequential(
            Conv2d(embed_dim, num_feat, 3, padding=1, dtype=dtype),
            nn.LeakyReLU(0.01))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """x: (B, H, W, 3). `generator` draws the DropPath masks in training
        mode (required there when drop_path_rate > 0)."""
        x = conv_nhwc(self.conv_first, x)
        y = self.patch_embed["norm"](x)
        for layer in self.layers:
            y = layer(y, generator)
        y = conv_nhwc(self.conv_after_body, self.norm(y)) + x
        return conv_nhwc(self.conv_before_upsample, y)
