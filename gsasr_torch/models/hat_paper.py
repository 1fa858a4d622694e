"""Paper HAT encoder with relative-position bias and shifted-window masks,
without upsampler (counterpart of `gsasr_tpu/models/hat_paper.py`, the
reference's `hat_arch.py` HATNOUP, the `network_g` type `HATNOUP`):
conv_first -> patch_embed.norm -> RHAGs (each a group of Hybrid Attention
Blocks, one overlapping cross-attention block, a conv and a residual) ->
norm -> conv_after_body + long residual -> conv_before_upsample (conv to
num_feat, LeakyReLU 0.01). NHWC in and out, under the reference
`state_dict` keys (`layers.{i}.residual_group.blocks.{j}.attn.qkv`,
`...blocks.{j}.attn.relative_position_bias_table`,
`layers.{i}.residual_group.overlap_attn.relative_position_bias_table`, ...),
those `gsasr_tpu/utils/torch_convert.py::convert_hat_paper` reads.

It is the RoPE HAT's topology (`models/hat.py`) with SwinIR's attention: a
HAB's window attention is SwinIR's `WindowAttention` (one qkv projection,
a (2 ws - 1)^2-row bias table), and a shifted HAB passes the SW-MSA mask,
so its windows of 16 (256 tokens) take the window-16 masked forms WM-long
and WMB-long on the card (WM-long-bf16 and WMB-long-bf16 in bfloat16); an
unshifted HAB's take W-long and WB-long with the bias. OCAB's 256 queries
attend to the 576 tokens of their overlapping patch with a bias gathered
from a rectangular (ws + ows - 1)^2-row table (`oca_rel_pos_index`), through
W-long and WB-long. The bias tables' gradients are kernel T's ordered sums
over their indices, the OCAB's rectangular one included. `dtype` has flax's
`dtype=` semantics (`models/common.py`); the tables and the mask stay f32.
As in the JAX module there is no stochastic depth, and the CAB branch is
added beside the attention.

A HAB raises on a map smaller than its window, as the port's SwinIR does:
JAX shrinks the window and would build a bias table of another size.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gsasr_torch.models.common import MLP, Conv2d, LayerNorm, Linear
from gsasr_torch.models.fea2gs import conv_nhwc, to_lattice, window_partition
from gsasr_torch.models.hat import CAB, overlap_windows
from gsasr_torch.models.swinir import WindowAttention, swin_attn_mask
from gsasr_torch.ops.attention import window_attention_packed
from gsasr_torch.ops.bias_table import (register_bias_index,
                                        relative_position_bias)


def oca_rel_pos_index(ws: int, ows: int) -> np.ndarray:
    """(ws*ws, ows*ows) index into the OCAB's (ws + ows - 1)^2-row table
    (`hat_arch.py:896-919`). It runs negative (the reference shifts each
    offset by ws - ows + 1, not by ws - 1), and the reference's and JAX's
    gathers wrap it: entry i reads row i mod (ws + ows - 1)^2, a one-to-one
    map of the offsets onto the rows."""
    co = np.stack(np.indices((ws, ws))).reshape(2, -1)
    ce = np.stack(np.indices((ows, ows))).reshape(2, -1)
    rel = (ce[:, None, :] - co[:, :, None]).transpose(1, 2, 0).astype(np.int64)
    rel += ws - ows + 1
    rel[:, :, 0] *= ws + ows - 1
    return rel.sum(-1)


class PaperHAB(nn.Module):
    """Hybrid Attention Block (`hat_arch.py:199-313`), NHWC: pre-norm
    (shifted, masked) window attention with a bias, plus the scaled CAB
    branch, then a GELU MLP."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift_size: int, compress_ratio: int, squeeze_factor: int,
                 conv_scale: float, mlp_ratio: float, dtype=torch.float32):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.conv_scale = conv_scale
        self.norm1 = LayerNorm(dim, dtype)
        self.conv_block = CAB(dim, compress_ratio, squeeze_factor, dtype)
        self.attn = WindowAttention(dim, window_size, num_heads, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = MLP(dim, int(dim * mlp_ratio), dim, act=F.gelu,
                       dtype=dtype)

    def forward(self, x):
        b, h, w, _ = x.shape
        ws = self.window_size
        if min(h, w) < ws:
            raise ValueError(f"a {h}x{w} map is smaller than the window {ws} "
                             "the bias table is sized for")
        shift = 0 if min(h, w) <= ws else self.shift_size
        shortcut = x
        x = self.norm1(x)
        conv_x = self.conv_block(x)
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        mask = swin_attn_mask(h, w, ws, shift, x.device) if shift else None
        y = to_lattice(self.attn(window_partition(x, ws), mask), b, h // ws,
                       w // ws, ws)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = shortcut + y + conv_x * self.conv_scale
        return x + self.mlp(self.norm2(x))


class PaperOCAB(nn.Module):
    """Overlapping cross-attention block (`hat_arch.py:352-438`): each
    window's ws^2 queries attend to the ows^2 tokens of its overlapping
    patch (ows = ws + ws * overlap_ratio) with a bias from the rectangular
    table, then proj + residual and a GELU MLP."""

    def __init__(self, dim: int, window_size: int, overlap_ratio: float,
                 num_heads: int, mlp_ratio: float, dtype=torch.float32):
        super().__init__()
        self.window_size = window_size
        self.overlap_win_size = int(window_size * overlap_ratio) + window_size
        self.num_heads = num_heads
        rows = (window_size + self.overlap_win_size - 1) ** 2
        self.relative_position_bias_table = nn.Parameter(
            torch.empty(rows, num_heads))
        register_bias_index(
            self, oca_rel_pos_index(window_size, self.overlap_win_size) % rows,
            rows)
        self.norm1 = LayerNorm(dim, dtype)
        self.qkv = Linear(dim, 3 * dim, dtype)
        self.proj = Linear(dim, dim, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = MLP(dim, int(dim * mlp_ratio), dim, act=F.gelu,
                       dtype=dtype)

    def forward(self, x):
        b, h, w, _ = x.shape
        ws, ows = self.window_size, self.overlap_win_size
        q, k, v = self.qkv(self.norm1(x)).chunk(3, dim=-1)
        bias = relative_position_bias(self.relative_position_bias_table,
                                      self.relative_position_index,
                                      self.relative_position_inverse)
        out = window_attention_packed(
            window_partition(q, ws), overlap_windows(k, ws, ows),
            overlap_windows(v, ws, ows), bias, num_heads=self.num_heads)
        x = self.proj(to_lattice(out, b, h // ws, w // ws, ws)) + x
        return x + self.mlp(self.norm2(x))


class PaperRHAG(nn.Module):
    """Residual Hybrid Attention Group: HABs alternating unshifted and
    shifted by window_size // 2, one OCAB, a 3x3 conv, and a residual."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, compress_ratio: int, squeeze_factor: int,
                 conv_scale: float, overlap_ratio: float, mlp_ratio: float,
                 dtype=torch.float32):
        super().__init__()
        self.residual_group = nn.ModuleDict({
            "blocks": nn.ModuleList(
                PaperHAB(dim, num_heads, window_size,
                         0 if i % 2 == 0 else window_size // 2,
                         compress_ratio, squeeze_factor, conv_scale,
                         mlp_ratio, dtype) for i in range(depth)),
            "overlap_attn": PaperOCAB(dim, window_size, overlap_ratio,
                                      num_heads, mlp_ratio, dtype)})
        self.conv = Conv2d(dim, dim, 3, padding=1, dtype=dtype)

    def forward(self, x):
        y = x
        for blk in self.residual_group["blocks"]:
            y = blk(y)
        y = self.residual_group["overlap_attn"](y)
        return conv_nhwc(self.conv, y) + x


class HATNOUPPaper(nn.Module):
    """(B, H, W, 3) -> (B, H, W, num_feat) NHWC in `dtype`; H and W
    multiples of window_size (16; with the paper decoder's windows of 12,
    `sr_forward` pads to 48). The defaults are the reference's HATNOUP: 180
    channels, 6 RHAGs of 6 HABs, 6 heads of 30, window 16, overlap 0.5,
    compress 3, squeeze 30, conv_scale 0.01, mlp ratio 2."""

    def __init__(self, embed_dim: int = 180,
                 depths: Sequence[int] = (6,) * 6,
                 num_heads: Sequence[int] = (6,) * 6,
                 window_size: int = 16, compress_ratio: int = 3,
                 squeeze_factor: int = 30, conv_scale: float = 0.01,
                 overlap_ratio: float = 0.5, mlp_ratio: float = 2.0,
                 num_feat: int = 64, dtype=torch.float32):
        super().__init__()
        self.window_size = window_size
        self.dtype = dtype
        self.conv_first = Conv2d(3, embed_dim, 3, padding=1, dtype=dtype)
        self.patch_embed = nn.ModuleDict({"norm": LayerNorm(embed_dim,
                                                            dtype)})
        self.layers = nn.ModuleList(
            PaperRHAG(embed_dim, d, num_heads[i], window_size, compress_ratio,
                      squeeze_factor, conv_scale, overlap_ratio, mlp_ratio,
                      dtype)
            for i, d in enumerate(depths))
        self.norm = LayerNorm(embed_dim, dtype)
        self.conv_after_body = Conv2d(embed_dim, embed_dim, 3, padding=1,
                                      dtype=dtype)
        self.conv_before_upsample = nn.Sequential(
            Conv2d(embed_dim, num_feat, 3, padding=1, dtype=dtype),
            nn.LeakyReLU(0.01))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """x: (B, H, W, 3). `generator` is taken as the other encoders take
        it and not used: this encoder has no stochastic depth."""
        x = conv_nhwc(self.conv_first, x)
        y = self.patch_embed["norm"](x)
        for layer in self.layers:
            y = layer(y)
        y = conv_nhwc(self.conv_after_body, self.norm(y)) + x
        return conv_nhwc(self.conv_before_upsample, y)
