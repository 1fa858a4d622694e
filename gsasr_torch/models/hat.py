"""HAT-L encoder with RoPE window attention, without upsampler (counterpart
of `gsasr_tpu/models/hat.py`, the reference's HATNOUP_ROPE_AMP):
conv_first -> patch_embed.norm -> RHAGs (each a group of Hybrid Attention
Blocks, one overlapping cross-attention block, a conv and a residual) ->
norm -> conv_after_body + long residual -> conv_before_upsample (conv to
num_feat, LeakyReLU 0.01). NHWC in and out, under the reference
`state_dict` keys (`layers.{i}.residual_group.blocks.{j}.attn.qkv`,
`...blocks.{j}.conv_block.cab.3.attention.1`,
`layers.{i}.residual_group.overlap_attn.rope_freqs`, ...).

Every attention goes through `window_attention_packed` without a bias or a
mask: HAT-L's windows of 16 (256 tokens) and OCAB's 256 queries against
576 keys take the window-16 forms of kernels W and WB on the card (W-long
and WB-long; W-long-bf16 and WB-long-bf16 in bfloat16). With
`dtype=torch.bfloat16` (the Ultra recipe's GSASRAMPModel, the reference's
--AMP_test) every module computes in bfloat16 on float32 parameters with
flax's `dtype=` semantics (`models/common.py`): each Dense and Conv rounds
its product, then adds its bias; a LayerNorm rounds once; the channel
attention's mean is taken in f32 and rounded; exact GELU, the sigmoid, the
residual adds and `conv_scale` run in bfloat16; RoPE rotates in f32 and
rounds back. The reference's quirks are kept, as the JAX module states
them:

- shifted HABs roll by ws // 2, attend unmasked and roll back (the
  reference's SDPA ignores its shifted-window mask);
- OCAB's RoPE lattice spans max(ws, ows)^2 row-major positions: q takes
  its first ws^2 rows, k all ows^2;
- OCAB's keys and values are the (ows x ows) patches at stride ws of the
  zero-padded map, the patch interior in row-major order;
- the CAB branch is added outside DropPath (identity in eval mode).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gsasr_torch.models.common import (MLP, Conv2d, DropPath, LayerNorm,
                                       Linear, linear)
from gsasr_torch.models.fea2gs import conv_nhwc, to_lattice, window_partition
from gsasr_torch.models.fea2gs_rope import (apply_rope_packed, rope_phases,
                                            rope_t_xy)
from gsasr_torch.ops.attention import window_attention_packed


def _rope_freqs(dim: int, num_heads: int) -> nn.Parameter:
    """Uninitialized (2, nh, hd/2) mixed-RoPE frequencies; `init_weights`
    draws them."""
    return nn.Parameter(torch.empty(2, num_heads, dim // num_heads // 2))


def _rope_attend(q, k, v, freqs, end: int, num_heads: int):
    """Multi-head attention of packed q against k, v, both rotated on the
    end x end lattice (q by its first Tq positions, k by its first Tk), no
    bias."""
    ph = rope_phases(freqs, *rope_t_xy(end, end, freqs.device))
    return window_attention_packed(apply_rope_packed(q, ph, num_heads),
                                   apply_rope_packed(k, ph, num_heads), v,
                                   None, num_heads=num_heads)


class ChannelAttention(nn.Module):
    """RCAN channel attention (`hatropeamp.py:191-209`), NHWC: the map's
    mean (f32, rounded to `dtype`) through two 1x1 convs (ReLU, sigmoid)
    scales each channel."""

    def __init__(self, num_feat: int, squeeze_factor: int,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(num_feat, num_feat // squeeze_factor, 1),
            nn.ReLU(inplace=True),
            nn.Conv2d(num_feat // squeeze_factor, num_feat, 1),
            nn.Sigmoid())

    def forward(self, x):
        fc1, fc2 = self.attention[1], self.attention[3]
        y = x.float().mean(dim=(1, 2), keepdim=True).to(self.dtype)
        y = torch.relu(linear(y, fc1.weight.flatten(1), fc1.bias, self.dtype))
        return x * torch.sigmoid(linear(y, fc2.weight.flatten(1), fc2.bias,
                                        self.dtype))


class CAB(nn.Module):
    """Channel attention block (`hatropeamp.py:212-225`): 3x3 conv to
    num_feat / compress_ratio, exact GELU, 3x3 conv back, channel
    attention."""

    def __init__(self, num_feat: int, compress_ratio: int = 3,
                 squeeze_factor: int = 30, dtype=torch.float32):
        super().__init__()
        self.cab = nn.Sequential(
            Conv2d(num_feat, num_feat // compress_ratio, 3, padding=1,
                   dtype=dtype),
            nn.GELU(),
            Conv2d(num_feat // compress_ratio, num_feat, 3, padding=1,
                   dtype=dtype),
            ChannelAttention(num_feat, squeeze_factor, dtype))

    def forward(self, x):
        y = F.gelu(conv_nhwc(self.cab[0], x))
        return self.cab[3](conv_nhwc(self.cab[2], y))


class HATWindowAttention(nn.Module):
    """RoPE window attention (`hatropeamp.py:280-349`): one qkv projection
    split into contiguous thirds, q and k rotated on the window's lattice,
    no mask and no bias, then proj."""

    def __init__(self, dim: int, num_heads: int, rope_theta: float = 10.0,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.rope_theta = rope_theta
        self.rope_freqs = _rope_freqs(dim, num_heads)
        self.qkv = Linear(dim, 3 * dim, dtype)
        self.proj = Linear(dim, dim, dtype)

    def forward(self, x, ws: int):
        """x: (B_, ws*ws, C) windows."""
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return self.proj(_rope_attend(q, k, v, self.rope_freqs, ws,
                                      self.num_heads))


class HAB(nn.Module):
    """Hybrid Attention Block (`hatropeamp.py:352-464`), NHWC: pre-norm
    (shifted, unmasked) window attention plus the scaled CAB branch, then a
    GELU MLP."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift_size: int, compress_ratio: int, squeeze_factor: int,
                 conv_scale: float, mlp_ratio: float, rope_theta: float,
                 drop_path: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.conv_scale = conv_scale
        self.norm1 = LayerNorm(dim, dtype)
        self.conv_block = CAB(dim, compress_ratio, squeeze_factor, dtype)
        self.attn = HATWindowAttention(dim, num_heads, rope_theta, dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = MLP(dim, int(dim * mlp_ratio), dim, act=F.gelu,
                       dtype=dtype)

    def forward(self, x, generator=None):
        b, h, w, _ = x.shape
        ws = min(self.window_size, h, w)
        shift = self.shift_size if ws == self.window_size else 0
        if min(h, w) <= self.window_size:
            shift = 0
        shortcut = x
        x = self.norm1(x)
        conv_x = self.conv_block(x)
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        y = to_lattice(self.attn(window_partition(x, ws), ws), b, h // ws,
                       w // ws, ws)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        # DropPath gates the attention and MLP branches, not the CAB's
        x = shortcut + self.drop_path(y, generator) + conv_x * self.conv_scale
        return x + self.drop_path(self.mlp(self.norm2(x)), generator)


def overlap_windows(t, ws: int, ows: int):
    """(B, H, W, C) -> (B * H/ws * W/ws, ows*ows, C): the ows x ows patches
    at stride ws of t zero-padded by (ows - ws) / 2, the patch interior in
    row-major order (the JAX module's loop over patch offsets; the
    reference's nn.Unfold rearranged)."""
    pad = (ows - ws) // 2
    tp = F.pad(t, (0, 0, pad, pad, pad, pad))
    # (B, nh, nw, C, ows_y, ows_x)
    p = tp.unfold(1, ows, ws).unfold(2, ows, ws)
    b, nh, nw, c = p.shape[:4]
    return p.permute(0, 1, 2, 4, 5, 3).reshape(b * nh * nw, ows * ows, c)


class OCAB(nn.Module):
    """Overlapping cross-attention block (`hatropeamp.py:507-606`): each
    window's ws^2 queries attend to the ows^2 tokens of its overlapping
    patch (ows = ws + ws * overlap_ratio), then proj + residual and a GELU
    MLP."""

    def __init__(self, dim: int, window_size: int, overlap_ratio: float,
                 num_heads: int, mlp_ratio: float, rope_theta: float = 10.0,
                 dtype=torch.float32):
        super().__init__()
        self.window_size = window_size
        self.overlap_win_size = int(window_size * overlap_ratio) + window_size
        self.num_heads = num_heads
        self.rope_theta = rope_theta
        self.norm1 = LayerNorm(dim, dtype)
        self.qkv = Linear(dim, 3 * dim, dtype)
        self.rope_freqs = _rope_freqs(dim, num_heads)
        self.proj = Linear(dim, dim, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = MLP(dim, int(dim * mlp_ratio), dim, act=F.gelu,
                       dtype=dtype)

    def forward(self, x):
        b, h, w, _ = x.shape
        ws, ows = self.window_size, self.overlap_win_size
        q, k, v = self.qkv(self.norm1(x)).chunk(3, dim=-1)
        out = _rope_attend(window_partition(q, ws),
                           overlap_windows(k, ws, ows),
                           overlap_windows(v, ws, ows), self.rope_freqs,
                           max(ws, ows), self.num_heads)
        x = self.proj(to_lattice(out, b, h // ws, w // ws, ws)) + x
        return x + self.mlp(self.norm2(x))


class RHAG(nn.Module):
    """Residual Hybrid Attention Group (`hatropeamp.py:710-795`): HABs
    alternating unshifted and shifted by window_size // 2, one OCAB, a 3x3
    conv, and a residual."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int, compress_ratio: int, squeeze_factor: int,
                 conv_scale: float, overlap_ratio: float, mlp_ratio: float,
                 rope_theta: float, drop_path: Sequence[float],
                 dtype=torch.float32):
        super().__init__()
        self.residual_group = nn.ModuleDict({
            "blocks": nn.ModuleList(
                HAB(dim, num_heads, window_size,
                    0 if i % 2 == 0 else window_size // 2, compress_ratio,
                    squeeze_factor, conv_scale, mlp_ratio, rope_theta,
                    drop_path[i], dtype) for i in range(depth)),
            "overlap_attn": OCAB(dim, window_size, overlap_ratio, num_heads,
                                 mlp_ratio, rope_theta, dtype)})
        self.conv = Conv2d(dim, dim, 3, padding=1, dtype=dtype)

    def forward(self, x, generator=None):
        y = x
        for blk in self.residual_group["blocks"]:
            y = blk(y, generator)
        y = self.residual_group["overlap_attn"](y)
        return conv_nhwc(self.conv, y) + x


class HATNOUP(nn.Module):
    """(B, H, W, 3) -> (B, H, W, num_feat) NHWC in `dtype`; H and W
    multiples of window_size (sr_forward pads to 16: `DENOMINATORS["hat"]`).
    The defaults are HAT-L's: 192 channels, 12 RHAGs of 6 HABs, 6 heads of
    32, window 16, overlap 0.5, compress 3, squeeze 32, conv_scale 0.01,
    stochastic depth 0.1."""

    def __init__(self, embed_dim: int = 192,
                 depths: Sequence[int] = (6,) * 12,
                 num_heads: Sequence[int] = (6,) * 12,
                 window_size: int = 16, compress_ratio: int = 3,
                 squeeze_factor: int = 32, conv_scale: float = 0.01,
                 overlap_ratio: float = 0.5, mlp_ratio: float = 2.0,
                 num_feat: int = 64, rope_theta: float = 10.0,
                 drop_path_rate: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.window_size = window_size
        # read by the Trainer, which passes a DropPath generator when it is
        # above 0
        self.drop_path_rate = drop_path_rate
        self.dtype = dtype
        # stochastic depth: a linspace over all blocks (`hatropeamp.py:978`)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        offs = np.cumsum([0, *depths])
        self.conv_first = Conv2d(3, embed_dim, 3, padding=1, dtype=dtype)
        self.patch_embed = nn.ModuleDict({"norm": LayerNorm(embed_dim,
                                                            dtype)})
        self.layers = nn.ModuleList(
            RHAG(embed_dim, d, num_heads[i], window_size, compress_ratio,
                 squeeze_factor, conv_scale, overlap_ratio, mlp_ratio,
                 rope_theta, dpr[offs[i]:offs[i + 1]], dtype)
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
