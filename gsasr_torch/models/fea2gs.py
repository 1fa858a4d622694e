"""Paper Fea2GS decoder (counterpart of `gsasr_tpu/models/fea2gs.py`): LR
features -> (B, N, 9) raw Gaussian parameters.

The modules hold the parameters under the reference PyTorch `state_dict`
keys (the ones `gsasr_tpu/utils/torch_convert.py` reads), so a reference
checkpoint loads natively. Their `relative_position_index` buffers equal the
index functions below, which makes the converter's bias-table remap the
identity. The forward pass is the fused path of `fea2gs_fast.py`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from gsasr_torch.models.common import MLP, LayerNorm


def cross_attn_rel_pos_index(gs_sqrt: int, window_size: int) -> np.ndarray:
    """Rectified relative-position index between the seed lattice and the
    feature window lattice, both scaled to a common resolution; pairwise
    deltas are ranked densely and combined as rank_y * max_rank + rank_x."""
    src = (np.stack(np.indices((gs_sqrt, gs_sqrt))) + 0.5) * window_size
    tgt = (np.stack(np.indices((window_size, window_size))) + 0.5) * gs_sqrt
    delta = (src.reshape(2, -1)[:, :, None]
             - tgt.reshape(2, -1)[:, None, :])
    uniq = np.unique(delta)
    ranks = np.searchsorted(uniq, delta)
    ranks[0] *= ranks.max()
    return ranks.sum(0)


def self_attn_rel_pos_index(n_sqrt: int) -> np.ndarray:
    """Swin-style relative position index on an n_sqrt^2 lattice."""
    coords = np.stack(np.indices((n_sqrt, n_sqrt))).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (n_sqrt - 1)
    rel[:, :, 0] *= 2 * n_sqrt - 1
    return rel.sum(-1)


def window_partition(x, ws: int):
    """(B, H, W, C) -> (B * H/ws * W/ws, ws*ws, C), row-major windows."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * (h // ws) * (w // ws), ws * ws, c)


def reference_points(h: int, w: int, dtype=torch.float32, device=None):
    """Pixel-center anchor grid: (h*w, 2) as (x, y)."""
    ys = torch.linspace(0.5 / h, 1 - 0.5 / h, h, dtype=dtype, device=device)
    xs = torch.linspace(0.5 / w, 1 - 0.5 / w, w, dtype=dtype, device=device)
    ref_y = ys[:, None].expand(h, w)
    ref_x = xs[None, :].expand(h, w)
    return torch.stack([ref_x.reshape(-1), ref_y.reshape(-1)], dim=-1)


class ScaleInject(nn.Module):
    """The reference's nn.MultiheadAttention over identical scale tokens.
    Its output is out_proj(v_proj(scale)); only the V third of in_proj and
    out_proj are live, the q/k thirds are kept for the checkpoint."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, scale_embedding):
        c = self.out_proj.in_features
        v = nn.functional.linear(scale_embedding, self.in_proj_weight[2 * c:],
                                 self.in_proj_bias[2 * c:])
        return self.out_proj(v)


class _WindowAttnParams(nn.Module):
    """q/k/v heads, out-projection, rel-pos bias table and its index."""

    def __init__(self, dim: int, num_heads: int, table_rows: int,
                 index: np.ndarray):
        super().__init__()
        self.num_heads = num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.empty(table_rows, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(index.astype(np.int64)))
        self.qhead = nn.Linear(dim, dim)
        self.khead = nn.Linear(dim, dim)
        self.vhead = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def bias(self):
        """(num_heads, Tq, Tk) bias gathered from the table."""
        idx = self.relative_position_index
        b = self.relative_position_bias_table[idx.reshape(-1)]
        return b.reshape(*idx.shape, self.num_heads).permute(2, 0, 1)


class WindowCrossAttn(_WindowAttnParams):
    def __init__(self, dim, num_heads, window_size, num_gs_seed):
        gs_sqrt = math.isqrt(num_gs_seed)
        super().__init__(dim, num_heads,
                         (2 * max(gs_sqrt, window_size) - 1) ** 2,
                         cross_attn_rel_pos_index(gs_sqrt, window_size))


class GSSelfAttn(_WindowAttnParams):
    def __init__(self, dim, num_heads, num_gs_seed_sqrt):
        super().__init__(dim, num_heads, (2 * num_gs_seed_sqrt - 1) ** 2,
                         self_attn_rel_pos_index(num_gs_seed_sqrt))


class WindowCrossAttnLayer(nn.Module):
    def __init__(self, dim, num_heads, window_size, num_gs_seed):
        super().__init__()
        self.norm1 = LayerNorm(dim)  # dead in the reference topology
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)
        self.norm4 = LayerNorm(dim)
        self.gs_cross_attn_scale = ScaleInject(dim)
        self.window_cross_attn = WindowCrossAttn(dim, num_heads, window_size,
                                                 num_gs_seed)
        self.mlp_crossattn_scale = MLP(dim, dim, dim)
        self.mlp_crossattn_feature = MLP(dim, dim, dim)


class GSSelfAttnLayer(nn.Module):
    def __init__(self, dim, num_heads, num_gs_seed_sqrt):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)  # dead in the reference topology
        self.norm4 = LayerNorm(dim)
        self.gs_cross_attn_scale = ScaleInject(dim)
        self.gs_self_attn = GSSelfAttn(dim, num_heads, num_gs_seed_sqrt)
        self.mlp_selfattn = MLP(dim, dim, dim)
        self.mlp_crossattn = MLP(dim, dim, dim)


class _Block(nn.Module):
    """norm -> layers -> mlp (Linear, ReLU, Linear) -> + residual."""

    def __init__(self, dim, layers):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.blocks = nn.ModuleList(layers)
        self.mlp = nn.Sequential(nn.Linear(dim, dim), nn.ReLU(),
                                 nn.Linear(dim, dim))


def _head(dim: int, out: int) -> nn.Sequential:
    """ch -> ch -> 4ch -> out head MLP."""
    return nn.Sequential(nn.Linear(dim, dim), nn.ReLU(),
                         nn.Linear(dim, 4 * dim), nn.ReLU(),
                         nn.Linear(4 * dim, out))


class Fea2GS(nn.Module):
    """Paper decoder: (B, h, w, inchannel) NHWC features with h, w divisible
    by window_size, and (B,) scales -> (B, N, 9) raw Gaussian parameters."""

    def __init__(self, inchannel: int = 64, channel: int = 180,
                 num_heads: int = 6, num_crossattn_blocks: int = 1,
                 num_crossattn_layers: int = 2, num_selfattn_blocks: int = 6,
                 num_selfattn_layers: int = 6, num_gs_seed: int = 144,
                 gs_up_factor: float = 1.0, window_size: int = 12,
                 shuffle_scale1: int = 2, shuffle_scale2: int = 2):
        super().__init__()
        ch = channel
        nsq = math.isqrt(num_gs_seed)
        self.channel = ch
        self.num_heads = num_heads
        self.num_gs_seed = num_gs_seed
        self.gs_up_factor = gs_up_factor
        self.window_size = window_size
        self.shuffle_scale1 = shuffle_scale1
        self.shuffle_scale2 = shuffle_scale2
        self.gs_embedding = nn.Parameter(torch.empty(num_gs_seed, ch))
        self.pos_embedding = nn.Parameter(torch.empty(num_gs_seed, ch))
        self.img_feat_proj = nn.Sequential(
            nn.Conv2d(inchannel, ch, 3, padding=1), nn.ReLU(),
            nn.Conv2d(ch, ch, 3, padding=1))
        self.window_crossattn_blocks = nn.ModuleList(
            _Block(ch, [WindowCrossAttnLayer(ch, num_heads, window_size,
                                             num_gs_seed)
                        for _ in range(num_crossattn_layers)])
            for _ in range(num_crossattn_blocks))
        self.gs_selfattn_blocks = nn.ModuleList(
            _Block(ch, [GSSelfAttnLayer(ch, num_heads, nsq)
                        for _ in range(num_selfattn_layers)])
            for _ in range(num_selfattn_blocks))
        self.scale_mlp = nn.Sequential(nn.Linear(1, 4 * ch), nn.ReLU(),
                                       nn.Linear(4 * ch, ch))
        self.UPNet = nn.Sequential(
            nn.Conv2d(ch, ch * shuffle_scale1 ** 2, 3, padding=1),
            nn.PixelShuffle(shuffle_scale1),
            nn.Conv2d(ch, ch * shuffle_scale2 ** 2, 3, padding=1),
            nn.PixelShuffle(shuffle_scale2))
        guf = int(gs_up_factor)
        self.mlp_block_sigma = _head(ch, 2 * guf)
        self.mlp_block_rho = _head(ch, guf)
        self.mlp_block_alpha = _head(ch, guf)
        self.mlp_block_rgb = _head(ch, 3 * guf)
        self.mlp_block_mean = _head(ch, 2 * guf)

    def forward(self, srcs, scale):
        from gsasr_torch.models.fea2gs_fast import fea2gs_apply_fused
        return fea2gs_apply_fused(self, srcs, scale)
