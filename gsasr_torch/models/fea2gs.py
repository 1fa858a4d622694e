"""Paper Fea2GS decoder (counterpart of `gsasr_tpu/models/fea2gs.py`): LR
features -> (B, N, 9) raw Gaussian parameters.

The modules hold the parameters under the reference PyTorch `state_dict`
keys (the ones `gsasr_tpu/utils/torch_convert.py` reads), so a reference
checkpoint loads natively. Their `relative_position_index` buffers equal the
index functions below, which makes the converter's bias-table remap the
identity. `Fea2GS.forward` is the differentiable module path of
`gsasr_tpu/models/fea2gs.py::Fea2GS.__call__`: LayerNorms, linears and
convolutions are PyTorch ops and every window attention goes through
`window_attention_packed` (kernels W and WB on the card). Inference takes
the fused path of `fea2gs_fast.py` instead, as the JAX package does, and so
does training with `fused_decoder=True`. The layer classes take a compute
`dtype` (flax's `dtype=`, see `common.py`). `Fea2GS(dtype=torch.bfloat16)`
is `configs/train_edsr_paper_bf16_r3.yml`'s module path, as JAX's
`Fea2GS(dtype=jnp.bfloat16)` computes it: float32 parameters; the seed and
position embeddings and the residual stream stay float32 (flax adds a
bf16 sub-layer output to a float32 residual in float32); LayerNorms,
linears, the scale MLP, the feature projection, the attentions (W-bf16 and
WB-bf16 with the float32 bias table on the card) and UPNet in bfloat16;
the heads in float32 with `fp32_heads` (False: in bfloat16, and the output
too, as JAX's).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from gsasr_torch.models.common import (MLP, Conv2d, LayerNorm, Linear,
                                       conv2d, linear, pixel_shuffle,
                                       seq_apply)
from gsasr_torch.ops.attention import window_attention_packed
from gsasr_torch.ops.bias_table import (register_bias_index,
                                        relative_position_bias)


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


def to_lattice(gs, b: int, h_count: int, w_count: int, nsq: int):
    """(B * h_count * w_count, nsq*nsq, C) windows -> the full seed lattice
    (B, h_count*nsq, w_count*nsq, C); `window_partition(., nsq)` inverts
    it."""
    ch = gs.shape[-1]
    full = gs.reshape(b, h_count, w_count, nsq, nsq, ch)
    return full.permute(0, 1, 3, 2, 4, 5).reshape(b, h_count * nsq,
                                                  w_count * nsq, ch)


def conv_nhwc(conv, x, dtype=None):
    """`conv` (a module, or a Conv2d computed in `dtype` when given) on NHWC
    x."""
    x = x.permute(0, 3, 1, 2)
    y = conv(x) if dtype is None else conv2d(x, conv, dtype)
    return y.permute(0, 2, 3, 1)


def reference_points(h: int, w: int, dtype=torch.float32, device=None):
    """Pixel-center anchor grid: (h*w, 2) as (x, y), computed in float32
    and rounded to `dtype`."""
    f32 = torch.float32
    ys = torch.linspace(0.5 / h, 1 - 0.5 / h, h, dtype=f32, device=device)
    xs = torch.linspace(0.5 / w, 1 - 0.5 / w, w, dtype=f32, device=device)
    ref_y = ys[:, None].expand(h, w)
    ref_x = xs[None, :].expand(h, w)
    return torch.stack([ref_x.reshape(-1), ref_y.reshape(-1)],
                       dim=-1).to(dtype)


class ScaleInject(nn.Module):
    """The reference's nn.MultiheadAttention over identical scale tokens.
    Its output is out_proj(v_proj(scale)); only the V third of in_proj and
    out_proj are live, the q/k thirds are kept for the checkpoint. Computes
    in `dtype`, or in the `dtype` a call passes (the fused paths' f32)."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, scale_embedding, dtype=None):
        dt = self.dtype if dtype is None else dtype
        c = self.out_proj.in_features
        v = linear(scale_embedding, self.in_proj_weight[2 * c:],
                   self.in_proj_bias[2 * c:], dt)
        return linear(v, self.out_proj.weight, self.out_proj.bias, dt)


class _WindowAttnParams(nn.Module):
    """q/k/v heads, out-projection, rel-pos bias table and its index."""

    def __init__(self, dim: int, num_heads: int, table_rows: int,
                 index: np.ndarray, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.empty(table_rows, num_heads))
        # the index, and its rows listed per table row for the ordered
        # gradient sum, rebuilt when a state_dict loads an index
        register_bias_index(self, index, table_rows)
        self.qhead = Linear(dim, dim, dtype)
        self.khead = Linear(dim, dim, dtype)
        self.vhead = Linear(dim, dim, dtype)
        self.proj = Linear(dim, dim, dtype)

    def bias(self):
        """(num_heads, Tq, Tk) bias gathered from the table; its gradient
        is summed in a fixed order (kernel T on the card)."""
        return relative_position_bias(self.relative_position_bias_table,
                                      self.relative_position_index,
                                      self.relative_position_inverse)

    def attend(self, x, src):
        """proj(MHA(q = x, k = v = src, + bias)) on packed (B_, T, C)."""
        out = window_attention_packed(
            self.qhead(x), self.khead(src), self.vhead(src), self.bias(),
            num_heads=self.num_heads)
        return self.proj(out)


class WindowCrossAttn(_WindowAttnParams):
    """Q = Gaussian seeds, K/V = feature window, rectified rel-pos bias."""

    def __init__(self, dim, num_heads, window_size, num_gs_seed,
                 dtype=torch.float32):
        gs_sqrt = math.isqrt(num_gs_seed)
        super().__init__(dim, num_heads,
                         (2 * max(gs_sqrt, window_size) - 1) ** 2,
                         cross_attn_rel_pos_index(gs_sqrt, window_size),
                         dtype)

    def forward(self, gs, feat):
        return self.attend(gs, feat)


class GSSelfAttn(_WindowAttnParams):
    """Windowed self-attention over the seed lattice, Swin rel-pos bias."""

    def __init__(self, dim, num_heads, num_gs_seed_sqrt, dtype=torch.float32):
        super().__init__(dim, num_heads, (2 * num_gs_seed_sqrt - 1) ** 2,
                         self_attn_rel_pos_index(num_gs_seed_sqrt), dtype)

    def forward(self, gs):
        return self.attend(gs, gs)


class WindowCrossAttnLayer(nn.Module):
    """scale-inject -> FFN -> (shifted) window cross-attention -> FFN, all
    pre-norm residual. norm1 is dead in the reference topology: its output
    is overwritten, so its parameters get a zero gradient. `attn` replaces
    the rel-pos-bias attention (the Enhanced family's RoPE attention);
    norms, inject, MLPs and the attention compute in `dtype`."""

    def __init__(self, dim, num_heads, window_size, num_gs_seed,
                 shift_size: int = 0, attn: nn.Module = None,
                 dtype=torch.float32):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = LayerNorm(dim, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.norm3 = LayerNorm(dim, dtype)
        self.norm4 = LayerNorm(dim, dtype)
        self.gs_cross_attn_scale = ScaleInject(dim, dtype)
        self.window_cross_attn = attn if attn is not None else \
            WindowCrossAttn(dim, num_heads, window_size, num_gs_seed, dtype)
        self.mlp_crossattn_scale = MLP(dim, dim, dim, dtype=dtype)
        self.mlp_crossattn_feature = MLP(dim, dim, dim, dtype=dtype)

    def forward(self, x, query_pos, feat, scale_embedding):
        """x: (B_, T, C); query_pos: (T, C); feat: (B, H, W, C) before
        windowing; scale_embedding: (B_, C)."""
        x = x + self.gs_cross_attn_scale(scale_embedding)[:, None, :]
        x = x + self.mlp_crossattn_scale(self.norm2(x))
        s = self.shift_size
        if s > 0:
            feat = torch.roll(feat, (-s, -s), dims=(1, 2))
        x = x + self.window_cross_attn(self.norm3(x) + query_pos,
                                       window_partition(feat,
                                                        self.window_size))
        return x + self.mlp_crossattn_feature(self.norm4(x))


class GSSelfAttnLayer(nn.Module):
    """scale-inject -> FFN -> (lattice-shifted) windowed self-attention ->
    FFN. norm3 is dead in the reference topology (zero gradient). Shifted
    layers roll the whole seed lattice across window boundaries and roll
    the attention output back. `attn` replaces the rel-pos-bias attention
    (the Enhanced family's RoPE attention); norms, inject, MLPs and the
    attention compute in `dtype`."""

    def __init__(self, dim, num_heads, num_gs_seed_sqrt, shift_size: int = 0,
                 attn: nn.Module = None, dtype=torch.float32):
        super().__init__()
        self.num_gs_seed_sqrt = num_gs_seed_sqrt
        self.shift_size = shift_size
        self.norm1 = LayerNorm(dim, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.norm3 = LayerNorm(dim, dtype)
        self.norm4 = LayerNorm(dim, dtype)
        self.gs_cross_attn_scale = ScaleInject(dim, dtype)
        self.gs_self_attn = attn if attn is not None else \
            GSSelfAttn(dim, num_heads, num_gs_seed_sqrt, dtype)
        self.mlp_selfattn = MLP(dim, dim, dim, dtype=dtype)
        self.mlp_crossattn = MLP(dim, dim, dim, dtype=dtype)

    def forward(self, gs, h_count: int, w_count: int, scale_embedding):
        gs = gs + self.gs_cross_attn_scale(scale_embedding)[:, None, :]
        gs = gs + self.mlp_crossattn(self.norm4(gs))
        a = self.norm1(gs)
        s, nsq = self.shift_size, self.num_gs_seed_sqrt
        b = gs.shape[0] // (h_count * w_count)
        if s > 0:
            a = window_partition(torch.roll(to_lattice(a, b, h_count, w_count,
                                                       nsq),
                                            (-s, -s), dims=(1, 2)), nsq)
        a = self.gs_self_attn(a)
        if s > 0:
            a = window_partition(torch.roll(to_lattice(a, b, h_count, w_count,
                                                       nsq),
                                            (s, s), dims=(1, 2)), nsq)
        gs = a + gs
        return gs + self.mlp_selfattn(self.norm2(gs))


class _Block(nn.Module):
    """norm -> layers -> mlp (Linear, ReLU, Linear) -> + residual; norm and
    mlp in `dtype`."""

    def __init__(self, dim, layers, dtype=torch.float32):
        super().__init__()
        self.norm = LayerNorm(dim, dtype)
        self.blocks = nn.ModuleList(layers)
        self.mlp = nn.Sequential(Linear(dim, dim, dtype), nn.ReLU(),
                                 Linear(dim, dim, dtype))

    def forward(self, x, *layer_args):
        y = self.norm(x)
        for layer in self.blocks:
            y = layer(y, *layer_args)
        return x + self.mlp(y)


def _head(dim: int, out: int, dtype) -> nn.Sequential:
    """ch -> ch -> 4ch -> out head MLP."""
    return nn.Sequential(Linear(dim, dim, dtype), nn.ReLU(),
                         Linear(dim, 4 * dim, dtype), nn.ReLU(),
                         Linear(4 * dim, out, dtype))


def _add_front(m, inchannel: int, channel: int, num_heads: int,
               num_gs_seed: int, gs_up_factor: float, window_size: int,
               shuffle_scale1: int, shuffle_scale2: int,
               dtype=torch.float32) -> None:
    """A decoder's sizes, compute type, seed and position embeddings and
    feature projection, registered before its blocks (the order
    `init_weights` draws in)."""
    ch = channel
    m.dtype = dtype
    m.channel = ch
    m.num_heads = num_heads
    m.num_gs_seed = num_gs_seed
    m.gs_up_factor = gs_up_factor
    m.window_size = window_size
    m.shuffle_scale1 = shuffle_scale1
    m.shuffle_scale2 = shuffle_scale2
    m.gs_embedding = nn.Parameter(torch.empty(num_gs_seed, ch))
    m.pos_embedding = nn.Parameter(torch.empty(num_gs_seed, ch))
    m.img_feat_proj = nn.Sequential(
        Conv2d(inchannel, ch, 3, padding=1, dtype=dtype), nn.ReLU(),
        Conv2d(ch, ch, 3, padding=1, dtype=dtype))


def _add_tail(m, head_dtype=torch.float32) -> None:
    """A decoder's scale MLP and UPNet (in its compute type) and the five
    head MLPs (in `head_dtype`), registered after its blocks."""
    ch, dt = m.channel, m.dtype
    m.head_dtype = head_dtype
    m.scale_mlp = nn.Sequential(Linear(1, 4 * ch, dt), nn.ReLU(),
                                Linear(4 * ch, ch, dt))
    m.UPNet = nn.Sequential(
        Conv2d(ch, ch * m.shuffle_scale1 ** 2, 3, padding=1, dtype=dt),
        nn.PixelShuffle(m.shuffle_scale1),
        Conv2d(ch, ch * m.shuffle_scale2 ** 2, 3, padding=1, dtype=dt),
        nn.PixelShuffle(m.shuffle_scale2))
    guf = int(m.gs_up_factor)
    m.mlp_block_sigma = _head(ch, 2 * guf, head_dtype)
    m.mlp_block_rho = _head(ch, guf, head_dtype)
    m.mlp_block_alpha = _head(ch, guf, head_dtype)
    m.mlp_block_rgb = _head(ch, 3 * guf, head_dtype)
    m.mlp_block_mean = _head(ch, 2 * guf, head_dtype)


class Fea2GS(nn.Module):
    """Paper decoder: (B, h, w, inchannel) NHWC features with h, w divisible
    by window_size, and (B,) scales -> (B, N, 9) raw Gaussian parameters,
    float32 (bfloat16 with `dtype` bfloat16 and not `fp32_heads`). The
    module path computes in `dtype` (see the module docstring)."""

    def __init__(self, inchannel: int = 64, channel: int = 180,
                 num_heads: int = 6, num_crossattn_blocks: int = 1,
                 num_crossattn_layers: int = 2, num_selfattn_blocks: int = 6,
                 num_selfattn_layers: int = 6, num_gs_seed: int = 144,
                 gs_up_factor: float = 1.0, window_size: int = 12,
                 shuffle_scale1: int = 2, shuffle_scale2: int = 2,
                 dtype=torch.float32, fp32_heads: bool = True):
        super().__init__()
        ch = channel
        nsq = math.isqrt(num_gs_seed)
        _add_front(self, inchannel, ch, num_heads, num_gs_seed, gs_up_factor,
                   window_size, shuffle_scale1, shuffle_scale2, dtype)
        self.window_crossattn_blocks = nn.ModuleList(
            _Block(ch, [WindowCrossAttnLayer(
                ch, num_heads, window_size, num_gs_seed,
                shift_size=0 if i % 2 == 0 else window_size // 2,
                dtype=dtype)
                for i in range(num_crossattn_layers)], dtype)
            for _ in range(num_crossattn_blocks))
        self.gs_selfattn_blocks = nn.ModuleList(
            _Block(ch, [GSSelfAttnLayer(
                ch, num_heads, nsq, shift_size=0 if i % 2 == 0 else nsq // 2,
                dtype=dtype)
                for i in range(num_selfattn_layers)], dtype)
            for _ in range(num_selfattn_blocks))
        _add_tail(self, torch.float32 if fp32_heads else dtype)

    def forward(self, srcs, scale):
        """(B, h, w, inchannel) features, (B,) scales -> (B, N, 9)."""
        b, h, w, _ = srcs.shape
        ws = self.window_size
        h_count, w_count = h // ws, w // ws
        nwin = h_count * w_count
        query = self.gs_embedding[None].expand(b * nwin, -1, -1)
        se = self.scale_mlp((1.0 / scale)[:, None])
        # (B_, C); a plain sum backward, where repeat_interleave's is an
        # index-add (atomics on the card)
        scale_embedding = se[:, None].expand(b, nwin, self.channel).reshape(
            b * nwin, self.channel)
        feat = conv_nhwc(self.img_feat_proj, srcs)
        for blk in self.window_crossattn_blocks:
            query = blk(query, self.pos_embedding, feat, scale_embedding)
        resi = query
        for blk in self.gs_selfattn_blocks:
            query = blk(query, h_count, w_count, scale_embedding)
        nsq = math.isqrt(self.num_gs_seed)
        # JAX computes the tail in the heads' type: float32, or bfloat16
        # without fp32_heads
        return decode_full_lattice(
            self, to_lattice(query + resi, b, h_count, w_count, nsq), b,
            h_count, w_count, self.dtype, self.head_dtype,
            out_dtype=self.head_dtype)


def decode_lattice(m, query, b: int, h_count: int, w_count: int):
    """Decoder tail shared by the module and fused paths: seed windows ->
    full lattice -> `decode_full_lattice`. Returns (B, N, 9)."""
    nsq = math.isqrt(m.num_gs_seed)
    return decode_full_lattice(m, to_lattice(query, b, h_count, w_count, nsq),
                               b, h_count, w_count)


def decode_full_lattice(m, query, b: int, h_count: int, w_count: int,
                        dtype=torch.float32, head_dtype=torch.float32,
                        out_dtype=torch.float32):
    """(B, h_count*nsq, w_count*nsq, C) lattice -> UPNet (conv + pixel
    shuffle, twice, in `dtype`) -> the five head MLPs (in `head_dtype`) ->
    means normalized by the lattice size plus the pixel-center grid, in
    `out_dtype`. Returns (B, N, 9) in `out_dtype`. The fused paths take the
    defaults, float32 whatever the module was built with; the module paths
    pass their own types."""
    nsq = math.isqrt(m.num_gs_seed)
    query = pixel_shuffle(conv_nhwc(m.UPNet[0], query, dtype),
                          m.shuffle_scale1)
    query = pixel_shuffle(conv_nhwc(m.UPNet[2], query, dtype),
                          m.shuffle_scale2)

    guf = int(m.gs_up_factor)

    def head(seq, n):
        return seq_apply(seq, query, head_dtype).reshape(b, -1, n).to(
            out_dtype)

    q_sigma = head(m.mlp_block_sigma, 2 * guf)
    q_rho = head(m.mlp_block_rho, guf)
    q_alpha = head(m.mlp_block_alpha, guf)
    q_rgb = head(m.mlp_block_rgb, 3 * guf)
    q_mean = head(m.mlp_block_mean, 2 * guf)

    lat_h = nsq * h_count * m.shuffle_scale1 * m.shuffle_scale2
    lat_w = nsq * w_count * m.shuffle_scale1 * m.shuffle_scale2
    q_mean = q_mean / torch.tensor([[lat_w, lat_h]], dtype=out_dtype,
                                   device=q_mean.device)
    q_mean = q_mean + reference_points(lat_h, lat_w, out_dtype,
                                       q_mean.device)[None]
    return torch.cat([q_sigma, q_rho, q_alpha, q_rgb, q_mean], dim=-1)
