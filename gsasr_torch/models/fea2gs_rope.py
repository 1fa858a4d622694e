"""Enhanced decoder Fea2GS_ROPE_AMP (counterpart of
`gsasr_tpu/models/fea2gs_rope.py`): LR features -> (B, N, 9) raw Gaussian
parameters.

Differences from the paper decoder (`fea2gs.py`), as in the reference
`utils/fea2gsropeamp.py:518-719`:

- no relative-position bias tables: mixed RoPE rotates q and k by
  ``angle = t_x freq_x + t_y freq_y`` over the row-major flattened token
  lattice, with learnable per-head 2D frequencies `rope_freqs` (2, nh,
  hd/2);
- each cross- and self-attention block ends with a 3x3 conv on the
  re-assembled seed lattice, and the decoder with `conv_final` plus a long
  residual from the post-cross-attention query;
- channel 192 by default.

The modules hold the reference `state_dict` keys (the ones
`gsasr_tpu/utils/torch_convert.py::convert_fea2gs_rope` reads).
`Fea2GSRopeAMP.forward` is the differentiable module path (training's
default): LayerNorms, linears and convolutions are PyTorch ops and every
window attention goes through `window_attention_packed` without a bias
(kernels W and WB on the card in float32, W-bf16 and WB-bf16 in bfloat16).
`Fea2GSRopeAMP(dtype=torch.bfloat16)` is the Enhanced recipes' module path
(`gsasr_tpu/models/fea2gs_rope.py:341-440`): float32 parameters; the
embeddings cast to bfloat16; the scale MLP, feature projection, blocks,
lattice convs, `conv_final` and UPNet in bfloat16 (flax's `dtype=`, see
`common.py`); RoPE phases and rotations in float32, rounded back; the heads
in float32 with `fp32_heads`; `q_mean` and the concatenation in float32.
Inference takes the fused path of `fea2gs_rope_fast.py`, whose types do not
depend on the module's.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from gsasr_torch.models.common import Conv2d, Linear
from gsasr_torch.models.fea2gs import (GSSelfAttnLayer, WindowCrossAttnLayer,
                                       _add_front, _add_tail, _Block,
                                       conv_nhwc, decode_full_lattice,
                                       to_lattice, window_partition)
from gsasr_torch.ops.attention import window_attention_packed


def rope_t_xy(end_x: int, end_y: int, device=None):
    """Row-major lattice coordinates (`fea2gsropeamp.py:84-89`): (t_x, t_y),
    each (end_x * end_y,) float32, made on `device` (no host copy)."""
    t = torch.arange(end_x * end_y, dtype=torch.float32, device=device)
    return t % end_x, torch.floor(t / end_x)


def rope_freqs_init(head_dim: int, num_heads: int, theta: float = 10.0, *,
                    generator=None) -> torch.Tensor:
    """Mixed-RoPE frequencies (`fea2gsropeamp.py:91-105`): (2, num_heads,
    head_dim // 2) float32 [freqs_x, freqs_y], one random angle per head
    drawn from `generator`."""
    mag = 1.0 / (theta ** (torch.arange(0, head_dim, 4)[: head_dim // 4]
                           .float() / head_dim))
    angles = torch.rand(num_heads, 1, generator=generator) * 2 * math.pi
    fx = torch.cat([mag * torch.cos(angles),
                    mag * torch.cos(math.pi / 2 + angles)], dim=-1)
    fy = torch.cat([mag * torch.sin(angles),
                    mag * torch.sin(math.pi / 2 + angles)], dim=-1)
    return torch.stack([fx, fy])


def rope_phases(freqs, t_x, t_y):
    """(2, nh, hd/2) frequencies x (N,) coordinates -> (nh, N, hd/2)
    rotation angles, f32."""
    fx, fy = freqs[0].float(), freqs[1].float()
    return (t_x[None, :, None] * fx[:, None, :]
            + t_y[None, :, None] * fy[:, None, :])


def apply_rope(x, phases):
    """Rotate feature pairs of x (B, nh, N, hd) by phases (nh, N', hd/2),
    N' >= N, in f32, cast back (the oracle of `apply_rope_packed`)."""
    b, nh, n, hd = x.shape
    xf = x.float().reshape(b, nh, n, hd // 2, 2)
    cos, sin = torch.cos(phases[:, :n])[None], torch.sin(phases[:, :n])[None]
    real = xf[..., 0] * cos - xf[..., 1] * sin
    imag = xf[..., 0] * sin + xf[..., 1] * cos
    return torch.stack([real, imag], dim=-1).reshape(b, nh, n, hd).to(x.dtype)


def apply_rope_packed(x, phases, num_heads: int):
    """RoPE on packed (B, N, C) operands, C = nh * hd in MultiheadAttention
    head packing, by phases (nh, N', hd/2), N' >= N; f32, cast back."""
    b, n, c = x.shape
    hdh = phases.shape[2]
    xf = x.float().reshape(b, n, num_heads, hdh, 2)
    ph = phases[:, :n].transpose(0, 1)[None]  # (1, n, nh, hdh)
    cos, sin = torch.cos(ph), torch.sin(ph)
    real = xf[..., 0] * cos - xf[..., 1] * sin
    imag = xf[..., 0] * sin + xf[..., 1] * cos
    return torch.stack([real, imag], dim=-1).reshape(b, n, c).to(x.dtype)


class _RopeAttn(nn.Module):
    """q/k/v heads and out-projection in `dtype`, and RoPE frequencies over
    an end x end token lattice."""

    def __init__(self, dim: int, num_heads: int, end: int,
                 rope_theta: float = 10.0, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.end = end
        self.rope_theta = rope_theta
        self.rope_freqs = nn.Parameter(
            torch.empty(2, num_heads, dim // num_heads // 2))
        self.qhead = Linear(dim, dim, dtype)
        self.khead = Linear(dim, dim, dtype)
        self.vhead = Linear(dim, dim, dtype)
        self.proj = Linear(dim, dim, dtype)

    def phases(self):
        """(nh, end^2, hd/2) rotation angles of the lattice's tokens."""
        return rope_phases(self.rope_freqs,
                           *rope_t_xy(self.end, self.end,
                                      self.rope_freqs.device))

    def attend(self, x, src):
        """proj(MHA(q = rope(x), k = rope(src), v = src)) on packed (B_, T,
        C), no bias; the rotations in f32, rounded to the projections'
        type."""
        ph, nh = self.phases(), self.num_heads
        out = window_attention_packed(
            apply_rope_packed(self.qhead(x), ph, nh),
            apply_rope_packed(self.khead(src), ph, nh), self.vhead(src),
            None, num_heads=nh)
        return self.proj(out)


class RopeWindowCrossAttn(_RopeAttn):
    """`fea2gsropeamp.py:185-250`: Q = seeds, K/V = feature window, both
    rotated on the max(sqrt(num_gs_seed), window_size) lattice."""

    def __init__(self, dim, num_heads, window_size, num_gs_seed,
                 rope_theta: float = 10.0, dtype=torch.float32):
        super().__init__(dim, num_heads,
                         max(math.isqrt(num_gs_seed), window_size),
                         rope_theta, dtype)

    def forward(self, gs, feat):
        return self.attend(gs, feat)


class RopeGSSelfAttn(_RopeAttn):
    """`fea2gsropeamp.py:352-417`: windowed self-attention over the seed
    lattice."""

    def __init__(self, dim, num_heads, num_gs_seed_sqrt,
                 rope_theta: float = 10.0, dtype=torch.float32):
        super().__init__(dim, num_heads, num_gs_seed_sqrt, rope_theta, dtype)

    def forward(self, gs):
        return self.attend(gs, gs)


class RopeWindowCrossAttnLayer(WindowCrossAttnLayer):
    """`fea2gsropeamp.py:253-309`: the paper layer with RoPE attention."""

    def __init__(self, dim, num_heads, window_size, num_gs_seed,
                 shift_size: int = 0, rope_theta: float = 10.0,
                 dtype=torch.float32):
        super().__init__(dim, num_heads, window_size, num_gs_seed, shift_size,
                         attn=RopeWindowCrossAttn(dim, num_heads, window_size,
                                                  num_gs_seed, rope_theta,
                                                  dtype), dtype=dtype)


class RopeGSSelfAttnLayer(GSSelfAttnLayer):
    """`fea2gsropeamp.py:420-478`: the paper layer with RoPE attention."""

    def __init__(self, dim, num_heads, num_gs_seed_sqrt, shift_size: int = 0,
                 rope_theta: float = 10.0, dtype=torch.float32):
        super().__init__(dim, num_heads, num_gs_seed_sqrt, shift_size,
                         attn=RopeGSSelfAttn(dim, num_heads, num_gs_seed_sqrt,
                                             rope_theta, dtype), dtype=dtype)


class _RopeBlock(_Block):
    """norm -> layers -> mlp (Linear, ReLU, Linear) -> 3x3 conv on the seed
    lattice -> + residual (`fea2gsropeamp.py:312-348, 481-515`), in
    `dtype`."""

    def __init__(self, dim, nsq: int, layers, dtype=torch.float32):
        super().__init__(dim, layers, dtype)
        self.nsq = nsq
        self.conv = Conv2d(dim, dim, 3, padding=1, dtype=dtype)

    def forward(self, x, h_count: int, w_count: int, *layer_args):
        y = self.norm(x)
        for layer in self.blocks:
            y = layer(y, *layer_args)
        b = x.shape[0] // (h_count * w_count)
        lat = to_lattice(self.mlp(y), b, h_count, w_count, self.nsq)
        return x + window_partition(conv_nhwc(self.conv, lat), self.nsq)


class RopeWindowCrossAttnBlock(_RopeBlock):
    """`fea2gsropeamp.py:312-348`; forward(x, h_count, w_count, query_pos,
    feat, scale_embedding)."""

    def __init__(self, dim, window_size, num_heads, num_layers, num_gs_seed,
                 rope_theta: float = 10.0, dtype=torch.float32):
        super().__init__(dim, math.isqrt(num_gs_seed), [
            RopeWindowCrossAttnLayer(
                dim, num_heads, window_size, num_gs_seed,
                shift_size=0 if i % 2 == 0 else window_size // 2,
                rope_theta=rope_theta, dtype=dtype)
            for i in range(num_layers)], dtype)


class RopeGSSelfAttnBlock(_RopeBlock):
    """`fea2gsropeamp.py:481-515`; forward(x, h_count, w_count, h_count,
    w_count, scale_embedding)."""

    def __init__(self, dim, num_heads, num_layers, num_gs_seed_sqrt,
                 rope_theta: float = 10.0, dtype=torch.float32):
        nsq = num_gs_seed_sqrt
        super().__init__(dim, nsq, [
            RopeGSSelfAttnLayer(dim, num_heads, nsq,
                                shift_size=0 if i % 2 == 0 else nsq // 2,
                                rope_theta=rope_theta, dtype=dtype)
            for i in range(num_layers)], dtype)


class Fea2GSRopeAMP(nn.Module):
    """Enhanced decoder (`fea2gsropeamp.py:518-719`): (B, h, w, inchannel)
    NHWC features with h, w divisible by window_size, and (B,) scales ->
    (B, N, 9) raw Gaussian parameters in float32. The module path computes
    in `dtype`, with the heads in float32 when `fp32_heads` (the recipes'
    default; False gives the reference autocast's all-bf16 heads)."""

    def __init__(self, inchannel: int = 64, channel: int = 192,
                 num_heads: int = 6, num_crossattn_blocks: int = 1,
                 num_crossattn_layers: int = 2, num_selfattn_blocks: int = 6,
                 num_selfattn_layers: int = 6, num_gs_seed: int = 144,
                 gs_up_factor: float = 1.0, window_size: int = 12,
                 shuffle_scale1: int = 2, shuffle_scale2: int = 2,
                 rope_theta: float = 10.0, dtype=torch.float32,
                 fp32_heads: bool = True):
        super().__init__()
        ch = channel
        nsq = math.isqrt(num_gs_seed)
        _add_front(self, inchannel, ch, num_heads, num_gs_seed, gs_up_factor,
                   window_size, shuffle_scale1, shuffle_scale2, dtype)
        self.window_crossattn_blocks = nn.ModuleList(
            RopeWindowCrossAttnBlock(ch, window_size, num_heads,
                                     num_crossattn_layers, num_gs_seed,
                                     rope_theta, dtype)
            for _ in range(num_crossattn_blocks))
        self.gs_selfattn_blocks = nn.ModuleList(
            RopeGSSelfAttnBlock(ch, num_heads, num_selfattn_layers, nsq,
                                rope_theta, dtype)
            for _ in range(num_selfattn_blocks))
        self.conv_final = Conv2d(ch, ch, 3, padding=1, dtype=dtype)
        _add_tail(self, torch.float32 if fp32_heads else dtype)

    def forward(self, srcs, scale):
        """(B, h, w, inchannel) features, (B,) scales -> (B, N, 9)."""
        b, h, w, _ = srcs.shape
        ws = self.window_size
        nsq = math.isqrt(self.num_gs_seed)
        h_count, w_count = h // ws, w // ws
        nwin = h_count * w_count
        dt = self.dtype
        query = self.gs_embedding.to(dt)[None].expand(b * nwin, -1, -1)
        query_pos = self.pos_embedding.to(dt)
        se = self.scale_mlp((1.0 / scale)[:, None].to(dt))
        # (B_, C); a plain sum backward, where repeat_interleave's is an
        # index-add (atomics on the card)
        scale_embedding = se[:, None].expand(b, nwin, self.channel).reshape(
            b * nwin, self.channel)
        feat = conv_nhwc(self.img_feat_proj, srcs)
        for blk in self.window_crossattn_blocks:
            query = blk(query, h_count, w_count, query_pos, feat,
                        scale_embedding)
        resi = query
        for blk in self.gs_selfattn_blocks:
            query = blk(query, h_count, w_count, h_count, w_count,
                        scale_embedding)
        lat = conv_nhwc(self.conv_final,
                        to_lattice(query, b, h_count, w_count, nsq))
        lat = lat + to_lattice(resi, b, h_count, w_count, nsq)
        return decode_full_lattice(self, lat, b, h_count, w_count, dt,
                                   self.head_dtype)
