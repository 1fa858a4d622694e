"""Fused path of the Enhanced `Fea2GSRopeAMP` decoder (counterpart of
`gsasr_tpu/models/fea2gs_rope_fast.py`), for inference and training.

Every [scale-inject -> FFN], [pre-norm RoPE attention -> proj] and
block-tail MLP is one call of `ln_mlp_residual` or `ln_attn_proj` (kernels
M and A on the card forward, MB and AB backward; A-long and AB-long at 256
seeds in windows of 16, the Ultra and SwinIR-Enhanced decoders), with the
RoPE rotations
inside A in f32 on pair-duplicated cos/sin tables built per layer from the
learnable frequencies under autograd: AB's table gradients reach
`rope_freqs` through them. The 3x3 lattice convolutions (block tails and
conv_final), the scale MLP, UPNet and the heads are PyTorch ops.

dtype=torch.bfloat16 runs the trunk in bf16 and UPNet and the heads in
fp32, the reference's AMP semantics for this family, whatever compute type
the module was built with. The function rounds
where the JAX fast path rounds: the scale MLP and the inject round their
results (f32 products of rounded inputs), convolutions run in the trunk
type, residual adds are bf16 adds, the block norms are f32 LayerNorms with
a bf16 result, and the lattice is widened to f32 after its long residual.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gsasr_torch.models.fea2gs import (decode_full_lattice, to_lattice,
                                       window_partition)
from gsasr_torch.models.fea2gs_fast import _attn, _ln, _ln_plain, _mlp, \
    _seq_mlp
from gsasr_torch.models.fea2gs_rope import rope_phases, rope_t_xy
from gsasr_torch.ops.fused_layers import ln_attn_proj, ln_mlp_residual


def _convd(conv, x, dtype):
    """3x3 NHWC conv in the trunk type: operands cast to it, the bias added
    in it."""
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), conv.weight.to(dtype),
                 padding=1)
    return y.permute(0, 2, 3, 1) + conv.bias.to(dtype)


def _dense(lin, x):
    """An f32 Linear of a (possibly bf16) input, as JAX promotes it."""
    return F.linear(x.float(), lin.weight, lin.bias)


def rope_tables(freqs, end: int, n: int):
    """Learnable frequencies (2, nh, hd/2) -> pair-duplicated (n, C) cos and
    sin tables of the first n tokens of the end x end lattice, on the
    frequencies' device, differentiable in the frequencies."""
    ph = rope_phases(freqs, *rope_t_xy(end, end, freqs.device))[:, :n]

    def expand(t):
        return t.repeat_interleave(2, dim=-1).transpose(0, 1).reshape(n, -1)

    return expand(torch.cos(ph)), expand(torch.sin(ph))


def fea2gs_rope_apply_fused(m, srcs, scale, dtype=None):
    """(B, h, w, inchannel) features, (B,) scales -> (B, N, 9) float32.

    dtype=None runs fp32 end to end; dtype=torch.bfloat16 a bf16 trunk with
    fp32 UPNet and heads."""
    b, h, w, _ = srcs.shape
    ws = m.window_size
    ch = m.channel
    nh = m.num_heads
    t = m.num_gs_seed
    nsq = math.isqrt(t)
    h_count, w_count = h // ws, w // ws
    nwin = h_count * w_count
    dt = torch.float32 if dtype is None else dtype
    end_cross = max(nsq, ws)

    query = m.gs_embedding.to(dt)[None].expand(b * nwin, -1, -1)
    query_pos = m.pos_embedding.to(dt)
    inv_scale = (1.0 / scale)[:, None].to(dt)
    se = torch.relu(_dense(m.scale_mlp[0], inv_scale).to(dt))
    se = _dense(m.scale_mlp[2], se).to(dt)
    # (B_, C), as in fea2gs_fast.py
    scale_embedding = se[:, None].expand(b, nwin, ch).reshape(b * nwin, ch)
    feat = torch.relu(_convd(m.img_feat_proj[0], srcs, dt))
    feat = _convd(m.img_feat_proj[2], feat, dt)

    se32 = scale_embedding.float()

    def inject(lyr):
        return lyr.gs_cross_attn_scale(se32, torch.float32).to(dt)

    def tail(blk, x, resi):
        z = ln_mlp_residual(x, zero_base=True, **_seq_mlp(blk.mlp))
        lat = _convd(blk.conv, to_lattice(z, b, h_count, w_count, nsq), dt)
        return resi + window_partition(lat, nsq)

    for blk in m.window_crossattn_blocks:
        x = _ln_plain(blk.norm, query)
        for li, lyr in enumerate(blk.blocks):
            shift = 0 if li % 2 == 0 else ws // 2
            x = ln_mlp_residual(x, inj=inject(lyr),
                                **_mlp(lyr.mlp_crossattn_scale),
                                **_ln(lyr.norm2))
            f = feat
            if shift > 0:
                f = torch.roll(f, (-shift, -shift), dims=(1, 2))
            attn = lyr.window_cross_attn
            # q takes the first t rows, k the first ws^2: the table has
            # max(t, ws^2) rows (the JAX fast path cuts it to t); autograd
            # sums the two slices' gradients into the one table
            cos, sin = rope_tables(attn.rope_freqs, end_cross,
                                   max(t, ws * ws))
            a = ln_attn_proj(x, pos=query_pos, kv=window_partition(f, ws),
                             num_heads=nh, rope_cos_q=cos[:t],
                             rope_sin_q=sin[:t], rope_cos_k=cos[:ws * ws],
                             rope_sin_k=sin[:ws * ws], **_attn(attn),
                             **_ln(lyr.norm3))
            x = x + a
            x = ln_mlp_residual(x, **_mlp(lyr.mlp_crossattn_feature),
                                **_ln(lyr.norm4))
        query = tail(blk, x, query)

    resi_outer = query
    for blk in m.gs_selfattn_blocks:
        x = _ln_plain(blk.norm, query)
        for li, lyr in enumerate(blk.blocks):
            shift = 0 if li % 2 == 0 else nsq // 2
            x = ln_mlp_residual(x, inj=inject(lyr),
                                **_mlp(lyr.mlp_crossattn), **_ln(lyr.norm4))
            attn = lyr.gs_self_attn
            cos, sin = rope_tables(attn.rope_freqs, nsq, t)
            kw = dict(num_heads=nh, rope_cos_q=cos, rope_sin_q=sin,
                      rope_cos_k=cos, rope_sin_k=sin, **_attn(attn),
                      **_ln(lyr.norm1))
            if shift > 0:
                # LN commutes with the lattice roll (see fea2gs_fast.py)
                full = to_lattice(x, b, h_count, w_count, nsq)
                full = torch.roll(full, (-shift, -shift), dims=(1, 2))
                a = ln_attn_proj(window_partition(full, nsq), **kw)
                full = to_lattice(a, b, h_count, w_count, nsq)
                full = torch.roll(full, (shift, shift), dims=(1, 2))
                a = window_partition(full, nsq)
            else:
                a = ln_attn_proj(x, **kw)
            x = x + a
            x = ln_mlp_residual(x, **_mlp(lyr.mlp_selfattn), **_ln(lyr.norm2))
        query = tail(blk, x, query)

    lat = _convd(m.conv_final, to_lattice(query, b, h_count, w_count, nsq),
                 dt)
    lat = (lat + to_lattice(resi_outer, b, h_count, w_count, nsq)).float()
    return decode_full_lattice(m, lat, b, h_count, w_count)
