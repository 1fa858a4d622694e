"""Fused inference path of the paper Fea2GS decoder (counterpart of
`gsasr_tpu/models/fea2gs_fast.py`), in float32.

Every [scale-inject -> FFN], [pre-norm attention -> proj] and block-tail
chain is one call of `ln_mlp_residual` or `ln_attn_proj` (kernels M and A
on the card). Shifted self-attention layers roll the lattice, run the
uniform kernel, un-roll its output and then add the residual, which is
exact because LN commutes with the roll. Convolutions, the scale MLP and
the heads are plain PyTorch ops.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gsasr_torch.models.common import pixel_shuffle
from gsasr_torch.models.fea2gs import reference_points, window_partition
from gsasr_torch.ops.fused_layers import ln_attn_proj, ln_mlp_residual


def _mlp(m):
    return dict(w1=m.fc1.weight, b1=m.fc1.bias, w2=m.fc2.weight,
                b2=m.fc2.bias)


def _seq_mlp(seq):
    return dict(w1=seq[0].weight, b1=seq[0].bias, w2=seq[2].weight,
                b2=seq[2].bias)


def _attn(a):
    return dict(wq=a.qhead.weight, bq=a.qhead.bias, wk=a.khead.weight,
                bk=a.khead.bias, wv=a.vhead.weight, bv=a.vhead.bias,
                wo=a.proj.weight, bo=a.proj.bias)


def _ln(norm):
    return dict(ln_w=norm.weight, ln_b=norm.bias)


def _to_lattice(gs, b, h_count, w_count, nsq, ch):
    full = gs.reshape(b, h_count, w_count, nsq, nsq, ch)
    return full.permute(0, 1, 3, 2, 4, 5).reshape(b, h_count * nsq,
                                                  w_count * nsq, ch)


def _conv_nhwc(conv, x):
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@torch.no_grad()
def fea2gs_apply_fused(m, srcs, scale):
    """(B, h, w, inchannel) features, (B,) scales -> (B, N, 9)."""
    b, h, w, _ = srcs.shape
    ws = m.window_size
    ch = m.channel
    nh = m.num_heads
    nsq = math.isqrt(m.num_gs_seed)
    h_count, w_count = h // ws, w // ws
    nwin = h_count * w_count

    query = m.gs_embedding[None].expand(b * nwin, -1, -1).contiguous()
    query_pos = m.pos_embedding
    se = m.scale_mlp((1.0 / scale)[:, None])
    scale_embedding = se.repeat_interleave(nwin, dim=0)  # (B_, C)
    feat = m.img_feat_proj(srcs.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    for blk in m.window_crossattn_blocks:
        resi_block = query
        x = F.layer_norm(query, (ch,), blk.norm.weight, blk.norm.bias, 1e-5)
        for li, lyr in enumerate(blk.blocks):
            shift = 0 if li % 2 == 0 else ws // 2
            inj = lyr.gs_cross_attn_scale(scale_embedding)
            x = ln_mlp_residual(x, inj=inj, **_mlp(lyr.mlp_crossattn_scale),
                                **_ln(lyr.norm2))
            f = feat
            if shift > 0:
                f = torch.roll(f, (-shift, -shift), dims=(1, 2))
            attn = lyr.window_cross_attn
            a = ln_attn_proj(x, pos=query_pos, kv=window_partition(f, ws),
                             bias=attn.bias(), num_heads=nh, **_attn(attn),
                             **_ln(lyr.norm3))
            x = x + a
            x = ln_mlp_residual(x, **_mlp(lyr.mlp_crossattn_feature),
                                **_ln(lyr.norm4))
        query = ln_mlp_residual(x, resi=resi_block, **_seq_mlp(blk.mlp))

    resi_outer = query
    for blk in m.gs_selfattn_blocks:
        resi_block = query
        x = F.layer_norm(query, (ch,), blk.norm.weight, blk.norm.bias, 1e-5)
        for li, lyr in enumerate(blk.blocks):
            shift = 0 if li % 2 == 0 else nsq // 2
            inj = lyr.gs_cross_attn_scale(scale_embedding)
            x = ln_mlp_residual(x, inj=inj, **_mlp(lyr.mlp_crossattn),
                                **_ln(lyr.norm4))
            attn = lyr.gs_self_attn
            kw = dict(bias=attn.bias(), num_heads=nh, **_attn(attn),
                      **_ln(lyr.norm1))
            if shift > 0:
                full = _to_lattice(x, b, h_count, w_count, nsq, ch)
                full = torch.roll(full, (-shift, -shift), dims=(1, 2))
                a = ln_attn_proj(window_partition(full, nsq), **kw)
                full = _to_lattice(a, b, h_count, w_count, nsq, ch)
                full = torch.roll(full, (shift, shift), dims=(1, 2))
                a = window_partition(full, nsq)
            else:
                a = ln_attn_proj(x, **kw)
            x = x + a
            x = ln_mlp_residual(x, **_mlp(lyr.mlp_selfattn), **_ln(lyr.norm2))
        query = ln_mlp_residual(x, resi=resi_block, **_seq_mlp(blk.mlp))
    query = query + resi_outer

    query = _to_lattice(query, b, h_count, w_count, nsq, ch)
    query = _conv_nhwc(m.UPNet[0], query)
    query = pixel_shuffle(query, m.shuffle_scale1)
    query = _conv_nhwc(m.UPNet[2], query)
    query = pixel_shuffle(query, m.shuffle_scale2)

    guf = int(m.gs_up_factor)
    q_sigma = m.mlp_block_sigma(query).reshape(b, -1, 2 * guf)
    q_rho = m.mlp_block_rho(query).reshape(b, -1, guf)
    q_alpha = m.mlp_block_alpha(query).reshape(b, -1, guf)
    q_rgb = m.mlp_block_rgb(query).reshape(b, -1, 3 * guf)
    q_mean = m.mlp_block_mean(query).reshape(b, -1, 2 * guf)

    lat_h = nsq * h_count * m.shuffle_scale1 * m.shuffle_scale2
    lat_w = nsq * w_count * m.shuffle_scale1 * m.shuffle_scale2
    q_mean = q_mean / torch.tensor([[lat_w, lat_h]], dtype=q_mean.dtype,
                                   device=q_mean.device)
    q_mean = q_mean + reference_points(lat_h, lat_w, q_mean.dtype,
                                       q_mean.device)[None]
    return torch.cat([q_sigma, q_rho, q_alpha, q_rgb, q_mean], dim=-1)
