"""Fused path of the paper Fea2GS decoder (counterpart of
`gsasr_tpu/models/fea2gs_fast.py`): inference, and training with
`TrainConfig(fused_decoder=True)` in float32.

Every [scale-inject -> FFN], [pre-norm attention -> proj] and block-tail
chain is one call of `ln_mlp_residual` or `ln_attn_proj` (kernels M and A
on the card forward, MB and AB backward). Shifted self-attention layers
roll the lattice, run the uniform kernel, un-roll its output and then add
the residual, which is exact because LN commutes with the roll.
Convolutions, the scale MLP and the heads are plain PyTorch ops. The
function is differentiable; inference calls it under `torch.no_grad()`.
dtype=torch.bfloat16 runs the trunk (the layer stack) in bf16 and UPNet and
the heads in fp32, as the JAX fast path does, whatever compute type the
module was built with (training with `fused_decoder=True` passes the
module's: `configs/train_edsr_paper_bf16_r3.yml`'s bf16 trunk).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gsasr_torch.models.common import seq_apply
from gsasr_torch.models.fea2gs import (decode_lattice, to_lattice,
                                       window_partition)
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


def _ln_plain(norm, x):
    """LayerNorm in f32, its result in x's type."""
    return F.layer_norm(x.float(), (x.shape[-1],), norm.weight, norm.bias,
                        1e-5).to(x.dtype)


def fea2gs_apply_fused(m, srcs, scale, dtype=None):
    """(B, h, w, inchannel) features, (B,) scales -> (B, N, 9) float32.

    dtype=None runs fp32 end to end; dtype=torch.bfloat16 a bf16 trunk (the
    scale embedding and inject stay f32) with fp32 UPNet and heads."""
    b, h, w, _ = srcs.shape
    ws = m.window_size
    ch = m.channel
    nh = m.num_heads
    nsq = math.isqrt(m.num_gs_seed)
    h_count, w_count = h // ws, w // ws
    nwin = h_count * w_count

    query = m.gs_embedding[None].expand(b * nwin, -1, -1).contiguous()
    query_pos = m.pos_embedding
    # the scale MLP, the feature projection and the inject in f32, whatever
    # the module's compute type, as the JAX fast path computes them (a bf16
    # encoder's features are widened: JAX's f32 convolution refuses them)
    se = seq_apply(m.scale_mlp, (1.0 / scale)[:, None])
    # (B_, C); a plain sum backward, where repeat_interleave's is an
    # index-add (atomics on the card)
    scale_embedding = se[:, None].expand(b, nwin, ch).reshape(b * nwin, ch)
    feat = seq_apply(m.img_feat_proj, srcs.permute(0, 3, 1, 2)).permute(
        0, 2, 3, 1)
    if dtype is not None:
        query, feat = query.to(dtype), feat.to(dtype)

    for blk in m.window_crossattn_blocks:
        resi_block = query
        x = _ln_plain(blk.norm, query)
        for li, lyr in enumerate(blk.blocks):
            shift = 0 if li % 2 == 0 else ws // 2
            inj = lyr.gs_cross_attn_scale(scale_embedding, torch.float32)
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
        x = _ln_plain(blk.norm, query)
        for li, lyr in enumerate(blk.blocks):
            shift = 0 if li % 2 == 0 else nsq // 2
            inj = lyr.gs_cross_attn_scale(scale_embedding, torch.float32)
            x = ln_mlp_residual(x, inj=inj, **_mlp(lyr.mlp_crossattn),
                                **_ln(lyr.norm4))
            attn = lyr.gs_self_attn
            kw = dict(bias=attn.bias(), num_heads=nh, **_attn(attn),
                      **_ln(lyr.norm1))
            if shift > 0:
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
        query = ln_mlp_residual(x, resi=resi_block, **_seq_mlp(blk.mlp))
    return decode_lattice(m, (query + resi_outer).float(), b, h_count,
                          w_count)
