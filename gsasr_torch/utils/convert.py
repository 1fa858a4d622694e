"""JAX parameter trees -> the port's state_dicts: the inverse of
`gsasr_tpu/utils/torch_convert.py`'s `convert_edsr`, `convert_rdn`,
`convert_swinir`, `convert_hat`, `convert_hat_paper`, `convert_fea2gs` and
`convert_fea2gs_rope`.

Trees are nested dicts of arrays. Conv kernels (kH, kW, I, O) become
weights (O, I, kH, kW); dense kernels (I, O) become (O, I); LayerNorm
`scale` becomes `weight`; ScaleInject's q_proj_dead, k_proj_dead and v_proj
stack into `in_proj_weight`, with zero q/k biases.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd, key, p):
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{key}.bias"] = _t(p["bias"])


def _dense(sd, key, p):
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{key}.bias"] = _t(p["bias"])


def _ln(sd, key, p):
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])


def _mlp(sd, key, p):
    _dense(sd, f"{key}.fc1", p["fc1"])
    _dense(sd, f"{key}.fc2", p["fc2"])


def _scale_inject(sd, key, p):
    v_b = np.asarray(p["v_proj"]["bias"], np.float32)
    sd[f"{key}.in_proj_weight"] = _t(np.concatenate(
        [p["q_proj_dead"], p["k_proj_dead"], np.asarray(p["v_proj"]["kernel"]).T]))
    sd[f"{key}.in_proj_bias"] = _t(np.concatenate(
        [np.zeros_like(v_b), np.zeros_like(v_b), v_b]))
    _dense(sd, f"{key}.out_proj", p["out_proj"])


def _attn(sd, key, p):
    sd[f"{key}.relative_position_bias_table"] = _t(
        p["relative_position_bias_table"])
    for name in ("qhead", "khead", "vhead", "proj"):
        _dense(sd, f"{key}.{name}", p[name])


def _rope_attn(sd, key, p):
    sd[f"{key}.rope_freqs"] = _t(p["rope_freqs"])
    for name in ("qhead", "khead", "vhead", "proj"):
        _dense(sd, f"{key}.{name}", p[name])


def _count(tree, prefix):
    return sum(1 for k in tree if k.startswith(prefix))


def _edsr(p) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "conv_first", p["conv_first"])
    for i in range(_count(p, "body_")):
        _conv(sd, f"body.{i}.conv1", p[f"body_{i}"]["conv1"])
        _conv(sd, f"body.{i}.conv2", p[f"body_{i}"]["conv2"])
    _conv(sd, "conv_after_body", p["conv_after_body"])
    return sd


def _rdn(p) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for key, name in (("SFENet1", "sfenet1"), ("SFENet2", "sfenet2"),
                      ("GFF.0", "gff_0"), ("GFF.1", "gff_1")):
        _conv(sd, key, p[name])
    for i in range(_count(p, "rdb_")):
        bp = p[f"rdb_{i}"]
        for c in range(_count(bp, "conv_")):
            _conv(sd, f"RDBs.{i}.convs.{c}.conv.0", bp[f"conv_{c}"])
        _conv(sd, f"RDBs.{i}.LFF", bp["lff"])
    return sd


def _swinir(p) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "conv_first", p["conv_first"])
    _ln(sd, "patch_embed.norm", p["patch_embed_norm"])
    for i in range(_count(p, "layer_")):
        lp = p[f"layer_{i}"]
        for j in range(_count(lp, "block_")):
            bp = lp[f"block_{j}"]
            bk = f"layers.{i}.residual_group.blocks.{j}"
            _ln(sd, f"{bk}.norm1", bp["norm1"])
            _ln(sd, f"{bk}.norm2", bp["norm2"])
            sd[f"{bk}.attn.relative_position_bias_table"] = _t(
                bp["attn"]["relative_position_bias_table"])
            _dense(sd, f"{bk}.attn.qkv", bp["attn"]["qkv"])
            _dense(sd, f"{bk}.attn.proj", bp["attn"]["proj"])
            _dense(sd, f"{bk}.mlp.fc1", bp["mlp_fc1"])
            _dense(sd, f"{bk}.mlp.fc2", bp["mlp_fc2"])
        _conv(sd, f"layers.{i}.conv", lp["conv"])
    _ln(sd, "norm", p["norm"])
    _conv(sd, "conv_after_body", p["conv_after_body"])
    _conv(sd, "conv_before_upsample.0", p["conv_before_upsample_0"])
    return sd


def hat_cab(sd, key, p):
    """HAT's CAB (`conv_block`): the reference's `cab` Sequential."""
    _conv(sd, f"{key}.cab.0", p["conv1"])
    _conv(sd, f"{key}.cab.2", p["conv2"])
    _conv(sd, f"{key}.cab.3.attention.1", p["ca"]["fc1"])
    _conv(sd, f"{key}.cab.3.attention.3", p["ca"]["fc2"])


def hat_window_attn(sd, key, p):
    """The attention of a HAB or an OCAB: RoPE frequencies, or (the paper
    HAT's) a relative-position bias table."""
    name = ("relative_position_bias_table"
            if "relative_position_bias_table" in p else "rope_freqs")
    sd[f"{key}.{name}"] = _t(p[name])
    _dense(sd, f"{key}.qkv", p["qkv"])
    _dense(sd, f"{key}.proj", p["proj"])


def hat_hab(sd, key, p):
    """A Hybrid Attention Block."""
    _ln(sd, f"{key}.norm1", p["norm1"])
    _ln(sd, f"{key}.norm2", p["norm2"])
    hat_window_attn(sd, f"{key}.attn", p["attn"])
    hat_cab(sd, f"{key}.conv_block", p["conv_block"])
    _dense(sd, f"{key}.mlp.fc1", p["mlp_fc1"])
    _dense(sd, f"{key}.mlp.fc2", p["mlp_fc2"])


def hat_ocab(sd, key, p):
    """An overlapping cross-attention block."""
    _ln(sd, f"{key}.norm1", p["norm1"])
    _ln(sd, f"{key}.norm2", p["norm2"])
    hat_window_attn(sd, key, p)
    _dense(sd, f"{key}.mlp.fc1", p["mlp_fc1"])
    _dense(sd, f"{key}.mlp.fc2", p["mlp_fc2"])


def hat_rhag(sd, key, p):
    """A Residual Hybrid Attention Group."""
    for j in range(_count(p, "block_")):
        hat_hab(sd, f"{key}.residual_group.blocks.{j}", p[f"block_{j}"])
    hat_ocab(sd, f"{key}.residual_group.overlap_attn", p["overlap_attn"])
    _conv(sd, f"{key}.conv", p["conv"])


def _hat(p) -> Dict[str, torch.Tensor]:
    """A HAT tree, the RoPE HAT-L's or the paper HAT's (the same keys but
    for each attention's bias table in place of its RoPE frequencies)."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "conv_first", p["conv_first"])
    _ln(sd, "patch_embed.norm", p["patch_embed_norm"])
    for i in range(_count(p, "layer_")):
        hat_rhag(sd, f"layers.{i}", p[f"layer_{i}"])
    _ln(sd, "norm", p["norm"])
    _conv(sd, "conv_after_body", p["conv_after_body"])
    _conv(sd, "conv_before_upsample.0", p["conv_before_upsample_0"])
    return sd


def _encoder(p) -> Dict[str, torch.Tensor]:
    """An EDSR, RDN, SwinIR or HAT tree, told apart by its keys (HAT's
    groups end in an overlapping cross-attention block; the RoPE HAT's and
    the paper HAT's attentions hold RoPE frequencies or bias tables)."""
    if "patch_embed_norm" in p:
        return _hat(p) if "overlap_attn" in p["layer_0"] else _swinir(p)
    if "sfenet1" in p:
        return _rdn(p)
    return _edsr(p)


def _fea2gs(p) -> Dict[str, torch.Tensor]:
    """A paper Fea2GS tree, or an Enhanced Fea2GSRopeAMP one (told apart by
    its `conv_final`): RoPE attentions instead of bias tables, and a conv
    at the end of every block."""
    rope = "conv_final" in p
    sd: Dict[str, torch.Tensor] = {
        "gs_embedding": _t(p["gs_embedding"]),
        "pos_embedding": _t(p["pos_embedding"]),
    }
    if rope:
        _conv(sd, "conv_final", p["conv_final"])
    _conv(sd, "img_feat_proj.0", p["img_feat_proj_0"])
    _conv(sd, "img_feat_proj.2", p["img_feat_proj_2"])
    _dense(sd, "scale_mlp.0", p["scale_mlp_0"])
    _dense(sd, "scale_mlp.2", p["scale_mlp_2"])
    _conv(sd, "UPNet.0", p["upnet_0"])
    _conv(sd, "UPNet.2", p["upnet_2"])
    for head in ("sigma", "rho", "alpha", "rgb", "mean"):
        hp = p[f"mlp_block_{head}"]
        for i in (0, 2, 4):
            _dense(sd, f"mlp_block_{head}.{i}", hp[f"fc{i}"])
    for kind, attn_name, mlps in (
            ("window_crossattn_blocks", "window_cross_attn",
             ("mlp_crossattn_scale", "mlp_crossattn_feature")),
            ("gs_selfattn_blocks", "gs_self_attn",
             ("mlp_selfattn", "mlp_crossattn"))):
        for i in range(_count(p, f"{kind}_")):
            bp = p[f"{kind}_{i}"]
            bk = f"{kind}.{i}"
            _ln(sd, f"{bk}.norm", bp["norm"])
            _dense(sd, f"{bk}.mlp.0", bp["mlp_0"])
            _dense(sd, f"{bk}.mlp.2", bp["mlp_2"])
            if rope:
                _conv(sd, f"{bk}.conv", bp["conv"])
            for j in range(_count(bp, "blocks_")):
                lp = bp[f"blocks_{j}"]
                lk = f"{bk}.blocks.{j}"
                for n in ("norm1", "norm2", "norm3", "norm4"):
                    _ln(sd, f"{lk}.{n}", lp[n])
                _scale_inject(sd, f"{lk}.gs_cross_attn_scale",
                              lp["gs_cross_attn_scale"])
                (_rope_attn if rope else _attn)(sd, f"{lk}.{attn_name}",
                                                lp[attn_name])
                for n in mlps:
                    _mlp(sd, f"{lk}.{n}", lp[n])
    return sd


def params_from_jax(enc_params, dec_params):
    """(EDSR, RDN, SwinIR, HAT-L or paper HAT params; paper Fea2GS or
    Enhanced Fea2GSRopeAMP params) -> (encoder state_dict, decoder
    state_dict) with the reference keys. The relative_position_index
    buffers (paper decoder, SwinIR, paper HAT) are not parameters and are
    left to the module (see `load_params`). The `hat_*` functions convert
    one HAT module's tree under a key prefix."""
    return _encoder(enc_params), _fea2gs(dec_params)


def load_params(module: torch.nn.Module, state_dict) -> torch.nn.Module:
    """Load a `params_from_jax` state_dict; every parameter must be given,
    and only the relative_position_index buffers may be absent."""
    res = module.load_state_dict(state_dict, strict=False)
    missing = [k for k in res.missing_keys
               if not k.endswith("relative_position_index")]
    if missing or res.unexpected_keys:
        raise KeyError(f"missing {missing}, unexpected {res.unexpected_keys}")
    return module
