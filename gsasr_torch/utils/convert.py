"""JAX parameter trees -> the port's state_dicts: the inverse of
`gsasr_tpu/utils/torch_convert.py`'s `convert_edsr`, `convert_fea2gs` and
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
    """(EDSR params, paper Fea2GS or Enhanced Fea2GSRopeAMP params) ->
    (encoder state_dict, decoder state_dict) with the reference keys. The
    paper decoder's relative_position_index buffers are not parameters and
    are left to the module (see `load_params`)."""
    return _edsr(enc_params), _fea2gs(dec_params)


def load_params(module: torch.nn.Module, state_dict) -> torch.nn.Module:
    """Load a `params_from_jax` state_dict; every parameter must be given,
    and only the relative_position_index buffers may be absent."""
    res = module.load_state_dict(state_dict, strict=False)
    missing = [k for k in res.missing_keys
               if not k.endswith("relative_position_index")]
    if missing or res.unexpected_keys:
        raise KeyError(f"missing {missing}, unexpected {res.unexpected_keys}")
    return module
