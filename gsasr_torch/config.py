"""YAML options -> networks and a `TrainConfig` (counterpart of
`gsasr_tpu/config.py`).

Reads the reference's BasicSR-style options (`network_g`,
`network_fea2gs`, `train`, `datasets`) and `--force_yml`-style dotted
overrides. PyYAML is imported only where a file or an override is parsed.
"""

from __future__ import annotations

import inspect
import math
from typing import Any, Dict, List, Optional

import torch

from gsasr_torch.models import (EDSRNOUP, HATNOUP, RDNNOUP, Fea2GS,
                                Fea2GSRopeAMP, HATNOUPPaper, SwinIRNOUP)
from gsasr_torch.models.init import init_weights
from gsasr_torch.train.trainer import TrainConfig


def load_options(path) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def apply_overrides(opt: Dict[str, Any], overrides: List[str]):
    """`key:sub=value` dotted overrides (reference --force_yml)."""
    import yaml

    for item in overrides or []:
        keys, value = item.split("=", 1)
        value = yaml.safe_load(value)
        node = opt
        parts = keys.replace(":", ".").split(".")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = value
    return opt


# Reference-yaml keys the NOUP modules fix structurally; dropped silently.
_STRUCTURAL = {"upscale", "upsampler", "img_size", "img_range", "in_chans",
               "no_upsampling", "resi_connection", "kSize", "r", "n_colors",
               "num_in_ch", "num_out_ch", "scale", "patch_size", "ape",
               "patch_norm"}
_ENCODERS = {"EDSRNOUP": EDSRNOUP, "EDSR": EDSRNOUP,
             "RDNNOUP": RDNNOUP, "RDN": RDNNOUP,
             "SwinIRNOUP": SwinIRNOUP, "SWINNOUP": SwinIRNOUP,
             "HATNOUP_ROPE_AMP": HATNOUP,
             # the reference's paper HAT (relative-position bias, masked
             # shifts), not the RoPE variant
             "HATNOUP": HATNOUPPaper}
# reference yaml names -> constructor arguments
_RENAME = {"G0": "g0", "RDNconfig": "config"}
_DECODERS = {"Fea2GS": Fea2GS, "Fea2GS_ROPE_AMP": Fea2GSRopeAMP,
             "Fea2GSRopeAMP": Fea2GSRopeAMP}
_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def _adapt(kwargs, cls):
    """Constructor kwargs of `cls` from a yaml block: structural keys are
    dropped, any other unknown key raises (a misspelled hyperparameter must
    not train with the module default)."""
    fields = set(inspect.signature(cls.__init__).parameters) - {"self"}
    out = {}
    for k, v in kwargs.items():
        k = _RENAME.get(k, k)
        if k in fields:
            out[k] = tuple(v) if isinstance(v, list) else v
        elif k not in _STRUCTURAL:
            raise TypeError(f"{cls.__name__}: unknown yaml key {k!r} "
                            f"(known: {sorted(fields)})")
    return out


def build_networks(opt: Dict[str, Any],
                   generator: Optional[torch.Generator] = None):
    """network_g / network_fea2gs -> (encoder, decoder) on the CPU, every
    weight drawn with the reference initializers from `generator` (default:
    seeded with the options' manual_seed). The EDSR, RDN, SwinIR, HAT-L
    (HATNOUP_ROPE_AMP) and paper HAT (HATNOUP) encoders and both decoders
    are ported in float32; `model_dtype: bfloat16` (the default of
    `model_type: GSASRAMPModel`, as in the JAX package) builds any of the
    encoders with the Enhanced decoder in bf16 compute on float32
    parameters (configs/train_hatl_ultra.yml is the Ultra recipe,
    configs/train_swinir_amp.yml SwinIR's)."""
    default = "bfloat16" if "AMP" in str(opt.get("model_type", "")) else \
        "float32"
    model_dtype = str(opt.get("model_dtype", default)).lower()
    if model_dtype not in _DTYPES:
        raise NotImplementedError(
            f"model_dtype {model_dtype!r} (expected one of {sorted(_DTYPES)})")
    dtype = _DTYPES[model_dtype]
    g = dict(opt["network_g"])
    enc_cls = _ENCODERS.get(g.pop("type"))
    d = dict(opt["network_fea2gs"])
    dec_cls = _DECODERS.get(d.pop("type"))
    if enc_cls is None or dec_cls is None:
        raise NotImplementedError(
            f"{opt['network_g']['type']} / {opt['network_fea2gs']['type']}: "
            f"only {sorted(_ENCODERS)} / {sorted(_DECODERS)} are ported yet")
    if dtype == torch.bfloat16:
        if dec_cls is Fea2GS:
            raise NotImplementedError(
                "the paper Fea2GS in bfloat16 (train_edsr_paper_bf16_r3.yml) "
                "is not ported yet: its module path needs a test of W-bf16 "
                "and WB-bf16 with the bias table against JAX")
        g["dtype"] = d["dtype"] = dtype
    if generator is None:
        generator = torch.Generator().manual_seed(
            int(opt.get("manual_seed", 0)))
    # constructors draw PyTorch's default init from the global RNG; fork
    # it so that state is left alone (every kept value comes from generator)
    with torch.random.fork_rng(devices=[]):
        enc = enc_cls(**_adapt(g, enc_cls))
        dec = dec_cls(**_adapt(d, dec_cls))
    return init_weights(enc, generator), init_weights(dec, generator)


def build_train_config(opt: Dict[str, Any]) -> TrainConfig:
    t = opt.get("train", {})
    sched = t.get("scheduler", {})
    optim = t.get("optim_g", {})
    ds = next((v for k, v in opt.get("datasets", {}).items()
               if k.startswith("train")), {})
    lr_size = ds.get("lr_size", 48)
    scale_list = ds.get("scale_list", [1, 4])
    gt_max = math.ceil(scale_list[-1] * lr_size)
    if "clip_grad_norm" in t:
        # the reference key is a boolean gate (clip at norm 5 when true);
        # a number is taken as the norm
        c = t["clip_grad_norm"]
        clip = (5.0 if c is True else float(c)) if c else None
    else:
        clip = 5.0 if t.get("use_grad_clip", True) else None
    ssim_opt = t.get("ssim_opt")
    return TrainConfig(
        lr=float(optim.get("lr", 2e-4)),
        betas=tuple(optim.get("betas", (0.9, 0.99))),
        milestones=tuple(sched.get("milestones", (250000, 400000, 450000,
                                                  475000))),
        gamma=float(sched.get("gamma", 0.5)),
        total_iter=int(t.get("total_iter", 500000)),
        warmup_iter=int(t.get("warmup_iter", -1)),
        ema_decay=float(t.get("ema_decay", 0.999)),
        clip_grad_norm=clip,
        accumulation_steps=int(t.get("accumulation_steps", 1)),
        default_step_size=float(opt.get("default_step_size", 1.2)),
        dmax=float(opt.get("dmax", 0.5)),
        dmax_mode=opt.get("dmax_mode", "fix"),
        if_dmax=bool(opt.get("if_dmax", True)),
        canvas_hw=(gt_max, gt_max),
        ssim_weight=(float(ssim_opt.get("loss_weight", 0.0))
                     if isinstance(ssim_opt, dict) else 0.0),
        seed=int(opt.get("manual_seed", 0)),
        fused_decoder=bool(t.get("fused_decoder", False)),
    )
