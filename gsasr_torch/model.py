"""End-to-end GSASR assembly: encoder -> decoder -> rasterizer (counterpart
of `gsasr_tpu/model.py`: the EDSR, RDN, SwinIR and HAT-L encoders with the
paper Fea2GS or the Enhanced Fea2GSRopeAMP decoder; HAT-L with the
Enhanced one is the Ultra model).

Single-image inference: reflect-pad the LR image to a denominator
multiple (`DENOMINATORS`: 24 for paper SwinIR, whose windows of 8 must
tile its decoder's windows of 12; 16 for HAT-L and the window-16 Enhanced
decoders), encode, decode on the fused path (kernels M and A; the Enhanced
trunk in bf16 by default), render each image at floor(scale * padded
size), crop to floor(scale * size).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from gsasr_torch import resolve_device
from gsasr_torch.models import (EDSRNOUP, HATNOUP, RDNNOUP, Fea2GS,
                                Fea2GSRopeAMP, SwinIRNOUP)
from gsasr_torch.models.fea2gs_fast import fea2gs_apply_fused
from gsasr_torch.models.fea2gs_rope_fast import fea2gs_rope_apply_fused
from gsasr_torch.models.init import init_weights
from gsasr_torch.rendering import render_gaussians

DENOMINATORS = {"edsr": 12, "rdn": 12, "swinir": 24, "hat": 16}
_ENCODERS = {"edsr": EDSRNOUP, "rdn": RDNNOUP, "swinir": SwinIRNOUP,
             "hat": HATNOUP}
# The Enhanced (and Ultra) decoder of each encoder, `gsasr_tpu/model.py`'s
# enhanced_cfg: SwinIR's and HAT-L's take 256 seeds in windows of 16
# (`cli/infer.py` pads them to 16), HAT-L's is the Ultra model's.
ENHANCED_CFG = {
    "edsr": {},
    "rdn": dict(num_crossattn_blocks=2),
    "swinir": dict(num_crossattn_blocks=2, num_crossattn_layers=4,
                   num_gs_seed=256, window_size=16),
    "hat": dict(channel=192, num_crossattn_blocks=4, num_crossattn_layers=4,
                num_selfattn_blocks=8, num_selfattn_layers=6,
                num_gs_seed=256, window_size=16),
}


def _reflect_index(n: int, total: int, device) -> torch.Tensor:
    """Source indices of a reflect pad of an n-long axis to `total`,
    repeating the reflection when the pad exceeds n - 1 (as numpy and
    jnp.pad do; torch's reflect pad refuses that case)."""
    i = torch.arange(total, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    j = i % period
    return torch.where(j < n, j, period - j)


def pad_to_denominator(img, denom: int):
    """Reflect-pad (B, H, W, C) so H and W are multiples of denom.
    Returns (padded, (h, w))."""
    b, h, w, c = img.shape
    ph = (denom - h % denom) % denom
    pw = (denom - w % denom) % denom
    if ph:
        img = img[:, _reflect_index(h, h + ph, img.device)]
    if pw:
        img = img[:, :, _reflect_index(w, w + pw, img.device)]
    return img, (h, w)


def make_models(encoder: str = "edsr", version: str = "paper", *,
                dtype=torch.float32, decoder_kwargs: Optional[dict] = None,
                generator: Optional[torch.Generator] = None, device=None):
    """Build (encoder, decoder) with seeded reference initializers, in eval
    mode on `device` (default: the CUDA card). encoder: 'edsr', 'rdn',
    'swinir' or 'hat' (HAT-L); version: 'paper' (Fea2GS) or 'enhanced' /
    'ultra' (Fea2GSRopeAMP with the encoder's settings, `ENHANCED_CFG`;
    HAT-L's is the Ultra model). dtype: the modules' compute type on float32
    parameters, `gsasr_tpu/model.py`'s keyword; torch.bfloat16 (the
    reference's --AMP_test) is taken by every encoder and both decoders
    (inference runs the paper decoder's fused trunk in float32 all the
    same, `fused_dtype`). decoder_kwargs override the decoder's settings (after
    `ENHANCED_CFG`), as in JAX. Callers pad with `DENOMINATORS[encoder]`
    (`sr_forward(..., denominator=...)`), 16 for the window-16 decoders of
    SwinIR and HAT-L."""
    dev = resolve_device(device)
    if encoder not in _ENCODERS:
        raise NotImplementedError(f"encoder '{encoder}'")
    if version not in ("paper", "enhanced", "ultra"):
        raise NotImplementedError(f"version '{version}'")
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"dtype {dtype}")
    kw = {} if dtype == torch.float32 else dict(dtype=dtype)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    # Module constructors draw PyTorch's default init from the global RNG;
    # fork it so building a model leaves that state alone. All kept values
    # come from `generator`.
    with torch.random.fork_rng(devices=[]):
        enc = _ENCODERS[encoder](**kw)
        dkw = dict(decoder_kwargs or {})
        dec = (Fea2GS(**dkw, **kw) if version == "paper" else
               Fea2GSRopeAMP(**{**ENHANCED_CFG[encoder], **dkw}, **kw))
    init_weights(enc, generator)
    init_weights(dec, generator)
    return enc.to(dev).eval(), dec.to(dev).eval()


def _lat_hw(dec, ph: int, pw: int):
    """Decoder-lattice dims for a (ph, pw) input."""
    f = (math.isqrt(dec.num_gs_seed) / dec.window_size
         * dec.shuffle_scale1 * dec.shuffle_scale2)
    lh, lw = int(round(ph * f)), int(round(pw * f))
    return (lh, lw) if lh > 0 and lw > 0 else None


def fused_dtype(dec):
    """The decoder trunk's default type: bf16 for the Enhanced family (the
    reference's AMP semantics), fp32 for the paper one (its evaluation
    protocol); `gsasr_tpu/model.py::_fused_dtype` without its environment
    override."""
    return torch.bfloat16 if isinstance(dec, Fea2GSRopeAMP) else \
        torch.float32


@torch.no_grad()
def sr_forward(enc, dec, lq, scale: float, *, sr_size=None,
               denominator: int = 12, dmax_mode: str = "fix",
               dmax: float = 0.1, device=None, trunk_dtype=None):
    """Full-image SR forward of one batch at one scale.

    lq: (B, H, W, 3) in [0, 1] (tensor or array), moved to `device`
    (default: the CUDA card), where enc and dec must already be. The
    decoder runs on its fused path with its trunk in `trunk_dtype`
    (torch.float32 or torch.bfloat16; default `fused_dtype(dec)`). Renders
    with the tile rasterizer under `dmax_mode` and `dmax`. Returns
    (B, H_sr, W_sr, 3), (H_sr, W_sr) = `sr_size`, by default
    (floor(scale * H), floor(scale * W)), as JAX's."""
    dev = resolve_device(device)
    for mod in (enc, dec):
        p = next(mod.parameters())
        if p.device.type != dev.type:
            raise ValueError(f"{type(mod).__name__} is on {p.device}, "
                             f"the forward runs on {dev}")
    lq = torch.as_tensor(np.asarray(lq) if not torch.is_tensor(lq) else lq,
                         dtype=torch.float32).to(dev)
    b, h, w, _ = lq.shape
    if sr_size is None:
        sr_size = (math.floor(h * scale), math.floor(w * scale))
    padded, _ = pad_to_denominator(lq, denominator)
    ph, pw = padded.shape[1], padded.shape[2]
    pad_sr = (math.floor(ph * scale), math.floor(pw * scale))
    feat = enc(padded)
    scales = torch.full((b,), scale, dtype=torch.float32, device=dev)
    dt = fused_dtype(dec) if trunk_dtype is None else trunk_dtype
    fused = (fea2gs_rope_apply_fused if isinstance(dec, Fea2GSRopeAMP)
             else fea2gs_apply_fused)
    gs = fused(dec, feat, scales, None if dt == torch.float32 else dt)
    lat = _lat_hw(dec, ph, pw)
    img = torch.stack([render_gaussians(pad_sr, gs[i], scale,
                                        dmax_mode=dmax_mode, dmax=dmax,
                                        lat_hw=lat, device=dev)
                       for i in range(b)])
    return img.permute(0, 2, 3, 1)[:, :sr_size[0], :sr_size[1], :]
