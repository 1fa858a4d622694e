"""The window-16 Enhanced decoder and the models built on it against
gsasr_tpu on the CPU: the Ultra decoder's fused path (256 seeds in windows
of 16) at tiny width and at full width on one window, its module path,
`sr_forward` of a tiny HAT-L Ultra pair and of a tiny SwinIR-Enhanced pair
at denominator 16, and make_models' SwinIR-Enhanced.

The JAX side's decoder runs its Pallas kernels in interpret mode (K7 and
K8, here at T = 256), as its own tests do; its encoders' window
attentions take the JAX package's plain reference (GSASR_ATTN=reference).
The port runs its plain PyTorch versions. Weights are drawn by the port,
read into JAX trees by the JAX package's reference converters and loaded
into fresh port modules with params_from_jax. The decoders keep the Ultra
settings' widths and windows with their depth cut to one cross-attention
and one self-attention block of two layers (the JAX side's interpret-mode
compile grows with the number of kernel calls).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_tpu.models import HATNOUP as JHAT
from gsasr_tpu.models import Fea2GSRopeAMP as JRope
from gsasr_tpu.models import SwinIRNOUP as JSwinIR
from gsasr_tpu.utils.torch_convert import (convert_fea2gs_rope, convert_hat,
                                           convert_swinir)
from gsasr_torch.models import HATNOUP, Fea2GSRopeAMP, SwinIRNOUP
from gsasr_torch.models.fea2gs_rope_fast import fea2gs_rope_apply_fused
from gsasr_torch.models.init import init_weights
from gsasr_torch.utils.convert import load_params, params_from_jax

# the Ultra decoder's windows (256 seeds in windows of 16) at tiny width
TINY16 = dict(inchannel=8, channel=32, num_heads=4, num_crossattn_blocks=1,
              num_crossattn_layers=2, num_selfattn_blocks=1,
              num_selfattn_layers=2, num_gs_seed=256, window_size=16)
# and at the Ultra widths (192 channels, 6 heads of 32, 64 features in)
FULL16 = dict(TINY16, inchannel=64, channel=192, num_heads=6)
TINY_HAT = dict(embed_dim=24, depths=(2,), num_heads=(6,), window_size=4,
                squeeze_factor=4, mlp_ratio=2, num_feat=8)
TINY_SWIN = dict(embed_dim=24, depths=(2,), num_heads=(6,), window_size=4,
                 num_feat=8)
ENCODERS = {"hat": (HATNOUP, JHAT, convert_hat, TINY_HAT),
            "swinir": (SwinIRNOUP, JSwinIR, convert_swinir, TINY_SWIN)}


@pytest.fixture(autouse=True)
def _jax_reference_attention(monkeypatch):
    monkeypatch.setenv("GSASR_ATTN", "reference")


def _pair(encoder, dec_kw, seed):
    """JAX encoder and decoder params drawn by the port's initializers and
    read by the reference converters, and fresh port modules loaded with
    them through params_from_jax."""
    cls, _, conv, enc_kw = ENCODERS[encoder]
    g = torch.Generator().manual_seed(seed)
    ep = conv(init_weights(cls(**enc_kw), g).state_dict())
    dp = convert_fea2gs_rope(
        init_weights(Fea2GSRopeAMP(**dec_kw), g).state_dict())
    esd, dsd = params_from_jax(ep, dp)
    return (ep, dp, load_params(cls(**enc_kw), esd).eval(),
            load_params(Fea2GSRopeAMP(**dec_kw), dsd).eval())


@pytest.mark.parametrize("dec_kw,b,hw,tol", [
    (TINY16, 2, (16, 32), 2e-4), (FULL16, 1, (16, 16), 5e-4)],
    ids=["tiny", "full_width_one_window"])
def test_ultra_decoder_fused_matches_jax(dec_kw, b, hw, tol):
    """fp32 trunk: A at T = 256 (cross-attention on 256 feature tokens,
    self-attention with the odd layers' lattice roll), M, the lattice
    convs, UPNet and the heads; within the JAX package's own bounds for
    its fused-vs-module test, 2e-4 at tiny width and 5e-4 at full width."""
    *_, dp, _, dec = _pair("hat", dec_kw, seed=b)
    rng = np.random.default_rng(b)
    srcs = rng.random((b, *hw, dec_kw["inchannel"]), dtype=np.float32)
    scale = rng.uniform(1.5, 4.0, (b,)).astype(np.float32)
    from gsasr_tpu.models.fea2gs_rope_fast import \
        fea2gs_rope_apply_fused as jfused
    ref = np.asarray(jax.jit(lambda p, x, s: jfused(
        JRope(**dec_kw), {"params": p}, x, s))(
        dp, jnp.asarray(srcs), jnp.asarray(scale)))
    with torch.no_grad():
        out = fea2gs_rope_apply_fused(dec, torch.from_numpy(srcs),
                                      torch.from_numpy(scale)).numpy()
    assert out.shape == ref.shape == (b, 16 * hw[0] * hw[1], 9)
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


def test_ultra_decoder_module_path_matches_jax():
    """The differentiable module path at windows of 16 (every attention of
    256 tokens: W-long's plain version here) against Fea2GSRopeAMP.apply,
    fp32, within the fused test's tiny bound; its backward, once a raise,
    runs WB-long's plain version: every parameter's gradient equals
    autograd through the plain forward (1e-5 of each tensor's largest
    entry: the same float32 products in another order)."""
    *_, dp, _, dec = _pair("hat", TINY16, seed=3)
    rng = np.random.default_rng(3)
    srcs = rng.random((1, 16, 32, 8), dtype=np.float32)
    scale = np.array([2.5], np.float32)
    ref = np.asarray(jax.jit(lambda p, x, s: JRope(**TINY16).apply(
        {"params": p}, x, s))(dp, jnp.asarray(srcs), jnp.asarray(scale)))
    out = dec(torch.from_numpy(srcs), torch.from_numpy(scale))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=2e-4,
                               atol=2e-4)
    from gsasr_torch.models import fea2gs_rope
    from gsasr_torch.ops import attention as ta

    params = [p for p in dec.parameters() if p.requires_grad]
    got = torch.autograd.grad(out.square().sum(), params, allow_unused=True)

    def plain(q, k, v, bias, num_heads):
        return ta.window_attention_packed_plain(
            q, k, v, bias, (q.shape[-1] // num_heads) ** -0.5, num_heads)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fea2gs_rope, "window_attention_packed", plain)
        y = dec(torch.from_numpy(srcs), torch.from_numpy(scale))
        ref = torch.autograd.grad(y.square().sum(), params, allow_unused=True)
    assert sum(g is not None for g in got) > len(params) // 2
    for a, r in zip(got, ref):
        assert (a is None) == (r is None)
        if r is not None:
            torch.testing.assert_close(a, r, rtol=1e-5,
                                       atol=1e-5 * float(r.abs().max()))


@pytest.mark.parametrize("encoder", ["hat", "swinir"])
def test_sr_forward_matches_jax(encoder):
    """sr_forward of a tiny HAT-L Ultra (or SwinIR-Enhanced) pair against
    JAX's sr_forward at denominator 16, both with the family's default
    trunk: bf16, fp32 heads and encoder."""
    from gsasr_tpu.model import sr_forward as jsr_forward
    from gsasr_torch.model import sr_forward

    _, jcls, _, enc_kw = ENCODERS[encoder]
    ep, dp, enc, dec = _pair(encoder, TINY16, seed=5)
    lq = np.random.default_rng(6).random((1, 10, 13, 3), dtype=np.float32)
    ref = np.asarray(jsr_forward(jcls(**enc_kw), JRope(**TINY16), ep, dp,
                                 jnp.asarray(lq), 3.3, denominator=16,
                                 dmax=0.5))
    out = sr_forward(enc, dec, torch.from_numpy(lq), 3.3, denominator=16,
                     dmax=0.5, device="cpu").numpy()
    assert out.shape == ref.shape == (1, math.floor(10 * 3.3),
                                      math.floor(13 * 3.3), 3)
    assert np.isfinite(out).all()
    # the bf16 trunk's one-step rounding differences, through the Gaussians
    # into the image (the Enhanced EDSR bound)
    np.testing.assert_allclose(out, ref, rtol=0, atol=5e-3)


def test_make_models_swinir_enhanced_seeded_and_shaped():
    """make_models("swinir", "enhanced" | "ultra"): SwinIR's encoder with
    the Enhanced decoder of two cross-attention blocks of four layers, 256
    seeds in windows of 16 (`gsasr_tpu/model.py`'s enhanced_cfg), the same
    weights for both names."""
    from gsasr_torch.model import make_models

    enc, dec = make_models("swinir", "enhanced", device="cpu",
                           generator=torch.Generator().manual_seed(0))
    _, dec2 = make_models("swinir", "ultra", device="cpu",
                          generator=torch.Generator().manual_seed(0))
    assert isinstance(enc, SwinIRNOUP) and enc.window_size == 8
    assert isinstance(dec, Fea2GSRopeAMP) and dec.window_size == 16
    assert dec.gs_embedding.shape == (256, 192)
    assert len(dec.window_crossattn_blocks) == 2
    assert len(dec.window_crossattn_blocks[0].blocks) == 4
    assert len(dec.gs_selfattn_blocks) == 6
    sd2 = dec2.state_dict()
    for k, v in dec.state_dict().items():
        assert torch.equal(v, sd2[k]), k
