"""gsasr_torch's Enhanced EDSR-GSASR inference against gsasr_tpu on the
CPU: the fused Enhanced decoder (fp32 at the tiny configuration and at full
width, the bf16 trunk), the RoPE k-table for windows larger than the seed
lattice, the paper decoder's bf16 trunk, the state_dict round trip through
the reference converter, `sr_forward` and device selection.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do; the port runs its plain PyTorch versions. Weights are drawn by the
port, read into JAX trees by the JAX package's reference converter and
loaded into fresh port modules with params_from_jax.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_tpu.models import EDSRNOUP as JEDSR
from gsasr_tpu.models import Fea2GSRopeAMP as JRope
from gsasr_tpu.utils.torch_convert import (convert_edsr, convert_fea2gs,
                                           convert_fea2gs_rope)
from gsasr_torch.models import EDSRNOUP, Fea2GS, Fea2GSRopeAMP
from gsasr_torch.models.fea2gs_rope_fast import fea2gs_rope_apply_fused
from gsasr_torch.models.init import init_weights
from gsasr_torch.utils.convert import load_params, params_from_jax

TINY_ENC = dict(num_feat=8, num_block=1)
# the JAX package's tiny Enhanced configuration (tests/test_fea2gs_rope_fast.py)
# with one self-attention block: the JAX side's interpret-mode compile grows
# with the number of kernel calls
TINY = dict(inchannel=8, channel=32, num_heads=4, num_crossattn_blocks=1,
            num_crossattn_layers=2, num_selfattn_blocks=1,
            num_selfattn_layers=2, num_gs_seed=16, window_size=4)
# the Enhanced widths (channel 192, 6 heads, 144 seeds, window 12) trimmed
# to one self-attention block of 2 layers
FULL = dict(num_selfattn_blocks=1, num_selfattn_layers=2)
# windows of 8x8 = 64 keys over a 4x4 seed lattice: ws^2 > num_gs_seed
WIDE = dict(TINY, window_size=8)


def _pair(dec_kw, seed=0, enc_kw=TINY_ENC, paper=False):
    """JAX encoder and decoder params drawn by the port's initializers and
    read by the reference converter, and fresh port modules loaded with
    them through params_from_jax."""
    g = torch.Generator().manual_seed(seed)
    cls, conv = (Fea2GS, convert_fea2gs) if paper else \
        (Fea2GSRopeAMP, convert_fea2gs_rope)
    ep = convert_edsr(init_weights(EDSRNOUP(**enc_kw), g).state_dict())
    dec0 = init_weights(cls(**dec_kw), g)
    kw = dict(num_gs_seed=dec0.num_gs_seed, window_size=dec0.window_size,
              num_heads=dec0.num_heads) if paper else {}
    dp = conv(dec0.state_dict(), **kw)
    esd, dsd = params_from_jax(ep, dp)
    return (ep, dp, load_params(EDSRNOUP(**enc_kw), esd).eval(),
            load_params(cls(**dec_kw), dsd).eval())


def _inputs(seed, b, hw, inch):
    rng = np.random.default_rng(seed)
    return (rng.random((b, *hw, inch), dtype=np.float32),
            rng.uniform(1.5, 4.0, (b,)).astype(np.float32))


def _jax_fused(jdec, dp, srcs, scale, dtype=None, paper=False):
    if paper:
        from gsasr_tpu.models.fea2gs_fast import fea2gs_apply_fused as fn
    else:
        from gsasr_tpu.models.fea2gs_rope_fast import \
            fea2gs_rope_apply_fused as fn
    return np.asarray(jax.jit(lambda p, x, s: fn(
        jdec, {"params": p}, x, s, dtype=dtype))(
        dp, jnp.asarray(srcs), jnp.asarray(scale)))


@pytest.mark.parametrize("dec_kw,b,hw,tol", [
    (TINY, 2, (8, 12), 2e-4), (FULL, 1, (12, 12), 5e-4)],
    ids=["tiny", "full_width"])
def test_fused_decoder_matches_jax(dec_kw, b, hw, tol):
    """fp32: the JAX package's own bounds for its fused-vs-module test,
    2e-4 at the tiny configuration and 5e-4 at full width (float32 sums in
    another order through 25 residual sub-layers)."""
    *_, dp, _, dec = _pair(dec_kw, seed=b)
    srcs, scale = _inputs(b, b, hw, dec.img_feat_proj[0].in_channels)
    ref = _jax_fused(JRope(**dec_kw), dp, srcs, scale)
    with torch.no_grad():
        out = fea2gs_rope_apply_fused(dec, torch.from_numpy(srcs),
                                      torch.from_numpy(scale)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


def test_bf16_trunk_matches_jax_bf16_trunk():
    """The bf16 trunk (fp32 heads) against JAX's, within the JAX package's
    own bf16 bound (rtol 0.1, atol 0.06; tests/test_fea2gs_rope_fast.py).
    Worst difference seen here: 4.4e-4 (max|ref| 0.99)."""
    *_, dp, _, dec = _pair(TINY, seed=3)
    srcs, scale = _inputs(3, 2, (8, 12), 8)
    ref = _jax_fused(JRope(**TINY), dp, srcs, scale, dtype=jnp.bfloat16)
    with torch.no_grad():
        out = fea2gs_rope_apply_fused(dec, torch.from_numpy(srcs),
                                      torch.from_numpy(scale),
                                      dtype=torch.bfloat16)
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0.1, atol=0.06)


def test_rope_k_table_covers_wide_windows_and_paper_bf16_trunk():
    """ws^2 > num_gs_seed: the k table needs ws^2 rows, which the JAX fast
    path cuts to num_gs_seed (ADVICE.md r5 #1), so the port's fused path is
    held against the JAX module path. Then the paper decoder's fused path
    with dtype=bf16 (the bf16 forms of M and A with the bias table) against
    the JAX paper fused path in bf16."""
    *_, dp, _, dec = _pair(WIDE, seed=4)
    srcs, scale = _inputs(4, 1, (8, 16), 8)
    ref = np.asarray(jax.jit(lambda p, x, s: JRope(**WIDE).apply(
        {"params": p}, x, s))(dp, jnp.asarray(srcs), jnp.asarray(scale)))
    with torch.no_grad():
        out = fea2gs_rope_apply_fused(dec, torch.from_numpy(srcs),
                                      torch.from_numpy(scale)).numpy()
    # 2e-4, as the fused-vs-module bound
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)

    from gsasr_tpu.models import Fea2GS as JFea2GS
    from gsasr_torch.models.fea2gs_fast import fea2gs_apply_fused

    # tests/test_model.py's tiny paper configuration
    paper = dict(inchannel=8, channel=12, num_heads=6, num_crossattn_blocks=1,
                 num_crossattn_layers=1, num_selfattn_blocks=1,
                 num_selfattn_layers=1, num_gs_seed=16, window_size=4)
    *_, pdp, _, pdec = _pair(paper, seed=5, paper=True)
    srcs, scale = _inputs(5, 2, (8, 8), 8)
    ref = _jax_fused(JFea2GS(**paper), pdp, srcs, scale, dtype=jnp.bfloat16,
                     paper=True)
    with torch.no_grad():
        out = fea2gs_apply_fused(pdec, torch.from_numpy(srcs),
                                 torch.from_numpy(scale),
                                 dtype=torch.bfloat16).numpy()
    # the JAX package's bf16 bound (rtol 0.1, atol 0.06); worst seen here
    # 6.4e-4 (max|ref| 0.99)
    np.testing.assert_allclose(out, ref, rtol=0.1, atol=0.06)


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


def _assert_same_structure(tree, abstract, path=""):
    if isinstance(abstract, dict):
        assert set(tree) == set(abstract), (path, set(tree) ^ set(abstract))
        for k in abstract:
            _assert_same_structure(tree[k], abstract[k], f"{path}/{k}")
    else:
        assert np.shape(tree) == abstract.shape, path


@pytest.mark.parametrize("dec_kw", [TINY, FULL], ids=["tiny", "full_width"])
def test_state_dict_roundtrip_through_reference_converter(dec_kw):
    """The reference converter reads the state_dict of an Enhanced decoder
    loaded by params_from_jax back into exactly the JAX params it was loaded
    from (rope_freqs, the block convs and conv_final included; no bias
    tables), and those params have the flax module's own tree."""
    _, dp, _, dec = _pair(dec_kw, seed=6)
    assert not any("relative_position" in k for k in dec.state_dict())
    _assert_tree_equal(convert_fea2gs_rope(dec.state_dict()), dp)
    inch = dec_kw.get("inchannel", 64)
    ws = dec.window_size
    _assert_same_structure(dp, jax.eval_shape(lambda: JRope(**dec_kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, ws, ws, inch)),
        jnp.ones((1,))))["params"])


# tiny networks of make_models("edsr", "enhanced")'s shape
SR_DEC = TINY


def test_sr_forward_matches_jax():
    """sr_forward of an Enhanced decoder against JAX's sr_forward, both
    with the family's default trunk: bf16, fp32 heads."""
    from gsasr_tpu.model import sr_forward as jsr_forward
    from gsasr_torch.model import sr_forward

    ep, dp, enc, dec = _pair(SR_DEC, seed=7)
    lq = np.random.default_rng(8).random((1, 10, 13, 3), dtype=np.float32)
    ref = np.asarray(jsr_forward(JEDSR(**TINY_ENC), JRope(**SR_DEC), ep, dp,
                                 jnp.asarray(lq), 3.3, denominator=4,
                                 dmax=0.5))
    out = sr_forward(enc, dec, torch.from_numpy(lq), 3.3, denominator=4,
                     dmax=0.5, device="cpu").numpy()
    assert out.shape == ref.shape == (1, math.floor(10 * 3.3),
                                      math.floor(13 * 3.3), 3)
    assert np.isfinite(out).all()
    # the bf16 trunk's one-step rounding differences, through the Gaussians
    # into the image; worst seen here 2.8e-4 (max|ref| 4.8)
    np.testing.assert_allclose(out, ref, rtol=0, atol=5e-3)


def test_sr_forward_takes_the_fused_bf16_path(monkeypatch):
    """sr_forward runs an Enhanced decoder on its fused path in bf16 by
    default, never on the module path."""
    import gsasr_torch.model as tm

    *_, enc, dec = _pair(SR_DEC, seed=9)
    calls = []
    fused = tm.fea2gs_rope_apply_fused
    monkeypatch.setattr(tm, "fea2gs_rope_apply_fused",
                        lambda *a: calls.append(a[3]) or fused(*a))
    monkeypatch.setattr(type(dec), "forward", lambda *a: pytest.fail(
        "sr_forward ran the module decoder"))
    tm.sr_forward(enc, dec, torch.rand(1, 8, 8, 3), 2.0, denominator=4,
                  device="cpu")
    assert calls == [torch.bfloat16]


def test_enhanced_entry_points_raise_without_gpu(monkeypatch):
    """Without a card and without device='cpu', make_models and sr_forward
    raise for the Enhanced family too: the bf16 plain versions run only
    where the caller asks for the CPU."""
    from gsasr_torch.model import make_models, sr_forward

    *_, enc, dec = _pair(SR_DEC, seed=10)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_models("edsr", "enhanced")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sr_forward(enc, dec, torch.zeros(1, 4, 4, 3), 2.0, denominator=4)


def test_make_models_enhanced_seeded_and_shaped():
    """make_models("edsr", "enhanced" | "ultra") builds the Enhanced
    decoder at its published widths, every weight drawn from the generator;
    RDN's takes two cross-attention blocks (`gsasr_tpu/model.py`'s
    enhanced_cfg); SwinIR's takes 256 seeds in windows of 16."""
    from gsasr_torch.model import make_models

    _, dec = make_models("edsr", "enhanced", device="cpu",
                         generator=torch.Generator().manual_seed(0))
    _, dec2 = make_models("edsr", "ultra", device="cpu",
                          generator=torch.Generator().manual_seed(0))
    assert isinstance(dec, Fea2GSRopeAMP)
    sd2 = dec2.state_dict()
    for k, v in dec.state_dict().items():
        assert torch.equal(v, sd2[k]), k
    assert dec.gs_embedding.shape == (144, 192) and dec.window_size == 12
    assert len(dec.window_crossattn_blocks) == 1
    assert len(dec.window_crossattn_blocks[0].blocks) == 2
    assert len(dec.gs_selfattn_blocks) == 6
    assert len(dec.gs_selfattn_blocks[0].blocks) == 6
    attn = dec.gs_selfattn_blocks[0].blocks[0].gs_self_attn
    assert attn.rope_freqs.shape == (2, 6, 16)
    # |freqs| per pair: the magnitudes 1 / 10^(4 i / 32) of
    # rope_freqs_init, rotated by one angle per head
    mag = torch.hypot(attn.rope_freqs[0], attn.rope_freqs[1])
    want = 1 / 10 ** (torch.arange(0, 32, 4) / 32.0)
    torch.testing.assert_close(mag, want.repeat(2).expand(6, 16),
                               rtol=1e-5, atol=1e-6)
    _, rdec = make_models("rdn", "enhanced", device="cpu")
    assert isinstance(rdec, Fea2GSRopeAMP)
    assert len(rdec.window_crossattn_blocks) == 2
    assert len(rdec.gs_selfattn_blocks) == 6
    _, sdec = make_models("swinir", "enhanced", device="cpu")
    assert sdec.num_gs_seed == 256 and sdec.window_size == 16
    assert len(sdec.window_crossattn_blocks) == 2
