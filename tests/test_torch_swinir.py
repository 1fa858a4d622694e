"""gsasr_torch's SwinIR and RDN encoders against gsasr_tpu on the CPU: the
SW-MSA mask, the encoders' forward (and SwinIR's gradients, through the
masked attention's plain versions against K13/K13b in interpret mode),
SwinIR-GSASR sr_forward, DropPath, the seeded initializers, the state_dict
round trip through the reference converters and the YAML configs.

Weights come from a JAX init, loaded into port modules by params_from_jax,
or from the port's initializers, read into JAX trees by the JAX package's
reference converters. The JAX side's window attentions take the JAX
package's plain reference (GSASR_ATTN=reference): K13 and K13b themselves
are held against the port in interpret mode by
tests/test_torch_attention.py, and compiling them for every module test
would cost minutes here."""

import importlib.util
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_tpu.models import Fea2GS as JFea2GS
from gsasr_tpu.models import RDNNOUP as JRDN
from gsasr_tpu.models import SwinIRNOUP as JSwinIR
from gsasr_tpu.models.swinir import swin_attn_mask as jswin_attn_mask
from gsasr_tpu.utils.torch_convert import (convert_fea2gs, convert_rdn,
                                           convert_swinir)
from gsasr_torch.models import RDNNOUP, Fea2GS, SwinIRNOUP
from gsasr_torch.models.common import DropPath
from gsasr_torch.models.init import init_weights
from gsasr_torch.models.swinir import swin_attn_mask
from gsasr_torch.utils.convert import load_params, params_from_jax

ROOT = Path(__file__).resolve().parents[1]
# tests/test_model_parity.py's tiny SwinIR (window 4, so an 8x8 map has
# shifted windows and 4 window classes)
TINY_SWIN = dict(embed_dim=24, depths=(2, 2), num_heads=(6, 6),
                 window_size=4, num_feat=8)
TINY_DEC = dict(inchannel=8, channel=12, num_heads=6, num_crossattn_blocks=1,
                num_crossattn_layers=2, num_selfattn_blocks=1,
                num_selfattn_layers=2, num_gs_seed=16, window_size=4)


@pytest.fixture(autouse=True)
def _jax_reference_attention(monkeypatch):
    monkeypatch.setenv("GSASR_ATTN", "reference")


@pytest.fixture(scope="module")
def dec_params():
    """A tiny paper decoder's JAX tree: params_from_jax converts an encoder
    tree beside a decoder tree."""
    return convert_fea2gs(
        init_weights(Fea2GS(**TINY_DEC), torch.Generator().manual_seed(0))
        .state_dict(), num_gs_seed=16, window_size=4, num_heads=6)


@pytest.fixture(scope="module")
def swin(dec_params):
    """A JAX-initialized tiny SwinIRNOUP, its params, and a port module
    loaded with them through params_from_jax."""
    jm = JSwinIR(**TINY_SWIN)
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))["params"]
    sd, _ = params_from_jax(p, dec_params)
    return jm, p, load_params(SwinIRNOUP(**TINY_SWIN), sd).eval()


@pytest.mark.parametrize("h,w", [(192, 192), (192, 168), (16, 24), (24, 8)])
def test_swin_attn_mask_equals_jax(h, w):
    """Built on the device with torch ops, bit for bit JAX's numpy mask,
    square and rectangular."""
    out = swin_attn_mask(h, w, 8, 4)
    ref = jswin_attn_mask(h, w, 8, 4)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)
    assert swin_attn_mask(h, w, 8, 4) is out  # cached per arguments


@pytest.mark.parametrize("hw", [(8, 8), (8, 12), (4, 8)],
                         ids=["8x8", "8x12", "4x8_no_shift"])
def test_swinir_encoder_matches_jax(swin, hw):
    """SwinIRNOUP.forward against SwinIRNOUP.apply with the same weights;
    at 4x8, min(h, w) <= window, so no block shifts."""
    jm, p, m = swin
    x = np.random.default_rng(1).random((2, *hw, 3), dtype=np.float32)
    ref = np.asarray(jax.jit(jm.apply)({"params": p}, jnp.asarray(x)))
    with torch.no_grad():
        out = m(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, *hw, 8)
    # 1e-4: float32 products summed in another order through 4 blocks
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_swinir_encoder_grads_match_jax(swin, dec_params):
    """Every parameter gradient of the encoder (shifted blocks through the
    masked attention's backward, bias tables through the ordered table
    gradient) against jax.grad."""
    jm, p, m = swin
    m.zero_grad()
    rng = np.random.default_rng(3)
    x = rng.random((2, 8, 12, 3), dtype=np.float32)
    g = rng.standard_normal((2, 8, 12, 8)).astype(np.float32)
    jgrads = jax.jit(jax.grad(lambda pp: jnp.sum(
        jm.apply({"params": pp}, jnp.asarray(x)) * g)))(p)
    want, _ = params_from_jax(jgrads, dec_params)
    (m(torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
    for name, prm in m.named_parameters():
        ref = want[name].numpy()
        # 1e-4 of the tensor's largest entry: sums over windows and tokens
        # in another order
        np.testing.assert_allclose(prm.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max() + 1e-9,
                                   err_msg=name)


def test_rdn_matches_jax(dec_params):
    """RDNNOUP config B (16 blocks of 8 dense convs, growth 64) at 12x12
    against RDNNOUP.apply with the same weights (the port's initializers,
    read by the reference converter and loaded back by params_from_jax)."""
    p = convert_rdn(init_weights(RDNNOUP(), torch.Generator().manual_seed(4))
                    .state_dict())
    sd, _ = params_from_jax(p, dec_params)
    m = load_params(RDNNOUP(), sd).eval()
    x = np.random.default_rng(5).random((1, 12, 12, 3), dtype=np.float32)
    ref = np.asarray(JRDN().apply({"params": p}, jnp.asarray(x)))
    with torch.no_grad():
        out = m(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (1, 12, 12, 64)
    # 1e-4: two conv implementations through 130 convolutions
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_sr_forward_matches_jax(swin):
    """A tiny SwinIR-GSASR sr_forward against JAX's, padding to 24 (the
    SwinIR denominator): 20x30 pads to 24x48."""
    from gsasr_tpu.model import sr_forward as jsr_forward
    from gsasr_torch.model import DENOMINATORS, sr_forward

    jenc, ep, enc = swin
    g = torch.Generator().manual_seed(7)
    dec = init_weights(Fea2GS(**TINY_DEC), g).eval()
    dp = convert_fea2gs(dec.state_dict(), num_gs_seed=16, window_size=4,
                        num_heads=6)
    lq = np.random.default_rng(8).random((1, 20, 30, 3), dtype=np.float32)
    denom = DENOMINATORS["swinir"]
    ref = np.asarray(jsr_forward(jenc, JFea2GS(**TINY_DEC), ep, dp,
                                 jnp.asarray(lq), 2.5, denominator=denom,
                                 dmax=0.5))
    out = sr_forward(enc, dec, torch.from_numpy(lq), 2.5, denominator=denom,
                     dmax=0.5, device="cpu").numpy()
    assert out.shape == ref.shape == (1, 50, 75, 3)
    assert np.isfinite(out).all()
    # tests/test_torch_model.py's EDSR-path tolerance: the raster's order
    # of Gaussians on top of the networks' float32 differences
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


# -- DropPath ------------------------------------------------------------------


def test_droppath_identity_in_eval_and_at_rate_zero():
    x = torch.randn(4, 3, 5)
    dp = DropPath(0.5).eval()
    assert dp(x) is x
    assert DropPath(0.0).train()(x) is x
    m = init_weights(SwinIRNOUP(**dict(TINY_SWIN, drop_path_rate=0.5)),
                     torch.Generator().manual_seed(2)).eval()
    y = torch.rand(2, 8, 8, 3)
    with torch.no_grad():
        assert torch.equal(m(y), m(y, torch.Generator().manual_seed(0)))


def test_droppath_keeps_whole_samples_scaled():
    """In training mode each sample is kept whole, scaled by 1/keep, or
    zeroed whole; about keep of them survive."""
    dp = DropPath(0.25).train()
    x = torch.rand(4000, 3, 5) + 0.5
    out = dp(x, torch.Generator().manual_seed(1))
    kept = (out != 0).flatten(1)
    assert torch.all(kept.all(1) | ~kept.any(1))
    s = kept.all(1)
    torch.testing.assert_close(out[s], x[s] / 0.75, rtol=0, atol=0)
    assert abs(float(s.float().mean()) - 0.75) < 0.03


def test_droppath_rates_and_generator():
    """Rates follow a linspace over all blocks (block 0 at 0); training
    mode without a generator raises; the same generator seed gives the
    same masks, another seed others."""
    m = init_weights(SwinIRNOUP(**dict(TINY_SWIN, drop_path_rate=0.3)),
                     torch.Generator().manual_seed(2)).train()
    rates = [blk.drop_path.rate for layer in m.layers
             for blk in layer.residual_group["blocks"]]
    assert rates == np.linspace(0, 0.3, 4).tolist() and rates[0] == 0.0
    x = torch.rand(16, 8, 8, 3)
    with pytest.raises(ValueError, match="generator"):
        m(x)
    with torch.no_grad():
        a = m(x, torch.Generator().manual_seed(3))
        b = m(x, torch.Generator().manual_seed(3))
        c = m(x, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_trainer_droppath_stream_is_deterministic_in_seed_and_step():
    """The Trainer's DropPath generator depends on (config.seed, step) only:
    one step's masks repeat, the next step's and another seed's differ."""
    from gsasr_torch.train import TrainConfig, Trainer

    def masks(seed, step):
        m = SwinIRNOUP(**dict(TINY_SWIN, drop_path_rate=0.5))
        tr = Trainer(m, Fea2GS(**TINY_DEC), TrainConfig(seed=seed),
                     device="cpu")
        tr.step_count = step
        return DropPath(0.5).train()(torch.ones(64, 1),
                                     tr.droppath_generator())

    assert torch.equal(masks(0, 5), masks(0, 5))
    assert not torch.equal(masks(0, 5), masks(0, 6))
    assert not torch.equal(masks(0, 5), masks(1, 5))


# -- initializers, converters, configs -------------------------------------


def test_make_models_swinir_and_rdn_seeded_and_shaped():
    """make_models("swinir" | "rdn", "paper") at the published widths with
    SwinIR's _init_weights; HAT with the paper decoder and SwinIR's
    window-16 Enhanced decoder build at their shapes."""
    from gsasr_torch.model import make_models

    enc, dec = make_models("swinir", "paper", device="cpu",
                           generator=torch.Generator().manual_seed(0))
    enc2, _ = make_models("swinir", "paper", device="cpu",
                          generator=torch.Generator().manual_seed(0))
    for k, v in enc.state_dict().items():
        assert torch.equal(v, enc2.state_dict()[k]), k
    assert not enc.training and dec.gs_embedding.shape == (144, 180)
    assert len(enc.layers) == 6
    assert all(len(layer.residual_group["blocks"]) == 6
               for layer in enc.layers)
    blk = enc.layers[2].residual_group["blocks"][1]
    assert blk.attn.qkv.weight.shape == (540, 180)
    assert blk.attn.relative_position_bias_table.shape == (225, 6)
    assert blk.mlp.fc1.weight.shape == (360, 180)
    linears = torch.cat([mod.weight.flatten() for mod in enc.modules()
                         if isinstance(mod, torch.nn.Linear)]).detach()
    assert abs(float(linears.std()) - 0.02) < 2e-4
    assert float(linears.abs().max()) <= 2.0
    assert all(torch.all(mod.bias == 0) for mod in enc.modules()
               if isinstance(mod, torch.nn.Linear))
    conv = enc.conv_after_body.weight
    bound = 1 / math.sqrt(180 * 9)
    assert conv.abs().max() <= bound and conv.abs().max() > 0.9 * bound
    rdn, _ = make_models("rdn", "paper", device="cpu")
    assert len(rdn.RDBs) == 16 and len(rdn.RDBs[0].convs) == 8
    assert rdn.RDBs[15].LFF.weight.shape == (64, 576, 1, 1)
    for enc_name, version, seeds, ws in (("hat", "paper", 144, 12),
                                         ("swinir", "enhanced", 256, 16),
                                         ("swinir", "ultra", 256, 16)):
        enc, dec = make_models(enc_name, version, device="cpu")
        assert enc.conv_before_upsample[0].out_channels == 64
        assert dec.num_gs_seed == seeds and dec.window_size == ws


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


@pytest.mark.parametrize("name", ["swinir", "rdn"])
def test_state_dict_roundtrip_through_reference_converter(name, dec_params):
    """The reference converter reads the port's state_dict into a tree of
    the flax module's own structure, and params_from_jax turns that tree
    back into the same state_dict: the port's keys are the reference's."""
    g = torch.Generator().manual_seed(9)
    if name == "swinir":
        m, conv, jm = SwinIRNOUP(**TINY_SWIN), convert_swinir, \
            JSwinIR(**TINY_SWIN)
    else:
        m, conv, jm = RDNNOUP(config="A"), convert_rdn, JRDN(config="A")
    init_weights(m, g)
    tree = conv(m.state_dict())
    abstract = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3))))["params"]
    _assert_tree_equal(jax.tree_util.tree_map(np.shape, tree),
                       jax.tree_util.tree_map(lambda a: a.shape, abstract))
    sd, _ = params_from_jax(tree, dec_params)
    params = dict(m.named_parameters())
    assert set(sd) == set(params)
    for k, v in sd.items():
        assert torch.equal(v, params[k].detach()), k


@pytest.mark.parametrize("yml", ["train_swinir_paper.yml",
                                 "train_rdn_paper.yml"])
def test_build_networks_from_paper_yaml(yml):
    """build_networks on the paper recipes gives the yaml's decoder, the
    encoder's published widths, and the JAX build_networks' encoder
    parameter count; the training recipe is chip_smoke.py's PAPER_TRAIN."""
    from gsasr_torch.config import (build_networks, build_train_config,
                                    load_options)
    from gsasr_torch.train import TrainConfig
    from gsasr_tpu.config import build_networks as jbuild_networks

    opt = load_options(ROOT / "configs" / yml)
    enc, dec = build_networks(opt)
    jenc, _ = jbuild_networks(opt)
    assert dec.channel == opt["network_fea2gs"]["channel"] == 180
    assert dec.num_gs_seed == 144 and dec.window_size == 12
    hw = 16
    abstract = jax.eval_shape(lambda: jenc.init(
        jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3))))["params"]
    jcount = sum(math.prod(a.shape)
                 for a in jax.tree_util.tree_leaves(abstract))
    assert sum(p.numel() for p in enc.parameters()) == jcount
    if isinstance(enc, SwinIRNOUP):
        assert enc.drop_path_rate == 0.1 and len(enc.layers) == 6
    else:
        assert len(enc.RDBs) == 16
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert TrainConfig(**cs.PAPER_TRAIN) == build_train_config(opt)


def test_chip_smoke_kernel_entry(monkeypatch):
    """chip_smoke.py's kernels line: an entry's times are the mean of the
    rows with launches on its path, weighted by them; its other forms are
    listed with their own numbers; without a card main() exits 2 with no
    result, whatever the arguments."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    row = dict(max_abs_err=1e-5, plain_ms=1.0, bound_ms=0.06,
               bound_by="operations", library_ms=0.9)
    rows = [dict(row, case="inference", per_step=0, ms=0.8),
            dict(row, case="training", per_step=18, ms=0.7),
            dict(row, case="other", per_step=6, ms=1.1)]
    on_path = cs._on_path(rows, "per_step")
    assert [r["case"] for r in on_path] == ["training", "other"]
    e = cs._kernel_entry("k", "src.cu", "ref.py:1", [], 24, "path", on_path,
                         rows)
    assert e["ms"] == pytest.approx((0.7 * 18 + 1.1 * 6) / 24)
    assert e["launches"] == 24 and e["library_ms"] == pytest.approx(0.9)
    assert [f["case"] for f in e["forms"]] == [r["case"] for r in rows]
    assert "forms" not in cs._kernel_entry("k", "s", "r", [], 1, "p",
                                           on_path)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cs.main() == 2
