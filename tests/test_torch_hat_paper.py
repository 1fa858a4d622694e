"""gsasr_torch's paper HAT encoder (`models/hat_paper.py`, the `network_g`
type HATNOUP) against gsasr_tpu's `HATNOUPPaper` on the CPU.

- The OCAB's rectangular relative-position index (it runs negative; both
  gathers wrap it) and the bias it gathers.
- A tiny HATNOUPPaper (one RHAG of two HABs and an OCAB, 24 channels, 6
  heads, window 16, on 32x32 maps: four windows, the second HAB shifted by
  8 and masked with the four-class SW-MSA mask, the OCAB at 256 x 576)
  against flax, forward and parameter gradients, in float32 and bfloat16.
- params_from_jax on a paper-HAT tree (the RoPE HAT's keys but for the bias
  tables), the state_dict round trip through convert_hat_paper and the
  index rebuilt when a state_dict loads one.
- build_networks of both recipes (the paper one in fp32 with the paper
  Fea2GS, the bf16 one with the Enhanced decoder), a CPU Trainer step of
  each at a small size, sr_forward at denominator 48, and chip_smoke.py's
  written-out networks.

The JAX side runs eagerly (jax.vjp without jit), as
tests/test_torch_hat_train.py does: a jit compile of its OCAB's 576-slice
unfold loop and its VJP takes about a minute. Its window attentions run K11
and K13 (and their VJPs K12 and K13b) in interpret mode, as its own tests
run them; the port runs its plain PyTorch versions.

Tolerances. float32: 1e-4 (the tiny HATNOUP's in tests/test_torch_hat.py;
gradients 1e-4 of each tensor's largest entry, as
tests/test_torch_swinir.py's): sums in another order. bfloat16: 2^-8 times
the bf16 depth crossed (tests/test_torch_hat_train.py's rule), the Dense
and Conv biases 2^-8 x (depth + log2 of the positions summed).
"""

import copy
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_tpu.models import hat_paper as jhp
from gsasr_tpu.utils.torch_convert import (convert_fea2gs_rope,
                                           convert_hat_paper)
from gsasr_torch.models import Fea2GS, Fea2GSRopeAMP, HATNOUPPaper
from gsasr_torch.models import hat_paper as hp
from gsasr_torch.models.init import init_weights
from gsasr_torch.ops import attention as ta
from gsasr_torch.train import TrainConfig, Trainer
from gsasr_torch.utils.convert import load_params, params_from_jax

ROOT = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16
STEP = 2.0 ** -8
TINY = dict(embed_dim=24, depths=(2,), num_heads=(6,), window_size=16,
            squeeze_factor=4, conv_scale=0.5, num_feat=16)
# bf16 sub-layers of the tiny encoder, output to input: conv_first, the
# patch norm; a HAB 16 (norm1, the CAB's 6, the attention's 3, the sum's 2,
# norm2, fc1, GELU, fc2, the add) twice; the OCAB 10 (norm1, qkv, the
# attention, proj, the add, norm2, fc1, GELU, fc2, the add); the RHAG's
# conv and add; norm, conv_after_body and its add, conv_before_upsample and
# its LeakyReLU
DEPTH = 2 + 2 * 16 + 10 + 2 + 5
# a tiny paper decoder (tests/test_trainer.py's) and Enhanced decoder
# (tests/test_torch_enhanced_train.py's), both at windows of 4
PAPER_DEC = dict(inchannel=16, channel=12, num_heads=6,
                 num_crossattn_blocks=1, num_crossattn_layers=2,
                 num_selfattn_blocks=1, num_selfattn_layers=2,
                 num_gs_seed=16, window_size=4)
ROPE_DEC = dict(inchannel=16, channel=24, num_heads=6, num_crossattn_blocks=1,
                num_crossattn_layers=1, num_selfattn_blocks=1,
                num_selfattn_layers=1, num_gs_seed=16, window_size=4)
CFG = dict(canvas_hw=(64, 64), warmup_iter=-1, milestones=(100,))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one intra-op thread, restored after the file (as
    tests/test_torch_enhanced_fused_train.py does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(got, ref):
    num = sum(float(np.sum((np.asarray(a, np.float64)
                            - np.asarray(r, np.float64)) ** 2))
              for a, r in zip(got, ref))
    den = sum(float(np.sum(np.asarray(r, np.float64) ** 2)) for r in ref)
    return math.sqrt(num / den)


def _tiny_weights(seed):
    """The tiny encoder's port state_dict from the reference initializers,
    every float entry moved by 0.05 x N(0, 1), and the same weights as a
    JAX tree (convert_hat_paper)."""
    m = init_weights(HATNOUPPaper(**TINY), torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    sd = {k: v if not v.is_floating_point() else
          v + 0.05 * torch.randn(v.shape, generator=g)
          for k, v in m.state_dict().items()}
    return sd, jax.tree_util.tree_map(jnp.asarray, convert_hat_paper(sd))


def _leaves(tree):
    """(every leaf but the Dense and Conv biases, those biases) in the
    tree's order."""
    out = ([], [])
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = jax.tree_util.keystr(path)
        out[key.endswith("['bias']") and "norm" not in key].append(
            np.asarray(a, np.float32))
    return out


def test_oca_rel_pos_index_matches_jax():
    """oca_rel_pos_index is JAX's, negative entries and all; the OCAB
    gathers through it wrapped (each entry mod the table's rows, as the
    reference's and JAX's gathers wrap), a one-to-one map onto the rows, so
    its bias equals JAX's gather and the table gradient covers every row."""
    for ws, ows in ((16, 24), (4, 6)):
        idx = hp.oca_rel_pos_index(ws, ows)
        np.testing.assert_array_equal(idx, jhp.oca_rel_pos_index(ws, ows))
        assert idx.min() < 0
    m = init_weights(HATNOUPPaper(**TINY), torch.Generator().manual_seed(1))
    ocab = m.layers[0].residual_group["overlap_attn"]
    rows = 39 ** 2
    assert ocab.relative_position_bias_table.shape == (rows, 6)
    assert sorted(np.unique(ocab.relative_position_index.numpy())) == \
        list(range(rows))
    table = ocab.relative_position_bias_table.detach()
    want = np.asarray(jnp.asarray(table.numpy())[
        jhp.oca_rel_pos_index(16, 24).reshape(-1)]).reshape(256, 576, 6)
    got = table.t()[:, ocab.relative_position_index]
    np.testing.assert_array_equal(got.permute(1, 2, 0).numpy(), want)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_hat_paper_matches_jax(dt):
    """The tiny HATNOUPPaper against flax's HATNOUPPaper on the same weights
    and a 2 x 32 x 32 image: forward and the gradients of sum(out * cot) in
    every parameter (the HABs' and the OCAB's bias tables among them). The
    shifted HAB takes the masked forms (WM-long and WMB-long's plain
    versions against K13 and K13b), the OCAB W-long and WB-long's. float32:
    out within 1e-4, each gradient within 1e-4 of its largest entry;
    bfloat16 (fp32 parameters): out within 2^-8 x DEPTH in relative L2 and
    times the largest entry elementwise, the gradients within 2^-8 x DEPTH
    in relative L2 (the biases with log2 of the 2048 positions more)."""
    bf16 = dt == "bf16"
    tdt, jdt = (BF16, jnp.bfloat16) if bf16 else (torch.float32,
                                                   jnp.float32)
    sd, tree = _tiny_weights(4)
    m = HATNOUPPaper(**TINY, dtype=tdt)
    m.load_state_dict(sd)
    x = np.random.default_rng(3).random((2, 32, 32, 3), dtype=np.float32)
    jm = jhp.HATNOUPPaper(**TINY, dtype=jdt)
    jout, vjp = jax.vjp(lambda pp: jm.apply({"params": pp}, jnp.asarray(x)),
                        tree)
    cot = np.random.default_rng(5).standard_normal(jout.shape).astype(
        np.float32)
    jgrads, = vjp(jnp.asarray(cot).astype(jout.dtype))
    masked = (ta.window_attention_packed_long_masked_fwd,
              ta.window_attention_packed_long_masked_bwd)
    n = [f.launches for f in masked]
    out = m(torch.from_numpy(x))
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert [f.launches for f in masked] == n
    assert out.dtype == tdt and jout.dtype == jdt
    ref = np.asarray(jout.astype(jnp.float32))
    got = out.detach().float().numpy()
    grads = convert_hat_paper({k: p.grad for k, p in m.named_parameters()})
    assert jax.tree_util.tree_structure(grads) == \
        jax.tree_util.tree_structure(jgrads)
    if not bf16:
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
        for (path, a), b in zip(
                jax.tree_util.tree_flatten_with_path(grads)[0],
                jax.tree_util.tree_leaves(jgrads)):
            b = np.asarray(b)
            np.testing.assert_allclose(
                np.asarray(a), b, rtol=1e-4,
                atol=1e-4 * np.abs(b).max() + 1e-9,
                err_msg=jax.tree_util.keystr(path))
        return
    assert _rel_l2([got], [ref]) <= STEP * DEPTH
    assert np.abs(got - ref).max() <= STEP * DEPTH * np.abs(ref).max()
    got_w, got_b = _leaves(grads)
    ref_w, ref_b = _leaves(jgrads)
    assert _rel_l2(got_w, ref_w) <= STEP * DEPTH
    assert _rel_l2(got_b, ref_b) <= STEP * (DEPTH + math.log2(2 * 32 * 32))


def test_params_from_jax_tells_the_paper_hat_apart():
    """A paper-HAT tree holds the RoPE HAT's keys (overlap_attn among them)
    with a bias table in place of each attention's RoPE frequencies:
    params_from_jax turns it into the paper HAT's state_dict (a dispatch on
    overlap_attn alone read it as the RoPE HAT's and failed on the missing
    rope_freqs), which loads into HATNOUPPaper and, read back by
    convert_hat_paper, is the same tree; the OCAB's index buffer, loaded
    from a state_dict, rebuilds the inverse its table gradient sums by."""
    sd, tree = _tiny_weights(6)
    dec_tree = convert_fea2gs_rope(init_weights(
        Fea2GSRopeAMP(**ROPE_DEC),
        torch.Generator().manual_seed(0)).state_dict())
    got, _ = params_from_jax(tree, dec_tree)
    m = load_params(HATNOUPPaper(**TINY), got)
    params = dict(m.named_parameters())
    assert set(got) == set(params)
    for k, v in got.items():
        assert torch.equal(v, sd[k]), k
    back = convert_hat_paper(m.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ocab = m.layers[0].residual_group["overlap_attn"]
    inv = ocab.relative_position_inverse.clone()
    ocab.relative_position_inverse.zero_()
    m.load_state_dict(m.state_dict())
    assert torch.equal(ocab.relative_position_inverse, inv)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("yml,dtype,dec_cls", [
    ("train_swinir_paper.yml", torch.float32, Fea2GS),
    ("train_swinir_amp.yml", BF16, Fea2GSRopeAMP)])
def test_build_networks_paper_hat(yml, dtype, dec_cls):
    """A recipe with network_g HATNOUP builds the paper HAT at the
    reference's widths (180 channels, 6 RHAGs of 6 HABs, 6 heads, window
    16, OCAB tables of 39^2 rows) in the recipe's type, fp32 with the paper
    Fea2GS or bf16 (fp32 parameters) with the Enhanced decoder; its tree,
    read by convert_hat_paper, has the shapes of the JAX package's
    build_networks of the same options (cut to one RHAG); chip_smoke.py's
    written-out networks are these, weight for weight."""
    from gsasr_torch.config import build_networks, load_options
    from gsasr_tpu.config import build_networks as jbuild_networks

    opt = load_options(ROOT / "configs" / yml)
    opt["network_g"] = {"type": "HATNOUP"}
    enc, dec = build_networks(opt)
    assert isinstance(enc, HATNOUPPaper) and isinstance(dec, dec_cls)
    assert enc.dtype == dtype and dec.dtype == dtype
    assert len(enc.layers) == 6 and all(
        len(layer.residual_group["blocks"]) == 6 for layer in enc.layers)
    blk = enc.layers[0].residual_group["blocks"][1]
    assert blk.shift_size == 8 and blk.attn.qkv.in_features == 180
    assert blk.attn.qkv.compute_dtype == dtype
    ocab = enc.layers[5].residual_group["overlap_attn"]
    assert ocab.relative_position_bias_table.shape == (39 ** 2, 6)
    assert all(p.dtype == torch.float32 for p in
               list(enc.parameters()) + list(dec.parameters()))
    cut = dict(opt, network_g={"type": "HATNOUP", "depths": [6],
                               "num_heads": [6]})
    jenc, _ = jbuild_networks(cut)
    shapes = jax.eval_shape(lambda: jenc.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 32, 32, 3))))
    enc1, _ = build_networks(cut)
    shape = lambda t: jax.tree_util.tree_map(np.shape, t)  # noqa: E731
    assert shape(convert_hat_paper(enc1.state_dict())) == shape(
        shapes["params"])
    got = _chip_smoke().hat_paper_networks(dtype)
    for g, w in zip(got, (enc, dec)):
        assert type(g) is type(w) and g.dtype == w.dtype
        sd = w.state_dict()
        for k, v in g.state_dict().items():
            assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_paper_hat_trains_on_cpu(dtype):
    """One CPU Trainer step of the tiny paper HAT with the tiny paper
    Fea2GS (fp32, the paper recipe's module path) or the tiny bf16 Enhanced
    decoder on 32x32 LR: a finite loss, every encoder parameter with a
    finite gradient, the bias tables' among them, parameters and EMA moved;
    two trainers from the same weights take the same step bit for bit (no
    stochastic depth); CPU tensors count no launch."""
    g = torch.Generator().manual_seed(11)
    enc = init_weights(HATNOUPPaper(**TINY, dtype=dtype), g)
    dec = init_weights(Fea2GS(**PAPER_DEC) if dtype == torch.float32 else
                       Fea2GSRopeAMP(**ROPE_DEC, dtype=dtype), g)
    rng = np.random.default_rng(12)
    scales = (1.0 + rng.random(2)).astype(np.float32)
    gt = np.ceil(scales * 32).astype(np.int32)
    batch = {"lq": rng.random((2, 32, 32, 3), dtype=np.float32),
             "gt": rng.random((2, 64, 64, 3), dtype=np.float32),
             "scale": scales, "gt_h": gt, "gt_w": gt}
    counts = lambda: [f.launches for pair in ta._FORMS.values()  # noqa: E731
                      for f in pair]
    n = counts()
    trs = [Trainer(copy.deepcopy(enc), copy.deepcopy(dec), TrainConfig(**CFG),
                   device="cpu") for _ in range(2)]
    loss, _, g_g, _ = trs[0].grads(batch)
    assert math.isfinite(float(loss))
    assert all(t is not None and bool(torch.isfinite(t).all()) for t in g_g)
    names = [k for k, _ in trs[0].enc.named_parameters()]
    tables = [t for k, t in zip(names, g_g) if "bias_table" in k]
    assert len(tables) == 3 and all(bool(t.abs().sum() > 0) for t in tables)
    metrics = [tr.step(batch) for tr in trs]
    assert torch.equal(metrics[0]["loss"], metrics[1]["loss"])
    for a, b in zip(trs[0].params_g, trs[1].params_g):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in
               zip(trs[0].params_g, enc.parameters()))
    assert any(not torch.equal(a, b) for a, b in
               zip(trs[0].ema_g.parameters(), enc.parameters()))
    assert counts() == n


def test_paper_hat_sr_forward_denominator_48():
    """sr_forward with the paper HAT and a paper decoder pads to 48
    (lcm of HAT's windows of 16 and the paper decoder's of 12): a 40x52
    image at x2.5 comes back (1, 100, 130, 3), finite."""
    from gsasr_torch.model import sr_forward

    g = torch.Generator().manual_seed(13)
    enc = init_weights(HATNOUPPaper(**TINY), g).eval()
    dec = init_weights(Fea2GS(inchannel=16, channel=12, num_heads=6,
                              num_crossattn_blocks=1, num_crossattn_layers=1,
                              num_selfattn_blocks=1, num_selfattn_layers=1),
                       g).eval()
    lq = np.random.default_rng(14).random((1, 40, 52, 3), dtype=np.float32)
    out = sr_forward(enc, dec, lq, 2.5, denominator=48, device="cpu")
    assert tuple(out.shape) == (1, 100, 130, 3)
    assert bool(torch.isfinite(out).all())
