"""gsasr_torch's SwinIR-GSASR at its bf16 recipe (configs/
train_swinir_amp.yml, GSASRAMPModel) against gsasr_tpu on the CPU.

- The masked window attention with bfloat16 operands: WM-bf16 and
  WMB-bf16's plain versions against jax.vjp of window_attention_packed
  with a window_mask (K13 and K13b with bf16 operands in interpret mode).
- SwinIRNOUP(dtype=bfloat16) and its window attention and blocks, shifted
  and not, against flax's modules built with dtype=bfloat16: forward, and
  the gradients of a scalar loss in the parameters.
- One tiny Trainer step of the recipe's form (bf16 SwinIR with a shifted
  block and the bf16 Enhanced decoder, DropPath 0) against the JAX
  Trainer: loss, gradients, the parameters after one update.
- build_networks of train_swinir_amp.yml against JAX's, its trainer's
  dtype split, and make_models("swinir", "enhanced", dtype=bfloat16).

The JAX side runs K11, K12, K13 and K13b in interpret mode, as its own
tests do (no GSASR_ATTN=reference: its plain einsum computes bf16 scores,
where K13 and the port compute them in f32); the port runs its plain
PyTorch versions. Weights are drawn by the port's initializers, moved by
seeded noise, and carried across by the reference converters.

bf16 tolerances, as tests/test_torch_enhanced_train.py and
tests/test_torch_hat_train.py state them: both sides round at the same
points but sum their f32 products and statistics in another order, so a
value lands one bf16 step (2^-8 relative) apart now and then and carries
it through every later bf16 sub-layer; each tolerance is 2^-8 times the
bf16 depth crossed (plus log2 of the positions summed for the Dense and
Conv biases, whose bf16 gradients XLA's CPU reduction sums in bf16).
"""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gsasr_tpu.models import Fea2GSRopeAMP as JRope
from gsasr_tpu.models import swinir as jswin
from gsasr_tpu.ops.attention import window_attention_packed as jattn
from gsasr_tpu.parallel.mesh import make_mesh
from gsasr_tpu.train import TrainConfig as JTrainConfig
from gsasr_tpu.train import Trainer as JTrainer
from gsasr_tpu.utils.torch_convert import convert_fea2gs_rope, convert_swinir
from gsasr_torch.models import Fea2GSRopeAMP, SwinIRNOUP
from gsasr_torch.models.init import init_weights
from gsasr_torch.models.swinir import swin_attn_mask
from gsasr_torch.ops import attention as ta
from gsasr_torch.train import TrainConfig, Trainer
from gsasr_torch.utils.convert import load_params, params_from_jax

ROOT = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16
STEP = 2.0 ** -8
C, NH, WS = 24, 6, 4
# a tiny SwinIR at window 4 on 8x8 maps: four windows, the second block
# shifted by 2 with the four-class SW-MSA mask
TINY_SWIN = dict(embed_dim=C, depths=(2,), num_heads=(NH,), window_size=WS,
                 mlp_ratio=2.0, num_feat=16, drop_path_rate=0.0)
# tests/test_torch_enhanced_train.py's bf16 decoder, and its bf16 depth
TINY_DEC = dict(inchannel=16, channel=24, num_heads=6, num_crossattn_blocks=1,
                num_crossattn_layers=1, num_selfattn_blocks=1,
                num_selfattn_layers=1, num_gs_seed=16, window_size=4)
DEC_DEPTH = 3 + 2 * (3 + 4)
# bf16 sub-layers crossed, output to input: the attention 3 (qkv, the
# attention, proj); a Swin block 10 (norm1, the attention's 3, the add,
# norm2, fc1, GELU, fc2, the add); the tiny SwinIRNOUP conv_first, the
# patch norm, two blocks, the RSTB's conv and add, norm, conv_after_body
# and its add, conv_before_upsample and its LeakyReLU: 29
DEPTH = {"window_attention": 3, "block": 10, "block_shifted": 10,
         "swinirnoup": 29}
CFG = dict(canvas_hw=(32, 32), warmup_iter=-1, milestones=(100,),
           clip_grad_norm=None)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one intra-op thread, restored after the file (as
    tests/test_torch_enhanced_fused_train.py does: in the six-worker suite
    the workers' thread pools spin on the same cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rel_l2(got, ref):
    """Relative L2 distance of two lists of arrays, taken together."""
    num = sum(float(np.sum((np.asarray(a, np.float64)
                            - np.asarray(r, np.float64)) ** 2))
              for a, r in zip(got, ref))
    den = sum(float(np.sum(np.asarray(r, np.float64) ** 2)) for r in ref)
    return math.sqrt(num / den)


def _within_a_bf16_step(a, ref):
    """|a - ref| <= one bf16 step of ref + 2^-16 max|ref|
    (tests/test_torch_attention.py's bound for one rounding of f32 sums
    taken in another order)."""
    a, ref = a.float(), ref.float()
    _, e = torch.frexp(ref)
    step = torch.ldexp(torch.ones_like(ref), e - 8)
    return bool(((a - ref).abs()
                 <= step + 2.0 ** -16 * ref.abs().max()).all())


# -- WM-bf16 and WMB-bf16 against K13 and K13b --------------------------------

# (windows, mask period, T, C, heads, bias): SwinIR's form (period 4 of a
# tiny map, windows of 64 tokens at 6 heads), a prime period, no bias
MASKED_BF16_CASES = [(8, 4, 64, 24, 6, True), (10, 5, 16, 12, 3, True),
                     (6, 3, 16, 12, 3, False)]


@pytest.mark.parametrize("b,nw,t,c,nh,bias", MASKED_BF16_CASES)
def test_masked_bf16_matches_jax_forward_and_grad(b, nw, t, c, nh, bias):
    """WM-bf16 and WMB-bf16's plain versions through window_attention_packed
    against K13 and K13b with bf16 operands in interpret mode, forward and
    VJP, with the SW-MSA-like mask (0 or -100 plus noise): out, dq, dk and
    dv each one rounding of f32 sums taken in another order, so equal or one
    bf16 step apart (`_within_a_bf16_step`); dbias f32, summed over the
    windows in another order (1e-5)."""
    rng = np.random.default_rng(3)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v, g = (r(b, t, c) for _ in range(4))
    bs = 0.5 * r(nh, t, t)
    mask = (np.where(rng.random((nw, t, t)) < 0.3, -100.0, 0.0)
            + 0.3 * rng.standard_normal((nw, t, t))).astype(np.float32)
    jbf = jnp.bfloat16
    args = [jnp.asarray(x).astype(jbf) for x in (q, k, v)]
    args += [jnp.asarray(bs)] if bias else []

    def jfwd(*a):
        return jattn(*a[:3], a[3] if bias else None, num_heads=nh,
                     window_mask=jnp.asarray(mask))

    jout, vjp = jax.vjp(jfwd, *args)
    gj = jnp.asarray(g).astype(jbf)
    jgrads = vjp(gj)

    def tbf(x):
        return torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(BF16)

    tens = [tbf(x).requires_grad_() for x in args[:3]]
    tens += [torch.from_numpy(bs).requires_grad_()] if bias else []
    n = ta.window_attention_packed_masked_bf16_fwd.launches
    out = ta.window_attention_packed(*tens[:3], tens[3] if bias else None,
                                     num_heads=nh,
                                     window_mask=torch.from_numpy(mask))
    out.backward(tbf(gj))
    assert ta.window_attention_packed_masked_bf16_fwd.launches == n
    assert out.dtype == BF16 and _within_a_bf16_step(out.detach(), tbf(jout))
    for t, jg, name in zip(tens, jgrads, "qkv"):
        assert t.grad.dtype == BF16
        assert _within_a_bf16_step(t.grad, tbf(jg)), name
    if bias:
        assert tens[3].grad.dtype == torch.float32
        np.testing.assert_allclose(tens[3].grad.numpy(),
                                   np.asarray(jgrads[3]), rtol=1e-5,
                                   atol=1e-5)


# -- the bf16 SwinIR modules against flax's -----------------------------------


def _tiny_swin_weights(seed):
    """The tiny SwinIR's port state_dict from the reference initializers,
    every entry moved by 0.05 x N(0, 1) (the indices left as they are), and
    the same weights as a JAX tree."""
    m = init_weights(SwinIRNOUP(**TINY_SWIN),
                     torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    sd = {k: v if not v.is_floating_point() else
          v + 0.05 * torch.randn(v.shape, generator=g)
          for k, v in m.state_dict().items()}
    return sd, jax.tree_util.tree_map(jnp.asarray, convert_swinir(sd))


def _split_biases(tree):
    """(every leaf but the Dense and Conv biases, those biases) of a
    parameter tree, as arrays in the tree's order."""
    out = ([], [])
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = jax.tree_util.keystr(path)
        out[key.endswith("['bias']") and "norm" not in key].append(
            np.asarray(a))
    return out


_MASK = swin_attn_mask(8, 8, WS, WS // 2)
# Each case: the JAX module and its call's extra arguments, the path of its
# subtree in convert_swinir's tree, the port module under SwinIRNOUP and its
# extra arguments.
_MODULES = {
    "window_attention": (
        lambda: jswin.WindowAttention(C, WS, NH, dtype=jnp.bfloat16),
        (jnp.asarray(_MASK.numpy()),), ("layer_0", "block_1", "attn"),
        lambda e: e.layers[0].residual_group["blocks"][1].attn, (_MASK,)),
    "block": (lambda: jswin.SwinBlock(C, NH, WS, 0, 2.0,
                                      dtype=jnp.bfloat16), (),
              ("layer_0", "block_0"),
              lambda e: e.layers[0].residual_group["blocks"][0], ()),
    "block_shifted": (lambda: jswin.SwinBlock(C, NH, WS, WS // 2, 2.0,
                                              dtype=jnp.bfloat16), (),
                      ("layer_0", "block_1"),
                      lambda e: e.layers[0].residual_group["blocks"][1], ()),
    "swinirnoup": (lambda: jswin.SwinIRNOUP(**TINY_SWIN, dtype=jnp.bfloat16),
                   (), (), lambda e: e, ()),
}


@pytest.mark.parametrize("name", list(DEPTH))
def test_bf16_swinir_modules_match_jax(name):
    """Each SwinIR module with dtype=bfloat16 (fp32 parameters) against the
    flax module with dtype=bfloat16, on the same weights and input (bf16
    features for a block or the attention, the f32 image for the encoder):
    the bf16 output within 2^-8 x its depth of JAX's in relative L2, and
    every entry within that times the output's largest entry; the gradients
    of sum(out * cot) in the parameters, the bias tables among them, all
    tensors together, within 2^-8 x the depth in relative L2, the Dense and
    Conv biases within 2^-8 x (depth + log2 of the positions summed)."""
    jcls, jextra, path, sub, extra = _MODULES[name]
    sd, tree = _tiny_swin_weights(4)
    enc = SwinIRNOUP(**TINY_SWIN, dtype=BF16)
    enc.load_state_dict(sd)
    m = sub(enc)
    jp = tree
    for key in path:
        jp = jp[key]
    if name == "swinirnoup":
        x = np.random.default_rng(3).random((2, 8, 8, 3), dtype=np.float32)
    else:
        shape = (8, WS * WS, C) if name == "window_attention" else \
            (2, 8, 8, C)
        x = torch.from_numpy(_x(1, *shape)).to(BF16).float().numpy()
    xj = jnp.asarray(x)
    if name != "swinirnoup":
        xj = xj.astype(jnp.bfloat16)
    jout, vjp = jax.vjp(
        lambda pp: jcls().apply({"params": pp}, xj, *jextra), jp)
    cot = _x(5, *jout.shape)
    jgrads, = vjp(jnp.asarray(cot).astype(jout.dtype))
    xt = torch.from_numpy(x)
    out = m(xt if name == "swinirnoup" else xt.to(BF16), *extra)
    assert out.dtype == BF16 and jout.dtype == jnp.bfloat16
    assert all(t.dtype == torch.float32 for t in m.parameters())
    (out.float() * torch.from_numpy(cot)).sum().backward()
    depth = DEPTH[name]
    ref = np.asarray(jout.astype(jnp.float32))
    got = out.detach().float().numpy()
    assert _rel_l2([got], [ref]) <= STEP * depth
    assert np.abs(got - ref).max() <= STEP * depth * np.abs(ref).max()
    grads = convert_swinir({k: torch.zeros_like(p) if p.grad is None
                            else p.grad for k, p in enc.named_parameters()})
    for key in path:
        grads = grads[key]
    assert jax.tree_util.tree_structure(grads) == \
        jax.tree_util.tree_structure(jgrads)
    got_w, got_b = _split_biases(grads)
    ref_w, ref_b = _split_biases(jgrads)
    assert _rel_l2(got_w, ref_w) <= STEP * depth
    if ref_b:
        n_pos = x.size // x.shape[-1]
        assert _rel_l2(got_b, ref_b) <= STEP * (depth + math.log2(n_pos))


# -- one tiny step of the recipe against the JAX Trainer ----------------------


def test_swinir_bf16_trainer_step_matches_jax():
    """One Trainer step of the bf16 recipe in small (the bf16 tiny SwinIR,
    its second block shifted and masked, and the bf16 Enhanced decoder on
    the module path; fp32 parameters, Adam, no clip, drop_path_rate 0)
    against the JAX Trainer with the same networks in bf16, from the same
    weights and batch: loss within 2^-8 relative; each network's gradient
    within relative L2 2^-8 x its bf16 depth (the decoder DEC_DEPTH, the
    encoder behind it and its own 29); the parameters after the update
    within 2 lr of JAX's (Adam's first step moves a weight by about lr
    sign(g), and a gradient within bf16 noise of 0 may flip it), the mean
    difference below 0.05 lr."""
    g = torch.Generator().manual_seed(6)
    enc = init_weights(SwinIRNOUP(**TINY_SWIN), g)
    dec = init_weights(Fea2GSRopeAMP(**TINY_DEC), g)
    params = jax.tree_util.tree_map(jnp.asarray, {
        "g": convert_swinir(enc.state_dict()),
        "d": convert_fea2gs_rope(dec.state_dict())})
    esd, dsd = params_from_jax(params["g"], params["d"])
    enc = load_params(SwinIRNOUP(**TINY_SWIN, dtype=BF16), esd)
    dec = load_params(Fea2GSRopeAMP(**TINY_DEC, dtype=BF16), dsd)
    rng = np.random.default_rng(7)
    scales = (2.0 + 2.0 * rng.random(2)).astype(np.float32)
    gt = np.ceil(scales * 8).astype(np.int32)
    batch = {"lq": rng.random((2, 8, 8, 3), dtype=np.float32),
             "gt": rng.random((2, 32, 32, 3), dtype=np.float32),
             "scale": scales, "gt_h": gt, "gt_w": gt}
    jtr = JTrainer(jswin.SwinIRNOUP(**TINY_SWIN, dtype=jnp.bfloat16),
                   JRope(**TINY_DEC, dtype=jnp.bfloat16), JTrainConfig(**CFG),
                   mesh=make_mesh(jax.devices()[:1]))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jtr._loss_fn,
                                                    has_aux=True))(
        params, jax.tree_util.tree_map(jnp.asarray, batch),
        jax.random.PRNGKey(0))
    updates, _ = jax.jit(jtr.tx.update)(jgrads, jtr.tx.init(params), params)
    jnew = optax.apply_updates(params, updates)

    tr = Trainer(enc, dec, TrainConfig(**CFG), device="cpu")
    n = (ta.window_attention_packed_masked_bf16_fwd.launches,
         ta.window_attention_packed_masked_bf16_bwd.launches)
    loss, met, g_g, g_d = tr.grads(batch)
    assert (ta.window_attention_packed_masked_bf16_fwd.launches,
            ta.window_attention_packed_masked_bf16_bwd.launches) == n
    assert all(t.dtype == torch.float32 for t in g_g + g_d)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP)
    want = params_from_jax(jgrads["g"], jgrads["d"])
    for mod, grads, depth, ref in (
            (tr.enc, g_g, DEC_DEPTH + DEPTH["swinirnoup"], want[0]),
            (tr.dec, g_d, DEC_DEPTH, want[1])):
        names = [n for n, _ in mod.named_parameters()]
        dist = _rel_l2([t.numpy() for t in grads],
                       [ref[n].numpy() for n in names])
        assert dist <= STEP * depth, (type(mod).__name__, dist)

    tr.apply(loss, met, g_g, g_d)
    lr = 2e-4
    new = params_from_jax(jnew["g"], jnew["d"])
    diffs = []
    for i, mod in enumerate((tr.enc, tr.dec)):
        for name, p in mod.named_parameters():
            diff = np.abs(p.detach().numpy() - new[i][name].numpy())
            assert diff.max() <= 2 * lr + 1e-6, (name, float(diff.max()))
            diffs.append(diff.ravel())
    assert np.concatenate(diffs).mean() <= 0.05 * lr


# -- the recipe ---------------------------------------------------------------


def test_build_networks_swinir_amp_recipe():
    """configs/train_swinir_amp.yml builds the bf16 SwinIR (180 channels, 6
    RSTBs of 6, window 8, DropPath 0.1) and the bf16 Fea2GSRopeAMP (192
    channels, 2 cross blocks of 4 layers, 6 self blocks of 6, 256 seeds in
    windows of 16, fp32 heads) on fp32 parameters; their trees, read by the
    reference converters, have the shapes of the JAX package's
    build_networks of the same file (cut to one RSTB and one self block);
    the trainer keeps the module path's split (bf16 UPNet, fp32 heads) and
    hands SwinIR its DropPath generator; chip_smoke.py's written-out recipe
    and networks are the file's, weight for weight."""
    from gsasr_torch.config import (build_networks, build_train_config,
                                    load_options)
    from gsasr_tpu.config import build_networks as jbuild_networks

    opt = load_options(ROOT / "configs" / "train_swinir_amp.yml")
    enc, dec = build_networks(opt)
    assert isinstance(enc, SwinIRNOUP) and isinstance(dec, Fea2GSRopeAMP)
    assert enc.dtype == BF16 and dec.dtype == BF16
    assert enc.drop_path_rate == 0.1 and enc.window_size == 8
    blk = enc.layers[5].residual_group["blocks"][5]
    assert blk.attn.qkv.compute_dtype == BF16 and blk.shift_size == 4
    assert enc.conv_first.compute_dtype == BF16
    assert dec.UPNet[0].compute_dtype == BF16
    assert dec.mlp_block_mean[0].compute_dtype == torch.float32
    assert (dec.channel, dec.num_gs_seed, dec.window_size) == (192, 256, 16)
    assert len(dec.window_crossattn_blocks) == 2
    assert all(p.dtype == torch.float32 for p in
               list(enc.parameters()) + list(dec.parameters()))
    assert len(enc.layers) == 6 and all(
        len(layer.residual_group["blocks"]) == 6 for layer in enc.layers)
    cut = dict(opt, network_g=dict(opt["network_g"], depths=[6],
                                   num_heads=[6]),
               network_fea2gs=dict(opt["network_fea2gs"],
                                   num_selfattn_blocks=1))
    enc1, dec1 = build_networks(cut)
    jenc, jdec = jbuild_networks(cut)
    assert jenc.dtype == jnp.bfloat16 and jdec.dtype == jnp.bfloat16
    shapes = jax.eval_shape(lambda: {
        "g": jenc.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))),
        "d": jdec.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 64)),
                       jnp.ones((1,)))})
    shape = lambda t: jax.tree_util.tree_map(np.shape, t)  # noqa: E731
    assert shape(convert_swinir(enc1.state_dict())) == shape(
        shapes["g"]["params"])
    assert shape(convert_fea2gs_rope(dec1.state_dict())) == shape(
        shapes["d"]["params"])
    cfg = build_train_config(opt)
    assert cfg.clip_grad_norm is None and cfg.canvas_hw == (192, 192)
    assert not cfg.fused_decoder
    tr = Trainer(enc1, dec1, cfg, device="cpu")
    assert isinstance(tr.droppath_generator(), torch.Generator)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert TrainConfig(**cs.ENHANCED_TRAIN) == cfg
    for got, want in zip(cs.enhanced_networks("swinir"), (enc, dec)):
        assert type(got) is type(want) and got.dtype == want.dtype
        sd = want.state_dict()
        for k, v in got.state_dict().items():
            assert torch.equal(v, sd[k]), k


def test_make_models_swinir_enhanced_bf16():
    """make_models("swinir", "enhanced", dtype=torch.bfloat16) builds the
    bf16 SwinIR and decoder on fp32 parameters, with the weights of the
    fp32 build (the same draws), in eval mode."""
    from gsasr_torch.model import make_models

    enc, dec = make_models("swinir", "enhanced", dtype=BF16, device="cpu")
    enc32, dec32 = make_models("swinir", "enhanced", device="cpu")
    assert enc.dtype == dec.dtype == BF16 and not enc.training
    assert enc.layers[5].residual_group["blocks"][1].attn.proj.compute_dtype \
        == BF16
    for a, b in ((enc, enc32), (dec, dec32)):
        sd = b.state_dict()
        for k, v in a.state_dict().items():
            assert torch.equal(v, sd[k]), k
