"""gsasr_torch's HAT-L Ultra training at the bf16 recipe against gsasr_tpu
on the CPU.

- The bf16 HAT modules (CAB, the RoPE window attention, HAB unshifted and
  shifted, OCAB, a tiny HATNOUP) against flax's modules built with
  dtype=bfloat16: forward, and the gradients of a scalar loss in the
  parameters.
- One tiny Ultra Trainer step (bf16 HAT and Enhanced decoder, windows of
  16) against the JAX Trainer: loss, gradients, the parameters after one
  update and the EMA.
- build_networks on configs/train_hatl_ultra.yml against JAX's, and
  chip_smoke.py's written-out recipe and networks against it (in
  tests/test_torch_hat_train_build.py).
- The repair: HATNOUP keeps drop_path_rate, so the Trainer hands HAT its
  DropPath generator.
- make_models' dtype keyword.

The JAX side runs K11 and K12 in interpret mode, as its own tests do (no
GSASR_ATTN=reference: its plain einsum computes bf16 scores, where K11 and
the port compute them in f32); the port runs its plain PyTorch versions.
Weights are drawn by JAX's init (moved by seeded noise) or by the port's
initializers, and carried across by the reference converters.

bf16 tolerances, as tests/test_torch_enhanced_train.py states them: both
sides round at the same points, but each sums its f32 products and
statistics in another order, and XLA may keep an elementwise chain in f32
where PyTorch rounds each op (or the reverse), so a value lands one bf16
step (2^-8 relative) apart now and then and carries that on through every
later bf16 sub-layer. Each tolerance is 2^-8 times the bf16 depth crossed.
"""

import copy
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gsasr_tpu.models import Fea2GSRopeAMP as JRope
from gsasr_tpu.models import hat as jhat
from gsasr_tpu.parallel.mesh import make_mesh
from gsasr_tpu.train import TrainConfig as JTrainConfig
from gsasr_tpu.train import Trainer as JTrainer
from gsasr_tpu.utils.torch_convert import convert_fea2gs_rope, convert_hat
from gsasr_torch.models import Fea2GSRopeAMP, HATNOUP
from gsasr_torch.models.init import init_weights
from gsasr_torch.train import TrainConfig, Trainer
from gsasr_torch.utils.convert import load_params, params_from_jax

ROOT = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16
STEP = 2.0 ** -8
C, NH, WS = 8, 2, 16
# module keyword arguments at window 16 on 32x32 maps: four windows, a
# shifted HAB rolls by 8, OCAB's keys are 24x24 patches; the CAB branch at
# conv_scale 0.5 so that it shows
HAB_KW = dict(dim=C, num_heads=NH, window_size=WS, compress_ratio=3,
              squeeze_factor=4, conv_scale=0.5, mlp_ratio=2.0,
              rope_theta=10.0)
OCAB_KW = dict(dim=C, window_size=WS, overlap_ratio=0.5, num_heads=NH,
               mlp_ratio=2.0, rope_theta=10.0)
TINY_HAT = dict(embed_dim=C, depths=(2,), num_heads=(NH,), window_size=WS,
                squeeze_factor=4, conv_scale=0.5, mlp_ratio=2, num_feat=8,
                drop_path_rate=0.0)
# the Ultra decoder's form, narrow: 256 seeds in windows of 16, one cross
# and one self layer
TINY_DEC = dict(inchannel=8, channel=C, num_heads=NH, num_crossattn_blocks=1,
                num_crossattn_layers=1, num_selfattn_blocks=1,
                num_selfattn_layers=1, num_gs_seed=256, window_size=WS)
# bf16 sub-layers crossed, output to input (each Dense or Conv, LayerNorm,
# GELU, RoPE, attention, residual add, the channel attention's chain):
# CAB 6 (two convs, GELU, the mean, its two 1x1 convs and sigmoid, the
# scaling), the attention 4 (qkv, RoPE, attention, proj), a HAB 16, OCAB 11,
# the tiny HATNOUP 4 + 2 HABs + OCAB + 3 = 50
DEPTH = {"cab": 6, "window_attention": 4, "hab": 16, "hab_shifted": 16,
         "ocab": 11, "hatnoup": 50}
# the decoder's bf16 sub-layers (tests/test_torch_enhanced_train.py's
# DEC_DEPTH for one cross and one self layer)
DEC_DEPTH = 3 + 2 * (3 + 4)
CFG = dict(canvas_hw=(64, 64), warmup_iter=-1, milestones=(100,),
           clip_grad_norm=None)


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


def _split_biases(tree):
    """(the Dense and Conv biases, every other leaf) of a parameter tree, as
    arrays in the tree's order."""
    out = ([], [])
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = jax.tree_util.keystr(path)
        out[key.endswith("['bias']") and "norm" not in key].append(
            np.asarray(a))
    return out[1], out[0]


def _tiny_hat_weights(seed):
    """The tiny HAT's port state_dict from the reference initializers, every
    entry moved by 0.05 x N(0, 1) (so biases and LayerNorm affines are not
    trivially 0 or 1), and the same weights as a JAX tree."""
    m = init_weights(HATNOUP(**TINY_HAT), torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    sd = {k: v + 0.05 * torch.randn(v.shape, generator=g)
          for k, v in m.state_dict().items()}
    return sd, jax.tree_util.tree_map(jnp.asarray, convert_hat(sd))


# Each case: the JAX module, the path of its subtree in convert_hat's tree,
# the port module under HATNOUP, and the extra argument of its forward.
_MODULES = {
    "cab": (lambda: jhat.CAB(C, 3, 4, dtype=jnp.bfloat16),
            ("layer_0", "block_0", "conv_block"),
            lambda e: e.layers[0].residual_group["blocks"][0].conv_block, ()),
    "window_attention": (
        lambda: jhat.HATWindowAttention(C, WS, NH, dtype=jnp.bfloat16),
        ("layer_0", "block_0", "attn"),
        lambda e: e.layers[0].residual_group["blocks"][0].attn, (WS,)),
    "hab": (lambda: jhat.HAB(**HAB_KW, shift_size=0, dtype=jnp.bfloat16),
            ("layer_0", "block_0"),
            lambda e: e.layers[0].residual_group["blocks"][0], ()),
    "hab_shifted": (
        lambda: jhat.HAB(**HAB_KW, shift_size=WS // 2, dtype=jnp.bfloat16),
        ("layer_0", "block_1"),
        lambda e: e.layers[0].residual_group["blocks"][1], ()),
    "ocab": (lambda: jhat.OCAB(**OCAB_KW, dtype=jnp.bfloat16),
             ("layer_0", "overlap_attn"),
             lambda e: e.layers[0].residual_group["overlap_attn"], ()),
    "hatnoup": (lambda: jhat.HATNOUP(**TINY_HAT, dtype=jnp.bfloat16), (),
                lambda e: e, ()),
}


@pytest.mark.parametrize("name", list(DEPTH))
def test_bf16_hat_modules_match_jax(name):
    """Each HAT module with dtype=bfloat16 (fp32 parameters) against the
    flax module with dtype=bfloat16, on the same weights and input (bf16
    features for a block, the f32 image for the encoder): the bf16 output
    within 2^-8 x its depth of JAX's in relative L2, and every entry within
    that times the output's largest entry; the gradients of sum(out * cot)
    in the parameters, all tensors together, within 2^-8 x the depth in
    relative L2 (the backward crosses the same sub-layers), except the
    Dense and Conv biases: XLA sums their bf16 gradients over the N
    positions in bf16, which adds about log2 N roundings (2^-8 x (depth +
    log2 N); the port's, summed in f32, are nearer the f32 gradient)."""
    jcls, path, sub, extra = _MODULES[name]
    sd, tree = _tiny_hat_weights(4)
    enc = HATNOUP(**TINY_HAT, dtype=BF16)
    enc.load_state_dict(sd)
    m = sub(enc)
    jp = tree
    for key in path:
        jp = jp[key]
    if name == "hatnoup":
        x = np.random.default_rng(3).random((1, 32, 32, 3), dtype=np.float32)
    else:
        shape = (4, WS * WS, C) if name == "window_attention" else \
            (1, 32, 32, C)
        x = torch.from_numpy(_x(1, *shape)).to(BF16).float().numpy()
    xj = jnp.asarray(x)
    if name != "hatnoup":
        xj = xj.astype(jnp.bfloat16)
    # eager: a jit compile of the JAX OCAB's 576-slice unfold loop and its
    # VJP takes about a minute here, its eager VJP seconds
    jout, vjp = jax.vjp(lambda pp: jcls().apply({"params": pp}, xj), jp)
    cot = _x(5, *jout.shape)
    jgrads, = vjp(jnp.asarray(cot).astype(jout.dtype))
    xt = torch.from_numpy(x)
    out = m(xt if name == "hatnoup" else xt.to(BF16), *extra)
    assert out.dtype == BF16 and jout.dtype == jnp.bfloat16
    assert all(t.dtype == torch.float32 for t in m.parameters())
    (out.float() * torch.from_numpy(cot)).sum().backward()
    depth = DEPTH[name]
    ref = np.asarray(jout.astype(jnp.float32))
    got = out.detach().float().numpy()
    assert _rel_l2([got], [ref]) <= STEP * depth
    assert np.abs(got - ref).max() <= STEP * depth * np.abs(ref).max()
    # the port's gradients in the JAX tree's layout: the whole encoder's
    # (zeros outside the module) through convert_hat, then its subtree
    grads = convert_hat({k: torch.zeros_like(p) if p.grad is None else p.grad
                         for k, p in enc.named_parameters()})
    for key in path:
        grads = grads[key]
    assert jax.tree_util.tree_structure(grads) == \
        jax.tree_util.tree_structure(jgrads)
    got_b, got_w = _split_biases(grads)
    ref_b, ref_w = _split_biases(jgrads)
    assert _rel_l2(got_w, ref_w) <= STEP * depth
    # XLA's CPU reduction of a bf16 bias gradient runs in bf16 (PyTorch's
    # in f32, rounded once): log2 of the positions summed more roundings
    n_pos = x.size // x.shape[-1]
    assert _rel_l2(got_b, ref_b) <= STEP * (depth + math.log2(n_pos))


# -- the slice: one tiny Ultra step against the JAX Trainer -----------------


def _tiny_batch(seed, b=1, lr_size=32):
    """b samples of lr_size^2 LR at scales in [1, 2], gt = ceil(s lr) (the
    Ultra recipe's round_mode) on the 64x64 canvas."""
    rng = np.random.default_rng(seed)
    scales = (1.0 + rng.random(b)).astype(np.float32)
    gt = np.ceil(scales * lr_size).astype(np.int32)
    return {"lq": rng.random((b, lr_size, lr_size, 3), dtype=np.float32),
            "gt": rng.random((b, 64, 64, 3), dtype=np.float32),
            "scale": scales, "gt_h": gt, "gt_w": gt}


def test_ultra_trainer_step_matches_jax():
    """One Trainer step of the Ultra recipe in small (a bf16 HAT of one
    RHAG of two HABs, the second shifted, and OCAB, at window 16 on 32x32
    LR; the bf16 Enhanced decoder at 256 seeds in windows of 16; fp32
    parameters, Adam, no clip, drop_path_rate 0) against the JAX Trainer
    with the same networks in bf16, from the same weights and batch:
    - loss within 2^-8 relative;
    - each network's gradient within relative L2 2^-8 x its bf16 depth
      (the decoder DEC_DEPTH, the encoder behind it and its own 50);
    - the parameters after the update: Adam's first step moves each weight
      by about lr sign(g), so a gradient within bf16 noise of 0 can move it
      the other way: every weight within 2 lr of JAX's, the mean difference
      below 0.05 lr;
    - the EMA, e d + p (1 - d) from the same start, within (1 - d) 2 lr of
      JAX's plus a float32 rounding of the largest entry."""
    g = torch.Generator().manual_seed(6)
    enc = init_weights(HATNOUP(**TINY_HAT), g)
    dec = init_weights(Fea2GSRopeAMP(**TINY_DEC), g)
    params = jax.tree_util.tree_map(jnp.asarray, {
        "g": convert_hat(enc.state_dict()),
        "d": convert_fea2gs_rope(dec.state_dict())})
    esd, dsd = params_from_jax(params["g"], params["d"])
    enc = load_params(HATNOUP(**TINY_HAT, dtype=BF16), esd)
    dec = load_params(Fea2GSRopeAMP(**TINY_DEC, dtype=BF16), dsd)
    batch = _tiny_batch(7)
    jtr = JTrainer(jhat.HATNOUP(**TINY_HAT, dtype=jnp.bfloat16),
                   JRope(**TINY_DEC, dtype=jnp.bfloat16),
                   JTrainConfig(**CFG), mesh=make_mesh(jax.devices()[:1]))
    # eager, as in test_bf16_hat_modules_match_jax
    (jloss, _), jgrads = jax.value_and_grad(jtr._loss_fn, has_aux=True)(
        params, jax.tree_util.tree_map(jnp.asarray, batch),
        jax.random.PRNGKey(0))
    updates, _ = jax.jit(jtr.tx.update)(jgrads, jtr.tx.init(params), params)
    jnew = optax.apply_updates(params, updates)

    tr = Trainer(enc, dec, TrainConfig(**CFG), device="cpu")
    loss, met, g_g, g_d = tr.grads(batch)
    assert all(t.dtype == torch.float32 for t in g_g + g_d)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP)
    want = params_from_jax(jgrads["g"], jgrads["d"])
    for mod, grads, depth, ref in (
            (tr.enc, g_g, DEC_DEPTH + DEPTH["hatnoup"], want[0]),
            (tr.dec, g_d, DEC_DEPTH, want[1])):
        names = [n for n, _ in mod.named_parameters()]
        dist = _rel_l2([t.numpy() for t in grads],
                       [ref[n].numpy() for n in names])
        assert dist <= STEP * depth, (type(mod).__name__, dist)

    tr.apply(loss, met, g_g, g_d)
    lr, d = 2e-4, tr.cfg.ema_decay
    new = params_from_jax(jnew["g"], jnew["d"])
    start = params_from_jax(params["g"], params["d"])
    diffs = []
    for i, (mod, ema) in enumerate(((tr.enc, tr.ema_g), (tr.dec, tr.ema_d))):
        emas = dict(ema.named_parameters())
        for name, p in mod.named_parameters():
            got, ref = p.detach().numpy(), new[i][name].numpy()
            diff = np.abs(got - ref)
            assert diff.max() <= 2 * lr + 1e-6, (name, float(diff.max()))
            diffs.append(diff.ravel())
            e0 = start[i][name].numpy()
            jema = e0 * d + ref * (1.0 - d)
            tol = (1.0 - d) * 2 * lr + 2.0 ** -22 * np.abs(e0).max()
            assert np.abs(emas[name].numpy() - jema).max() <= tol, name
    assert np.concatenate(diffs).mean() <= 0.05 * lr


# -- the repair ---------------------------------------------------------------


def test_hat_droppath_trains_and_repeats():
    """HATNOUP keeps drop_path_rate, so the Trainer hands it the step's
    DropPath generator (without it, DropPath raises in training mode): one
    CPU step of a tiny HAT with stochastic depth trains, the training
    forward differs from the eval forward (the masks are drawn), and two
    trainers from the same weights and seed take the same step, bit for
    bit (the masks come from (seed, step))."""
    g = torch.Generator().manual_seed(8)
    kw = dict(embed_dim=C, depths=(3,), num_heads=(NH,), window_size=4,
              squeeze_factor=4, mlp_ratio=2, num_feat=8, drop_path_rate=0.5)
    batch = _tiny_batch(9, b=2, lr_size=8)
    enc = init_weights(HATNOUP(**kw), g)
    assert enc.drop_path_rate == 0.5
    dec = init_weights(Fea2GSRopeAMP(inchannel=8, channel=C, num_heads=NH,
                                     num_crossattn_layers=1,
                                     num_selfattn_blocks=1,
                                     num_selfattn_layers=1, num_gs_seed=16,
                                     window_size=4), g)
    trs = [Trainer(copy.deepcopy(enc), copy.deepcopy(dec),
                   TrainConfig(**dict(CFG, seed=3)), device="cpu")
           for _ in range(2)]
    lq = trs[0].to_device(batch)["lq"]
    with torch.no_grad():
        train_out = trs[0].enc(lq, generator=trs[0].droppath_generator())
        eval_out = copy.deepcopy(trs[0].enc).eval()(lq)
    assert not torch.equal(train_out, eval_out)
    metrics = [tr.step(batch) for tr in trs]
    assert math.isfinite(float(metrics[0]["loss"]))
    assert torch.equal(metrics[0]["loss"], metrics[1]["loss"])
    for a, b in zip(trs[0].params_g + trs[0].params_d,
                    trs[1].params_g + trs[1].params_d):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in
               zip(trs[0].params_g, enc.parameters()))


# -- make_models' dtype -------------------------------------------------------


def test_make_models_dtype():
    """make_models takes JAX's dtype keyword: bf16 HAT-L Ultra (the
    reference's --AMP_test) builds bf16 modules on fp32 parameters, as do
    EDSR and RDN with the Enhanced decoder (SwinIR too:
    tests/test_torch_swinir_bf16.py) and EDSR with the paper decoder, as
    JAX's make_models builds Fea2GS(dtype=dtype); inference runs the paper
    decoder's fused trunk in fp32 all the same (fused_dtype)."""
    from gsasr_torch.model import make_models

    enc, dec = make_models("hat", "ultra", dtype=BF16, device="cpu")
    assert enc.dtype == dec.dtype == BF16 and not enc.training
    assert enc.layers[11].residual_group["overlap_attn"].qkv.compute_dtype \
        == BF16
    assert all(p.dtype == torch.float32 for p in
               list(enc.parameters()) + list(dec.parameters()))
    enc32, _ = make_models("hat", "ultra", device="cpu")
    for (k, v), v32 in zip(enc.state_dict().items(),
                           enc32.state_dict().values()):
        assert torch.equal(v, v32), k
    assert make_models("rdn", "enhanced", dtype=BF16,
                       device="cpu")[0].dtype == BF16
    from gsasr_torch.model import fused_dtype

    enc, dec = make_models("edsr", "paper", dtype=BF16, device="cpu")
    assert enc.dtype == dec.dtype == BF16 and not dec.training
    assert dec.head_dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in
               list(enc.parameters()) + list(dec.parameters()))
    assert fused_dtype(dec) == torch.float32
