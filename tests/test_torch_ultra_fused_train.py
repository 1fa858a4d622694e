"""gsasr_torch's window-16 fused Enhanced training path (the HAT-L Ultra and
SwinIR-Enhanced decoders: 256 seeds in windows of 16) against gsasr_tpu on
the CPU.

- Kernel AB-long's plain version (the backward of A at T = 256, through
  ln_attn_proj's autograd Function) against jax.vjp of the JAX package's
  ln_attn_proj, whose custom VJP runs the Pallas kernel K10 in interpret
  mode: RoPE cross- and self-attention in fp32 and bf16 (the four table
  gradients among the outputs) and the bias form in fp32.
- The window-16 fused decoder's gradients, rope_freqs included, against
  jax.grad of the JAX fused decoder, fp32 and with a bf16 trunk.
- The port's fused path against its module path (Trainer, both types).
- One bf16 fused Trainer step (a tiny EDSR with the window-16 decoder)
  against the JAX Trainer(fused_decoder=True): loss, gradients, the update
  and the EMA.
- train_hatl_ultra.yml and train_swinir_amp.yml with train.fused_decoder
  set, cut in width, build a fused Trainer that steps.

Inputs are made with numpy from a seed; weights are drawn by the port,
read into JAX trees by the reference converters and loaded into fresh port
modules with params_from_jax. bf16 tolerances as
tests/test_torch_enhanced_fused_train.py states them: both sides round at
the same points but sum their f32 products in another order, so a rounded
value lands one bf16 step (2^-8 relative) apart now and then and carries
that on through every later bf16 product.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gsasr_tpu.models import EDSRNOUP as JEDSR
from gsasr_tpu.models import Fea2GSRopeAMP as JRope
from gsasr_tpu.models.fea2gs_rope_fast import \
    fea2gs_rope_apply_fused as jfused
from gsasr_tpu.ops import fused_layers as jf
from gsasr_tpu.parallel.mesh import make_mesh
from gsasr_tpu.train import TrainConfig as JTrainConfig
from gsasr_tpu.train import Trainer as JTrainer
from gsasr_tpu.utils.torch_convert import convert_edsr, convert_fea2gs_rope
from gsasr_torch.models import EDSRNOUP, Fea2GSRopeAMP
from gsasr_torch.models.fea2gs_rope_fast import fea2gs_rope_apply_fused
from gsasr_torch.models.init import init_weights
from gsasr_torch.ops import fused_layers as tf
from gsasr_torch.train import TrainConfig, Trainer
from gsasr_torch.utils.convert import load_params, params_from_jax

ROOT = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16
STEP = 2.0 ** -8
# (windows, tokens, channels, heads): a window of 16 (256 tokens), narrow
B, T, C, NH = 2, 256, 16, 2
# weights whose JAX layout is the transpose of nn.Linear's
_TRANSPOSED = {"wq", "wk", "wv", "wo"}
# activations: bf16 on both sides in the bf16 cases
_ACT = {"x", "pos", "kv"}
# the window-16 Enhanced decoder, narrow and cut to one cross-attention and
# one self-attention layer: 256 seeds in windows of 16, as the Ultra and
# SwinIR-Enhanced decoders
DEC16 = dict(inchannel=8, channel=16, num_heads=2, num_crossattn_blocks=1,
             num_crossattn_layers=1, num_selfattn_blocks=1,
             num_selfattn_layers=1, num_gs_seed=256, window_size=16)
ENC_KW = dict(num_feat=8, num_block=1)
# bf16 sub-layers of DEC16's decoder, loss to input: conv_final and per
# block its lattice conv and tail MLP, per layer its inject, two FFNs and
# attention (tests/test_torch_enhanced_fused_train.py's count)
DEC_DEPTH = 1 + 2 * 2 + 4 * 2
CFG = dict(canvas_hw=(32, 32), warmup_iter=-1, milestones=(100,),
           clip_grad_norm=None)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one intra-op thread, restored after the file, as
    tests/test_torch_enhanced_fused_train.py does: its many small ops run
    far slower in the six-worker suite when every worker's thread pool
    spins on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_close(got, ref, tol, name, scale=None):
    """|got - ref| <= tol * (the column's largest |ref|, or `scale`) +
    tol * |ref|: sums over rows and windows cancel, so an entry's error
    follows its column's scale. Vectors take their largest entry."""
    r = ref.reshape(-1, ref.shape[-1]) if ref.ndim >= 2 else ref.reshape(1, -1)
    if scale is None:
        scale = np.abs(r).max(axis=0) if ref.ndim >= 2 else np.abs(r).max()
    err = np.abs(np.asarray(got, np.float32).reshape(r.shape) - r)
    bad = err > tol * scale + tol * np.abs(r)
    assert not bad.any(), (name, float(err.max()), float(np.abs(r).max()))


def _attn_args(rng, opts):
    """ln_attn_proj's arguments at T = 256: weights, LN, and RoPE tables of
    random angles (pair-duplicated), a bias, or pos and kv."""
    args = {"x": rng.standard_normal((B, T, C)).astype(np.float32)}
    bound = 1 / np.sqrt(C)
    for n in ("q", "k", "v", "o"):
        args[f"w{n}"] = rng.uniform(-bound, bound, (C, C)).astype(np.float32)
        args[f"b{n}"] = rng.uniform(-bound, bound, C).astype(np.float32)
    args["ln_w"] = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    args["ln_b"] = (0.1 * rng.standard_normal(C)).astype(np.float32)
    if "rope" in opts:
        for s in ("q", "k"):
            ang = rng.uniform(-np.pi, np.pi, (T, C // 2))
            args[f"rope_cos_{s}"] = np.repeat(np.cos(ang), 2, -1).astype(
                np.float32)
            args[f"rope_sin_{s}"] = np.repeat(np.sin(ang), 2, -1).astype(
                np.float32)
    if "bias" in opts:
        args["bias"] = (0.5 * rng.standard_normal((NH, T, T))).astype(
            np.float32)
    if "cross" in opts:
        args["pos"] = rng.standard_normal((T, C)).astype(np.float32)
        args["kv"] = rng.standard_normal((B, T, C)).astype(np.float32)
    return args


@pytest.mark.parametrize("opts,bf16", [
    ("rope_cross", False), ("rope_self", False), ("rope_cross", True),
    ("rope_self", True), ("bias_self", False)])
def test_ln_attn_proj_vjp_matches_jax_at_256(opts, bf16):
    """AB-long's plain version at T = 256 (2 windows, 2 heads of 8) against
    jax.vjp of K10: RoPE cross-attention (pos, kv) and self-attention in
    fp32 and bf16, and the bias form in fp32; every output, the four table
    gradients and dbias included. fp32 within 1e-5 of the column's scale;
    bf16 within 2^-7, the bounds of tests/test_torch_enhanced_fused_train.py
    (the k bias's true gradient is 0: both sides are noise, held to the k
    weight's scale)."""
    rng = np.random.default_rng(len(opts) + 10 * bf16)
    args = _attn_args(rng, opts)
    g = rng.standard_normal((B, T, C)).astype(np.float32)
    names = list(args)

    def jfn(*vals):
        kw = {n: v.astype(jnp.bfloat16) if bf16 and n in _ACT else v
              for n, v in zip(names, vals)}
        return jf.ln_attn_proj(num_heads=NH, **kw).astype(jnp.float32)

    _, vjp = jax.vjp(jfn, *[jnp.asarray(args[n].T if n in _TRANSPOSED
                                        else args[n]) for n in names])
    want = {n: np.asarray(d, np.float32) for n, d in
            zip(names, vjp(jnp.asarray(g)))}
    want = {n: d.T if n in _TRANSPOSED else d for n, d in want.items()}
    ts = {n: torch.from_numpy(v).requires_grad_() for n, v in args.items()}
    kw = {n: v.to(BF16) if bf16 and n in _ACT else v for n, v in ts.items()}
    out = tf.ln_attn_proj(num_heads=NH, **kw).float()
    got = dict(zip(names, torch.autograd.grad(out, list(ts.values()),
                                              torch.from_numpy(g))))
    for n in names:
        scale = np.abs(want["wk"]).max() if n == "bk" else None
        _assert_close(got[n].numpy(), want[n], 2 * STEP if bf16 else 1e-5,
                      n, scale)


# -- the whole window-16 fused decoder ---------------------------------------


def _weights(seed, dec_kw=DEC16):
    """JAX (g, d) params of a tiny EDSR and the decoder, drawn by the port's
    initializers and read by the reference converters."""
    g = torch.Generator().manual_seed(seed)
    ep = convert_edsr(init_weights(EDSRNOUP(**ENC_KW), g).state_dict())
    dp = convert_fea2gs_rope(init_weights(Fea2GSRopeAMP(**dec_kw),
                                          g).state_dict())
    return jax.tree_util.tree_map(jnp.asarray, {"g": ep, "d": dp})


def _port(params, dtype=torch.float32):
    """Fresh port modules in `dtype` loaded with the JAX params."""
    esd, dsd = params_from_jax(params["g"], params["d"])
    return (load_params(EDSRNOUP(**ENC_KW, dtype=dtype), esd),
            load_params(Fea2GSRopeAMP(**DEC16, dtype=dtype), dsd))


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def decoder_grads(request):
    """The window-16 fused decoder's loss sum(w * out) and parameter
    gradients, port and JAX (jax.grad through its fused path, K7-K10 in
    interpret mode at T = 256), on one sample (one window) in one trunk
    type: (bf16, loss, port grads, JAX loss, JAX grads by port name)."""
    bf16 = request.param == "bf16"
    params = _weights(1)
    _, dec = _port(params)
    rng = np.random.default_rng(2)
    srcs = rng.random((1, 16, 16, DEC16["inchannel"]), dtype=np.float32)
    scale = np.float32([2.5])
    out = fea2gs_rope_apply_fused(dec, torch.from_numpy(srcs),
                                  torch.from_numpy(scale),
                                  dtype=BF16 if bf16 else None)
    w = rng.standard_normal(tuple(out.shape)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jnp.asarray(w) * jfused(
            JRope(**DEC16), {"params": p}, jnp.asarray(srcs),
            jnp.asarray(scale), dtype=jnp.bfloat16 if bf16 else None))

    jl, jgrad = jax.jit(jax.value_and_grad(jloss))(params["d"])
    want = {k: v.numpy() for k, v in
            params_from_jax(params["g"], jgrad)[1].items()}
    loss = (out * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(loss, list(dec.parameters()),
                                allow_unused=True)
    got = {n: (np.zeros(p.shape, np.float32) if d is None else d.numpy())
           for (n, p), d in zip(dec.named_parameters(), grads)}
    assert sorted(got) == sorted(want)
    return bf16, float(loss.detach()), got, float(jl), want


def test_window16_fused_decoder_grads_match_jax(decoder_grads):
    """Every parameter's gradient of sum(w * fea2gs_rope_apply_fused(...))
    at 256 seeds in windows of 16, the RoPE frequencies (through the
    tables' gradients of AB-long) among them, against jax.grad through the
    JAX fused decoder. fp32: the loss within 1e-5 relative, each gradient
    within 1e-4 of its tensor's largest entry. bf16 trunk: the loss within
    2^-8 relative, the whole decoder's gradient within relative L2 2^-8 x
    DEC_DEPTH of JAX's and each tensor's within 2^-7 x DEC_DEPTH (PR 9's
    bounds for the decoder at 144 seeds)."""
    bf16, loss, got, jl, want = decoder_grads
    np.testing.assert_allclose(loss, jl, rtol=STEP if bf16 else 1e-5)
    assert any("rope_freqs" in n for n in got)
    num = den = 0.0
    for name, g in got.items():
        ref = want[name]
        if bf16:
            d, r = np.linalg.norm(g - ref), np.linalg.norm(ref)
            assert d <= 2 * STEP * DEC_DEPTH * r + 1e-12, (name, d, r)
            num, den = num + d ** 2, den + r ** 2
        else:
            np.testing.assert_allclose(
                g, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max() + 1e-7,
                err_msg=name)
    assert num ** 0.5 <= STEP * DEC_DEPTH * den ** 0.5


# -- Trainer ------------------------------------------------------------------


def _batch(seed, b=2, lr_size=16, canvas=32):
    """b samples of lr_size^2 LR (one window of 16 each) at scales in [1,
    2], gt = ceil(s lr) on the canvas."""
    rng = np.random.default_rng(seed)
    scales = (1.0 + rng.random(b)).astype(np.float32)
    gt = np.ceil(scales * lr_size).astype(np.int32)
    return {"lq": rng.random((b, lr_size, lr_size, 3), dtype=np.float32),
            "gt": rng.random((b, canvas, canvas, 3), dtype=np.float32),
            "scale": scales, "gt_h": gt, "gt_w": gt}


def _rel_l2(mod, grads, want):
    num = den = 0.0
    for (n, _), g in zip(mod.named_parameters(), grads):
        ref = want[n].astype(np.float64)
        num += float(((g.numpy().astype(np.float64) - ref) ** 2).sum())
        den += float((ref ** 2).sum())
    return (num / den) ** 0.5


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_window16_fused_trainer_matches_module_path(dtype):
    """A tiny EDSR with the window-16 decoder trains on the fused decoder
    (A-long and AB-long on the card) in fp32 and bf16: the step's loss and
    gradients against the same Trainer on the module path (fp32: loss 1e-5
    relative, gradients 1e-4 relative L2 per network, the same float32
    sub-layers in another order; bf16: loss 2^-8 relative, gradients 2^-8
    x DEC_DEPTH relative L2, the two paths round at other points), then
    one step moves both networks and the EMA."""
    dt = BF16 if dtype == "bf16" else torch.float32
    params = _weights(8)
    batch = _batch(9)
    res = []
    for fused in (False, True):
        enc, dec = _port(params, dt)
        tr = Trainer(enc, dec, TrainConfig(**CFG, fused_decoder=fused),
                     device="cpu")
        res.append((tr, tr.grads(batch)))
    (_, (l_mod, _, gm_g, gm_d)), (tr, (l_f, _, gf_g, gf_d)) = res
    tol = STEP * DEC_DEPTH if dt == BF16 else 1e-4
    np.testing.assert_allclose(float(l_f), float(l_mod),
                               rtol=STEP if dt == BF16 else 1e-5)
    for mod, a, b in ((tr.enc, gf_g, gm_g), (tr.dec, gf_d, gm_d)):
        want = {n: g.numpy() for (n, _), g in zip(mod.named_parameters(), b)}
        assert _rel_l2(mod, a, want) <= tol
    start = [p.detach().clone() for p in tr.params_g + tr.params_d]
    ema = [p.detach().clone() for p in tr.ema_d.parameters()]
    m = tr.step(batch)
    assert np.isfinite(float(m["loss"]))
    assert any(not torch.equal(a, p) for a, p in zip(start, tr.params_g))
    assert any(not torch.equal(a, p) for a, p in
               zip(start[len(tr.params_g):], tr.params_d))
    assert any(not torch.equal(a, p) for a, p in
               zip(ema, tr.ema_d.parameters()))


def _by_name(tree_g, tree_d):
    sd_g, sd_d = params_from_jax(tree_g, tree_d)
    return ({k: v.numpy() for k, v in sd_g.items()},
            {k: v.numpy() for k, v in sd_d.items()})


def test_bf16_window16_fused_trainer_step_matches_jax():
    """One fused Trainer step of the bf16 recipe with the window-16
    decoder (a tiny bf16 EDSR, whose encoder keeps JAX's eager OCAB out of
    the test; the decoder through fea2gs_rope_apply_fused with a bf16 trunk
    and fp32 UPNet and heads; fp32 parameters, Adam, no clip) against the
    JAX Trainer(fused_decoder=True) with the same networks in bf16, from
    the same weights and batch:
    - loss within 2^-8 relative;
    - each network's gradient within relative L2 2^-8 x its bf16 depth
      (the decoder DEC_DEPTH, the encoder behind it and its own three
      convs);
    - the parameters after the update: Adam's first step moves each weight
      by about lr sign(g), so a gradient within bf16 noise of 0 can move it
      the other way: every weight within 2 lr of JAX's, the mean difference
      below 0.05 lr;
    - the EMA, e d + p (1 - d) from the same start, within (1 - d) 2 lr of
      JAX's plus a float32 rounding of the largest entry."""
    params = _weights(6)
    enc, dec = _port(params, dtype=BF16)
    batch = _batch(7)
    jtr = JTrainer(JEDSR(**ENC_KW, dtype=jnp.bfloat16),
                   JRope(**DEC16, dtype=jnp.bfloat16),
                   JTrainConfig(**CFG, fused_decoder=True),
                   mesh=make_mesh(jax.devices()[:1]))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jtr._loss_fn,
                                                    has_aux=True))(
        params, jax.tree_util.tree_map(jnp.asarray, batch),
        jax.random.PRNGKey(0))
    updates, _ = jax.jit(jtr.tx.update)(jgrads, jtr.tx.init(params), params)
    jnew = _by_name(*(lambda t: (t["g"], t["d"]))(
        optax.apply_updates(params, updates)))
    start = _by_name(params["g"], params["d"])

    tr = Trainer(enc, dec, TrainConfig(**CFG, fused_decoder=True),
                 device="cpu")
    loss, met, g_g, g_d = tr.grads(batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP)
    want = _by_name(jgrads["g"], jgrads["d"])
    for mod, grads, w, depth in ((tr.enc, g_g, want[0], DEC_DEPTH + 3),
                                 (tr.dec, g_d, want[1], DEC_DEPTH)):
        assert _rel_l2(mod, grads, w) <= STEP * depth
    tr.apply(loss, met, g_g, g_d)
    lr, d = CFG.get("lr", 2e-4), tr.cfg.ema_decay
    diffs = []
    for i, (mod, ema) in enumerate(((tr.enc, tr.ema_g), (tr.dec, tr.ema_d))):
        emas = dict(ema.named_parameters())
        for n, p in mod.named_parameters():
            ref = jnew[i][n]
            diff = np.abs(p.detach().numpy() - ref)
            assert diff.max() <= 2 * lr + 1e-6, (n, float(diff.max()))
            diffs.append(diff.ravel())
            e0 = start[i][n]
            jema = e0 * d + ref * (1.0 - d)
            tol = (1.0 - d) * 2 * lr + 2.0 ** -22 * np.abs(e0).max()
            assert np.abs(emas[n].detach().numpy() - jema).max() <= tol, n
    assert np.concatenate(diffs).mean() <= 0.05 * lr


# the recipes cut in width (depth and windows kept where the CPU allows):
# the encoder to one narrow group, the decoder to 24 channels in 6 heads
# of one cross and one self block, at 256 seeds in windows of 16
_NARROW = {
    "train_hatl_ultra.yml": dict(embed_dim=24, depths=[2], num_heads=[6],
                                 squeeze_factor=4),
    "train_swinir_amp.yml": dict(embed_dim=24, depths=[2], num_heads=[6]),
}


@pytest.mark.parametrize("yml", sorted(_NARROW))
def test_window16_recipes_build_a_fused_trainer_that_steps(yml):
    """train_hatl_ultra.yml and train_swinir_amp.yml with
    train.fused_decoder=true give a fused Trainer of their bf16 networks at
    256 seeds in windows of 16; cut in width (and the canvas to 32x32 by
    the dataset's LR size and scales), one step on the CPU is finite and
    moves both networks."""
    from gsasr_torch.config import (apply_overrides, build_networks,
                                    build_train_config, load_options)

    opt = load_options(ROOT / "configs" / yml)
    apply_overrides(opt, ["train.fused_decoder=true",
                          "datasets.train.lr_size=16",
                          "datasets.train.scale_list=[1, 2]"])
    opt["network_g"] = dict(opt["network_g"], **_NARROW[yml])
    opt["network_fea2gs"] = dict(
        opt["network_fea2gs"], channel=24, num_heads=6,
        num_crossattn_blocks=1, num_crossattn_layers=1,
        num_selfattn_blocks=1, num_selfattn_layers=1)
    cfg = build_train_config(opt)
    assert cfg.fused_decoder and cfg.canvas_hw == (32, 32)
    enc, dec = build_networks(opt)
    assert isinstance(dec, Fea2GSRopeAMP) and dec.dtype == BF16
    assert (dec.num_gs_seed, dec.window_size) == (256, 16)
    tr = Trainer(enc, dec, cfg, device="cpu")
    start = [p.detach().clone() for p in tr.params_g + tr.params_d]
    m = tr.step(_batch(11))
    assert np.isfinite(float(m["loss"]))
    n = len(tr.params_g)
    assert any(not torch.equal(a, p) for a, p in zip(start[:n], tr.params_g))
    assert any(not torch.equal(a, p) for a, p in zip(start[n:], tr.params_d))
