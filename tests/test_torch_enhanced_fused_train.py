"""gsasr_torch's fused Enhanced training path against gsasr_tpu on the CPU.

- Kernels MB (zero_base, and bf16 in the decoder's three option sets) and
  AB (RoPE cross- and self-attention in fp32 and bf16, the paper bias
  forms in bf16) through their autograd Functions (the plain versions here)
  against jax.vjp of the JAX package's fused layers, whose custom VJPs run
  the Pallas kernels K9 and K10 in interpret mode; the four RoPE-table
  gradients among them.
- The whole fused Enhanced decoder's gradients, rope_freqs included,
  against jax.grad of the JAX fused decoder, fp32 and with a bf16 trunk.
- One bf16 fused Trainer step against the JAX Trainer(fused_decoder=True).
- The port's fused path against its module path (fp32 gradients; EDSR and
  RDN trainers in fp32 and bf16), and the recipes with fused_decoder set.

Inputs are made with numpy from a seed. Weights are drawn by the port, read
into JAX trees by the JAX package's reference converter and loaded into
fresh port modules with params_from_jax.

bf16 tolerances. Both sides round at the same points but sum their f32
products in another order, so a rounded value lands one bf16 step (2^-8
relative) apart now and then, and the step is carried on through every
later bf16 product; each tolerance says how many it crosses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gsasr_tpu.models import EDSRNOUP as JEDSR
from gsasr_tpu.models import Fea2GSRopeAMP as JRope
from gsasr_tpu.ops import fused_layers as jf
from gsasr_tpu.parallel.mesh import make_mesh
from gsasr_tpu.train import TrainConfig as JTrainConfig
from gsasr_tpu.train import Trainer as JTrainer
from gsasr_tpu.utils.torch_convert import (convert_edsr, convert_fea2gs_rope,
                                           convert_rdn)
from gsasr_torch.models import EDSRNOUP, RDNNOUP, Fea2GSRopeAMP
from gsasr_torch.models.fea2gs_rope_fast import fea2gs_rope_apply_fused
from gsasr_torch.models.init import init_weights
from gsasr_torch.ops import fused_layers as tf
from gsasr_torch.train import TrainConfig, Trainer
from gsasr_torch.utils.convert import load_params, params_from_jax

BF16 = torch.bfloat16
STEP = 2.0 ** -8
# (windows, tokens, channels, heads): even head widths (RoPE pairs and the
# bf16 forms), a window count that is no multiple of the JAX block of 8
B, T, C, NH = 5, 16, 24, 4
# weights whose JAX layout is the transpose of nn.Linear's
_TRANSPOSED = {"w1", "w2", "wq", "wk", "wv", "wo"}
# activations: bf16 on both sides in the bf16 cases
_ACT = {"x", "inj", "resi", "pos", "kv"}
# a tiny Enhanced decoder with a shifted cross- and self-attention layer;
# ws^2 == num_gs_seed, where the JAX fast path's k table is whole
DEC_KW = dict(inchannel=8, channel=24, num_heads=6, num_crossattn_blocks=1,
              num_crossattn_layers=2, num_selfattn_blocks=1,
              num_selfattn_layers=2, num_gs_seed=16, window_size=4)
ENC_KW = dict(num_feat=8, num_block=1)
# bf16 sub-layers of DEC_KW's decoder, loss to input: conv_final and per
# block its lattice conv and tail MLP, per layer its inject, two FFNs and
# attention (UPNet and the heads are fp32 on the fused path)
DEC_DEPTH = 1 + 2 * 2 + 4 * 4
CFG = dict(canvas_hw=(32, 32), warmup_iter=-1, milestones=(100,),
           clip_grad_norm=None)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one intra-op thread, restored after the file:
    its many small products and convolutions (RDN's 146 dense
    convolutions among them) ran 40 times slower in the six-worker suite,
    each worker's thread pool spinning on the same cores, than alone."""
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


def _lin(rng, n_out, n_in):
    bound = 1 / np.sqrt(n_in)
    return (rng.uniform(-bound, bound, (n_out, n_in)).astype(np.float32),
            rng.uniform(-bound, bound, n_out).astype(np.float32))


def _ln_params(rng, c):
    return ((1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32))


def _tables(rng, n, c):
    """Pair-duplicated (n, c) cos and sin tables of random angles."""
    ang = rng.uniform(-np.pi, np.pi, (n, c // 2))
    return (np.repeat(np.cos(ang), 2, -1).astype(np.float32),
            np.repeat(np.sin(ang), 2, -1).astype(np.float32))


def _vjp_both(jax_fn, torch_fn, args, g, bf16):
    """(port gradients, JAX gradients) of the named float32 numpy args at
    cotangent g. With bf16 both sides take the activations in bf16 and
    return the output in f32 (so g is rounded to bf16 on both sides); JAX
    takes the transposed weights and its gradients come back in the port's
    layout, in f32."""
    names = list(args)

    def jf_(*vals):
        kw = {n: v.astype(jnp.bfloat16) if bf16 and n in _ACT else v
              for n, v in zip(names, vals)}
        return jax_fn(**kw).astype(jnp.float32)

    jvals = [jnp.asarray(args[n].T if n in _TRANSPOSED else args[n])
             for n in names]
    _, vjp = jax.vjp(jf_, *jvals)
    jgrads = [np.asarray(d, np.float32) for d in vjp(jnp.asarray(g))]
    jgrads = {n: (d.T if n in _TRANSPOSED else d)
              for n, d in zip(names, jgrads)}
    ts = {n: torch.from_numpy(v).requires_grad_() for n, v in args.items()}
    kw = {n: v.to(BF16) if bf16 and n in _ACT else v for n, v in ts.items()}
    out = torch_fn(**kw).float()
    tgrads = torch.autograd.grad(out, list(ts.values()), torch.from_numpy(g))
    return {n: d.numpy() for n, d in zip(names, tgrads)}, jgrads


@pytest.mark.parametrize("opts,bf16", [
    ("zero_base", False), ("ln_inj", True), ("ln", True),
    ("zero_base", True)])
def test_ln_mlp_residual_vjp_matches_jax(opts, bf16):
    """K9's zero_base form (the Enhanced block tails) and its bf16 forms in
    the decoder's three option sets: (LN, inj, base x+inj), (LN, base x),
    (no LN, zero base)."""
    rng = np.random.default_rng(len(opts) + 10 * bf16)
    args = {"x": rng.standard_normal((B, T, C)).astype(np.float32)}
    args["w1"], args["b1"] = _lin(rng, C, C)
    args["w2"], args["b2"] = _lin(rng, C, C)
    if opts != "zero_base":
        args["ln_w"], args["ln_b"] = _ln_params(rng, C)
    if opts == "ln_inj":
        args["inj"] = rng.standard_normal((B, C)).astype(np.float32)
    zb = opts == "zero_base"
    g = rng.standard_normal((B, T, C)).astype(np.float32)
    got, want = _vjp_both(
        lambda x, **kw: jf.ln_mlp_residual(x, zero_base=zb, **kw),
        lambda x, **kw: tf.ln_mlp_residual(x, zero_base=zb, **kw),
        args, g, bf16)
    for n in args:
        # fp32: 1e-5 of the column's scale, as the paper forms' test.
        # bf16: one bf16 step: dx and dinj are rounded once, after products
        # whose rounded operands (h, z1, dz1) may sit one step apart
        # (worst seen: dx and dinj bit-equal, the weight gradients 2e-7)
        _assert_close(got[n], want[n], STEP if bf16 else 1e-5, n)


def _attn_args(rng, opts):
    args = {"x": rng.standard_normal((B, T, C)).astype(np.float32)}
    for n in ("q", "k", "v", "o"):
        args[f"w{n}"], args[f"b{n}"] = _lin(rng, C, C)
    args["ln_w"], args["ln_b"] = _ln_params(rng, C)
    if "rope" in opts:
        args["rope_cos_q"], args["rope_sin_q"] = _tables(rng, T, C)
        args["rope_cos_k"], args["rope_sin_k"] = _tables(rng, T, C)
    if "bias" in opts:
        args["bias"] = (0.5 * rng.standard_normal((NH, T, T))).astype(
            np.float32)
    if "cross" in opts:
        args["pos"] = rng.standard_normal((T, C)).astype(np.float32)
        args["kv"] = rng.standard_normal((B, T, C)).astype(np.float32)
    return args


@pytest.mark.parametrize("opts,bf16", [
    ("rope_cross", False), ("rope_self", False), ("rope_cross", True),
    ("rope_self", True), ("bias_cross", True), ("bias_self", True)])
def test_ln_attn_proj_vjp_matches_jax(opts, bf16):
    """K10's RoPE forms (cross-attention with pos and kv, self-attention;
    the four table gradients among the outputs) in fp32 and bf16, and the
    paper's bias forms in bf16."""
    rng = np.random.default_rng(len(opts) + 10 * bf16)
    args = _attn_args(rng, opts)
    g = rng.standard_normal((B, T, C)).astype(np.float32)
    got, want = _vjp_both(
        lambda x, **kw: jf.ln_attn_proj(x, num_heads=NH, **kw),
        lambda x, **kw: tf.ln_attn_proj(x, num_heads=NH, **kw), args, g,
        bf16)
    for n in args:
        # fp32: 1e-5 of the column's scale, as the paper forms' test.
        # bf16: 2^-7: the chain rounds q, k, v, p, att, g wo^T, ds and the
        # back-rotated dq, dk, dv; a one-step difference in one of them
        # reaches dx through one more rounded product (worst seen: dx, dkv
        # and dpos bit-equal, the weight and table gradients 2.4e-7). The k
        # bias's true gradient is 0 (softmax ignores a per-query constant):
        # both sides are noise, held to the k weight's scale.
        scale = np.abs(want["wk"]).max() if n == "bk" else None
        _assert_close(got[n], want[n], 2 * STEP if bf16 else 1e-5, n, scale)


# -- the whole fused decoder -------------------------------------------------


def _weights(seed, dec_kw=DEC_KW, enc=("edsr", ENC_KW)):
    """JAX (g, d) params drawn by the port's initializers and read by the
    reference converter."""
    g = torch.Generator().manual_seed(seed)
    name, enc_kw = enc
    cls, conv = (EDSRNOUP, convert_edsr) if name == "edsr" else \
        (RDNNOUP, convert_rdn)
    ep = conv(init_weights(cls(**enc_kw), g).state_dict())
    dp = convert_fea2gs_rope(init_weights(Fea2GSRopeAMP(**dec_kw),
                                          g).state_dict())
    return jax.tree_util.tree_map(jnp.asarray, {"g": ep, "d": dp})


def _port(params, dec_kw=DEC_KW, dtype=torch.float32, enc=("edsr", ENC_KW)):
    """Fresh port modules in `dtype` loaded with the JAX params."""
    esd, dsd = params_from_jax(params["g"], params["d"])
    cls = EDSRNOUP if enc[0] == "edsr" else RDNNOUP
    return (load_params(cls(**enc[1], dtype=dtype), esd),
            load_params(Fea2GSRopeAMP(**dec_kw, dtype=dtype), dsd))


def _decoder_inputs(seed):
    rng = np.random.default_rng(seed)
    srcs = rng.random((1, 8, 8, DEC_KW["inchannel"]), dtype=np.float32)
    scale = np.float32([2.5])
    w = rng.standard_normal((1, 1024, 9)).astype(np.float32)
    return srcs, scale, w


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def decoder_grads(request):
    """The fused decoder's loss sum(w * out) and parameter gradients, port
    and JAX (jax.grad through its fused path, K7-K10 in interpret mode),
    for one trunk type: (loss, port grads, JAX loss, JAX grads by port
    name)."""
    bf16 = request.param == "bf16"
    params = _weights(1)
    _, dec = _port(params)
    srcs, scale, w = _decoder_inputs(2)
    from gsasr_tpu.models.fea2gs_rope_fast import \
        fea2gs_rope_apply_fused as jfused

    def jloss(p):
        return jnp.sum(jnp.asarray(w) * jfused(
            JRope(**DEC_KW), {"params": p}, jnp.asarray(srcs),
            jnp.asarray(scale), dtype=jnp.bfloat16 if bf16 else None))

    jl, jgrad = jax.jit(jax.value_and_grad(jloss))(params["d"])
    want = {k: v.numpy() for k, v in
            params_from_jax(params["g"], jgrad)[1].items()}
    out = fea2gs_rope_apply_fused(dec, torch.from_numpy(srcs),
                                  torch.from_numpy(scale),
                                  dtype=BF16 if bf16 else None)
    loss = (out * torch.from_numpy(w)).sum()
    names = [n for n, _ in dec.named_parameters()]
    grads = torch.autograd.grad(loss, list(dec.parameters()),
                                allow_unused=True)
    got = {n: (np.zeros(p.shape, np.float32) if d is None else d.numpy())
           for (n, p), d in zip(dec.named_parameters(), grads)}
    assert sorted(got) == sorted(want) and len(names) == len(got)
    return bf16, float(loss.detach()), got, float(jl), want


def test_fused_decoder_grads_match_jax(decoder_grads):
    """Every parameter's gradient of sum(w * fea2gs_rope_apply_fused(...)),
    the RoPE frequencies, the lattice convs and the dead q/k thirds of
    ScaleInject included, against jax.grad through the JAX fused decoder,
    on one sample (the paper decoder's test's size).
    fp32: the loss within 1e-5 relative, each gradient within 1e-4 of its
    tensor's largest entry (tests/test_torch_fused_backward.py's bounds).
    On two samples the heads' ReLUs put a pre-activation within float32
    noise of 0, and the JAX fused path itself then differs from its module
    path by 2e-3 in a head's bias gradient, while the port stays within
    1e-6 of the module path.
    bf16 trunk: the loss within 2^-8 relative; the whole decoder's
    gradient within relative L2 distance 2^-8 x DEC_DEPTH of JAX's (worst
    seen 2.7%), each tensor's within 2^-7 x DEC_DEPTH (worst seen 14%:
    small sums that cancel, LayerNorm biases and RoPE frequencies). The
    layers match bit for bit (the tests above); the convolutions and glue
    of the two libraries round their sums one step apart now and then."""
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


def test_fused_decoder_grads_match_module_path():
    """The port's fused path (fp32) and its module path (Fea2GSRopeAMP.
    forward: W and WB on the card) give the same loss and gradients, the
    RoPE frequencies' among them, within 1e-4 of each tensor's largest
    entry: the same float32 sub-layers composed in another order."""
    _, dec = _port(_weights(4))
    srcs, scale, w = _decoder_inputs(5)
    res = []
    for fn in (lambda s, sc: dec(s, sc),
               lambda s, sc: fea2gs_rope_apply_fused(dec, s, sc)):
        loss = (fn(torch.from_numpy(srcs), torch.from_numpy(scale))
                * torch.from_numpy(w)).sum()
        grads = torch.autograd.grad(loss, list(dec.parameters()),
                                    allow_unused=True)
        res.append((float(loss), [np.zeros(p.shape, np.float32) if d is None
                                  else d.numpy() for p, d in
                                  zip(dec.parameters(), grads)]))
    (l_mod, g_mod), (l_fused, g_fused) = res
    np.testing.assert_allclose(l_fused, l_mod, rtol=1e-5)
    for (name, _), a, ref in zip(dec.named_parameters(), g_fused, g_mod):
        np.testing.assert_allclose(a, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max() + 1e-7,
                                   err_msg=name)


# -- Trainer ------------------------------------------------------------------


def _batch(seed, b=2, lr_size=8, canvas=32):
    rng = np.random.default_rng(seed)
    scales = (2.0 + 2.0 * rng.random(b)).astype(np.float32)
    gt = np.ceil(scales * lr_size).astype(np.int32)
    return {"lq": rng.random((b, lr_size, lr_size, 3), dtype=np.float32),
            "gt": rng.random((b, canvas, canvas, 3), dtype=np.float32),
            "scale": scales, "gt_h": gt, "gt_w": gt}


def _by_name(tree_g, tree_d):
    sd_g, sd_d = params_from_jax(tree_g, tree_d)
    return ({k: v.numpy() for k, v in sd_g.items()},
            {k: v.numpy() for k, v in sd_d.items()})


def _rel_l2(mod, grads, want):
    num = den = 0.0
    for (n, _), g in zip(mod.named_parameters(), grads):
        ref = want[n].astype(np.float64)
        num += float(((g.numpy().astype(np.float64) - ref) ** 2).sum())
        den += float((ref ** 2).sum())
    return (num / den) ** 0.5


def test_bf16_fused_trainer_step_matches_jax():
    """One fused Trainer step of the bf16 recipe (bf16 EDSR, the Enhanced
    decoder through fea2gs_rope_apply_fused with a bf16 trunk and fp32
    UPNet and heads, fp32 parameters, Adam, no clip) against the JAX
    Trainer(fused_decoder=True) with the same networks in bf16, from the
    same weights and batch:
    - loss within 2^-8 relative;
    - each network's gradient within relative L2 distance 2^-8 x its bf16
      depth from JAX's (the decoder DEC_DEPTH, the encoder behind it and
      its own three convs; worst seen 0.09% and 0.76%, as the module
      path's step);
    - the parameters after the update: Adam's first step moves each weight
      by about lr sign(g), so a gradient within bf16 noise of 0 can move
      it the other way: every weight within 2 lr of JAX's, and the mean
      difference below 0.05 lr."""
    params = _weights(6)
    enc, dec = _port(params, dtype=BF16)
    batch = _batch(7)
    jtr = JTrainer(JEDSR(**ENC_KW, dtype=jnp.bfloat16),
                   JRope(**DEC_KW, dtype=jnp.bfloat16),
                   JTrainConfig(**CFG, fused_decoder=True),
                   mesh=make_mesh(jax.devices()[:1]))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jtr._loss_fn,
                                                    has_aux=True))(
        params, jax.tree_util.tree_map(jnp.asarray, batch),
        jax.random.PRNGKey(0))
    updates, _ = jtr.tx.update(jgrads, jtr.tx.init(params), params)
    jnew = _by_name(*(lambda t: (t["g"], t["d"]))(
        optax.apply_updates(params, updates)))

    tr = Trainer(enc, dec, TrainConfig(**CFG, fused_decoder=True),
                 device="cpu")
    loss, _, g_g, g_d = tr.grads(batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP)
    want = _by_name(jgrads["g"], jgrads["d"])
    for mod, grads, w, depth in ((tr.enc, g_g, want[0], DEC_DEPTH + 3),
                                 (tr.dec, g_d, want[1], DEC_DEPTH)):
        assert _rel_l2(mod, grads, w) <= STEP * depth
    tr.apply(loss, {}, g_g, g_d)
    lr = CFG.get("lr", 2e-4)
    diffs = []
    for mod, ref in ((tr.enc, jnew[0]), (tr.dec, jnew[1])):
        for n, p in mod.named_parameters():
            d = np.abs(p.detach().numpy() - ref[n])
            assert d.max() <= 2 * lr + 1e-6, (n, float(d.max()))
            diffs.append(d.ravel())
    assert np.concatenate(diffs).mean() <= 0.05 * lr


@pytest.mark.parametrize("enc_name", ["edsr", "rdn"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_fused_trainer_trains_and_matches_module_path(enc_name, dtype):
    """EDSR- and RDN-Enhanced (RDN's decoder with two cross-attention
    blocks) train on the fused decoder in fp32 and bf16: the step's loss
    and gradients against the same Trainer on the module path (fp32: loss
    1e-5 relative, gradients 1e-4 relative L2 per network, the same
    float32 sub-layers in another order; bf16: loss 2^-8 relative,
    gradients 2^-8 x DEC_DEPTH relative L2, the two paths round at other
    points), then one step moves every parameter group and the EMA."""
    dec_kw = dict(DEC_KW, num_crossattn_blocks=2 if enc_name == "rdn" else 1)
    enc_kw = ENC_KW if enc_name == "edsr" else dict(g0=8)
    dt = BF16 if dtype == "bf16" else torch.float32
    params = _weights(8, dec_kw, (enc_name, enc_kw))
    batch = _batch(9)
    res = []
    for fused in (False, True):
        enc, dec = _port(params, dec_kw, dt, (enc_name, enc_kw))
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


@pytest.mark.parametrize("yml", ["train_edsr_amp.yml", "train_rdn_amp.yml",
                                 "train_edsr_enhanced_r5.yml"])
def test_enhanced_recipes_build_a_fused_trainer(yml):
    """The Enhanced recipes with train.fused_decoder set build a fused
    Trainer at full width (the recipes' bf16 networks)."""
    from pathlib import Path

    from gsasr_torch.config import (apply_overrides, build_networks,
                                    build_train_config, load_options)

    opt = load_options(Path(__file__).resolve().parents[1] / "configs" / yml)
    apply_overrides(opt, ["train.fused_decoder=true"])
    cfg = build_train_config(opt)
    assert cfg.fused_decoder
    enc, dec = build_networks(opt)
    assert isinstance(dec, Fea2GSRopeAMP) and dec.dtype == BF16
    tr = Trainer(enc, dec, cfg, device="cpu")
    assert tr.cfg.fused_decoder and tr.dec is dec
