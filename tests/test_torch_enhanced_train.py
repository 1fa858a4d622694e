"""gsasr_torch's Enhanced EDSR-GSASR training at the bf16 recipe against
gsasr_tpu on the CPU.

- The fp32 module path of Fea2GSRopeAMP: every parameter's gradient (the
  RoPE frequencies and the lattice convs included) against jax.grad.
- The bf16 modules (EDSR, RDN, the Enhanced decoder) against JAX's flax
  modules built with dtype=bfloat16.
- One bf16 Trainer step against the JAX Trainer: loss, gradients and the
  parameters after the update.
- build_networks on the Enhanced recipes, the combinations that still
  raise, and the window-16 fused trainer's raise.
- RDN-Enhanced (two cross-attention blocks) through sr_forward (in
  tests/test_torch_enhanced_train_rdn.py).
- The bias-table inverse rebuilt when a state_dict loads an index, and the
  trainer's deterministic cuDNN flags.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do (K11/K12 with bf16 operands on the bf16 path); the port runs its plain
PyTorch versions. Weights are drawn by the port, read into JAX trees by the
JAX package's reference converter and loaded into fresh port modules with
params_from_jax.

bf16 tolerances. Both sides round at the same points (the modules and W/WB
are checked bit for bit in places below and in test_torch_attention.py),
but each sums its f32 products and statistics in another order, and
XLA's CPU reductions of bf16 bias gradients accumulate in bf16: a value
then lands one bf16 step (2^-8 relative) apart now and then, and the step
is carried on through every later bf16 sub-layer. Each tolerance is 2^-8
times the number of bf16 sub-layers it crosses.
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gsasr_tpu.models import EDSRNOUP as JEDSR
from gsasr_tpu.models import RDNNOUP as JRDN
from gsasr_tpu.models import Fea2GSRopeAMP as JRope
from gsasr_tpu.parallel.mesh import make_mesh
from gsasr_tpu.train import TrainConfig as JTrainConfig
from gsasr_tpu.train import Trainer as JTrainer
from gsasr_tpu.utils.torch_convert import (convert_edsr, convert_fea2gs_rope,
                                           convert_rdn)
from gsasr_torch.models import EDSRNOUP, RDNNOUP, Fea2GSRopeAMP
from gsasr_torch.models.init import init_weights
from gsasr_torch.train import TrainConfig, Trainer
from gsasr_torch.utils.convert import load_params, params_from_jax

ROOT = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16
STEP = 2.0 ** -8
# tests/test_trainer.py's bf16 networks (test_train_step_bf16_amp_family)
ENC_KW = dict(num_feat=16, num_block=1)
DEC_KW = dict(inchannel=16, channel=24, num_heads=6, num_crossattn_blocks=1,
              num_crossattn_layers=1, num_selfattn_blocks=1,
              num_selfattn_layers=1, num_gs_seed=16, window_size=4)
# and with a shifted self-attention layer
DEC2_KW = dict(DEC_KW, num_selfattn_layers=2)
# bf16 sub-layers of DEC_KW's decoder, loss to input: UPNet's two convs,
# conv_final; per block its lattice conv, tail MLP and norm, and per layer
# its inject, two FFNs and attention
DEC_DEPTH = 3 + 2 * (3 + 4)
# that test's config, with the Enhanced recipes' no-clip
# (configs/train_edsr_amp.yml: clip_grad_norm False)
CFG = dict(canvas_hw=(32, 32), warmup_iter=-1, milestones=(100,),
           clip_grad_norm=None)


def _weights(seed, dec_kw, enc=("edsr", ENC_KW)):
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


def _port(params, dec_kw, dtype=torch.float32, enc=("edsr", ENC_KW)):
    """Fresh port modules in `dtype` loaded with the JAX params."""
    esd, dsd = params_from_jax(params["g"], params["d"])
    cls = EDSRNOUP if enc[0] == "edsr" else RDNNOUP
    return (load_params(cls(**enc[1], dtype=dtype), esd),
            load_params(Fea2GSRopeAMP(**dec_kw, dtype=dtype), dsd))


def _batch(seed, b=2, lr_size=8, canvas=32):
    rng = np.random.default_rng(seed)
    scales = (2.0 + 2.0 * rng.random(b)).astype(np.float32)
    gt = np.round(scales * lr_size).astype(np.int32)
    return {"lq": rng.random((b, lr_size, lr_size, 3), dtype=np.float32),
            "gt": rng.random((b, canvas, canvas, 3), dtype=np.float32),
            "scale": scales, "gt_h": gt, "gt_w": gt}


def _bf16_steps(a, b):
    """Elementwise distance of two bf16 arrays (as float arrays) in bf16
    steps: their bit patterns read as ordered integers."""
    def ordered(x):
        bits = torch.from_numpy(np.array(x, np.float32)).to(
            BF16).view(torch.int16).numpy().astype(np.int32)
        return np.where(bits < 0, -(bits & 0x7FFF), bits)
    return np.abs(ordered(a) - ordered(b))


def _by_name(tree_g, tree_d):
    sd_g, sd_d = params_from_jax(tree_g, tree_d)
    return ({k: v.numpy() for k, v in sd_g.items()},
            {k: v.numpy() for k, v in sd_d.items()})


# -- 1. the fp32 module path's gradients against jax.grad -------------------


def test_fp32_module_gradients_match_jax():
    """Every parameter's gradient of sum(out * cot) through the fp32 module
    path (RoPE attentions through W and WB's plain versions, the lattice
    convs, conv_final, UPNet, the heads), and the features' gradient,
    against jax.grad of the flax module (K11/K12 in interpret mode).
    Tolerance 1e-4 of each tensor's largest entry: float32 sums in another
    order through about twenty sub-layers (worst seen here 4e-6)."""
    params = _weights(0, DEC2_KW)
    _, dec = _port(params, DEC2_KW)
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((2, 8, 12, 16)).astype(np.float32)
    scale = np.float32([2.5, 3.7])
    cot = rng.standard_normal((2, 1536, 9)).astype(np.float32)

    def jloss(p, x):
        out = JRope(**DEC2_KW).apply({"params": p}, x, jnp.asarray(scale))
        return jnp.sum(out * cot)

    jg_d, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        params["d"], jnp.asarray(feat))
    x = torch.from_numpy(feat).requires_grad_()
    out = dec(x, torch.from_numpy(scale))
    assert out.shape == cot.shape
    names = [n for n, _ in dec.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                [x, *dec.parameters()], allow_unused=True)
    _, want = _by_name(params["g"], jg_d)
    assert any("rope_freqs" in n for n in names)
    assert any(n.endswith(".conv.weight") for n in names)
    for name, got in zip(["features"] + names, grads):
        ref = np.asarray(jg_x) if name == "features" else want[name]
        got = np.zeros_like(ref) if got is None else got.numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max() + 1e-12,
                                   err_msg=name)


# -- 2. the bf16 modules against JAX's ---------------------------------------


def _dense_p(lin):
    return {"kernel": jnp.asarray(lin.weight.detach().numpy().T),
            "bias": jnp.asarray(lin.bias.detach().numpy())}


def test_bf16_sublayers_match_jax():
    """The rounding points, one sub-layer at a time on the same bf16 input:
    Linear, Conv2d and LayerNorm with dtype=bfloat16 against flax's Dense,
    Conv and LayerNorm, and the RoPE self- and cross-attention (q/k/v
    projections, f32 rotations rounded back, W-bf16's plain version against
    K11 in bf16, out-projection) against the flax modules: bf16 outputs
    within one bf16 step of JAX's (each sums f32 products or statistics in
    another order before its one rounding; most are bit-equal)."""
    import flax.linen as fnn

    from gsasr_tpu.models.fea2gs_rope import RopeGSSelfAttn as JSelf
    from gsasr_tpu.models.fea2gs_rope import RopeWindowCrossAttn as JCross
    from gsasr_torch.models.common import Conv2d, LayerNorm, Linear
    from gsasr_torch.models.fea2gs_rope import (RopeGSSelfAttn,
                                                RopeWindowCrossAttn)

    g = torch.Generator().manual_seed(16)
    rng = np.random.default_rng(17)
    c, nh = 24, 6
    x = rng.standard_normal((8, 16, c)).astype(np.float32)
    feat = rng.standard_normal((8, 36, c)).astype(np.float32)
    jbf = jnp.bfloat16
    xj, fj = jnp.asarray(x).astype(jbf), jnp.asarray(feat).astype(jbf)
    xt = torch.from_numpy(x).to(BF16)
    ft = torch.from_numpy(feat).to(BF16)
    lin = init_weights(Linear(c, c, BF16), g)
    ln = LayerNorm(c, BF16)
    with torch.no_grad():
        ln.weight.normal_(1.0, 0.2, generator=g)
        ln.bias.normal_(0.0, 0.2, generator=g)
    conv = init_weights(Conv2d(c, c, 3, padding=1, dtype=BF16), g)
    attn_s = init_weights(RopeGSSelfAttn(c, nh, 4, dtype=BF16), g)
    attn_c = init_weights(RopeWindowCrossAttn(c, nh, 6, 16, dtype=BF16), g)

    def attn_p(a):
        return {"rope_freqs": jnp.asarray(a.rope_freqs.detach().numpy()),
                **{n: _dense_p(getattr(a, n))
                   for n in ("qhead", "khead", "vhead", "proj")}}

    img = x.reshape(2, 8, 8, c)
    cases = {
        "Linear": (fnn.Dense(c, dtype=jbf).apply(
            {"params": _dense_p(lin)}, xj), lin(xt)),
        "LayerNorm": (fnn.LayerNorm(epsilon=1e-5, dtype=jbf).apply(
            {"params": {"scale": jnp.asarray(ln.weight.detach().numpy()),
                        "bias": jnp.asarray(ln.bias.detach().numpy())}}, xj),
            ln(xt)),
        "Conv2d": (fnn.Conv(c, (3, 3), padding=1, dtype=jbf).apply(
            {"params": {"kernel": jnp.asarray(conv.weight.detach().numpy()
                                              .transpose(2, 3, 1, 0)),
                        "bias": jnp.asarray(conv.bias.detach().numpy())}},
            jnp.asarray(img).astype(jbf)),
            conv(torch.from_numpy(img).to(BF16).permute(0, 3, 1, 2))
            .permute(0, 2, 3, 1)),
        "RoPE self-attention": (JSelf(c, nh, 4, dtype=jbf).apply(
            {"params": attn_p(attn_s)}, xj), attn_s(xt)),
        "RoPE cross-attention": (JCross(c, nh, 6, 16, dtype=jbf).apply(
            {"params": attn_p(attn_c)}, xj, fj), attn_c(xt, ft)),
    }
    for name, (ref, out) in cases.items():
        assert out.dtype == BF16 and ref.dtype == jbf, name
        steps = _bf16_steps(out.detach().float().numpy(),
                            np.asarray(ref.astype(jnp.float32)))
        assert steps.max() <= 1, (name, int(steps.max()))


def test_bf16_encoders_match_jax():
    """EDSRNOUP and RDNNOUP with dtype=bfloat16 (bf16 convs, ReLUs,
    concatenations and residual adds on fp32 parameters) against the flax
    modules with dtype=bfloat16. Each conv sums its f32 products in another
    order before its one rounding, so a value can land one bf16 step apart
    and carry it on: EDSR (3 convs deep) within one bf16 step elementwise
    (bit-equal here); RDN at the recipe's config B, narrowed to g0 = 8 (146
    convs deep), within two bf16 steps of its largest entry and relative L2
    within 2^-8 (worst seen one step, 0.17%)."""
    lq = np.random.default_rng(2).random((2, 8, 12, 3), dtype=np.float32)
    for name, enc_kw, jcls in (("edsr", ENC_KW, JEDSR),
                               ("rdn", dict(g0=8), JRDN)):
        params = _weights(3, DEC_KW, enc=(name, enc_kw))
        enc, _ = _port(params, DEC_KW, BF16, enc=(name, enc_kw))
        ref = jcls(**enc_kw, dtype=jnp.bfloat16).apply(
            {"params": params["g"]}, jnp.asarray(lq))
        with torch.no_grad():
            out = enc(torch.from_numpy(lq))
        assert out.dtype == BF16 and ref.dtype == jnp.bfloat16, name
        assert all(p.dtype == torch.float32 for p in enc.parameters())
        ref = np.asarray(ref.astype(jnp.float32))
        out = out.float().numpy()
        if name == "edsr":
            assert _bf16_steps(out, ref).max() <= 1
        else:
            assert np.abs(out - ref).max() <= 2 * STEP * np.abs(ref).max()
            assert np.linalg.norm(out - ref) <= STEP * np.linalg.norm(ref)


def test_bf16_decoder_matches_jax():
    """Fea2GSRopeAMP(dtype=bfloat16) on its module path against the flax
    module with dtype=bfloat16 (fp32 heads, f32 q_mean and concatenation;
    K11 with bf16 operands in interpret mode): float32 output, each column
    within 2^-8 x DEC_DEPTH (+1 for the shifted layer) of its largest
    entry. The sub-layers match bit for bit where their inputs do; a
    LayerNorm's f32 statistics (PyTorch's two passes against flax's mean of
    squares) can put a value one bf16 step apart (worst seen 0.4% of a
    column's largest entry)."""
    params = _weights(4, DEC2_KW)
    _, dec = _port(params, DEC2_KW, BF16)
    assert all(p.dtype == torch.float32 for p in dec.parameters())
    feat = np.random.default_rng(5).standard_normal(
        (2, 8, 8, 16)).astype(np.float32)
    scale = np.float32([2.5, 3.7])
    ref = np.asarray(jax.jit(lambda p, x, s: JRope(
        **DEC2_KW, dtype=jnp.bfloat16).apply({"params": p}, x, s))(
        params["d"], jnp.asarray(feat).astype(jnp.bfloat16),
        jnp.asarray(scale)))
    with torch.no_grad():
        out = dec(torch.from_numpy(feat).to(BF16), torch.from_numpy(scale))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    col = np.abs(ref).reshape(-1, 9).max(0)
    err = np.abs(out.numpy() - ref).reshape(-1, 9).max(0)
    assert (err <= STEP * (DEC_DEPTH + 4) * col).all(), (err, col)
    # the heads run in fp32: their outputs are not on the bf16 grid
    assert not torch.equal(out, out.to(BF16).float())


# -- 3. one bf16 Trainer step against the JAX Trainer ------------------------


def test_bf16_trainer_step_matches_jax():
    """One Trainer step of the bf16 recipe (bf16 EDSR and Enhanced decoder
    on the module path, fp32 parameters, Adam, no clip, no GradScaler)
    against the JAX Trainer with the same networks in bf16, from the same
    weights and batch:
    - loss within 2^-8 relative (a mean over the canvas of a render whose
      Gaussians come from the fp32 heads on a bf16 trunk);
    - each network's gradient within relative L2 distance 2^-8 x its bf16
      depth from JAX's (decoder DEC_DEPTH; the encoder sits behind the
      decoder and its own three convs; worst seen 0.16% and 1.0%);
    - the parameters after the update: Adam's first step moves each weight
      by about lr sign(g), so a gradient that lies within bf16 noise of 0
      can move it the other way; every weight within 2 lr of JAX's, and
      the mean difference below 0.05 lr (flips of a few percent of the
      near-zero entries)."""
    params = _weights(6, DEC_KW)
    enc, dec = _port(params, DEC_KW, BF16)
    batch = _batch(7)
    jtr = JTrainer(JEDSR(**ENC_KW, dtype=jnp.bfloat16),
                   JRope(**DEC_KW, dtype=jnp.bfloat16), JTrainConfig(**CFG),
                   mesh=make_mesh(jax.devices()[:1]))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jtr._loss_fn,
                                                    has_aux=True))(
        params, jax.tree_util.tree_map(jnp.asarray, batch),
        jax.random.PRNGKey(0))
    updates, _ = jtr.tx.update(jgrads, jtr.tx.init(params), params)
    jnew = optax.apply_updates(params, updates)

    tr = Trainer(enc, dec, TrainConfig(**CFG), device="cpu")
    loss, met, g_g, g_d = tr.grads(batch)
    assert all(g.dtype == torch.float32 for g in g_g + g_d)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP)
    want = _by_name(jgrads["g"], jgrads["d"])
    for i, (mod, grads, depth) in enumerate(
            ((tr.enc, g_g, DEC_DEPTH + 3), (tr.dec, g_d, DEC_DEPTH))):
        num = den = 0.0
        for (name, _), got in zip(mod.named_parameters(), grads):
            ref = want[i][name].astype(np.float64)
            num += np.sum((got.double().numpy() - ref) ** 2)
            den += np.sum(ref ** 2)
        assert math.sqrt(num / den) <= STEP * depth, (i, math.sqrt(num / den))

    tr.apply(loss, met, g_g, g_d)
    lr = CFG.get("lr", 2e-4)
    new = _by_name(jnew["g"], jnew["d"])
    diffs = []
    for i, mod in enumerate((tr.enc, tr.dec)):
        for name, p in mod.named_parameters():
            d = np.abs(p.detach().numpy() - new[i][name])
            assert d.max() <= 2 * lr + 1e-6, (name, float(d.max()))
            diffs.append(d.ravel())
    assert np.concatenate(diffs).mean() <= 0.05 * lr


# -- 4. the recipes, and what is not ported ----------------------------------


@pytest.mark.parametrize("yml,enc_cls,cross", [
    ("train_edsr_amp.yml", EDSRNOUP, 1), ("train_rdn_amp.yml", RDNNOUP, 2),
    ("train_edsr_enhanced_r5.yml", EDSRNOUP, 1)])
def test_build_networks_enhanced_recipes(yml, enc_cls, cross):
    """The Enhanced recipes (GSASRAMPModel, bf16 by default or by
    model_dtype) build bf16-compute modules on fp32 parameters at their
    published widths, trained on the module path."""
    from gsasr_torch.config import (build_networks, build_train_config,
                                    load_options)

    opt = load_options(ROOT / "configs" / yml)
    enc, dec = build_networks(opt)
    assert isinstance(enc, enc_cls) and isinstance(dec, Fea2GSRopeAMP)
    assert enc.dtype == BF16 and dec.dtype == BF16
    assert dec.head_dtype == torch.float32
    assert dec.conv_final.compute_dtype == BF16
    assert dec.mlp_block_mean[0].compute_dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in
               list(enc.parameters()) + list(dec.parameters()))
    assert dec.channel == 192 and len(dec.window_crossattn_blocks) == cross
    assert not build_train_config(opt).fused_decoder


def test_unported_bf16_combinations_raise():
    """No bf16 combination of the recipes raises any more: the paper Fea2GS
    in bf16 (train_edsr_paper_bf16_r3.yml) builds, with EDSR and with the
    paper HAT, in bf16 compute on fp32 parameters (its paths against JAX:
    tests/test_torch_paper_bf16.py); SwinIR in bf16, train_swinir_amp.yml,
    builds too (tests/test_torch_swinir_bf16.py); and a fused trainer whose
    decoder has windows of more than 160 tokens (the Ultra and
    SwinIR-Enhanced decoders' 256 seeds in windows of 16) constructs, on
    the fused decoder (AB-long: tests/test_torch_ultra_fused_train.py)."""
    from gsasr_torch.config import build_networks, load_options
    from gsasr_torch.models import Fea2GS, HATNOUPPaper

    opt = load_options(ROOT / "configs" / "train_edsr_paper_bf16_r3.yml")
    opt["network_fea2gs"].update(channel=24, num_selfattn_blocks=1)
    enc, dec = build_networks(opt)
    assert isinstance(enc, EDSRNOUP) and isinstance(dec, Fea2GS)
    assert enc.dtype == dec.dtype == BF16
    assert dec.head_dtype == torch.float32
    opt["network_g"] = {"type": "HATNOUP", "embed_dim": 24, "depths": [2],
                        "num_heads": [6], "squeeze_factor": 4}
    enc, dec = build_networks(opt)
    assert isinstance(enc, HATNOUPPaper) and isinstance(dec, Fea2GS)
    assert enc.dtype == dec.dtype == BF16
    assert all(p.dtype == torch.float32 for p in
               list(enc.parameters()) + list(dec.parameters()))
    w16 = dict(DEC_KW, num_gs_seed=256, window_size=16)
    enc, dec = _port(_weights(8, w16), w16, BF16)
    tr = Trainer(enc, dec, TrainConfig(**CFG, fused_decoder=True),
                 device="cpu")
    assert tr.cfg.fused_decoder and tr.dec is dec


def test_chip_smoke_enhanced_constants_match_yaml():
    """chip_smoke.py writes the Enhanced recipe out (the card has no
    PyYAML): it must equal what build_train_config reads from
    configs/train_edsr_amp.yml, with the file's batch, sizes and rounding,
    and its networks must be build_networks' from the file, weight for
    weight and type for type."""
    import importlib.util

    from gsasr_torch.config import (build_networks, build_train_config,
                                    load_options)

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    opt = load_options(ROOT / "configs" / "train_edsr_amp.yml")
    assert TrainConfig(**cs.ENHANCED_TRAIN) == build_train_config(opt)
    ds = opt["datasets"]["train"]
    assert cs.PAPER_BATCH == ds["batch_size_per_gpu"]
    assert cs.PAPER_LR_SIZE == ds["lr_size"]
    assert cs.PAPER_SCALES == tuple(ds["scale_list"])
    assert ds["round_mode"] == "ceil"
    for got, want in zip(cs.enhanced_networks("edsr"), build_networks(opt)):
        assert type(got) is type(want) and got.dtype == want.dtype
        sd = want.state_dict()
        for k, v in got.state_dict().items():
            assert torch.equal(v, sd[k]), k


# -- 5. RDN-Enhanced through sr_forward ---------------------------------------


# -- 6. the two repairs -------------------------------------------------------


def _permute_index(module, seed):
    """A state_dict of `module` whose bias-table rows and index are permuted
    the same way (table'[pi(r)] = table[r], index' = pi(index)), as a
    checkpoint with another row order brings them; and the permutation."""
    sd = {k: v.clone() for k, v in module.state_dict().items()}
    key = next(k for k in sd if k.endswith("relative_position_bias_table"))
    prefix = key[:-len("relative_position_bias_table")]
    rows = sd[key].shape[0]
    pi = torch.from_numpy(np.random.default_rng(seed).permutation(rows))
    table = torch.empty_like(sd[key])
    table[pi] = sd[key]
    sd[key] = table
    sd[prefix + "relative_position_index"] = pi[
        sd[prefix + "relative_position_index"]]
    return sd, key, pi


@pytest.mark.parametrize("which", ["paper_fea2gs", "swinir_block"])
def test_permuted_bias_index_keeps_forward_and_gradient(which):
    """Loading an index whose rows are permuted with the table's leaves the
    forward the same bits and moves the table gradient by the same
    permutation: the inverse the ordered gradient sums over is rebuilt on
    load (it is not in the state_dict)."""
    import copy

    from gsasr_torch.models import Fea2GS
    from gsasr_torch.models.swinir import SwinBlock

    g = torch.Generator().manual_seed(11)
    rng = np.random.default_rng(12)
    if which == "paper_fea2gs":
        mod = init_weights(Fea2GS(inchannel=8, channel=12, num_heads=6,
                                  num_crossattn_blocks=1,
                                  num_crossattn_layers=1,
                                  num_selfattn_blocks=1,
                                  num_selfattn_layers=1, num_gs_seed=16,
                                  window_size=4), g)
        args = (torch.from_numpy(rng.random((2, 8, 8, 8), dtype=np.float32)),
                torch.tensor([2.0, 3.0]))
    else:
        mod = init_weights(SwinBlock(12, 3, 4, 2, 2.0), g)
        args = (torch.from_numpy(rng.random((2, 8, 8, 12),
                                            dtype=np.float32)),)
    sd, key, pi = _permute_index(mod, 13)
    moved = copy.deepcopy(mod)
    moved.load_state_dict(sd)
    mods = {}
    for name, m in (("base", mod), ("moved", moved)):
        out = m(*args)
        table = dict(m.named_parameters())[key]
        mods[name] = (out.detach(), torch.autograd.grad(out.sum(), table)[0])
    assert torch.equal(mods["moved"][0], mods["base"][0])
    assert mods["base"][1].abs().max() > 0
    assert torch.equal(mods["moved"][1][pi], mods["base"][1])


def test_trainer_cudnn_flags_keep_the_others(monkeypatch):
    """Trainer.grads runs under cudnn.flags(deterministic=True) with
    enabled, benchmark and allow_tf32 as they stand (flags() would reset
    what it is not given), and restores all of them afterwards."""
    from gsasr_torch.models import Fea2GS
    from gsasr_torch.train import trainer as trainer_mod

    cudnn = torch.backends.cudnn
    seen = []
    real = trainer_mod.Trainer.loss_fn

    def spy(self, batch):
        seen.append((cudnn.enabled, cudnn.benchmark, cudnn.allow_tf32,
                     cudnn.deterministic,
                     torch.backends.cuda.matmul.allow_tf32))
        return real(self, batch)

    monkeypatch.setattr(trainer_mod.Trainer, "loss_fn", spy)
    g = torch.Generator().manual_seed(14)
    enc = init_weights(EDSRNOUP(num_feat=8, num_block=1), g)
    dec = init_weights(Fea2GS(inchannel=8, channel=12, num_heads=6,
                              num_crossattn_blocks=1, num_crossattn_layers=1,
                              num_selfattn_blocks=1, num_selfattn_layers=1,
                              num_gs_seed=16, window_size=4), g)
    tr = Trainer(enc, dec, TrainConfig(canvas_hw=(32, 32)), device="cpu")
    before = (cudnn.enabled, cudnn.benchmark, cudnn.allow_tf32,
              cudnn.deterministic, torch.backends.cuda.matmul.allow_tf32)
    for bench, tf32 in ((True, False), (False, True)):
        monkeypatch.setattr(cudnn, "benchmark", bench)
        monkeypatch.setattr(cudnn, "allow_tf32", tf32)
        state = (cudnn.enabled, bench, tf32, cudnn.deterministic,
                 torch.backends.cuda.matmul.allow_tf32)
        tr.step(_batch(15))
        assert seen[-1] == state[:3] + (True,) + state[4:]
        assert (cudnn.enabled, cudnn.benchmark, cudnn.allow_tf32,
                cudnn.deterministic,
                torch.backends.cuda.matmul.allow_tf32) == state
    monkeypatch.undo()
    assert (cudnn.enabled, cudnn.benchmark, cudnn.allow_tf32,
            cudnn.deterministic,
            torch.backends.cuda.matmul.allow_tf32) == before
