"""gsasr_torch's paper Fea2GS in bf16 (`configs/train_edsr_paper_bf16_r3.yml`)
against gsasr_tpu's `Fea2GS(dtype=jnp.bfloat16)` on the CPU.

- The module path's forward with `fp32_heads` on (float32 heads and output)
  and off (bf16 heads and output, as JAX's).
- The module path's gradients against jax.grad.
- The fused path with a bf16 trunk against JAX's
  `fea2gs_apply_fused(dtype=jnp.bfloat16)` (K7/K8 with bf16 operands and the
  bias tables in interpret mode).
- `build_networks` on the recipe. One Trainer step on each path against the
  JAX Trainer is in tests/test_torch_paper_bf16_train.py.

Weights are drawn by the port, read into JAX trees by the JAX package's
reference converter, and loaded as they were drawn into fresh port modules
of each compute type. Inputs are made with numpy from a seed.

bf16 tolerances, as tests/test_torch_enhanced_train.py states them: both
sides round at the same points but sum their f32 products and statistics
in another order, so a value lands one bf16 step (2^-8 relative) apart now
and then and carries the step through every later bf16 sub-layer; each
tolerance is 2^-8 times the number of bf16 sub-layers it crosses.
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_tpu.models import Fea2GS as JFea2GS
from gsasr_tpu.models.fea2gs_fast import fea2gs_apply_fused as jfused
from gsasr_tpu.utils.torch_convert import convert_fea2gs
from gsasr_torch.models import Fea2GS
from gsasr_torch.models.fea2gs_fast import fea2gs_apply_fused
from gsasr_torch.models.init import init_weights
from gsasr_torch.utils import convert

ROOT = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16
STEP = 2.0 ** -8
# a tiny paper decoder with a shifted cross- and self-attention layer
DEC_KW = dict(inchannel=8, channel=24, num_heads=6, num_crossattn_blocks=1,
              num_crossattn_layers=2, num_selfattn_blocks=1,
              num_selfattn_layers=2, num_gs_seed=16, window_size=4)
# bf16 sub-layers of DEC_KW's decoder, output to input: UPNet's two convs;
# per block its norm and tail MLP; per layer its inject, two FFNs and
# attention; the feature projection's two convs
DEC_DEPTH = 2 + 2 * (2 + 2 * 4) + 2
# the gradient test's decoder: one cross-attention layer, and a shifted
# self-attention layer (each attention layer costs JAX a compile of K11
# and K12 in interpret mode)
GRAD_KW = dict(DEC_KW, num_crossattn_layers=1)
GRAD_DEPTH = 2 + 2 * 2 + 3 * 4 + 2


def _weights(seed, dec_kw=DEC_KW):
    """(port state_dict, JAX params) of a decoder drawn by the port's
    initializers; the JAX tree read by the reference converter."""
    g = torch.Generator().manual_seed(seed)
    sd = init_weights(Fea2GS(**dec_kw), g).state_dict()
    return sd, jax.tree_util.tree_map(jnp.asarray, convert_fea2gs(
        sd, num_gs_seed=dec_kw["num_gs_seed"],
        window_size=dec_kw["window_size"], num_heads=dec_kw["num_heads"]))


def _port(sd, dtype=BF16, fp32_heads=True, dec_kw=DEC_KW):
    dec = Fea2GS(**dec_kw, dtype=dtype, fp32_heads=fp32_heads)
    dec.load_state_dict(sd)
    return dec


def _inputs(seed):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    return feat, np.float32([2.5, 3.7])


def _col_err(out, ref):
    """Each of the 9 columns' max |out - ref| and max |ref|."""
    col = np.abs(ref).reshape(-1, 9).max(0)
    return np.abs(out - ref).reshape(-1, 9).max(0), col


# the forward test's worst column readings (max |out - ref| / max |ref|),
# with fp32 heads and without; a zeroed bias table reads 3.57% and 3.68%
FWD_WORST = {True: 0.00625, False: 0.01282}


@pytest.mark.parametrize("fp32_heads", [True, False])
def test_bf16_paper_decoder_matches_jax(fp32_heads, monkeypatch):
    """Fea2GS(dtype=bfloat16) on its module path (float32 embeddings and
    residual stream; LayerNorms, linears, convs and W-bf16's plain version
    with the float32 bias in bf16) against flax's with dtype=bfloat16 (K11
    with bf16 operands in interpret mode): float32 output with fp32_heads,
    bfloat16 without, as JAX's; each column within 2^-8 x DEC_DEPTH of its
    largest entry (+2 without fp32_heads: the heads' three bf16 products),
    and within 2.5x the worst reading seen (FWD_WORST), which a zeroed bias
    table exceeds: the bias tables are seeded N(0, 1) so that they move the
    output, where the initial 0.02 hardly does. Every attention takes bf16
    q, k and v (an fp32 attention sits as near JAX's bf16 output as bf16
    does here, so the output cannot tell them apart)."""
    from gsasr_torch.models import fea2gs as port_fea2gs

    sd, _ = _weights(1)
    g = torch.Generator().manual_seed(9)
    for k, v in sd.items():
        if k.endswith("relative_position_bias_table"):
            v.copy_(torch.randn(v.shape, generator=g))
    params = jax.tree_util.tree_map(jnp.asarray, convert_fea2gs(
        sd, num_gs_seed=DEC_KW["num_gs_seed"],
        window_size=DEC_KW["window_size"], num_heads=DEC_KW["num_heads"]))
    dec = _port(sd, fp32_heads=fp32_heads)
    assert all(p.dtype == torch.float32 for p in dec.parameters())
    assert dec.dtype == BF16
    assert dec.head_dtype == (torch.float32 if fp32_heads else BF16)
    seen = []

    def attention(q, k, v, *a, **kw):
        seen.append((q.dtype, k.dtype, v.dtype))
        return window_attention_packed(q, k, v, *a, **kw)

    window_attention_packed = port_fea2gs.window_attention_packed
    monkeypatch.setattr(port_fea2gs, "window_attention_packed", attention)
    feat, scale = _inputs(2)
    ref = jax.jit(lambda p, x, s: JFea2GS(
        **DEC_KW, dtype=jnp.bfloat16, fp32_heads=fp32_heads).apply(
            {"params": p}, x, s))(params, jnp.asarray(feat).astype(
                jnp.bfloat16), jnp.asarray(scale))
    with torch.no_grad():
        out = dec(torch.from_numpy(feat).to(BF16), torch.from_numpy(scale))
    assert seen == [(BF16, BF16, BF16)] * 4
    want = torch.float32 if fp32_heads else BF16
    assert out.dtype == want and ref.dtype == (
        jnp.float32 if fp32_heads else jnp.bfloat16)
    assert out.shape == ref.shape
    err, col = _col_err(out.float().numpy(),
                        np.asarray(ref.astype(jnp.float32)))
    depth = DEC_DEPTH + (0 if fp32_heads else 2)
    assert (err <= STEP * depth * col).all(), (err / col)
    assert (err <= 2.5 * FWD_WORST[fp32_heads] * col).all(), (err / col)
    if fp32_heads:
        # the heads run in fp32: their outputs are not on the bf16 grid
        assert not torch.equal(out, out.to(BF16).float())


def test_bf16_paper_gradients_match_jax():
    """Every parameter's gradient of sum(out * cot) through the bf16 module
    path (the bias tables through W-bf16/WB-bf16's plain versions and the
    ordered table gradient, f32), and the features' gradient, against
    jax.grad of flax's bf16 module: relative L2 distance within 2^-8 x
    GRAD_DEPTH over all parameters and for the features. A single
    attention's tensors (its projections, its bias table) sit about 10%
    from JAX's here, as far as JAX's own bf16 gradient sits from its fp32
    one (a sum over windows of softmax gradients that mostly cancel), so
    they are held in the sum, and each bias table's gradient only to be
    nearer JAX's than its own size. Worst seen: 4.9% over the parameters,
    6.0% for the features."""
    sd, params = _weights(3, GRAD_KW)
    dec = _port(sd, dec_kw=GRAD_KW)
    feat, scale = _inputs(4)
    cot = np.random.default_rng(5).standard_normal(
        (2, 1024, 9)).astype(np.float32)

    def jloss(p, x):
        out = JFea2GS(**GRAD_KW, dtype=jnp.bfloat16).apply(
            {"params": p}, x, jnp.asarray(scale))
        return jnp.sum(out.astype(jnp.float32) * cot)

    jg_d, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        params, jnp.asarray(feat))
    x = torch.from_numpy(feat).requires_grad_()
    out = dec(x, torch.from_numpy(scale))
    assert out.shape == cot.shape
    names = [n for n, _ in dec.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                [x, *dec.parameters()], allow_unused=True)
    want = convert._fea2gs(jg_d)
    num = den = 0.0
    tables = 0
    for name, got in zip(names, grads[1:]):
        ref = want[name].double().numpy()
        got = np.zeros_like(ref) if got is None else got.double().numpy()
        assert got.dtype == np.float64
        d, r = np.sum((got - ref) ** 2), np.sum(ref ** 2)
        num, den = num + d, den + r
        if name.endswith("relative_position_bias_table"):
            tables += 1
            assert got.dtype == np.float64 and d < r, name
    assert tables == 3
    assert math.sqrt(num / den) <= STEP * GRAD_DEPTH, math.sqrt(num / den)
    gx, rx = grads[0].double().numpy(), np.asarray(jg_x, np.float64)
    assert np.linalg.norm(gx - rx) <= STEP * GRAD_DEPTH * np.linalg.norm(rx)


def test_bf16_paper_fused_matches_jax():
    """The fused path with a bf16 trunk on a bf16-built decoder (its scale
    MLP, feature projection and injects in f32, UPNet and heads in f32,
    whatever the module's type: the JAX fast path's) against JAX's
    fea2gs_apply_fused(dtype=bfloat16) (K7/K8 with bf16 operands and the
    bias tables in interpret mode): float32 output, each column within
    2^-8 x DEC_DEPTH of its largest entry (worst seen 0.4%); and the same
    function on the
    fp32-built module gives the same bits (the fused path ignores the
    module's type)."""
    sd, params = _weights(6)
    dec = _port(sd)
    feat, scale = _inputs(7)
    ref = jax.jit(lambda p, x, s: jfused(JFea2GS(**DEC_KW), {"params": p},
                                         x, s, dtype=jnp.bfloat16))(
        params, jnp.asarray(feat), jnp.asarray(scale))
    with torch.no_grad():
        out = fea2gs_apply_fused(dec, torch.from_numpy(feat),
                                 torch.from_numpy(scale), BF16)
        same = fea2gs_apply_fused(_port(sd, torch.float32),
                                  torch.from_numpy(feat),
                                  torch.from_numpy(scale), BF16)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert torch.equal(out, same)
    err, col = _col_err(out.numpy(), np.asarray(ref))
    assert (err <= STEP * DEC_DEPTH * col).all(), (err / col)


def test_build_networks_paper_bf16_recipe():
    """configs/train_edsr_paper_bf16_r3.yml builds, read by the port's own
    YAML reader: EDSR and the paper Fea2GS at their published widths in
    bf16 compute on float32 parameters, the heads in float32, on the
    module path."""
    from gsasr_torch.config import (build_networks, build_train_config,
                                    load_options)
    from gsasr_torch.models import EDSRNOUP

    opt = load_options(ROOT / "configs" / "train_edsr_paper_bf16_r3.yml")
    enc, dec = build_networks(opt)
    assert isinstance(enc, EDSRNOUP) and isinstance(dec, Fea2GS)
    assert enc.dtype == BF16 and dec.dtype == BF16
    assert dec.head_dtype == torch.float32
    attn = dec.gs_selfattn_blocks[0].blocks[0].gs_self_attn
    assert attn.qhead.compute_dtype == BF16
    assert dec.UPNet[0].compute_dtype == BF16
    assert dec.mlp_block_mean[0].compute_dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in
               list(enc.parameters()) + list(dec.parameters()))
    assert dec.channel == 180 and len(dec.gs_selfattn_blocks) == 6
    assert not build_train_config(opt).fused_decoder


def test_chip_smoke_paper_bf16_constants_match_yaml():
    """chip_smoke.py writes the paper bf16 recipe out (the card's machine
    reads the file with the port's reader too, but the phase keeps its
    networks and recipe in one place): PAPER_BF16_TRAIN is what
    build_train_config reads from configs/train_edsr_paper_bf16_r3.yml,
    with the file's batch, sizes and rounding, and paper_bf16_networks() is
    build_networks' pair, weight for weight and type for type."""
    import importlib.util

    from gsasr_torch.config import (build_networks, build_train_config,
                                    load_options)
    from gsasr_torch.train import TrainConfig

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    opt = load_options(ROOT / "configs" / "train_edsr_paper_bf16_r3.yml")
    assert TrainConfig(**cs.PAPER_BF16_TRAIN) == build_train_config(opt)
    ds = opt["datasets"]["train"]
    assert cs.PAPER_BATCH == ds["batch_size_per_gpu"]
    assert cs.PAPER_LR_SIZE == ds["lr_size"]
    assert cs.PAPER_SCALES == tuple(ds["scale_list"])
    assert ds["round_mode"] == "round"
    for ours, ref in zip(cs.paper_bf16_networks(), build_networks(opt)):
        assert type(ours) is type(ref) and ours.dtype == ref.dtype == BF16
        for (k, v), (k2, v2) in zip(ours.state_dict().items(),
                                    ref.state_dict().items()):
            assert k == k2 and torch.equal(v, v2), k
