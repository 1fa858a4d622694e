"""One Trainer step of the paper Fea2GS in bf16
(`configs/train_edsr_paper_bf16_r3.yml`) against the JAX Trainer on the
CPU, on the module path (the recipe's) and on the fused path: loss,
gradients and the parameters after the update (a file of its own: each
JAX Trainer compiles its Pallas kernels in interpret mode).

Tolerances as tests/test_torch_enhanced_train.py's one-step test states
them: 2^-8 relative for the loss, relative L2 2^-8 times a network's bf16
depth for its gradient, and 2 lr per weight after Adam's first step.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gsasr_tpu.models import EDSRNOUP as JEDSR
from gsasr_tpu.models import Fea2GS as JFea2GS
from gsasr_tpu.parallel.mesh import make_mesh
from gsasr_tpu.train import TrainConfig as JTrainConfig
from gsasr_tpu.train import Trainer as JTrainer
from gsasr_tpu.utils.torch_convert import convert_edsr, convert_fea2gs
from gsasr_torch.models import EDSRNOUP, Fea2GS
from gsasr_torch.models.init import init_weights
from gsasr_torch.train import TrainConfig, Trainer
from gsasr_torch.utils.convert import params_from_jax

BF16 = torch.bfloat16
STEP = 2.0 ** -8
ENC_KW = dict(num_feat=16, num_block=1)
DEC_KW = dict(inchannel=16, channel=24, num_heads=6, num_crossattn_blocks=1,
              num_crossattn_layers=1, num_selfattn_blocks=1,
              num_selfattn_layers=1, num_gs_seed=16, window_size=4)
# bf16 sub-layers of DEC_KW's decoder, loss to input: UPNet's two convs;
# per block its norm and tail MLP; per layer its inject, two FFNs and
# attention; the feature projection's two convs
DEC_DEPTH = 2 + 2 * (2 + 4) + 2
# the paper bf16 recipe's no-clip (clip_grad_norm: false), no warm-up
CFG = dict(canvas_hw=(32, 32), warmup_iter=-1, milestones=(100,),
           clip_grad_norm=None)


def _batch(seed, b=2, lr_size=8, canvas=32):
    rng = np.random.default_rng(seed)
    scales = (2.0 + 2.0 * rng.random(b)).astype(np.float32)
    gt = np.round(scales * lr_size).astype(np.int32)
    return {"lq": rng.random((b, lr_size, lr_size, 3), dtype=np.float32),
            "gt": rng.random((b, canvas, canvas, 3), dtype=np.float32),
            "scale": scales, "gt_h": gt, "gt_w": gt}


def _by_name(tree_g, tree_d):
    sd_g, sd_d = params_from_jax(tree_g, tree_d)
    return ({k: v.numpy() for k, v in sd_g.items()},
            {k: v.numpy() for k, v in sd_d.items()})


@pytest.mark.parametrize("fused", [False, True], ids=["module", "fused"])
def test_paper_bf16_trainer_step_matches_jax(fused):
    """The module path: the recipe's bf16 EDSR and bf16 paper decoder (W-
    and WB-bf16's plain versions with the bias tables, T's ordered table
    gradient) against the JAX Trainer with both networks in bf16. The fused
    path: the decoder's bf16 trunk through M, A, MB and AB's plain versions
    with the bias tables, fp32 UPNet and heads, against the JAX
    Trainer(fused_decoder=True); its encoder runs in fp32 there, since JAX's
    fused path refuses a bf16 encoder's features (its f32 feature
    projection takes f32 only; the port widens them). Worst seen:
    gradients 0.2% and 0.14% (decoder), 1.7% and 2.1% (encoder)."""
    g = torch.Generator().manual_seed(11)
    enc = init_weights(EDSRNOUP(**ENC_KW), g)
    dec = init_weights(Fea2GS(**DEC_KW), g)
    params = jax.tree_util.tree_map(jnp.asarray, {
        "g": convert_edsr(enc.state_dict()),
        "d": convert_fea2gs(dec.state_dict(), num_gs_seed=16, window_size=4,
                            num_heads=6)})
    enc_dt = torch.float32 if fused else BF16
    p_enc, p_dec = EDSRNOUP(**ENC_KW, dtype=enc_dt), Fea2GS(**DEC_KW,
                                                             dtype=BF16)
    p_enc.load_state_dict(enc.state_dict())
    p_dec.load_state_dict(dec.state_dict())
    batch = _batch(12)
    jdt = jnp.float32 if fused else jnp.bfloat16
    jtr = JTrainer(JEDSR(**ENC_KW, dtype=jdt),
                   JFea2GS(**DEC_KW, dtype=jnp.bfloat16),
                   JTrainConfig(**CFG, fused_decoder=fused),
                   mesh=make_mesh(jax.devices()[:1]))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jtr._loss_fn,
                                                    has_aux=True))(
        params, jax.tree_util.tree_map(jnp.asarray, batch),
        jax.random.PRNGKey(0))
    updates, _ = jtr.tx.update(jgrads, jtr.tx.init(params), params)
    jnew = _by_name(*(lambda t: (t["g"], t["d"]))(
        optax.apply_updates(params, updates)))

    tr = Trainer(p_enc, p_dec, TrainConfig(**CFG, fused_decoder=fused),
                 device="cpu")
    loss, met, g_g, g_d = tr.grads(batch)
    assert all(x.dtype == torch.float32 for x in g_g + g_d)
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
    lr = 2e-4
    diffs = []
    for mod, ref in ((tr.enc, jnew[0]), (tr.dec, jnew[1])):
        for name, p in mod.named_parameters():
            d = np.abs(p.detach().numpy() - ref[name])
            assert d.max() <= 2 * lr + 1e-6, (name, float(d.max()))
            diffs.append(d.ravel())
    assert np.concatenate(diffs).mean() <= 0.05 * lr
