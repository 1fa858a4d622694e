"""The SwinIR-GSASR training step of gsasr_torch against gsasr_tpu's
Trainer on the CPU: a tiny SwinIR encoder (window 4, so its odd blocks
shift and take the SW-MSA mask) and a tiny paper decoder, drop_path_rate 0
(the JAX and port DropPath streams draw different bits). One step's loss
and every gradient against jax.value_and_grad(Trainer._loss_fn), and the
weights and EMA after two whole steps against the JAX Trainer's. The JAX
side's window attentions take its plain reference (GSASR_ATTN=reference;
tests/test_torch_attention.py holds K13/K13b in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_tpu.models import Fea2GS as JFea2GS
from gsasr_tpu.models import SwinIRNOUP as JSwinIR
from gsasr_tpu.parallel.mesh import make_mesh, replicated_sharding
from gsasr_tpu.train import TrainConfig as JTrainConfig
from gsasr_tpu.train import Trainer as JTrainer
from gsasr_tpu.train import TrainState
from gsasr_tpu.utils.torch_convert import convert_fea2gs, convert_swinir
from gsasr_torch.models import Fea2GS, SwinIRNOUP
from gsasr_torch.models.init import init_weights
from gsasr_torch.train import TrainConfig, Trainer
from gsasr_torch.train.schedules import multistep_warmup_schedule
from gsasr_torch.utils.convert import params_from_jax

ENC_KW = dict(embed_dim=24, depths=(2,), num_heads=(6,), window_size=4,
              num_feat=16, drop_path_rate=0.0)
DEC_KW = dict(inchannel=16, channel=12, num_heads=6, num_crossattn_blocks=1,
              num_crossattn_layers=1, num_selfattn_blocks=1,
              num_selfattn_layers=1, num_gs_seed=16, window_size=4)
# an EMA decay of 0.9 moves the EMA by about 1e-5 per weight in two steps,
# far above float32 rounding (tests/test_torch_trainer.py's STEP_CFG)
CFG = dict(canvas_hw=(32, 32), warmup_iter=2, milestones=(100,),
           ema_decay=0.9)


@pytest.fixture(autouse=True)
def _jax_reference_attention(monkeypatch):
    monkeypatch.setenv("GSASR_ATTN", "reference")


def _nets():
    g = torch.Generator().manual_seed(0)
    enc = init_weights(SwinIRNOUP(**ENC_KW), g)
    dec = init_weights(Fea2GS(**DEC_KW), g)
    params = {"g": convert_swinir(enc.state_dict()),
              "d": convert_fea2gs(dec.state_dict(), num_gs_seed=16,
                                  window_size=4, num_heads=6)}
    return enc, dec, jax.tree_util.tree_map(jnp.asarray, params)


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    scales = (2.0 + 2.0 * rng.random(b)).astype(np.float32)
    gt = np.round(scales * 8).astype(np.int32)
    return {"lq": rng.random((b, 8, 8, 3), dtype=np.float32),
            "gt": rng.random((b, 32, 32, 3), dtype=np.float32),
            "scale": scales, "gt_h": gt, "gt_w": gt}


def _jax_trainer(params):
    jtr = JTrainer(JSwinIR(**ENC_KW), JFea2GS(**DEC_KW), JTrainConfig(**CFG),
                   mesh=make_mesh(jax.devices()[:1]))
    cp = lambda t: jax.tree_util.tree_map(jnp.copy, t)  # noqa: E731
    state = TrainState(step=jnp.zeros((), jnp.int32), params_g=params["g"],
                       params_d=params["d"], ema_g=cp(params["g"]),
                       ema_d=cp(params["d"]),
                       opt_state=jtr.tx.init(cp(params)))
    return jtr, jax.device_put(state, replicated_sharding(jtr.mesh))


def _by_name(tree_g, tree_d):
    sd_g, sd_d = params_from_jax(tree_g, tree_d)
    return ({k: v.numpy() for k, v in sd_g.items()},
            {k: v.numpy() for k, v in sd_d.items()})


def test_loss_and_grads_match_jax():
    enc, dec, params = _nets()
    batch = _batch(1)
    jtr, _ = _jax_trainer(params)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jtr._loss_fn, has_aux=True))(
        params, jax.tree_util.tree_map(jnp.asarray, batch),
        jax.random.PRNGKey(0))
    tr = Trainer(enc, dec, TrainConfig(**CFG), device="cpu")
    loss, _, g_g, g_d = tr.grads(batch)
    # tests/test_torch_trainer.py's tolerances: 1e-5 relative for the loss
    # (the render sums Gaussians in another order), 1e-3 of each tensor's
    # largest entry for a gradient through the render and both networks
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want_g, want_d = _by_name(jgrads["g"], jgrads["d"])
    for mod, grads, want in ((enc, g_g, want_g), (dec, g_d, want_d)):
        for (name, _), got in zip(mod.named_parameters(), grads):
            ref = want[name]
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3,
                                       atol=1e-3 * np.abs(ref).max() + 1e-9,
                                       err_msg=name)


def test_two_steps_match_jax_trainer():
    """Two whole steps (clip 5, Adam, warm-up, EMA) from the same weights:
    the metrics, the weights (Adam moves each by about lr sign(g), and a
    gradient within float32 noise of 0 can take either sign) and each
    network's EMA displacement."""
    enc, dec, params = _nets()
    start = [{n: p.detach().numpy().copy() for n, p in m.named_parameters()}
             for m in (enc, dec)]
    jtr, state = _jax_trainer(params)
    tr = Trainer(enc, dec, TrainConfig(**CFG), device="cpu")
    for seed in (2, 3):
        b = _batch(seed)
        state, jm = jtr.step(state, jax.tree_util.tree_map(jnp.asarray, b))
        tm = tr.step(b)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, err_msg=k)
    sched = multistep_warmup_schedule(2e-4, (100,), 0.5, 2)
    lr_sum = sched(0) + sched(1)
    want = _by_name(state.params_g, state.params_d)
    ema = _by_name(state.ema_g, state.ema_d)
    diffs = []
    for i, (mod, emod) in enumerate(((tr.enc, tr.ema_g), (tr.dec, tr.ema_d))):
        for name, p in mod.named_parameters():
            d = np.abs(p.detach().numpy() - want[i][name])
            assert d.max() <= 2 * lr_sum + 1e-6, (name, float(d.max()))
            diffs.append(d.ravel())
        err = ref = 0.0
        for name, e in emod.named_parameters():
            d_ref = ema[i][name].astype(np.float64) - start[i][name]
            d_got = e.numpy().astype(np.float64) - start[i][name]
            err += np.sum((d_got - d_ref) ** 2)
            ref += np.sum(d_ref ** 2)
        assert ref > 0 and np.sqrt(err) <= 1e-2 * np.sqrt(ref), i
    assert np.concatenate(diffs).mean() <= 0.01 * lr_sum
