"""gsasr_torch training step against gsasr_tpu on the CPU: losses and the
schedule, one step's loss and gradients against
jax.value_and_grad(Trainer._loss_fn), and whole Trainer.steps (Adam, clip,
EMA, accumulation, SSIM, sparse supervision, the fused decoder) against the
JAX Trainer from the same weights; the fused step against the module step;
the options that are not ported raise; and chip_smoke.py's training
constants equal configs/train_edsr_paper.yml."""

import copy
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_tpu.models import EDSRNOUP as JEDSR
from gsasr_tpu.models import Fea2GS as JFea2GS
from gsasr_tpu.parallel.mesh import make_mesh, replicated_sharding
from gsasr_tpu.train import TrainConfig as JTrainConfig
from gsasr_tpu.train import Trainer as JTrainer
from gsasr_tpu.train import TrainState
from gsasr_tpu.train import losses as jlosses
from gsasr_tpu.train.schedules import multistep_warmup_schedule as jschedule
from gsasr_tpu.utils.torch_convert import convert_edsr, convert_fea2gs
from gsasr_torch.models import EDSRNOUP, Fea2GS
from gsasr_torch.models.init import init_weights
from gsasr_torch.train import TrainConfig, Trainer, losses
from gsasr_torch.train.schedules import multistep_warmup_schedule
from gsasr_torch.utils.convert import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
# tests/test_trainer.py's tiny networks
ENC_KW = dict(num_feat=16, num_block=1)
DEC_KW = dict(inchannel=16, channel=12, num_heads=6, num_crossattn_blocks=1,
              num_crossattn_layers=1, num_selfattn_blocks=1,
              num_selfattn_layers=1, num_gs_seed=16, window_size=4)
CFG = dict(canvas_hw=(32, 32), warmup_iter=2, milestones=(100,))
# The whole-step comparisons take an EMA decay of 0.9: at 0.999 the EMA
# moves about 1e-7 per weight in three steps, a few float32 ulps of the
# weights, so its displacement would be rounding; at 0.9 it is about 1e-5.
STEP_CFG = dict(CFG, ema_decay=0.9)


def _nets(seed=0):
    """Port networks with seeded reference initializers and their JAX
    parameter trees (read by the JAX package's reference converter)."""
    g = torch.Generator().manual_seed(seed)
    enc = init_weights(EDSRNOUP(**ENC_KW), g)
    dec = init_weights(Fea2GS(**DEC_KW), g)
    params = {"g": convert_edsr(enc.state_dict()),
              "d": convert_fea2gs(dec.state_dict(), num_gs_seed=16,
                                  window_size=4, num_heads=6)}
    return enc, dec, jax.tree_util.tree_map(jnp.asarray, params)


def _batch(seed, b=2, lr_size=8, canvas=32, sparse=False):
    rng = np.random.default_rng(seed)
    scales = (2.0 + 2.0 * rng.random(b)).astype(np.float32)
    gt = np.round(scales * lr_size).astype(np.int32)
    batch = {"lq": rng.random((b, lr_size, lr_size, 3), dtype=np.float32),
             "scale": scales, "gt_h": gt, "gt_w": gt}
    if sparse:
        k = 16
        batch["sample_coords"] = np.stack(
            [rng.integers(0, 16, (b, k)), rng.integers(0, 16, (b, k))],
            -1).astype(np.int32)
        batch["gt_samples"] = rng.random((b, k, 3), dtype=np.float32)
    else:
        batch["gt"] = rng.random((b, canvas, canvas, 3), dtype=np.float32)
    return batch


def _jax_trainer(params, cfg_kw):
    jtr = JTrainer(JEDSR(**ENC_KW), JFea2GS(**DEC_KW), JTrainConfig(**cfg_kw),
                   mesh=make_mesh(jax.devices()[:1]))
    copy = lambda t: jax.tree_util.tree_map(jnp.copy, t)  # noqa: E731
    state = TrainState(step=jnp.zeros((), jnp.int32), params_g=params["g"],
                       params_d=params["d"], ema_g=copy(params["g"]),
                       ema_d=copy(params["d"]),
                       opt_state=jtr.tx.init(copy(params)))
    return jtr, jax.device_put(state, replicated_sharding(jtr.mesh))


def _by_name(grads_g, grads_d):
    """JAX (g, d) trees -> {port parameter name: array}, through
    params_from_jax, which takes gradient and EMA trees as they are."""
    sd_g, sd_d = params_from_jax(grads_g, grads_d)
    return ({k: v.numpy() for k, v in sd_g.items()},
            {k: v.numpy() for k, v in sd_d.items()})


# -- losses and schedule ----------------------------------------------------


def test_losses_match_jax(rng):
    pred = rng.random((2, 24, 20, 3), dtype=np.float32)
    tgt = rng.random((2, 24, 20, 3), dtype=np.float32)
    hs, ws = np.int32([17, 24]), np.int32([20, 13])
    jm = jlosses.size_mask(jnp.asarray(hs), jnp.asarray(ws), 24, 20)
    tm = losses.size_mask(torch.from_numpy(hs), torch.from_numpy(ws), 24, 20)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    ref = float(jlosses.masked_l1(jnp.asarray(pred), jnp.asarray(tgt), jm))
    out = float(losses.masked_l1(torch.from_numpy(pred),
                                 torch.from_numpy(tgt), tm))
    # 1e-6: a float32 mean over about 2,000 elements
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    jmap = jlosses.ssim(jnp.asarray(pred), jnp.asarray(tgt), reduce=False)
    tmap = losses.ssim(torch.from_numpy(pred), torch.from_numpy(tgt),
                       reduce=False)
    # 1e-5: two 11-tap float32 blurs summed in another order, then ratios
    np.testing.assert_allclose(tmap.numpy(), np.asarray(jmap), rtol=1e-5,
                               atol=1e-5)
    # absolute: the mean SSIM of random images is near 0
    np.testing.assert_allclose(
        float(losses.ssim(torch.from_numpy(pred), torch.from_numpy(tgt))),
        float(jlosses.ssim(jnp.asarray(pred), jnp.asarray(tgt))), rtol=0,
        atol=1e-6)


@pytest.mark.parametrize("warmup", [2000, -1, 3])
def test_schedule_matches_jax(warmup):
    ms = (5, 400, 12)
    ref = jschedule(2e-4, ms, 0.5, warmup)
    out = multistep_warmup_schedule(2e-4, ms, 0.5, warmup)
    for step in (0, 1, 2, 4, 5, 11, 12, 13, 399, 400, 1999, 2000, 5000):
        # 1e-6: JAX computes in float32, the port in float64
        np.testing.assert_allclose(out(step), float(ref(step)), rtol=1e-6)


# -- one step's loss and gradients ------------------------------------------


def test_loss_and_grads_match_jax():
    enc, dec, params = _nets(1)
    batch = _batch(2)
    jtr, _ = _jax_trainer(params, CFG)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jtr._loss_fn, has_aux=True))(
        params, jax.tree_util.tree_map(jnp.asarray, batch),
        jax.random.PRNGKey(0))
    tr = Trainer(enc, dec, TrainConfig(**CFG), device="cpu")
    loss, met, g_g, g_d = tr.grads(batch)
    # 1e-5 relative: the render sums Gaussians in another order
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(met["l_pix"]), float(jmet["l_pix"]),
                               rtol=1e-5)
    want_g, want_d = _by_name(jgrads["g"], jgrads["d"])
    for mod, grads, want in ((enc, g_g, want_g), (dec, g_d, want_d)):
        for (name, _), got in zip(mod.named_parameters(), grads):
            ref = want[name]
            # 1e-3 of the tensor's largest entry: a gradient chain through
            # the render's moment sums and the decoder, summed in another
            # order
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3,
                                       atol=1e-3 * np.abs(ref).max() + 1e-9,
                                       err_msg=name)


# -- whole steps against the JAX Trainer ------------------------------------


def _run_both(cfg_kw, batches):
    enc, dec, params = _nets(3)
    start = ({n: p.detach().numpy().copy() for n, p in enc.named_parameters()},
             {n: p.detach().numpy().copy() for n, p in dec.named_parameters()})
    jtr, state = _jax_trainer(params, cfg_kw)
    tr = Trainer(enc, dec, TrainConfig(**cfg_kw), device="cpu")
    jm, tm = [], []
    for b in batches:
        state, m = jtr.step(state, jax.tree_util.tree_map(jnp.asarray, b))
        jm.append({k: float(v) for k, v in m.items()})
        tm.append({k: float(v) for k, v in tr.step(b).items()})
    return tr, state, jm, tm, start


def _assert_params_close(tr, state, lr_sum):
    """Adam's first steps move each weight by about lr * sign(g), and a
    gradient within float32 noise of zero (the k biases' true gradient is 0)
    can take either sign: parameters agree within 2 * the summed learning
    rates, and on average within a hundredth of that."""
    want = _by_name(state.params_g, state.params_d)
    diffs = []
    for i, mod in enumerate((tr.enc, tr.dec)):
        for name, p in mod.named_parameters():
            d = np.abs(p.detach().numpy() - want[i][name])
            assert d.max() <= 2 * lr_sum + 1e-6, (name, float(d.max()))
            diffs.append(d.ravel())
    assert np.concatenate(diffs).mean() <= 0.01 * lr_sum


def _assert_ema_close(tr, state, start):
    """Each network's EMA displacement from the start weights, ema - p0,
    against the JAX Trainer's, within 1e-2 of its norm: a few sign flips of
    near-zero gradients (see above) and float32 rounding of the EMA update
    keep it from matching closer. A wrong decay, or an EMA that skips the
    calls without an update, is off by tens of percent or more."""
    want = _by_name(state.ema_g, state.ema_d)
    for i, ema in enumerate((tr.ema_g, tr.ema_d)):
        err = ref = 0.0
        for name, e in ema.named_parameters():
            d_ref = want[i][name].astype(np.float64) - start[i][name]
            d_got = e.numpy().astype(np.float64) - start[i][name]
            err += np.sum((d_got - d_ref) ** 2)
            ref += np.sum(d_ref ** 2)
        assert ref > 0 and np.sqrt(err) <= 1e-2 * np.sqrt(ref), \
            (i, float(np.sqrt(err / ref)))


def test_three_steps_match_jax_trainer():
    """Default options (clip 5, Adam, warm-up, EMA at STEP_CFG's decay) for
    three steps from the same weights."""
    batches = [_batch(s) for s in (4, 5, 6)]
    tr, state, jm, tm, start = _run_both(STEP_CFG, batches)
    for j, t in zip(jm, tm):
        assert set(t) == set(j)
        for k in j:
            # 1e-4 relative: losses, norms and the schedule in float32
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)
    sched = multistep_warmup_schedule(2e-4, (100,), 0.5, 2)
    assert tr.update_count == 3
    _assert_params_close(tr, state, sum(sched(n) for n in range(3)))
    _assert_ema_close(tr, state, start)


@pytest.mark.parametrize("opts", [
    dict(accumulation_steps=2, ssim_weight=0.1),
    dict(sparse=True)], ids=["accumulate2_ssim", "sample_coords"])
def test_options_match_jax_trainer(opts):
    """accumulation_steps=2 (a running mean, one update every other call,
    the EMA on every call: the third call moves it with no update) with
    SSIM on; sparse supervision on sampled pixels."""
    opts = dict(opts)
    sparse = opts.pop("sparse", False)
    cfg = dict(STEP_CFG, **opts)
    batches = [_batch(s, sparse=sparse) for s in (7, 8, 9)]
    tr, state, jm, tm, start = _run_both(cfg, batches)
    for j, t in zip(jm, tm):
        assert set(t) == set(j)
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)
    sched = multistep_warmup_schedule(2e-4, (100,), 0.5, 2)
    n_updates = len(batches) // cfg.get("accumulation_steps", 1)
    assert tr.update_count == n_updates and tr.step_count == len(batches)
    _assert_params_close(tr, state, sum(sched(n) for n in range(n_updates)))
    _assert_ema_close(tr, state, start)


def test_update_ignores_gradient_strides():
    """The update is the same whether autograd hands back a gradient
    contiguous or with transposed strides (fused Adam reads a gradient as
    laid out like its parameter)."""
    enc, dec, _ = _nets(5)
    trs = [Trainer(copy.deepcopy(enc), copy.deepcopy(dec), TrainConfig(**CFG),
                   device="cpu") for _ in range(2)]
    loss, met, g_g, g_d = trs[0].grads(_batch(9))
    strided = [g.t().contiguous().t() if g.dim() == 2 else g.clone()
               for g in g_d]
    assert any(not g.is_contiguous() for g in strided)
    trs[0].apply(loss, met, [g.clone() for g in g_g],
                 [g.contiguous().clone() for g in g_d])
    trs[1].apply(loss, met, [g.clone() for g in g_g], strided)
    for a, b in zip(trs[0].params_d, trs[1].params_d):
        assert torch.equal(a, b)


# -- the fused decoder path -------------------------------------------------


def test_fused_step_matches_jax_trainer():
    """One step with fused_decoder=True (kernels M and A forward, MB and AB
    backward on the card; their plain versions here) against the JAX
    Trainer with the same option (K7-K10 in interpret mode) from the same
    weights."""
    cfg = dict(STEP_CFG, fused_decoder=True)
    tr, state, jm, tm, start = _run_both(cfg, [_batch(10)])
    assert set(tm[0]) == set(jm[0])
    for k in jm[0]:
        # 1e-5 relative for the losses; 1e-4 for the gradient norms, sums
        # over every parameter, as in the module-path steps
        rtol = 1e-5 if k in ("loss", "l_pix") else 1e-4
        np.testing.assert_allclose(tm[0][k], jm[0][k], rtol=rtol, err_msg=k)
    sched = multistep_warmup_schedule(2e-4, (100,), 0.5, 2)
    _assert_params_close(tr, state, sched(0))
    _assert_ema_close(tr, state, start)


def test_fused_step_matches_module_step():
    """The port's fused step against its module step from the same weights
    and batch, at tests/test_trainer.py's fused-vs-module tolerance: the
    same loss (1e-5 relative) and updated parameters within 5e-3."""
    enc, dec, _ = _nets(11)
    batch = _batch(12)
    res = []
    for fused in (False, True):
        tr = Trainer(copy.deepcopy(enc), copy.deepcopy(dec),
                     TrainConfig(**CFG, fused_decoder=fused), device="cpu")
        loss = float(tr.step(batch)["loss"])
        res.append((loss, [p.detach().numpy().copy()
                           for p in tr.params_g + tr.params_d]))
    (l_mod, p_mod), (l_fused, p_fused) = res
    np.testing.assert_allclose(l_fused, l_mod, rtol=1e-5)
    for a, b in zip(p_fused, p_mod):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-3)


# -- what is not ported raises -----------------------------------------------


def test_unported_options_raise(monkeypatch):
    enc, dec, _ = _nets(0)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        Trainer(enc, dec, TrainConfig(), device="cpu", mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(enc, dec, TrainConfig())


# -- the YAML and chip_smoke.py's constants ---------------------------------


def test_chip_smoke_training_constants_match_yaml():
    """chip_smoke.py writes the paper recipe out (the card has no PyYAML);
    it must equal what build_train_config reads from the file, and its
    batch must be the dataset block's."""
    from gsasr_torch.config import build_networks, build_train_config, \
        load_options

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    opt = load_options(ROOT / "configs" / "train_edsr_paper.yml")
    assert TrainConfig(**cs.PAPER_TRAIN) == build_train_config(opt)
    ds = opt["datasets"]["train"]
    assert cs.PAPER_BATCH == ds["batch_size_per_gpu"]
    assert cs.PAPER_LR_SIZE == ds["lr_size"]
    assert cs.PAPER_SCALES == tuple(ds["scale_list"])
    assert ds["round_mode"] == "round"
    # the paper widths chip_smoke.py builds with make_models are the file's
    from gsasr_torch.model import make_models
    enc, dec = build_networks(opt)
    enc2, dec2 = make_models("edsr", "paper", device="cpu")
    for a, b in ((enc, enc2), (dec, dec2)):
        assert {k: v.shape for k, v in a.state_dict().items()} == \
            {k: v.shape for k, v in b.state_dict().items()}


def test_build_networks_and_overrides():
    from gsasr_torch.config import apply_overrides, build_networks

    opt = {"network_g": {"type": "EDSRNOUP", "num_feat": 8, "num_block": 1,
                         "upscale": 4},
           "network_fea2gs": {"type": "Fea2GS", **DEC_KW, "inchannel": 8}}
    apply_overrides(opt, ["network_g:num_block=2", "train.ema_decay=0.99"])
    assert opt["train"]["ema_decay"] == 0.99
    enc, dec = build_networks(opt)
    assert len(enc.body) == 2 and dec.channel == 12
    enc2, _ = build_networks(opt)
    assert torch.equal(enc.conv_first.weight, enc2.conv_first.weight)
    for bad, err in (({"type": "UNKNOWNNOUP"}, NotImplementedError),
                     ({"type": "EDSR", "num_feats": 8}, TypeError)):
        with pytest.raises(err):
            build_networks(dict(opt, network_g=bad))
    with pytest.raises(NotImplementedError, match="bf16"):
        build_networks(dict(opt, model_dtype="bfloat16"))
