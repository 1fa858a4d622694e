"""`python -m gsasr_torch.cli.train` on the CPU at a tiny width through
--force_yml: a few iterations with saves, validation and best-step
tracking, then --auto_resume; and its logged losses of the first two steps
against the JAX package's Trainer.step on JAX's first two batch_iterator
batches, from the same .pth weights loaded through each package's
`pretrain_network_*` path."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_torch.cli import train
from gsasr_torch.utils import checkpoint as ck
from gsasr_torch.utils.png import write_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT = os.path.join(ROOT, "configs", "train_edsr_paper.yml")
# the recipe cut to tests/test_trainer.py's tiny networks, 2 samples of
# 8x8 LR, 3 data threads
TINY = ["network_g:num_feat=16", "network_g:num_block=1",
        "network_fea2gs:inchannel=16", "network_fea2gs:channel=12",
        "network_fea2gs:num_crossattn_layers=1",
        "network_fea2gs:num_selfattn_blocks=1",
        "network_fea2gs:num_selfattn_layers=1",
        "network_fea2gs:num_gs_seed=16", "network_fea2gs:window_size=4",
        "datasets:train:lr_size=8", "datasets:train:batch_size_per_gpu=2",
        "datasets:train:num_worker_per_gpu=3",
        "datasets:train:dataset_enlarge_ratio=2",
        "logger:print_freq=1", "logger:use_tb_logger=false"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Five seeded 40x40 training PNGs and one x4 validation pair."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    for sub in ("gt", "val/gt", "val/lq"):
        os.makedirs(d / sub)
    for i in range(5):
        write_png(d / "gt" / f"{i}.png",
                  (rng.random((40, 40, 3)) * 255).astype(np.uint8))
    write_png(d / "val/gt/a.png",
              (rng.random((32, 32, 3)) * 255).astype(np.uint8))
    write_png(d / "val/lq/a.png",
              (rng.random((8, 8, 3)) * 255).astype(np.uint8))
    return d


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # many small torch ops: the default pool spins against the other test
    # workers' (tests/test_torch_infer.py)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(data, exp, total, *extra):
    return ["-opt", OPT, "--device", "cpu", "--force_yml", *TINY,
            f"datasets:train:all_gt_list=[{data / 'gt'}]",
            f"path:experiments_root={exp}", f"train:total_iter={total}",
            *extra]


def test_train_cli_saves_validates_and_resumes(data, tmp_path):
    """Four iterations saving every 2 and validating every 2 on the EMA
    weights (PSNR and SSIM; the best step marked), then --auto_resume to 6:
    the run restores the newest step bit for bit and goes on from it,
    restarting the epoch loop at 0 as JAX's CLI does."""
    val = ["datasets:val:name=v", f"datasets:val:dataroot_gt={data}/val/gt",
           f"datasets:val:dataroot_lq={data}/val/lq", "datasets:val:scale=4",
           "val:val_freq=2", "logger:save_checkpoint_freq=2"]
    exp = tmp_path / "exp"
    run = train.main(_args(data, exp, 4, *val))
    assert run["iter"] == 4 and sorted(run["logged"]) == [1, 2, 3, 4]
    assert all(np.isfinite(v["loss"]) for v in run["logged"].values())
    ckpt = exp / "checkpoints"
    assert sorted(p for p in os.listdir(ckpt) if p.isdigit()) == ["2", "4"]
    assert os.readlink(ckpt / "best") == "2"
    hist = run["history"].history("v", "psnr")
    assert [i for i, _ in hist] == [2, 4] and np.isfinite(hist[0][1])
    assert len(run["data_s"]) == len(run["iter_s"]) == 4
    saved = ck.load_step(ckpt, 4)

    resumed = {}
    orig = ck.restore_checkpoint

    def spy(directory, step, trainer):
        out = orig(directory, step, trainer)
        resumed[step] = trainer.state_dict()
        return out

    ck.restore_checkpoint = spy
    try:
        run2 = train.main(_args(data, exp, 6, *val) + ["--auto_resume"])
    finally:
        ck.restore_checkpoint = orig
    assert list(resumed) == [4]
    for net in ("net_g", "net_fea2gs"):
        for key in ("params", "params_ema"):
            for k, v in saved[net][key].items():
                assert torch.equal(resumed[4][net][key][k], v), (net, k)
    assert resumed[4]["train_state"]["step_count"] == 4
    assert run2["iter"] == 6 and sorted(run2["logged"]) == [5, 6]
    assert run2["trainer"].step_count == 6
    assert sorted(p for p in os.listdir(ckpt) if p.isdigit()) == [
        "2", "4", "6"]


def test_train_cli_refuses(data, tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="Queue 1, item 6"):
        train.main(_args(data, tmp_path, 1) + ["--multihost"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        train.main(["-opt", OPT])


def test_first_two_losses_match_jax_trainer(data, tmp_path):
    """The CLI's logged losses of steps 1 and 2 against the JAX Trainer's on
    the JAX package's first two batch_iterator batches (3 threads, the same
    per-position streams), with both packages' networks loaded from the
    same .pth pair through pretrain_network_g / pretrain_network_fea2gs;
    within 1e-4 relative, tests/test_torch_trainer_steps.py's tolerance
    for a step's metrics."""
    from gsasr_tpu import config as jconfig
    from gsasr_tpu.data import datasets as jds
    from gsasr_tpu.parallel.mesh import make_mesh, replicated_sharding
    from gsasr_tpu.train import Trainer as JTrainer
    from gsasr_tpu.train import TrainState
    from gsasr_tpu.utils.checkpoint import load_pretrained_params as jpre
    from gsasr_torch.config import (apply_overrides, build_networks,
                                    load_options)

    opt = apply_overrides(load_options(OPT), TINY)
    enc, dec = build_networks(opt, torch.Generator().manual_seed(21))
    g, d = tmp_path / "net_g.pth", tmp_path / "net_fea2gs.pth"
    torch.save({"params": enc.state_dict()}, g)
    # without the decoder's index buffers, which the port's modules build
    # and which JAX's loader would remap to the 144-seed lattice of its
    # converter's defaults
    torch.save({"params": {k: v for k, v in dec.state_dict().items()
                           if not k.endswith("relative_position_index")}}, d)
    pre = [f"path:pretrain_network_g={g}",
           f"path_fea2gs:pretrain_network_fea2gs={d}"]
    run = train.main(_args(data, tmp_path / "exp", 2, *pre))
    got = [run["logged"][i]["loss"] for i in (1, 2)]

    jopt = jconfig.apply_overrides(jconfig.load_options(OPT), TINY + pre + [
        f"datasets:train:all_gt_list=[{data / 'gt'}]"])
    jenc, jdec = jconfig.build_networks(jopt)
    jtr = JTrainer(jenc, jdec, jconfig.build_train_config(jopt),
                   mesh=make_mesh(jax.devices()[:1]))
    # the state JAX's CLI makes: Trainer.init's, with params and EMA
    # replaced by the loaded networks (built here without init's compile)
    pg, pd = (jax.tree_util.tree_map(jnp.asarray, p) for p in (
        jpre(str(g), "edsr", "params"), jpre(str(d), "fea2gs", "params")))
    copy = lambda t: jax.tree_util.tree_map(jnp.copy, t)  # noqa: E731
    state = jax.device_put(TrainState(
        step=jnp.zeros((), jnp.int32), params_g=pg, params_d=pd,
        ema_g=copy(pg), ema_d=copy(pd),
        opt_state=jtr.tx.init({"g": copy(pg), "d": copy(pd)})),
        replicated_sharding(jtr.mesh))
    ds_opt = jopt["datasets"]["train"]
    ds = jds.ContinuousBicubicDataset(
        ds_opt["all_gt_list"], scale_list=ds_opt["scale_list"],
        lr_size=ds_opt["lr_size"], round_mode=ds_opt["round_mode"], seed=0)
    batches = jds.batch_iterator(ds, 2, epoch=0, seed=0, enlarge_ratio=2,
                                 num_workers=3)
    want = []
    for _ in range(2):
        state, m = jtr.step(state, next(batches))
        want.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
