"""Training CLI (counterpart of `gsasr_tpu/cli/train.py`, the reference's
`basicsr/train.py`), on the CUDA card unless --device cpu is given.

Usage:
  python -m gsasr_torch.cli.train -opt configs/train_edsr_paper.yml \\
      [--auto_resume] [--force_yml train:total_iter=1000] [--device cpu]

The flow is JAX's: the networks and the recipe from the YAML file (read by
the port's own reader, `utils/yaml_subset.py`); `pretrain_network_g` and
`pretrain_network_fea2gs` from a reference `.pth` file or a step directory;
with --auto_resume, the newest step under `<experiments_root>/checkpoints`
restored bit for bit, the epoch loop restarting at 0 as JAX's does;
threaded batches (`batch_iterator`) through `DevicePrefetcher`; a log line
every `print_freq`, a saved step every `save_checkpoint_freq`, validation
on the EMA weights every `val_freq` with best-step tracking, and a final
save. The batch is `batch_size_per_gpu` on one card; --multihost is not
ported (ROADMAP Queue 1, item 6).
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch


def _denominator(enc, dec) -> int:
    """The padding denominator of validation images: the decoder's window
    and the encoder's, if it has one (12 for EDSR and RDN, 24 for paper
    SwinIR, 16 for the window-16 decoders, 48 for the paper HAT)."""
    return math.lcm(dec.window_size, getattr(enc, "window_size", 1))


def _validate(trainer, val_opt, opt, device):
    """In-training validation (reference `nondist_validation`) on the EMA
    weights: the mean of each metric of the yaml's `val.metrics` table
    (default PSNR and SSIM on Y, border cropped by the scale) over the
    validation pairs, in RGB order."""
    from gsasr_torch.data.datasets import PairedImageDataset
    from gsasr_torch.metrics import calculate_metric, crop_border_for_scale
    from gsasr_torch.model import sr_forward

    enc, dec = trainer.ema_g, trainer.ema_d
    ds = PairedImageDataset(val_opt["dataroot_gt"], val_opt["dataroot_lq"],
                            val_opt.get("scale", 4))
    crop = crop_border_for_scale(ds.scale)
    # RGB throughout; calculate_psnr/ssim default to BGR (the reference's
    # cv2 order), so the order is forced to rgb for yaml metrics too
    metric_opts = opt.get("val", {}).get("metrics") or {
        "psnr": dict(type="calculate_psnr", crop_border=crop,
                     test_y_channel=True),
        "ssim": dict(type="calculate_ssim", crop_border=crop,
                     test_y_channel=True),
    }
    metric_opts = {name: {**mopt, "channel_order": "rgb"}
                   for name, mopt in metric_opts.items()}
    n_images = min(len(ds), val_opt.get("max_images", len(ds)))
    sums = {k: 0.0 for k in metric_opts}
    denom = _denominator(enc, dec)
    for i in range(n_images):
        item = ds[i]
        want = (item["gt"].shape[0], item["gt"].shape[1])
        out = sr_forward(enc, dec, item["lq"][None], ds.scale, sr_size=want,
                         denominator=denom, dmax=0.1,
                         device=device).cpu().numpy()[0]
        sr255 = np.clip(out, 0, 1) * 255
        gt255 = item["gt"] * 255
        for name, mopt in metric_opts.items():
            sums[name] += calculate_metric(dict(img=sr255, img2=gt255), mopt)
    return {k: v / max(n_images, 1) for k, v in sums.items()}


def main(argv=None):
    """Run the CLI on `argv` (default: the command line). Returns a dict:
    the trainer, the last iteration, the logged scalars by iteration, each
    iteration's wait for its batch and its wall time in seconds (without a
    sync, save at the log lines), the validation history and the
    checkpoint directory."""
    p = argparse.ArgumentParser()
    p.add_argument("-opt", required=True)
    p.add_argument("--auto_resume", action="store_true")
    p.add_argument("--force_yml", nargs="*", default=None)
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")
    args = p.parse_args(argv)
    if args.multihost:
        raise SystemExit("--multihost: multi-GPU training is not ported yet "
                         "(ROADMAP Queue 1, item 6)")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card is available; pass --device cpu to "
                         "run the plain PyTorch path")

    from gsasr_torch.config import (apply_overrides, build_networks,
                                    build_train_config, load_options)
    from gsasr_torch.data.datasets import (ContinuousBicubicDataset,
                                           batch_iterator)
    from gsasr_torch.data.prefetch import DevicePrefetcher
    from gsasr_torch.train import Trainer
    from gsasr_torch.utils.checkpoint import (CONVERTER_KINDS, latest_step,
                                              load_pretrained_params,
                                              mark_best, restore_checkpoint,
                                              save_checkpoint)
    from gsasr_torch.utils.convert import load_params
    from gsasr_torch.utils.env import get_env_info
    from gsasr_torch.utils.logging import (AvgTimer, MessageLogger,
                                           MetricHistory, get_root_logger,
                                           init_wandb_logger)

    opt = apply_overrides(load_options(args.opt), args.force_yml)
    exp_dir = opt.get("path", {}).get(
        "experiments_root", f"experiments/{opt.get('name', 'run')}")
    os.makedirs(exp_dir, exist_ok=True)
    logger = get_root_logger(log_file=f"{exp_dir}/train.log")
    logger.info(get_env_info())
    enc, dec = build_networks(opt)
    cfg = build_train_config(opt)

    # pretrained networks (reference `path.pretrain_network_g` /
    # `path_fea2gs.pretrain_network_fea2gs`, train.py:132-142): params and
    # EMA start from a .pth or a step directory
    path_opt = opt.get("path", {}) or {}
    fea_opt = opt.get("path_fea2gs", {}) or {}
    for mod, spec, kind, key, net in (
            (enc, path_opt.get("pretrain_network_g"),
             CONVERTER_KINDS[opt["network_g"]["type"]],
             path_opt.get("param_key_g", "params"), "g"),
            (dec, fea_opt.get("pretrain_network_fea2gs"),
             CONVERTER_KINDS[opt["network_fea2gs"]["type"]],
             fea_opt.get("param_key_fea2gs", "params"), "fea2gs")):
        sd = load_pretrained_params(spec, kind, key, net=net)
        if sd is not None:
            load_params(mod, sd)
            logger.info(f"loaded pretrain_network_{net} from {spec}")
    trainer = Trainer(enc, dec, cfg, device=dev)

    ds_opt = next(v for k, v in opt["datasets"].items()
                  if k.startswith("train"))
    seed = opt.get("manual_seed", 0)
    dataset = ContinuousBicubicDataset(
        ds_opt["all_gt_list"], scale_list=ds_opt.get("scale_list", (1, 4)),
        lr_size=ds_opt.get("lr_size", 48),
        use_hflip=ds_opt.get("use_hflip", True),
        use_rot=ds_opt.get("use_rot", True),
        round_mode=ds_opt.get("round_mode", "ceil"),
        clamp_scale_to_image=ds_opt.get("clamp_scale_to_image", False),
        sample_size=ds_opt.get("sample_size", 0), seed=seed)
    batch_size = ds_opt.get("batch_size_per_gpu", 16)

    ckpt_dir = f"{exp_dir}/checkpoints"
    start_iter = 0
    if args.auto_resume:
        step = latest_step(ckpt_dir)
        if step is not None:
            restore_checkpoint(ckpt_dir, step, trainer)
            start_iter = int(step)
            logger.info(f"resumed from iter {start_iter}")

    total = cfg.total_iter
    log_opt = opt.get("logger", {}) or {}
    save_freq = log_opt.get("save_checkpoint_freq", 5000)
    print_freq = log_opt.get("print_freq", 100)
    val_opt = next((v for k, v in opt.get("datasets", {}).items()
                    if k.startswith("val")), None)
    val_freq = opt.get("val", {}).get("val_freq", 10000)
    tb_dir = (f"{exp_dir}/tb_logger"
              if log_opt.get("use_tb_logger", True) else None)
    # wandb before the tb writer: sync_tensorboard patches only writers
    # made after wandb.init (reference logger.py:126-131)
    init_wandb_logger(opt)
    msg_logger = MessageLogger(total, start_iter, tb_dir=tb_dir)
    history = MetricHistory()
    logged, data_s, iter_s = {}, [], []

    def run_validation(it):
        results = _validate(trainer, val_opt, opt, dev)
        ds_name = val_opt.get("name", "val")
        improved = history.update(ds_name, it, results)
        msg_logger.log_validation(it, ds_name, results, best=history)
        return improved

    it = start_iter
    epoch = 0
    num_workers = ds_opt.get("num_worker_per_gpu", 4)
    data_timer = AvgTimer()
    iter_timer = AvgTimer()
    while it < total:
        # threaded sample assembly and the device copy overlap the running
        # step (reference prefetch_dataloader.py:61-123)
        prefetcher = DevicePrefetcher(
            batch_iterator(dataset, batch_size, epoch=epoch, seed=seed,
                           enlarge_ratio=ds_opt.get("dataset_enlarge_ratio",
                                                    1),
                           num_workers=num_workers), device=dev)
        batches = iter(prefetcher)
        start = it
        while True:
            data_timer.start()
            t0 = time.perf_counter()
            batch = next(batches, None)
            data_timer.record()
            t1 = time.perf_counter()
            if batch is None:
                break
            iter_timer.start()
            metrics = trainer.step(batch)
            it += 1
            if it % print_freq == 0:
                scalars = {k: float(v) for k, v in metrics.items()
                           if k != "lr"}
                iter_timer.record()
                logged[it] = dict(scalars)
                scalars["data_time"] = data_timer.get_avg_time()
                msg_logger(it, epoch, float(metrics["lr"]), scalars,
                           iter_time=iter_timer.get_avg_time())
            else:
                iter_timer.record()
            data_s.append(t1 - t0)
            iter_s.append(time.perf_counter() - t0)
            if it % save_freq == 0:
                save_checkpoint(ckpt_dir, it, trainer)
            if val_opt is not None and it % val_freq == 0:
                if run_validation(it):
                    # keep the best-metric step past `keep`
                    # (base_model.py:50-73 best tracking)
                    save_checkpoint(ckpt_dir, it, trainer)
                    mark_best(ckpt_dir, it)
            if it >= total:
                prefetcher.close()
                break
        if it == start:
            raise SystemExit(f"the training set ({len(dataset)} images) "
                             f"gives no batch of {batch_size}")
        epoch += 1

    save_checkpoint(ckpt_dir, it, trainer)
    logger.info("training done")
    return dict(trainer=trainer, iter=it, logged=logged, data_s=data_s,
                iter_s=iter_s, history=history, ckpt_dir=ckpt_dir)


if __name__ == "__main__":
    main()
