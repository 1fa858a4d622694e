"""Benchmark evaluation CLI (counterpart of `gsasr_tpu/cli/test.py`, the
reference's `basicsr/test.py` + `GSASRModel.nondist_validation`,
`gsasr_model.py:433-504`), on the CUDA card unless --device cpu is given.

Usage:
  python -m gsasr_torch.cli.test --gt <GT folder> --lq <LR folder> \\
      --scale 4 [--enc_ckpt net_g.pth --dec_ckpt net_fea2gs.pth | \\
      --ckpt_dir DIR] [--tile_size 480 --tile_overlap 8 --crop_size 4] \\
      [--save_sr out/] [--lpips_weights lpips.pth [--lpips_net vgg]] \\
      [--dists_weights dists.pth] [--device cuda|cpu]

Protocol: PSNR/SSIM on the Y channel, crop_border = scale if <= 8 else 8
(`README.md:349-355`). LPIPS and DISTS follow the reference protocol
(`inference_paper_benchmark.py:127-156`, `basicsr/metrics/lpips.py`):
pass --lpips_weights / --dists_weights (official .pth files, which the
repository does not hold; loaded with `torch.load(weights_only=True)`) to
enable them; without weights the metric is skipped. Each image's time
ends when its output is on the host; the first two are left out of the
average. The peak device memory is `torch.cuda.max_memory_allocated` over
the run (n/a on the CPU). Images are PNG only (`utils/png.py`).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    """Run the CLI on `argv` (default: the command line). Returns the
    per-image rows (name, psnr, ssim, seconds, and lpips / dists where
    enabled) and the summary line."""
    p = argparse.ArgumentParser()
    p.add_argument("--gt", required=True)
    p.add_argument("--lq", required=True)
    p.add_argument("--scale", type=float, default=4.0)
    p.add_argument("--model", default="EDSR",
                   choices=["EDSR", "RDN", "SWIN", "HATL"])
    p.add_argument("--version", default="paper",
                   choices=["paper", "enhanced", "ultra"])
    p.add_argument("--AMP_test", "--bf16", dest="bf16", action="store_true")
    p.add_argument("--enc_ckpt", default=None)
    p.add_argument("--dec_ckpt", default=None)
    p.add_argument("--ckpt_dir", default=None,
                   help="a step directory (cli/train.py, cli/convert.py) "
                        "holding net_g + net_fea2gs")
    p.add_argument("--param_key", default="params_ema",
                   choices=["params", "params_ema"],
                   help="reference param_key_g semantics: eval uses "
                        "params_ema by default")
    p.add_argument("--dmax", type=float, default=0.1)
    p.add_argument("--tile_size", type=int, default=0,
                   help="0 disables tiling")
    p.add_argument("--tile_overlap", type=int, default=8)
    p.add_argument("--crop_size", type=int, default=4)
    p.add_argument("--save_sr", default=None)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--lpips_weights", default=None,
                   help="official LPIPS (alex) weights .pth; enables LPIPS")
    p.add_argument("--lpips_net", default="alex",
                   choices=["alex", "vgg"])
    p.add_argument("--dists_weights", default=None,
                   help="official DISTS weights.pt (+VGG16); enables DISTS")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")
    args = p.parse_args(argv)

    from gsasr_torch.cli.infer import build_models
    from gsasr_torch.data.datasets import PairedImageDataset
    from gsasr_torch.metrics import (calculate_psnr, calculate_ssim,
                                     crop_border_for_scale)
    from gsasr_torch.metrics_perceptual import (calculate_dists,
                                                calculate_lpips, load_dists,
                                                load_lpips)
    from gsasr_torch.model import sr_forward
    from gsasr_torch.tiling import split_and_joint_image
    from gsasr_torch.utils.checkpoint import (load_eval_params,
                                              load_torch_checkpoint)
    from gsasr_torch.utils.convert import load_params
    from gsasr_torch.utils.png import write_png

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card is available; pass --device cpu to "
                         "run the plain PyTorch path")
    if (args.enc_ckpt is None) != (args.dec_ckpt is None):
        raise SystemExit("give both --enc_ckpt and --dec_ckpt, or neither")
    if args.ckpt_dir and args.enc_ckpt:
        raise SystemExit("give --ckpt_dir or --enc_ckpt/--dec_ckpt, not both")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    enc, dec, enc_kind, dec_kind, denom = build_models(
        args.model, args.version, args.bf16, device=dev)
    if args.tile_size and args.tile_size % denom:
        raise SystemExit(f"--tile_size {args.tile_size} is not a multiple "
                         f"of the denominator {denom}")
    if args.ckpt_dir:
        for mod, sd in zip((enc, dec),
                           load_eval_params(args.ckpt_dir, args.param_key)):
            load_params(mod, sd)
    elif args.enc_ckpt:
        load_params(enc, load_torch_checkpoint(args.enc_ckpt, enc_kind,
                                               args.param_key))
        load_params(dec, load_torch_checkpoint(args.dec_ckpt, dec_kind,
                                               args.param_key))
    else:
        print("WARNING: no checkpoint given; seeded init (smoke mode)")

    ds = PairedImageDataset(args.gt, args.lq, args.scale)
    n = len(ds) if not args.limit else min(args.limit, len(ds))
    crop = crop_border_for_scale(args.scale)

    lpips_model = dists_model = None
    if args.lpips_weights:
        lpips_model = load_lpips(
            torch.load(args.lpips_weights, map_location="cpu",
                       weights_only=True), args.lpips_net, dev)
    if args.dists_weights:
        try:
            dists_model = load_dists(
                torch.load(args.dists_weights, map_location="cpu",
                           weights_only=True), dev)
        except RuntimeError as e:
            raise SystemExit(
                "--dists_weights must contain the VGG16 backbone convs as "
                "well as alpha/beta (merge torchvision vgg16 features into "
                f"the DISTS weights.pt state dict): {e}") from None

    rows = []
    for i in range(n):
        item = ds[i]
        lq = item["lq"][None]
        gt = item["gt"]
        h, w = lq.shape[1:3]
        want = (gt.shape[0], gt.shape[1])

        t0 = time.perf_counter()
        if args.tile_size and min(h, w) > args.tile_size:
            canvas = split_and_joint_image(
                lq, args.scale, args.tile_size, args.tile_overlap, enc, dec,
                crop_size=args.crop_size, if_dmax=True, dmax=args.dmax,
                device=dev)
            sr = canvas[0, :want[0], :want[1]]
        else:
            sr = sr_forward(enc, dec, lq, args.scale, sr_size=want,
                            denominator=denom, dmax=args.dmax,
                            device=dev).cpu().numpy()[0]
        row = dict(name=os.path.basename(item["gt_path"]),
                   seconds=time.perf_counter() - t0)

        sr255 = np.clip(sr, 0, 1) * 255.0
        gt255 = gt * 255.0
        row["psnr"] = calculate_psnr(sr255, gt255, crop, test_y_channel=True,
                                     channel_order="rgb")
        row["ssim"] = calculate_ssim(sr255, gt255, crop, test_y_channel=True,
                                     channel_order="rgb")
        extra = ""
        if lpips_model is not None:
            # calculate_lpips expects BGR-ordered inputs (reference
            # `lpips.py:11-63` reads images via cv2).
            row["lpips"] = calculate_lpips(
                sr255[..., ::-1], gt255[..., ::-1], crop, lpips_model,
                net=args.lpips_net)
            extra += f" lpips {row['lpips']:.4f}"
        if dists_model is not None:
            row["dists"] = calculate_dists(
                sr255[..., ::-1], gt255[..., ::-1], crop, dists_model)
            extra += f" dists {row['dists']:.4f}"
        rows.append(row)
        print(f"[{i+1}/{n}] {row['name']} psnr {row['psnr']:.3f} "
              f"ssim {row['ssim']:.4f} {row['seconds']*1e3:.0f} ms{extra}",
              flush=True)

        if args.save_sr:
            os.makedirs(args.save_sr, exist_ok=True)
            write_png(os.path.join(args.save_sr, row["name"]),
                      (np.clip(sr, 0, 1) * 255).round().astype(np.uint8))

    # protocol: discard the first 2 timings (inference_paper_benchmark:169)
    times = [r["seconds"] for r in rows]
    avg_t = float(np.mean(times[2:])) if len(times) > 2 else float(
        np.mean(times))
    mean = lambda key: np.mean([r[key] for r in rows])  # noqa: E731
    summary = (f"AVG psnr {mean('psnr'):.4f} ssim {mean('ssim'):.5f} "
               f"time {avg_t*1e3:.1f} ms over {n} images")
    if lpips_model is not None:
        summary += f" lpips {mean('lpips'):.4f}"
    if dists_model is not None:
        summary += f" dists {mean('dists'):.4f}"
    # peak device memory (reference protocol reports max_memory_allocated,
    # `inference_paper_benchmark.py:127-156`)
    summary += (f" peak_mem {torch.cuda.max_memory_allocated(dev) / 2**20:.0f}"
                " MiB" if dev.type == "cuda" else " peak_mem n/a")
    print(summary)
    return dict(rows=rows, summary=summary)


if __name__ == "__main__":
    main()
