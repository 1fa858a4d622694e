"""Metric CLI (counterpart of `gsasr_tpu/cli/metrics.py`, the reference's
`scripts/metrics/`: `calculate_psnr_ssim.py`, `calculate_niqe.py`,
`calculate_fid_stats_from_datasets.py`, `calculate_fid_folder.py`; the
lpips and dists choices only check for their optional packages, as the JAX
CLI's do: `cli/test.py` scores LPIPS and DISTS).

Usage:
  python -m gsasr_torch.cli.metrics --gt GT/ --restored SR/ --scale 4 \\
      [--test_y_channel] [--suffix _x4]
  python -m gsasr_torch.cli.metrics --metric niqe --restored SR/ [--crop 0]
  python -m gsasr_torch.cli.metrics --metric fid-stats --restored IMGS/ \\
      --inception_params inception.pt --out stats.npz [--device cuda|cpu]
  python -m gsasr_torch.cli.metrics --metric fid --restored SR/ \\
      --inception_params inception.pt --fid_stats stats.npz

Images are PNG only (`utils/png.py`, read as RGB). NIQE, PSNR and SSIM are
host numpy; the FID network runs on the card unless --device cpu is
given, in float32 with TF32 off.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _read(folder, name) -> np.ndarray:
    from gsasr_torch.utils.png import read_png
    return read_png(os.path.join(folder, name))


def _niqe_folder(args):
    from gsasr_torch.metrics_niqe import calculate_niqe

    scores = []
    names = sorted(os.listdir(args.restored))
    for i, name in enumerate(names):
        s = calculate_niqe(_read(args.restored, name), int(args.crop),
                           convert_to="y", channel_order="rgb")
        print(f"{i + 1:3d}: {os.path.splitext(name)[0]:25}\tNIQE: {s:.6f}")
        scores.append(s)
    print(f"Average: NIQE: {np.mean(scores):.6f} ({len(scores)} images)")
    return scores


def _inception_feature_fn(params_path, device):
    """Feature extractor from a user-supplied InceptionV3-FID TorchScript
    file (the pytorch-fid artifact), loaded onto `device`. The reference's
    own FID path is broken as shipped: `basicsr/metrics/fid.py:7` imports
    `basicsr.archs.inception`, which does not exist in its repository. No
    weights are in this repository."""
    if not params_path or not os.path.exists(params_path):
        raise SystemExit(
            "FID needs a pretrained InceptionV3-FID network; pass "
            "--inception_params PATH to a TorchScript file "
            "(e.g. pytorch-fid's pt_inception-2015-12-05 export)")
    import torch

    from gsasr_torch.metrics_perceptual import fp32_math
    mod = torch.jit.load(params_path, map_location=device).eval()

    def feature_fn(img_hwc01):
        x = torch.from_numpy(
            np.ascontiguousarray(img_hwc01, dtype=np.float32))
        x = x.permute(2, 0, 1)[None].to(device)
        with torch.no_grad(), fp32_math():
            out = mod(x)
        out = out[0] if isinstance(out, (tuple, list)) else out
        return out.reshape(-1).cpu().numpy()

    return feature_fn


def _folder_stats(args, device):
    from gsasr_torch.metrics_perceptual import (compute_feature_stats,
                                                extract_features)

    feature_fn = _inception_feature_fn(args.inception_params, device)
    names = sorted(os.listdir(args.restored))
    imgs = (_read(args.restored, n) / 255.0 for n in names)
    return len(names), compute_feature_stats(
        extract_features(imgs, feature_fn))


def _fid_stats(args, device):
    n, (mu, sigma) = _folder_stats(args, device)
    np.savez(args.out, mean=mu, cov=sigma)
    print(f"wrote stats for {n} images to {args.out}")
    return mu, sigma


def _fid_folder(args, device):
    from gsasr_torch.metrics_perceptual import calculate_fid

    n, (mu, sigma) = _folder_stats(args, device)
    stats = np.load(args.fid_stats)
    fid = calculate_fid(mu, sigma, stats["mean"], stats["cov"])
    print(f"FID: {fid:.6f} ({n} images)")
    return fid


def main(argv=None):
    """Run the CLI on `argv` (default: the command line). Returns the
    metric's values: NIQE's scores, (mu, sigma), the FID, or PSNR's and
    SSIM's lists."""
    p = argparse.ArgumentParser()
    p.add_argument("--gt")
    p.add_argument("--restored", required=True)
    p.add_argument("--scale", type=float, default=4)
    p.add_argument("--suffix", default="")
    p.add_argument("--test_y_channel", action="store_true")
    p.add_argument("--crop", type=float, default=0,
                   help="crop border (niqe)")
    p.add_argument("--inception_params", default=None)
    p.add_argument("--fid_stats", default=None)
    p.add_argument("--out", default="fid_stats.npz")
    p.add_argument("--metric", default="psnr_ssim",
                   choices=["psnr_ssim", "lpips", "dists", "niqe",
                            "fid-stats", "fid"])
    p.add_argument("--device", default="cuda",
                   help="the FID network's device: cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.metric == "niqe":
        return _niqe_folder(args)
    if args.metric in ("fid-stats", "fid"):
        import torch
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise SystemExit("no CUDA card is available; pass --device cpu "
                             "to run the FID network on the CPU")
        return (_fid_stats if args.metric == "fid-stats" else _fid_folder)(
            args, device)
    if args.gt is None:
        raise SystemExit("--gt is required for paired metrics")

    from gsasr_torch.metrics import (calculate_psnr, calculate_ssim,
                                     crop_border_for_scale)

    crop = crop_border_for_scale(args.scale)
    names = sorted(os.listdir(args.gt))

    if args.metric in ("lpips", "dists"):
        pkg = "lpips" if args.metric == "lpips" else "DISTS_pytorch"
        try:
            __import__(pkg)
        except ImportError:
            raise SystemExit(
                f"{args.metric} requires the optional '{pkg}' package, "
                "which is not installed in this environment")

    psnrs, ssims = [], []
    for name in names:
        base, ext = os.path.splitext(name)
        rest_path = os.path.join(args.restored, base + args.suffix + ext)
        if not os.path.exists(rest_path):
            rest_path = os.path.join(args.restored, name)
        gt = _read(args.gt, name).astype(np.float64)
        sr = _read(*os.path.split(rest_path)).astype(np.float64)
        psnrs.append(calculate_psnr(sr, gt, crop,
                                    test_y_channel=args.test_y_channel,
                                    channel_order="rgb"))
        ssims.append(calculate_ssim(sr, gt, crop,
                                    test_y_channel=args.test_y_channel,
                                    channel_order="rgb"))
        print(f"{name}: psnr {psnrs[-1]:.4f} ssim {ssims[-1]:.5f}")

    print(f"Average: psnr {np.mean(psnrs):.4f} ssim {np.mean(ssims):.5f} "
          f"({len(names)} images, crop {crop}, "
          f"y={args.test_y_channel})")
    return psnrs, ssims


if __name__ == "__main__":
    main()
