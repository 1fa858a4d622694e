"""Single-image inference CLI (counterpart of `gsasr_tpu/cli/infer.py`,
the reference's `inference_paper.py` and `inference_enhenced.py`, chosen
by --version), on the CUDA card unless --device cpu is given.

Usage:
  python -m gsasr_torch.cli.infer --input_img_path in.png --scale 4 \\
      --save_sr_path out/ [--model EDSR|RDN|SWIN|HATL] \\
      [--version paper|enhanced|ultra] [--bf16] \\
      [--enc_ckpt net_g.pth --dec_ckpt net_fea2gs.pth | --ckpt_dir DIR] \\
      [--tile_process --tile_size 480 --tile_overlap 8 --crop_size 4] \\
      [--device cuda|cpu]

Loads reference-format .pth checkpoints, or a step directory of the port's
training-state format (`--ckpt_dir`, the counterpart of JAX's
`--orbax_ckpt`: a step that `cli/train.py` saved or `cli/convert.py`
wrote), under --param_key (default params_ema); otherwise runs with seeded
weights (smoke mode). Reads and writes PNG only (`utils/png.py`: the
card's machine has neither OpenCV nor PIL); the output is named as JAX
names it.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

# CLI model name -> encoder key (and checkpoint converter kind)
MODEL_ENCODERS = {"EDSR": "edsr", "RDN": "rdn", "SWIN": "swinir",
                  "HATL": "hat"}


def build_models(model: str, version: str, bf16: bool = False, *,
                 device=None):
    """(enc, dec, enc_kind, dec_kind, denominator) on `device`, with
    make_models' seeded weights."""
    from gsasr_torch.model import DENOMINATORS, make_models

    encoder = MODEL_ENCODERS[model]
    if model == "HATL" and version == "paper":
        raise SystemExit("HATL ships only as Enhanced/Ultra")
    dtype = torch.bfloat16 if bf16 else torch.float32
    enc, dec = make_models(encoder, version, dtype=dtype, device=device)
    dec_kind = "fea2gs" if version == "paper" else "fea2gs_rope"
    # Enhanced family denominators: 12 EDSR/RDN, 16 SWIN/HATL
    # (`inference_enhenced.py:219-222`); paper: 12/24
    # (`inference_paper.py:170`)
    if version == "paper":
        denom = DENOMINATORS[encoder]
    else:
        denom = 12 if model in ("EDSR", "RDN") else 16
    return enc, dec, encoder, dec_kind, denom


def main(argv=None) -> str:
    """Run the CLI on `argv` (default: the command line); returns the path
    of the written PNG."""
    p = argparse.ArgumentParser()
    p.add_argument("--input_img_path", required=True, help="a PNG file")
    p.add_argument("--save_sr_path", default="./output")
    p.add_argument("--scale", type=float, default=4.0)
    p.add_argument("--model", default="EDSR",
                   choices=sorted(MODEL_ENCODERS))
    p.add_argument("--version", default="paper",
                   choices=["paper", "enhanced", "ultra"])
    p.add_argument("--AMP_test", "--bf16", dest="bf16",
                   action="store_true",
                   help="bf16 inference (`inference_enhenced.py:212`)")
    p.add_argument("--enc_ckpt", default=None)
    p.add_argument("--dec_ckpt", default=None)
    p.add_argument("--ckpt_dir", default=None,
                   help="a step directory (cli/train.py, cli/convert.py)")
    p.add_argument("--param_key", default="params_ema",
                   choices=["params", "params_ema"])
    p.add_argument("--denominator", type=int, default=None)
    p.add_argument("--suffix", default="GSASR_tpu",
                   help="output name suffix (JAX's default)")
    p.add_argument("--tile_process", action="store_true")
    p.add_argument("--tile_size", type=int, default=480)
    p.add_argument("--tile_overlap", type=int, default=8)
    p.add_argument("--crop_size", type=int, default=4)
    p.add_argument("--dmax", type=float, default=0.1)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")
    args = p.parse_args(argv)

    from gsasr_torch.model import sr_forward
    from gsasr_torch.tiling import split_and_joint_image
    from gsasr_torch.utils.checkpoint import (load_eval_params,
                                              load_torch_checkpoint)
    from gsasr_torch.utils.convert import load_params
    from gsasr_torch.utils.png import read_png, write_png

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card is available; pass --device cpu to "
                         "run the plain PyTorch path")
    if (args.enc_ckpt is None) != (args.dec_ckpt is None):
        raise SystemExit("give both --enc_ckpt and --dec_ckpt, or neither")
    if args.ckpt_dir and args.enc_ckpt:
        raise SystemExit("give --ckpt_dir or --enc_ckpt/--dec_ckpt, not both")
    enc, dec, enc_kind, dec_kind, denom = build_models(
        args.model, args.version, args.bf16, device=dev)
    denom = args.denominator or denom
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

    try:
        img = read_png(args.input_img_path)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    lq = img.astype(np.float32)[None] / 255.0
    h, w = lq.shape[1:3]
    gt_size = (math.floor(args.scale * h), math.floor(args.scale * w))

    if args.tile_process:
        if args.tile_size % denom:
            raise SystemExit(f"--tile_size {args.tile_size} is not a "
                             f"multiple of the denominator {denom}")
        canvas = split_and_joint_image(
            lq, args.scale, args.tile_size, args.tile_overlap, enc, dec,
            crop_size=args.crop_size, if_dmax=True, dmax=args.dmax,
            device=dev)
        out = canvas[:, :gt_size[0], :gt_size[1]]
    else:
        out = sr_forward(enc, dec, lq, args.scale, denominator=denom,
                         dmax=args.dmax, device=dev).cpu().numpy()

    sr = np.clip(out[0], 0, 1)
    os.makedirs(args.save_sr_path, exist_ok=True)
    name, ext = os.path.splitext(os.path.basename(args.input_img_path))
    out_path = os.path.join(
        args.save_sr_path,
        f"{name}_{args.suffix}_{args.model}_{args.scale}{ext}")
    write_png(out_path, (sr * 255).round().astype(np.uint8))
    print(f"Saved SR image to {out_path}")
    return out_path


if __name__ == "__main__":
    main()
