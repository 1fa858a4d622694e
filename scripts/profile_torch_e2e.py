#!/usr/bin/env python3
"""Where the time of one gsasr_torch image or training step goes, on one
CUDA card.

  python3 scripts/profile_torch_e2e.py [--encoder edsr|swinir|rdn]
                                       [--enhanced [--fp32-trunk] |
                                        --train [--fused]]
                                       [--iters 3] [--json PATH]

Builds the paper EDSR-GSASR (--encoder swinir or rdn: SwinIR- or
RDN-GSASR; with --enhanced the Enhanced EDSR-GSASR, whose decoder trunk
runs in bf16, or in fp32 with --fp32-trunk) with seeded weights, warms up,
then traces with torch.profiler either `sr_forward` on a 180x180 x4 image
(padded to the encoder's denominator: 192x192 for SwinIR) or, with
--train, `Trainer.step` of configs/train_<encoder>_paper.yml's recipe on
chip_smoke.py's synthetic batch of 16 samples of 48x48 (with --fused, on
the fused decoder: fused_decoder=True). Prints the device
time per image (or step) grouped by kernel family (the port's kernels,
cuDNN convolutions, cuBLAS products, PyTorch's ReLU, foreach updates,
index gathers and scatters, the rest), the top kernels by device time, and
the device busy share: the summed kernel time over the host-clock time of
the traced iterations (one stream, so kernels do not overlap). With
--train it also prints the host time of the gradient and update halves of
the step. The card's name and power limit head the output. --json PATH
also writes the same there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FAMILIES = (
    ("R raster_fwd", ("raster_fwd_kernel",)),
    ("RB raster_bwd", ("raster_bwd_kernel",)),
    # the masked forms (WM, WMB) are instantiations with kMask = true
    ("WM window_attn_fwd masked", ("window_attn_fwd_kernel<true>",)),
    ("W window_attn_fwd", ("window_attn_fwd_kernel",)),
    ("WMB window_attn_bwd masked", ("window_attn_bwd_kernel<false, true>",)),
    # AB runs WB's device code for its attention backward
    ("WB window_attn_bwd, AB attention", ("window_attn_bwd_kernel",
                                          "dbias_sum_kernel")),
    ("M ln_mlp", ("ln_mlp_kernel",)),
    ("A ln_attn heads", ("attn_heads_kernel",)),
    ("A ln_attn out-proj", ("out_proj_kernel",)),
    ("MB, AB tile products", ("linear_rows_kernel",)),
    ("MB, AB weight gradients", ("wgrad_partial_kernel",
                                 "wgrad_reduce_kernel")),
    ("MB, AB LN rows and ordered sums", ("ln_rows_kernel",
                                         "ln_bwd_rows_kernel",
                                         "sum_terms_kernel")),
    ("T bias_table_bwd", ("bias_table_bwd_kernel",)),
    # before the products: cuDNN's implicit-GEMM kernels also say "gemm"
    ("cuDNN convolutions", ("fprop", "conv", "cudnn", "winograd")),
    ("cuBLAS products", ("gemm", "gemv", "cutlass")),
    ("ReLU (clamp)", ("clamp",)),
    ("foreach (Adam, EMA, zeros)", ("foreach", "multi_tensor")),
    ("index gather/scatter", ("index", "scatter", "gather")),
)


def _family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other (elementwise, copies, reductions)"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", action="store_true",
                    help="trace Trainer.step instead of sr_forward")
    ap.add_argument("--fused", action="store_true",
                    help="with --train: the fused decoder")
    ap.add_argument("--encoder", default="edsr",
                    choices=("edsr", "swinir", "rdn"),
                    help="the paper GSASR of this encoder")
    ap.add_argument("--enhanced", action="store_true",
                    help="trace sr_forward of the Enhanced EDSR-GSASR")
    ap.add_argument("--fp32-trunk", action="store_true",
                    help="with --enhanced: the decoder trunk in fp32")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--json", help="write the results to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_e2e: no CUDA card", file=sys.stderr)
        return 2
    from gsasr_torch.model import DENOMINATORS, make_models, sr_forward

    if args.enhanced and (args.train or args.encoder != "edsr"):
        ap.error("--enhanced traces EDSR inference only")
    trunk = torch.float32 if args.fp32_trunk else None
    enc, dec = make_models(args.encoder,
                           "enhanced" if args.enhanced else "paper",
                           generator=torch.Generator().manual_seed(0))
    if args.train:
        from chip_smoke import PAPER_BATCH, PAPER_TRAIN, paper_batch
        from gsasr_torch.train import TrainConfig, Trainer

        tr = Trainer(enc, dec, TrainConfig(**dict(
            PAPER_TRAIN, fused_decoder=args.fused)))
        batches = [paper_batch(PAPER_BATCH, seed=20 + i)
                   for i in range(args.iters + 2)]

        def run(i):
            with record_function("grads"):
                out = tr.grads(batches[i])
            with record_function("optimizer+EMA"):
                tr.apply(*out)
    else:
        lq = torch.rand(1, 180, 180, 3,
                        generator=torch.Generator().manual_seed(4)).cuda()

        def run(i):
            sr_forward(enc, dec, lq, 4.0, trunk_dtype=trunk,
                       denominator=DENOMINATORS[args.encoder])
    for i in range(2):
        run(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.iters):
            run(2 + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: record_function ranges (ours, and Optimizer.step's)
    # also carry device time, the span of the kernels inside them
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
    ranges = {}
    for e in events:
        if getattr(e, "is_user_annotation", False) and \
                e.device_type == torch.autograd.DeviceType.CPU:
            ranges[e.key] = e.cpu_time_total / 1e3 / args.iters
    fam_ms: dict = {}
    for e in kernels:
        f = _family(e.key)
        fam_ms[f] = fam_ms.get(f, 0.0) + e.self_device_time_total / 1e3
    busy_ms = sum(fam_ms.values())
    per = args.iters
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    unit = "step" if args.train else "image"
    res = dict(
        card=card, iters=per, unit=unit,
        encoder=args.encoder,
        decoder=("paper" if not args.enhanced else "Enhanced, fp32 trunk"
                 if args.fp32_trunk else "Enhanced, bf16 trunk"),
        wall_ms_per_image=wall_ms / per,
        device_busy_ms_per_image=busy_ms / per,
        device_busy_share=busy_ms / wall_ms,
        families_ms_per_image={k: v / per for k, v in sorted(
            fam_ms.items(), key=lambda kv: -kv[1])},
        host_ranges_ms=ranges,
        top_kernels=[dict(name=e.key[:120], calls_per_image=e.count / per,
                          ms_per_image=e.self_device_time_total / 1e3 / per)
                     for e in top])
    print(f"{res['card']}, {res['encoder']}, {res['decoder']}: "
          f"{res['wall_ms_per_image']:.3f} ms per {unit} "
          f"(profiled), device busy {res['device_busy_ms_per_image']:.3f} ms "
          f"= {100 * res['device_busy_share']:.1f}%")
    for k, v in res["host_ranges_ms"].items():
        print(f"  host {k}: {v:.3f} ms per step")
    for k, v in res["families_ms_per_image"].items():
        print(f"  {v:9.3f} ms  {k}")
    print(f"top kernels (ms per {unit}, calls per {unit}):")
    for t in res["top_kernels"]:
        print(f"  {t['ms_per_image']:9.3f}  {t['calls_per_image']:6.1f}  "
              f"{t['name']}")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
