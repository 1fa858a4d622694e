#!/usr/bin/env python3
"""Where the time of one gsasr_torch image or training step goes, on one
CUDA card.

  python3 scripts/profile_torch_e2e.py
      [--encoder edsr|swinir|rdn|hat|hat_paper]
      [--enhanced [--fp32-trunk] | --train [--fused] [--enhanced]]
      [--iters 3] [--json PATH]

Builds the paper EDSR-GSASR (--encoder swinir or rdn: SwinIR- or
RDN-GSASR; --encoder hat: the HAT-L Ultra model, padded to 16, or with
--train the Ultra step at configs/train_hatl_ultra.yml's bf16 recipe, 8
samples of 64x64 at scales in [1, 16] on the 1024x1024 canvas; with
--enhanced the Enhanced EDSR-GSASR, whose decoder trunk runs in bf16, or in
fp32 with --fp32-trunk; --encoder hat_paper: the paper HAT, network_g
type HATNOUP, with the paper Fea2GS, padded to 48, or with --train its
step at the paper recipe; --encoder swinir --enhanced --train: SwinIR's
step at configs/train_swinir_amp.yml's bf16 recipe; --fused with either
window-16 step, HAT-L Ultra's or SwinIR's, takes its fused decoder: M, A-long,
MB and AB-long) with seeded weights, warms up,
then traces with torch.profiler either `sr_forward` on a 180x180 x4 image
(padded to the encoder's denominator: 192x192 for SwinIR) or, with
--train, `Trainer.step` of configs/train_<encoder>_paper.yml's recipe on
chip_smoke.py's synthetic batch of 16 samples of 48x48 (with --fused, on
the fused decoder: fused_decoder=True; with --enhanced, the Enhanced
EDSR-GSASR at configs/train_edsr_amp.yml's bf16 recipe on its module
decoder, or with --fused too on its fused decoder, the networks as
chip_smoke.enhanced_networks builds them). Prints
the device
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
    # AB-bf16's and AB-long-bf16's attention backward: WB-bf16's and
    # WB-long-bf16's bodies in their AB form (TO = float), before the WB
    # forms' names match them
    ("AB-bf16 attention (WB-bf16's body, AB form)",
     ("window_attn_bwd_short_mma_kernel<false, false, 4, float",
      "window_attn_bwd_short_mma_kernel<false, false, 9, float",
      "window_attn_bwd_short_mma_kernel<false, false, 10, float")),
    ("AB-long-bf16 attention (WB-long-bf16's launches, AB form)",
     ("window_attn_bwd_long_mma_q_kernel<false, false, float",
      "window_attn_bwd_long_mma_kv_kernel<false, false, float")),
    # the bf16 window-16 forms on the tensor cores: W-long-bf16 (with its
    # flags WM-long-bf16, W4-long-bf16, and A-long-bf16's attention) and
    # WB-long-bf16's two launches (WMB-long-bf16, WB4-long-bf16)
    ("W-long-bf16 window_attn_fwd long mma",
     ("window_attn_fwd_long_mma_kernel",)),
    ("WB-long-bf16 window_attn_bwd long mma dq",
     ("window_attn_bwd_long_mma_q_kernel",)),
    ("WB-long-bf16 window_attn_bwd long mma dk/dv",
     ("window_attn_bwd_long_mma_kv_kernel",)),
    # the masked forms of the fp32 3xTF32 bodies (the paper HAT's shifted
    # windows; SwinIR's WMB), instantiations with kMask of their own, before
    # the unmasked forms' names match them
    ("WM-long window_attn_fwd long tf32 masked",
     ("window_attn_fwd_long_tf32_kernel<true",)),
    ("WMB-long window_attn_bwd long tf32 masked",
     ("window_attn_bwd_long_tf32_q_kernel<true",
      "window_attn_bwd_long_tf32_kv_kernel<true")),
    ("WMB window_attn_bwd short tf32 masked",
     ("window_attn_bwd_short_tf32_kernel<true",)),
    # the fp32 3xTF32 forward: W-long (W4-long), and A-long's fp32
    # attention launch, the same kernel; up to 160 tokens W (W4), WM, and
    # A's fp32 attention (AB's att) on the short body; their projections
    # below
    ("W-long window_attn_fwd long tf32, A-long fp32 attention",
     ("window_attn_fwd_long_tf32_kernel",)),
    ("WM window_attn_fwd short tf32 masked",
     ("window_attn_fwd_short_tf32_kernel<true",)),
    ("W window_attn_fwd short tf32, A fp32 attention",
     ("window_attn_fwd_short_tf32_kernel",)),
    # WB-long (and WB4-long): the 3xTF32 body's dq / row-statistics and
    # dk / dv launches; WB (and WB4) up to 160 tokens: its one launch; AB's
    # and AB-long's fp32 attention runs the same kernels
    ("WB-long window_attn_bwd long tf32 (and AB-long's fp32 attention)",
     ("window_attn_bwd_long_tf32",)),
    ("WB window_attn_bwd short tf32 (and AB's fp32 attention)",
     ("window_attn_bwd_short_tf32",)),
    # AB's recompute: A's projections with the backward's extra outputs
    ("AB, AB-long recompute (q/k/v, xq, q0, k0)",
     ("ln_qkv_kernel<float, true", "ln_qkv_kernel<__nv_bfloat16, true")),
    # A's and A-long's projections on the tensor cores (tile_mma.cuh)
    ("A, A-long q/k/v projections", ("ln_qkv_kernel",)),
    ("A, A-long out-projection", ("out_proj_kernel",)),
    ("RB raster_bwd", ("raster_bwd_kernel",)),
    # the bf16 forms up to 160 tokens on the tensor cores, by their mask
    # flag: W-bf16 (and W4-bf16, and A's bf16 attention) and WM-bf16,
    # WB-bf16 (and WB4-bf16) and WMB-bf16
    ("WM-bf16 window_attn_fwd short mma masked",
     ("window_attn_fwd_short_mma_kernel<true",)),
    ("W-bf16 window_attn_fwd short mma",
     ("window_attn_fwd_short_mma_kernel",)),
    ("WMB-bf16 window_attn_bwd short mma masked",
     ("window_attn_bwd_short_mma_kernel<true",)),
    ("WB-bf16 window_attn_bwd short mma",
     ("window_attn_bwd_short_mma_kernel",)),
    # the sum of ds over the windows: every form's dbias
    ("dbias sums", ("dbias_sum_kernel",)),
    ("M ln_mlp", ("ln_mlp_kernel",)),
    # MB's two row-tile launches and AB's row products with the LN backward
    # (tile_mma_bwd.cuh)
    ("MB row tiles (fc1; g w2, dz1 w1, LN backward)",
     ("ln_fc1_kernel", "ln_mlp_bwd_kernel")),
    ("AB row products (g wo; dxq, dkv with the LN backward)",
     ("rows_bwd_kernel",)),
    ("MB, AB weight gradients", ("wgrad_mma_kernel", "wgrad_sum_kernel")),
    ("MB, AB ordered sums, transposed weights, RoPE back-rotation",
     ("ordered_sum_kernel", "inj_sum_kernel", "wt_kernel",
      "rope_back_kernel")),
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
                    choices=("edsr", "swinir", "rdn", "hat", "hat_paper"),
                    help="the paper GSASR of this encoder (hat: HAT-L "
                    "Ultra, with --train its bf16 recipe; hat_paper: the "
                    "paper HAT)")
    ap.add_argument("--enhanced", action="store_true",
                    help="trace sr_forward of the Enhanced EDSR-GSASR (with "
                    "--train: its step at the bf16 recipe, or SwinIR's with "
                    "--encoder swinir)")
    ap.add_argument("--fp32-trunk", action="store_true",
                    help="with --enhanced: the decoder trunk in fp32")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--json", help="write the results to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_e2e: no CUDA card", file=sys.stderr)
        return 2
    from gsasr_torch.model import DENOMINATORS, make_models, sr_forward

    swinir_amp = args.encoder == "swinir" and args.enhanced
    if args.enhanced and (
            args.encoder not in ("edsr", "swinir")
            or args.fused and not args.train
            or args.train and args.fp32_trunk
            or swinir_amp and not args.train):
        ap.error("--enhanced traces EDSR (its step on the module decoder, "
                 "or with --fused the fused one), or with --encoder swinir "
                 "--train SwinIR's bf16 step (--fused: on the fused "
                 "decoder)")
    ultra = args.encoder == "hat"
    hat_paper = args.encoder == "hat_paper"
    if (ultra or hat_paper) and args.enhanced or hat_paper and args.fused \
            or args.fused and not args.train:
        ap.error("--encoder hat traces HAT-L Ultra (--train: its bf16 "
                 "recipe on the module decoder, --fused on the fused one), "
                 "hat_paper the paper HAT (--train: the paper recipe on the "
                 "module decoder)")
    trunk = torch.float32 if args.fp32_trunk else None
    denominator = DENOMINATORS.get(args.encoder, 48)
    if hat_paper:
        from chip_smoke import hat_paper_networks
        enc, dec = (m.cuda().eval() for m in hat_paper_networks())
    elif args.train and (args.enhanced or ultra):
        from chip_smoke import enhanced_networks
        enc, dec = enhanced_networks(args.encoder)
    else:
        enc, dec = make_models(args.encoder,
                               "ultra" if ultra else
                               "enhanced" if args.enhanced else "paper",
                               generator=torch.Generator().manual_seed(0))
    if args.train:
        from chip_smoke import (ENHANCED_TRAIN, PAPER_BATCH, PAPER_TRAIN,
                                ULTRA_BATCH, ULTRA_TRAIN, paper_batch)
        from gsasr_torch.train import TrainConfig, Trainer

        recipe = (ULTRA_TRAIN if ultra else ENHANCED_TRAIN if args.enhanced
                  else PAPER_TRAIN)
        tr = Trainer(enc, dec, TrainConfig(**dict(recipe,
                                                  fused_decoder=args.fused)))
        batches = [paper_batch(ULTRA_BATCH if ultra else PAPER_BATCH,
                               seed=20 + i, ceil=args.enhanced, ultra=ultra)
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
                       denominator=denominator)
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
    mode = "fused" if args.fused else "module"
    res = dict(
        card=card, iters=per, unit=unit,
        encoder=args.encoder,
        decoder=(f"Ultra, bf16 recipe ({mode})" if ultra and args.train
                 else "Ultra, bf16 trunk" if ultra else "paper"
                 if not args.enhanced else
                 f"Enhanced, SwinIR's bf16 recipe ({mode})" if swinir_amp
                 else "Enhanced, fp32 trunk"
                 if args.fp32_trunk else "Enhanced, bf16 recipe (fused)"
                 if args.train and args.fused else
                 "Enhanced, bf16 recipe (module)" if args.train else
                 "Enhanced, bf16 trunk"),
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
