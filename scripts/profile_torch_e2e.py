#!/usr/bin/env python3
"""Where the time of one gsasr_torch image goes, on one CUDA card.

  python3 scripts/profile_torch_e2e.py [--iters 3] [--json PATH]

Builds the paper EDSR-GSASR with seeded weights, warms up, then traces
`sr_forward` on a 180x180 x4 image with torch.profiler. Prints the device
time per image grouped by kernel family (the port's kernels R, M and A,
cuDNN convolutions, cuBLAS products, PyTorch's ReLU, the rest), the top
kernels by device time, and the device busy share: the summed kernel time
over the host-clock time of the traced iterations (one stream, so kernels
do not overlap). The card's name and power limit head the output.
--json PATH also writes the same there.
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
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FAMILIES = (
    ("R raster_fwd", ("raster_fwd_kernel",)),
    ("M ln_mlp", ("ln_mlp_kernel",)),
    ("A ln_attn heads", ("attn_heads_kernel",)),
    ("A ln_attn out-proj", ("out_proj_kernel",)),
    # before the products: cuDNN's implicit-GEMM kernels also say "gemm"
    ("cuDNN convolutions", ("fprop", "conv", "cudnn", "winograd")),
    ("cuBLAS products", ("gemm", "gemv", "cutlass")),
    ("ReLU (clamp)", ("clamp",)),
)


def _family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other (elementwise, copies, reductions)"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--json", help="write the results to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_e2e: no CUDA card", file=sys.stderr)
        return 2
    from gsasr_torch.model import make_models, sr_forward

    enc, dec = make_models("edsr", "paper",
                           generator=torch.Generator().manual_seed(0))
    lq = torch.rand(1, 180, 180, 3,
                    generator=torch.Generator().manual_seed(4)).cuda()
    for _ in range(2):
        sr_forward(enc, dec, lq, 4.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            sr_forward(enc, dec, lq, 4.0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
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
    res = dict(
        card=card, iters=per,
        wall_ms_per_image=wall_ms / per,
        device_busy_ms_per_image=busy_ms / per,
        device_busy_share=busy_ms / wall_ms,
        families_ms_per_image={k: v / per for k, v in sorted(
            fam_ms.items(), key=lambda kv: -kv[1])},
        top_kernels=[dict(name=e.key[:120], calls_per_image=e.count / per,
                          ms_per_image=e.self_device_time_total / 1e3 / per)
                     for e in top])
    print(f"{res['card']}: {res['wall_ms_per_image']:.3f} ms per image "
          f"(profiled), device busy {res['device_busy_ms_per_image']:.3f} ms "
          f"= {100 * res['device_busy_share']:.1f}%")
    for k, v in res["families_ms_per_image"].items():
        print(f"  {v:9.3f} ms  {k}")
    print("top kernels (ms per image, calls per image):")
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
