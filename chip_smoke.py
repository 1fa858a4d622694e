#!/usr/bin/env python3
"""Smoke run of the gsasr_torch port on one CUDA card.

  python3 chip_smoke.py [--json PATH]

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds kernels R, M and A from gsasr_torch/ops/csrc.
2. Kernel phase (TF32 off): each kernel against its plain PyTorch version at
   the main path's shapes, with its median time, the plain version's time
   and its lower bound on this card.
3. Path phase: make_models("edsr", "paper") with seeded weights, then
   sr_forward on 180x180 x4 (the main shape), 173x151 x3.3 and a batch of
   two 96x96 x2, checking shapes, finiteness and the kernel launch counts.
4. One 48x48 x4 request on the card against the same request on the CPU.
5. End-to-end timing of the main shape with PyTorch's default TF32
   settings, its encoder/decoder/render split, peak memory and the sigma
   percentiles of the rendered Gaussians.

Any failed phase raises and the exit code is not 0. The line before the
last is {"kernels": [...]}; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
--json PATH also writes every measurement and the compiler reports there.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Peaks of one H100 SXM (NVIDIA data sheet, at the 700 W limit): FP32
# outside the tensor cores and HBM3 bandwidth. The SFU rate is 16 special
# function results per SM per clock x 132 SMs x 1.98 GHz boost.
PEAK_FP32 = 67e12
PEAK_HBM = 3.35e12
PEAK_SFU = 16 * 132 * 1.98e9
# FP32 operations per (pixel, Gaussian) pair inside a cull box in kernel R
# (box test, offsets, quadratic form, exp argument, three color FMAs).
RASTER_OPS_PER_PAIR = 24
# Tolerances of kernel vs plain version on the card: |out - ref| <=
# ATOL + RTOL * |ref|. Both sides are float32; the kernels sum products of
# depth 144-180 and Gaussian contributions in another order.
KERNEL_ATOL = 1e-4
KERNEL_RTOL = 1e-4
# Card vs CPU on the whole path: two conv libraries and two summation
# orders through 38 attention and 83 MLP sub-layers, on images of order 5.
CARD_CPU_ATOL = 1e-3
# Launches per sr_forward of the paper decoder (independent of batch and
# image size) and of R per image.
M_PER_FORWARD = 83
A_PER_FORWARD = 38


def _nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of fn() over reps runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def _host_ms(fn, reps: int, warmup: int = 2):
    """Host-clock times of fn() ending in a synchronize, warm-ups dropped."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return ts


def _compare(out, ref, name):
    err = (out - ref).abs()
    ok = bool((err <= KERNEL_ATOL + KERNEL_RTOL * ref.abs()).all())
    mx = float(err.max())
    print(f"  {name}: max|d| {mx:.3e} (tol {KERNEL_ATOL} + {KERNEL_RTOL}|ref|,"
          f" max|ref| {float(ref.abs().max()):.3f})", flush=True)
    if not ok or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return mx


def _bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_HBM
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


@torch.no_grad()
def kernel_phase(enc, dec, dev):
    """Each kernel against its plain version at the main path's shapes."""
    from gsasr_torch.model import _lat_hw, pad_to_denominator
    from gsasr_torch.models.fea2gs_fast import _attn, _mlp, _seq_mlp
    from gsasr_torch.ops import fused_layers as fl
    from gsasr_torch.ops import rasterizer as rz
    from gsasr_torch.rendering import raster_inputs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(1)
    b, t, c, nh = 225, 144, 180, 6
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev)  # noqa: E731
    x = rnd(b, t, c)
    results = {}

    # -- M: the three option sets of the paper decoder -----------------------
    blk = dec.gs_selfattn_blocks[0]
    lyr = blk.blocks[0]
    scale_emb = dec.scale_mlp(torch.full((1, 1), 0.25, device=dev))
    cases = {
        "ln_inj": (dict(inj=lyr.gs_cross_attn_scale(scale_emb).expand(b, c)
                        .contiguous(), ln_w=lyr.norm4.weight,
                        ln_b=lyr.norm4.bias, **_mlp(lyr.mlp_crossattn)), 38),
        "ln": (dict(ln_w=lyr.norm2.weight, ln_b=lyr.norm2.bias,
                    **_mlp(lyr.mlp_selfattn)), 38),
        "resi": (dict(resi=rnd(b, t, c), **_seq_mlp(blk.mlp)), 7),
    }
    rows = []
    for name, (kw, per_image) in cases.items():
        out = fl.ln_mlp_residual(x, **kw)
        ref = fl.ln_mlp_residual_plain(x, **kw)
        err = _compare(out, ref, f"M {name}")
        ms = _time_ms(lambda: fl.ln_mlp_residual(x, **kw), 20)
        plain = _time_ms(lambda: fl.ln_mlp_residual_plain(x, **kw), 20)
        nbytes = 4 * (b * t * c * (3 if "resi" in kw else 2) + 2 * c * c
                      + (b * c if "inj" in kw else 0))
        bound, by = _bound_ms(4.0 * b * t * c * c, nbytes)
        rows.append(dict(case=name, per_image=per_image, max_abs_err=err,
                         ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by))
    results["M"] = rows

    # -- A: cross-attention (pos, kv, bias) and self-attention (bias) --------
    cl = dec.window_crossattn_blocks[0].blocks[0]
    sa = lyr.gs_self_attn
    kv = rnd(b, t, c)
    cases = {
        "cross_pos_kv_bias": (dict(pos=dec.pos_embedding, kv=kv,
                                   bias=cl.window_cross_attn.bias()
                                   .contiguous(), ln_w=cl.norm3.weight,
                                   ln_b=cl.norm3.bias,
                                   **_attn(cl.window_cross_attn)), 2),
        "self_bias": (dict(bias=sa.bias().contiguous(), ln_w=lyr.norm1.weight,
                           ln_b=lyr.norm1.bias, **_attn(sa)), 36),
    }
    rows = []
    for name, (kw, per_image) in cases.items():
        out = fl.ln_attn_proj(x, num_heads=nh, **kw)
        ref = fl.ln_attn_proj_plain(x, num_heads=nh, **kw)
        err = _compare(out, ref, f"A {name}")
        ms = _time_ms(lambda: fl.ln_attn_proj(x, num_heads=nh, **kw), 10)
        plain = _time_ms(lambda: fl.ln_attn_proj_plain(x, num_heads=nh,
                                                       **kw), 10)
        flops = 2.0 * b * (4 * t * c * c + 2 * t * t * c)
        nbytes = 4 * (b * t * c * (3 if "kv" in kw else 2) + 4 * c * c
                      + nh * t * t + (t * c if "pos" in kw else 0))
        bound, by = _bound_ms(flops, nbytes)
        rows.append(dict(case=name, per_image=per_image, max_abs_err=err,
                         ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by))
    results["A"] = rows

    # -- R: the 720x720 render of the decoder's output at these weights ------
    lq = torch.rand(1, 180, 180, 3, generator=g).to(dev)
    padded, _ = pad_to_denominator(lq, 12)
    with torch.no_grad():
        gs = dec(enc(padded), torch.full((1,), 4.0, device=dev))[0]
    sr = (720, 720)
    geom, colors, bbox = raster_inputs(sr, gs, 4.0, dmax_mode="fix",
                                       dmax=0.1, lat_hw=_lat_hw(dec, 180, 180))
    out = rz.raster_fwd(geom, colors, bbox, *sr)
    ref = rz.raster_fwd_plain(geom, colors, bbox, *sr)
    err = _compare(out, ref, "R 720x720")
    ms = _time_ms(lambda: rz.raster_fwd(geom, colors, bbox, *sr), 10)
    plain = _time_ms(lambda: rz.raster_fwd_plain(geom, colors, bbox, *sr), 3,
                     warmup=1)
    # pairs this run's data needs: the clipped integer pixels of every box
    nx = (torch.clamp(torch.floor(geom[:, 6]), max=sr[1] - 1)
          - torch.clamp(torch.ceil(geom[:, 5]), min=0) + 1).clamp(min=0)
    ny = (torch.clamp(torch.floor(geom[:, 8]), max=sr[0] - 1)
          - torch.clamp(torch.ceil(geom[:, 7]), min=0) + 1).clamp(min=0)
    pairs = float((nx.double() * ny.double()).sum())
    t_ops = pairs * RASTER_OPS_PER_PAIR / PEAK_FP32
    t_sfu = pairs / PEAK_SFU
    t_bytes = 4 * (geom.numel() + colors.numel() + sr[0] * sr[1] * 3) / PEAK_HBM
    bound = max(t_ops, t_sfu, t_bytes) * 1e3
    results["R"] = [dict(case="720x720", per_image=1, max_abs_err=err, ms=ms,
                         plain_ms=plain, bound_ms=bound,
                         bound_by="bytes" if t_bytes > max(t_ops, t_sfu)
                         else "operations", box_pairs=pairs,
                         gaussians=int(gs.shape[0]),
                         chunks=int(bbox.shape[1]))]
    for k, rows in results.items():
        for r in rows:
            print(f"  {k} {r['case']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f},"
                  f" bound {r['bound_ms']:.4f} by {r['bound_by']})", flush=True)
    return results


def _counts(kernels):
    return {k: f.launches for k, f in kernels.items()}


def _reset(kernels):
    for f in kernels.values():
        f.launches = 0


def path_phase(enc, dec, dev, kernels):
    """sr_forward on the user-facing requests; counts each kernel's launches
    from zero for each request."""
    from gsasr_torch.model import sr_forward

    g = torch.Generator().manual_seed(2)
    requests = [((1, 180, 180), 4.0), ((1, 173, 151), 3.3),
                ((2, 96, 96), 2.0)]
    runs = []
    for (b, h, w), scale in requests:
        lq = torch.rand(b, h, w, 3, generator=g)
        _reset(kernels)
        out = sr_forward(enc, dec, lq, scale)
        torch.cuda.synchronize()
        counts = _counts(kernels)
        want = (b, math.floor(h * scale), math.floor(w * scale), 3)
        print(f"  sr_forward {b}x{h}x{w} x{scale}: {tuple(out.shape)}, "
              f"launches {counts}, range [{float(out.min()):.4f}, "
              f"{float(out.max()):.4f}]", flush=True)
        if tuple(out.shape) != want or not torch.isfinite(out).all():
            raise AssertionError(f"bad output {tuple(out.shape)} for {want}")
        if counts != {"R": b, "M": M_PER_FORWARD, "A": A_PER_FORWARD}:
            raise AssertionError(f"launch counts {counts}")
        runs.append(dict(request=[b, h, w], scale=scale, shape=list(out.shape),
                         launches=counts))
    return runs


@torch.no_grad()
def card_vs_cpu(enc, dec, dev):
    from gsasr_torch.model import sr_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lq = torch.rand(1, 48, 48, 3, generator=torch.Generator().manual_seed(3))
    out = sr_forward(enc, dec, lq, 4.0).cpu()
    ref = sr_forward(copy.deepcopy(enc).cpu(), copy.deepcopy(dec).cpu(), lq,
                     4.0, device="cpu")
    err = float((out - ref).abs().max())
    print(f"  48x48 x4 card vs CPU: max|d| {err:.3e} (tol {CARD_CPU_ATOL}, "
          f"max|ref| {float(ref.abs().max()):.3f})", flush=True)
    if not err <= CARD_CPU_ATOL:
        raise AssertionError("card and CPU disagree")
    return dict(max_abs_err=err, max_ref=float(ref.abs().max()),
                tol=CARD_CPU_ATOL)


@torch.no_grad()
def e2e_phase(enc, dec, dev):
    """Main-shape latency with PyTorch's default TF32 settings."""
    from gsasr_torch.model import _lat_hw, pad_to_denominator, sr_forward
    from gsasr_torch.rendering import prepare_kernel_inputs, render_gaussians

    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch default
    torch.backends.cudnn.allow_tf32 = True         # PyTorch default
    lq = torch.rand(1, 180, 180, 3,
                    generator=torch.Generator().manual_seed(4)).to(dev)
    e2e = _host_ms(lambda: sr_forward(enc, dec, lq, 4.0), 9, warmup=2)
    padded, _ = pad_to_denominator(lq, 12)
    scales = torch.full((1,), 4.0, device=dev)
    with torch.no_grad():
        feat = enc(padded)
        gs = dec(feat, scales)
        enc_ms = _host_ms(lambda: enc(padded), 9)
        dec_ms = _host_ms(lambda: dec(feat, scales), 9)
    lat = _lat_hw(dec, 180, 180)
    ren_ms = _host_ms(lambda: render_gaussians((720, 720), gs[0], 4.0,
                                               dmax_mode="fix", dmax=0.1,
                                               lat_hw=lat), 9)
    torch.cuda.reset_peak_memory_stats()
    sr_forward(enc, dec, lq, 4.0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    sig = prepare_kernel_inputs((720, 720), gs[0], 4.0, dmax_mode="fix",
                                dmax=0.1)[0][:, :2]
    s_px = (sig * torch.tensor([719 / 2.0, 719 / 2.0], device=dev)).cpu()
    p50, p90 = (float(np.percentile(s_px.numpy(), p)) for p in (50, 90))
    res = dict(e2e_ms_median=float(np.median(e2e)), e2e_ms=e2e,
               encoder_ms=float(np.median(enc_ms)),
               decoder_ms=float(np.median(dec_ms)),
               render_ms=float(np.median(ren_ms)), peak_mem_bytes=int(peak),
               sigma_px_p50=p50, sigma_px_p90=p90,
               tf32={"cudnn": True, "matmul": False})
    print(f"  e2e 180x180 -> 720x720 x4: median {res['e2e_ms_median']:.3f} ms "
          f"over {len(e2e)} runs (encoder {res['encoder_ms']:.3f}, decoder "
          f"{res['decoder_ms']:.3f}, render {res['render_ms']:.3f}); peak "
          f"{peak / 2**20:.1f} MiB; sigma px p50 {p50:.4f} p90 {p90:.4f}; "
          f"TF32 cudnn on, matmul off (PyTorch defaults)", flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", help="write the details to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    from gsasr_torch.model import make_models
    from gsasr_torch.ops import _build
    from gsasr_torch.ops.fused_layers import ln_attn_proj, ln_mlp_residual
    from gsasr_torch.ops.rasterizer import raster_fwd

    t_start = time.perf_counter()
    card = _nvidia_smi()
    dev = torch.device("cuda")
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    names = ["raster_fwd", "ln_mlp", "ln_attn"]
    _build.build(names)
    build_s = time.perf_counter() - t0
    print(f"built {names} in {build_s:.1f} s", flush=True)
    ptxas = {n: _build.ptxas_report(n) for n in names}
    for n in names:
        for line in ptxas[n].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {n}: {line.strip()}", flush=True)

    kernels = {"R": raster_fwd, "M": ln_mlp_residual, "A": ln_attn_proj}
    enc, dec = make_models("edsr", "paper",
                           generator=torch.Generator().manual_seed(0))

    print("kernel phase", flush=True)
    kres = kernel_phase(enc, dec, dev)
    print("path phase", flush=True)
    runs = path_phase(enc, dec, dev, kernels)
    print("card vs CPU", flush=True)
    cvc = card_vs_cpu(enc, dec, dev)
    print("end to end", flush=True)
    e2e = e2e_phase(enc, dec, dev)

    main_counts = runs[0]["launches"]
    meta = {
        "R": ("gsasr_torch/ops/csrc/raster_fwd.cu",
              "gsasr_tpu/ops/rasterizer.py:334",
              ["gsasr_tpu/ops/rasterizer.py:254",
               "gsasr_tpu/ops/rasterizer.py:126"]),
        "M": ("gsasr_torch/ops/csrc/ln_mlp.cu",
              "gsasr_tpu/ops/fused_layers.py:122", []),
        "A": ("gsasr_torch/ops/csrc/ln_attn.cu",
              "gsasr_tpu/ops/fused_layers.py:336", []),
    }
    line = []
    for k, (src, rep, also) in meta.items():
        rows = kres[k]
        n = sum(r["per_image"] for r in rows)
        mean = lambda key: sum(r[key] * r["per_image"] for r in rows) / n  # noqa: E731
        entry = {"name": {"R": "raster_fwd", "M": "ln_mlp",
                          "A": "ln_attn"}[k],
                 "route": "cuda", "source": src, "replaces": rep,
                 "launches": main_counts[k],
                 "max_abs_err": max(r["max_abs_err"] for r in rows),
                 "ms": mean("ms"), "plain_ms": mean("plain_ms"),
                 "bound_ms": mean("bound_ms"),
                 "bound_by": rows[0]["bound_by"], "library_ms": None}
        if also:
            entry["also_replaces"] = also
        line.append(entry)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(card=card, torch=torch.__version__,
                           cuda=torch.version.cuda, build_s=build_s,
                           ptxas=ptxas, kernels=kres, paths=runs,
                           card_vs_cpu=cvc, e2e=e2e,
                           total_s=time.perf_counter() - t_start), f, indent=1)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
