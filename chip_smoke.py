#!/usr/bin/env python3
"""Smoke run of the gsasr_torch port on one CUDA card.

  python3 chip_smoke.py [--json PATH]

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds kernels R, M, A, W, WB, RB, MB, AB and T from
   gsasr_torch/ops/csrc, one nvcc each, in parallel.
2. Kernel phase (TF32 off): R, M and A against their plain PyTorch versions
   at the inference path's shapes, with their median times, the plain
   versions' times and their lower bounds on this card.
3. Path phase: make_models("edsr", "paper") with seeded weights, then
   sr_forward on 180x180 x4 (the main shape), 173x151 x3.3 and a batch of
   two 96x96 x2, checking shapes, finiteness and the kernel launch counts.
4. One 48x48 x4 request on the card against the same request on the CPU.
5. End-to-end timing of the main shape with PyTorch's default TF32
   settings, its encoder/decoder/render split, peak memory and the sigma
   percentiles of the rendered Gaussians.
6. Training kernel phase (TF32 off): W, WB and RB against their plain
   versions at the paper training step's shapes (256 windows of 144 tokens;
   the 3072x192 slot canvas of 16 samples), WB and RB twice for bitwise
   repeatability, with times, bounds and the SDPA yardstick for W and WB.
7. Fused training kernel phase (TF32 off): MB and AB against their plain
   versions at the training step's shapes, for each option set the fused
   decoder uses, and T (the bias-table gradient) for both tables; each
   twice for bitwise repeatability, with times and bounds.
8. Training phase: Trainer.step on the paper EDSR-GSASR at full width and
   depth with configs/train_edsr_paper.yml's recipe, 16 samples of 48x48,
   2 warm-up and 5 timed steps, first on the module decoder, then with
   fused_decoder=True: launch counts per step, finite losses, moved
   parameters and EMA, step time and its split, peak memory, and a report
   of whether two gradients of one batch from one state are the same bits.
9. One tiny training step on the card against the same step on the CPU,
   module and fused decoder.
10. Enhanced kernel phase (TF32 off): M in its zero_base and bf16 forms, A
   in its RoPE (fp32 and bf16) and paper bf16 forms, against their plain
   versions at the Enhanced shapes (225 windows x 144 tokens x 192
   channels, 6 heads), with times and bounds.
11. Enhanced path phase: make_models("edsr", "enhanced"), then sr_forward
   (bf16 trunk, fp32 heads) on the three requests of phase 3, with the
   same launch counts.
12. One 48x48 x4 Enhanced request on the card against the CPU, with the
   trunk in fp32 and in bf16.
13. Enhanced end-to-end timing of the main shape, bf16 and fp32 trunk.
14. SwinIR kernel phase (TF32 off): WM and WMB (the masked forms of W and
   WB) against their plain versions at SwinIR's inference shape (576
   windows x 64 tokens x 180 channels, 6 heads, the SW-MSA mask of a
   192x192 map) and training shape (16 x 36 windows, period 36), WMB twice
   for bitwise repeatability; W and WB at T = 64; times, bounds and the
   SDPA yardstick with the bias and mask as a float mask.
15. SwinIR path phase: make_models("swinir", "paper"), sr_forward with
   denominator 24 on the three requests of phase 3 (18 W and 18 WM more per
   forward than EDSR), a 48x48 request on the card against the CPU, and
   the 180x180 x4 end-to-end timing.
16. SwinIR training: Trainer.step of configs/train_swinir_paper.yml's
   recipe (DropPath 0.1) at batch 16 on the module decoder, as phase 8
   (W 56, WB 56, WM 18, WMB 18, R 1, RB 1, T 74 per step), and a tiny step
   (drop_path_rate 0) on the card against the CPU.
17. RDN: path phase and end-to-end timing of make_models("rdn", "paper").

Any failed phase raises and the exit code is not 0. The line before the
last is {"kernels": [...]}; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
--json PATH also writes every measurement and the compiler reports there.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# Peaks of one H100 SXM (NVIDIA data sheet, at the 700 W limit): FP32
# outside the tensor cores and HBM3 bandwidth. The SFU rate is 16 special
# function results per SM per clock x 132 SMs x 1.98 GHz boost.
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12  # dense tensor cores
PEAK_BF16 = 989e12  # dense tensor cores
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
# bf16 forms of M and A against their plain versions on the card: both
# round at the same points but sum their f32 products in another order, so
# a rounded intermediate may move by one bf16 step (2^-8 relative):
# |out - ref| <= BF16_RTOL |ref| + BF16_ATOL max|ref|.
BF16_RTOL = 2 ** -7
BF16_ATOL = 2 ** -8
# Card vs CPU on the whole path: two conv libraries and two summation
# orders through 38 attention and 83 MLP sub-layers, on images of order 5.
CARD_CPU_ATOL = 1e-3
# The same with a bf16 trunk: a one-step rounding difference of a trunk
# value (2^-8 relative) reaches the image through the Gaussians; 7.6e-4
# measured on an H100.
CARD_CPU_ATOL_BF16 = 5e-3
# Launches per sr_forward of the paper decoder (independent of batch and
# image size) and of R per image.
M_PER_FORWARD = 83
A_PER_FORWARD = 38
# configs/train_edsr_paper.yml as gsasr_torch.config.build_train_config
# reads it, written out because the card has no PyYAML
# (tests/test_torch_trainer.py holds them equal to the file), and its
# dataset block: 16 samples of 48x48 LR, scales in [1, 4], gt = round(s 48).
PAPER_TRAIN = dict(lr=2e-4, betas=(0.9, 0.99),
                   milestones=(250000, 400000, 450000, 475000), gamma=0.5,
                   total_iter=500000, warmup_iter=2000, ema_decay=0.999,
                   clip_grad_norm=None, accumulation_steps=1,
                   default_step_size=1.2, dmax=0.5, dmax_mode="fix",
                   if_dmax=True, canvas_hw=(192, 192), ssim_weight=0.0,
                   seed=0, fused_decoder=False)
PAPER_BATCH = 16
PAPER_LR_SIZE = 48
PAPER_SCALES = (1, 4)
# FP32 operations per (pixel, Gaussian) pair inside a cull box in kernel RB
# (box test, offsets and products, quadratic form, exp argument, three
# color FMAs, g . col and at, five moment FMAs).
RB_OPS_PER_PAIR = 35
# Gradient tolerance, kernel vs plain and card vs CPU: |d| <= GRAD_TOL *
# max|ref| (per output and column) + GRAD_TOL * |ref|. Moment sums over
# thousands of pixels and sums over 256 windows cancel, so an entry's error
# scales with its column's largest entry.
GRAD_TOL = 1e-4
# Launches per paper training step: W and WB once per window attention
# (2 cross + 36 self), R and RB once for the slot canvas, T once per
# attention's bias table; with fused_decoder=True, M and MB once per MLP
# chain (38 inject, 38 feature/self FFNs, 7 block tails) and A and AB once
# per attention instead of W and WB.
TRAIN_COUNTS = {"R": 1, "M": 0, "A": 0, "W": 38, "WB": 38, "RB": 1, "MB": 0,
                "AB": 0, "T": 38, "WM": 0, "WMB": 0}
FUSED_TRAIN_COUNTS = {"R": 1, "M": 83, "A": 38, "W": 0, "WB": 0, "RB": 1,
                      "MB": 83, "AB": 38, "T": 38, "WM": 0, "WMB": 0}
# SwinIR (6 RSTBs of 6 blocks, window 8, shift 4 on odd blocks): per
# forward 18 W (unshifted blocks) and 18 WM (shifted), per step their
# backward too, and 36 more T (its bias tables). configs/
# train_swinir_paper.yml's recipe is PAPER_TRAIN (tests/test_torch_swinir.py
# holds it equal); sr_forward pads to 24.
SWINIR_DENOMINATOR = 24
SWINIR_PER_FORWARD = {"W": 18, "WM": 18}
SWINIR_TRAIN_COUNTS = dict(TRAIN_COUNTS, W=56, WB=56, WM=18, WMB=18, T=74)
TRAIN_WARMUP = 2
TRAIN_STEPS = 5


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


def _grad_err(out, ref, per_column: bool = True, floor: float = 0.0):
    """Largest |out - ref| and whether every entry is inside GRAD_TOL
    (per column of the last axis, or of the whole tensor) plus `floor`."""
    r = ref.reshape(-1, ref.shape[-1]) if ref.dim() else ref.reshape(1, 1)
    o = out.reshape(r.shape)
    scale = r.abs().amax(dim=0) if per_column else r.abs().max()
    err = (o - r).abs()
    ok = bool((err <= GRAD_TOL * scale + GRAD_TOL * r.abs() + floor).all())
    return float(err.max()), ok and bool(torch.isfinite(o).all())


def _compare_grad(out, ref, name):
    mx, ok = _grad_err(out, ref)
    print(f"  {name}: max|d| {mx:.3e} (tol {GRAD_TOL} max|ref col| + "
          f"{GRAD_TOL}|ref|, max|ref| {float(ref.abs().max()):.3e})",
          flush=True)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return mx


def _compare_grads(outs, refs, names, label, floor_of=None):
    """_compare_grad over a kernel's outputs: a matrix per column, a vector
    over the whole vector. `floor_of` maps an output whose true value is 0
    (float32 noise on both sides) to the output whose largest entry, times
    GRAD_TOL, is its floor. Returns the largest |out - ref|."""
    worst = 0.0
    for o, r, n in zip(outs, refs, names):
        if r is None:
            if o is not None:
                raise AssertionError(f"{label} {n}: output without reference")
            continue
        floor = 0.0
        if floor_of and n in floor_of:
            floor = GRAD_TOL * float(
                refs[names.index(floor_of[n])].abs().max())
        mx, ok = _grad_err(o, r, per_column=r.dim() >= 2, floor=floor)
        print(f"  {label} {n}: max|d| {mx:.3e} (max|ref| "
              f"{float(r.abs().max()):.3e})", flush=True)
        if not ok:
            raise AssertionError(f"{label} {n}: kernel disagrees with its "
                                 "plain version")
        worst = max(worst, mx)
    return worst


def _repeatable(fn, name):
    """Two launches of a kernel give the same bits."""
    a, b = fn(), fn()
    if not all(x is None and y is None or torch.equal(x, y)
               for x, y in zip(a, b)):
        raise AssertionError(f"{name}: two launches differ")
    print(f"  {name}: two launches bitwise equal", flush=True)


def _compare_bf16(out, ref, name):
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    scale = float(r.abs().max())
    ok = bool((err <= BF16_RTOL * r.abs() + BF16_ATOL * scale).all())
    mx = float(err.max())
    print(f"  {name}: max|d| {mx:.3e} (tol 2^-7|ref| + 2^-8 max|ref|, "
          f"max|ref| {scale:.3f})", flush=True)
    if out.dtype != torch.bfloat16 or not ok or not torch.isfinite(o).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return mx


class _OpFlops(TorchDispatchMode):
    """Operations of the products and convolutions PyTorch runs inside the
    mode (torch's own flop registry), by kind and operand type."""

    def __init__(self):
        super().__init__()
        self.flops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            kind = "conv" if "conv" in func._overloadpacket.__name__ else "mm"
            key = (kind, args[0].dtype)
            self.flops[key] = self.flops.get(key, 0) + count(
                *args, **kwargs, out_val=out)
        return out


def _e2e_bound_ms(enc, dec, lq, dt, denominator=12):
    """Least time of one sr_forward's arithmetic: the PyTorch products
    (full fp32 or bf16) and convolutions (TF32 by cuDNN's default, or bf16)
    over their peaks, plus kernels M and A (their operations at their
    type's peak: 4 rows C^2 and 2 B (2 Tq C^2 + 2 Tk C^2 + 2 Tq Tk C) per
    launch) and a SwinIR encoder's W and WM (4 B T^2 C each, FP32). The
    raster and the glue's bytes are not counted."""
    from gsasr_torch.model import pad_to_denominator, sr_forward
    from gsasr_torch.models import SwinIRNOUP

    mode = _OpFlops()
    with mode:
        sr_forward(enc, dec, lq, 4.0, trunk_dtype=dt,
                   denominator=denominator)
    peak = {("mm", torch.float32): PEAK_FP32,
            ("conv", torch.float32): PEAK_TF32,
            ("mm", torch.bfloat16): PEAK_BF16,
            ("conv", torch.bfloat16): PEAK_BF16}
    ms = sum(f / peak[k] for k, f in mode.flops.items()) * 1e3
    padded, _ = pad_to_denominator(lq, denominator)
    b, h, w, _ = padded.shape
    ws, c, t = dec.window_size, dec.channel, dec.num_gs_seed
    win = b * -(-h // ws) * -(-w // ws)
    cross = sum(len(blk.blocks) for blk in dec.window_crossattn_blocks)
    self_ = sum(len(blk.blocks) for blk in dec.gs_selfattn_blocks)
    mlps = 2 * (cross + self_) + len(dec.window_crossattn_blocks) + len(
        dec.gs_selfattn_blocks)
    kflops = (mlps * 4.0 * win * t * c * c
              + cross * 2.0 * win * (2 * t * c * c + 2 * ws * ws * c * c
                                     + 2 * t * ws * ws * c)
              + self_ * 2.0 * win * (4 * t * c * c + 2 * t * t * c))
    kpeak = PEAK_BF16 if dt == torch.bfloat16 else PEAK_FP32
    flops = {f"{k[0]}_{str(k[1]).replace('torch.', '')}": f
             for k, f in mode.flops.items()}
    flops["kernels_M_A"] = kflops
    ms += kflops / kpeak * 1e3
    if isinstance(enc, SwinIRNOUP):
        ew = enc.window_size
        blocks = sum(len(layer.residual_group["blocks"])
                     for layer in enc.layers)
        ec = enc.conv_first.out_channels
        flops["kernels_W_WM"] = (blocks * 4.0 * b * (h // ew) * (w // ew)
                                 * ew ** 4 * ec)
        ms += flops["kernels_W_WM"] / PEAK_FP32 * 1e3
    return ms, flops


def _bound_ms(flops: float, nbytes: float, peak: float = PEAK_FP32):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


@torch.no_grad()
def kernel_phase(enc, dec, dev):
    """Each kernel against its plain version at the main path's shapes."""
    from gsasr_torch.model import _lat_hw, pad_to_denominator
    from gsasr_torch.models.fea2gs_fast import (_attn, _mlp, _seq_mlp,
                                                fea2gs_apply_fused)
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
        gs = fea2gs_apply_fused(dec, enc(padded),
                                torch.full((1,), 4.0, device=dev))[0]
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


@torch.no_grad()
def enhanced_kernel_phase(dec, dev):
    """M's zero_base and bf16 forms and A's RoPE and bf16 forms against their
    plain versions at the Enhanced path's shapes, with the decoder's weights
    and RoPE tables. per_image: launches per image on the Enhanced main path
    (bf16 trunk); fp32 rows run 0 times there (the fp32 trunk's weights)."""
    from gsasr_torch.models.fea2gs_fast import _attn, _ln, _mlp, _seq_mlp
    from gsasr_torch.models.fea2gs_rope_fast import rope_tables
    from gsasr_torch.ops import fused_layers as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(11)
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev)  # noqa: E731
    b, t, c, nh = 225, 144, dec.channel, dec.num_heads
    ws = dec.window_size
    f32, bf16 = torch.float32, torch.bfloat16
    x = rnd(b, t, c)
    blk = dec.gs_selfattn_blocks[0]
    lyr = blk.blocks[0]
    cl = dec.window_crossattn_blocks[0].blocks[0]
    scale_emb = dec.scale_mlp(torch.full((1, 1), 0.25, device=dev))
    inj = lyr.gs_cross_attn_scale(scale_emb).expand(b, c).contiguous()
    results = {"M": [], "A": []}

    def row(kind, name, dt, per_image, out, ref, flops, nbytes, fn, plain,
            reps):
        err = (_compare_bf16(out, ref, f"{kind} {name}") if dt == bf16
               else _compare(out, ref, f"{kind} {name}"))
        ms = _time_ms(fn, reps)
        plain_ms = _time_ms(plain, reps)
        bound, by = _bound_ms(flops, nbytes,
                              PEAK_BF16 if dt == bf16 else PEAK_FP32)
        results[kind].append(dict(
            case=name, dtype=str(dt).replace("torch.", ""),
            per_image=per_image, max_abs_err=err,
            max_ref=float(ref.float().abs().max()), ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=None))

    # -- M: the block tails (zero_base) in both types, the inject and FFN
    # chains in bf16
    for name, dt, per_image, kw in (
            ("zero_base", f32, 0, dict(zero_base=True, **_seq_mlp(blk.mlp))),
            ("zero_base", bf16, 7, dict(zero_base=True, **_seq_mlp(blk.mlp))),
            ("ln_inj", bf16, 38, dict(inj=inj.to(bf16), **_ln(lyr.norm4),
                                      **_mlp(lyr.mlp_crossattn))),
            ("ln", bf16, 38, dict(**_ln(lyr.norm2),
                                  **_mlp(lyr.mlp_selfattn)))):
        xd = x.to(dt)
        act = 2 if dt == bf16 else 4
        nbytes = (act * (2 * b * t * c + (b * c if "inj" in kw else 0))
                  + 4 * (2 * c * c + 2 * c + (2 * c if "ln_w" in kw else 0)))
        row("M", name, dt, per_image, fl.ln_mlp_residual(xd, **kw),
            fl.ln_mlp_residual_plain(xd, **kw), 4.0 * b * t * c * c, nbytes,
            lambda: fl.ln_mlp_residual(xd, **kw),
            lambda: fl.ln_mlp_residual_plain(xd, **kw), 20)

    # -- A: RoPE cross-attention (pos, kv) and self-attention in both types,
    # and the paper's bias form in bf16
    nsq = math.isqrt(t)
    cc, sc = rope_tables(cl.window_cross_attn.rope_freqs, max(nsq, ws),
                         max(t, ws * ws))
    cs, ss = rope_tables(lyr.gs_self_attn.rope_freqs, nsq, t)
    kv = rnd(b, ws * ws, c)
    cross = dict(pos=dec.pos_embedding, rope_cos_q=cc[:t], rope_sin_q=sc[:t],
                 rope_cos_k=cc[:ws * ws], rope_sin_k=sc[:ws * ws],
                 **_attn(cl.window_cross_attn), **_ln(cl.norm3))
    self_ = dict(rope_cos_q=cs, rope_sin_q=ss, rope_cos_k=cs, rope_sin_k=ss,
                 **_attn(lyr.gs_self_attn), **_ln(lyr.norm1))
    bias = dict(bias=0.02 * rnd(nh, t, t), **_attn(lyr.gs_self_attn),
                **_ln(lyr.norm1))
    for name, dt, per_image, kw in (
            ("rope_cross", f32, 0, cross), ("rope_self", f32, 0, self_),
            ("rope_cross", bf16, 2, cross), ("rope_self", bf16, 36, self_),
            ("bias_self", bf16, 0, bias)):
        kw = dict(kw, num_heads=nh)
        if "pos" in kw:
            kw.update(pos=kw["pos"].to(dt), kv=kv.to(dt))
        xd = x.to(dt)
        act = 2 if dt == bf16 else 4
        flops = 2.0 * b * (4 * t * c * c + 2 * t * t * c)
        nbytes = (act * (b * t * c * (3 if "kv" in kw else 2)
                         + (t * c if "pos" in kw else 0))
                  + 4 * (4 * c * c + 6 * c + (nh * t * t if "bias" in kw
                                              else 4 * t * c)))
        row("A", name, dt, per_image, fl.ln_attn_proj(xd, **kw),
            fl.ln_attn_proj_plain(xd, **kw), flops, nbytes,
            lambda: fl.ln_attn_proj(xd, **kw),
            lambda: fl.ln_attn_proj_plain(xd, **kw), 10)
    for k, rows in results.items():
        for r in rows:
            print(f"  {k} {r['case']} {r['dtype']}: {r['ms']:.4f} ms (plain "
                  f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} by "
                  f"{r['bound_by']}) x{r['per_image']} per Enhanced image",
                  flush=True)
    return results


def _counts(kernels):
    return {k: f.launches for k, f in kernels.items()}


def _reset(kernels):
    for f in kernels.values():
        f.launches = 0


def path_phase(enc, dec, dev, kernels, label="paper", denominator=12,
               extra=None):
    """sr_forward on the user-facing requests (the decoder's default trunk
    type); counts each kernel's launches from zero for each request. Per
    forward: 1 R per image, M and A as the paper decoder launches them, and
    `extra` (the encoder's kernels)."""
    from gsasr_torch.model import sr_forward

    g = torch.Generator().manual_seed(2)
    requests = [((1, 180, 180), 4.0), ((1, 173, 151), 3.3),
                ((2, 96, 96), 2.0)]
    runs = []
    for (b, h, w), scale in requests:
        lq = torch.rand(b, h, w, 3, generator=g)
        _reset(kernels)
        out = sr_forward(enc, dec, lq, scale, denominator=denominator)
        torch.cuda.synchronize()
        counts = _counts(kernels)
        want = (b, math.floor(h * scale), math.floor(w * scale), 3)
        print(f"  {label} sr_forward {b}x{h}x{w} x{scale}: {tuple(out.shape)}, "
              f"launches {counts}, range [{float(out.min()):.4f}, "
              f"{float(out.max()):.4f}]", flush=True)
        if tuple(out.shape) != want or not torch.isfinite(out).all():
            raise AssertionError(f"bad output {tuple(out.shape)} for {want}")
        want_counts = {k: 0 for k in kernels}
        want_counts.update(R=b, M=M_PER_FORWARD, A=A_PER_FORWARD,
                           **(extra or {}))
        if counts != want_counts:
            raise AssertionError(f"launch counts {counts}")
        runs.append(dict(request=[b, h, w], scale=scale, shape=list(out.shape),
                         launches=counts))
    return runs


@torch.no_grad()
def card_vs_cpu(enc, dec, dev, trunk_dtype=torch.float32, tol=CARD_CPU_ATOL,
                label="paper", denominator=12):
    from gsasr_torch.model import sr_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lq = torch.rand(1, 48, 48, 3, generator=torch.Generator().manual_seed(3))
    out = sr_forward(enc, dec, lq, 4.0, trunk_dtype=trunk_dtype,
                     denominator=denominator).cpu()
    ref = sr_forward(copy.deepcopy(enc).cpu(), copy.deepcopy(dec).cpu(), lq,
                     4.0, device="cpu", trunk_dtype=trunk_dtype,
                     denominator=denominator)
    err = float((out - ref).abs().max())
    trunk = str(trunk_dtype).replace("torch.", "")
    print(f"  {label} 48x48 x4 card vs CPU, {trunk} trunk: max|d| {err:.3e} "
          f"(tol {tol}, max|ref| {float(ref.abs().max()):.3f})", flush=True)
    if not err <= tol:
        raise AssertionError("card and CPU disagree")
    return dict(decoder=label, trunk=trunk, max_abs_err=err,
                max_ref=float(ref.abs().max()), tol=tol)


@torch.no_grad()
def e2e_phase(enc, dec, dev, trunk_dtype=None, label="paper",
              denominator=12):
    """Main-shape latency with PyTorch's default TF32 settings, the decoder
    trunk in `trunk_dtype` (default: the family's); the split renders the
    padded map (768x768 for SwinIR's 192x192) as sr_forward does."""
    from gsasr_torch.model import (_lat_hw, fused_dtype, pad_to_denominator,
                                   sr_forward)
    from gsasr_torch.models import Fea2GSRopeAMP
    from gsasr_torch.models.fea2gs_fast import fea2gs_apply_fused
    from gsasr_torch.models.fea2gs_rope_fast import fea2gs_rope_apply_fused
    from gsasr_torch.rendering import prepare_kernel_inputs, render_gaussians

    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch default
    torch.backends.cudnn.allow_tf32 = True         # PyTorch default
    dt = fused_dtype(dec) if trunk_dtype is None else trunk_dtype
    fused = (fea2gs_rope_apply_fused if isinstance(dec, Fea2GSRopeAMP)
             else fea2gs_apply_fused)
    fdt = None if dt == torch.float32 else dt
    lq = torch.rand(1, 180, 180, 3,
                    generator=torch.Generator().manual_seed(4)).to(dev)
    e2e = _host_ms(lambda: sr_forward(enc, dec, lq, 4.0, trunk_dtype=dt,
                                      denominator=denominator), 9, warmup=2)
    padded, _ = pad_to_denominator(lq, denominator)
    ph, pw = padded.shape[1:3]
    scales = torch.full((1,), 4.0, device=dev)
    with torch.no_grad():
        feat = enc(padded)
        gs = fused(dec, feat, scales, fdt)
        enc_ms = _host_ms(lambda: enc(padded), 9)
        dec_ms = _host_ms(lambda: fused(dec, feat, scales, fdt), 9)
    lat = _lat_hw(dec, ph, pw)
    sr = (4 * ph, 4 * pw)
    ren_ms = _host_ms(lambda: render_gaussians(sr, gs[0], 4.0,
                                               dmax_mode="fix", dmax=0.1,
                                               lat_hw=lat), 9)
    torch.cuda.reset_peak_memory_stats()
    sr_forward(enc, dec, lq, 4.0, trunk_dtype=dt, denominator=denominator)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    bound, flops = _e2e_bound_ms(enc, dec, lq, dt, denominator)
    sig = prepare_kernel_inputs(sr, gs[0], 4.0, dmax_mode="fix",
                                dmax=0.1)[0][:, :2]
    s_px = (sig * torch.tensor([(sr[1] - 1) / 2.0, (sr[0] - 1) / 2.0],
                               device=dev)).cpu()
    p50, p90 = (float(np.percentile(s_px.numpy(), p)) for p in (50, 90))
    trunk = str(dt).replace("torch.", "")
    res = dict(decoder=label, trunk=trunk,
               e2e_ms_median=float(np.median(e2e)), e2e_ms=e2e,
               encoder_ms=float(np.median(enc_ms)),
               decoder_ms=float(np.median(dec_ms)),
               render_ms=float(np.median(ren_ms)), peak_mem_bytes=int(peak),
               bound_ms=bound, flops=flops,
               sigma_px_p50=p50, sigma_px_p90=p90,
               tf32={"cudnn": True, "matmul": False})
    print(f"  {label} e2e 180x180 -> 720x720 x4, {trunk} trunk: median "
          f"{res['e2e_ms_median']:.3f} ms "
          f"over {len(e2e)} runs (encoder {res['encoder_ms']:.3f}, decoder "
          f"{res['decoder_ms']:.3f}, render {res['render_ms']:.3f}; bound "
          f"{bound:.3f}); peak "
          f"{peak / 2**20:.1f} MiB; sigma px p50 {p50:.4f} p90 {p90:.4f}; "
          f"TF32 cudnn on, matmul off (PyTorch defaults)", flush=True)
    return res


def paper_batch(b: int, seed: int):
    """A synthetic batch of the paper recipe: b samples of 48x48 LR, scales
    uniform in [1, 4], gt_h = gt_w = round(scale * 48), random gt on the
    192x192 canvas; numpy from a seed."""
    rng = np.random.default_rng(seed)
    hmax = PAPER_TRAIN["canvas_hw"][0]
    scales = rng.uniform(*PAPER_SCALES, b).astype(np.float32)
    gt = np.round(scales * PAPER_LR_SIZE).astype(np.int32)
    return {"lq": rng.random((b, PAPER_LR_SIZE, PAPER_LR_SIZE, 3),
                             dtype=np.float32),
            "gt": rng.random((b, hmax, hmax, 3), dtype=np.float32),
            "scale": scales, "gt_h": gt, "gt_w": gt}


def _sdpa_ms(q, k, v, mask, g, nh, scale):
    """Yardsticks for W and WB (WM and WMB): one
    scaled_dot_product_attention call on (B, nh, T, hd) views of the packed
    operands with a float attn_mask (the bias as (1, nh, Tq, Tk), or bias
    and window mask summed to (B, nh, Tq, Tk)), and its backward through
    torch.autograd.grad. Returns (fwd ms, bwd ms or None, why None)."""
    import torch.nn.functional as F

    b, tq, c = q.shape
    heads = lambda x: x.view(b, x.shape[1], nh, c // nh).transpose(1, 2)  # noqa: E731
    qh, kh, vh, gh = heads(q), heads(k), heads(v), heads(g)
    fwd = _time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, scale=scale), 10)
    leaves = [x.detach().requires_grad_() for x in (qh, kh, vh, mask)]
    try:
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(*leaves[:3],
                                                 attn_mask=leaves[3],
                                                 scale=scale)
            bwd = _time_ms(lambda: torch.autograd.grad(
                out, leaves, gh, retain_graph=True), 10)
        return fwd, bwd, None
    except RuntimeError as e:
        return fwd, None, f"SDPA gives the mask no gradient: {e}"


@torch.no_grad()
def train_kernel_phase(enc, dec, dev):
    """W, WB and RB against their plain versions at the training step's
    shapes, twice each for WB and RB to show the bits repeat."""
    from gsasr_torch.models.fea2gs_fast import fea2gs_apply_fused
    from gsasr_torch.ops import attention as ta
    from gsasr_torch.ops import rasterizer as rz
    from gsasr_torch.rendering import training_batch_geometry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(5)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    b = PAPER_BATCH * (PAPER_LR_SIZE // dec.window_size) ** 2
    t, c, nh = dec.num_gs_seed, dec.channel, dec.num_heads
    hd = c // nh
    scale = hd ** -0.5
    cross = dec.window_crossattn_blocks[0].blocks[0].window_cross_attn
    self_ = dec.gs_selfattn_blocks[0].blocks[0].gs_self_attn
    results = {"W": [], "WB": []}
    for name, tk, bias, per_step in (
            ("cross", dec.window_size ** 2, cross.bias().contiguous(), 2),
            ("self", t, self_.bias().contiguous(), 36)):
        q, k, v, g = rnd(b, t, c), rnd(b, tk, c), rnd(b, tk, c), rnd(b, t, c)
        fargs = (q, k, v, bias, scale, nh)
        err = _compare(ta.window_attention_packed_fwd(*fargs),
                       ta.window_attention_packed_plain(*fargs), f"W {name}")
        ms = _time_ms(lambda: ta.window_attention_packed_fwd(*fargs), 20)
        plain = _time_ms(lambda: ta.window_attention_packed_plain(*fargs), 10)
        lib_f, lib_b, why = _sdpa_ms(q, k, v, bias[None], g, nh, scale)
        bound, by = _bound_ms(4.0 * b * nh * t * tk * hd,
                              4 * (2 * b * t * c + 2 * b * tk * c
                                   + nh * t * tk))
        results["W"].append(dict(case=name, per_step=per_step,
                                 max_abs_err=err, ms=ms, plain_ms=plain,
                                 bound_ms=bound, bound_by=by,
                                 library_ms=lib_f))
        bargs = (q, k, v, bias, g, scale, nh)
        outs = ta.window_attention_packed_bwd(*bargs)
        refs = ta.window_attention_packed_bwd_plain(*bargs)
        err = max(_compare_grad(o, r, f"WB {name} {n}") for o, r, n in zip(
            outs, refs, ("dq", "dk", "dv", "dbias")))
        _repeatable(lambda: ta.window_attention_packed_bwd(*bargs),
                    f"WB {name}")
        ms = _time_ms(lambda: ta.window_attention_packed_bwd(*bargs), 10)
        plain = _time_ms(lambda: ta.window_attention_packed_bwd_plain(
            *bargs), 5)
        if why:
            print(f"  WB {name} library: null ({why})", flush=True)
        # five products: the recomputed scores, dp, dv, dq and dk
        bound, by = _bound_ms(10.0 * b * nh * t * tk * hd,
                              4 * (3 * b * t * c + 4 * b * tk * c
                                   + 2 * nh * t * tk))
        results["WB"].append(dict(case=name, per_step=per_step,
                                  max_abs_err=err, ms=ms, plain_ms=plain,
                                  bound_ms=bound, bound_by=by,
                                  library_ms=lib_b, library_null_reason=why))

    # -- RB on the slot canvas of the seeded decoder's Gaussians -------------
    cfg = PAPER_TRAIN
    batch = paper_batch(PAPER_BATCH, seed=6)
    lq = torch.from_numpy(batch["lq"]).to(dev)
    sc = torch.from_numpy(batch["scale"]).to(dev)
    gt_h = torch.from_numpy(batch["gt_h"]).to(dev)
    gs = fea2gs_apply_fused(dec, enc(lq), sc)
    geoms, colors = training_batch_geometry(
        gs, sc, gt_h, gt_h, cfg["canvas_hw"],
        default_step_size=cfg["default_step_size"], if_dmax=cfg["if_dmax"],
        dmax_mode=cfg["dmax_mode"], dmax=cfg["dmax"])
    h, w = PAPER_BATCH * cfg["canvas_hw"][0], cfg["canvas_hw"][1]
    geom, col, bbox = rz.chunk_geometry(geoms.reshape(-1, rz.GEOM_COLS),
                                        colors.reshape(-1, 3), (h, w))
    g = rnd(h, w, 3)
    outs = rz.raster_bwd(geom, col, bbox, g, h, w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refs = rz.raster_bwd_plain(geom, col, bbox, g, h, w)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    err = max(_compare_grad(o, r, f"RB {n}") for o, r, n in zip(
        outs, refs, ("dgeom", "dcol")))
    if not bool((outs[0][:, 5:] == 0).all()):
        raise AssertionError("RB: cull-box columns got a gradient")
    _repeatable(lambda: rz.raster_bwd(geom, col, bbox, g, h, w), "RB")
    ms = _time_ms(lambda: rz.raster_bwd(geom, col, bbox, g, h, w), 10)
    nx = (torch.clamp(torch.floor(geom[:, 6]), max=w - 1)
          - torch.clamp(torch.ceil(geom[:, 5]), min=0) + 1).clamp(min=0)
    ny = (torch.clamp(torch.floor(geom[:, 8]), max=h - 1)
          - torch.clamp(torch.ceil(geom[:, 7]), min=0) + 1).clamp(min=0)
    pairs = float((nx.double() * ny.double()).sum())
    t_ops = pairs * RB_OPS_PER_PAIR / PEAK_FP32
    t_sfu = pairs / PEAK_SFU
    t_bytes = 4 * (2 * geom.numel() + 2 * col.numel() + h * w * 3) / PEAK_HBM
    results["RB"] = [dict(case=f"{h}x{w}", per_step=1, max_abs_err=err,
                          ms=ms, plain_ms=plain,
                          bound_ms=max(t_ops, t_sfu, t_bytes) * 1e3,
                          bound_by="bytes" if t_bytes > max(t_ops, t_sfu)
                          else "operations", library_ms=None,
                          library_null_reason="no PyTorch call computes it",
                          box_pairs=pairs, gaussians=int(geom.shape[0]),
                          chunks=int(bbox.shape[1]))]
    for k in ("W", "WB", "RB"):
        for r in results[k]:
            lib = "null" if r["library_ms"] is None else \
                f"{r['library_ms']:.4f}"
            print(f"  {k} {r['case']}: {r['ms']:.4f} ms (plain "
                  f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} by "
                  f"{r['bound_by']}, library {lib}) x{r['per_step']} per "
                  f"step", flush=True)
    return results


@torch.no_grad()
def fused_kernel_phase(dec, dev):
    """MB and AB against their plain versions at the fused training step's
    shapes, for each option set the fused decoder uses, and T for both bias
    tables; twice each to show the bits repeat."""
    from gsasr_torch.models.fea2gs_fast import _attn, _ln, _mlp, _seq_mlp
    from gsasr_torch.ops import bias_table as bt
    from gsasr_torch.ops import fused_layers as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(9)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    b = PAPER_BATCH * (PAPER_LR_SIZE // dec.window_size) ** 2
    t, c, nh = dec.num_gs_seed, dec.channel, dec.num_heads
    m = b * t
    x, g = rnd(b, t, c), rnd(b, t, c)
    blk = dec.gs_selfattn_blocks[0]
    lyr = blk.blocks[0]
    cl = dec.window_crossattn_blocks[0].blocks[0]
    null = "no PyTorch call computes it"
    results = {"MB": [], "AB": [], "T": []}

    # -- MB: (LN, inj, base x+inj), (LN, base x), (no LN, resi) ---------------
    names = ("dx", "dresi", "dinj", "dln_w", "dln_b", "dw1", "db1", "dw2",
             "db2")
    for name, kw, per_step in (
            ("ln_inj", dict(inj=rnd(b, c), **_mlp(lyr.mlp_crossattn),
                            **_ln(lyr.norm4)), 38),
            ("ln", dict(**_mlp(lyr.mlp_selfattn), **_ln(lyr.norm2)), 38),
            ("resi", dict(resi=rnd(b, t, c), **_seq_mlp(blk.mlp)), 7)):
        err = _compare_grads(fl.ln_mlp_residual_bwd(x, g, **kw),
                             fl.ln_mlp_residual_bwd_plain(x, g, **kw), names,
                             f"MB {name}")
        _repeatable(lambda: fl.ln_mlp_residual_bwd(x, g, **kw), f"MB {name}")
        ms = _time_ms(lambda: fl.ln_mlp_residual_bwd(x, g, **kw), 10)
        plain = _time_ms(lambda: fl.ln_mlp_residual_bwd_plain(x, g, **kw),
                         10)
        hid = kw["w1"].shape[0]
        # five products: the recomputed fc1, dw2, dz1, dw1 and dh; bytes: x,
        # g, dx, the weights and their gradients, the vectors
        nbytes = 4 * (3 * m * c + 4 * c * hid + 2 * hid + 2 * c
                      + (2 * b * c if "inj" in kw else 0)
                      + (4 * c if "ln_w" in kw else 0))
        bound, by = _bound_ms(10.0 * m * c * hid, nbytes)
        results["MB"].append(dict(case=name, per_step=per_step,
                                  max_abs_err=err, ms=ms, plain_ms=plain,
                                  bound_ms=bound, bound_by=by,
                                  library_ms=None, library_null_reason=null))

    # -- AB: cross-attention (pos, kv, bias), self-attention (bias) ----------
    names = ("dx", "dpos", "dkv", "dln_w", "dln_b", "dwq", "dbq", "dwk",
             "dbk", "dwv", "dbv", "dwo", "dbo", "dbias")
    for name, kw, per_step in (
            ("cross_pos_kv_bias",
             dict(pos=dec.pos_embedding, kv=rnd(b, t, c),
                  bias=cl.window_cross_attn.bias(),
                  **_attn(cl.window_cross_attn), **_ln(cl.norm3)), 2),
            ("self_bias", dict(bias=lyr.gs_self_attn.bias(),
                               **_attn(lyr.gs_self_attn), **_ln(lyr.norm1)),
             36)):
        # dbk's true value is 0 (softmax ignores a per-query constant)
        err = _compare_grads(
            fl.ln_attn_proj_bwd(x, g, num_heads=nh, **kw),
            fl.ln_attn_proj_bwd_plain(x, g, num_heads=nh, **kw), names,
            f"AB {name}", floor_of={"dbk": "dwk"})
        _repeatable(lambda: fl.ln_attn_proj_bwd(x, g, num_heads=nh, **kw),
                    f"AB {name}")
        ms = _time_ms(lambda: fl.ln_attn_proj_bwd(x, g, num_heads=nh, **kw),
                      10)
        plain = _time_ms(lambda: fl.ln_attn_proj_bwd_plain(
            x, g, num_heads=nh, **kw), 5)
        # eleven products of 2 T C^2 (q, k, v; dwo, datt, dwq, dwk, dwv,
        # dxq, two for dsrc) and six of 2 T^2 C (scores, p v, dp, dv, dq,
        # dk) per window; bytes: x, g, dx (kv, dkv, pos, dpos), the bias and
        # dbias, the weights and their gradients, the vectors
        cross = "kv" in kw
        flops = 2.0 * b * (11 * t * c * c + 6 * t * t * c)
        nbytes = 4 * (3 * m * c + (2 * m * c + 2 * t * c if cross else 0)
                      + 2 * nh * t * t + 8 * c * c + 11 * c)
        bound, by = _bound_ms(flops, nbytes)
        results["AB"].append(dict(case=name, per_step=per_step,
                                  max_abs_err=err, ms=ms, plain_ms=plain,
                                  bound_ms=bound, bound_by=by,
                                  library_ms=None, library_null_reason=null))

    # -- T: the bias-table gradients of both attentions ----------------------
    for name, attn, per_step in (("cross", cl.window_cross_attn, 2),
                                 ("self", lyr.gs_self_attn, 36)):
        inv = attn.relative_position_inverse
        gb = rnd(nh, *attn.relative_position_index.shape)
        err = _compare_grads([bt.bias_table_bwd(gb, inv)],
                             [bt.bias_table_bwd_plain(gb, inv)], ["dtable"],
                             f"T {name}")
        _repeatable(lambda: (bt.bias_table_bwd(gb, inv),), f"T {name}")
        ms = _time_ms(lambda: bt.bias_table_bwd(gb, inv), 20)
        plain = _time_ms(lambda: bt.bias_table_bwd_plain(gb, inv), 20)
        rows = inv.shape[0]
        bound, by = _bound_ms(float(gb.numel()),
                              4 * (gb.numel() + inv.numel() + rows * nh))
        results["T"].append(dict(case=name, per_step=per_step,
                                 max_abs_err=err, ms=ms, plain_ms=plain,
                                 bound_ms=bound, bound_by=by,
                                 library_ms=None, library_null_reason=null))
    for k, rows in results.items():
        for r in rows:
            print(f"  {k} {r['case']}: {r['ms']:.4f} ms (plain "
                  f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} by "
                  f"{r['bound_by']}, library null) x{r['per_step']} per step",
                  flush=True)
    return results


@torch.no_grad()
def swinir_kernel_phase(enc, dev):
    """WM and WMB against their plain versions at SwinIR's inference shape
    (one 192x192 map: 576 windows, each its own mask class) and training
    shape (16 samples of 48x48: 576 windows, mask period 36), WMB twice to
    show the bits repeat; W and WB at T = 64 beside them. The bias is the
    encoder's first shifted block's table."""
    from gsasr_torch.models.swinir import swin_attn_mask
    from gsasr_torch.ops import attention as ta

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(12)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    attn = enc.layers[0].residual_group["blocks"][1].attn
    nh, c, ws = attn.num_heads, attn.proj.in_features, enc.window_size
    t, hd = ws * ws, c // attn.num_heads
    scale = hd ** -0.5
    bias = attn.relative_position_bias_table[
        attn.relative_position_index].permute(2, 0, 1).contiguous()
    results = {"WM": [], "WMB": [], "W": [], "WB": []}
    lr = PAPER_LR_SIZE
    for name, mask, b, per in (
            ("inference 192x192", swin_attn_mask(192, 192, ws, ws // 2, dev),
             (192 // ws) ** 2, dict(per_image=18)),
            ("training 16x48x48", swin_attn_mask(lr, lr, ws, ws // 2, dev),
             PAPER_BATCH * (lr // ws) ** 2, dict(per_step=18))):
        nw = mask.shape[0]
        q, k, v, g = (rnd(b, t, c) for _ in range(4))
        full = (bias[None] + mask.repeat(b // nw, 1, 1)[:, None]).contiguous()
        fargs = (q, k, v, bias, mask, scale, nh)
        err = _compare(ta.window_attention_packed_masked_fwd(*fargs),
                       ta.window_attention_packed_plain(
                           q, k, v, bias, scale, nh, mask), f"WM {name}")
        ms = _time_ms(lambda: ta.window_attention_packed_masked_fwd(*fargs),
                      20)
        plain = _time_ms(lambda: ta.window_attention_packed_plain(
            q, k, v, bias, scale, nh, mask), 10)
        lib_f, lib_b, why = _sdpa_ms(q, k, v, full, g, nh, scale)
        act = 4 * b * t * c
        bound, by = _bound_ms(4.0 * b * nh * t * t * hd,
                              4 * act + 4 * (nh + nw) * t * t)
        results["WM"].append(dict(case=name, nW=nw, windows=b,
                                  max_abs_err=err, ms=ms, plain_ms=plain,
                                  bound_ms=bound, bound_by=by,
                                  library_ms=lib_f, **per))
        bargs = (q, k, v, bias, mask, g, scale, nh)
        outs = ta.window_attention_packed_masked_bwd(*bargs)
        refs = ta.window_attention_packed_bwd_plain(q, k, v, bias, g, scale,
                                                    nh, mask)
        err = _compare_grads(outs, refs, ("dq", "dk", "dv", "dbias"),
                             f"WMB {name}")
        _repeatable(lambda: ta.window_attention_packed_masked_bwd(*bargs),
                    f"WMB {name}")
        ms = _time_ms(lambda: ta.window_attention_packed_masked_bwd(*bargs),
                      10)
        plain = _time_ms(lambda: ta.window_attention_packed_bwd_plain(
            q, k, v, bias, g, scale, nh, mask), 5)
        if why:
            print(f"  WMB {name} library: null ({why})", flush=True)
        # five products; bytes: q, g, dq, k, v, dk, dv, bias, dbias, mask
        bound, by = _bound_ms(10.0 * b * nh * t * t * hd,
                              7 * act + 4 * (2 * nh + nw) * t * t)
        results["WMB"].append(dict(
            case=name, nW=nw, windows=b, max_abs_err=err, ms=ms,
            plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=lib_b,
            library_null_reason=why,
            **({"per_step": 0} if "per_image" in per else per)))
    # W and WB at SwinIR's T = 64 (its unshifted blocks), 576 windows
    fargs = (q, k, v, bias, scale, nh)
    err = _compare(ta.window_attention_packed_fwd(*fargs),
                   ta.window_attention_packed_plain(*fargs), "W T=64")
    ms = _time_ms(lambda: ta.window_attention_packed_fwd(*fargs), 20)
    plain = _time_ms(lambda: ta.window_attention_packed_plain(*fargs), 10)
    lib_f, lib_b, why = _sdpa_ms(q, k, v, bias[None], g, nh, scale)
    bound, by = _bound_ms(4.0 * b * nh * t * t * hd, 4 * act + 4 * nh * t * t)
    results["W"].append(dict(case="swinir T=64", per_image=18, per_step=18,
                             max_abs_err=err, ms=ms, plain_ms=plain,
                             bound_ms=bound, bound_by=by, library_ms=lib_f))
    bargs = (q, k, v, bias, g, scale, nh)
    err = _compare_grads(ta.window_attention_packed_bwd(*bargs),
                         ta.window_attention_packed_bwd_plain(*bargs),
                         ("dq", "dk", "dv", "dbias"), "WB T=64")
    ms = _time_ms(lambda: ta.window_attention_packed_bwd(*bargs), 10)
    plain = _time_ms(lambda: ta.window_attention_packed_bwd_plain(*bargs), 5)
    bound, by = _bound_ms(10.0 * b * nh * t * t * hd,
                          7 * act + 8 * nh * t * t)
    results["WB"].append(dict(case="swinir T=64", per_step=18,
                              max_abs_err=err, ms=ms, plain_ms=plain,
                              bound_ms=bound, bound_by=by, library_ms=lib_b,
                              library_null_reason=why))
    for k, rows in results.items():
        for r in rows:
            lib = "null" if r["library_ms"] is None else \
                f"{r['library_ms']:.4f}"
            print(f"  {k} {r['case']}: {r['ms']:.4f} ms (plain "
                  f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} by "
                  f"{r['bound_by']}, library {lib})", flush=True)
    return results


def _train_run(dev, kernels, b: int, fused: bool, encoder: str):
    from gsasr_torch.model import make_models
    from gsasr_torch.train import TrainConfig, Trainer

    enc, dec = make_models(encoder, "paper",
                           generator=torch.Generator().manual_seed(0))
    tr = Trainer(enc, dec, TrainConfig(**dict(PAPER_TRAIN,
                                              fused_decoder=fused)))
    want = (FUSED_TRAIN_COUNTS if fused else
            SWINIR_TRAIN_COUNTS if encoder == "swinir" else TRAIN_COUNTS)
    label = ("fused" if fused else "module") + (
        "" if encoder == "edsr" else f" {encoder}")
    start = [p.detach().clone() for p in tr.params_g + tr.params_d]
    start_ema = [p.detach().clone() for p in
                 list(tr.ema_g.parameters()) + list(tr.ema_d.parameters())]
    batches = [paper_batch(b, seed=10 + i)
               for i in range(TRAIN_WARMUP + TRAIN_STEPS)]
    steps, grads_ms, apply_ms, losses, counts = [], [], [], [], []
    for i, batch in enumerate(batches):
        if i == len(batches) - 1:
            torch.cuda.reset_peak_memory_stats()
        _reset(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tr.grads(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = tr.apply(*out)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        c = _counts(kernels)
        loss = float(m["loss"])
        print(f"  {label} step {i}: loss {loss:.6f}, {(t2 - t0) * 1e3:.1f} ms,"
              f" launches {c}", flush=True)
        if c != want:
            raise AssertionError(f"training launch counts {c}")
        if not math.isfinite(loss):
            raise AssertionError(f"step {i}: loss {loss}")
        losses.append(loss)
        counts.append(c)
        if i >= TRAIN_WARMUP:
            steps.append((t2 - t0) * 1e3)
            grads_ms.append((t1 - t0) * 1e3)
            apply_ms.append((t2 - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    fwd = _host_ms(lambda: tr.loss_fn(tr.to_device(batches[0])), 3,
                   warmup=1)
    moved = any(not torch.equal(a, p) for a, p in
                zip(start, tr.params_g + tr.params_d))
    ema_moved = any(not torch.equal(a, p) for a, p in zip(
        start_ema, list(tr.ema_g.parameters()) + list(tr.ema_d.parameters())))
    if not (moved and ema_moved):
        raise AssertionError(f"parameters moved {moved}, EMA moved "
                             f"{ema_moved}")
    repeat = _repeat_report(tr, batches[-1], label)
    med = lambda x: float(np.median(x))  # noqa: E731
    res = dict(decoder=label, encoder=encoder, batch=b,
               step_ms_median=med(steps),
               step_ms=steps,
               forward_ms=med(fwd), backward_ms=med(grads_ms) - med(fwd),
               grads_ms=med(grads_ms), optimizer_ema_ms=med(apply_ms),
               peak_mem_bytes=int(peak), losses=losses, launches=counts[-1],
               repeat=repeat, tf32={"cudnn": True, "matmul": False})
    print(f"  {label} training step, batch {b}: median {res['step_ms_median']:.1f} "
          f"ms over {len(steps)} steps (forward {res['forward_ms']:.1f}, "
          f"backward {res['backward_ms']:.1f}, optimizer+EMA "
          f"{res['optimizer_ema_ms']:.1f}); peak {peak / 2**30:.2f} GiB; "
          f"TF32 cudnn on, matmul off (PyTorch defaults)", flush=True)
    return res


def _repeat_report(tr, batch, label):
    """Whether two gradients of one batch from one state are the same bits,
    and which tensors differ. A report, not asserted: besides the port's
    kernels (all deterministic), cuDNN's convolution backward may choose
    algorithms that add in no fixed order."""
    a, b = tr.grads(batch), tr.grads(batch)
    names = ([f"enc.{n}" for n, _ in tr.enc.named_parameters()]
             + [f"dec.{n}" for n, _ in tr.dec.named_parameters()])
    diff = [n for n, x, y in zip(names, a[2] + a[3], b[2] + b[3])
            if not torch.equal(x, y)]
    same_loss = bool(torch.equal(a[0], b[0]))
    shown = ", ".join(diff[:60]) + (f" and {len(diff) - 60} more (all in "
                                    "--json)" if len(diff) > 60 else "")
    print(f"  {label} repeatability: two gradients of one batch from one "
          f"state are {'the same bits' if not diff else 'not the same bits'}"
          f"; loss {'equal' if same_loss else 'differs'}; {len(diff)} of "
          f"{len(names)} tensors differ" + (f": {shown}" if diff else ""),
          flush=True)
    return dict(same_bits=not diff, loss_equal=same_loss, differ=diff,
                tensors=len(names))


def train_phase(dev, kernels, fused: bool, encoder: str = "edsr"):
    """Full-width paper training steps of `encoder` on the module or the
    fused decoder; halves the batch only if it does not fit the card, and
    says so."""
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch default
    torch.backends.cudnn.allow_tf32 = True         # PyTorch default
    b = PAPER_BATCH
    while True:
        try:
            return _train_run(dev, kernels, b, fused, encoder)
        except torch.cuda.OutOfMemoryError:
            if b == 1:
                raise
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  batch {b} does not fit the card: halved to {b // 2}",
              flush=True)
        b //= 2


def train_card_vs_cpu(dev, fused: bool, encoder: str = "edsr"):
    """One tiny training step (tests/test_trainer.py's networks, batch 2;
    or a tiny SwinIR with window 4, so its second block shifts, and no
    DropPath) from the same weights on the card and on the CPU, on the
    module or the fused decoder."""
    from gsasr_torch.models import EDSRNOUP, Fea2GS, SwinIRNOUP
    from gsasr_torch.models.init import init_weights
    from gsasr_torch.train import TrainConfig, Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(7)
    if encoder == "swinir":
        enc = init_weights(SwinIRNOUP(embed_dim=24, depths=(2,),
                                      num_heads=(6,), window_size=4,
                                      num_feat=16, drop_path_rate=0.0), gen)
    else:
        enc = init_weights(EDSRNOUP(num_feat=16, num_block=1), gen)
    dec = init_weights(Fea2GS(inchannel=16, channel=12, num_heads=6,
                              num_crossattn_blocks=1, num_crossattn_layers=2,
                              num_selfattn_blocks=1, num_selfattn_layers=2,
                              num_gs_seed=16, window_size=4), gen)
    cfg = TrainConfig(canvas_hw=(32, 32), warmup_iter=2, milestones=(100,),
                      fused_decoder=fused)
    rng = np.random.default_rng(8)
    scales = (2.0 + 2.0 * rng.random(2)).astype(np.float32)
    gt = np.round(scales * 8).astype(np.int32)
    batch = {"lq": rng.random((2, 8, 8, 3), dtype=np.float32),
             "gt": rng.random((2, 32, 32, 3), dtype=np.float32),
             "scale": scales, "gt_h": gt, "gt_w": gt}
    card = Trainer(copy.deepcopy(enc), copy.deepcopy(dec), cfg)
    cpu = Trainer(enc, dec, cfg, device="cpu")
    out_card, out_cpu = card.grads(batch), cpu.grads(batch)
    l_card, l_cpu = float(out_card[0]), float(out_cpu[0])
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    g_card = [g.cpu() for g in out_card[2] + out_card[3]]
    g_cpu = out_cpu[2] + out_cpu[3]
    # floor: the k biases' true gradient is 0 (softmax ignores a per-query
    # constant); both sides give float32 noise around it
    floor = 1e-7 * max(float(g.abs().max()) for g in g_cpu)
    names = [n for n, _ in card.enc.named_parameters()] + \
        [n for n, _ in card.dec.named_parameters()]
    worst, bad = 0.0, []
    for n, a, r in zip(names, g_card, g_cpu):
        mx, ok = _grad_err(a, r, per_column=False, floor=floor)
        worst = max(worst, mx)
        if not ok:
            bad.append(n)
    card.apply(*out_card)
    cpu.apply(*out_cpu)
    print(f"  tiny {'fused' if fused else 'module'} {encoder} training step "
          f"card vs CPU: loss {l_card:.7f} vs "
          f"{l_cpu:.7f} (rel {rel:.2e}, tol 1e-4); gradients max|d| "
          f"{worst:.3e} over {len(names)} tensors (tol {GRAD_TOL} max|ref| "
          f"+ {GRAD_TOL}|ref| + {floor:.1e})", flush=True)
    if not rel <= 1e-4 or bad:
        raise AssertionError(f"training step: card and CPU disagree {bad}")
    return dict(fused_decoder=fused, encoder=encoder, loss_card=l_card,
                loss_cpu=l_cpu,
                loss_rel=rel, grad_max_abs_err=worst, tensors=len(names))


FORM_KEYS = ("decoder", "case", "dtype", "nW", "windows", "per_image",
             "per_step", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")


def _on_path(rows, per):
    """The rows with launches (`per`: per_image or per_step) on a path."""
    return [r for r in rows if r.get(per)]


def _kernel_entry(name, src, rep, also, launches, path, rows, forms=None):
    """One entry of the {"kernels": [...]} line: each time a mean over
    `rows` weighted by their launches on the path; `forms`, where given,
    listed with their own numbers."""
    wt = [r.get("per_image", r.get("per_step")) for r in rows]
    mean = lambda key: (None if any(r[key] is None for r in rows) else  # noqa: E731
                        sum(r[key] * n for r, n in zip(rows, wt)) / sum(wt))
    entry = {"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches,
             "max_abs_err": max(r["max_abs_err"] for r in rows),
             "ms": mean("ms"), "plain_ms": mean("plain_ms"),
             "bound_ms": mean("bound_ms"), "bound_by": rows[0]["bound_by"],
             "library_ms": mean("library_ms") if "library_ms" in rows[0]
             else None, "path": path}
    if also:
        entry["also_replaces"] = also
    if forms:
        entry["forms"] = [{k: r[k] for k in FORM_KEYS if k in r}
                          for r in forms]
    return entry


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", help="write the details to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    from gsasr_torch.model import make_models
    from gsasr_torch.ops import _build
    from gsasr_torch.ops.attention import (
        window_attention_packed_bwd, window_attention_packed_fwd,
        window_attention_packed_masked_bwd, window_attention_packed_masked_fwd)
    from gsasr_torch.ops.bias_table import bias_table_bwd
    from gsasr_torch.ops.fused_layers import (ln_attn_proj, ln_attn_proj_bwd,
                                              ln_mlp_residual,
                                              ln_mlp_residual_bwd)
    from gsasr_torch.ops.rasterizer import raster_bwd, raster_fwd

    t_start = time.perf_counter()
    card = _nvidia_smi()
    dev = torch.device("cuda")
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    names = list(_build.SIGNATURES)
    _build.build(names)
    build_s = time.perf_counter() - t0
    print(f"built {names} in {build_s:.1f} s", flush=True)
    srcs = list(dict.fromkeys(_build.source_of(n) for n in names))
    ptxas = {n: _build.ptxas_report(n) for n in srcs}
    for n in srcs:
        for line in ptxas[n].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {n}: {line.strip()}", flush=True)

    kernels = {"R": raster_fwd, "M": ln_mlp_residual, "A": ln_attn_proj,
               "W": window_attention_packed_fwd,
               "WB": window_attention_packed_bwd, "RB": raster_bwd,
               "MB": ln_mlp_residual_bwd, "AB": ln_attn_proj_bwd,
               "T": bias_table_bwd, "WM": window_attention_packed_masked_fwd,
               "WMB": window_attention_packed_masked_bwd}
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

    enc_e, dec_e = make_models("edsr", "enhanced",
                               generator=torch.Generator().manual_seed(0))
    print("Enhanced kernel phase", flush=True)
    ekres = enhanced_kernel_phase(dec_e, dev)
    print("Enhanced path phase", flush=True)
    eruns = path_phase(enc_e, dec_e, dev, kernels, label="Enhanced")
    print("Enhanced card vs CPU", flush=True)
    ecvc = [card_vs_cpu(enc_e, dec_e, dev, dt, tol, label="Enhanced")
            for dt, tol in ((torch.float32, CARD_CPU_ATOL),
                            (torch.bfloat16, CARD_CPU_ATOL_BF16))]
    print("Enhanced end to end", flush=True)
    ee2e = [e2e_phase(enc_e, dec_e, dev, dt, label="Enhanced")
            for dt in (torch.bfloat16, torch.float32)]
    del enc_e, dec_e
    print("training kernel phase", flush=True)
    kres.update(train_kernel_phase(enc, dec, dev))
    print("fused training kernel phase", flush=True)
    kres.update(fused_kernel_phase(dec, dev))
    del enc, dec
    gc.collect()
    torch.cuda.empty_cache()
    print("training phase", flush=True)
    train = train_phase(dev, kernels, fused=False)
    gc.collect()
    torch.cuda.empty_cache()
    ftrain = train_phase(dev, kernels, fused=True)
    print(f"  fused vs module step median, batch {ftrain['batch']}: "
          f"{ftrain['step_ms_median']:.1f} vs {train['step_ms_median']:.1f} "
          f"ms; peak {ftrain['peak_mem_bytes'] / 2**30:.2f} vs "
          f"{train['peak_mem_bytes'] / 2**30:.2f} GiB", flush=True)
    print("training card vs CPU", flush=True)
    tcvc = [train_card_vs_cpu(dev, fused) for fused in (False, True)]
    gc.collect()
    torch.cuda.empty_cache()

    enc_s, dec_s = make_models("swinir", "paper",
                               generator=torch.Generator().manual_seed(0))
    print("SwinIR kernel phase", flush=True)
    sres = swinir_kernel_phase(enc_s, dev)
    print("SwinIR path phase", flush=True)
    sruns = path_phase(enc_s, dec_s, dev, kernels, label="SwinIR",
                       denominator=SWINIR_DENOMINATOR,
                       extra=SWINIR_PER_FORWARD)
    print("SwinIR card vs CPU", flush=True)
    scvc = card_vs_cpu(enc_s, dec_s, dev, label="SwinIR",
                       denominator=SWINIR_DENOMINATOR)
    print("SwinIR end to end", flush=True)
    se2e = e2e_phase(enc_s, dec_s, dev, label="SwinIR",
                     denominator=SWINIR_DENOMINATOR)
    del enc_s, dec_s
    gc.collect()
    torch.cuda.empty_cache()
    print("SwinIR training phase", flush=True)
    strain = train_phase(dev, kernels, fused=False, encoder="swinir")
    print("SwinIR training card vs CPU", flush=True)
    stcvc = train_card_vs_cpu(dev, False, encoder="swinir")
    gc.collect()
    torch.cuda.empty_cache()

    enc_r, dec_r = make_models("rdn", "paper",
                               generator=torch.Generator().manual_seed(0))
    print("RDN path phase", flush=True)
    rruns = path_phase(enc_r, dec_r, dev, kernels, label="RDN")
    print("RDN end to end", flush=True)
    re2e = e2e_phase(enc_r, dec_r, dev, label="RDN")
    del enc_r, dec_r

    infer, step = runs[0]["launches"], train["launches"]
    sinfer, sstep = sruns[0]["launches"], strain["launches"]
    fstep, einfer = ftrain["launches"], eruns[0]["launches"]
    enhanced = "sr_forward (Enhanced, bf16 trunk)"
    for k in ("M", "A"):
        for r in kres[k]:
            r.update(dtype="float32", decoder="paper")
        for r in ekres[k]:
            r["decoder"] = "Enhanced"
    # Each kernel: (name, source, replaces, also replaces, launch counts,
    # path, the rows timed on that path, the rows of its other forms and
    # shapes or None). A row's per_image / per_step is its launches on the
    # path of its own run; rows with none are left out of the mean.
    meta = {
        "R": ("raster_fwd", "gsasr_torch/ops/csrc/raster_fwd.cu",
              "gsasr_tpu/ops/rasterizer.py:334",
              ["gsasr_tpu/ops/rasterizer.py:254",
               "gsasr_tpu/ops/rasterizer.py:126"], infer, "sr_forward",
              kres["R"], None),
        "M": ("ln_mlp", "gsasr_torch/ops/csrc/ln_mlp.cu",
              "gsasr_tpu/ops/fused_layers.py:122", [], einfer, enhanced,
              _on_path(ekres["M"], "per_image"), kres["M"] + ekres["M"]),
        "A": ("ln_attn", "gsasr_torch/ops/csrc/ln_attn.cu",
              "gsasr_tpu/ops/fused_layers.py:336", [], einfer, enhanced,
              _on_path(ekres["A"], "per_image"), kres["A"] + ekres["A"]),
        "W": ("window_attn_fwd", "gsasr_torch/ops/csrc/window_attn_fwd.cu",
              "gsasr_tpu/ops/attention.py:338", [], step, "Trainer.step",
              kres["W"], sres["W"]),
        "WB": ("window_attn_bwd", "gsasr_torch/ops/csrc/window_attn_bwd.cu",
               "gsasr_tpu/ops/attention.py:397", [], step, "Trainer.step",
               kres["WB"], sres["WB"]),
        "RB": ("raster_bwd", "gsasr_torch/ops/csrc/raster_bwd.cu",
               "gsasr_tpu/ops/rasterizer.py:232",
               ["gsasr_tpu/ops/rasterizer.py:166",
                "gsasr_tpu/ops/rasterizer.py:308"], step, "Trainer.step",
               kres["RB"], None),
        "MB": ("ln_mlp_bwd", "gsasr_torch/ops/csrc/ln_mlp_bwd.cu",
               "gsasr_tpu/ops/fused_layers.py:146", [], fstep,
               "Trainer.step(fused_decoder=True)", kres["MB"], None),
        "AB": ("ln_attn_bwd", "gsasr_torch/ops/csrc/ln_attn_bwd.cu",
               "gsasr_tpu/ops/fused_layers.py:381", [], fstep,
               "Trainer.step(fused_decoder=True)", kres["AB"], None),
        "T": ("bias_table_bwd", "gsasr_torch/ops/csrc/bias_table_bwd.cu",
              "no Pallas kernel: the gradient of the bias-table gather "
              "(gsasr_tpu/models/fea2gs.py:142,173) is XLA's", [], step,
              "Trainer.step", kres["T"], None),
        "WM": ("window_attn_fwd_masked",
               "gsasr_torch/ops/csrc/window_attn_fwd.cu",
               "gsasr_tpu/ops/attention.py:553", [], sinfer,
               "sr_forward (SwinIR)", _on_path(sres["WM"], "per_image"),
               sres["WM"]),
        "WMB": ("window_attn_bwd_masked",
                "gsasr_torch/ops/csrc/window_attn_bwd.cu",
                "gsasr_tpu/ops/attention.py:661", [], sstep,
                "Trainer.step (SwinIR)", _on_path(sres["WMB"], "per_step"),
                sres["WMB"]),
    }
    line = [_kernel_entry(name, src, rep, also, counts[k], path, rows, forms)
            for k, (name, src, rep, also, counts, path, rows, forms)
            in meta.items()]
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(card=card, torch=torch.__version__,
                           cuda=torch.version.cuda, build_s=build_s,
                           ptxas=ptxas, kernels=kres, paths=runs,
                           card_vs_cpu=cvc, e2e=e2e,
                           enhanced=dict(kernels=ekres, paths=eruns,
                                         card_vs_cpu=ecvc, e2e=ee2e),
                           train=train, train_fused=ftrain,
                           train_card_vs_cpu=tcvc,
                           swinir=dict(kernels=sres, paths=sruns,
                                       card_vs_cpu=scvc, e2e=se2e,
                                       train=strain,
                                       train_card_vs_cpu=stcvc),
                           rdn=dict(paths=rruns, e2e=re2e),
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
