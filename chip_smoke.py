#!/usr/bin/env python3
"""Smoke run of the gsasr_torch port on one CUDA card.

  python3 chip_smoke.py [--json PATH]

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds kernels R, M, A, W, WB, RB, MB, AB and T (and
   their forms: WB-long, MB-bf16, AB-bf16, AB-long, R-exact, W4 and WB4
   among them) from gsasr_torch/ops/csrc, one nvcc per source, in
   parallel.
2. Kernel phase (TF32 off): R, M and A against their plain PyTorch versions
   at the inference path's shapes, each twice for bitwise repeatability,
   with their median times, the plain versions' times and their lower
   bounds on this card (M's and A's products in 3xTF32 at the TF32 peak:
   they run the tensor-core row-tile product of tile_mma.cuh; R's pairs at
   24 FP32 operations), R's time one call and back to back beside the one
   recorded before its redesign (RASTER_MS_RECORDED), ptxas's registers of
   M's and A's kernels beside the FMA kernels' they replace, of MB's and
   AB's tensor-core kernels beside the FMA kernels' they replaced (a
   spill, or an FMA product or attention kernel left in their sources,
   fails the phase), and of R, R-exact and RB beside the recorded ones (a
   kernel that spills fails the phase), and of A's fp32 attention (W's
   3xTF32 body up to 160 tokens, window_attn_short_tf32.cuh) beside
   W-long's, which it ran before; A's times beside the recorded ones.
3. Path phase: make_models("edsr", "paper") with seeded weights, then
   sr_forward on 180x180 x4 (the main shape), 173x151 x3.3 and a batch of
   two 96x96 x2, checking shapes, finiteness and the kernel launch counts.
4. One 48x48 x4 request on the card against the same request on the CPU.
5. End-to-end timing of the main shape with PyTorch's default TF32
   settings, its encoder/decoder/render split, peak memory and the sigma
   percentiles of the rendered Gaussians.
6. Training kernel phase (TF32 off): W, WB, R and RB against their plain
   versions at the paper training step's shapes (256 windows of 144 tokens;
   the 3072x192 slot canvas of 16 samples), WB, R and RB twice for bitwise
   repeatability, with times, bounds (W's and WB's products in 3xTF32 at
   the TF32 peak: they run the 3xTF32 tensor-core bodies
   window_attn_short_tf32.cuh and window_attn_short_tf32_bwd.cuh; R's and
   RB's pairs at 24 and 35 FP32 operations), W's times beside its FMA
   body's and its registers beside the FMA body's 64, R's and RB's times
   beside the recorded ones and the SDPA yardstick for W and WB.
7. Fused training kernel phase (TF32 off): MB and AB against their plain
   versions at the training step's shapes, for each option set the fused
   decoder uses, and T (the bias-table gradient) for both tables; each
   twice for bitwise repeatability, with times beside the ones recorded
   before MB's and AB's tensor-core redesign (FUSED_BWD_MS_RECORDED) and
   bounds (MB's and AB's products in 3xTF32 at the TF32 peak).
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
   channels, 6 heads), each twice for bitwise repeatability, with times
   and bounds.
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
   for bitwise repeatability; W and WB at T = 64; times (W's and WM's
   beside their FMA body's), bounds (in 3xTF32 at the TF32 peak, or the
   bytes), WM's registers beside the FMA body's and the SDPA yardstick
   with the bias and mask as a float mask.
15. SwinIR path phase: make_models("swinir", "paper"), sr_forward with
   denominator 24 on the three requests of phase 3 (18 W and 18 WM more per
   forward than EDSR), a 48x48 request on the card against the CPU, and
   the 180x180 x4 end-to-end timing.
16. SwinIR training: Trainer.step of configs/train_swinir_paper.yml's
   recipe (DropPath 0.1) at batch 16 on the module decoder, as phase 8
   (W 56, WB 56, WM 18, WMB 18, R 1, RB 1, T 74 per step), and a tiny step
   (drop_path_rate 0) on the card against the CPU.
17. RDN: path phase and end-to-end timing of make_models("rdn", "paper").
18. Enhanced training kernel phase (TF32 off): W-bf16 and WB-bf16 (the
   bfloat16 forms of W and WB, on the tensor cores:
   window_attn_short_mma.cuh, window_attn_short_mma_bwd.cuh) against their
   plain versions at the Enhanced training shape (256 windows x 144 tokens
   x 192 channels, 6 heads of 32, no bias), at the bf16 SwinIR step's (576
   windows x 64 tokens x 180 channels, 6 heads of 30, a bias) and at an
   odd shape (Tq 144, Tk 100, a bias), each twice for bitwise
   repeatability; times, bounds, the SDPA yardstick in bf16 and the
   window-16 routing's time (W-long-bf16's and WB-long-bf16's bodies on
   the same operands).
19. Enhanced training: Trainer.step of configs/train_edsr_amp.yml's recipe
   (the networks as build_networks builds them: bf16 compute on fp32
   parameters, the module decoder) at batch 16, as phase 8 (W-bf16 38,
   WB-bf16 38, R 1, RB 1 per step, nothing else), and a tiny bf16 step on
   the card against the CPU.
20. RDN-Enhanced: path phase and end-to-end timing of make_models("rdn",
   "enhanced") (two cross-attention blocks: 88 M and 40 A per forward).
21. SwinIR-Enhanced: path phase and end-to-end timing of
   make_models("swinir", "enhanced") with denominator 16 (18 W, 18 WM, 96
   M and 44 A-long per forward: its decoder takes 256 seeds in windows of
   16).
22. Ultra kernel phase (TF32 off): the window-16 forms W-long (a HAB's
   144 windows x 256 x 256 and an OCAB's 256 x 576, fp32, on the 3xTF32
   tensor-core body window_attn_long_tf32.cuh, its time beside the FMA
   body's as recorded; and W-long-bf16), A-long (RoPE cross- and
   self-attention at T = 256, bf16 and fp32, whose attention is W-long's
   body and whose projections are M's tile product) and M at the Ultra
   decoder's 144 x 256 x 192 (bf16, the path's trunk, and fp32) against
   their plain versions, each twice for bitwise repeatability, with times,
   bounds and SDPA as W-long's yardstick.
23. HAT-L Ultra: make_models("hat", "ultra"), sr_forward with denominator
   16 on the three requests of phase 3 (84 W-long, 64 A-long, 140 M, no
   A, per forward), a 48x48 request on the card against the CPU (bf16
   trunk), and the 180x180 x4 end-to-end timing with its split, peak
   memory and bound.
24. Ultra training kernel phase (TF32 off): W-long-bf16 and WB-long-bf16
   (the bf16 window-16 forms of W and WB, on the tensor cores:
   window_attn_long_mma.cuh, window_attn_long_mma_bwd.cuh) and WB-long
   (fp32, on the tensor cores in 3xTF32: window_attn_long_tf32_bwd.cuh,
   its time beside the FMA body's as PERF.md records it) against their
   plain versions at the Ultra training step's shapes (128 windows x 256 x
   256 and 256 x 576, 6 heads of 32; WB-long-bf16 once more with a bias),
   twice each for bitwise repeatability, with SDPA forward and backward as
   the yardstick, bounds and ptxas's registers; R and RB on the 8-slot
   1024x1024 canvas, beside the recorded times.
25. HAT-L Ultra training: Trainer.step of configs/train_hatl_ultra.yml's
   recipe (written out as ULTRA_TRAIN and enhanced_networks("hat"): bf16
   compute on fp32 parameters, DropPath 0.1) at batch 8 of 64x64 LR,
   scales in [1, 16], canvas 1024: W-long-bf16 148, WB-long-bf16 148, R 1,
   RB 1 per step and nothing else, two gradients of one batch asserted the
   same bits; then 3 steps of the same networks at model_dtype float32
   (W-long 148, WB-long 148; scripts/ab_torch_sources.py --steps times
   them on the FMA backward too); and a tiny bf16 step at window 16 on the
   card against the CPU.
26. HAT-L Ultra in bf16 (make_models("hat", "ultra", dtype=torch.bfloat16),
   the reference's --AMP_test): path phase (84 W-long-bf16, 64 A-long, 140
   M, 1 R per image) and end-to-end timing at 180x180 x4.
27. Enhanced fused training kernel phase (TF32 off): MB in its ln_inj, ln
   and zero_base option sets and AB's RoPE cross-attention (pos, kv, Tk =
   144) and self-attention (with the four RoPE-table gradients), each in
   bf16 and fp32, against their plain versions at the Enhanced training
   shape (256 windows x 144 tokens x 192 channels, 6 heads of 32), twice
   each for bitwise repeatability, with times beside the recorded ones,
   launches per step, bounds (fp32: 3xTF32 at the TF32 peak) and ptxas's
   registers.
28. Enhanced fused training: Trainer.step of configs/train_edsr_amp.yml's
   recipe with fused_decoder=True at batch 16, as phase 8 (M 83, A 38, MB
   83, AB 38, R 1, RB 1 per step, nothing else; two gradients of one batch
   asserted the same bits), 3 steps at model_dtype float32 (the same
   counts), and a tiny fused bf16 step on the card against the CPU.
29. Masked kernel phase (TF32 off): WM-bf16 and WMB-bf16 (the bf16 forms of
   WM and WMB) at SwinIR's training shape (16 x 36 windows of 64 tokens,
   180 channels, 6 heads of 30, mask period 36) and inference shape (576
   windows, period 576); WM-long and WMB-long, fp32 and bf16 (the
   window-16 masked forms; in bf16 the tensor-core bodies with their mask
   flag, in fp32 the 3xTF32 bodies with it, their times beside the FMA
   bodies' as recorded), at the paper HAT's training shape (144
   windows of 256 tokens, period 9) and inference shape (period 144); each
   with the bias of a shifted block's table, against its plain version,
   twice for bitwise repeatability, with times, bounds, SDPA with the bias
   and mask as a float mask, and ptxas's registers: the window-16
   tensor-core bodies' (the fp32 3xTF32 forward and backward among them,
   A-long's projections beside them) beside the recorded ones, and the
   tensor-core bodies up to 160 tokens (a tensor-core body that is missing
   or spills fails the phase).
30. SwinIR at its bf16 recipe: Trainer.step of configs/train_swinir_amp.yml
   (written out as ENHANCED_TRAIN and enhanced_networks("swinir")) at batch
   16, as phase 8 (W-bf16 18, WM-bf16 18, W-long-bf16 44, WB-bf16 18,
   WMB-bf16 18, WB-long-bf16 44, T 36, R 1, RB 1 per step and nothing
   else; two gradients of one batch asserted the same bits), and a tiny
   bf16 step (a shifted, masked block) on the card against the CPU.
31. SwinIR-Enhanced in bf16 (make_models("swinir", "enhanced",
   dtype=torch.bfloat16)): path phase (18 W-bf16, 18 WM-bf16, 44 A-long,
   96 M, 1 R per image) and end-to-end timing at denominator 16.
32. The paper HAT (network_g type HATNOUP: 180 channels, 6 RHAGs of 6
   HABs, window 16, OCAB 256 x 576, with the paper Fea2GS): path phase at
   denominator 48 (24 W-long, 18 WM-long, 83 M, 38 A, 1 R per image), a
   48x48 request on the card against the CPU, end-to-end timing, and
   Trainer.step at the paper recipe, batch 16 (W-long 24, WM-long 18,
   WB-long 24, WMB-long 18, W 38, WB 38, T 80, R 1, RB 1 per step; two
   gradients of one batch asserted the same bits; the step's median beside
   PERF.md's record of it on the FMA backward).
33. The paper HAT in bf16 with the Enhanced decoder (train_swinir_amp.yml
   with network_g HATNOUP): 3 steps (W-long-bf16 68, WM-long-bf16 18,
   WB-long-bf16 68, WMB-long-bf16 18, T 42, R 1, RB 1 per step).
34. AB-long kernel phase (TF32 off): AB-long and AB-long-bf16 (the
   window-16 form of AB) against their plain versions at the Ultra step's
   shapes (128 windows x 256 tokens x 192 channels, 6 heads of 32, the
   recipe decoder's weights and RoPE tables): RoPE cross-attention (pos,
   kv) and self-attention in both types and a bias in fp32, and MB at the
   same shapes in the Ultra decoder's option sets (ln_inj, ln, zero_base)
   in bf16, twice each for bitwise repeatability, with times beside
   the recorded ones, bounds (fp32: 3xTF32 at the TF32 peak) and ptxas's
   registers of AB's and AB-long's attention (WB's tensor-core bodies; a
   spill fails the phase).
35. HAT-L Ultra on the fused decoder: Trainer.step of
   configs/train_hatl_ultra.yml's recipe with fused_decoder=True at batch 8
   (W-long-bf16 84, WB-long-bf16 84, M 140, MB 140, A-long 64, AB-long 64,
   R 1, RB 1 per step and nothing else; two gradients of one batch
   asserted the same bits; beside the module step of phase 25), a report
   of cuBLAS's reduced-precision bf16 reductions (one step's gradients
   with the flag on and off), 3 steps at model_dtype float32 (W-long,
   WB-long, AB-long fp32), and a tiny fused window-16 step on the card
   against the CPU.
36. SwinIR-Enhanced on the fused decoder: 3 steps of
   configs/train_swinir_amp.yml's recipe with fused_decoder=True at batch
   16 (W-bf16 18, WM-bf16 18, WB-bf16 18, WMB-bf16 18, T 36, M 96, MB 96,
   A-long 44, AB-long 44, R 1, RB 1 per step and nothing else).
37. Exact render (TF32 off): gs_render(binning="exact") on
   scripts/bench_exact_render.py's workload (720x720, 518,400 Gaussians,
   dmax 0.1): trained-like boxes launch the list build XB and R-exact once
   and nothing else, init-like ones XB and, as the lists overflow, R once;
   the path runs none of exact_tables' list-building torch ops (a spy and
   the profiler's host ops); the lists' ok, XB against exact_tables
   integer for integer and twice for bits, with its host and device ms,
   the build's ms (sort, pad, XB; and its device time by kernel), the
   path's ms beside binning="auto"'s; R-exact against its plain walk and
   against R on the same Gaussians, twice for bits, with its ms, bound,
   memberships and used chunks; one backward against binning="auto"'s
   gradients.
38. 4D window attention (TF32 off): W4 and WB4 (K14, K14b; bf16 forms and
   the window-16 bodies: in fp32 W's 3xTF32 body up to 160 tokens, W-long's
   beyond, WB's 3xTF32 body up to 160 tokens and WB-long's beyond, their
   times beside the FMA bodies' as recorded, in bf16 the tensor-core
   bodies, all with the head-major flag)
   against their plain versions at the decoder's window (225 and 256
   windows x 6 heads x 144 x 30 fp32, 32 bf16) and HAT's (128 x 6 x 256 x
   32, fp32 and bf16, with and without a bias),
   twice each for bits, beside the packed W and WB on the same operands
   and SDPA; window_attention through autograd once per shape (launches
   asserted); ptxas's registers of the 4D kernels and the packed forms'
   beside the recorded ones.

Every training phase also times Trainer.grads, which runs with cuDNN's
deterministic algorithms, against the same forward and backward under
PyTorch's default cuDNN flags, in turns (the cost of determinism).

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
import re
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
# Kernels R, R-exact and RB in ptxas's report: (source, a substring of the
# kernel's name), and the registers PERF.md records for the forms before
# R's and RB's redesign (the per-chunk walk of R, one thread a Gaussian in
# RB).
RASTER_KERNELS = {"R": ("raster_fwd", "raster_fwd_kernel"),
                  "R-exact": ("raster_fwd", "raster_fwd_exact_kernel"),
                  "RB": ("raster_bwd", "raster_bwd_kernel")}
RASTER_REGS_RECORDED = {"R": 32, "R-exact": 48, "RB": 63}
# The times PERF.md records for those forms of R and RB by canvas
# (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700.00 W): the paper image
# (phase 2), the paper step (phase 6) and the Ultra step (phase 24);
# printed beside this tree's.
RASTER_MS_RECORDED = {("R", "720x720"): 4.9716, ("R", "8192x1024"): 14.6766,
                      ("RB", "3072x192"): 3.1252,
                      ("RB", "8192x1024"): 25.3484}
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
                "AB": 0, "T": 38, "WM": 0, "WMB": 0, "W-bf16": 0,
                "WB-bf16": 0, "W-long": 0, "W-long-bf16": 0, "A-long": 0,
                "WB-long": 0, "WB-long-bf16": 0, "WM-bf16": 0,
                "WMB-bf16": 0, "WM-long": 0, "WMB-long": 0,
                "WM-long-bf16": 0, "WMB-long-bf16": 0, "AB-long": 0,
                "R-exact": 0, "XB": 0, "W4": 0, "W4-bf16": 0, "WB4": 0,
                "WB4-bf16": 0}
FUSED_TRAIN_COUNTS = dict({k: 0 for k in TRAIN_COUNTS}, R=1, M=83, A=38,
                          RB=1, MB=83, AB=38, T=38)
# SwinIR (6 RSTBs of 6 blocks, window 8, shift 4 on odd blocks): per
# forward 18 W (unshifted blocks) and 18 WM (shifted), per step their
# backward too, and 36 more T (its bias tables). configs/
# train_swinir_paper.yml's recipe is PAPER_TRAIN (tests/test_torch_swinir.py
# holds it equal); sr_forward pads to 24.
SWINIR_DENOMINATOR = 24
SWINIR_PER_FORWARD = {"W": 18, "WM": 18}
SWINIR_TRAIN_COUNTS = dict(TRAIN_COUNTS, W=56, WB=56, WM=18, WMB=18, T=74)
# configs/train_edsr_amp.yml (the Enhanced EDSR recipe, GSASRAMPModel:
# bf16 compute on fp32 parameters, no clip) as build_train_config reads it:
# the paper recipe's numbers (tests/test_torch_enhanced_train.py holds them
# equal); its dataset block rounds gt up (round_mode: ceil).
ENHANCED_TRAIN = dict(PAPER_TRAIN)
# Launches per Enhanced step at the bf16 recipe: W-bf16 and WB-bf16 once
# per attention (2 cross + 36 self), R and RB once; RoPE has no bias
# table, so no T.
ENHANCED_TRAIN_COUNTS = dict({k: 0 for k in TRAIN_COUNTS}, R=1, RB=1,
                             **{"W-bf16": 38, "WB-bf16": 38})
# RDN's Enhanced decoder (two cross-attention blocks of two layers): per
# forward 8 + 2 + 72 + 6 M and 4 + 36 A.
RDN_ENHANCED_PER_FORWARD = {"M": 88, "A": 40}
# A tiny bf16 step, card against CPU: tests/test_torch_enhanced_train.py's
# bf16 depth of its decoder (DEC_DEPTH); each network's gradient within
# relative L2 2^-8 times it (the encoder three convs deeper).
ENHANCED_TINY_DEPTH = 17
# HAT-L Ultra (make_models("hat", "ultra"), sr_forward pads to 16): per
# forward W-long once per HAB (12 RHAGs of 6, T = 256) and OCAB (12, 256 x
# 576); the decoder's 4 cross-attention blocks of 4 layers and 8
# self-attention blocks of 6, all at T = 256: A-long 16 + 48, M 4 (2 x 4 +
# 1) + 8 (2 x 6 + 1) = 140, no A.
ULTRA_DENOMINATOR = 16
ULTRA_PER_FORWARD = {"M": 140, "A": 0, "W-long": 84, "A-long": 64}
# SwinIR-Enhanced (make_models("swinir", "enhanced"), padded to 16): SwinIR's
# 18 W and 18 WM at T = 64, and a decoder of 2 cross-attention blocks of 4
# layers and 6 self-attention blocks of 6 at T = 256: A-long 8 + 36, M 2 (2
# x 4 + 1) + 6 (2 x 6 + 1) = 96.
SWINIR_ENHANCED_PER_FORWARD = {"W": 18, "WM": 18, "M": 96, "A": 0,
                               "A-long": 44}
# configs/train_hatl_ultra.yml (HAT-L Ultra, GSASRAMPModel: bf16 compute on
# fp32 parameters, no clip) as build_train_config reads it, and its dataset
# block: 8 samples of 64x64 LR, scales in [1, 16], gt = ceil(64 s), so the
# canvas is 1024x1024 (tests/test_torch_hat_train.py holds them equal).
ULTRA_TRAIN = dict(PAPER_TRAIN, canvas_hw=(1024, 1024))
ULTRA_BATCH = 8
ULTRA_LR_SIZE = 64
ULTRA_SCALES = (1, 16)
# Launches per Ultra step at the bf16 recipe: W-long-bf16 forward and
# WB-long-bf16 backward once per window attention (the encoder's 72 HABs
# and 12 OCABs, the decoder's 16 cross and 48 self layers), R and RB once;
# no T (RoPE has no bias table).
ULTRA_TRAIN_COUNTS = dict({k: 0 for k in TRAIN_COUNTS}, R=1, RB=1,
                          **{"W-long-bf16": 148, "WB-long-bf16": 148})
# The same networks at model_dtype float32: W-long and WB-long instead.
ULTRA_FP32_TRAIN_COUNTS = dict({k: 0 for k in TRAIN_COUNTS}, R=1, RB=1,
                               **{"W-long": 148, "WB-long": 148})
# A bf16 Ultra image (make_models("hat", "ultra", dtype=torch.bfloat16), the
# reference's --AMP_test): the encoder's 84 window attentions in bf16, the
# decoder as ULTRA_PER_FORWARD.
ULTRA_BF16_PER_FORWARD = {"M": 140, "A": 0, "W-long": 0, "W-long-bf16": 84,
                          "A-long": 64}
# Launches per Enhanced step on the fused decoder (train_edsr_amp.yml's
# recipe with fused_decoder=True), in either type: M and MB once per MLP
# chain (38 inject, 38 feature/self FFNs, 7 block tails), A and AB once
# per attention (2 cross + 36 self), R and RB once; no W, WB or T.
ENHANCED_FUSED_TRAIN_COUNTS = dict({k: 0 for k in TRAIN_COUNTS}, M=83, A=38,
                                   MB=83, AB=38, R=1, RB=1)
# The bf16 forms of MB and AB against their plain versions on the card:
# each output within relative L2 distance 2^-7 of the plain version's.
# Both round at the same points but sum their f32 products (and the LN
# statistics) in another order, so a rounded value may sit one bf16 step
# (2^-8) apart; an LN output one step apart moves a pre-activation by
# about 1e-3, which can cross the ReLU's 0 and move a whole entry of dz1,
# so single entries of dx and dw1 move by many steps (the plain version on
# the card against the same on the CPU: 9% of an entry), and no
# elementwise bound holds.
BWD_BF16_TOL = 2.0 ** -7
# configs/train_swinir_amp.yml (SwinIR at the bf16 recipe) trains by
# ENHANCED_TRAIN (its train block is train_edsr_amp.yml's;
# tests/test_torch_swinir_bf16.py holds them equal). Per step: SwinIR's 18
# unshifted blocks W-bf16 (T 64, bias) and 18 shifted WM-bf16, their
# backward, 36 T; the decoder's 2 x 4 cross and 6 x 6 self layers at 256
# seeds in windows of 16, W-long-bf16 and WB-long-bf16 44 each; R, RB.
SWINIR_AMP_TRAIN_COUNTS = dict({k: 0 for k in TRAIN_COUNTS}, R=1, RB=1,
                               T=36, **{"W-bf16": 18, "WM-bf16": 18,
                                        "W-long-bf16": 44, "WB-bf16": 18,
                                        "WMB-bf16": 18,
                                        "WB-long-bf16": 44})
# A bf16 SwinIR-Enhanced image: SwinIR_ENHANCED_PER_FORWARD's encoder
# launches in their bf16 forms.
SWINIR_ENHANCED_BF16_PER_FORWARD = dict(SWINIR_ENHANCED_PER_FORWARD, W=0,
                                        WM=0, **{"W-bf16": 18,
                                                 "WM-bf16": 18})
# The paper HAT (HATNOUPPaper, 6 RHAGs of 6 HABs at window 16): per
# forward its 18 unshifted HABs and 6 OCABs take W-long with a bias (256 x
# 256, 256 x 576), its 18 shifted HABs WM-long; with the paper decoder
# sr_forward pads to 48 = lcm(16, 12). Per step at the paper recipe, their
# backward, T for 42 encoder and 38 decoder tables, and the paper decoder's
# module path (TRAIN_COUNTS).
HAT_PAPER_DENOMINATOR = 48
HAT_PAPER_PER_FORWARD = {"W-long": 24, "WM-long": 18}
HAT_PAPER_TRAIN_COUNTS = dict(TRAIN_COUNTS, T=80, **{
    "W-long": 24, "WM-long": 18, "WB-long": 24, "WMB-long": 18})
# In bf16 with the Enhanced decoder (train_swinir_amp.yml's recipe and
# decoder, network_g HATNOUP): the encoder's 24 and the decoder's 44
# window attentions W-long-bf16, 18 WM-long-bf16, their backward, T 42.
HAT_PAPER_BF16_TRAIN_COUNTS = dict({k: 0 for k in TRAIN_COUNTS}, R=1, RB=1,
                                   T=42, **{"W-long-bf16": 68,
                                            "WM-long-bf16": 18,
                                            "WB-long-bf16": 68,
                                            "WMB-long-bf16": 18})
# HAT-L Ultra's step on the fused decoder (train_hatl_ultra.yml with
# fused_decoder=True): the encoder's 72 HABs and 12 OCABs W-long-bf16 and
# WB-long-bf16; the decoder's 16 cross and 48 self attentions A-long and
# AB-long, its 140 MLP chains (ULTRA_PER_FORWARD's) M and MB; R, RB.
ULTRA_FUSED_TRAIN_COUNTS = dict(
    {k: 0 for k in TRAIN_COUNTS}, R=1, RB=1, M=140, MB=140,
    **{"W-long-bf16": 84, "WB-long-bf16": 84, "A-long": 64, "AB-long": 64})
# The same at model_dtype float32: W-long and WB-long, AB-long in fp32.
ULTRA_FP32_FUSED_TRAIN_COUNTS = dict(
    {k: 0 for k in TRAIN_COUNTS}, R=1, RB=1, M=140, MB=140,
    **{"W-long": 84, "WB-long": 84, "A-long": 64, "AB-long": 64})
# SwinIR at its bf16 recipe on the fused decoder (train_swinir_amp.yml with
# fused_decoder=True): SWINIR_AMP_TRAIN_COUNTS' encoder launches; the
# decoder's 8 cross and 36 self attentions A-long and AB-long, its 96 MLP
# chains M and MB.
SWINIR_FUSED_TRAIN_COUNTS = dict(
    {k: 0 for k in TRAIN_COUNTS}, R=1, RB=1, T=36, M=96, MB=96,
    **{"W-bf16": 18, "WM-bf16": 18, "WB-bf16": 18, "WMB-bf16": 18,
       "A-long": 44, "AB-long": 44})
# ptxas registers of the fp32 window-16 kernels as PERF.md §6 records them
# (the 3xTF32 forward's W-long and WM-long; A-long's projections in both
# types, the tensor-core ln_qkv_kernel of tile_mma.cuh, and its
# fp32 attention, W-long's kernel; the dq and dk/dv launches of WB-long,
# WMB-long and WB4-long, the fp32 backward's 3xTF32 body): the template
# flags of the masked forms and of AB-long, and the forms' moves to other
# bodies, must leave them as they were.
LONG_REGS_RECORDED = {"W-long": (141,), "WM-long": (146,),
                      "A-long": (128, 128, 141),
                      "WB-long": (156, 167), "WMB-long": (152, 168),
                      "WB4-long": (152, 166)}
# The times PERF.md §6 records for the fp32 window attentions on their FMA
# bodies (NVIDIA H100 80GB HBM3 at 700.00 W): the window-16 backward
# (window_attn_long_bwd.cuh) and forward (W-long's, A-long's attention),
# WB and WMB up to 160 tokens (window_attn_bwd.cuh), and W, WM and W4 up to
# 160 tokens (W's FMA forward body; one call each, the last chip_smoke.py
# run before the 3xTF32 body up to 160 tokens), printed beside the 3xTF32
# bodies' by the phases that time them: by (form, case) as the training,
# Ultra, Ultra training, SwinIR, masked and 4D attention phases name their
# rows.
FMA_MS = {("W-long", "HAB 256x256"): 0.826, ("W-long", "OCAB 256x576"): 1.881,
          ("A-long", "rope_cross float32"): 1.630,
          ("A-long", "rope_self float32"): 1.587,
          ("WM-long", "paper HAT training 16x48x48"): 1.092,
          ("WM-long", "paper HAT inference 192x192"): 0.988,
          ("W", "cross"): 0.4100, ("W", "self"): 0.3962,
          ("W", "swinir T=64"): 0.2880,
          ("WM", "inference 192x192"): 0.3501,
          ("WM", "training 16x48x48"): 0.3074,
          ("W4", "decoder window, inference 225x6x144x30 float32"): 0.3924,
          ("W4", "training 256x6x144x30 float32"): 0.4167,
          ("W4", "window 16 128x6x256x32 float32"): 0.7686,
          ("W4", "window 16 128x6x256x32 float32, no bias"): 0.7479,
          ("WB", "swinir T=64"): 0.802,
          ("WMB", "training 16x48x48"): 0.7753,
          ("WMB", "inference 192x192"): 0.7805,
          ("WB4", "training 256x6x144x30 float32"): 1.2235,
          ("WB-long", "HAB and decoder 256x256"): 2.660,
              ("WB-long", "OCAB 256x576"): 6.170,
              ("WMB-long", "paper HAT training 16x48x48"): 4.543,
              ("WMB-long", "paper HAT inference 192x192"): 4.083,
              ("WB4", "window 16 128x6x256x32 float32"): 3.0148,
              ("WB4", "window 16 128x6x256x32 float32, no bias"): 2.6885}
# Kernel A (paper fp32, one call) as the same run timed it with its
# attention on W-long's 3xTF32 body, printed beside this run's by phase 2.
A_MS_RECORDED = {"cross_pos_kv_bias": 0.6366, "self_bias": 0.6686}
# The paper HAT fp32 step on the FMA backward (PERF.md's unprofiled
# median, the same card), printed beside the paper HAT training phase's.
FMA_HAT_PAPER_STEP_MS = 793.2
# ptxas registers of the bf16 window-16 forms' tensor-core bodies
# (window_attn_long_mma.cuh, window_attn_long_mma_bwd.cuh) as PERF.md §6
# records them: the forward's flag pairs (A-long-bf16's attention is
# W-long-bf16's kernel), the backward's dq and dk/dv launches.
MMA_REGS_RECORDED = {"W-long-bf16": (94,), "WM-long-bf16": (96,),
                     "W4-long-bf16": (96,), "WB-long-bf16": (125, 126),
                     "WMB-long-bf16": (128, 128),
                     "WB4-long-bf16": (128, 128)}
# The times PERF.md §6 records for MB, AB and AB-long on their earlier FP32
# FMA design (tile_gemm.cuh's row products, FMA weight gradients and
# attention bodies; a chip_smoke.py run on an NVIDIA H100 80GB HBM3 at
# 700.00 W) by (kernel, case, dtype), printed beside this tree's by phases
# 7, 27 and 34: the paper step's forms (phase 7, fp32), the Enhanced step's
# (phase 27) and AB-long's at the Ultra step's shapes (phase 34).
FUSED_BWD_MS_RECORDED = {
    ("MB", "ln_inj", "paper"): 1.3984, ("MB", "ln", "paper"): 1.3287,
    ("MB", "resi", "paper"): 1.2711,
    ("AB", "cross_pos_kv_bias", "paper"): 4.0530,
    ("AB", "self_bias", "paper"): 4.0461,
    ("MB", "ln_inj", "bfloat16"): 1.7397, ("MB", "ln_inj", "float32"): 1.4169,
    ("MB", "ln", "bfloat16"): 1.6848, ("MB", "ln", "float32"): 1.4279,
    ("MB", "zero_base", "bfloat16"): 1.6549,
    ("MB", "zero_base", "float32"): 1.3844,
    ("AB", "rope_cross", "bfloat16"): 4.9070,
    ("AB", "rope_cross", "float32"): 4.3390,
    ("AB", "rope_self", "bfloat16"): 4.8353,
    ("AB", "rope_self", "float32"): 4.3559,
    ("AB-long", "rope_cross", "bfloat16"): 6.8001,
    ("AB-long", "rope_cross", "float32"): 5.6920,
    ("AB-long", "rope_self", "bfloat16"): 6.6771,
    ("AB-long", "rope_self", "float32"): 5.6714,
    ("AB-long", "rope_self, bias", "float32"): 6.0051}
# The kernels of MB and AB on the tensor cores by ptxas's name key (MB's
# two row-tile launches, AB's row products with the LN backward, the weight
# gradients, AB's recompute; the attention bodies are WB's and W's and
# keep their own keys), and the registers PERF.md §6 records for the FMA
# kernels they replaced, printed beside them.
FUSED_BWD_REG_KEYS = ("ln_fc1_kernel", "ln_mlp_bwd_kernel",
                      "rows_bwd_kernel", "wgrad_mma_kernel", "ln_qkv_kernel")
FUSED_BWD_REGS_FMA = ("row products 80-92 (the fp32 transposed form spilled "
                      "8 bytes), weight gradients 73-128, AB's attention "
                      "99-105, AB-long's 130-179")
# The FMA kernels that no launch of MB, AB or AB-long reaches any more:
# none of them may be compiled into ln_mlp_bwd.cu or ln_attn_bwd.cu.
FUSED_BWD_FMA_KERNELS = ("linear_rows_kernel", "wgrad_partial_kernel",
                         "window_attn_bwd_kernel",
                         "window_attn_bwd_long_q_kernel",
                         "window_attn_bwd_long_kv_kernel")


def _recorded_note(kind, case, dtype):
    """ "; before the redesign t ms" from FUSED_BWD_MS_RECORDED, or "". """
    was = FUSED_BWD_MS_RECORDED.get((kind, case, dtype))
    return f"; before the redesign {was:.4f} ms" if was else ""
# The kernels of M and A (and A-long's projections) by ptxas's name key:
# since the tensor-core row-tile product of tile_mma.cuh, ln_mlp_kernel,
# ln_qkv_kernel and out_proj_kernel, each in fp32 (3xTF32) and bf16; and
# the registers PERF.md §6 records for the FMA kernels they replaced (M
# 113 fp32, 109 bf16; A's per-(window, head) attn_heads_kernel 80; the
# FMA ln_qkv_kernel 114; out_proj_kernel 100-102), printed beside them.
FUSED_REG_KEYS = ("ln_mlp_kernel", "ln_qkv_kernel", "out_proj_kernel")
FUSED_REGS_FMA = {"ln_mlp_kernel": (109, 113), "attn_heads_kernel": (80, 80),
                  "ln_qkv_kernel": (114, 114),
                  "out_proj_kernel": (100, 100, 102)}
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


def _batch_ms(fn, n: int = 10, reps: int = 5) -> float:
    """Device time of one fn() from n calls back to back between two CUDA
    events (the launches queue up, so the host's time to launch them hides
    behind the card's), the median over reps."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / n)
    return float(np.median(ts))


def _compare(out, ref, name):
    err = (out - ref).abs()
    ok = bool((err <= KERNEL_ATOL + KERNEL_RTOL * ref.abs()).all())
    mx = float(err.max())
    print(f"  {name}: max|d| {mx:.3e} (tol {KERNEL_ATOL} + {KERNEL_RTOL}|ref|,"
          f" max|ref| {float(ref.abs().max()):.3f})", flush=True)
    if not ok or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return mx


def _grad_err(out, ref, per_column: bool = True, floor: float = 0.0,
              tol: float = GRAD_TOL):
    """Largest |out - ref| and whether every entry is inside tol (per
    column of the last axis, or of the whole tensor) plus `floor`."""
    r = ref.float().reshape(-1, ref.shape[-1]) if ref.dim() else \
        ref.float().reshape(1, 1)
    o = out.float().reshape(r.shape)
    scale = r.abs().amax(dim=0) if per_column else r.abs().max()
    err = (o - r).abs()
    ok = bool((err <= tol * scale + tol * r.abs() + floor).all())
    return float(err.max()), ok and bool(torch.isfinite(o).all())


def _compare_grad(out, ref, name):
    mx, ok = _grad_err(out, ref)
    print(f"  {name}: max|d| {mx:.3e} (tol {GRAD_TOL} max|ref col| + "
          f"{GRAD_TOL}|ref|, max|ref| {float(ref.abs().max()):.3e})",
          flush=True)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return mx


def _l2_err(out, ref, floor: float = 0.0):
    """Largest |out - ref|, and ||out - ref|| over max(||ref||, floor)."""
    d = out.double() - ref.double()
    return (float(d.abs().max()),
            float(d.norm()) / max(float(ref.double().norm()), floor, 1e-30))


def _compare_grads(outs, refs, names, label, floor_of=None,
                   tol: float = GRAD_TOL, l2: bool = False):
    """_compare_grad over a kernel's outputs: a matrix per column, a vector
    over the whole vector, each output in its reference's type; with l2,
    each output's relative L2 distance instead (the bf16 forms). `floor_of`
    maps an output whose true value is 0 (float32 noise on both sides) to
    the output whose largest entry (with l2: whose norm, scaled to the
    output's size), times tol, is its floor. Returns the largest |out -
    ref|."""
    worst = 0.0
    for o, r, n in zip(outs, refs, names):
        if r is None:
            if o is not None:
                raise AssertionError(f"{label} {n}: output without reference")
            continue
        if o is None or o.dtype != r.dtype:
            raise AssertionError(f"{label} {n}: {o} against a {r.dtype} "
                                 "reference")
        f = refs[names.index(floor_of[n])] if floor_of and n in floor_of \
            else None
        if l2:
            floor = (0.0 if f is None else
                     float(f.double().norm()) * (r.numel() / f.numel()) ** 0.5)
            mx, rel = _l2_err(o, r, floor)
            print(f"  {label} {n}: max|d| {mx:.3e}, relative L2 {rel:.3e} "
                  f"(tol {tol:.3e}; max|ref| {float(r.abs().max()):.3e})",
                  flush=True)
            if not rel <= tol or not bool(torch.isfinite(o).all()):
                raise AssertionError(f"{label} {n}: kernel disagrees with its "
                                     "plain version")
            worst = max(worst, mx)
            continue
        floor = 0.0 if f is None else tol * float(f.abs().max())
        mx, ok = _grad_err(o, r, per_column=r.dim() >= 2, floor=floor,
                           tol=tol)
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
    over their peaks, plus kernels M and A (their operations at the bf16
    peak, or three TF32 products each at the TF32 peak in fp32 (3xTF32): 4
    rows C^2 and 2 B (2 Tq C^2 + 2 Tk C^2 + 2 Tq Tk C) per launch, at the
    decoder's T whether A or A-long runs), a SwinIR
    encoder's W and WM (4 B T^2 C each) and a HAT encoder's (the paper
    HAT's too) W-long and WM-long (4 B Tq Tk C: T^2 in each HAB, ws^2 ows^2
    in each OCAB), at the encoder type's peak. The raster and the glue's
    bytes are not counted."""
    from gsasr_torch.model import pad_to_denominator, sr_forward
    from gsasr_torch.models import HATNOUP, HATNOUPPaper, SwinIRNOUP

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
    kpeak = PEAK_BF16 if dt == torch.bfloat16 else PEAK_TF32 / 3
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
        ms += flops["kernels_W_WM"] / (
            PEAK_BF16 if enc.dtype == torch.bfloat16 else PEAK_FP32) * 1e3
    if isinstance(enc, (HATNOUP, HATNOUPPaper)):
        ew = enc.window_size
        ows = enc.layers[0].residual_group["overlap_attn"].overlap_win_size
        habs = sum(len(layer.residual_group["blocks"])
                   for layer in enc.layers)
        ec = enc.conv_first.out_channels
        flops["kernels_W_long"] = (4.0 * b * (h // ew) * (w // ew) * ew ** 2
                                   * ec * (habs * ew ** 2
                                           + len(enc.layers) * ows ** 2))
        ms += flops["kernels_W_long"] / (
            PEAK_BF16 if enc.dtype == torch.bfloat16 else PEAK_FP32) * 1e3
    return ms, flops


def _bound_ms(flops: float, nbytes: float, peak: float = PEAK_FP32):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


@torch.no_grad()
def image_raster_inputs(enc, dec, lq):
    """Kernel R's arguments for the paper decoder's Gaussians of one
    180x180 image at x4 (dmax 0.1, as `bench.py` renders): (geom, colors,
    bbox, 720, 720)."""
    from gsasr_torch.model import _lat_hw, pad_to_denominator
    from gsasr_torch.models.fea2gs_fast import fea2gs_apply_fused
    from gsasr_torch.rendering import raster_inputs

    padded, _ = pad_to_denominator(lq, 12)
    gs = fea2gs_apply_fused(dec, enc(padded),
                            torch.full((1,), 4.0, device=lq.device))[0]
    sr = (4 * lq.shape[1], 4 * lq.shape[2])
    return (*raster_inputs(sr, gs, 4.0, dmax_mode="fix", dmax=0.1,
                           lat_hw=_lat_hw(dec, *lq.shape[1:3])), *sr)


@torch.no_grad()
def step_raster_inputs(enc, dec, batch, cfg, dev):
    """Kernels R's and RB's arguments for a training batch's slot canvas
    (`Trainer.step`'s render): the decoder's Gaussians of `batch`
    (`paper_batch`) at the recipe `cfg`'s dmax, one slot of
    cfg["canvas_hw"] a sample. Returns (geom, colors, bbox, h, w)."""
    from gsasr_torch.ops import rasterizer as rz
    from gsasr_torch.rendering import training_batch_geometry

    lq = torch.from_numpy(batch["lq"]).to(dev)
    sc = torch.from_numpy(batch["scale"]).to(dev)
    gt_h = torch.from_numpy(batch["gt_h"]).to(dev)
    gs = dec(enc(lq), sc)
    geoms, colors = training_batch_geometry(
        gs, sc, gt_h, gt_h, cfg["canvas_hw"],
        default_step_size=cfg["default_step_size"], if_dmax=cfg["if_dmax"],
        dmax_mode=cfg["dmax_mode"], dmax=cfg["dmax"])
    h, w = len(batch["scale"]) * cfg["canvas_hw"][0], cfg["canvas_hw"][1]
    return (*rz.chunk_geometry(geoms.reshape(-1, rz.GEOM_COLS),
                               colors.reshape(-1, 3), (h, w)), h, w)


# The workloads on which scripts/ab_torch_sources.py times kernels R and
# RB, as the phases that time them build them: the paper image (phase 2),
# the paper step's slot canvas (phase 6), the Ultra step's (phase 24) and
# phase 37's two regimes.
RASTER_WORKLOADS = ("paper image 720x720", "paper step 3072x192",
                    "Ultra step 8192x1024", "exact trained 720x720",
                    "exact init 720x720")


def raster_workload(name, dev):
    """(geom, colors, bbox, h, w) of one of RASTER_WORKLOADS, with seeded
    networks (the paper EDSR-GSASR; the Ultra recipe's HAT-L networks) and
    chip_smoke.py's seeded batches."""
    from gsasr_torch.model import make_models
    from gsasr_torch.ops import rasterizer as rz

    if name.startswith("exact"):
        hw = EXACT_HW
        sigmas, coords, colors = exact_workload(name.split()[1], dev)
        geom = rz.pack_geometry(sigmas, coords, (hw, hw), EXACT_DMAX)
        return (*rz.chunk_geometry(geom, colors, (hw, hw)), hw, hw)
    if name.startswith("Ultra"):
        enc, dec = enhanced_networks("hat")
        batch, cfg = paper_batch(ULTRA_BATCH, seed=16, ultra=True), ULTRA_TRAIN
    else:
        enc, dec = make_models("edsr", "paper",
                               generator=torch.Generator().manual_seed(0))
        batch, cfg = paper_batch(PAPER_BATCH, seed=6), PAPER_TRAIN
    enc, dec = enc.to(dev).eval(), dec.to(dev).eval()
    if name.startswith("paper image"):
        lq = torch.rand(1, 180, 180, 3,
                        generator=torch.Generator().manual_seed(1)).to(dev)
        return image_raster_inputs(enc, dec, lq)
    return step_raster_inputs(enc, dec, batch, cfg, dev)


@torch.no_grad()
def kernel_phase(enc, dec, dev):
    """Each kernel against its plain version at the main path's shapes."""
    from gsasr_torch.models.fea2gs_fast import _attn, _mlp, _seq_mlp
    from gsasr_torch.ops import fused_layers as fl

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
        _repeatable(lambda: (fl.ln_mlp_residual(x, **kw),), f"M {name}")
        ms = _time_ms(lambda: fl.ln_mlp_residual(x, **kw), 20)
        plain = _time_ms(lambda: fl.ln_mlp_residual_plain(x, **kw), 20)
        nbytes = 4 * (b * t * c * (3 if "resi" in kw else 2) + 2 * c * c
                      + (b * c if "inj" in kw else 0))
        # the two products in 3xTF32: three TF32 products each
        bound, by = _bound_ms(3 * 4.0 * b * t * c * c, nbytes, PEAK_TF32)
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
        _repeatable(lambda: (fl.ln_attn_proj(x, num_heads=nh, **kw),),
                    f"A {name}")
        ms = _time_ms(lambda: fl.ln_attn_proj(x, num_heads=nh, **kw), 10)
        plain = _time_ms(lambda: fl.ln_attn_proj_plain(x, num_heads=nh,
                                                       **kw), 10)
        flops = 2.0 * b * (4 * t * c * c + 2 * t * t * c)
        nbytes = 4 * (b * t * c * (3 if "kv" in kw else 2) + 4 * c * c
                      + nh * t * t + (t * c if "pos" in kw else 0))
        # every product in 3xTF32
        bound, by = _bound_ms(3 * flops, nbytes, PEAK_TF32)
        rows.append(dict(case=name, per_image=per_image, max_abs_err=err,
                         ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by))
    results["A"] = rows

    # -- R: the 720x720 render of the decoder's output at these weights ------
    lq = torch.rand(1, 180, 180, 3, generator=g).to(dev)
    geom, colors, bbox, h, w = image_raster_inputs(enc, dec, lq)
    results["R"] = [_raster_rows(geom, colors, bbox, h, w, None, 1,
                                 f"{h}x{w}", per="per_image")["R"]]
    for k in ("M", "A"):
        for r in results[k]:
            was = A_MS_RECORDED.get(r["case"]) if k == "A" else None
            was = "" if was is None else (
                f", with W-long's attention body as recorded {was}")
            print(f"  {k} {r['case']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f},"
                  f" bound {r['bound_ms']:.4f} by {r['bound_by']}{was})",
                  flush=True)
    results["registers"] = fused_registers()
    results["attention_registers"] = short_tf32_registers(["A"])
    results["raster_registers"] = raster_registers()
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
        _repeatable(lambda: (fn(),), f"{kind} {name} {dt}")
        ms = _time_ms(fn, reps)
        plain_ms = _time_ms(plain, reps)
        # bf16 products at the bf16 peak; fp32 in 3xTF32 at the TF32 peak
        bound, by = (_bound_ms(flops, nbytes, PEAK_BF16) if dt == bf16 else
                     _bound_ms(3 * flops, nbytes, PEAK_TF32))
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
    `extra` (the encoder's kernels, or another decoder's M and A counts)."""
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
        want_counts.update(R=b, M=M_PER_FORWARD, A=A_PER_FORWARD)
        want_counts.update(extra or {})
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


def paper_batch(b: int, seed: int, ceil: bool = False, ultra: bool = False):
    """A synthetic batch of the paper recipe: b samples of 48x48 LR, scales
    uniform in [1, 4], gt_h = gt_w = round(scale * 48) (ceil with `ceil`,
    the Enhanced recipe's round_mode), random gt on the 192x192 canvas; or
    of the Ultra recipe (`ultra`): 64x64 LR, scales in [1, 16], gt =
    ceil(64 s) on the 1024x1024 canvas. numpy from a seed."""
    rng = np.random.default_rng(seed)
    lr, lo_hi, cfg = ((ULTRA_LR_SIZE, ULTRA_SCALES, ULTRA_TRAIN) if ultra
                      else (PAPER_LR_SIZE, PAPER_SCALES, PAPER_TRAIN))
    hmax = cfg["canvas_hw"][0]
    scales = rng.uniform(*lo_hi, b).astype(np.float32)
    gt = (np.ceil if ceil or ultra else np.round)(scales * lr).astype(
        np.int32)
    return {"lq": rng.random((b, lr, lr, 3), dtype=np.float32),
            "gt": rng.random((b, hmax, hmax, 3), dtype=np.float32),
            "scale": scales, "gt_h": gt, "gt_w": gt}


def _sdpa_ms(q, k, v, mask, g, nh, scale):
    """Yardsticks for W and WB (WM and WMB, W-bf16 and WB-bf16; with nh
    None, W4 and WB4 on head-major operands): one
    scaled_dot_product_attention call on (B, nh, T, hd) views of the packed
    operands with a float attn_mask (the bias as (1, nh, Tq, Tk), or bias
    and window mask summed to (B, nh, Tq, Tk); none without a bias), and
    its backward through torch.autograd.grad. Returns (fwd ms, bwd ms or
    None, why None)."""
    import torch.nn.functional as F

    def heads(x):
        if nh is None:
            return x
        b, t, c = x.shape
        return x.view(b, t, nh, c // nh).transpose(1, 2)

    qh, kh, vh, gh = heads(q), heads(k), heads(v), heads(g)
    fwd = _time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, scale=scale), 10)
    leaves = [x.detach().requires_grad_() for x in (qh, kh, vh, mask)
              if x is not None]
    try:
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(
                *leaves[:3], attn_mask=None if mask is None else leaves[3],
                scale=scale)
            bwd = _time_ms(lambda: torch.autograd.grad(
                out, leaves, gh, retain_graph=True), 10)
        return fwd, bwd, None
    except RuntimeError as e:
        return fwd, None, f"SDPA gives the mask no gradient: {e}"


@torch.no_grad()
def train_kernel_phase(enc, dec, dev):
    """W, WB, R and RB against their plain versions at the training step's
    shapes (R and RB on the 16-slot 3072x192 canvas of the seeded decoder's
    Gaussians: "R-step", "RB"), twice each for WB, R and RB to show the bits
    repeat."""
    from gsasr_torch.ops import attention as ta

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
        # two products, three TF32 products each on W's 3xTF32 body
        bound, by = _bound_ms(12.0 * b * nh * t * tk * hd,
                              4 * (2 * b * t * c + 2 * b * tk * c
                                   + nh * t * tk), PEAK_TF32)
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
        # five products: the recomputed scores, dp, dv, dq and dk, each
        # three TF32 products on WB's 3xTF32 tensor-core body
        bound, by = _bound_ms(30.0 * b * nh * t * tk * hd,
                              4 * (3 * b * t * c + 4 * b * tk * c
                                   + 2 * nh * t * tk), PEAK_TF32)
        results["WB"].append(dict(case=name, per_step=per_step,
                                  max_abs_err=err, ms=ms, plain_ms=plain,
                                  bound_ms=bound, bound_by=by,
                                  library_ms=lib_b, library_null_reason=why))

    # -- R and RB on the slot canvas of the seeded decoder's Gaussians -------
    geom, col, bbox, h, w = step_raster_inputs(enc, dec, paper_batch(
        PAPER_BATCH, seed=6), PAPER_TRAIN, dev)
    rows = _raster_rows(geom, col, bbox, h, w, rnd(h, w, 3), 1, f"{h}x{w}")
    results["R-step"], results["RB"] = [rows["R"]], [rows["RB"]]
    for k in ("W", "WB"):
        for r in results[k]:
            lib = "null" if r["library_ms"] is None else \
                f"{r['library_ms']:.4f}"
            fma = FMA_MS.get((k, r["case"]))
            was = "" if fma is None else f", FMA body as recorded {fma}"
            print(f"  {k} {r['case']}: {r['ms']:.4f} ms (plain "
                  f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} by "
                  f"{r['bound_by']}, library {lib}{was}) x{r['per_step']} "
                  f"per step", flush=True)
    results["registers"] = short_tf32_registers(["W"])
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
        # in 3xTF32: three TF32 products each, at the TF32 peak
        bound, by = _bound_ms(3 * 10.0 * m * c * hid, nbytes, PEAK_TF32)
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
        bound, by = _bound_ms(3 * flops, nbytes, PEAK_TF32)
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
                  f"{r['bound_by']}, library null) x{r['per_step']} per step"
                  + _recorded_note(k, r["case"], "paper"), flush=True)
    return results


@torch.no_grad()
def swinir_kernel_phase(enc, dev):
    """WM and WMB against their plain versions at SwinIR's inference shape
    (one 192x192 map: 576 windows, each its own mask class) and training
    shape (16 samples of 48x48: 576 windows, mask period 36), WMB twice to
    show the bits repeat; W and WB at T = 64 beside them (WB and WMB on the
    3xTF32 tensor-core body up to 160 tokens, bound by their products in
    3xTF32 at the TF32 peak or the bytes, their times beside the FMA body's
    as recorded; W and WM likewise on the 3xTF32 forward body, with its
    registers). The bias is the encoder's first shifted block's table."""
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
        # two products in 3xTF32 (WM's tensor-core body)
        bound, by = _bound_ms(12.0 * b * nh * t * t * hd,
                              4 * act + 4 * (nh + nw) * t * t, PEAK_TF32)
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
        # five products, three TF32 products each on the 3xTF32 body;
        # bytes: q, g, dq, k, v, dk, dv, bias, dbias, mask
        bound, by = _bound_ms(30.0 * b * nh * t * t * hd,
                              7 * act + 4 * (2 * nh + nw) * t * t, PEAK_TF32)
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
    bound, by = _bound_ms(12.0 * b * nh * t * t * hd,
                          4 * act + 4 * nh * t * t, PEAK_TF32)
    results["W"].append(dict(case="swinir T=64", per_image=18, per_step=18,
                             max_abs_err=err, ms=ms, plain_ms=plain,
                             bound_ms=bound, bound_by=by, library_ms=lib_f))
    bargs = (q, k, v, bias, g, scale, nh)
    err = _compare_grads(ta.window_attention_packed_bwd(*bargs),
                         ta.window_attention_packed_bwd_plain(*bargs),
                         ("dq", "dk", "dv", "dbias"), "WB T=64")
    ms = _time_ms(lambda: ta.window_attention_packed_bwd(*bargs), 10)
    plain = _time_ms(lambda: ta.window_attention_packed_bwd_plain(*bargs), 5)
    bound, by = _bound_ms(30.0 * b * nh * t * t * hd,
                          7 * act + 8 * nh * t * t, PEAK_TF32)
    results["WB"].append(dict(case="swinir T=64", per_step=18,
                              max_abs_err=err, ms=ms, plain_ms=plain,
                              bound_ms=bound, bound_by=by, library_ms=lib_b,
                              library_null_reason=why))
    for k, rows in results.items():
        for r in rows:
            lib = "null" if r["library_ms"] is None else \
                f"{r['library_ms']:.4f}"
            fma = FMA_MS.get((k, r["case"]))
            was = "" if fma is None else f", FMA body as recorded {fma}"
            print(f"  {k} {r['case']}: {r['ms']:.4f} ms (plain "
                  f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} by "
                  f"{r['bound_by']}, library {lib}{was})", flush=True)
    results["registers"] = short_tf32_registers(["WM"])
    return results


@torch.no_grad()
def enhanced_train_kernel_phase(dec, dev):
    """W-bf16 and WB-bf16 (the tensor-core bodies up to 160 tokens) against
    their plain versions at the Enhanced training step's shape (16 samples
    of 48x48: 256 windows of 144 tokens, 192 channels, 6 heads of 32, no
    bias: the RoPE attentions, 38 of each per step), at the bf16 SwinIR
    step's (16 samples of 48x48 in windows of 8: 576 windows of 64 tokens,
    180 channels, 6 heads of 30, a bias: 18 of each per step) and at an odd
    shape (Tq 144 against Tk 100, with a bias, as the paper's bf16 module
    path would take it), WB-bf16 twice to show the bits repeat; times,
    bounds (bf16 bytes, bf16 tensor-core peak), SDPA in bf16 as the
    yardstick, and beside each the window-16 routing's time (the same
    operands through W-long-bf16's and WB-long-bf16's bodies)."""
    from gsasr_torch.ops import attention as ta

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(13)
    bf16 = torch.bfloat16
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    t, c, nh = dec.num_gs_seed, dec.channel, dec.num_heads
    b = PAPER_BATCH * (PAPER_LR_SIZE // dec.window_size) ** 2
    sw = PAPER_BATCH * (PAPER_LR_SIZE // 8) ** 2
    results = {"W-bf16": [], "WB-bf16": []}
    # (case, windows, Tq, Tk, C, heads, bias, per Enhanced step, per bf16
    # SwinIR step)
    for name, bw, tq, tk, cc, nhh, has_bias, per_step, per_swinir in (
            ("training", b, t, dec.window_size ** 2, c, nh, False, 38, 0),
            ("SwinIR step: T 64, bias", sw, 64, 64, 180, 6, True, 0, 18),
            ("odd: Tk 100, bias", 64, t, 100, c, nh, True, 0, 0)):
        hd = cc // nhh
        scale = hd ** -0.5
        q, g = rnd(bw, tq, cc).to(bf16), rnd(bw, tq, cc).to(bf16)
        k, v = rnd(bw, tk, cc).to(bf16), rnd(bw, tk, cc).to(bf16)
        bias = 0.5 * rnd(nhh, tq, tk) if has_bias else None
        nbias = 0 if bias is None else 4 * nhh * tq * tk
        fargs = (q, k, v, bias, scale, nhh)
        err = _compare_bf16(ta.window_attention_packed_bf16_fwd(*fargs),
                            ta.window_attention_packed_plain(*fargs),
                            f"W-bf16 {name}")
        _repeatable(lambda: (ta.window_attention_packed_bf16_fwd(*fargs),),
                    f"W-bf16 {name}")
        ms = _time_ms(lambda: ta.window_attention_packed_bf16_fwd(*fargs), 20)
        w16 = _time_ms(lambda: ta._fwd(q, k, v, bias, None, scale, nhh, bf16,
                                       True), 20)
        plain = _time_ms(lambda: ta.window_attention_packed_plain(*fargs), 10)
        lib_f, lib_b, why = _sdpa_ms(
            q, k, v, None if bias is None else bias.to(bf16)[None], g, nhh,
            scale)
        # bytes: q, k, v, out in bf16 (and the f32 bias)
        bound, by = _bound_ms(4.0 * bw * nhh * tq * tk * hd,
                              2 * (2 * bw * tq * cc + 2 * bw * tk * cc)
                              + nbias, PEAK_BF16)
        results["W-bf16"].append(dict(
            case=name, dtype="bfloat16", windows=bw, tokens=tq,
            per_step=per_step, per_swinir_step=per_swinir, max_abs_err=err,
            ms=ms, window16_ms=w16, plain_ms=plain, bound_ms=bound,
            bound_by=by, library_ms=lib_f))
        bargs = (q, k, v, bias, g, scale, nhh)
        outs = ta.window_attention_packed_bf16_bwd(*bargs)
        refs = ta.window_attention_packed_bwd_plain(*bargs)
        err = max(_compare_bf16(o, r, f"WB-bf16 {name} {n}")
                  for o, r, n in zip(outs[:3], refs[:3], ("dq", "dk", "dv")))
        if bias is not None:
            err = max(err, _compare_grad(outs[3], refs[3],
                                         f"WB-bf16 {name} dbias"))
        _repeatable(lambda: ta.window_attention_packed_bf16_bwd(*bargs),
                    f"WB-bf16 {name}")
        ms = _time_ms(lambda: ta.window_attention_packed_bf16_bwd(*bargs), 10)
        w16 = _time_ms(lambda: ta._bwd(q, k, v, bias, None, g, scale, nhh,
                                       bf16, True), 10)
        plain = _time_ms(lambda: ta.window_attention_packed_bwd_plain(
            *bargs), 5)
        if why:
            print(f"  WB-bf16 {name} library: null ({why})", flush=True)
        # five products; bytes: q, g, dq, k, v, dk, dv in bf16 (and the f32
        # bias and dbias)
        bound, by = _bound_ms(10.0 * bw * nhh * tq * tk * hd,
                              2 * (3 * bw * tq * cc + 4 * bw * tk * cc)
                              + 2 * nbias, PEAK_BF16)
        results["WB-bf16"].append(dict(
            case=name, dtype="bfloat16", windows=bw, tokens=tq,
            per_step=per_step, per_swinir_step=per_swinir, max_abs_err=err,
            ms=ms, window16_ms=w16, plain_ms=plain, bound_ms=bound,
            bound_by=by, library_ms=lib_b, library_null_reason=why))
    for k, rows in results.items():
        for r in rows:
            lib = "null" if r["library_ms"] is None else \
                f"{r['library_ms']:.4f}"
            print(f"  {k} {r['case']}: {r['ms']:.4f} ms (window-16 routing "
                  f"{r['window16_ms']:.4f}, plain {r['plain_ms']:.4f}, bound "
                  f"{r['bound_ms']:.4f} by {r['bound_by']}, SDPA bf16 {lib}) "
                  f"x{r['per_step']} per Enhanced step, "
                  f"x{r['per_swinir_step']} per bf16 SwinIR step",
                  flush=True)
    return results


@torch.no_grad()
def enhanced_fused_kernel_phase(dec, dev):
    """MB and AB in the Enhanced fused step's forms against their plain
    versions at its shapes (16 samples of 48x48: 256 windows of 144
    tokens, 192 channels, 6 heads of 32), with the recipe decoder's weights
    and RoPE tables: MB in its ln_inj, ln and zero_base option sets, AB's
    RoPE cross-attention (pos, kv, Tk = 144) and self-attention (the four
    table gradients among the outputs), each in bf16 and fp32; each twice
    for bitwise repeatability, with times, bounds (bf16: bytes against the
    tensor-core peak) and ptxas's registers. per_step: launches per step of
    the bf16 recipe on the fused decoder (fp32 rows: its model_dtype
    float32 step's)."""
    from gsasr_torch.models.fea2gs_fast import _attn, _ln, _mlp, _seq_mlp
    from gsasr_torch.models.fea2gs_rope_fast import rope_tables
    from gsasr_torch.ops import _build
    from gsasr_torch.ops import fused_layers as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(19)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    f32, bf16 = torch.float32, torch.bfloat16
    b = PAPER_BATCH * (PAPER_LR_SIZE // dec.window_size) ** 2
    t, c, nh, ws = dec.num_gs_seed, dec.channel, dec.num_heads, \
        dec.window_size
    m = b * t
    blk = dec.gs_selfattn_blocks[0]
    lyr = blk.blocks[0]
    cl = dec.window_crossattn_blocks[0].blocks[0]
    scale_emb = dec.scale_mlp(torch.full((1, 1), 0.25, device=dev))
    inj = lyr.gs_cross_attn_scale(scale_emb).expand(b, c).contiguous()
    null = "no PyTorch call computes it"
    regs = {}
    for src in ("ln_mlp_bwd", "ln_attn_bwd"):
        regs.update(_ptxas_kernels(_build.ptxas_report(src), ""))
    results = {"MB": [], "AB": []}

    def row(kind, name, dt, per_step, fn, plain, names, flops, nbytes,
            floor_of=None):
        label = f"{kind} {name} {str(dt).replace('torch.', '')}"
        outs, refs = fn(), plain()
        err = _compare_grads(outs, refs, names, label, floor_of,
                             BWD_BF16_TOL if dt == bf16 else GRAD_TOL,
                             l2=dt == bf16)
        _repeatable(fn, label)
        ms = _time_ms(fn, 10)
        plain_ms = _time_ms(plain, 3)
        # fp32: three TF32 products a product (3xTF32) at the TF32 peak
        bound, by = (_bound_ms(flops, nbytes, PEAK_BF16) if dt == bf16 else
                     _bound_ms(3 * flops, nbytes, PEAK_TF32))
        results[kind].append(dict(
            case=name, dtype=str(dt).replace("torch.", ""),
            decoder="Enhanced", windows=b, per_step=per_step,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=None, library_null_reason=null))

    # -- MB: the inject and FFN chains, the block tails (zero_base) ---------
    names = ("dx", "dresi", "dinj", "dln_w", "dln_b", "dw1", "db1", "dw2",
             "db2")
    for name, kw, per_step in (
            ("ln_inj", dict(inj=inj, **_ln(lyr.norm4),
                            **_mlp(lyr.mlp_crossattn)), 38),
            ("ln", dict(**_ln(lyr.norm2), **_mlp(lyr.mlp_selfattn)), 38),
            ("zero_base", dict(zero_base=True, **_seq_mlp(blk.mlp)), 7)):
        for dt in (bf16, f32):
            x, g = rnd(b, t, c).to(dt), rnd(b, t, c).to(dt)
            kwd = dict(kw, inj=inj.to(dt)) if "inj" in kw else kw
            act = 2 if dt == bf16 else 4
            hid = kw["w1"].shape[0]
            # five products: the recomputed fc1, dw2, dz1, dw1 and dh;
            # bytes: x, g, dx (inj, dinj), the weights and their gradients,
            # the vectors
            nbytes = (act * (3 * m * c + (2 * b * c if "inj" in kw else 0))
                      + 4 * (4 * c * hid + 2 * hid + 2 * c
                             + (4 * c if "ln_w" in kw else 0)))
            row("MB", name, dt, per_step if dt == bf16 else 0,
                lambda: fl.ln_mlp_residual_bwd(x, g, **kwd),
                lambda: fl.ln_mlp_residual_bwd_plain(x, g, **kwd), names,
                10.0 * m * c * hid, nbytes)

    # -- AB: RoPE cross-attention (pos, kv) and self-attention ---------------
    nsq = math.isqrt(t)
    cc, sc = rope_tables(cl.window_cross_attn.rope_freqs, max(nsq, ws),
                         max(t, ws * ws))
    cs, ss = rope_tables(lyr.gs_self_attn.rope_freqs, nsq, t)
    names = ("dx", "dpos", "dkv", "dln_w", "dln_b", "dwq", "dbq", "dwk",
             "dbk", "dwv", "dbv", "dwo", "dbo", "dbias", "dcos_q", "dsin_q",
             "dcos_k", "dsin_k")
    for name, kw, per_step in (
            ("rope_cross", dict(pos=dec.pos_embedding, kv=rnd(b, ws * ws, c),
                                rope_cos_q=cc[:t], rope_sin_q=sc[:t],
                                rope_cos_k=cc[:ws * ws],
                                rope_sin_k=sc[:ws * ws],
                                **_attn(cl.window_cross_attn),
                                **_ln(cl.norm3)), 2),
            ("rope_self", dict(rope_cos_q=cs, rope_sin_q=ss, rope_cos_k=cs,
                               rope_sin_k=ss, **_attn(lyr.gs_self_attn),
                               **_ln(lyr.norm1)), 36)):
        for dt in (bf16, f32):
            x, g = rnd(b, t, c).to(dt), rnd(b, t, c).to(dt)
            kwd = dict(kw, num_heads=nh)
            if "kv" in kw:
                kwd.update(pos=kw["pos"].to(dt), kv=kw["kv"].to(dt))
            act = 2 if dt == bf16 else 4
            tk = ws * ws if "kv" in kw else t
            # eleven products of 2 T C^2 and six of 2 T^2 C per window (as
            # the paper form); bytes: x, g, dx (kv, dkv, pos, dpos) in the
            # activation type, the four tables and their gradients, the
            # weights and their gradients, the vectors
            flops = 2.0 * b * (11 * t * c * c + 6 * t * tk * c)
            nbytes = (act * (3 * m * c + (2 * b * tk * c + 2 * t * c
                                          if "kv" in kw else 0))
                      + 4 * (4 * (t + tk) * c + 8 * c * c + 11 * c))
            row("AB", name, dt, per_step if dt == bf16 else 0,
                lambda: fl.ln_attn_proj_bwd(x, g, **kwd),
                lambda: fl.ln_attn_proj_bwd_plain(x, g, **kwd), names, flops,
                nbytes, floor_of={"dbk": "dwk"})
    for k, rows in results.items():
        for r in rows:
            print(f"  {k} {r['case']} {r['dtype']}: {r['ms']:.4f} ms (plain "
                  f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} by "
                  f"{r['bound_by']}, library null) x{r['per_step']} per "
                  f"Enhanced fused step"
                  + _recorded_note(k, r["case"], r["dtype"]), flush=True)
    for name, (r_, st, ld) in sorted(regs.items()):
        print(f"  ptxas {name}: {r_} registers, {st}/{ld} bytes spilled",
              flush=True)
    results["registers"] = regs
    return results


def enhanced_networks(encoder: str = "edsr", dtype=torch.bfloat16):
    """The bf16 recipe's networks as gsasr_torch.config.build_networks
    builds them from configs/train_<encoder>_amp.yml, or for "hat" from
    configs/train_hatl_ultra.yml (written out: the card has no PyYAML;
    tests/test_torch_enhanced_train.py, tests/test_torch_hat_train.py and
    tests/test_torch_swinir_bf16.py hold them equal): EDSR, RDN, SwinIR or
    HAT-L and Fea2GSRopeAMP (RDN's with two cross-attention blocks,
    SwinIR's at 256 seeds in windows of 16, HAT-L's the Ultra decoder),
    bf16 compute on fp32 parameters (`dtype` float32: model_dtype float32),
    every weight from a generator seeded with the recipe's manual_seed 0.
    On the CPU, in training mode."""
    from gsasr_torch.model import ENHANCED_CFG
    from gsasr_torch.models import (EDSRNOUP, HATNOUP, RDNNOUP,
                                    Fea2GSRopeAMP, SwinIRNOUP)
    from gsasr_torch.models.init import init_weights

    g = torch.Generator().manual_seed(0)
    encoders = {"edsr": EDSRNOUP, "rdn": RDNNOUP, "hat": HATNOUP,
                "swinir": SwinIRNOUP}
    with torch.random.fork_rng(devices=[]):
        enc = encoders[encoder](dtype=dtype)
        dec = Fea2GSRopeAMP(**(ENHANCED_CFG[encoder]
                               if encoder in ("hat", "swinir") else
                               dict(num_crossattn_blocks=2 if encoder ==
                                    "rdn" else 1)), dtype=dtype)
    return init_weights(enc, g), init_weights(dec, g)


def hat_paper_networks(dtype=torch.float32):
    """The paper HAT's networks as build_networks builds them with network_g
    {type: HATNOUP}: in float32 from configs/train_swinir_paper.yml (the
    paper Fea2GS), in bfloat16 from configs/train_swinir_amp.yml (the
    Enhanced decoder at 256 seeds in windows of 16), every weight from a
    generator seeded with manual_seed 0 (tests/test_torch_hat_paper.py
    holds them equal). On the CPU, in training mode."""
    from gsasr_torch.model import ENHANCED_CFG
    from gsasr_torch.models import Fea2GS, Fea2GSRopeAMP, HATNOUPPaper
    from gsasr_torch.models.init import init_weights

    g = torch.Generator().manual_seed(0)
    with torch.random.fork_rng(devices=[]):
        enc = HATNOUPPaper(dtype=dtype)
        dec = (Fea2GS() if dtype == torch.float32 else
               Fea2GSRopeAMP(**ENHANCED_CFG["swinir"], dtype=dtype))
    return init_weights(enc, g), init_weights(dec, g)


def _determinism_cost(tr, batch, turns: int = 3):
    """Host ms of Trainer.grads (cuDNN's deterministic algorithms) against
    the same forward and backward under the process's cuDNN flags
    (PyTorch's defaults: not deterministic), `turns` each, in turns."""
    def pinned():
        tr.grads(batch)

    def default():
        loss, _ = tr.loss_fn(tr.to_device(batch))
        torch.autograd.grad(loss, tr.params_g + tr.params_d,
                            allow_unused=True)

    times = {"deterministic": [], "default": []}
    for key in ("deterministic", "default", "default", "deterministic",
                "deterministic", "default")[:2 * turns]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (pinned if key == "deterministic" else default)()
        torch.cuda.synchronize()
        times[key].append((time.perf_counter() - t0) * 1e3)
    med = {k: float(np.median(v)) for k, v in times.items()}
    return dict(grads_ms=times, grads_ms_median=med,
                cost_ms=med["deterministic"] - med["default"])


def _train_run(dev, kernels, b: int, fused: bool, encoder: str,
               enhanced=None, ultra=None):
    """`ultra` (a dtype): configs/train_hatl_ultra.yml's networks and
    recipe, bf16 (the recipe's; its repeatability asserted, its costly
    reports run once; on the fused decoder also the report of cuBLAS's
    reduced-precision bf16 reductions) or float32 (model_dtype float32: 1
    warm-up and 2 timed steps, no reports). `enhanced` (a dtype): configs/
    train_<encoder>_amp.yml's networks and recipe, bf16 (the recipe's; on
    the fused decoder, and for SwinIR, its repeatability asserted; SwinIR
    on the fused decoder 1 warm-up and 2 timed steps, no reports) or
    float32 (model_dtype float32: 1 warm-up and 2 timed steps, no reports).
    encoder "hat_paper": the paper HAT with the paper recipe (its
    repeatability asserted), or with `enhanced` bf16 train_swinir_amp.yml's
    recipe and decoder (1 warm-up and 2 timed steps, no reports)."""
    from gsasr_torch.model import make_models
    from gsasr_torch.train import TrainConfig, Trainer

    warmup, steps = TRAIN_WARMUP, TRAIN_STEPS
    short = torch.float32 in (ultra, enhanced) or (
        encoder == "hat_paper" and enhanced is not None) or (
        encoder == "swinir" and enhanced is not None and fused)
    if short:
        warmup, steps = 1, 2
    if ultra is not None:
        enc, dec = enhanced_networks("hat", ultra)
        cfg = ULTRA_TRAIN
    elif encoder == "hat_paper":
        enc, dec = hat_paper_networks(enhanced or torch.float32)
        cfg = PAPER_TRAIN if enhanced is None else ENHANCED_TRAIN
    elif enhanced is not None:
        enc, dec = enhanced_networks(encoder, enhanced)
        cfg = ENHANCED_TRAIN
    else:
        enc, dec = make_models(encoder, "paper",
                               generator=torch.Generator().manual_seed(0))
        cfg = PAPER_TRAIN
    tr = Trainer(enc, dec, TrainConfig(**dict(cfg, fused_decoder=fused)))
    want = (ULTRA_FUSED_TRAIN_COUNTS if ultra == torch.bfloat16 and fused
            else ULTRA_FP32_FUSED_TRAIN_COUNTS if ultra == torch.float32
            and fused else
            ULTRA_TRAIN_COUNTS if ultra == torch.bfloat16 else
            ULTRA_FP32_TRAIN_COUNTS if ultra == torch.float32 else
            HAT_PAPER_BF16_TRAIN_COUNTS if encoder == "hat_paper" and enhanced
            else HAT_PAPER_TRAIN_COUNTS if encoder == "hat_paper" else
            SWINIR_FUSED_TRAIN_COUNTS if enhanced and fused
            and encoder == "swinir" else
            ENHANCED_FUSED_TRAIN_COUNTS if enhanced and fused else
            SWINIR_AMP_TRAIN_COUNTS if enhanced and encoder == "swinir" else
            ENHANCED_TRAIN_COUNTS if enhanced else
            FUSED_TRAIN_COUNTS if fused else
            SWINIR_TRAIN_COUNTS if encoder == "swinir" else TRAIN_COUNTS)
    dtn = lambda d: str(d).replace("torch.", "").replace(  # noqa: E731
        "bfloat16", "bf16")
    label = (f"HAT-L Ultra {dtn(ultra)}" + (" fused" if fused else "")
             if ultra else (f"Enhanced {dtn(enhanced)} " if enhanced
                            else "") + (
                 "fused" if fused else "module") + (
                 "" if encoder == "edsr" else f" {encoder}"))
    start = [p.detach().clone() for p in tr.params_g + tr.params_d]
    start_ema = [p.detach().clone() for p in
                 list(tr.ema_g.parameters()) + list(tr.ema_d.parameters())]
    batches = [paper_batch(b, seed=10 + i, ceil=enhanced is not None,
                           ultra=ultra is not None)
               for i in range(warmup + steps)]
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
        if i >= warmup:
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
    repeat = det = reduction = None
    if not short:
        repeat = _repeat_report(tr, batches[-1], label)
        if ((ultra is not None or (enhanced and fused)
             or encoder == "hat_paper" or (enhanced and encoder == "swinir"))
                and not repeat["same_bits"]):
            raise AssertionError(f"{label}: two gradients of one batch "
                                 "differ")
        det = _determinism_cost(
            tr, batches[-1],
            turns=1 if ultra is not None or encoder == "hat_paper" else 3)
        print(f"  {label} cost of cuDNN determinism: Trainer.grads median "
              f"{det['grads_ms_median']['deterministic']:.1f} ms against "
              f"{det['grads_ms_median']['default']:.1f} ms under the default "
              f"flags ({det['cost_ms']:+.1f} ms)", flush=True)
        if ultra is not None and fused:
            reduction = _bf16_reduction_report(tr, batches[-1], label)
    med = lambda x: float(np.median(x))  # noqa: E731
    res = dict(decoder=label, encoder=encoder, batch=b,
               step_ms_median=med(steps),
               step_ms=steps,
               forward_ms=med(fwd), backward_ms=med(grads_ms) - med(fwd),
               grads_ms=med(grads_ms), optimizer_ema_ms=med(apply_ms),
               peak_mem_bytes=int(peak), losses=losses, launches=counts[-1],
               repeat=repeat, determinism=det, bf16_reduction=reduction,
               tf32={"cudnn": True, "matmul": False})
    print(f"  {label} training step, batch {b}: median {res['step_ms_median']:.1f} "
          f"ms over {len(steps)} steps (forward {res['forward_ms']:.1f}, "
          f"backward {res['backward_ms']:.1f}, optimizer+EMA "
          f"{res['optimizer_ema_ms']:.1f}); peak {peak / 2**30:.2f} GiB; "
          f"TF32 cudnn on, matmul off (PyTorch defaults)", flush=True)
    return res


def _bf16_reduction_report(tr, batch, label):
    """One batch's gradients with cuBLAS's reduced-precision bf16 reductions
    allowed (PyTorch's default) and not (XLA's f32 accumulation), from one
    state: their relative L2 distance per network. A report: it asserts
    nothing, and the flag is restored as it was."""
    mm = torch.backends.cuda.matmul
    flag = mm.allow_bf16_reduced_precision_reduction
    grads = {}
    try:
        for on in (True, False):
            mm.allow_bf16_reduced_precision_reduction = on
            grads[on] = tr.grads(batch)
    finally:
        mm.allow_bf16_reduced_precision_reduction = flag
    dist = {}
    for i, net in ((2, "encoder"), (3, "decoder")):
        num = sum(float(((a.double() - b.double()) ** 2).sum())
                  for a, b in zip(grads[True][i], grads[False][i]))
        den = sum(float((b.double() ** 2).sum()) for b in grads[False][i])
        dist[net] = math.sqrt(num / den)
    loss_rel = abs(float(grads[True][0]) - float(grads[False][0])) / abs(
        float(grads[False][0]))
    print(f"  {label} cuBLAS reduced-precision bf16 reductions on vs off: "
          f"gradient rel L2 encoder {dist['encoder']:.3e}, decoder "
          f"{dist['decoder']:.3e}; loss rel {loss_rel:.3e} (flag restored "
          f"to {flag})", flush=True)
    return dict(grad_rel_l2=dist, loss_rel=loss_rel, default=flag)


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


def train_phase(dev, kernels, fused: bool, encoder: str = "edsr",
                enhanced=None, ultra=None):
    """Full-width training steps of `encoder` at the paper recipe on the
    module or the fused decoder, at the Enhanced recipe (`enhanced`: the
    networks' type, bfloat16 for the recipe's), or of HAT-L Ultra at
    train_hatl_ultra.yml's recipe in `ultra`'s type; halves the batch only
    if it does not fit the card, and says so."""
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch default
    torch.backends.cudnn.allow_tf32 = True         # PyTorch default
    b = PAPER_BATCH if ultra is None else ULTRA_BATCH
    while True:
        try:
            return _train_run(dev, kernels, b, fused, encoder, enhanced,
                              ultra)
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


def enhanced_train_card_vs_cpu(dev, fused: bool = False,
                               encoder: str = "edsr"):
    """One tiny step of the bf16 recipe (tests/test_trainer.py's bf16
    networks: EDSR 16 x 1, or tests/test_torch_swinir_bf16.py's SwinIR of
    two blocks at window 4, the second shifted and masked; Fea2GSRopeAMP 24
    channels, one layer per block; batch 2) on the module or the fused
    decoder, from the same weights on the card and on the CPU: loss within
    2^-8 relative, each network's gradient within relative L2 2^-8 times
    its bf16 depth (two libraries round the same bf16 values, summed in
    another order, one step apart now and then; the fused path is no
    deeper than the module path). SwinIR's step launches WMB-bf16 once."""
    from gsasr_torch.models import EDSRNOUP, Fea2GSRopeAMP, SwinIRNOUP
    from gsasr_torch.models.init import init_weights
    from gsasr_torch.ops import attention as ta
    from gsasr_torch.train import TrainConfig, Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(17)
    if encoder == "swinir":
        enc = init_weights(SwinIRNOUP(embed_dim=24, depths=(2,),
                                      num_heads=(6,), window_size=4,
                                      num_feat=16, drop_path_rate=0.0,
                                      dtype=bf16), gen)
        enc_depth = ENHANCED_TINY_DEPTH + 29
    else:
        enc = init_weights(EDSRNOUP(num_feat=16, num_block=1, dtype=bf16),
                           gen)
        enc_depth = ENHANCED_TINY_DEPTH + 3
    dec = init_weights(Fea2GSRopeAMP(inchannel=16, channel=24, num_heads=6,
                                     num_crossattn_blocks=1,
                                     num_crossattn_layers=1,
                                     num_selfattn_blocks=1,
                                     num_selfattn_layers=1, num_gs_seed=16,
                                     window_size=4, dtype=bf16), gen)
    cfg = TrainConfig(canvas_hw=(32, 32), warmup_iter=-1, milestones=(100,),
                      clip_grad_norm=None, fused_decoder=fused)
    rng = np.random.default_rng(18)
    scales = (2.0 + 2.0 * rng.random(2)).astype(np.float32)
    gt = np.ceil(scales * 8).astype(np.int32)
    batch = {"lq": rng.random((2, 8, 8, 3), dtype=np.float32),
             "gt": rng.random((2, 32, 32, 3), dtype=np.float32),
             "scale": scales, "gt_h": gt, "gt_w": gt}
    card = Trainer(copy.deepcopy(enc), copy.deepcopy(dec), cfg)
    cpu = Trainer(enc, dec, cfg, device="cpu")
    n = ta.window_attention_packed_masked_bf16_bwd.launches
    out_card = card.grads(batch)
    torch.cuda.synchronize()
    launched = ta.window_attention_packed_masked_bf16_bwd.launches - n
    if launched != (1 if encoder == "swinir" else 0):
        raise AssertionError(f"tiny {encoder} bf16 step: {launched} "
                             "WMB-bf16 launches")
    out_cpu = cpu.grads(batch)
    l_card, l_cpu = float(out_card[0]), float(out_cpu[0])
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    dist = []
    for i, depth in ((2, enc_depth), (3, ENHANCED_TINY_DEPTH)):
        num = sum(float(((a.cpu().double() - r.double()) ** 2).sum())
                  for a, r in zip(out_card[i], out_cpu[i]))
        den = sum(float((r.double() ** 2).sum()) for r in out_cpu[i])
        dist.append((math.sqrt(num / den), 2.0 ** -8 * depth))
    card.apply(*out_card)
    cpu.apply(*out_cpu)
    print(f"  tiny Enhanced bf16 {'fused' if fused else 'module'} {encoder} "
          f"training step card vs CPU: loss "
          f"{l_card:.7f} vs {l_cpu:.7f} (rel {rel:.2e}, tol {2.0 ** -8:.2e});"
          f" gradient rel L2 encoder {dist[0][0]:.2e} (tol {dist[0][1]:.2e}),"
          f" decoder {dist[1][0]:.2e} (tol {dist[1][1]:.2e})", flush=True)
    if not rel <= 2.0 ** -8 or any(not d <= t for d, t in dist):
        raise AssertionError("Enhanced bf16 step: card and CPU disagree")
    return dict(fused_decoder=fused, encoder=encoder, loss_card=l_card,
                loss_cpu=l_cpu, loss_rel=rel,
                grad_rel_l2_enc=dist[0][0], grad_rel_l2_dec=dist[1][0])


@torch.no_grad()
def ultra_kernel_phase(dec, dev):
    """The window-16 forms against their plain versions at the HAT-L Ultra
    path's shapes (one 192x192 padded map: 144 windows): W-long at a HAB's
    256 x 256 and an OCAB's 256 x 576 (6 heads of 32, no bias; the 3xTF32
    tensor-core body, its time beside the FMA body's as recorded) and
    W-long-bf16 at 256 x 256, with SDPA in the kernel's type as the
    yardstick; A-long in the decoder's RoPE cross- and self-attention forms
    at T = 256, bf16 (the path's trunk) and fp32 (its attention on W-long's
    body, its projections on M's tile product), with the Ultra decoder's
    weights and tables; M in its LN form at the decoder's 144 windows x 256
    x 192 (the path's 140 launches timed in that form in bf16, and fp32),
    with the decoder's weights. Each twice for bitwise repeatability.
    per_image: launches per Ultra image."""
    from gsasr_torch.models.fea2gs_fast import _attn, _ln, _mlp
    from gsasr_torch.models.fea2gs_rope_fast import rope_tables
    from gsasr_torch.ops import attention as ta
    from gsasr_torch.ops import fused_layers as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(14)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    f32, bf16 = torch.float32, torch.bfloat16
    ws, c, nh = dec.window_size, dec.channel, dec.num_heads
    t, hd = ws * ws, c // nh
    b = (192 // ws) ** 2
    scale = hd ** -0.5
    results = {"W-long": [], "W-long-bf16": [], "A-long": [], "M": []}
    for name, key, tk, dt, per_image in (
            ("HAB 256x256", "W-long", t, f32, 72),
            ("OCAB 256x576", "W-long", (ws + ws // 2) ** 2, f32, 12),
            ("HAB 256x256", "W-long-bf16", t, bf16, 0)):
        q, g = rnd(b, t, c).to(dt), rnd(b, t, c).to(dt)
        k, v = rnd(b, tk, c).to(dt), rnd(b, tk, c).to(dt)
        fwd = (ta.window_attention_packed_long_bf16_fwd if dt == bf16
               else ta.window_attention_packed_long_fwd)
        fargs = (q, k, v, None, scale, nh)
        out = fwd(*fargs)
        ref = ta.window_attention_packed_plain(*fargs)
        err = (_compare_bf16(out, ref, f"{key} {name}") if dt == bf16
               else _compare(out, ref, f"{key} {name}"))
        _repeatable(lambda: (fwd(*fargs),), f"{key} {name}")
        ms = _time_ms(lambda: fwd(*fargs), 10)
        plain = _time_ms(lambda: ta.window_attention_packed_plain(*fargs), 5)
        lib_f, _, _ = _sdpa_ms(q, k, v, None, g, nh, scale)
        act = 2 if dt == bf16 else 4
        # the two products; in fp32 three TF32 products each (3xTF32)
        bound, by = _bound_ms((4.0 if dt == bf16 else 12.0)
                              * b * nh * t * tk * hd,
                              act * (2 * b * t * c + 2 * b * tk * c),
                              PEAK_BF16 if dt == bf16 else PEAK_TF32)
        results[key].append(dict(
            case=name, dtype=str(dt).replace("torch.", ""), windows=b,
            per_image=per_image, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=bound, bound_by=by, library_ms=lib_f))

    x = rnd(b, t, c)
    lyr = dec.gs_selfattn_blocks[0].blocks[0]
    cl = dec.window_crossattn_blocks[0].blocks[0]
    cc, sc = rope_tables(cl.window_cross_attn.rope_freqs, ws, t)
    cs, ss = rope_tables(lyr.gs_self_attn.rope_freqs, ws, t)
    kv = rnd(b, t, c)
    cross = dict(pos=dec.pos_embedding, rope_cos_q=cc, rope_sin_q=sc,
                 rope_cos_k=cc, rope_sin_k=sc,
                 **_attn(cl.window_cross_attn), **_ln(cl.norm3))
    self_ = dict(rope_cos_q=cs, rope_sin_q=ss, rope_cos_k=cs, rope_sin_k=ss,
                 **_attn(lyr.gs_self_attn), **_ln(lyr.norm1))
    for name, dt, per_image, kw in (
            ("rope_cross", bf16, 16, cross), ("rope_self", bf16, 48, self_),
            ("rope_cross", f32, 0, cross), ("rope_self", f32, 0, self_)):
        kw = dict(kw, num_heads=nh, scale=scale)
        if "pos" in kw:
            kw.update(pos=kw["pos"].to(dt), kv=kv.to(dt))
        xd = x.to(dt)
        out = fl.ln_attn_proj_long(xd, **kw)
        ref = fl.ln_attn_proj_plain(xd, **kw)
        err = (_compare_bf16(out, ref, f"A-long {name} {dt}") if dt == bf16
               else _compare(out, ref, f"A-long {name} {dt}"))
        _repeatable(lambda: (fl.ln_attn_proj_long(xd, **kw),),
                    f"A-long {name} {dt}")
        ms = _time_ms(lambda: fl.ln_attn_proj_long(xd, **kw), 10)
        plain = _time_ms(lambda: fl.ln_attn_proj_plain(xd, **kw), 5)
        act = 2 if dt == bf16 else 4
        # the four projections and the attention's two products; in fp32
        # every product in 3xTF32 (three TF32 products) at the TF32 peak
        flops = 8.0 * b * t * c * c + 4.0 * b * t * t * c
        nbytes = (act * (b * t * c * (3 if "kv" in kw else 2)
                         + (t * c if "pos" in kw else 0))
                  + 4 * (4 * c * c + 6 * c + 4 * t * c))
        bound, by = (_bound_ms(flops, nbytes, PEAK_BF16) if dt == bf16 else
                     _bound_ms(3 * flops, nbytes, PEAK_TF32))
        results["A-long"].append(dict(
            case=name, dtype=str(dt).replace("torch.", ""), windows=b,
            per_image=per_image, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=bound, bound_by=by, library_ms=None))
    mlp = dict(**_ln(lyr.norm2), **_mlp(lyr.mlp_selfattn))
    for dt, per_image in ((bf16, ULTRA_PER_FORWARD["M"]), (f32, 0)):
        xd = x.to(dt)
        out = fl.ln_mlp_residual(xd, **mlp)
        ref = fl.ln_mlp_residual_plain(xd, **mlp)
        err = (_compare_bf16(out, ref, f"M ln {dt}") if dt == bf16
               else _compare(out, ref, f"M ln {dt}"))
        _repeatable(lambda: (fl.ln_mlp_residual(xd, **mlp),), f"M ln {dt}")
        ms = _time_ms(lambda: fl.ln_mlp_residual(xd, **mlp), 20)
        plain = _time_ms(lambda: fl.ln_mlp_residual_plain(xd, **mlp), 5)
        act = 2 if dt == bf16 else 4
        flops = 4.0 * b * t * c * c
        nbytes = act * 2 * b * t * c + 4 * (2 * c * c + 4 * c)
        bound, by = (_bound_ms(flops, nbytes, PEAK_BF16) if dt == bf16 else
                     _bound_ms(3 * flops, nbytes, PEAK_TF32))
        results["M"].append(dict(
            case="ln Ultra 144x256x192", dtype=str(dt).replace("torch.", ""),
            windows=b, per_image=per_image, max_abs_err=err, ms=ms,
            plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=None))
    for k, rows in results.items():
        for r in rows:
            lib = "null" if r["library_ms"] is None else \
                f"{r['library_ms']:.4f}"
            fma = FMA_MS.get((k, r["case"]), FMA_MS.get(
                (k, f"{r['case']} {r['dtype']}")))
            was = "" if fma is None else f", FMA body as recorded {fma}"
            print(f"  {k} {r['case']} {r['dtype']}: {r['ms']:.4f} ms (plain "
                  f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} by "
                  f"{r['bound_by']}, SDPA {lib}{was}) x{r['per_image']} per "
                  "Ultra image", flush=True)
    return results


def box_pairs(geom, h, w):
    """The (pixel, Gaussian) pairs geom's inclusive cull boxes hold on an h
    x w canvas: the work R and RB must do for this data."""
    nx = (torch.clamp(torch.floor(geom[:, 6]), max=w - 1)
          - torch.clamp(torch.ceil(geom[:, 5]), min=0) + 1).clamp(min=0)
    ny = (torch.clamp(torch.floor(geom[:, 8]), max=h - 1)
          - torch.clamp(torch.ceil(geom[:, 7]), min=0) + 1).clamp(min=0)
    return float((nx.double() * ny.double()).sum())


def _raster_rows(geom, col, bbox, h, w, g, launches, case, per="per_step"):
    """R (and RB unless g is None) against their plain versions on one
    canvas, each twice for bitwise repeatability, with their times (one
    call, and ten back to back: the card's time without the host's; the
    plain versions once) beside the recorded ones (RASTER_MS_RECORDED)
    and bounds: the pairs this run's data needs (the clipped integer pixels
    of every cull box) at their FP32 operations or exponentials per pair, or
    the bytes. `launches`: per image or step (`per`). Returns {"R": row,
    "RB": row}."""
    from gsasr_torch.ops import rasterizer as rz

    pairs = box_pairs(geom, h, w)

    def row(name, fn, plain_fn, compare, ops_per_pair, nbytes):
        out = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = plain_fn()
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        err = compare(out, ref)
        _repeatable(lambda: (fn(),) if name == "R" else fn(),
                    f"{name} {case}")
        ms = _time_ms(fn, 10)
        b2b = _batch_ms(fn)
        t_ops = pairs * ops_per_pair / PEAK_FP32
        t_sfu = pairs / PEAK_SFU
        t_bytes = nbytes / PEAK_HBM
        was = RASTER_MS_RECORDED.get((name, f"{h}x{w}"))
        print(f"  {name} {case}: {ms:.4f} ms, back to back {b2b:.4f} "
              f"(recorded before the redesign: {was if was else 'not timed'};"
              f" plain {plain:.1f}, bound "
              f"{max(t_ops, t_sfu, t_bytes) * 1e3:.4f}), {pairs:.3e} box "
              f"pairs, {int(geom.shape[0])} Gaussians in "
              f"{int(bbox.shape[1])} chunks", flush=True)
        return {"case": case, per: launches, "max_abs_err": err, "ms": ms,
                "ms_back_to_back": b2b, "plain_ms": plain,
                "bound_ms": max(t_ops, t_sfu, t_bytes) * 1e3,
                "bound_by": "bytes" if t_bytes > max(t_ops, t_sfu)
                else "operations", "library_ms": None,
                "library_null_reason": "no PyTorch call computes it",
                "box_pairs": pairs, "gaussians": int(geom.shape[0]),
                "chunks": int(bbox.shape[1])}

    rows = {"R": row(
        "R", lambda: rz.raster_fwd(geom, col, bbox, h, w),
        lambda: rz.raster_fwd_plain(geom, col, bbox, h, w),
        lambda o, r: _compare(o, r, f"R {case}"), RASTER_OPS_PER_PAIR,
        4 * (geom.numel() + col.numel() + h * w * 3))}
    if g is None:
        return rows

    def rb_compare(outs, refs):
        if not bool((outs[0][:, 5:] == 0).all()):
            raise AssertionError("RB: cull-box columns got a gradient")
        return max(_compare_grad(o, r, f"RB {case} {n}") for o, r, n in zip(
            outs, refs, ("dgeom", "dcol")))

    rows["RB"] = row(
        "RB", lambda: rz.raster_bwd(geom, col, bbox, g, h, w),
        lambda: rz.raster_bwd_plain(geom, col, bbox, g, h, w), rb_compare,
        RB_OPS_PER_PAIR, 4 * (2 * geom.numel() + 2 * col.numel() + h * w * 3))
    return rows


def raster_registers():
    """ptxas's registers and spills of R, R-exact and RB, printed beside
    the ones PERF.md records for their earlier forms (RASTER_REGS_RECORDED);
    raises if one is missing or spills."""
    from gsasr_torch.ops import _build

    regs = {}
    for key, (src, name) in RASTER_KERNELS.items():
        found = list(_ptxas_kernels(_build.ptxas_report(src),
                                    name).values())
        if len(found) != 1 or found[0][1] or found[0][2]:
            raise AssertionError(f"{key}: missing or spilling {found}")
        regs[key] = found[0][0]
        print(f"  ptxas {key}: {regs[key]} registers, no spills (recorded "
              f"before the redesign: {RASTER_REGS_RECORDED[key]})",
              flush=True)
    return regs


def fused_registers():
    """ptxas's registers and spills of M's and A's kernels (ln_mlp.cu,
    ln_attn.cu) and of MB's and AB's tensor-core kernels (ln_mlp_bwd.cu,
    ln_attn_bwd.cu), printed beside the FMA kernels' they replaced; raises
    if one is missing or spills, if any kernel of the backward sources
    spills, or if an FMA product or attention kernel is left in them."""
    from gsasr_torch.ops import _build

    regs = {}
    for src in ("ln_mlp", "ln_attn"):
        for name, r in _ptxas_kernels(_build.ptxas_report(src), "").items():
            key = next((k for k in FUSED_REG_KEYS if k in name), None)
            if key:
                regs.setdefault(key, []).append(r)
    for key in FUSED_REG_KEYS:
        print(f"  ptxas {key}: " + ", ".join(
            f"{r} registers, {st}/{ld} bytes spilled"
            for r, st, ld in sorted(regs.get(key, ())))
            + f" (the FMA kernels': {FUSED_REGS_FMA})", flush=True)
    if any(len(regs.get(k, ())) != 2 or any(st or ld for _, st, ld in
                                            regs[k])
           for k in FUSED_REG_KEYS):
        raise AssertionError(f"M's or A's kernels missing or spilling: {regs}")
    out = {k: sorted(r for r, _, _ in v) for k, v in regs.items()}
    bwd, spilled, fma = {}, {}, []
    for src in ("ln_mlp_bwd", "ln_attn_bwd"):
        for name, r in _ptxas_kernels(_build.ptxas_report(src), "").items():
            if r[1] or r[2]:
                spilled[name] = r
            if any(k in name for k in FUSED_BWD_FMA_KERNELS):
                fma.append(name)
            key = next((k for k in FUSED_BWD_REG_KEYS if k in name), None)
            if key:
                bwd.setdefault(f"{src} {key}", []).append(r)
    for key, rs in sorted(bwd.items()):
        print(f"  ptxas {key}: " + ", ".join(
            f"{r} registers, {st}/{ld} bytes spilled" for r, st, ld in
            sorted(rs)) + f" (the FMA kernels': {FUSED_BWD_REGS_FMA})",
            flush=True)
    want = {"ln_mlp_bwd ln_fc1_kernel", "ln_mlp_bwd ln_mlp_bwd_kernel",
            "ln_mlp_bwd wgrad_mma_kernel",
            "ln_attn_bwd rows_bwd_kernel", "ln_attn_bwd wgrad_mma_kernel",
            "ln_attn_bwd ln_qkv_kernel"}
    if spilled or fma or set(bwd) != want:
        raise AssertionError(f"MB's or AB's kernels missing or spilling, or "
                             f"an FMA kernel left: {sorted(bwd)}, {spilled}, "
                             f"{fma}")
    out.update({k: sorted(r for r, _, _ in v) for k, v in bwd.items()})
    return out


def _ptxas_kernels(report, key):
    """{kernel: (registers, spill store bytes, spill load bytes)} of the
    entry functions in a ptxas -v report whose mangled name holds `key`."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        if name and key in name:
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
            if sp:
                out[name] = [None, int(sp.group(1)), int(sp.group(2))]
            reg = re.search(r"Used (\d+) registers", line)
            if reg and name in out:
                out[name][0] = int(reg.group(1))
    return {k: tuple(v) for k, v in out.items()}


def short_tf32_registers(forms):
    """ptxas's registers and spills of the 3xTF32 forward body up to 160
    tokens (window_attn_short_tf32.cuh) for `forms`, keys of
    SHORT_TF32_KEYS, printed beside what the form ran before; raises if
    the kernel is missing or spills."""
    from gsasr_torch.ops import _build

    out = {}
    for form in forms:
        src, args = SHORT_TF32_KEYS[form]
        got = {n: r for n, r in _ptxas_kernels(
            _build.ptxas_report(src),
            "window_attn_fwd_short_tf32_kernel").items() if args in n}
        out[form] = sorted(r for r, _, _ in got.values())
        spills = sorted({(st, ld) for _, st, ld in got.values()})
        print(f"  ptxas {form}'s 3xTF32 body ({src}.cu): {out[form]} "
              f"registers, spill stores/loads {spills} (before: "
              f"{SHORT_TF32_REGS_BEFORE[form]})", flush=True)
        if len(got) != 1 or spills != [(0, 0)]:
            raise AssertionError(f"{form}'s 3xTF32 body missing or "
                                 f"spilling: {got}")
    return out


@torch.no_grad()
def ultra_train_kernel_phase(enc, dec, dev):
    """The window-16 kernels of the Ultra training step against their plain
    versions at its shapes (8 samples of 64x64 LR: 128 windows of 256
    tokens, 192 channels, 6 heads of 32, no bias; the HABs' and the
    decoder's 256 x 256 and the OCABs' 256 x 576): W-long-bf16 and
    WB-long-bf16 (the bf16 recipe's, the tensor-core bodies), WB-long-bf16
    once more with a bias (dbias), and WB-long (fp32, model_dtype float32,
    the tensor-core body in 3xTF32, its time beside the FMA body's that
    PERF.md records); each twice for bitwise repeatability, with SDPA
    forward and backward in the kernel's type as the yardstick, bounds
    (the fp32 backward's five products in 3xTF32 at the TF32 peak) and
    ptxas's registers. Then R and RB on the
    8-slot 1024x1024 canvas of the seeded Ultra networks' Gaussians at
    scales in [1, 16]. per_step: launches per Ultra step of that type."""
    from gsasr_torch.ops import _build
    from gsasr_torch.ops import attention as ta

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(15)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    f32, bf16 = torch.float32, torch.bfloat16
    ws, c, nh = dec.window_size, dec.channel, dec.num_heads
    t, hd = ws * ws, c // nh
    ocab = (ws + ws // 2) ** 2
    b = ULTRA_BATCH * (ULTRA_LR_SIZE // ws) ** 2
    scale = hd ** -0.5
    # WB-long's launches, not the masked forms' (template flag true)
    regs = {k: r for k, r in _ptxas_kernels(
        _build.ptxas_report("window_attn_bwd_long"),
        "window_attn_bwd_long").items() if "Lb1E" not in k}
    results = {"W-long-bf16": [], "WB-long-bf16": [], "WB-long": []}
    for name, tk, dt, bias, per_step in (
            ("HAB and decoder 256x256", t, bf16, None, 136),
            ("OCAB 256x576", ocab, bf16, None, 12),
            ("256x256, bias", t, bf16, 0.5 * rnd(nh, t, t), 0),
            ("HAB and decoder 256x256", t, f32, None, 136),
            ("OCAB 256x576", ocab, f32, None, 12)):
        q, g = rnd(b, t, c).to(dt), rnd(b, t, c).to(dt)
        k, v = rnd(b, tk, c).to(dt), rnd(b, tk, c).to(dt)
        act = 2 if dt == bf16 else 4
        peak = PEAK_BF16 if dt == bf16 else PEAK_FP32
        nbias = 0 if bias is None else 4 * nh * t * tk
        lib_f, lib_b, why = _sdpa_ms(
            q, k, v, None if bias is None else bias.to(dt)[None], g, nh,
            scale)
        if dt == bf16 and bias is None:
            fargs = (q, k, v, None, scale, nh)
            fwd = ta.window_attention_packed_long_bf16_fwd
            err = _compare_bf16(fwd(*fargs),
                                ta.window_attention_packed_plain(*fargs),
                                f"W-long-bf16 {name}")
            _repeatable(lambda: (fwd(*fargs),), f"W-long-bf16 {name}")
            bound, by = _bound_ms(4.0 * b * nh * t * tk * hd,
                                  act * (2 * b * t * c + 2 * b * tk * c),
                                  peak)
            results["W-long-bf16"].append(dict(
                case=name, dtype="bfloat16", windows=b, per_step=per_step,
                max_abs_err=err, ms=_time_ms(lambda: fwd(*fargs), 10),
                plain_ms=_time_ms(lambda: ta.window_attention_packed_plain(
                    *fargs), 3), bound_ms=bound, bound_by=by,
                library_ms=lib_f))
        key = "WB-long-bf16" if dt == bf16 else "WB-long"
        bwd = (ta.window_attention_packed_long_bf16_bwd if dt == bf16
               else ta.window_attention_packed_long_bwd)
        bargs = (q, k, v, bias, g, scale, nh)
        outs = bwd(*bargs)
        refs = ta.window_attention_packed_bwd_plain(*bargs)
        cmp = _compare_bf16 if dt == bf16 else _compare_grad
        err = max(cmp(o, r, f"{key} {name} {n}")
                  for o, r, n in zip(outs[:3], refs[:3], ("dq", "dk", "dv")))
        if bias is not None:
            err = max(err, _compare_grad(outs[3], refs[3],
                                         f"{key} {name} dbias"))
        _repeatable(lambda: bwd(*bargs), f"{key} {name}")
        ms = _time_ms(lambda: bwd(*bargs), 10)
        plain = _time_ms(lambda: ta.window_attention_packed_bwd_plain(
            *bargs), 3)
        if why:
            print(f"  {key} {name} library: null ({why})", flush=True)
        # the function's five products (the scores, dp, dv, dq, dk), in
        # fp32 three TF32 products each (3xTF32); bytes: q, g, dq, k, v,
        # dk, dv (and the f32 bias and dbias)
        bound, by = _bound_ms(
            (10.0 if dt == bf16 else 30.0) * b * nh * t * tk * hd,
            act * (3 * b * t * c + 4 * b * tk * c) + 2 * nbias,
            peak if dt == bf16 else PEAK_TF32)
        results[key].append(dict(
            case=name, dtype=str(dt).replace("torch.", ""), windows=b,
            per_step=per_step, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=bound, bound_by=by, library_ms=lib_b,
            library_null_reason=why,
            registers={k: r for k, r in regs.items()
                       if ("bfloat16" in k) == (dt == bf16)}))
    for name, (r_, st, ld) in regs.items():
        print(f"  ptxas {name}: {r_} registers, {st}/{ld} bytes spilled",
              flush=True)

    # -- R and RB on the Ultra canvas of the seeded networks' Gaussians ------
    batch = paper_batch(ULTRA_BATCH, seed=16, ultra=True)
    geom, col, bbox, h, w = step_raster_inputs(enc, dec, batch, ULTRA_TRAIN,
                                               dev)
    rows = _raster_rows(geom, col, bbox, h, w, rnd(h, w, 3), 1,
                        f"{h}x{w}, scales {batch['scale'].min():.2f}-"
                        f"{batch['scale'].max():.2f}")
    results.update({k: [r] for k, r in rows.items()})
    for k in ("W-long-bf16", "WB-long-bf16", "WB-long"):
        for r in results[k]:
            lib = "null" if r["library_ms"] is None else \
                f"{r['library_ms']:.4f}"
            fma = FMA_MS.get((k, r["case"]))
            was = "" if k != "WB-long" else f", FMA body as recorded {fma}"
            print(f"  {k} {r['case']}: {r['ms']:.4f} ms (plain "
                  f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} by "
                  f"{r['bound_by']}, SDPA {lib}{was}) x{r['per_step']} per "
                  f"Ultra step", flush=True)
    return results


def ultra_train_card_vs_cpu(dev, fused: bool = False):
    """One tiny step of the Ultra recipe (a bf16 HAT of one RHAG of two
    HABs, the second shifted, and OCAB, at window 16 on 32x32 LR: 256 x
    256 and 256 x 576 windows; a bf16 decoder of one cross and one self
    layer at 256 seeds in windows of 16; batch 2) from the same weights on
    the card (W-long-bf16, WB-long-bf16; with `fused` the decoder's
    attentions A-long and AB-long-bf16) and on the CPU (their plain
    versions): loss within 2^-8 relative, each network's gradient within
    relative L2 2^-8 times its bf16 depth (tests/test_torch_hat_train.py's
    depths: the decoder's ENHANCED_TINY_DEPTH, the tiny HAT's 50 more)."""
    from gsasr_torch.models import HATNOUP, Fea2GSRopeAMP
    from gsasr_torch.models.init import init_weights
    from gsasr_torch.ops import attention as ta
    from gsasr_torch.ops import fused_layers as fl
    from gsasr_torch.train import TrainConfig, Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(19)
    enc = init_weights(HATNOUP(embed_dim=24, depths=(2,), num_heads=(6,),
                               window_size=16, squeeze_factor=4,
                               conv_scale=0.5, num_feat=16,
                               drop_path_rate=0.0, dtype=bf16), gen)
    dec = init_weights(Fea2GSRopeAMP(inchannel=16, channel=24, num_heads=6,
                                     num_crossattn_blocks=1,
                                     num_crossattn_layers=1,
                                     num_selfattn_blocks=1,
                                     num_selfattn_layers=1, num_gs_seed=256,
                                     window_size=16, dtype=bf16), gen)
    cfg = TrainConfig(canvas_hw=(64, 64), warmup_iter=-1, milestones=(100,),
                      clip_grad_norm=None, fused_decoder=fused)
    rng = np.random.default_rng(20)
    scales = (1.0 + rng.random(2)).astype(np.float32)
    gt = np.ceil(scales * 32).astype(np.int32)
    batch = {"lq": rng.random((2, 32, 32, 3), dtype=np.float32),
             "gt": rng.random((2, 64, 64, 3), dtype=np.float32),
             "scale": scales, "gt_h": gt, "gt_w": gt}
    card = Trainer(copy.deepcopy(enc), copy.deepcopy(dec), cfg)
    cpu = Trainer(enc, dec, cfg, device="cpu")
    n = (ta.window_attention_packed_long_bf16_bwd.launches,
         fl.ln_attn_proj_bwd_long.launches)
    out_card = card.grads(batch)
    torch.cuda.synchronize()
    launched = (ta.window_attention_packed_long_bf16_bwd.launches - n[0],
                fl.ln_attn_proj_bwd_long.launches - n[1])
    if launched != ((3, 2) if fused else (5, 0)):
        raise AssertionError(f"tiny Ultra step: {launched} WB-long-bf16 and "
                             "AB-long launches")
    out_cpu = cpu.grads(batch)
    l_card, l_cpu = float(out_card[0]), float(out_cpu[0])
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    dist = []
    for i, depth in ((2, ENHANCED_TINY_DEPTH + 50), (3, ENHANCED_TINY_DEPTH)):
        num = sum(float(((a.cpu().double() - r.double()) ** 2).sum())
                  for a, r in zip(out_card[i], out_cpu[i]))
        den = sum(float((r.double() ** 2).sum()) for r in out_cpu[i])
        dist.append((math.sqrt(num / den), 2.0 ** -8 * depth))
    card.apply(*out_card)
    cpu.apply(*out_cpu)
    print(f"  tiny HAT-L Ultra bf16 {'fused' if fused else 'module'} "
          f"training step card vs CPU: loss "
          f"{l_card:.7f} vs {l_cpu:.7f} (rel {rel:.2e}, tol {2.0 ** -8:.2e});"
          f" gradient rel L2 encoder {dist[0][0]:.2e} (tol {dist[0][1]:.2e}),"
          f" decoder {dist[1][0]:.2e} (tol {dist[1][1]:.2e})", flush=True)
    if not rel <= 2.0 ** -8 or any(not d <= t for d, t in dist):
        raise AssertionError("Ultra bf16 step: card and CPU disagree")
    return dict(fused_decoder=fused, loss_card=l_card, loss_cpu=l_cpu,
                loss_rel=rel, grad_rel_l2_enc=dist[0][0],
                grad_rel_l2_dec=dist[1][0])


# Each form's kernels in ptxas's report: (a substring of the mangled name,
# a substring of its template arguments or ""), one pair per kernel. The
# window-16 tensor-core bodies take (kMask, kHM): in fp32 (3xTF32) W-long,
# WM-long (and A-long's fp32 attention, W-long's kernel) and WB-long,
# WMB-long and WB4-long, in bf16 their -bf16 forms.
REG_KEYS = {
    # the tensor-core bodies up to 160 tokens, by their flags (kMask, kHM)
    # and in their three register-array sizes
    "WM-bf16": [("window_attn_fwd_short_mma_kernel", "ILb1ELb0E")],
    "WMB-bf16": [("window_attn_bwd_short_mma_kernel", "ILb1ELb0E")],
    "WM-long": [("window_attn_fwd_long_tf32_kernel", "ILb1ELb0E")],
    "WMB-long": [("window_attn_bwd_long_tf32_", "ILb1ELb0E")],
    "W-long": [("window_attn_fwd_long_tf32_kernel", "ILb0ELb0E")],
    "A-long": [("ln_qkv_kernel", ""),
               ("window_attn_fwd_long_tf32_kernel", "ILb0ELb0E")],
    "WB-long": [("window_attn_bwd_long_tf32_", "ILb0ELb0E")],
    "WB4-long": [("window_attn_bwd_long_tf32_", "ILb0ELb1E")],
    # the tensor-core bodies, by their flags (kMask, kHM)
    "W-long-bf16": [("window_attn_fwd_long_mma_kernel", "ILb0ELb0E")],
    "WM-long-bf16": [("window_attn_fwd_long_mma_kernel", "ILb1ELb0E")],
    "W4-long-bf16": [("window_attn_fwd_long_mma_kernel", "ILb0ELb1E")],
    "WB-long-bf16": [("window_attn_bwd_long_mma_", "ILb0ELb0E")],
    "WMB-long-bf16": [("window_attn_bwd_long_mma_", "ILb1ELb0E")],
    "WB4-long-bf16": [("window_attn_bwd_long_mma_", "ILb0ELb1E")],
}
# The fp32 T <= 160 forms of W and WB (whose bodies W4 and WB4 share) with
# their registers as recorded, printed by the 4D attention phase beside the
# 4D kernels': W's and WM's 3xTF32 body (once 64 registers on the FMA
# body), and WB's and WMB's 3xTF32 body in
# its two block sizes (once 99 and 80 registers on the FMA body). (Their
# bf16 forms, once W-bf16 64 and WB-bf16 99 registers on the FMA body, run
# the tensor-core bodies of SHORT_REG_KEYS.)
PACKED_REG_KEYS = {
    "W": [("window_attn_fwd_short_tf32_kernel", "ILb0ELb0E")],
    "WM": [("window_attn_fwd_short_tf32_kernel", "ILb1ELb0E")],
    "WB": [("window_attn_bwd_short_tf32_kernel", "ILb0ELb0E")],
    "WMB": [("window_attn_bwd_short_tf32_kernel", "ILb1ELb0E")],
}
PACKED_REGS_RECORDED = {"W": (94,), "WM": (103,), "WB": (157, 157),
                        "WMB": (154, 154)}
# The registers of W's, WM's and W4's FMA body (64 each), printed beside
# their 3xTF32 body's (window_attn_short_tf32.cuh, one kernel a flag pair)
# and A's fp32 attention's (the same body in ln_attn.cu; before it
# W-long's, 141).
SHORT_TF32_KEYS = {
    "W": ("window_attn_fwd", "ILb0ELb0E"),
    "WM": ("window_attn_fwd", "ILb1ELb0E"),
    "W4": ("window_attn_fwd", "ILb0ELb1E"),
    "A": ("ln_attn", "ILb0ELb0E"),
}
SHORT_TF32_REGS_BEFORE = {"W": "FMA body 64", "WM": "FMA body 64",
                          "W4": "FMA body 64",
                          "A": "W-long's 3xTF32 body 141"}
# The bf16 forms up to 160 tokens on the tensor cores
# (window_attn_short_mma.cuh, window_attn_short_mma_bwd.cuh): each flag
# pair (kMask, kHM) in its three register-array sizes (4, 9 and 10 chunks
# of 16 keys); printed by the masked kernel phase, which fails if one is
# missing or spills.
SHORT_REG_KEYS = {
    "W-bf16": [("window_attn_fwd_short_mma_kernel", "ILb0ELb0E")],
    "WM-bf16": [("window_attn_fwd_short_mma_kernel", "ILb1ELb0E")],
    "W4-bf16": [("window_attn_fwd_short_mma_kernel", "ILb0ELb1E")],
    "WB-bf16": [("window_attn_bwd_short_mma_kernel", "ILb0ELb0E")],
    "WMB-bf16": [("window_attn_bwd_short_mma_kernel", "ILb1ELb0E")],
    "WB4-bf16": [("window_attn_bwd_short_mma_kernel", "ILb0ELb1E")],
}


# AB's and AB-long's attention in ptxas's report of ln_attn_bwd.cu: WB's
# tensor-core bodies, in fp32 as WB and WB-long instantiate them (the short
# 3xTF32 body's two block sizes, WB-long's dq and dk/dv launches), in bf16
# in their AB forms (TO = float: p and ds rounded once, f32 dq, dk, dv):
# WB-bf16's body in its three chunk counts and WB-long-bf16's launches.
AB_REG_KEYS = {
    "AB": [("window_attn_bwd_short_tf32_kernel", "ILb0ELb0E")],
    "AB-bf16": [("window_attn_bwd_short_mma_kernel", "EfEE")],
    "AB-long": [("window_attn_bwd_long_tf32_", "ILb0ELb0E")],
    "AB-long-bf16": [("window_attn_bwd_long_mma_", "ILb0ELb0EfEE")],
}


def _form_regs(regs, form, keys=REG_KEYS):
    """{kernel: (registers, spill stores, spill loads)} of one form."""
    return {k: r for k, r in regs.items()
            if any(key in k and args in k for key, args in keys[form])}


@torch.no_grad()
def masked_kernel_phase(enc_s, enc_h, dev):
    """The bf16 and window-16 forms of WM and WMB against their plain
    versions at their paths' shapes: WM-bf16 and WMB-bf16 at SwinIR's
    (window 8: 16 samples of 48x48, 576 windows of 64 tokens, period 36;
    one 192x192 map, period 576), WM-long and WMB-long in fp32 and bf16
    at the paper HAT's (window 16: 144 windows of 256 tokens, period 9 in
    training and 144 at inference); 180 channels, 6 heads of 30, the bias
    of the encoder's first shifted block (the bf16 window-16 forms on the
    tensor-core bodies; WM-long and WMB-long on the fp32 3xTF32 tensor-core
    bodies, their times beside the FMA bodies' that PERF.md records). Each
    twice for bitwise repeatability, with its time, plain time, bound in its
    type (WM-long, WMB-long: their products in 3xTF32 at the TF32 peak),
    SDPA (the
    bias plus the mask as a float mask in the operands' type) forward and
    backward, and ptxas's registers; then W-long's, A-long's and the fp32
    backward's registers and the tensor-core bodies' beside the recorded
    ones (raises if a tensor-core body is missing or spills). per_image /
    per_step: launches on
    the bf16 SwinIR-Enhanced image and the bf16 SwinIR step (the bf16
    forms), the paper HAT's image and step (WM-long, WMB-long) and the bf16
    paper HAT step (the window-16 bf16 forms)."""
    from gsasr_torch.models.swinir import swin_attn_mask
    from gsasr_torch.ops import _build
    from gsasr_torch.ops import attention as ta

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(21)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    f32, bf16 = torch.float32, torch.bfloat16
    regs = {}
    for src in ("window_attn_fwd", "window_attn_bwd", "ln_attn"):
        regs.update(_ptxas_kernels(_build.ptxas_report(src), ""))
    results = {k: [] for k in ("WM-bf16", "WMB-bf16", "WM-long",
                               "WMB-long", "WM-long-bf16", "WMB-long-bf16")}
    lr = PAPER_LR_SIZE
    # (encoder, type, case, map side, samples, per forward, per backward)
    cases = [(enc_s, bf16, "SwinIR training 16x48x48", lr, PAPER_BATCH,
              dict(per_step=18), dict(per_step=18)),
             (enc_s, bf16, "SwinIR inference 192x192", 192, 1,
              dict(per_image=18), dict(per_step=0)),
             (enc_h, f32, "paper HAT training 16x48x48", lr, PAPER_BATCH,
              dict(per_step=18), dict(per_step=18)),
             (enc_h, f32, "paper HAT inference 192x192", 192, 1,
              dict(per_image=18), dict(per_step=0)),
             (enc_h, bf16, "paper HAT training 16x48x48", lr, PAPER_BATCH,
              dict(per_step=18), dict(per_step=18)),
             (enc_h, bf16, "paper HAT inference 192x192", 192, 1,
              dict(per_image=0), dict(per_step=0))]
    for enc, dt, name, side, samples, per_f, per_b in cases:
        attn = enc.layers[0].residual_group["blocks"][1].attn
        ws = enc.window_size
        nh, c = attn.num_heads, attn.proj.in_features
        t, hd = ws * ws, c // attn.num_heads
        scale = hd ** -0.5
        long = t > ta._MAX_T
        isbf = dt == bf16
        suffix = "-bf16" if isbf else ""
        kf, kb = (("WM-long", "WMB-long") if long else ("WM", "WMB"))
        kf, kb = kf + suffix, kb + suffix
        fwd, bwd = ta._FORMS[True, isbf, long]
        bias = attn.relative_position_bias_table[
            attn.relative_position_index].permute(2, 0, 1).contiguous()
        mask = swin_attn_mask(side, side, ws, ws // 2, dev)
        nw = mask.shape[0]
        b = samples * nw
        q, k, v, g = (rnd(b, t, c).to(dt) for _ in range(4))
        full = (bias[None] + mask.repeat(b // nw, 1, 1)[:, None]).to(dt)
        fargs = (q, k, v, bias, mask, scale, nh)
        plain_f = lambda: ta.window_attention_packed_plain(  # noqa: E731
            q, k, v, bias, scale, nh, mask)
        out, ref = fwd(*fargs), plain_f()
        err = (_compare_bf16(out, ref, f"{kf} {name}") if isbf
               else _compare(out, ref, f"{kf} {name}"))
        _repeatable(lambda: (fwd(*fargs),), f"{kf} {name}")
        ms = _time_ms(lambda: fwd(*fargs), 10)
        plain = _time_ms(plain_f, 3)
        lib_f, lib_b, why = _sdpa_ms(q, k, v, full, g, nh, scale)
        act = 2 if isbf else 4
        peak = PEAK_BF16 if isbf else PEAK_FP32
        # the two products (fp32, all beyond 160 tokens here: three TF32
        # products each, 3xTF32); bytes: q, k, v, out in the operands'
        # type, the f32 bias and mask
        bound, by = _bound_ms((4.0 if isbf else 12.0) * b * nh * t * t * hd,
                              act * 4 * b * t * c + 4 * (nh + nw) * t * t,
                              peak if isbf else PEAK_TF32)
        results[kf].append(dict(
            case=name, dtype=str(dt).replace("torch.", ""), nW=nw,
            windows=b, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=bound, bound_by=by, library_ms=lib_f,
            registers=_form_regs(regs, kf), **per_f))
        bargs = (q, k, v, bias, mask, g, scale, nh)
        plain_b = lambda: ta.window_attention_packed_bwd_plain(  # noqa: E731
            q, k, v, bias, g, scale, nh, mask)
        outs, refs = bwd(*bargs), plain_b()
        if isbf:
            err = max(_compare_bf16(o, r, f"{kb} {name} {n}") for o, r, n in
                      zip(outs[:3], refs[:3], ("dq", "dk", "dv")))
            err = max(err, _compare_grad(outs[3], refs[3],
                                         f"{kb} {name} dbias"))
        else:
            err = _compare_grads(outs, refs, ("dq", "dk", "dv", "dbias"),
                                 f"{kb} {name}")
        _repeatable(lambda: bwd(*bargs), f"{kb} {name}")
        ms = _time_ms(lambda: bwd(*bargs), 10)
        plain = _time_ms(plain_b, 3)
        if why:
            print(f"  {kb} {name} library: null ({why})", flush=True)
        # the function's five products (fp32 beyond 160 tokens: three TF32
        # products each, 3xTF32); bytes: q, g, dq, k, v, dk, dv in the
        # operands' type, the f32 bias, dbias and mask
        tf32 = long and not isbf
        bound, by = _bound_ms((30.0 if tf32 else 10.0) * b * nh * t * t * hd,
                              act * 7 * b * t * c
                              + 4 * (2 * nh + nw) * t * t,
                              PEAK_TF32 if tf32 else peak)
        results[kb].append(dict(
            case=name, dtype=str(dt).replace("torch.", ""), nW=nw,
            windows=b, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=bound, bound_by=by, library_ms=lib_b,
            library_null_reason=why, registers=_form_regs(regs, kb),
            **per_b))
    for key, rows in results.items():
        for r in rows:
            lib = "null" if r["library_ms"] is None else \
                f"{r['library_ms']:.4f}"
            per = r.get("per_image", r.get("per_step"))
            fma = FMA_MS.get((key, r["case"]))
            was = "" if fma is None else f", FMA body as recorded {fma}"
            print(f"  {key} {r['case']}: {r['ms']:.4f} ms (plain "
                  f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} by "
                  f"{r['bound_by']}, SDPA {lib}{was}) x{per} per "
                  f"{'image' if 'per_image' in r else 'step'}", flush=True)
    kept = {}
    for form in REG_KEYS:
        for name, (r_, st, ld) in _form_regs(regs, form).items():
            print(f"  ptxas {form} {name}: {r_} registers, {st}/{ld} bytes "
                  "spilled", flush=True)
            kept.setdefault(form, []).append(r_)
    earlier = {k: tuple(sorted(kept.get(k, ())))
               for k in LONG_REGS_RECORDED}
    same = earlier == LONG_REGS_RECORDED
    print(f"  registers of the earlier window-16 kernels: {earlier}, "
          f"{'kept' if same else 'MOVED'} (recorded: "
          f"{LONG_REGS_RECORDED})", flush=True)
    mma = {k: tuple(sorted(kept.get(k, ()))) for k in MMA_REGS_RECORDED}
    print(f"  registers of the tensor-core bodies: {mma}, "
          f"{'kept' if mma == MMA_REGS_RECORDED else 'MOVED'} (recorded: "
          f"{MMA_REGS_RECORDED})", flush=True)
    short = {}
    for form in SHORT_REG_KEYS:
        for name, (r_, st, ld) in _form_regs(regs, form,
                                             SHORT_REG_KEYS).items():
            print(f"  ptxas {form} {name}: {r_} registers, {st}/{ld} bytes "
                  "spilled", flush=True)
            short.setdefault(form, []).append(r_)
    print(f"  registers of the tensor-core bodies up to 160 tokens: "
          f"{ {k: sorted(v) for k, v in short.items()} } (the FMA body "
          f"they replace: W-bf16, WM-bf16 64, WB-bf16 99, WMB-bf16 80)",
          flush=True)
    spilled = {k: r for form in (*MMA_REGS_RECORDED, "W-long", "WM-long",
                                 "WB-long", "WMB-long", "WB4-long")
               for k, r in _form_regs(regs, form).items() if r[1] or r[2]}
    spilled.update({k: r for form in SHORT_REG_KEYS
                    for k, r in _form_regs(regs, form,
                                           SHORT_REG_KEYS).items()
                    if r[1] or r[2]})
    if (spilled or not all(mma.values())
            or any(len(short.get(f, ())) != 3 for f in SHORT_REG_KEYS)):
        raise AssertionError(f"tensor-core bodies missing or spilling: "
                             f"{mma}, {short}, {spilled}")
    results["registers"] = {k: sorted(v) for k, v in kept.items()}
    results["short_registers"] = {k: sorted(v) for k, v in short.items()}
    results["earlier_registers_kept"] = same
    results["mma_registers_kept"] = mma == MMA_REGS_RECORDED
    return results


@torch.no_grad()
def ab_long_kernel_phase(dec, dev):
    """AB-long and AB-long-bf16 (the window-16 form of AB) against their
    plain versions at the Ultra fused step's shapes (8 samples of 64x64 LR:
    128 windows of 256 tokens, 192 channels, 6 heads of 32), with the
    recipe decoder's weights and RoPE tables: RoPE cross-attention (pos,
    kv, Tk = 256) and self-attention (the four table gradients among the
    outputs), each in bf16 and fp32, and the self-attention with a bias in
    fp32 (dbias, the ordered sum over windows); MB in the Ultra decoder's
    three option sets (ln_inj, ln, zero_base) at the same shapes in the
    recipe's bf16; each twice for bitwise repeatability, with times beside the ones
    recorded before the redesign, bounds (bf16: the operations against the
    tensor-core peak; fp32: three TF32 products a product at the TF32
    peak) and ptxas's registers of AB's and AB-long's attention (WB's
    tensor-core bodies; raises on a spill). per_step: launches per Ultra
    step on the fused decoder at the bf16 recipe (the fp32 and bias rows
    0)."""
    from gsasr_torch.models.fea2gs_fast import _attn, _ln, _mlp, _seq_mlp
    from gsasr_torch.models.fea2gs_rope_fast import rope_tables
    from gsasr_torch.ops import _build
    from gsasr_torch.ops import fused_layers as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(23)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    f32, bf16 = torch.float32, torch.bfloat16
    ws, t, c, nh = dec.window_size, dec.num_gs_seed, dec.channel, \
        dec.num_heads
    b = ULTRA_BATCH * (ULTRA_LR_SIZE // ws) ** 2
    m = b * t
    lyr = dec.gs_selfattn_blocks[0].blocks[0]
    cl = dec.window_crossattn_blocks[0].blocks[0]
    nsq = math.isqrt(t)
    cc, sc = rope_tables(cl.window_cross_attn.rope_freqs, max(nsq, ws),
                         max(t, ws * ws))
    cs, ss = rope_tables(lyr.gs_self_attn.rope_freqs, nsq, t)
    names = ("dx", "dpos", "dkv", "dln_w", "dln_b", "dwq", "dbq", "dwk",
             "dbk", "dwv", "dbv", "dwo", "dbo", "dbias", "dcos_q", "dsin_q",
             "dcos_k", "dsin_k")
    self_kw = dict(rope_cos_q=cs, rope_sin_q=ss, rope_cos_k=cs,
                   rope_sin_k=ss, **_attn(lyr.gs_self_attn), **_ln(lyr.norm1))
    cases = [("rope_cross", dict(pos=dec.pos_embedding, kv=rnd(b, ws * ws, c),
                                 rope_cos_q=cc[:t], rope_sin_q=sc[:t],
                                 rope_cos_k=cc[:ws * ws],
                                 rope_sin_k=sc[:ws * ws],
                                 **_attn(cl.window_cross_attn),
                                 **_ln(cl.norm3)), 16),
             ("rope_self", self_kw, 48)]
    rows = []
    for name, kw, per_step in cases + [
            ("rope_self, bias", dict(self_kw, bias=0.5 * rnd(nh, t, t)), 0)]:
        for dt in ((bf16, f32) if "bias" not in name else (f32,)):
            x, g = rnd(b, t, c).to(dt), rnd(b, t, c).to(dt)
            kwd = dict(kw, num_heads=nh)
            if "kv" in kw:
                kwd.update(pos=kw["pos"].to(dt), kv=kw["kv"].to(dt))
            label = f"AB-long {name} {str(dt).replace('torch.', '')}"
            fn = lambda: fl.ln_attn_proj_bwd(x, g, **kwd)  # noqa: E731
            plain = lambda: fl.ln_attn_proj_bwd_plain(  # noqa: E731
                x, g, **kwd)
            n = fl.ln_attn_proj_bwd_long.launches
            outs, refs = fn(), plain()
            if fl.ln_attn_proj_bwd_long.launches != n + 1:
                raise AssertionError(f"{label}: AB-long not launched")
            err = _compare_grads(outs, refs, names, label, {"dbk": "dwk"},
                                 BWD_BF16_TOL if dt == bf16 else GRAD_TOL,
                                 l2=dt == bf16)
            _repeatable(fn, label)
            act = 2 if dt == bf16 else 4
            tk = ws * ws if "kv" in kw else t
            # eleven products of 2 T C^2 and six of 2 T^2 C per window (as
            # AB); bytes: x, g, dx (kv, dkv, pos, dpos) in the activation
            # type, the four tables and their gradients, the weights and
            # their gradients, the vectors (the f32 bias and dbias)
            flops = 2.0 * b * (11 * t * c * c + 6 * t * tk * c)
            nbytes = (act * (3 * m * c + (2 * b * tk * c + 2 * t * c
                                          if "kv" in kw else 0))
                      + 4 * (4 * (t + tk) * c + 8 * c * c + 11 * c
                             + (2 * nh * t * tk if "bias" in kw else 0)))
            bound, by = (_bound_ms(flops, nbytes, PEAK_BF16) if dt == bf16
                         else _bound_ms(3 * flops, nbytes, PEAK_TF32))
            rows.append(dict(
                case=name, dtype=str(dt).replace("torch.", ""),
                decoder="HAT-L Ultra", windows=b,
                per_step=per_step if dt == bf16 else 0, max_abs_err=err,
                ms=_time_ms(fn, 10), plain_ms=_time_ms(plain, 3),
                bound_ms=bound, bound_by=by, library_ms=None,
                library_null_reason="no PyTorch call computes it"))
            print(f"  {label}: {rows[-1]['ms']:.4f} ms (plain "
                  f"{rows[-1]['plain_ms']:.4f}, bound {bound:.4f} by {by}, "
                  f"library null) x{rows[-1]['per_step']} per Ultra fused "
                  f"step" + _recorded_note("AB-long", name, rows[-1]["dtype"]),
                  flush=True)

    # -- MB at the Ultra decoder's shapes: its three option sets ------------
    blocks = list(dec.window_crossattn_blocks) + list(dec.gs_selfattn_blocks)
    layers = sum(len(blk.blocks) for blk in blocks)
    blk = dec.gs_selfattn_blocks[0]
    scale_emb = dec.scale_mlp(torch.full((1, 1), 0.0625, device=dev))
    inj = lyr.gs_cross_attn_scale(scale_emb).expand(b, c).contiguous()
    names = ("dx", "dresi", "dinj", "dln_w", "dln_b", "dw1", "db1", "dw2",
             "db2")
    mb_rows = []
    for name, kw, per_step in (
            ("ln_inj", dict(inj=inj, **_ln(lyr.norm4),
                            **_mlp(lyr.mlp_crossattn)), layers),
            ("ln", dict(**_ln(lyr.norm2), **_mlp(lyr.mlp_selfattn)), layers),
            ("zero_base", dict(zero_base=True, **_seq_mlp(blk.mlp)),
             len(blocks))):
        # the recipe's bf16 only: in fp32 a pre-activation within float32
        # rounding of the ReLU's kink may take the other side in the plain
        # version (its LayerNorm rounds otherwise than the kernel's, as it
        # did against the FMA kernel before): tests/test_torch_kernels_gpu.py
        # holds fp32 MB at this shape, and scripts/ab_torch_sources.py
        # --fused-bwd-only times it (PERF.md §6)
        for dt in (bf16,):
            x, g = rnd(b, t, c).to(dt), rnd(b, t, c).to(dt)
            kwd = dict(kw, inj=inj.to(dt)) if "inj" in kw else kw
            label = f"MB Ultra {name} {str(dt).replace('torch.', '')}"
            fn = lambda: fl.ln_mlp_residual_bwd(x, g, **kwd)  # noqa: E731
            plain = lambda: fl.ln_mlp_residual_bwd_plain(  # noqa: E731
                x, g, **kwd)
            err = _compare_grads(fn(), plain(), names, label, None,
                                 BWD_BF16_TOL if dt == bf16 else GRAD_TOL,
                                 l2=dt == bf16)
            _repeatable(fn, label)
            act = 2 if dt == bf16 else 4
            hid = kw["w1"].shape[0]
            # five products (the recomputed fc1, dw2, dz1, dw1 and dh);
            # bytes as phase 27's
            flops = 10.0 * m * c * hid
            nbytes = (act * (3 * m * c + (2 * b * c if "inj" in kw else 0))
                      + 4 * (4 * c * hid + 2 * hid + 2 * c
                             + (4 * c if "ln_w" in kw else 0)))
            bound, by = (_bound_ms(flops, nbytes, PEAK_BF16) if dt == bf16
                         else _bound_ms(3 * flops, nbytes, PEAK_TF32))
            mb_rows.append(dict(
                case=f"Ultra {name}", dtype=str(dt).replace("torch.", ""),
                decoder="HAT-L Ultra", windows=b,
                per_step=per_step if dt == bf16 else 0, max_abs_err=err,
                ms=_time_ms(fn, 10), plain_ms=_time_ms(plain, 3),
                bound_ms=bound, bound_by=by, library_ms=None,
                library_null_reason="no PyTorch call computes it"))
            print(f"  {label}: {mb_rows[-1]['ms']:.4f} ms (plain "
                  f"{mb_rows[-1]['plain_ms']:.4f}, bound {bound:.4f} by "
                  f"{by}, library null) x{mb_rows[-1]['per_step']} per "
                  "Ultra fused step (not timed before the redesign)",
                  flush=True)

    regs = _ptxas_kernels(_build.ptxas_report("ln_attn_bwd"), "")
    kept = {}
    for form in AB_REG_KEYS:
        for k, (r_, st, ld) in _form_regs(regs, form, AB_REG_KEYS).items():
            print(f"  ptxas {form} {k}: {r_} registers, {st}/{ld} bytes "
                  "spilled", flush=True)
            kept.setdefault(form, []).append(r_)
            if st or ld:
                raise AssertionError(f"{form}'s attention spills: {k}")
    if set(kept) != set(AB_REG_KEYS):
        raise AssertionError(f"AB's attention kernels missing: {sorted(kept)}")
    print(f"  registers of AB's and AB-long's attention (WB's tensor-core "
          f"bodies): {dict(sorted(kept.items()))}; before the redesign "
          f"(FMA bodies): AB 99-105, AB-long 130-179", flush=True)
    return {"AB-long": rows, "MB": mb_rows,
            "registers": {k: sorted(v) for k, v in kept.items()}}


# Phase 37: scripts/bench_exact_render.py's workload, the render of the
# 180^2 -> x4 bench: a 720^2 canvas, 518,400 Gaussians, dmax 0.1.
EXACT_HW = 720
EXACT_GAUSSIANS = 518400
EXACT_DMAX = 0.1


def exact_workload(kind: str, dev, s: int = EXACT_GAUSSIANS,
                   hw: int = EXACT_HW, seed: int = 0):
    """scripts/bench_exact_render.py's Gaussians, from a seed with numpy:
    centers on a jittered lattice, colors in [0, 0.3], rho in [-0.6, 0.6];
    sigmas "trained"-like (lognormal around 1.1 px, sigma 0.7, clipped to
    [0.3, 60]: boxes of about 32 px) or "init"-like (300 px, every box at
    the dmax clamp). Returns (sigmas, coords, colors) on `dev`."""
    rng = np.random.default_rng(seed)
    half = (hw - 1) / 2.0
    if kind == "trained":
        sig_px = np.clip(np.exp(rng.normal(np.log(1.1), 0.7, (s, 2))).astype(
            np.float32), 0.3, 60.0)
    else:
        sig_px = np.full((s, 2), 300.0, np.float32)
    sigmas = np.concatenate(
        [sig_px / half, rng.uniform(-0.6, 0.6, (s, 1)).astype(np.float32)],
        axis=1)
    n = int(np.sqrt(s))
    gx, gy = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n))
    coords = np.stack([gx.ravel(), gy.ravel()], 1).astype(np.float32)
    coords += rng.uniform(-1.0 / n, 1.0 / n, coords.shape).astype(np.float32)
    colors = rng.uniform(0, 0.3, (s, 3)).astype(np.float32)
    return [torch.from_numpy(x).to(dev) for x in (sigmas, coords, colors)]


def exact_render_phase(dev, kernels):
    """Phase 37: gs_render(binning="exact") at full width (the 720^2 render
    of 518,400 Gaussians, dmax 0.1) on trained-like boxes (the lists fit:
    R-exact once, no R) and init-like ones (they overflow: R once, no
    R-exact), each call driven with every count from zero, the lists from
    kernel XB (the path may run none of exact_tables' list-building torch
    ops: a spy and the profiler's host ops say so). Then, per
    regime: the lists' ok, the build's ms (sort, pad, tables), the path's
    host ms beside binning="auto"'s (R) on the same Gaussians and R's
    kernel ms; on the trained-like regime R-exact against its plain walk
    and against R on the same sorted Gaussians, twice for bits, its ms and
    bound (the box pairs this run needs at 24 FP32 operations or one exp
    each, or the bytes: geometry, colors, the used list slots and the
    table read once, the image written once), memberships and used chunks;
    and one backward through the exact path against binning="auto"'s."""
    from gsasr_torch.ops import rasterizer as rz

    torch.backends.cuda.matmul.allow_tf32 = False
    hw, dmax = EXACT_HW, EXACT_DMAX
    box = dmax * (hw - 1) + 1
    mr, mc = rz._exact_spans(hw, hw, (box, box))
    results = {"R-exact": [], "XB": [], "regimes": []}
    plain_tables = rz.exact_tables

    def no_plain_tables(*a, **k):
        raise AssertionError("the exact path ran exact_tables' torch ops")

    for kind, want in (("trained", {"R-exact": 1, "XB": 1}),
                       ("init", {"R": 1, "XB": 1})):
        sigmas, coords, colors = exact_workload(kind, dev)
        with torch.no_grad():
            _reset(kernels)
            # the path with the plain lists' torch ops forbidden, under the
            # profiler: none of their list-building ops may run
            rz.exact_tables = no_plain_tables
            try:
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU]) as prof:
                    img = rz.gs_render(sigmas, coords, colors, (hw, hw),
                                       dmax, binning="exact")
                    torch.cuda.synchronize()
            finally:
                rz.exact_tables = plain_tables
            counts = _counts(kernels)
            ops = {e.key for e in prof.key_averages()}
            listing = sorted(ops & EXACT_LIST_OPS)
            print(f"  exact render {kind}: {len(ops)} distinct host ops on "
                  f"the path, list-building ones: {listing}", flush=True)
            if listing:
                raise AssertionError(f"exact render {kind}: the path ran "
                                     f"list-building torch ops {listing}")
            print(f"  exact render {kind}: {tuple(img.shape)}, launches "
                  f"{ {k: c for k, c in counts.items() if c} }, range "
                  f"[{float(img.min()):.4f}, {float(img.max()):.4f}]",
                  flush=True)
            if counts != dict({k: 0 for k in kernels}, **want):
                raise AssertionError(f"exact render {kind}: launch counts "
                                     f"{counts}")
            if tuple(img.shape) != (hw, hw, 3) or \
                    not bool(torch.isfinite(img).all()):
                raise AssertionError(f"exact render {kind}: bad image")
            geom = rz.pack_geometry(sigmas, coords, (hw, hw), dmax)

            def build():
                return rz.exact_geometry(geom, colors, (hw, hw), mr, mc)

            g, col, bbox, lists, tab, ok = build()
            ok = bool(ok)
            med = lambda fn, n=5: float(np.median(_host_ms(fn, n)))  # noqa
            # XB alone against its plain version (exact_tables' torch ops
            # on the card): the same integers, its device and host ms
            nt = rz._cdiv(hw, rz._TH_BIN) * rz._cdiv(hw, rz._TW_BIN)
            xb_args = (g, hw, hw, rz._TH_BIN, rz._TW_BIN, rz._GC_LIST, mr,
                       mc, tab.numel() * rz._GC_LIST)
            ref_tables = rz.exact_tables(*xb_args)
            if not all(torch.equal(a, r) for a, r in zip(
                    (lists, tab, torch.tensor(ok, device=dev)),
                    ref_tables)):
                raise AssertionError(f"XB {kind}: the lists differ from "
                                     "exact_tables'")
            print(f"  XB {kind}: list_idx, tab and ok equal to "
                  f"exact_tables' ({lists.numel()} slots)", flush=True)
            _repeatable(lambda: rz.exact_build(*xb_args), f"XB {kind}")
            xb_bytes = 4 * (g.numel() + lists.numel() + tab.numel()) + 1
            xb_row = dict(
                case=kind, per_image=1, max_abs_err=0.0,
                ms=_time_ms(lambda: rz.exact_build(*xb_args), 10),
                host_ms=med(lambda: rz.exact_build(*xb_args), 9),
                plain_ms=_time_ms(lambda: rz.exact_tables(*xb_args), 5),
                bound_ms=xb_bytes / PEAK_HBM * 1e3, bound_by="bytes",
                library_ms=None,
                library_null_reason="no PyTorch call computes it",
                gaussians=int(g.shape[0]), tiles=nt)
            results["XB"].append(xb_row)
            print(f"  XB {kind}: {xb_row['ms']:.4f} ms on the card, "
                  f"{xb_row['host_ms']:.4f} ms host (plain "
                  f"{xb_row['plain_ms']:.4f}, bound {xb_row['bound_ms']:.4f}"
                  f" by bytes)", flush=True)
            del ref_tables
            row = dict(
                case=kind, ok=ok, span=[mr, mc], build_ms=med(build),
                xb_ms=xb_row["ms"], xb_host_ms=xb_row["host_ms"],
                path_ms=med(lambda: rz.gs_render(
                    sigmas, coords, colors, (hw, hw), dmax,
                    binning="exact")),
                r_path_ms=med(lambda: rz.gs_render(
                    sigmas, coords, colors, (hw, hw), dmax)),
                launches=counts, capacity_chunks=int(tab.numel()))
            # the build's device time by kernel (torch.profiler)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                build()
                torch.cuda.synchronize()
            kern = sorted((e for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA
                           and e.self_device_time_total > 0),
                          key=lambda e: -e.self_device_time_total)
            row["build_device_ms"] = sum(
                e.self_device_time_total for e in kern) / 1e3
            row["build_kernels"] = [[e.key[:80], e.count,
                                     e.self_device_time_total / 1e3]
                                    for e in kern[:8]]
            print(f"  exact render {kind}: build on the device "
                  f"{row['build_device_ms']:.3f} ms; "
                  + "; ".join(f"{k[:48]} x{n} {ms:.3f}"
                              for k, n, ms in row["build_kernels"]),
                  flush=True)
            rg, rcol, rbbox = rz.chunk_geometry(geom, colors, (hw, hw))
            row["r_ms"] = _time_ms(lambda: rz.raster_fwd(rg, rcol, rbbox, hw,
                                                         hw), 10)
            if ok:
                walk = lambda: rz.raster_fwd_exact(  # noqa: E731
                    g, col, lists, tab, hw, hw)
                out = walk()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref = rz.raster_fwd_exact_plain(g, col, lists, tab, hw, hw)
                torch.cuda.synchronize()
                plain = (time.perf_counter() - t0) * 1e3
                err = _compare(out, ref, "R-exact")
                _compare(out, rz.raster_fwd(g, col, bbox, hw, hw),
                         "R-exact vs R, same Gaussians")
                _repeatable(lambda: (walk(),), "R-exact")
                used = tab % 4 != 0
                members = int((lists.view(-1, 256)[used] < g.shape[0]).sum())
                pairs = box_pairs(g, hw, hw)
                t_ops = pairs * RASTER_OPS_PER_PAIR / PEAK_FP32
                t_sfu = pairs / PEAK_SFU
                t_bytes = 4 * (g.numel() + col.numel() + hw * hw * 3
                               + 256 * int(used.sum()) + tab.numel()) \
                    / PEAK_HBM
                row.update(
                    per_image=1, max_abs_err=err, ms=_time_ms(walk, 10),
                    plain_ms=plain,
                    bound_ms=max(t_ops, t_sfu, t_bytes) * 1e3,
                    bound_by="bytes" if t_bytes > max(t_ops, t_sfu)
                    else "operations", library_ms=None,
                    library_null_reason="no PyTorch call computes it",
                    box_pairs=pairs, memberships=members,
                    used_chunks=int(used.sum()), gaussians=int(g.shape[0]))
                results["R-exact"].append(row)
            results["regimes"].append(row)
            walk_s = (f"walk {row['ms']:.4f} ms (plain {row['plain_ms']:.1f},"
                      f" bound {row['bound_ms']:.4f} by {row['bound_by']}), "
                      f"{row['memberships']} memberships in "
                      f"{row['used_chunks']} of {row['capacity_chunks']} "
                      f"chunks, {row['box_pairs']:.4e} box pairs; "
                      if ok else "")
            print(f"  exact render {kind}: ok {ok} (span {mr} x {mc} list "
                  f"tiles), build {row['build_ms']:.3f} ms, {walk_s}path "
                  f"{row['path_ms']:.3f} ms against R's {row['r_path_ms']:.3f}"
                  f" (R kernel {row['r_ms']:.4f} ms)", flush=True)
            del g, col, bbox, lists, tab, rg, rcol, rbbox
    sigmas, coords, colors = exact_workload("trained", dev)
    wgt = torch.randn(hw, hw, 3, generator=torch.Generator().manual_seed(37)
                      ).to(dev)
    grads = []
    for binning in ("exact", "auto"):
        tens = [x.clone().requires_grad_() for x in (sigmas, coords, colors)]
        (rz.gs_render(*tens, (hw, hw), dmax, binning=binning) * wgt).sum(
        ).backward()
        grads.append([t.grad for t in tens])
    results["grad_max_abs_err"] = max(
        _compare_grad(a, r, f"exact render gradient {n} against R's")
        for a, r, n in zip(*grads, ("sigmas", "coords", "colors")))
    return results


# The torch ops that built the exact lists before kernel XB (exact_tables:
# prefix sums, searchsorted, scatters, gathers; its index_put_ also builds
# the pad row, so it does not tell them apart); phase 37's path may run
# none of them.
EXACT_LIST_OPS = {"aten::searchsorted", "aten::cumsum", "aten::scatter_add_",
                  "aten::gather", "aten::repeat_interleave"}


# Phase 38: the 4D layout's shapes (windows, Tq = Tk, head width, type,
# bias, backward): the decoder's window at inference, its training step in
# fp32 and at the Enhanced width in bf16, and HAT's window of 16 (128
# windows of the Ultra step) in both types, with and without a bias; 6
# heads each.
ATTN4_SHAPES = [("decoder window, inference", 225, 144, 30, torch.float32,
                 True, False),
                ("training", 256, 144, 30, torch.float32, True, True),
                ("training", 256, 144, 32, torch.bfloat16, True, True),
                ("window 16", 128, 256, 32, torch.float32, True, True),
                ("window 16", 128, 256, 32, torch.float32, False, True),
                ("window 16", 128, 256, 32, torch.bfloat16, True, True),
                ("window 16", 128, 256, 32, torch.bfloat16, False, True)]
# The 4D forms' kernels in ptxas's reports: the tensor-core bodies with kHM
# set (3xTF32 in fp32: W's forward up to 160 tokens and W-long's
# beyond, WB's body in its two block
# sizes up to 160 and WB-long's two launches beyond).
FOURD_REG_KEYS = {
    "W4": [("window_attn_fwd_short_tf32_kernel", "ILb0ELb1E"),
           ("window_attn_fwd_long_tf32_kernel", "ILb0ELb1E")],
    "W4-bf16": [("window_attn_fwd_short_mma_kernel", "ILb0ELb1E"),
                ("window_attn_fwd_long_mma_kernel", "ILb0ELb1E")],
    "WB4": [("window_attn_bwd_short_tf32_kernel", "ILb0ELb1E"),
            ("window_attn_bwd_long_tf32_", "ILb0ELb1E")],
    "WB4-bf16": [("window_attn_bwd_short_mma_kernel", "ILb0ELb1E"),
                 ("window_attn_bwd_long_mma_", "ILb0ELb1E")],
}


@torch.no_grad()
def attention_4d_phase(dev, kernels):
    """Phase 38: W4 and WB4 (K14, K14b; their bf16 forms, and beyond 160
    tokens W-long's and WB-long's bodies on the head-major layout: in fp32
    W-long's 3xTF32 tensor-core body beyond 160 tokens and W's FMA body up
    to it, WB's 3xTF32 body up to 160 tokens and WB-long's beyond; in bf16
    the tensor-core
    ones) against their plain versions at ATTN4_SHAPES, twice each for
    bits, with their ms (the fp32 3xTF32 forms' beside the FMA bodies' that
    PERF.md records), the plain versions', the packed W / WB (or their
    window-16 and bf16 forms) on packed copies of the same operands, SDPA
    forward and backward on the 4D operands as the library call, and
    bounds (the function's products at the type's peak, the fp32 3xTF32
    forms' at the TF32 peak, or q, k, v, out (and g, dq, dk, dv), the f32
    bias and dbias); then the path: window_attention forward (and
    backward through autograd) once per shape, every count from zero; and
    ptxas's registers of the 4D kernels beside the packed forms' recorded
    ones."""
    from gsasr_torch.ops import _build
    from gsasr_torch.ops import attention as ta

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(38)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    nh = 6
    results = {k: [] for k in ("W4", "W4-bf16", "WB4", "WB4-bf16")}
    ops = []
    for name, b, t, hd, dt, has_bias, backward in ATTN4_SHAPES:
        bf = dt == torch.bfloat16
        sfx = "-bf16" if bf else ""
        long = t > ta._MAX_T
        q, k, v, g = (rnd(b, nh, t, hd).to(dt) for _ in range(4))
        bias = 0.5 * rnd(nh, t, t) if has_bias else None
        scale = hd ** -0.5
        ops.append((q, k, v, bias, g, backward))
        fwd, bwd = ta._FORMS4[bf]
        pfwd, pbwd = ta._FORMS[False, bf, long]
        packed = [x.transpose(1, 2).reshape(b, t, nh * hd)
                  for x in (q, k, v, g)]
        act = 2 if bf else 4
        peak = PEAK_BF16 if bf else PEAK_FP32
        nbias = 0 if bias is None else 4 * nh * t * t
        label = f"{name} {b}x{nh}x{t}x{hd} {str(dt)[6:]}" + (
            "" if has_bias else ", no bias")
        lib_f, lib_b, why = _sdpa_ms(q, k, v, None if bias is None else
                                     bias.to(dt)[None], g, None, scale)
        fargs = (q, k, v, bias, scale)
        out, ref = fwd(*fargs), ta.window_attention_plain(*fargs)
        err = (_compare_bf16(out, ref, f"W4{sfx} {label}") if bf
               else _compare(out, ref, f"W4{sfx} {label}"))
        _repeatable(lambda: (fwd(*fargs),), f"W4{sfx} {label}")
        # W4 in fp32 (3xTF32 bodies at every length): three TF32 products
        # each
        bound, by = _bound_ms((4.0 if bf else 12.0) * b * nh * t * t * hd,
                              act * 4 * b * nh * t * hd + nbias,
                              peak if bf else PEAK_TF32)
        row = dict(case=name, dtype=str(dt)[6:], windows=b, tokens=t,
                   head_width=hd, bias=has_bias, per_step=1,
                   max_abs_err=err, ms=_time_ms(lambda: fwd(*fargs), 10),
                   plain_ms=_time_ms(lambda: ta.window_attention_plain(
                       *fargs), 3),
                   packed_ms=_time_ms(lambda: pfwd(
                       *packed[:3], bias, scale, nh), 10),
                   bound_ms=bound, bound_by=by, library_ms=lib_f)
        results["W4" + sfx].append(row)
        if not backward:
            continue
        bargs = (q, k, v, bias, g, scale)
        outs, refs = bwd(*bargs), ta.window_attention_bwd_plain(*bargs)
        if bf:
            err = max(_compare_bf16(o, r, f"WB4-bf16 {label} {n}")
                      for o, r, n in zip(outs[:3], refs[:3], "qkv"))
            if bias is not None:
                err = max(err, _compare_grad(outs[3], refs[3],
                                             f"WB4-bf16 {label} dbias"))
        else:
            err = _compare_grads(outs, refs, ("dq", "dk", "dv", "dbias"),
                                 f"WB4 {label}")
        _repeatable(lambda: bwd(*bargs), f"WB4{sfx} {label}")
        if why:
            print(f"  WB4{sfx} {label} library: null ({why})", flush=True)
        # WB4 in fp32 runs a 3xTF32 body at every length
        bound, by = _bound_ms((10.0 if bf else 30.0) * b * nh * t * t * hd,
                              act * 7 * b * nh * t * hd + 2 * nbias,
                              peak if bf else PEAK_TF32)
        results["WB4" + sfx].append(dict(
            row, max_abs_err=err, ms=_time_ms(lambda: bwd(*bargs), 10),
            plain_ms=_time_ms(lambda: ta.window_attention_bwd_plain(
                *bargs), 3),
            packed_ms=_time_ms(lambda: pbwd(*packed[:3], bias, packed[3],
                                            scale, nh), 10),
            bound_ms=bound, bound_by=by, library_ms=lib_b,
            library_null_reason=why))
    for key, rows in results.items():
        for r in rows:
            lib = "null" if r["library_ms"] is None else \
                f"{r['library_ms']:.4f}"
            case = (f"{r['case']} {r['windows']}x{nh}x{r['tokens']}x"
                    f"{r['head_width']} {r['dtype']}"
                    f"{'' if r['bias'] else ', no bias'}")
            fma = FMA_MS.get((key, case))
            was = "" if fma is None else f", FMA body as recorded {fma}"
            print(f"  {key} {case}: {r['ms']:.4f} ms (packed "
                  f"{r['packed_ms']:.4f}, plain {r['plain_ms']:.4f}, bound "
                  f"{r['bound_ms']:.4f} by {r['bound_by']}, SDPA "
                  f"{lib}{was})", flush=True)

    # the path: window_attention through autograd, counts from zero
    _reset(kernels)
    for q, k, v, bias, g, backward in ops:
        with torch.enable_grad():
            qg = q.detach().requires_grad_(backward)
            y = ta.window_attention(qg, k, v, bias)
            if backward:
                y.backward(g)
        if not bool(torch.isfinite(y).all()):
            raise AssertionError("window_attention: non-finite output")
    torch.cuda.synchronize()
    counts = _counts(kernels)
    want = dict({k: 0 for k in kernels}, **{
        f: sum(1 for *_, dt, _, bw in ATTN4_SHAPES if f.endswith("-bf16") ==
               (dt == torch.bfloat16) and (bw or f.startswith("W4")))
        for f in results})
    print(f"  4D window attention path: launches "
          f"{ {k: c for k, c in counts.items() if c} }", flush=True)
    if counts != want:
        raise AssertionError(f"4D window attention launch counts {counts}")

    regs = {}
    for src in ("window_attn_fwd", "window_attn_bwd"):
        regs.update(_ptxas_kernels(_build.ptxas_report(src), ""))
    kept, new = {}, {}
    for form in FOURD_REG_KEYS:
        for name, (r_, st, ld) in _form_regs(regs, form,
                                             FOURD_REG_KEYS).items():
            print(f"  ptxas {form} {name}: {r_} registers, {st}/{ld} bytes "
                  "spilled", flush=True)
            new.setdefault(form, []).append(r_)
    for form in PACKED_REG_KEYS:
        kept[form] = tuple(sorted(
            r_ for r_, _, _ in _form_regs(regs, form,
                                          PACKED_REG_KEYS).values()))
    same = kept == PACKED_REGS_RECORDED
    print(f"  registers of the packed forms: {kept}, "
          f"{'kept' if same else 'MOVED'} (recorded: "
          f"{PACKED_REGS_RECORDED})", flush=True)
    results.update(path_launches=counts, registers=new,
                   packed_registers=kept, packed_registers_kept=same,
                   short_registers=short_tf32_registers(["W4"]))
    return results


FORM_KEYS = ("decoder", "case", "dtype", "nW", "windows", "tokens",
             "head_width", "bias", "per_image", "per_step", "per_swinir_step",
             "max_abs_err", "ms", "ms_back_to_back", "window16_ms",
             "plain_ms", "packed_ms", "bound_ms", "bound_by",
             "library_ms", "memberships", "used_chunks", "build_ms",
             "host_ms")


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


def kernel_wrappers():
    """Every kernel's wrapper by its name in the {"kernels": ...} line: the
    launch counts the phases reset and read."""
    from gsasr_torch.ops.attention import (
        window_attention_4d_bf16_bwd, window_attention_4d_bf16_fwd,
        window_attention_4d_bwd, window_attention_4d_fwd,
        window_attention_packed_bf16_bwd, window_attention_packed_bf16_fwd,
        window_attention_packed_bwd, window_attention_packed_fwd,
        window_attention_packed_long_bf16_bwd,
        window_attention_packed_long_bf16_fwd,
        window_attention_packed_long_bwd, window_attention_packed_long_fwd,
        window_attention_packed_long_masked_bf16_bwd,
        window_attention_packed_long_masked_bf16_fwd,
        window_attention_packed_long_masked_bwd,
        window_attention_packed_long_masked_fwd,
        window_attention_packed_masked_bf16_bwd,
        window_attention_packed_masked_bf16_fwd,
        window_attention_packed_masked_bwd,
        window_attention_packed_masked_fwd)
    from gsasr_torch.ops.bias_table import bias_table_bwd
    from gsasr_torch.ops.fused_layers import (ln_attn_proj, ln_attn_proj_bwd,
                                              ln_attn_proj_bwd_long,
                                              ln_attn_proj_long,
                                              ln_mlp_residual,
                                              ln_mlp_residual_bwd)
    from gsasr_torch.ops.rasterizer import (exact_build, raster_bwd,
                                            raster_fwd, raster_fwd_exact)

    return {"R": raster_fwd, "M": ln_mlp_residual, "A": ln_attn_proj,
            "W": window_attention_packed_fwd,
            "WB": window_attention_packed_bwd, "RB": raster_bwd,
            "MB": ln_mlp_residual_bwd, "AB": ln_attn_proj_bwd,
            "T": bias_table_bwd, "WM": window_attention_packed_masked_fwd,
            "WMB": window_attention_packed_masked_bwd,
            "W-bf16": window_attention_packed_bf16_fwd,
            "WB-bf16": window_attention_packed_bf16_bwd,
            "W-long": window_attention_packed_long_fwd,
            "W-long-bf16": window_attention_packed_long_bf16_fwd,
            "A-long": ln_attn_proj_long,
            "WB-long": window_attention_packed_long_bwd,
            "WB-long-bf16": window_attention_packed_long_bf16_bwd,
            "WM-bf16": window_attention_packed_masked_bf16_fwd,
            "WMB-bf16": window_attention_packed_masked_bf16_bwd,
            "WM-long": window_attention_packed_long_masked_fwd,
            "WMB-long": window_attention_packed_long_masked_bwd,
            "WM-long-bf16": window_attention_packed_long_masked_bf16_fwd,
            "WMB-long-bf16":
                window_attention_packed_long_masked_bf16_bwd,
            "AB-long": ln_attn_proj_bwd_long,
            "R-exact": raster_fwd_exact, "XB": exact_build,
            "W4": window_attention_4d_fwd,
            "W4-bf16": window_attention_4d_bf16_fwd,
            "WB4": window_attention_4d_bwd,
            "WB4-bf16": window_attention_4d_bf16_bwd}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", help="write the details to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    from gsasr_torch.model import make_models
    from gsasr_torch.ops import _build

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

    kernels = kernel_wrappers()
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
    gc.collect()
    torch.cuda.empty_cache()

    enc_e, dec_e = enhanced_networks("edsr")
    print("Enhanced training kernel phase", flush=True)
    etres = enhanced_train_kernel_phase(dec_e.to(dev), dev)
    del enc_e, dec_e
    gc.collect()
    torch.cuda.empty_cache()
    print("Enhanced training phase", flush=True)
    etrain = train_phase(dev, kernels, fused=False, enhanced=torch.bfloat16)
    print("Enhanced training card vs CPU", flush=True)
    etcvc = enhanced_train_card_vs_cpu(dev)
    gc.collect()
    torch.cuda.empty_cache()

    enc_re, dec_re = make_models("rdn", "enhanced",
                                 generator=torch.Generator().manual_seed(0))
    print("RDN-Enhanced path phase", flush=True)
    rerun = path_phase(enc_re, dec_re, dev, kernels, label="RDN-Enhanced",
                       extra=RDN_ENHANCED_PER_FORWARD)
    print("RDN-Enhanced end to end", flush=True)
    ree2e = e2e_phase(enc_re, dec_re, dev, label="RDN-Enhanced")
    del enc_re, dec_re
    gc.collect()
    torch.cuda.empty_cache()

    enc_se, dec_se = make_models("swinir", "enhanced",
                                 generator=torch.Generator().manual_seed(0))
    print("SwinIR-Enhanced path phase", flush=True)
    seruns = path_phase(enc_se, dec_se, dev, kernels,
                        label="SwinIR-Enhanced", denominator=ULTRA_DENOMINATOR,
                        extra=SWINIR_ENHANCED_PER_FORWARD)
    print("SwinIR-Enhanced end to end", flush=True)
    see2e = e2e_phase(enc_se, dec_se, dev, label="SwinIR-Enhanced",
                      denominator=ULTRA_DENOMINATOR)
    del enc_se, dec_se
    gc.collect()
    torch.cuda.empty_cache()

    enc_u, dec_u = make_models("hat", "ultra",
                               generator=torch.Generator().manual_seed(0))
    print("Ultra kernel phase", flush=True)
    ures = ultra_kernel_phase(dec_u, dev)
    print("Ultra path phase", flush=True)
    uruns = path_phase(enc_u, dec_u, dev, kernels, label="HAT-L Ultra",
                       denominator=ULTRA_DENOMINATOR,
                       extra=ULTRA_PER_FORWARD)
    print("Ultra card vs CPU", flush=True)
    ucvc = card_vs_cpu(enc_u, dec_u, dev, torch.bfloat16, CARD_CPU_ATOL_BF16,
                       label="HAT-L Ultra", denominator=ULTRA_DENOMINATOR)
    print("Ultra end to end", flush=True)
    ue2e = e2e_phase(enc_u, dec_u, dev, label="HAT-L Ultra",
                     denominator=ULTRA_DENOMINATOR)
    del enc_u, dec_u
    gc.collect()
    torch.cuda.empty_cache()

    enc_ut, dec_ut = enhanced_networks("hat")
    print("Ultra training kernel phase", flush=True)
    utres = ultra_train_kernel_phase(enc_ut.to(dev).eval(),
                                     dec_ut.to(dev).eval(), dev)
    del enc_ut, dec_ut
    gc.collect()
    torch.cuda.empty_cache()
    print("Ultra training phase", flush=True)
    utrain = train_phase(dev, kernels, fused=False, encoder="hat",
                         ultra=torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    utrain32 = train_phase(dev, kernels, fused=False, encoder="hat",
                           ultra=torch.float32)
    print(f"  HAT-L Ultra float32 step median {utrain32['step_ms_median']:.1f}"
          f" ms (on the FMA backward: not recorded; "
          f"scripts/ab_torch_sources.py --steps times both)", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print("Ultra training card vs CPU", flush=True)
    utcvc = ultra_train_card_vs_cpu(dev)
    gc.collect()
    torch.cuda.empty_cache()

    enc_ub, dec_ub = make_models("hat", "ultra", dtype=torch.bfloat16,
                                 generator=torch.Generator().manual_seed(0))
    print("Ultra bf16 path phase", flush=True)
    ubruns = path_phase(enc_ub, dec_ub, dev, kernels,
                        label="HAT-L Ultra bf16",
                        denominator=ULTRA_DENOMINATOR,
                        extra=ULTRA_BF16_PER_FORWARD)
    print("Ultra bf16 end to end", flush=True)
    ube2e = e2e_phase(enc_ub, dec_ub, dev, label="HAT-L Ultra bf16",
                      denominator=ULTRA_DENOMINATOR)
    del enc_ub, dec_ub
    gc.collect()
    torch.cuda.empty_cache()

    enc_ef, dec_ef = enhanced_networks("edsr")
    print("Enhanced fused training kernel phase", flush=True)
    efres = enhanced_fused_kernel_phase(dec_ef.to(dev).eval(), dev)
    del enc_ef, dec_ef
    gc.collect()
    torch.cuda.empty_cache()
    print("Enhanced fused training phase", flush=True)
    eftrain = train_phase(dev, kernels, fused=True, enhanced=torch.bfloat16)
    print(f"  Enhanced fused vs module step median, batch "
          f"{eftrain['batch']}: {eftrain['step_ms_median']:.1f} vs "
          f"{etrain['step_ms_median']:.1f} ms; peak "
          f"{eftrain['peak_mem_bytes'] / 2**30:.2f} vs "
          f"{etrain['peak_mem_bytes'] / 2**30:.2f} GiB", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    eftrain32 = train_phase(dev, kernels, fused=True, enhanced=torch.float32)
    gc.collect()
    torch.cuda.empty_cache()
    print("Enhanced fused training card vs CPU", flush=True)
    eftcvc = enhanced_train_card_vs_cpu(dev, fused=True)
    gc.collect()
    torch.cuda.empty_cache()

    enc_sb, dec_sb = make_models("swinir", "enhanced", dtype=torch.bfloat16,
                                 generator=torch.Generator().manual_seed(0))
    enc_h, dec_h = hat_paper_networks()
    enc_h, dec_h = enc_h.to(dev).eval(), dec_h.to(dev).eval()
    print("masked kernel phase", flush=True)
    mres = masked_kernel_phase(enc_sb, enc_h, dev)
    print("SwinIR bf16 training phase", flush=True)
    sbtrain = train_phase(dev, kernels, fused=False, encoder="swinir",
                          enhanced=torch.bfloat16)
    print("SwinIR bf16 training card vs CPU", flush=True)
    sbtcvc = enhanced_train_card_vs_cpu(dev, encoder="swinir")
    print("SwinIR-Enhanced bf16 path phase", flush=True)
    sbruns = path_phase(enc_sb, dec_sb, dev, kernels,
                        label="SwinIR-Enhanced bf16",
                        denominator=ULTRA_DENOMINATOR,
                        extra=SWINIR_ENHANCED_BF16_PER_FORWARD)
    print("SwinIR-Enhanced bf16 end to end", flush=True)
    sbe2e = e2e_phase(enc_sb, dec_sb, dev, label="SwinIR-Enhanced bf16",
                      denominator=ULTRA_DENOMINATOR)
    del enc_sb, dec_sb
    gc.collect()
    torch.cuda.empty_cache()
    print("paper HAT path phase", flush=True)
    hruns = path_phase(enc_h, dec_h, dev, kernels, label="paper HAT",
                       denominator=HAT_PAPER_DENOMINATOR,
                       extra=HAT_PAPER_PER_FORWARD)
    print("paper HAT card vs CPU", flush=True)
    hcvc = card_vs_cpu(enc_h, dec_h, dev, label="paper HAT",
                       denominator=HAT_PAPER_DENOMINATOR)
    print("paper HAT end to end", flush=True)
    he2e = e2e_phase(enc_h, dec_h, dev, label="paper HAT",
                     denominator=HAT_PAPER_DENOMINATOR)
    del enc_h, dec_h
    gc.collect()
    torch.cuda.empty_cache()
    print("paper HAT training phase", flush=True)
    htrain = train_phase(dev, kernels, fused=False, encoder="hat_paper")
    print(f"  paper HAT float32 step median {htrain['step_ms_median']:.1f} "
          f"ms (on the FMA backward, as recorded: {FMA_HAT_PAPER_STEP_MS})",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print("paper HAT bf16 training phase", flush=True)
    hbtrain = train_phase(dev, kernels, fused=False, encoder="hat_paper",
                          enhanced=torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()

    _, dec_uf = enhanced_networks("hat")
    print("AB-long kernel phase", flush=True)
    abres = ab_long_kernel_phase(dec_uf.to(dev).eval(), dev)
    del dec_uf
    gc.collect()
    torch.cuda.empty_cache()
    print("Ultra fused training phase", flush=True)
    uftrain = train_phase(dev, kernels, fused=True, encoder="hat",
                          ultra=torch.bfloat16)
    print(f"  HAT-L Ultra fused vs module step median, batch "
          f"{uftrain['batch']}: {uftrain['step_ms_median']:.1f} vs "
          f"{utrain['step_ms_median']:.1f} ms (forward "
          f"{uftrain['forward_ms']:.1f} vs {utrain['forward_ms']:.1f}, "
          f"backward {uftrain['backward_ms']:.1f} vs "
          f"{utrain['backward_ms']:.1f}, optimizer+EMA "
          f"{uftrain['optimizer_ema_ms']:.1f} vs "
          f"{utrain['optimizer_ema_ms']:.1f}); peak "
          f"{uftrain['peak_mem_bytes'] / 2**30:.2f} vs "
          f"{utrain['peak_mem_bytes'] / 2**30:.2f} GiB", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    uftrain32 = train_phase(dev, kernels, fused=True, encoder="hat",
                            ultra=torch.float32)
    gc.collect()
    torch.cuda.empty_cache()
    print("Ultra fused training card vs CPU", flush=True)
    ufcvc = ultra_train_card_vs_cpu(dev, fused=True)
    gc.collect()
    torch.cuda.empty_cache()
    print("SwinIR-Enhanced fused training phase", flush=True)
    sftrain = train_phase(dev, kernels, fused=True, encoder="swinir",
                          enhanced=torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    print("exact render phase", flush=True)
    xres = exact_render_phase(dev, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    print("4D window attention phase", flush=True)
    fres = attention_4d_phase(dev, kernels)
    for r in (train, ftrain, strain, etrain, utrain, eftrain, sbtrain,
              htrain, uftrain):
        same = "the same" if r["repeat"]["same_bits"] else "NOT the same"
        print(f"  {r['decoder']} step: repeatability {same} bits; cost of "
              f"cuDNN determinism {r['determinism']['cost_ms']:+.1f} ms on "
              f"Trainer.grads", flush=True)

    infer, step = runs[0]["launches"], train["launches"]
    sinfer, sstep = sruns[0]["launches"], strain["launches"]
    fstep, einfer = ftrain["launches"], eruns[0]["launches"]
    estep, uinfer = etrain["launches"], uruns[0]["launches"]
    ustep, ustep32 = utrain["launches"], utrain32["launches"]
    efstep = eftrain["launches"]
    sbstep, hstep = sbtrain["launches"], htrain["launches"]
    hbstep, sbinfer = hbtrain["launches"], sbruns[0]["launches"]
    hinfer = hruns[0]["launches"]
    ufstep = uftrain["launches"]
    enhanced = "sr_forward (Enhanced, bf16 trunk)"
    for k in ("M", "A"):
        for r in kres[k]:
            r.update(dtype="float32", decoder="paper")
        for r in ekres[k]:
            r["decoder"] = "Enhanced"
    for r in ures["M"]:
        r["decoder"] = "HAT-L Ultra"
    for k in ("MB", "AB"):
        for r in kres[k]:
            r.update(dtype="float32", decoder="paper")
    efpath = "Trainer.step (Enhanced, fused_decoder=True, bf16 recipe)"
    # Each kernel: (name, source, replaces, also replaces, launch counts,
    # path, the rows timed on that path, the rows of its other forms and
    # shapes or None). A row's per_image / per_step is its launches on the
    # path of its own run; rows with none are left out of the mean.
    meta = {
        "R": ("raster_fwd", "gsasr_torch/ops/csrc/raster_fwd.cu",
              "gsasr_tpu/ops/rasterizer.py:334",
              ["gsasr_tpu/ops/rasterizer.py:254",
               "gsasr_tpu/ops/rasterizer.py:126"], infer, "sr_forward",
              kres["R"], kres["R"] + kres["R-step"] + utres["R"]),
        "M": ("ln_mlp", "gsasr_torch/ops/csrc/ln_mlp.cu",
              "gsasr_tpu/ops/fused_layers.py:122", [], einfer, enhanced,
              _on_path(ekres["M"], "per_image"),
              kres["M"] + ekres["M"] + ures["M"]),
        "A": ("ln_attn", "gsasr_torch/ops/csrc/ln_attn.cu",
              "gsasr_tpu/ops/fused_layers.py:336", [], einfer, enhanced,
              _on_path(ekres["A"], "per_image"), kres["A"] + ekres["A"]),
        "W": ("window_attn_fwd",
              "gsasr_torch/ops/csrc/window_attn_short_tf32.cuh",
              "gsasr_tpu/ops/attention.py:338", [], step, "Trainer.step",
              kres["W"], sres["W"]),
        "WB": ("window_attn_bwd",
               "gsasr_torch/ops/csrc/window_attn_short_tf32_bwd.cuh",
               "gsasr_tpu/ops/attention.py:397", [], step, "Trainer.step",
               kres["WB"], sres["WB"]),
        "RB": ("raster_bwd", "gsasr_torch/ops/csrc/raster_bwd.cu",
               "gsasr_tpu/ops/rasterizer.py:232",
               ["gsasr_tpu/ops/rasterizer.py:166",
                "gsasr_tpu/ops/rasterizer.py:308"], step, "Trainer.step",
               kres["RB"], kres["RB"] + utres["RB"]),
        "MB": ("ln_mlp_bwd", "gsasr_torch/ops/csrc/ln_mlp_bwd.cu",
               "gsasr_tpu/ops/fused_layers.py:146", [], efstep, efpath,
               _on_path(efres["MB"], "per_step"),
               kres["MB"] + efres["MB"] + abres["MB"]),
        "AB": ("ln_attn_bwd", "gsasr_torch/ops/csrc/ln_attn_bwd.cu",
               "gsasr_tpu/ops/fused_layers.py:381", [], efstep, efpath,
               _on_path(efres["AB"], "per_step"), kres["AB"] + efres["AB"]),
        "T": ("bias_table_bwd", "gsasr_torch/ops/csrc/bias_table_bwd.cu",
              "no Pallas kernel: the gradient of the bias-table gather "
              "(gsasr_tpu/models/fea2gs.py:142,173) is XLA's", [], step,
              "Trainer.step", kres["T"], None),
        "WM": ("window_attn_fwd_masked",
               "gsasr_torch/ops/csrc/window_attn_short_tf32.cuh",
               "gsasr_tpu/ops/attention.py:553", [], sinfer,
               "sr_forward (SwinIR)", _on_path(sres["WM"], "per_image"),
               sres["WM"]),
        "WMB": ("window_attn_bwd_masked",
                "gsasr_torch/ops/csrc/window_attn_short_tf32_bwd.cuh",
                "gsasr_tpu/ops/attention.py:661", [], sstep,
                "Trainer.step (SwinIR)", _on_path(sres["WMB"], "per_step"),
                sres["WMB"]),
        "W-bf16": ("window_attn_fwd_bf16",
                   "gsasr_torch/ops/csrc/window_attn_short_mma.cuh",
                   "gsasr_tpu/ops/attention.py:338", [], estep,
                   "Trainer.step (Enhanced, bf16 recipe)",
                   _on_path(etres["W-bf16"], "per_step"), etres["W-bf16"]),
        "WB-bf16": ("window_attn_bwd_bf16",
                    "gsasr_torch/ops/csrc/window_attn_short_mma_bwd.cuh",
                    "gsasr_tpu/ops/attention.py:397", [], estep,
                    "Trainer.step (Enhanced, bf16 recipe)",
                    _on_path(etres["WB-bf16"], "per_step"),
                    etres["WB-bf16"]),
        "W-long": ("window_attn_fwd_long",
                   "gsasr_torch/ops/csrc/window_attn_long_tf32.cuh",
                   "gsasr_tpu/ops/attention.py:338", [], uinfer,
                   "sr_forward (HAT-L Ultra)", ures["W-long"],
                   ures["W-long"]),
        "W-long-bf16": ("window_attn_fwd_long_bf16",
                        "gsasr_torch/ops/csrc/window_attn_long_mma.cuh",
                        "gsasr_tpu/ops/attention.py:338", [], ustep,
                        "Trainer.step (HAT-L Ultra, bf16 recipe)",
                        _on_path(utres["W-long-bf16"], "per_step"),
                        ures["W-long-bf16"] + utres["W-long-bf16"]),
        "WB-long": ("window_attn_bwd_long",
                    "gsasr_torch/ops/csrc/window_attn_long_tf32_bwd.cuh",
                    "gsasr_tpu/ops/attention.py:397", [], ustep32,
                    "Trainer.step (HAT-L Ultra, model_dtype float32)",
                    _on_path(utres["WB-long"], "per_step"),
                    utres["WB-long"]),
        "WB-long-bf16": ("window_attn_bwd_long_bf16",
                         "gsasr_torch/ops/csrc/window_attn_long_mma_bwd.cuh",
                         "gsasr_tpu/ops/attention.py:397", [], ustep,
                         "Trainer.step (HAT-L Ultra, bf16 recipe)",
                         _on_path(utres["WB-long-bf16"], "per_step"),
                         utres["WB-long-bf16"]),
        "A-long": ("ln_attn_long", "gsasr_torch/ops/csrc/ln_attn.cu",
                   "gsasr_tpu/ops/fused_layers.py:336", [], uinfer,
                   "sr_forward (HAT-L Ultra, bf16 trunk)",
                   _on_path(ures["A-long"], "per_image"), ures["A-long"]),
        "WM-bf16": ("window_attn_fwd_masked_bf16",
                    "gsasr_torch/ops/csrc/window_attn_short_mma.cuh",
                    "gsasr_tpu/ops/attention.py:553", [], sbstep,
                    "Trainer.step (SwinIR, bf16 recipe)",
                    _on_path(mres["WM-bf16"], "per_step"), mres["WM-bf16"]),
        "WMB-bf16": ("window_attn_bwd_masked_bf16",
                     "gsasr_torch/ops/csrc/window_attn_short_mma_bwd.cuh",
                     "gsasr_tpu/ops/attention.py:661", [], sbstep,
                     "Trainer.step (SwinIR, bf16 recipe)",
                     _on_path(mres["WMB-bf16"], "per_step"),
                     mres["WMB-bf16"]),
        "WM-long": ("window_attn_fwd_long_masked",
                    "gsasr_torch/ops/csrc/window_attn_long_tf32.cuh",
                    "gsasr_tpu/ops/attention.py:553", [], hstep,
                    "Trainer.step (paper HAT, paper recipe)",
                    _on_path(mres["WM-long"], "per_step"), mres["WM-long"]),
        "WMB-long": ("window_attn_bwd_long_masked",
                     "gsasr_torch/ops/csrc/window_attn_long_tf32_bwd.cuh",
                     "gsasr_tpu/ops/attention.py:661", [], hstep,
                     "Trainer.step (paper HAT, paper recipe)",
                     _on_path(mres["WMB-long"], "per_step"),
                     mres["WMB-long"]),
        "WM-long-bf16": ("window_attn_fwd_long_masked_bf16",
                         "gsasr_torch/ops/csrc/window_attn_long_mma.cuh",
                         "gsasr_tpu/ops/attention.py:553", [], hbstep,
                         "Trainer.step (paper HAT in bf16, Enhanced "
                         "decoder)",
                         _on_path(mres["WM-long-bf16"], "per_step"),
                         mres["WM-long-bf16"]),
        "WMB-long-bf16": ("window_attn_bwd_long_masked_bf16",
                          "gsasr_torch/ops/csrc/"
                          "window_attn_long_mma_bwd.cuh",
                          "gsasr_tpu/ops/attention.py:661", [], hbstep,
                          "Trainer.step (paper HAT in bf16, Enhanced "
                          "decoder)",
                          _on_path(mres["WMB-long-bf16"], "per_step"),
                          mres["WMB-long-bf16"]),
        "AB-long": ("ln_attn_bwd_long", "gsasr_torch/ops/csrc/ln_attn_bwd.cu",
                    "gsasr_tpu/ops/fused_layers.py:381", [], ufstep,
                    "Trainer.step (HAT-L Ultra, fused_decoder=True, bf16 "
                    "recipe)", _on_path(abres["AB-long"], "per_step"),
                    abres["AB-long"]),
        "R-exact": ("raster_fwd_exact", "gsasr_torch/ops/csrc/raster_fwd.cu",
                    "gsasr_tpu/ops/rasterizer.py:334",
                    ["gsasr_tpu/ops/rasterizer.py:732"],
                    xres["regimes"][0]["launches"],
                    "exact render (gs_render(binning=\"exact\"), 720x720, "
                    "518,400 Gaussians)", xres["R-exact"], xres["R-exact"]),
        "XB": ("exact_build", "gsasr_torch/ops/csrc/exact_build.cu",
               "no Pallas kernel: the exact lists of _exact_tables "
               "(gsasr_tpu/ops/rasterizer.py:624) are XLA ops", [],
               xres["regimes"][0]["launches"],
               "exact render (gs_render(binning=\"exact\"), 720x720, "
               "518,400 Gaussians)", xres["XB"][:1], xres["XB"]),
    }
    for key, rep in (("W4", "gsasr_tpu/ops/attention.py:87"),
                     ("WB4", "gsasr_tpu/ops/attention.py:109")):
        entry = "window_attn_fwd_4d" if key == "W4" else "window_attn_bwd_4d"
        for sfx in ("", "-bf16"):
            # the bodies of the first rows (up to 160 tokens): W's and WB's
            # 3xTF32 bodies; in bf16 the tensor-core bodies
            src = "gsasr_torch/ops/csrc/" + (
                ("window_attn_short_tf32.cuh" if key == "W4" else
                 "window_attn_short_tf32_bwd.cuh")
                if not sfx else "window_attn_short_mma.cuh" if key == "W4"
                else "window_attn_short_mma_bwd.cuh")
            meta[key + sfx] = (
                entry + sfx.replace("-", "_"), src, rep, [],
                fres["path_launches"], "4D window attention "
                "(window_attention, forward and backward)",
                fres[key + sfx], fres[key + sfx])
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
                           enhanced_train=dict(kernels=etres, train=etrain,
                                               card_vs_cpu=etcvc),
                           rdn_enhanced=dict(paths=rerun, e2e=ree2e),
                           swinir_enhanced=dict(paths=seruns, e2e=see2e),
                           ultra=dict(kernels=ures, paths=uruns,
                                      card_vs_cpu=ucvc, e2e=ue2e),
                           ultra_train=dict(kernels=utres, train=utrain,
                                            train_fp32=utrain32,
                                            card_vs_cpu=utcvc),
                           ultra_bf16=dict(paths=ubruns, e2e=ube2e),
                           enhanced_fused_train=dict(
                               kernels=efres, train=eftrain,
                               train_fp32=eftrain32, card_vs_cpu=eftcvc),
                           masked_kernels=mres,
                           swinir_bf16=dict(train=sbtrain,
                                            train_card_vs_cpu=sbtcvc,
                                            paths=sbruns, e2e=sbe2e,
                                            infer_launches=sbinfer),
                           hat_paper=dict(paths=hruns, card_vs_cpu=hcvc,
                                          e2e=he2e, train=htrain,
                                          train_bf16=hbtrain,
                                          infer_launches=hinfer),
                           ultra_fused_train=dict(
                               kernels=abres, train=uftrain,
                               train_fp32=uftrain32, card_vs_cpu=ufcvc),
                           swinir_fused_train=sftrain,
                           exact_render=xres, attention_4d=fres,
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
