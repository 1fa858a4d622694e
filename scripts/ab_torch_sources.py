#!/usr/bin/env python3
"""Compare the port's CUDA sources of a parent checkout with this tree's on
one card: ptxas's registers of every kernel of the named sources, kernels
R's and RB's times, kernels M's, A's and A-long's, the bf16 window
attention's up to 160 tokens (W-bf16, WB-bf16 and their masked forms
WM-bf16, WMB-bf16) from both builds in turns
(parent, change, change, parent, ...), with the window-16 routing (this
tree's W-long-bf16 and WB-long-bf16 on the same operands) beside them, and
the fp32 window attentions (the window-16 forward W-long, WM-long,
W4-long; the backward up to 160 tokens WB, WMB, WB4; the window-16
backward WB-long, WMB-long, WB4-long) from every build in turns.

  python3 scripts/ab_torch_sources.py --parent DIR [--label NAME]
      [--parent DIR2 --label NAME2 ...] [--skip-raster]
      [--fp32-only | --fused-only | --fused-bwd-only | --raster-only]
      [--steps] [--images] [--turns N] [--json PATH]

DIR holds the parent's `gsasr_torch/ops/csrc` (for example
`git archive <parent> gsasr_torch/ops | tar -x -C DIR`; with the parent's
`_build.py` beside it, a build whose entry points take other arguments than
this tree's is refused, save RB's, below), or a variant of this tree's
sources, named in the output by --label; further --parent DIR --label NAME pairs add variants, which only
the fp32 sections time (the other sections take the first). All builds
use `gsasr_torch/ops/_build.py`'s flags and go to build/ab_sources/. R and
RB run on chip_smoke.RASTER_WORKLOADS: the paper image's 720x720 render,
the paper step's 3072x192 and the Ultra step's 8192x1024 slot canvases of
the seeded networks' Gaussians, and chip_smoke.py's exact-render workloads
(scripts/bench_exact_render.py's 720x720 render of 518,400 Gaussians,
trained-like and init-like boxes), chunked as `gs_render` chunks them; each
build's R is held to the plain version within chip_smoke.py's tolerance and
to the same bits twice, this tree's R to the first build's bits; each
build's RB within GRAD_TOL of the plain version and to the same bits twice;
one call and ten back to back (--skip-raster leaves them out;
--raster-only builds raster_fwd.cu and raster_bwd.cu alone and times them
from every build). A parent whose RB took the chunk boxes (before this
tree's) is called with them. The bf16 attention runs at the
Enhanced training step's shape (256 windows of 144 tokens, 6 heads of 32,
no bias), at the bf16 SwinIR step's unshifted blocks (576 windows of 64
tokens, 6 heads of 30, a bias) and at its shifted blocks (the same with the
SW-MSA mask of period 36: WM-bf16, WMB-bf16); each build's result must hold
against the plain version within the bf16 tolerance (2^-7 |ref| + 2^-8
max|ref|), and the largest difference between the two builds is printed.
The fp32 window-16 forward runs W-long at the fp32 Ultra image's 144 and
the Ultra step's 128 windows of 256 x 256 and 256 x 576, WM-long at the
paper HAT's 144 x 256 x 256 x 30 with a bias and the mask of period 9,
W4-long at 128 x 6 x 256 x 32 with a bias, and W at the paper step's 256 x
6 x 144 x 30 beside this tree's W-long on its operands; the fp32 backward
up to 160 tokens WB at the paper step's shape and SwinIR's 576 x 6 x 64 x
30 (with a bias and without), WMB at SwinIR's with a bias and the mask of
period 36 and WB4 at 256 x 6 x 144 x 30 with a bias; the fp32 window-16
backward WB-long at the fp32 Ultra step's shapes (128 windows of 256 x 256
and 256 x 576, 6 heads of 32, no bias), WMB-long at the paper HAT step's
(144 windows of 256 x 256, 6 heads of 30, a bias and the SW-MSA mask of
period 9), and WB4-long on the head-major layout at 128 x 6 x 256 x 256 x
32 with a bias. Each fp32 build's results must hold against the plain
version (forward atol = rtol = 1e-4; backward within 1e-4 of each output's
largest entry) and give the same bits twice. The fp32 forward also runs
the forms up to 160 tokens: W at the paper step's 256 x 6 x 144 x 30
beside this tree's W-long on the same operands, W at SwinIR's 576 x 6 x 64
x 30, WM there with the mask of period 36 and W4 at the paper image's 225
x 6 x 144 x 30, each with a bias, one call and ten back to back.
--fp32-only builds window_attn_fwd.cu, window_attn_bwd.cu and ln_attn.cu
alone and times only the fp32 window attentions and kernel A in fp32 at
the paper decoder's shape (its attention runs W's body up to 160 tokens).
--raster-only also times the exact render from both builds in turns
(`_exact_ab`: R-exact's walk on phase 37's trained-like lists, asserted
the first build's bits, and the whole gs_render(binning="exact") path and
its list build on both of phase 37's workloads, each build with its own
R-exact and lists: this tree's kernel XB, or exact_tables' torch ops
where the build's `_build.py` declares no XB). The fused section times
kernels M (ln_mlp.cu) and A and A-long
(ln_attn.cu) from every build in turns at the paper decoder's 225 x 144 x
180 in fp32, the Enhanced decoder's 225 x 144 x 192 in bf16 and the Ultra
decoder's 144 x 256 x 192 in bf16 and fp32 (RoPE for A-long), each held
to its plain version and to the same bits twice, one call a time and ten
back to back (the card's time without the host's); --fused-only builds
ln_mlp.cu and ln_attn.cu alone and times only that section. --images times the paper fp32, Enhanced
bf16 and HAT-L Ultra (fp32 and bf16) images with the first build's and
this tree's ln_mlp.cu, ln_attn.cu and raster_fwd.cu (those built) in
turns (with --fp32-only, ln_attn.cu alone: A's attention). --steps then times the paths that run the fp32 window attentions,
chip_smoke.py's paper EDSR module step (WB 38 a step), SwinIR step (WB 56,
WMB 18), HAT-L Ultra step at model_dtype float32 (W-long 148, WB-long 148),
paper HAT step (W-long 24, WM-long 18, WB-long 24, WMB-long 18, WB 38) and
the HAT-L Ultra image (W-long 84), or with --raster-only the paper EDSR
step and the bf16 HAT-L Ultra step (R 1, RB 1 each), with the first
build's and this tree's built sources in --turns pairs of turns, which
build goes first alternating (parent, change, change, parent, ...): their
entry points are swapped into the port's loaded kernels
(RB through rasterizer.raster_bwd), and the rest of the port is this
tree's. Each kernel's registers in every build are printed beside its
form.

--grid-bits (beside any section but --fused-bwd-only's and --raster-only's;
it adds ln_attn_bwd.cu to the built sources) runs every window attention
entry point (W, WM, W4, W-long, WM-long and their backward, fp32 and bf16)
and kernels A and AB through the port's wrappers with each build's entry
points swapped in, on the same operands, and asserts that every build
gives the first build's bits: at chip_smoke.py's phase-39 shapes at 65,532
windows (the largest count below 65,536 that the mask period divides) and
at the models' shapes (the paper step's 256 x 144 x 180 in 6 heads with a
bias, SwinIR's shifted 576 x 64 x 180 with the mask of period 36, the
head-major 256 x 6 x 144 x 30, HAT-L's 128 x 256 x 192, the paper HAT's
shifted 144 x 256 x 180 with the mask of period 9; A and AB at the paper
decoder's 256 x 144 x 180 cross-attention form).

--fused-bwd-only builds ln_mlp_bwd.cu, ln_attn_bwd.cu and window_attn_bwd.cu
(whose attention bodies AB shares) alone and times, from every build in
turns, kernels MB, AB and AB-long (`_fused_bwd_ab`: the paper step's 256
windows of 144 tokens at 180 channels in fp32, the Enhanced step's at 192
in bf16 and fp32, the Ultra step's 128 windows of 256 tokens at 192), each
build held to the plain version (GRAD_TOL in fp32, relative L2 2^-7 in
bf16) and to the same bits twice, one call a time and ten back to back,
with WB, WMB, WB4 and the window-16 backward (WB-long, WMB-long, WB4-long)
as the shared bodies' guard and WB-bf16 and WB-long-bf16 beside them; with
--steps the fused steps (`_fused_steps_ab`: chip_smoke.py's paper EDSR
step in fp32, Enhanced EDSR step and HAT-L Ultra step at their bf16
recipes, each with fused_decoder=True) with the first build's and this
tree's MB, AB and attention sources swapped in, in --turns pairs of
turns: the wall time of a step (median of three) and the device time of
one profiled step (the summed kernel time, torch.profiler).
"""

from __future__ import annotations

import argparse
import ast
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCES = ("raster_fwd", "raster_bwd", "window_attn_fwd", "window_attn_bwd",
           "ln_mlp", "ln_attn", "ln_mlp_bwd", "ln_attn_bwd")
# kernels R's and RB's sources
RASTER = ("raster_fwd", "raster_bwd")
# The sources whose entry points --steps and --images swap in turns
SWAPPED = ("window_attn_fwd", "window_attn_bwd", "ln_mlp", "ln_attn",
           "raster_fwd", "raster_bwd", "ln_mlp_bwd", "ln_attn_bwd")
# chip_smoke.train_phase's arguments of the steps --steps times: the paths
# of the fp32 window attentions, and with --raster-only the steps R's and
# RB's share of which moves most (the paper step and the Ultra bf16 step)
STEPS = {"paper EDSR step": dict(encoder="edsr"),
         "SwinIR float32 step": dict(encoder="swinir"),
         "HAT-L Ultra float32 step": dict(encoder="hat", ultra="float32"),
         "paper HAT float32 step": dict(encoder="hat_paper"),
         "HAT-L Ultra bf16 step": dict(encoder="hat", ultra="bfloat16")}
# M's and A's sources, which every build compiles
FUSED = ("ln_mlp", "ln_attn")
# MB's and AB's sources, and WB's, whose attention bodies AB runs
FUSED_BWD = ("ln_mlp_bwd", "ln_attn_bwd", "window_attn_bwd")


def _registers(log: str) -> dict:
    """{kernel: registers} of a ptxas -v log, the names without their
    translation unit's unique prefix; a kernel that spills is named with
    its spill stores and loads in bytes appended."""
    out, name, spill = {}, None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}|(?<=_cu_)[0-9a-f]{8}",
                          "", m.group(1))
            spill = ""
        sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                       r"loads", line)
        if sp and sp.groups() != ("0", "0"):
            spill = f" SPILLS {sp.group(1)}/{sp.group(2)}"
        r = re.search(r"Used (\d+) registers", line)
        if r and name:
            out[name + spill] = int(r.group(1))
    return out


# The moved forms' kernels: (source, name key, argument key) in the parent
# (the FMA body's bf16 instantiations) and in this tree (the tensor-core
# body's kernels up to 160 tokens, named by their flags kMask, kHM and
# compiled in three register-array sizes).
MOVED_KERNELS = {
    "W-bf16": ([("window_attn_fwd", "window_attn_fwd_bf16_kernel", "")],
               [("window_attn_fwd", "window_attn_fwd_short_mma_kernel",
                 "ILb0ELb0E")]),
    "WM-bf16": ([("window_attn_fwd", "window_attn_fwd_masked_bf16_kernel",
                  "")],
                [("window_attn_fwd", "window_attn_fwd_short_mma_kernel",
                  "ILb1ELb0E")]),
    "W4-bf16": ([("window_attn_fwd", "window_attn_fwd_4d_kernelI13", "")],
                [("window_attn_fwd", "window_attn_fwd_short_mma_kernel",
                  "ILb0ELb1E")]),
    "WB-bf16": ([("window_attn_bwd", "window_attn_bwd_kernel",
                  "ILb0ELb0E13__nv_bfloat16Lb0E")],
                [("window_attn_bwd", "window_attn_bwd_short_mma_kernel",
                  "ILb0ELb0E")]),
    "WMB-bf16": ([("window_attn_bwd", "window_attn_bwd_kernel",
                   "ILb0ELb1E13__nv_bfloat16")],
                 [("window_attn_bwd", "window_attn_bwd_short_mma_kernel",
                   "ILb1ELb0E")]),
    "WB4-bf16": ([("window_attn_bwd", "window_attn_bwd_4d_kernelI13", "")],
                 [("window_attn_bwd", "window_attn_bwd_short_mma_kernel",
                   "ILb0ELb1E")]),
}


def _attention_ab(cs, out_dir, regs, tags):
    """W-bf16 and WB-bf16 at the Enhanced step's shape and SwinIR's bf16
    step's T = 64, WM-bf16 and WMB-bf16 at SwinIR's shifted blocks, from
    both builds in turns, and the window-16 routing (the change's
    W-long-bf16 and WB-long-bf16 entry points on the same operands) beside
    them: ms of each, the speed-ups, the bound, SDPA's time, and the
    registers of the kernels of each form."""
    import torch

    from gsasr_torch.models.swinir import swin_attn_mask
    from gsasr_torch.ops import _build
    from gsasr_torch.ops import attention as ta

    old, new = tags
    entries = {}
    for tag in tags:
        for name in ("window_attn_fwd_bf16", "window_attn_bwd_bf16",
                     "window_attn_fwd_masked_bf16",
                     "window_attn_bwd_masked_bf16",
                     "window_attn_fwd_long_bf16", "window_attn_bwd_long_bf16"):
            fn = getattr(ctypes.CDLL(os.path.join(
                out_dir, f"{tag}_{_build.source_of(name)}.so")), name)
            fn.argtypes = [_build._CTYPES[k] for k in _build.SIGNATURES[
                name]] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            entries[tag, name] = fn

    def call(tag, name, *args):
        err = entries[tag, name](*[a.data_ptr() if isinstance(
            a, torch.Tensor) else a for a in args],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the {tag}'s {name} failed: cudaError {err}")

    print(f"registers of the moved forms ({old} -> {new}):", flush=True)
    form_regs = {}
    for form, (was, now) in MOVED_KERNELS.items():
        pick = lambda keys, tag: {  # noqa: E731
            k: r[tag] for k, r in regs.items() if tag in r and any(
                k.startswith(src + " ") and name in k and arg in k
                for src, name, arg in keys)}
        form_regs[form] = {old: pick(was, old), new: pick(now, new)}
        print(f"  {form}: {sorted(form_regs[form][old].values())} -> "
              f"{sorted(form_regs[form][new].values())}", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(31)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    bf16 = torch.bfloat16
    mask36 = swin_attn_mask(48, 48, 8, 4, dev)
    # (forward and backward form, case, windows, Tq, Tk, C, heads, bias,
    # mask)
    cases = [(("W-bf16", "WB-bf16"), "Enhanced 144x144", 256, 144, 144, 192,
              6, False, None),
             (("W-bf16", "WB-bf16"), "SwinIR 64x64, bias", 576, 64, 64, 180,
              6, True, None),
             (("WM-bf16", "WMB-bf16"), "SwinIR 64x64, bias, period 36", 576,
              64, 64, 180, 6, True, mask36)]
    rows = []
    for forms, case, b, tq, tk, c, nh, has_bias, mask in cases:
        q, g = rnd(b, tq, c).to(bf16), rnd(b, tq, c).to(bf16)
        k, v = rnd(b, tk, c).to(bf16), rnd(b, tk, c).to(bf16)
        bias = 0.5 * rnd(nh, tq, tk) if has_bias else None
        scale = (c // nh) ** -0.5
        nw = 0 if mask is None else mask.shape[0]
        full = None if bias is None else (
            bias[None] + (0 if mask is None else mask.repeat(
                b // nw, 1, 1)[:, None])).to(bf16)
        lib_f, lib_b, _ = cs._sdpa_ms(q, k, v, full, g, nh, scale)
        extra = 4 * nh * tq * tk * (0 if bias is None else 1) + (
            0 if mask is None else 4 * nw * tq * tk)
        # the ds_w scratch that the parent's FMA body always writes
        ds_w = torch.empty(b, nh, tq, tk, device=dev)
        stats = torch.empty(b, nh, tq, 3, device=dev)
        for kind in ("fwd", "bwd"):
            masked = "" if mask is None else "_masked"
            label = forms[kind == "bwd"]
            outs = {}

            def run(tag):
                # the window-16 routing: the change's W-long-bf16 and
                # WB-long-bf16 on the same operands (no mask here)
                w16 = tag == "window-16"
                src = new if w16 else tag
                name = (f"window_attn_{kind}_long_bf16" if w16 else
                        f"window_attn_{kind}{masked}_bf16")
                m = [] if w16 or mask is None else [mask]
                nwa = [] if w16 or mask is None else [nw]
                if kind == "fwd":
                    out = torch.empty_like(q)
                    call(src, name, q, k, v, bias, *m, out, b, tq, tk, c, nh,
                         *nwa, scale)
                    outs[tag] = (out,)
                    return
                dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
                dbias = (torch.empty(nh, tq, tk, device=dev)
                         if bias is not None else None)
                call(src, name, q, k, v, bias, *m, g, dq, dk, dv,
                     *([stats] if w16 else []), ds_w, dbias, b, tq, tk, c,
                     nh, *nwa, scale)
                outs[tag] = (dq, dk, dv)

            order = [old, new, new, old, old, new]
            if mask is None:
                order += ["window-16"] * 3
            ms = {tag: [] for tag in dict.fromkeys(order)}
            for tag in order:
                ms[tag].append(cs._time_ms(lambda: run(tag), 10))
            if kind == "fwd":
                refs = (ta.window_attention_packed_plain(
                    q, k, v, bias, scale, nh, mask),)
                flops = 4.0 * b * nh * tq * tk * (c // nh)
                nbytes = 2 * (2 * b * tq * c + 2 * b * tk * c) + extra
            else:
                refs = ta.window_attention_packed_bwd_plain(
                    q, k, v, bias, g, scale, nh, mask)[:3]
                flops = 10.0 * b * nh * tq * tk * (c // nh)
                nbytes = 2 * (3 * b * tq * c + 4 * b * tk * c) + 2 * extra
            bound, by = cs._bound_ms(flops, nbytes, cs.PEAK_BF16)
            errs = {tag: max(cs._compare_bf16(o, r, f"{label} {case} "
                                              f"{tag}")
                             for o, r in zip(outs[tag], refs))
                    for tag in outs}
            between = max(float((a.float() - o.float()).abs().max())
                          for a, o in zip(outs[old], outs[new]))
            med = {tag: sorted(v)[len(v) // 2] for tag, v in ms.items()}
            rows.append(dict(
                form=label, case=case, windows=b, ms=ms,
                speedup=med[old] / med[new],
                speedup_vs_window16=(med["window-16"] / med[new]
                                     if "window-16" in med else None),
                bound_ms=bound, bound_by=by,
                library_ms=lib_f if kind == "fwd" else lib_b,
                max_abs_err=errs, max_between_builds=between))
            w16 = ("" if "window-16" not in med else
                   f", window-16 routing {ms['window-16']} ms "
                   f"({rows[-1]['speedup_vs_window16']:.2f}x)")
            print(f"  {label} {case}: {old} {ms[old]} ms, {new} "
                  f"{ms[new]} ms, {rows[-1]['speedup']:.2f}x{w16} (bound "
                  f"{bound:.4f} by {by}, SDPA {rows[-1]['library_ms']}); "
                  f"builds differ by at most {between:.3e}", flush=True)
    return dict(rows=rows, registers=form_regs)


# The fp32 window attentions' kernels in the earlier builds (the FMA
# bodies' instantiations: the window-16 forward's, A-long's attention, WB's
# (T, kMask, ...) and WB4's; the window-16 backward's (T, kMask, kAtt, kRnd,
# kHM) for the dq launch, (T, kMask, kRnd, kHM) for the dk/dv launch) and
# in this tree (the 3xTF32 bodies, by their flags kMask, kHM, and for WB,
# WMB and WB4 kBig).
LONG_FP32_KERNELS = {
    "W-long": [("window_attn_fwd", "window_attn_fwd_long_kernel", "IfE"),
               ("window_attn_fwd", "window_attn_fwd_long_tf32_kernel",
                "ILb0ELb0E")],
    "WM-long": [("window_attn_fwd", "window_attn_fwd_long_masked_kernel", ""),
                ("window_attn_fwd", "window_attn_fwd_long_tf32_kernel",
                 "ILb1ELb0E")],
    "W4-long": [("window_attn_fwd", "window_attn_fwd_4d_long_kernel", ""),
                ("window_attn_fwd", "window_attn_fwd_long_tf32_kernel",
                 "ILb0ELb1E")],
    "A-long attention": [("ln_attn", "attn_long_kernel", ""),
                         ("ln_attn", "window_attn_fwd_long_tf32_kernel", "")],
    "WB": [("window_attn_bwd", "window_attn_bwd_kernel", "ILb0ELb0EfLb0E"),
           ("window_attn_bwd", "window_attn_bwd_short_tf32_", "ILb0ELb0E")],
    "WMB": [("window_attn_bwd", "window_attn_bwd_kernel", "ILb0ELb1EfLb0E"),
            ("window_attn_bwd", "window_attn_bwd_short_tf32_", "ILb1ELb0E")],
    "WB4": [("window_attn_bwd", "window_attn_bwd_4d_kernelIf", ""),
            ("window_attn_bwd", "window_attn_bwd_short_tf32_", "ILb0ELb1E")],
    "WB-long": [("window_attn_bwd", "window_attn_bwd_long_q_kernel",
                 "IfLb0ELb0ELb0ELb0EE"),
                ("window_attn_bwd", "window_attn_bwd_long_kv_kernel",
                 "IfLb0ELb0ELb0EE"),
                ("window_attn_bwd", "window_attn_bwd_long_tf32_",
                 "ILb0ELb0E")],
    "WMB-long": [("window_attn_bwd", "window_attn_bwd_long_q_kernel",
                  "IfLb1E"),
                 ("window_attn_bwd", "window_attn_bwd_long_kv_kernel",
                  "IfLb1E"),
                 ("window_attn_bwd", "window_attn_bwd_long_tf32_",
                  "ILb1ELb0E")],
    "WB4-long": [("window_attn_bwd", "window_attn_bwd_long_q_kernel",
                  "IfLb0ELb0ELb0ELb1EE"),
                 ("window_attn_bwd", "window_attn_bwd_long_kv_kernel",
                  "IfLb0ELb0ELb1EE"),
                 ("window_attn_bwd", "window_attn_bwd_long_tf32_",
                  "ILb0ELb1E")],
}


def _long_fp32_ab(cs, out_dir, regs, tags):
    """WB-long at the fp32 Ultra step's 256 x 256 and 256 x 576, WMB-long at
    the paper HAT step's shape and WB4-long on the head-major layout, from
    every build in turns (tags + reversed + tags): ms of each, the speed-up
    of the change over each other build, the bound (the five products in
    3xTF32 at the TF32 peak, or the bytes), SDPA's backward, and the
    registers of each form's kernels."""
    import torch

    from gsasr_torch.models.swinir import swin_attn_mask
    from gsasr_torch.ops import _build
    from gsasr_torch.ops import attention as ta

    names = ("window_attn_bwd_long", "window_attn_bwd_long_masked",
             "window_attn_bwd_4d")
    entries = {}
    for tag in tags:
        for name in names:
            fn = getattr(ctypes.CDLL(os.path.join(
                out_dir, f"{tag}_{_build.source_of(name)}.so")), name)
            fn.argtypes = [_build._CTYPES[k] for k in _build.SIGNATURES[
                name]] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            entries[tag, name] = fn

    def call(tag, name, *args):
        err = entries[tag, name](*[a.data_ptr() if isinstance(
            a, torch.Tensor) else a for a in args],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the {tag}'s {name} failed: cudaError {err}")

    print(f"registers of the fp32 window attentions ({', '.join(tags)}):",
          flush=True)
    form_regs = {}
    for form, keys in LONG_FP32_KERNELS.items():
        form_regs[form] = {tag: sorted(
            r[tag] for k, r in regs.items() if tag in r and any(
                k.startswith(src + " ") and name in k and arg in k
                for src, name, arg in keys)) for tag in tags}
        print(f"  {form}: {form_regs[form]}", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(37)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    mask9 = swin_attn_mask(48, 48, 16, 8, dev)
    # (form, case, windows, Tq, Tk, C, heads, bias, mask, head-major)
    cases = [("WB-long", "Ultra 256x256", 128, 256, 256, 192, 6, False,
              None, False),
             ("WB-long", "Ultra OCAB 256x576", 128, 256, 576, 192, 6, False,
              None, False),
             ("WMB-long", "paper HAT 256x256, bias, period 9", 144, 256,
              256, 180, 6, True, mask9, False),
             ("WB4-long", "4D 256x256, bias", 128, 256, 256, 192, 6, True,
              None, True)]
    rows = []
    for form, case, b, tq, tk, c, nh, has_bias, mask, hm in cases:
        q, g = rnd(b, tq, c), rnd(b, tq, c)
        k, v = rnd(b, tk, c), rnd(b, tk, c)
        bias = 0.5 * rnd(nh, tq, tk) if has_bias else None
        scale = (c // nh) ** -0.5
        hd = c // nh
        nw = 0 if mask is None else mask.shape[0]
        full = None if bias is None else (
            bias[None] + (0 if mask is None else mask.repeat(
                b // nw, 1, 1)[:, None]))
        _, lib_b, _ = cs._sdpa_ms(q, k, v, full, g, nh, scale)
        stats = torch.empty(b, nh, tq, 3, device=dev)
        ds_w = torch.empty(b, nh, tq, tk, device=dev) if has_bias else None
        hmaj = lambda x: ta._heads(x, nh).contiguous()  # noqa: E731
        ops = [hmaj(x) for x in (q, k, v, g)] if hm else [q, k, v, g]
        outs = {}

        def run(tag):
            dq, dk, dv = (torch.empty_like(x) for x in ops[:3])
            dbias = (torch.empty(nh, tq, tk, device=dev) if has_bias
                     else None)
            if hm:
                call(tag, "window_attn_bwd_4d", *ops[:3], bias, ops[3], dq,
                     dk, dv, stats, ds_w, dbias, b, tq, tk, c, nh, scale)
                dq, dk, dv = (ta._merge(x) for x in (dq, dk, dv))
            elif mask is None:
                call(tag, "window_attn_bwd_long", *ops[:3], bias, ops[3], dq,
                     dk, dv, stats, ds_w, dbias, b, tq, tk, c, nh, scale)
            else:
                call(tag, "window_attn_bwd_long_masked", *ops[:3], bias,
                     mask, ops[3], dq, dk, dv, stats, ds_w, dbias, b, tq,
                     tk, c, nh, nw, scale)
            outs[tag] = (dq, dk, dv, dbias)

        order = list(tags) + list(tags)[::-1] + list(tags)
        ms = {tag: [] for tag in tags}
        for tag in order:
            ms[tag].append(cs._time_ms(lambda: run(tag), 10))
        refs = ta.window_attention_packed_bwd_plain(q, k, v, bias, g, scale,
                                                    nh, mask)
        errs = {}
        for tag in tags:
            first = outs[tag]
            run(tag)
            if not all(torch.equal(a, o) for a, o in zip(first, outs[tag])
                       if o is not None):
                raise AssertionError(f"{form} {case} {tag}: not the same "
                                     "bits twice")
            errs[tag] = cs._compare_grads(
                first, refs, ("dq", "dk", "dv", "dbias"),
                f"{form} {case} {tag}")
        flops = 3 * 10.0 * b * nh * tq * tk * hd
        nbytes = 4 * (3 * b * tq * c + 4 * b * tk * c) + (
            8 * nh * tq * tk if has_bias else 0) + 4 * nw * tq * tk
        bound, by = cs._bound_ms(flops, nbytes, cs.PEAK_TF32)
        med = {tag: sorted(v)[len(v) // 2] for tag, v in ms.items()}
        rows.append(dict(form=form, case=case, windows=b, ms=ms,
                         speedup={tag: med[tag] / med["change"]
                                  for tag in tags if tag != "change"},
                         bound_ms=bound, bound_by=by, library_ms=lib_b,
                         max_abs_err=errs))
        speed = ", ".join(f"{med[t] / med['change']:.2f}x over {t}"
                          for t in tags if t != "change")
        print(f"  {form} {case}: " + ", ".join(
            f"{t} {ms[t]} ms" for t in tags) + f"; {speed} (bound "
              f"{bound:.4f} by {by}, SDPA backward {lib_b})", flush=True)
    return dict(rows=rows, registers=form_regs)

def _signatures(root):
    """The entry points' argument kinds of the `_build.py` beside a tree's
    csrc (a parent's archive holds it), else this tree's."""
    from gsasr_torch.ops import _build

    path = os.path.join(root, "gsasr_torch", "ops", "_build.py")
    if not os.path.exists(path):
        return _build.SIGNATURES
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "SIGNATURES" for t in node.targets):
            return eval(compile(ast.Expression(node.value), path, "eval"))
    raise RuntimeError(f"no SIGNATURES in {path}")


def _entries(out_dir, tags, names, sigs, adapted=()):
    """{(tag, name): the entry point of tag's build, with tag's argument
    kinds}. A build whose entry point takes other arguments than this
    tree's is refused unless the caller adapts it (`adapted`)."""
    from gsasr_torch.ops import _build

    out = {}
    for tag in tags:
        for name in names:
            if (sigs[tag][name] != _build.SIGNATURES[name]
                    and name not in adapted):
                raise RuntimeError(
                    f"the {tag}'s {name} takes {sigs[tag][name]!r}, this "
                    f"tree's {_build.SIGNATURES[name]!r}: no adapter")
            fn = getattr(ctypes.CDLL(os.path.join(
                out_dir, f"{tag}_{_build.source_of(name)}.so")), name)
            fn.argtypes = [_build._CTYPES[k] for k in sigs[tag][name]] + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            out[tag, name] = fn
    return out


def _fp32_fwd_ab(cs, out_dir, tags, sigs):
    """The fp32 window attention forward from every build in turns (tags +
    reversed + tags): the window-16 forms, W-long at the Ultra image's 144
    windows and the Ultra step's 128 of 256 x 256 and 256 x 576 (6 heads of
    32, no bias), WM-long at the paper HAT's 144 x 256 x 256 x 30 with a
    bias and the SW-MSA mask of period 9, W4-long at 128 x 6 x 256 x 32
    with a bias; and the forms up to 160 tokens (this tree's 3xTF32 body,
    window_attn_short_tf32.cuh; a parent's may be an FMA body): W at the
    paper step's 256 x 6 x 144 x 30 with a bias, beside this tree's W-long
    on the same operands ("window-16", the window-16 body as W's
    yardstick), W at SwinIR's 576 x 6 x 64 x 30 with a bias, WM there with
    the mask of period 36, and W4 at the paper image's 225 x 6 x 144 x 30
    with a bias. Each held within atol = rtol = 1e-4 of the plain version
    and to the same bits twice; ms (one call, CUDA events, median of 10 in
    each turn) and ten back to back, the speed-up of the change over each
    other build, the bound (the two products in 3xTF32 at the TF32 peak,
    or the bytes) and SDPA's forward."""
    import torch

    from gsasr_torch.models.swinir import swin_attn_mask
    from gsasr_torch.ops import attention as ta

    names = ("window_attn_fwd", "window_attn_fwd_masked",
             "window_attn_fwd_long", "window_attn_fwd_long_masked",
             "window_attn_fwd_4d")
    entries = _entries(out_dir, tags, names, sigs)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(41)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    mask9 = swin_attn_mask(48, 48, 16, 8, dev)
    mask36 = swin_attn_mask(48, 48, 8, 4, dev)
    # (form, case, windows, Tq, Tk, C, heads, bias, mask, head-major)
    cases = [("W-long", "Ultra image 256x256", 144, 256, 256, 192, 6, False,
              None, False),
             ("W-long", "Ultra image OCAB 256x576", 144, 256, 576, 192, 6,
              False, None, False),
             ("W-long", "Ultra step 256x256", 128, 256, 256, 192, 6, False,
              None, False),
             ("W-long", "Ultra step OCAB 256x576", 128, 256, 576, 192, 6,
              False, None, False),
             ("WM-long", "paper HAT 256x256, bias, period 9", 144, 256, 256,
              180, 6, True, mask9, False),
             ("W4-long", "4D 256x256, bias", 128, 256, 256, 192, 6, True,
              None, True),
             ("W", "paper step 144x144, bias", 256, 144, 144, 180, 6, True,
              None, False),
             ("W", "SwinIR 64x64, bias", 576, 64, 64, 180, 6, True, None,
              False),
             ("WM", "SwinIR 64x64, bias, period 36", 576, 64, 64, 180, 6,
              True, mask36, False),
             ("W4", "paper image 4D 144x144, bias", 225, 144, 144, 180, 6,
              True, None, True)]
    rows = []
    for form, case, b, tq, tk, c, nh, has_bias, mask, hm in cases:
        q, k, v = rnd(b, tq, c), rnd(b, tk, c), rnd(b, tk, c)
        bias = 0.5 * rnd(nh, tq, tk) if has_bias else None
        scale = (c // nh) ** -0.5
        hd = c // nh
        nw = 0 if mask is None else mask.shape[0]
        full = None if bias is None else (
            bias[None] + (0 if mask is None else mask.repeat(
                b // nw, 1, 1)[:, None]))
        lib_f, _, _ = cs._sdpa_ms(q, k, v, full, q, nh, scale)
        hmaj = lambda x: ta._heads(x, nh).contiguous()  # noqa: E731
        ops = [hmaj(x) for x in (q, k, v)] if hm else [q, k, v]
        outs = {}

        def run(tag):
            src = "change" if tag == "window-16" else tag
            out = torch.empty_like(ops[0])
            if tag == "window-16":
                name, extra = "window_attn_fwd_long", ()
            elif form == "W":
                name, extra = "window_attn_fwd", ()
            elif form == "WM":
                name, extra = "window_attn_fwd_masked", (mask,)
            elif hm:
                name, extra = "window_attn_fwd_4d", ()
            elif mask is None:
                name, extra = "window_attn_fwd_long", ()
            else:
                name, extra = "window_attn_fwd_long_masked", (mask,)
            err = entries[src, name](*[a.data_ptr() if isinstance(
                a, torch.Tensor) else a for a in (
                    *ops, bias, *extra, out, b, tq, tk, c, nh,
                    *((nw,) if extra else ()), scale)],
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"the {src}'s {name} failed: cudaError "
                                   f"{err}")
            outs[tag] = ta._merge(out) if hm else out

        turns = list(tags) + (["window-16"] if case.startswith(
            "paper step") else [])
        order = turns + turns[::-1] + turns
        ms = {tag: [] for tag in turns}
        dev_ms = {tag: [] for tag in turns}
        for tag in order:
            ms[tag].append(cs._time_ms(lambda: run(tag), 10))
            dev_ms[tag].append(cs._batch_ms(lambda: run(tag)))
        ref = ta.window_attention_packed_plain(q, k, v, bias, scale, nh,
                                               mask)
        errs = {}
        for tag in turns:
            first = outs[tag]
            run(tag)
            if not torch.equal(first, outs[tag]):
                raise AssertionError(f"{form} {case} {tag}: not the same "
                                     "bits twice")
            errs[tag] = cs._compare(first, ref, f"{form} {case} {tag}")
        nbytes = 4 * (2 * b * tq * c + 2 * b * tk * c) + (
            4 * nh * tq * tk if has_bias else 0) + 4 * nw * tq * tk
        bound, by = cs._bound_ms(12.0 * b * nh * tq * tk * hd, nbytes,
                                 cs.PEAK_TF32)
        med = {tag: sorted(v)[len(v) // 2] for tag, v in ms.items()}
        dmed = {tag: sorted(v)[len(v) // 2] for tag, v in dev_ms.items()}
        rows.append(dict(form=form, case=case, windows=b, ms=ms,
                         dev_ms=dev_ms,
                         speedup={t: med[t] / med["change"] for t in turns
                                  if t != "change"},
                         bound_ms=bound, bound_by=by, library_ms=lib_f,
                         max_abs_err=errs))
        speed = ", ".join(f"{med[t] / med['change']:.2f}x over {t}"
                          for t in turns if t != "change")
        print(f"  {form} {case}: " + ", ".join(
            f"{t} {[round(x, 4) for x in ms[t]]}" for t in turns)
            + f" ms; change {speed}; back to back " + ", ".join(
                f"{t} {dmed[t]:.4f}" for t in turns)
            + f" ms (bound in 3xTF32 {bound:.4f} by {by}, SDPA {lib_f})",
            flush=True)
    return dict(rows=rows)


# The sources --grid-bits swaps: the window attentions' and A's and AB's
GRID_BITS_SOURCES = ("window_attn_fwd", "window_attn_bwd", "ln_attn",
                     "ln_attn_bwd")


def _grid_bits_ab(cs, out_dir, tags, sigs):
    """--grid-bits: every window attention form and A and AB through the
    port's wrappers with each build's entry points swapped in (`_swapper`),
    on the same seeded operands; asserts each build's outputs are the first
    build's bits. Returns the cases run."""
    import torch

    from gsasr_torch.models.swinir import swin_attn_mask
    from gsasr_torch.ops import fused_layers as fl

    dev = torch.device("cuda")
    swap = _swapper(out_dir, tags, sigs, GRID_BITS_SOURCES)
    first = tags[0]
    # phase 39's forms with Swin's mask (its "<form>/<period>" cases need
    # more windows than one launch held)
    narrow = [(form, 65532, t, nh, hd, 2 * math.isqrt(t) if nw else 0, hm)
              for form, t, nh, hd, nw, hm in cs.GRID_FORMS if "/" not in form]
    cases = narrow + [("W", 256, 144, 6, 30, 0, False),
                      ("WM", 576, 64, 6, 30, 48, False),
                      ("W4", 256, 144, 6, 30, 0, True),
                      ("W-long", 128, 256, 6, 32, 0, False),
                      ("WM-long", 144, 256, 6, 30, 48, False)]
    gen = torch.Generator().manual_seed(61)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    done = []

    def same(label, outs):
        for tag in tags:
            if not all(a is None and b is None or torch.equal(a, b)
                       for a, b in zip(outs[tag], outs[first])):
                raise AssertionError(f"{label}: the {tag}'s bits differ "
                                     f"from the {first}'s")
        print(f"  {label}: the same bits from {', '.join(tags)}",
              flush=True)
        done.append(label)

    for form, n, t, nh, hd, side, hm in cases:
        ws = math.isqrt(t)
        mask = (swin_attn_mask(side, side, ws, ws // 2, dev) if side
                else None)
        bias = 0.5 * rnd(nh, t, t)
        scale = hd ** -0.5
        for dt in (torch.float32, torch.bfloat16):
            fwd, bwd, _, _ = cs._grid_wrappers(form, dt)
            shape = (n, nh, t, hd) if hm else (n, t, nh * hd)
            q, k, v, g = (rnd(*shape).to(dt) for _ in range(4))
            outs = {}
            for tag in tags:
                swap(tag)
                outs[tag] = (fwd(q, k, v, bias, mask, scale, nh),
                             *bwd(q, k, v, bias, mask, g, scale, nh))
            swap(None)
            tag_dt = "" if dt == torch.float32 else "-bf16"
            same(f"{form}{tag_dt} and its backward, {n} windows of {t} "
                 f"tokens, {nh} heads of {hd}", outs)
            del q, k, v, g, outs
    for n, t, c, nh in ((65532, 64, 32, 1), (256, 144, 180, 6)):
        kw = dict(wq=0.1 * rnd(c, c), bq=0.1 * rnd(c), wk=0.1 * rnd(c, c),
                  bk=0.1 * rnd(c), wv=0.1 * rnd(c, c), bv=0.1 * rnd(c),
                  wo=0.1 * rnd(c, c), bo=0.1 * rnd(c), ln_w=1 + 0.1 * rnd(c),
                  ln_b=0.1 * rnd(c), bias=0.5 * rnd(nh, t, t), num_heads=nh)
        for dt in (torch.float32, torch.bfloat16):
            x, kv, g = (rnd(n, t, c).to(dt) for _ in range(3))
            pos = rnd(t, c).to(dt)
            outs = {}
            for tag in tags:
                swap(tag)
                with torch.no_grad():
                    a = fl.ln_attn_proj(x, kv=kv, pos=pos, **kw)
                outs[tag] = (a, *fl.ln_attn_proj_bwd(x, g, kv=kv, pos=pos,
                                                     **kw))
            swap(None)
            tag_dt = "" if dt == torch.float32 else "-bf16"
            same(f"A{tag_dt} and AB{tag_dt}, {n} windows of {t} tokens, "
                 f"{c} channels in {nh} heads", outs)
            del x, kv, g, outs
    return dict(cases=done)


def _fp32_short_bwd_ab(cs, out_dir, tags, sigs):
    """The fp32 window attention backward up to 160 tokens from every build
    in turns (tags + reversed + tags): WB at the paper step's 256 x 6 x 144
    x 30 and SwinIR's 576 x 6 x 64 x 30, WMB at SwinIR's training shape
    with the mask of period 36, WB4 at 256 x 6 x 144 x 30, with a bias (and
    WB without one). Each build's dq, dk, dv and dbias held
    within 1e-4 of each one's largest entry of the plain version and to the
    same bits twice; ms, speed-ups, the bound (the five
    products in 3xTF32 at the TF32 peak, or the bytes) and SDPA's
    backward."""
    import torch

    from gsasr_torch.models.swinir import swin_attn_mask
    from gsasr_torch.ops import attention as ta

    names = ("window_attn_bwd", "window_attn_bwd_masked",
             "window_attn_bwd_4d")
    entries = _entries(out_dir, tags, names, sigs)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(43)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    mask36 = swin_attn_mask(48, 48, 8, 4, dev)
    # (form, case, windows, T, C, bias, mask, head-major)
    cases = [("WB", "paper step 144x144, bias", 256, 144, 180, True, None,
              False),
             ("WB", "paper step 144x144, no bias", 256, 144, 180, False, None,
              False),
             ("WB", "SwinIR 64x64, bias", 576, 64, 180, True, None, False),
             ("WB", "SwinIR 64x64, no bias", 576, 64, 180, False, None,
              False),
             ("WMB", "SwinIR 64x64, bias, period 36", 576, 64, 180, True,
              mask36, False),
             ("WB4", "4D 144x144, bias", 256, 144, 180, True, None, True)]
    rows = []
    for form, case, b, t, c, has_bias, mask, hm in cases:
        nh, hd = 6, c // 6
        q, k, v, g = (rnd(b, t, c) for _ in range(4))
        bias = 0.5 * rnd(nh, t, t) if has_bias else None
        scale = hd ** -0.5
        nw = 0 if mask is None else mask.shape[0]
        full = None if bias is None else bias[None] + (
            0 if mask is None else mask.repeat(b // nw, 1, 1)[:, None])
        _, lib_b, _ = cs._sdpa_ms(q, k, v, full, g, nh, scale)
        stats = torch.empty(b, nh, t, 3, device=dev)
        ds_w = torch.empty(b, nh, t, t, device=dev)
        hmaj = lambda x: ta._heads(x, nh).contiguous()  # noqa: E731
        ops = [hmaj(x) for x in (q, k, v, g)] if hm else [q, k, v, g]
        name = ("window_attn_bwd_4d" if hm else "window_attn_bwd_masked"
                if mask is not None else "window_attn_bwd")
        outs = {}

        def run(tag):
            dq, dk, dv = (torch.empty_like(x) for x in ops[:3])
            dbias = torch.empty(nh, t, t, device=dev) if has_bias else None
            extra = () if mask is None else (mask,)
            err = entries[tag, name](*[a.data_ptr() if isinstance(
                a, torch.Tensor) else a for a in (
                    *ops[:3], bias, *extra, ops[3], dq, dk, dv, stats, ds_w,
                    dbias, b, t, t, c, nh, *((nw,) if extra else ()),
                    scale)], torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"the {tag}'s {name} failed: cudaError "
                                   f"{err}")
            if hm:
                dq, dk, dv = (ta._merge(x) for x in (dq, dk, dv))
            outs[tag] = (dq, dk, dv, dbias)

        order = list(tags) + list(tags)[::-1] + list(tags)
        ms = {tag: [] for tag in tags}
        for tag in order:
            ms[tag].append(cs._time_ms(lambda: run(tag), 10))
        refs = ta.window_attention_packed_bwd_plain(q, k, v, bias, g, scale,
                                                    nh, mask)
        errs = {}
        for tag in tags:
            first = outs[tag]
            run(tag)
            if not all(torch.equal(a, o) for a, o in zip(first, outs[tag])
                       if o is not None):
                raise AssertionError(f"{form} {case} {tag}: not the same "
                                     "bits twice")
            errs[tag] = cs._compare_grads(
                first, refs, ("dq", "dk", "dv", "dbias"),
                f"{form} {case} {tag}")
        nbytes = 4 * 7 * b * t * c + 8 * nh * t * t * has_bias + \
            4 * nw * t * t
        bound, by = cs._bound_ms(30.0 * b * nh * t * t * hd, nbytes,
                                 cs.PEAK_TF32)
        med = {tag: sorted(v)[len(v) // 2] for tag, v in ms.items()}
        rows.append(dict(form=form, case=case, windows=b, ms=ms,
                         speedup={tag: med[tag] / med["change"]
                                  for tag in tags if tag != "change"},
                         bound_ms=bound, bound_by=by, library_ms=lib_b,
                         max_abs_err=errs))
        speed = ", ".join(f"{med[t] / med['change']:.2f}x over {t}"
                          for t in tags if t != "change")
        print(f"  {form} {case}: " + ", ".join(
            f"{t} {ms[t]} ms" for t in tags) + f"; {speed} (bound "
              f"{bound:.4f} by {by}, SDPA backward {lib_b})", flush=True)
    return dict(rows=rows)



def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, action="append",
                    help="directory holding the parent's gsasr_torch/ops/csrc"
                    " (repeat for more variants)")
    ap.add_argument("--label", action="append",
                    help="name of the other tree in the output (a variant "
                    "of this tree's sources, say), one per --parent")
    ap.add_argument("--skip-raster", action="store_true",
                    help="time the attention forms only, not kernels R "
                    "and RB")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--fp32-only", action="store_true",
                      help="build window_attn_fwd.cu, window_attn_bwd.cu "
                      "and ln_attn.cu alone and time only the fp32 window "
                      "attentions and kernel A in fp32 at the paper's shape")
    only.add_argument("--fused-only", action="store_true",
                      help="build ln_mlp.cu and ln_attn.cu alone and time "
                      "only kernels M, A and A-long")
    only.add_argument("--fused-bwd-only", action="store_true",
                      help="build ln_mlp_bwd.cu, ln_attn_bwd.cu and "
                      "window_attn_bwd.cu alone and time kernels MB, AB and "
                      "AB-long, and WB's bodies beside them; with --steps "
                      "the fused paper, Enhanced and Ultra steps")
    only.add_argument("--raster-only", action="store_true",
                      help="build raster_fwd.cu and raster_bwd.cu alone and "
                      "time only kernels R and RB, R-exact's walk and the "
                      "exact render's path, from every build")
    ap.add_argument("--steps", action="store_true",
                    help="also time training steps with the first build's "
                    "and this tree's built sources in turns: the paper "
                    "EDSR, SwinIR, fp32 Ultra and paper HAT steps and the "
                    "fp32 Ultra image, or with --raster-only the paper "
                    "EDSR step and the bf16 Ultra step")
    ap.add_argument("--images", action="store_true",
                    help="also time the paper fp32, Enhanced bf16 and HAT-L "
                    "Ultra (bf16, fp32) images with the first build's and "
                    "this tree's ln_mlp.cu, ln_attn.cu and raster_fwd.cu, "
                    "where built, in turns")
    ap.add_argument("--turns", type=int, default=2,
                    help="pairs of turns of --steps and --images, which "
                    "build goes first alternating (default 2: parent, "
                    "change, change, parent)")
    ap.add_argument("--grid-bits", action="store_true",
                    help="also run every window attention entry point and "
                    "kernels A and AB from every build on the same "
                    "operands (below 65,536 windows) and assert the same "
                    "bits")
    ap.add_argument("--json", help="write the results to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ab_torch_sources: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gsasr_torch.ops import _build

    out_dir = os.path.join(ROOT, "build", "ab_sources")
    os.makedirs(out_dir, exist_ok=True)
    labels = args.label or []
    labels += ["parent" if not i else f"variant{i}"
               for i in range(len(labels), len(args.parent))]
    if len(labels) != len(args.parent) or "change" in labels:
        ap.error("one --label per --parent, none named change")
    old = labels[0]
    dirs = {tag: os.path.join(d, "gsasr_torch", "ops", "csrc")
            for tag, d in zip(labels, args.parent)}
    dirs["change"] = str(_build.SRC_DIR)
    sigs = {tag: _signatures(d) for tag, d in zip(labels, args.parent)}
    sigs["change"] = _build.SIGNATURES
    fp32 = ("window_attn_fwd", "window_attn_bwd")
    if args.fused_only:
        sources = variant = FUSED
    elif args.fused_bwd_only:
        sources = variant = FUSED_BWD
    elif args.fp32_only:
        sources = variant = fp32 + ("ln_attn",)
    elif args.raster_only:
        sources = variant = RASTER
    else:
        sources, variant = SOURCES, fp32 + FUSED
    if args.grid_bits:
        sources = tuple(dict.fromkeys(sources + GRID_BITS_SOURCES))
        variant = tuple(dict.fromkeys(variant + GRID_BITS_SOURCES))
    jobs = [(tag, src, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
         os.path.join(out_dir, f"{tag}_{src}.so"),
         os.path.join(d, f"{src}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
        for tag, d in dirs.items()
        for src in (sources if tag in (old, "change") else variant)]
    regs: dict = {}
    for tag, src, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {tag}'s {src}.cu:\n{log}")
        for name, r in _registers(log).items():
            regs.setdefault(f"{src} {name}", {})[tag] = r
    card = cs._nvidia_smi()
    print(f"card: {card}", flush=True)
    for key, r in sorted(regs.items()):
        mark = "" if r.get(old) == r.get("change") else "  (differs)"
        rest = "".join(f", {t} {r[t]}" for t in dirs
                       if t not in (old, "change") and t in r)
        print(f"  {key[:120]}: {r.get(old)} -> {r.get('change')}{rest}"
              f"{mark}", flush=True)
    times, attn, fused, fused_bwd, exact = {}, {}, {}, {}, {}
    fwd_fp32 = short_fp32 = long_fp32 = {}
    swapped = [src for src in SWAPPED if src in sources]
    steps = images = {}
    if args.fused_bwd_only:
        print("kernels MB, AB and AB-long:", flush=True)
        fused_bwd = _fused_bwd_ab(cs, out_dir, regs, tuple(dirs))
        print("the fp32 backward up to 160 tokens (AB's fp32 body):",
              flush=True)
        short_fp32 = _fp32_short_bwd_ab(cs, out_dir, tuple(dirs), sigs)
        print("the fp32 window-16 backward (AB-long's fp32 body):",
              flush=True)
        long_fp32 = _long_fp32_ab(cs, out_dir, regs, tuple(dirs))
        if args.steps:
            print("fused steps in turns:", flush=True)
            steps = _fused_steps_ab(cs, out_dir, (old, "change"), sigs,
                                    swapped, args.turns)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(dict(card=card, registers=regs,
                               fused_bwd=fused_bwd, short_fp32=short_fp32,
                               long_fp32=long_fp32, steps=steps), f,
                          indent=1)
        return 0
    if args.raster_only:
        print("kernels R and RB:", flush=True)
        times = _raster_ab(cs, out_dir, tuple(dirs), sigs)
        print("the exact render: R-exact's walk and the path:", flush=True)
        exact = _exact_ab(cs, out_dir, (old, "change"), sigs)
    elif not (args.skip_raster or args.fp32_only or args.fused_only):
        print("kernels R and RB:", flush=True)
        times = _raster_ab(cs, out_dir, (old, "change"), sigs)
    if not (args.fp32_only or args.fused_only or args.raster_only):
        attn = _attention_ab(cs, out_dir, regs, (old, "change"))
    if not (args.fp32_only or args.raster_only):
        print("kernels M, A and A-long:", flush=True)
        fused = _fused_fwd_ab(cs, out_dir, regs, tuple(dirs), sigs)
    elif args.fp32_only:
        print("kernel A, paper fp32:", flush=True)
        fused = _fused_fwd_ab(cs, out_dir, regs, tuple(dirs), sigs,
                              only=("A", "paper"))
    if not (args.fused_only or args.raster_only):
        print("the fp32 forward (up to 160 tokens and window 16):",
              flush=True)
        fwd_fp32 = _fp32_fwd_ab(cs, out_dir, tuple(dirs), sigs)
        print("the fp32 backward up to 160 tokens:", flush=True)
        short_fp32 = _fp32_short_bwd_ab(cs, out_dir, tuple(dirs), sigs)
        print("the fp32 window-16 backward:", flush=True)
        long_fp32 = _long_fp32_ab(cs, out_dir, regs, tuple(dirs))
    grid_bits = {}
    if args.grid_bits:
        print("every window attention form, A and AB, the same bits from "
              "every build:", flush=True)
        grid_bits = _grid_bits_ab(cs, out_dir, tuple(dirs), sigs)
    if args.steps:
        print("steps in turns:", flush=True)
        steps = _steps_ab(cs, out_dir, (old, "change"), sigs, swapped,
                          ["paper EDSR step", "HAT-L Ultra bf16 step"]
                          if args.raster_only else list(STEPS)[:4],
                          args.turns)
    if args.images:
        print("images in turns:", flush=True)
        images = _images_ab(cs, out_dir, (old, "change"), sigs, [
            src for src in swapped if src in FUSED + ("raster_fwd",)],
            args.turns)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, registers=regs, raster=times,
                           exact=exact,
                           attention=attn, fused=fused, fwd_fp32=fwd_fp32,
                           short_fp32=short_fp32, long_fp32=long_fp32,
                           steps=steps, images=images,
                           grid_bits=grid_bits), f, indent=1)
    return 0


# The kernels of M and A in ptxas's report (source, name key): the
# tensor-core row-tile products (ln_mlp_kernel, A's ln_qkv_kernel and
# out_proj_kernel) and, in a parent's build, the FMA bodies they replace
# (attn_heads_kernel, gemm_rows inside the same names).
FUSED_KERNELS = (("ln_mlp", "ln_mlp_kernel"), ("ln_attn", "ln_qkv_kernel"),
                 ("ln_attn", "out_proj_kernel"),
                 ("ln_attn", "attn_heads_kernel"))


def _fused_fwd_ab(cs, out_dir, regs, tags, sigs, only=None):
    """Kernels M and A (A-long beyond 160 tokens) from every build in turns
    (tags + reversed + tags), at the main path's shapes with seeded
    weights: M at the paper decoder's 225 x 144 x 180 in fp32 (ln_inj, ln,
    resi), the Enhanced decoder's 225 x 144 x 192 in bf16 (ln_inj, ln,
    zero_base) and the Ultra decoder's 144 x 256 x 192 in bf16 and fp32
    (ln); A at the paper's 225 x 144 x 180 x 6 heads in fp32 (cross with
    pos, kv and a bias; self with a bias), the Enhanced decoder's 225 x 144
    x 192 in bf16 with RoPE (cross with pos and kv of 144 tokens; self);
    A-long at the Ultra decoder's 144 x 256 x 192 with RoPE, cross and
    self, in bf16 and fp32. Each build held against the plain version
    (fp32 atol = rtol = 1e-4; bf16 2^-7 |ref| + 2^-8 max|ref|) and to the
    same bits twice; ms, the speed-up of the change over each other build,
    the bound (fp32: the products in 3xTF32 at the TF32 peak; bf16: at the
    bf16 peak, or the bytes) and the registers of each build's kernels.
    `only` (kernel, case) keeps those cases alone (--fp32-only: A paper).
    """
    import torch

    from gsasr_torch.models.fea2gs_rope_fast import rope_tables
    from gsasr_torch.ops import fused_layers as fl

    entries = _entries(out_dir, tags, ("ln_attn", "ln_attn_long") + (
        () if only else ("ln_mlp",)), sigs)
    print("registers of M's and A's kernels:", flush=True)
    kregs = {}
    for key, r in sorted(regs.items()):
        if any(key.startswith(src + " ") and name in key
               for src, name in FUSED_KERNELS):
            kregs[key] = r
            print(f"  {key[:110]}: " + ", ".join(
                f"{t} {r.get(t)}" for t in tags), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(51)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    f32, bf16 = torch.float32, torch.bfloat16

    def mlp_case(dt, c, opts):
        kw = dict(w1=rnd(c, c) / 14, b1=rnd(c), w2=rnd(c, c) / 14,
                  b2=rnd(c))
        if opts in ("ln_inj", "ln"):
            kw.update(ln_w=1 + 0.1 * rnd(c), ln_b=0.1 * rnd(c))
        return kw

    def attn_case(dt, b, tq, tk, c, nh, opts):
        kw = {k: rnd(c, c) / 14 if k[0] == "w" else rnd(c)
              for k in ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")}
        kw.update(ln_w=1 + 0.1 * rnd(c), ln_b=0.1 * rnd(c), num_heads=nh)
        if "cross" in opts:
            kw.update(pos=rnd(tq, c).to(dt), kv=rnd(b, tk, c).to(dt))
        if opts.startswith("rope"):
            side = int(round(max(tq, tk) ** 0.5))
            cos, sin = rope_tables(0.5 * rnd(2, nh, c // nh // 2), side,
                                   max(tq, tk))
            kw.update(rope_cos_q=cos[:tq].contiguous(),
                      rope_sin_q=sin[:tq].contiguous(),
                      rope_cos_k=cos[:tk].contiguous(),
                      rope_sin_k=sin[:tk].contiguous())
        else:
            kw.update(bias=0.5 * rnd(nh, tq, tk))
        return kw

    # (kernel, case, type, windows, Tq, Tk, C, options)
    cases = [("M", "paper", f32, 225, 144, 144, 180, o)
             for o in ("ln_inj", "ln", "resi")]
    cases += [("M", "Enhanced", bf16, 225, 144, 144, 192, o)
              for o in ("ln_inj", "ln", "zero_base")]
    cases += [("M", "Ultra", dt, 144, 256, 256, 192, "ln")
              for dt in (bf16, f32)]
    cases += [("A", "paper", f32, 225, 144, 144, 180, o)
              for o in ("cross_bias", "self_bias")]
    cases += [("A", "Enhanced", bf16, 225, 144, 144, 192, o)
              for o in ("rope_cross", "rope_self")]
    cases += [("A-long", "Ultra", dt, 144, 256, 256, 192, o)
              for dt in (bf16, f32) for o in ("rope_cross", "rope_self")]
    if only:
        cases = [cs_ for cs_ in cases if cs_[:2] == only]
    rows = []
    for kind, case, dt, b, tq, tk, c, opts in cases:
        x = rnd(b, tq, c).to(dt)
        is_bf16 = int(dt == bf16)
        if kind == "M":
            kw = mlp_case(dt, c, opts)
            inj = rnd(b, c) if opts == "ln_inj" else None
            resi = rnd(b, tq, c).to(dt) if opts == "resi" else None
            zero = opts == "zero_base"
            pk = dict(kw, inj=inj, resi=resi, zero_base=zero)
            ref = fl.ln_mlp_residual_plain(x, **pk)

            def launch(tag, out):
                err = entries[tag, "ln_mlp"](*[
                    t.data_ptr() if isinstance(t, torch.Tensor) else t
                    for t in (x, inj, resi, kw.get("ln_w"), kw.get("ln_b"),
                              kw["w1"], kw["b1"], kw["w2"], kw["b2"], out)],
                    b * tq, tq, c, c, int(zero), is_bf16,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"the {tag}'s ln_mlp failed: "
                                       f"cudaError {err}")
            flops = 4.0 * b * tq * c * c
            act = 2 if dt == bf16 else 4
            nbytes = (act * b * tq * c * (3 if resi is not None else 2)
                      + 8 * c * c)
        else:
            nh = 6
            kw = attn_case(dt, b, tq, tk, c, nh, opts)
            ref = fl.ln_attn_proj_plain(x, **kw)
            a = {k: (v.to(dt) if k == "pos" else v) for k, v in kw.items()
                 if k != "num_heads"}
            a = {**dict.fromkeys(("bias", "pos", "kv") + fl._ROPE), **a}
            name = "ln_attn_long" if kind == "A-long" else "ln_attn"
            scale = (c // nh) ** -0.5
            scr = [torch.empty(b, t_, c, dtype=dt, device=dev)
                   for t_ in (tq, tk, tk, tq)]

            def launch(tag, out):
                err = entries[tag, name](*[
                    t.data_ptr() if isinstance(t, torch.Tensor) else t
                    for t in (x, a["pos"], a["kv"], a["ln_w"], a["ln_b"],
                              a["wq"], a["bq"], a["wk"], a["bk"], a["wv"],
                              a["bv"], a["wo"], a["bo"], a["bias"],
                              *(a[r] for r in fl._ROPE), *scr, out)],
                    b, tq, tk, c, nh, is_bf16, float(scale),
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"the {tag}'s {name} failed: "
                                       f"cudaError {err}")
            flops = 2.0 * b * (4 * tq * c * c + 2 * tq * tk * c)
            act = 2 if dt == bf16 else 4
            nbytes = (act * b * tq * c * (3 if "cross" in opts else 2)
                      + 16 * c * c + (4 * nh * tq * tk if "bias" in opts
                                      else 0))
        outs = {}

        def run(tag):
            outs[tag] = torch.empty_like(x)
            launch(tag, outs[tag])

        order = list(tags) + list(tags)[::-1] + list(tags)
        ms = {tag: [] for tag in tags}
        dev_ms = {tag: [] for tag in tags}
        for tag in order:
            ms[tag].append(cs._time_ms(lambda: run(tag), 10))
            dev_ms[tag].append(cs._batch_ms(lambda: run(tag)))
        errs = {}
        for tag in tags:
            first = outs[tag]
            run(tag)
            if not torch.equal(first, outs[tag]):
                raise AssertionError(f"{kind} {case} {opts} {tag}: not the "
                                     "same bits twice")
            errs[tag] = (cs._compare_bf16 if dt == bf16 else cs._compare)(
                first, ref, f"{kind} {case} {opts} {dt} {tag}")
        bound, by = (cs._bound_ms(flops, nbytes, cs.PEAK_BF16)
                     if dt == bf16 else
                     cs._bound_ms(3 * flops, nbytes, cs.PEAK_TF32))
        med = {tag: sorted(v)[len(v) // 2] for tag, v in ms.items()}
        dmed = {tag: sorted(v)[len(v) // 2] for tag, v in dev_ms.items()}
        rows.append(dict(kernel=kind, case=case, options=opts,
                         dtype=str(dt).replace("torch.", ""), windows=b,
                         ms=ms, dev_ms=dev_ms,
                         speedup={t: med[t] / med["change"]
                                  for t in tags if t != "change"},
                         bound_ms=bound, bound_by=by, max_abs_err=errs))
        speed = ", ".join(f"{med[t] / med['change']:.2f}x over {t}"
                          for t in tags if t != "change")
        print(f"  {kind} {case} {opts} {rows[-1]['dtype']}: " + ", ".join(
            f"{t} {[round(v, 4) for v in ms[t]]}" for t in tags)
            + f" ms; {speed}; back to back " + ", ".join(
                f"{t} {dmed[t]:.4f}" for t in tags)
            + f" ms (bound {bound:.4f} by {by})", flush=True)
    return dict(rows=rows, registers=kregs)


# The kernels of MB and AB in ptxas's report: this tree's tensor-core
# kernels (MB's two row-tile launches, AB's row products and recompute, the
# weight gradients) and the FMA kernels of a parent's build (its row
# products, weight-gradient partials and AB's and AB-long's attention).
FUSED_BWD_KERNELS = ("ln_fc1_kernel", "ln_mlp_bwd_kernel", "rows_bwd_kernel",
                     "wgrad_mma_kernel", "ln_qkv_kernel",
                     "window_attn_bwd_short_", "window_attn_bwd_long_",
                     "linear_rows_kernel", "wgrad_partial_kernel",
                     "window_attn_bwd_kernel")
# Floats of scratch passed to every build's MB and AB: enough for the
# parent's layout and this tree's at every case below (the kernels check
# the size they are given against what they need).
BWD_WORK_FLOATS = 160 * 2 ** 20


def _fused_bwd_ab(cs, out_dir, regs, tags):
    """Kernels MB, AB and AB-long from every build in turns (tags +
    reversed + tags) at the fused steps' shapes with seeded weights: MB at
    the paper step's 256 x 144 x 180 in fp32 (ln_inj, ln, resi), the
    Enhanced step's 256 x 144 x 192 in bf16 (ln_inj, ln, zero_base) and
    fp32 (ln), and the Ultra step's 128 x 256 x 192 in bf16 and fp32 (ln);
    AB at the paper step's 256 x 144 x 180 x 6 heads in fp32 (cross with
    pos, kv and a bias; self with a bias) and the Enhanced step's with RoPE
    (cross with pos and kv, self) in bf16 and fp32 (self), and a bias in
    bf16; AB-long at the Ultra step's 128 x 256 x 192 with RoPE in bf16
    (cross, self) and fp32 (self), and a bias in fp32. Each build held to
    the plain version (chip_smoke.py's GRAD_TOL, or relative L2 2^-7 in
    bf16) and to the same bits twice; ms one call a time and ten back to
    back, the speed-up of the change over each other build, the bound (fp32:
    the products in 3xTF32 at the TF32 peak; bf16 at the bf16 peak) and the
    registers of each build's kernels."""
    import torch

    from gsasr_torch.models.fea2gs_rope_fast import rope_tables
    from gsasr_torch.ops import _build
    from gsasr_torch.ops import fused_layers as fl

    names = ("ln_mlp_bwd", "ln_mlp_bwd_bf16", "ln_attn_bwd",
             "ln_attn_bwd_bf16", "ln_attn_bwd_long", "ln_attn_bwd_long_bf16")
    entries = {}
    for tag in tags:
        for name in names:
            fn = getattr(ctypes.CDLL(os.path.join(
                out_dir, f"{tag}_{_build.source_of(name)}.so")), name)
            fn.argtypes = [_build._CTYPES[k] for k in _build.SIGNATURES[
                name]] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            entries[tag, name] = fn
    print("registers of MB's and AB's kernels:", flush=True)
    kregs = {}
    for key, r in sorted(regs.items()):
        if key.split(" ")[0] in FUSED_BWD[:2] and any(
                k in key for k in FUSED_BWD_KERNELS):
            kregs[key] = r
            print(f"  {key[:110]}: " + ", ".join(
                f"{t} {r.get(t)}" for t in tags), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(53)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    f32, bf16 = torch.float32, torch.bfloat16
    work = torch.empty(BWD_WORK_FLOATS, dtype=f32, device=dev)

    def call(tag, name, *args):
        err = entries[tag, name](*[
            a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the {tag}'s {name} failed: cudaError {err}")

    # (kernel, case, type, windows, Tq, Tk, C, options)
    cases = [("MB", "paper", f32, 256, 144, 144, 180, o)
             for o in ("ln_inj", "ln", "resi")]
    cases += [("MB", "Enhanced", bf16, 256, 144, 144, 192, o)
              for o in ("ln_inj", "ln", "zero_base")]
    cases += [("MB", "Enhanced", f32, 256, 144, 144, 192, "ln")]
    cases += [("MB", "Ultra", dt, 128, 256, 256, 192, "ln")
              for dt in (bf16, f32)]
    cases += [("AB", "paper", f32, 256, 144, 144, 180, o)
              for o in ("cross_bias", "self_bias")]
    cases += [("AB", "Enhanced", bf16, 256, 144, 144, 192, o)
              for o in ("rope_cross", "rope_self", "bias_self")]
    cases += [("AB", "Enhanced", f32, 256, 144, 144, 192, "rope_self")]
    cases += [("AB-long", "Ultra", bf16, 128, 256, 256, 192, o)
              for o in ("rope_cross", "rope_self")]
    cases += [("AB-long", "Ultra", f32, 128, 256, 256, 192, o)
              for o in ("rope_self", "bias_self")]
    rows = []
    for kind, case, dt, b, tq, tk, c, opts in cases:
        is_bf16 = dt == bf16
        x, g = rnd(b, tq, c).to(dt), rnd(b, tq, c).to(dt)
        m = b * tq
        if kind == "MB":
            kw = dict(w1=rnd(c, c) / 14, b1=rnd(c), w2=rnd(c, c) / 14,
                      b2=rnd(c), zero_base=opts == "zero_base")
            if opts in ("ln_inj", "ln"):
                kw.update(ln_w=1 + 0.1 * rnd(c), ln_b=0.1 * rnd(c))
            if opts == "ln_inj":
                kw.update(inj=rnd(b, c))
            if opts == "resi":
                kw.update(resi=rnd(b, tq, c).to(dt))
            ref = fl.ln_mlp_residual_bwd_plain(x, g, **kw)
            names_out = ("dx", "dresi", "dinj", "dln_w", "dln_b", "dw1",
                         "db1", "dw2", "db2")
            name = "ln_mlp_bwd" + "_bf16" * is_bf16
            base_is_t = int(opts not in ("resi", "zero_base"))

            def launch(tag, outs):
                (dx, dinj, dln, dw1, db1, dw2, db2) = outs
                call(tag, name, x, kw.get("inj"), kw.get("ln_w"),
                     kw.get("ln_b"), kw["w1"], kw["b1"], kw["w2"], g, dx,
                     dinj, dln, dw1, db1, dw2, db2, work, BWD_WORK_FLOATS,
                     m, tq, c, c, base_is_t)

            def new_outs():
                e = dict(dtype=f32, device=dev)
                return (torch.empty_like(x),
                        torch.empty(b, c, dtype=dt, device=dev)
                        if "inj" in kw else None,
                        torch.empty(2, c, **e) if "ln_w" in kw else None,
                        torch.empty(c, c, **e), torch.empty(c, **e),
                        torch.empty(c, c, **e), torch.empty(c, **e))

            def as_ref(outs):
                dx, dinj, dln, dw1, db1, dw2, db2 = outs
                return (dx, g if "resi" in kw else None, dinj,
                        None if dln is None else dln[0],
                        None if dln is None else dln[1], dw1, db1, dw2, db2)
            flops = 10.0 * m * c * c
            act = 2 if is_bf16 else 4
            nbytes = act * 3 * m * c + 4 * 4 * c * c
        else:
            nh = 6
            kw = {k: rnd(c, c) / 14 if k[0] == "w" else rnd(c)
                  for k in ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")}
            kw.update(ln_w=1 + 0.1 * rnd(c), ln_b=0.1 * rnd(c))
            if "cross" in opts:
                kw.update(pos=rnd(tq, c).to(dt), kv=rnd(b, tk, c).to(dt))
            if opts.startswith("rope"):
                side = int(round(max(tq, tk) ** 0.5))
                cos, sin = rope_tables(0.5 * rnd(2, nh, c // nh // 2), side,
                                       max(tq, tk))
                kw.update(rope_cos_q=cos[:tq].contiguous(),
                          rope_sin_q=sin[:tq].contiguous(),
                          rope_cos_k=cos[:tk].contiguous(),
                          rope_sin_k=sin[:tk].contiguous())
            else:
                kw.update(bias=0.5 * rnd(nh, tq, tk))
            ref = fl.ln_attn_proj_bwd_plain(x, g, num_heads=nh, **kw)
            names_out = ("dx", "dpos", "dkv", "dln_w", "dln_b", "dwq", "dbq",
                         "dwk", "dbk", "dwv", "dbv", "dwo", "dbo", "dbias",
                         "dcos_q", "dsin_q", "dcos_k", "dsin_k")
            a = {**dict.fromkeys(("bias", "pos", "kv") + fl._ROPE), **kw}
            name = ("ln_attn_bwd" + "_long" * (kind == "AB-long")
                    + "_bf16" * is_bf16)
            scale = float((c // nh) ** -0.5)
            rope = a["rope_cos_q"] is not None

            def launch(tag, outs):
                call(tag, name, x, a["pos"], a["kv"], a["ln_w"], a["ln_b"],
                     a["wq"], a["bq"], a["wk"], a["bk"], a["wv"], a["bv"],
                     a["wo"], a["bias"], *(a[r] for r in fl._ROPE), g,
                     *outs, work, BWD_WORK_FLOATS, b, tq, tk, c, nh, scale)

            def new_outs():
                e = dict(dtype=f32, device=dev)
                return (torch.empty_like(x),
                        torch.empty(b, tk, c, dtype=dt, device=dev)
                        if a["kv"] is not None else None,
                        torch.empty(tq, c, dtype=dt, device=dev)
                        if a["pos"] is not None else None,
                        torch.empty(2, c, **e),
                        *[torch.empty(*s, **e) for _ in range(4)
                          for s in ((c, c), (c,))],
                        torch.empty(nh, tq, tk, **e)
                        if a["bias"] is not None else None,
                        *([torch.empty(n, c, **e) for n in (tq, tq, tk, tk)]
                          if rope else [None] * 4))

            def as_ref(outs):
                dx, dkv, dpos, dln = outs[:4]
                return (dx, dpos, dkv, dln[0], dln[1], *outs[4:])
            flops = 2.0 * b * (11 * tq * c * c + 6 * tq * tk * c)
            act = 2 if is_bf16 else 4
            nbytes = (act * 3 * m * c + 4 * 8 * c * c
                      + (4 * 2 * nh * tq * tk if "bias" in opts else 0))
        outs = {}

        def run(tag):
            outs[tag] = new_outs()
            launch(tag, outs[tag])

        order = list(tags) + list(tags)[::-1] + list(tags)
        ms = {tag: [] for tag in tags}
        dev_ms = {tag: [] for tag in tags}
        for tag in order:
            ms[tag].append(cs._time_ms(lambda: run(tag), 10))
            dev_ms[tag].append(cs._batch_ms(lambda: run(tag)))
        errs = {}
        for tag in tags:
            first = outs[tag]
            run(tag)
            if not all(p is None or torch.equal(p, q)
                       for p, q in zip(first, outs[tag])):
                raise AssertionError(f"{kind} {case} {opts} {tag}: not the "
                                     "same bits twice")
            errs[tag] = cs._compare_grads(
                as_ref(first), ref, names_out,
                f"{kind} {case} {opts} {dt} {tag}",
                {"dbk": "dwk"} if kind != "MB" else None,
                cs.BWD_BF16_TOL if is_bf16 else cs.GRAD_TOL, l2=is_bf16)
        bound, by = (cs._bound_ms(flops, nbytes, cs.PEAK_BF16) if is_bf16
                     else cs._bound_ms(3 * flops, nbytes, cs.PEAK_TF32))
        med = {tag: sorted(v)[len(v) // 2] for tag, v in ms.items()}
        dmed = {tag: sorted(v)[len(v) // 2] for tag, v in dev_ms.items()}
        rows.append(dict(kernel=kind, case=case, options=opts,
                         dtype=str(dt).replace("torch.", ""), windows=b,
                         ms=ms, dev_ms=dev_ms,
                         speedup={t: med[t] / med["change"]
                                  for t in tags if t != "change"},
                         bound_ms=bound, bound_by=by, max_abs_err=errs))
        speed = ", ".join(f"{med[t] / med['change']:.2f}x over {t}"
                          for t in tags if t != "change")
        print(f"  {kind} {case} {opts} {rows[-1]['dtype']}: " + ", ".join(
            f"{t} {[round(v, 4) for v in ms[t]]}" for t in tags)
            + f" ms; {speed}; back to back " + ", ".join(
                f"{t} {dmed[t]:.4f}" for t in tags)
            + f" ms (bound {bound:.4f} by {by})", flush=True)
    rows += _bf16_bodies_ab(cs, out_dir, tags)
    return dict(rows=rows, registers=kregs)


def _bf16_bodies_ab(cs, out_dir, tags):
    """WB-bf16 at the Enhanced step's 256 x 6 x 144 x 32 and WB-long-bf16
    at the Ultra step's 128 x 6 x 256 x 32 (no bias), from every build in
    turns: the bf16 bodies whose AB form this tree adds, each build the
    same bits twice and the largest difference from the first build's."""
    import torch

    from gsasr_torch.ops import _build

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(57)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    rows = []
    for form, name, b, t in (("WB-bf16", "window_attn_bwd_bf16", 256, 144),
                             ("WB-long-bf16", "window_attn_bwd_long_bf16",
                              128, 256)):
        c, nh = 192, 6
        ents = {}
        for tag in tags:
            fn = getattr(ctypes.CDLL(os.path.join(
                out_dir, f"{tag}_{_build.source_of(name)}.so")), name)
            fn.argtypes = [_build._CTYPES[k] for k in _build.SIGNATURES[
                name]] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            ents[tag] = fn
        q, k, v, g = (rnd(b, t, c).to(torch.bfloat16) for _ in range(4))
        stats = torch.empty(b * nh * t * 3, device=dev)
        outs = {}

        def run(tag):
            dq, dk, dv = (torch.empty_like(q) for _ in range(3))
            args = ((q, k, v, None, g, dq, dk, dv, None, None)
                    if name == "window_attn_bwd_bf16" else
                    (q, k, v, None, g, dq, dk, dv, stats, None, None))
            err = ents[tag](*[a.data_ptr() if isinstance(a, torch.Tensor)
                              else a for a in args], b, t, t, c, nh,
                            float((c // nh) ** -0.5),
                            torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"the {tag}'s {name}: cudaError {err}")
            outs[tag] = (dq, dk, dv)

        ms = {tag: [] for tag in tags}
        for tag in list(tags) + list(tags)[::-1] + list(tags):
            ms[tag].append(cs._time_ms(lambda: run(tag), 10))
        first = tags[0]
        diff = {}
        for tag in tags:
            was = outs[tag]
            run(tag)
            if not all(torch.equal(p, r) for p, r in zip(was, outs[tag])):
                raise AssertionError(f"{form} {tag}: not the same bits twice")
            diff[tag] = max(float((p.float() - r.float()).abs().max())
                            for p, r in zip(outs[tag], outs[first]))
        rows.append(dict(kernel=form, case=f"{b} x {nh} x {t} x {c // nh}",
                         options="no bias", dtype="bfloat16", windows=b,
                         ms=ms, max_diff_from_first=diff))
        print(f"  {form} {b}x{nh}x{t}x{c // nh}: " + ", ".join(
            f"{tg} {[round(x_, 4) for x_ in ms[tg]]}" for tg in tags)
            + f" ms; largest difference from the {first}'s: {diff}",
            flush=True)
    return rows


# The fused steps --fused-bwd-only --steps times: (networks, recipe, batch)
FUSED_STEPS = ("paper EDSR fp32 fused step", "Enhanced EDSR bf16 fused step",
               "HAT-L Ultra bf16 fused step")


def _fused_steps_ab(cs, out_dir, tags, sigs, srcs, turns):
    """The fused steps of FUSED_STEPS with each build's entry points of
    `srcs` (MB's, AB's and WB's sources) in turns (`_turns`; `_swapper`),
    the rest of the port this tree's, on one Trainer each (fused_decoder
    =True): per turn two warm-up steps, the median wall time of three steps
    (host clock, synchronised), and the device time of one step under
    torch.profiler (its kernels' summed time), with the launch counts of
    MB, AB and AB-long per step."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gsasr_torch.model import make_models
    from gsasr_torch.train import TrainConfig, Trainer

    kernels = cs.kernel_wrappers()
    swap = _swapper(out_dir, tags, sigs, srcs)
    work = torch.empty(BWD_WORK_FLOATS, dtype=torch.float32, device="cuda")
    out = {}
    for label in FUSED_STEPS:
        ultra = "Ultra" in label
        if label.startswith("paper"):
            enc, dec = make_models("edsr", "paper",
                                   generator=torch.Generator().manual_seed(0))
            recipe, ceil = cs.PAPER_TRAIN, False
        else:
            enc, dec = cs.enhanced_networks("hat" if ultra else "edsr")
            recipe = cs.ULTRA_TRAIN if ultra else cs.ENHANCED_TRAIN
            ceil = not ultra
        tr = Trainer(enc, dec, TrainConfig(**dict(recipe,
                                                  fused_decoder=True)))
        batches = [cs.paper_batch(cs.ULTRA_BATCH if ultra else
                                  cs.PAPER_BATCH, seed=30 + i, ceil=ceil,
                                  ultra=ultra) for i in range(3)]
        res = {tag: dict(wall_ms=[], device_ms=[]) for tag in tags}
        counts = None
        for tag in _turns(tags, turns):
            swap(tag)
            _big_work(work)
            for i in range(2):
                tr.step(batches[i % 3])
            torch.cuda.synchronize()
            walls = []
            for i in range(3):
                t0 = time.perf_counter()
                tr.step(batches[i])
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            before = {k: f.launches for k, f in kernels.items()}
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                tr.step(batches[0])
                torch.cuda.synchronize()
            dev_ms = sum(e.self_device_time_total for e in
                         prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and not getattr(e, "is_user_annotation", False)
                         ) / 1e3
            counts = {k: f.launches - before[k] for k, f in kernels.items()
                      if k in ("MB", "AB", "AB-long")}
            res[tag]["wall_ms"].append(sorted(walls)[1])
            res[tag]["device_ms"].append(dev_ms)
        out[label] = dict(res, launches=counts)
        print(f"  {label}: " + "; ".join(
            f"{t} wall {[round(v, 1) for v in r['wall_ms']]} ms, device "
            f"{[round(v, 1) for v in r['device_ms']]} ms"
            for t, r in res.items()) + f"; launches {counts}", flush=True)
        del tr, enc, dec, batches
        gc.collect()
        torch.cuda.empty_cache()
    swap(None)
    return out


def _big_work(work):
    """The loaded MB and AB entry points (the port's wrappers call them)
    wrapped to take `work` (BWD_WORK_FLOATS floats) as their scratch: a
    parent's layout may need more scratch than this tree's wrappers give."""
    from gsasr_torch.ops import _build

    for name in ("ln_mlp_bwd", "ln_mlp_bwd_bf16", "ln_attn_bwd",
                 "ln_attn_bwd_bf16", "ln_attn_bwd_long",
                 "ln_attn_bwd_long_bf16"):
        fn = _build._libs[name]
        at = _build.SIGNATURES[name].index("i") - 1  # the work pointer

        def call(*a, fn=fn, at=at):
            a = list(a)
            a[at], a[at + 1] = work.data_ptr(), BWD_WORK_FLOATS
            return fn(*a)
        _build._libs[name] = call


def _swapper(out_dir, tags, sigs, srcs):
    """swap(tag): the port's kernels of the sources `srcs` (built for every
    tag in out_dir) replaced by tag's build's entry points, each called with
    this tree's arguments; RB through rasterizer.raster_bwd (a parent's RB
    takes the chunk boxes, `_raster_kernels`); the launch counts stay the
    port wrappers'. swap(None) puts this tree's back."""
    from gsasr_torch.ops import _build
    from gsasr_torch.ops import rasterizer as rz

    names = [n for n in _build.SIGNATURES
             if _build.source_of(n) in srcs and n != "raster_bwd"]
    _build.build(list(_build.SIGNATURES))
    mine = {n: _build._libs[n] for n in names}
    ents = _entries(out_dir, tags, names, sigs)
    bwd = rz.raster_bwd
    rb = (_raster_kernels(out_dir, tags, sigs) if "raster_bwd" in srcs
          else {})

    def swap(tag):
        for name in names:
            _build._libs[name] = mine[name] if tag is None else ents[
                tag, name]
        if rb:
            rz.raster_bwd = bwd if tag is None else rb[tag][1]
    return swap


def _turns(tags, turns):
    """`turns` pairs of turns, which build goes first alternating: parent,
    change, change, parent, parent, change, ..."""
    return [t for i in range(turns) for t in (tags if i % 2 == 0
                                              else tags[::-1])]


def _steps_ab(cs, out_dir, tags, sigs, srcs, steps, turns):
    """Training steps with each build's entry points of `srcs` in turns
    (`_turns`; `_swapper`): the step medians of
    chip_smoke.py's `steps` (labels of STEPS); with the window attentions'
    sources also the HAT-L Ultra image in fp32 (W-long 84): the e2e
    medians."""
    import gc

    import torch

    from gsasr_torch.model import make_models

    dev = torch.device("cuda")
    kernels = cs.kernel_wrappers()
    swap = _swapper(out_dir, tags, sigs, srcs)
    out = {}
    for label in steps:
        ms = {tag: [] for tag in tags}
        for tag in _turns(tags, turns):
            swap(tag)
            kw = dict(STEPS[label])
            if "ultra" in kw:
                kw["ultra"] = getattr(torch, kw["ultra"])
            res = cs.train_phase(dev, kernels, fused=False, **kw)
            ms[tag].append(res["step_ms_median"])
            gc.collect()
            torch.cuda.empty_cache()
        out[label] = ms
        print(f"  {label}: " + ", ".join(f"{t} {v} ms" for t, v in
                                         ms.items()), flush=True)
    if "window_attn_fwd" in srcs:
        enc, dec = make_models("hat", "ultra",
                               generator=torch.Generator().manual_seed(0))
        enc, dec = enc.to(dev).eval(), dec.to(dev).eval()
        ms = {tag: [] for tag in tags}
        for tag in _turns(tags, turns):
            swap(tag)
            res = cs.e2e_phase(enc, dec, dev, label="HAT-L Ultra",
                               denominator=cs.ULTRA_DENOMINATOR)
            ms[tag].append(res["e2e_ms_median"])
        out["HAT-L Ultra image"] = ms
        print("  HAT-L Ultra image: " + ", ".join(f"{t} {v} ms" for t, v in
                                                  ms.items()), flush=True)
    swap(None)
    return out


def _images_ab(cs, out_dir, tags, sigs, srcs, turns):
    """The images, with each build's entry points of `srcs` (M's and A's
    sources, R's) in turns (`_turns`; `_swapper`),
    the rest of the port this tree's: the paper EDSR image in fp32 (83 M,
    38 A, 1 R), the Enhanced EDSR image with its bf16 trunk (83 M, 38 A,
    1 R), and the HAT-L Ultra image at model_dtype float32 and bfloat16
    (140 M, 64 A-long, 1 R; denominator 16), each the median of 9 runs of
    chip_smoke.py's 180x180 -> 720x720 x4 sr_forward after 2 warm-ups
    (chip_smoke.py's e2e metric)."""
    import gc

    import numpy as np
    import torch

    from gsasr_torch.model import make_models, sr_forward

    dev = torch.device("cuda")
    swap = _swapper(out_dir, tags, sigs, srcs)

    lq = torch.rand(1, 180, 180, 3,
                    generator=torch.Generator().manual_seed(4)).to(dev)
    out = {}
    for label, args, kw, dt, den in (
            ("paper EDSR fp32 image", ("edsr", "paper"), {}, None, 12),
            ("Enhanced EDSR bf16 image", ("edsr", "enhanced"), {},
             torch.bfloat16, 12),
            ("HAT-L Ultra float32 image", ("hat", "ultra"), {}, None, 16),
            ("HAT-L Ultra bf16 image", ("hat", "ultra"),
             dict(dtype=torch.bfloat16), None, 16)):
        enc, dec = make_models(*args, **kw,
                               generator=torch.Generator().manual_seed(0))
        enc, dec = enc.to(dev).eval(), dec.to(dev).eval()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        ms = {tag: [] for tag in tags}
        with torch.no_grad():
            for tag in _turns(tags, turns):
                swap(tag)
                ms[tag].append(float(np.median(cs._host_ms(
                    lambda: sr_forward(enc, dec, lq, 4.0, trunk_dtype=dt,
                                       denominator=den), 9))))
        out[label] = ms
        print(f"  {label}: " + ", ".join(f"{t} {v} ms" for t, v in
                                         ms.items()), flush=True)
        del enc, dec
        gc.collect()
        torch.cuda.empty_cache()
    swap(None)
    return out


def _raster_kernels(out_dir, tags, sigs):
    """{tag: (fwd, bwd)}: kernels R and RB of each build, called as the
    port's wrappers are (fwd(geom, colors, bbox, h, w), bwd(geom, colors,
    bbox, g, h, w)), on the current stream; a build whose RB takes the
    chunk boxes (before this tree's) gets them. bwd adds its launches to
    the port's RB wrapper's count."""
    import torch

    from gsasr_torch.ops import _build
    from gsasr_torch.ops import rasterizer as rz

    ents = _entries(out_dir, tags, RASTER, sigs, adapted=("raster_bwd",))
    counter = rz.raster_bwd

    def call(tag, name, *args):
        err = ents[tag, name](*[a.data_ptr() if isinstance(a, torch.Tensor)
                                else a for a in args],
                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the {tag}'s {name} failed: cudaError {err}")

    def kernels(tag):
        def fwd(geom, colors, bbox, h, w):
            out = torch.empty(h, w, 3, device=geom.device)
            kc = bbox.shape[1]
            call(tag, "raster_fwd", geom, colors, bbox, out, kc,
                 geom.shape[0] // kc, h, w)
            return out

        def bwd(geom, colors, bbox, g, h, w):
            s, kc = geom.shape[0], bbox.shape[1]
            dgeom = torch.empty(s, 16, device=geom.device)
            dcol = torch.empty(s, 3, device=geom.device)
            if sigs[tag]["raster_bwd"] == _build.SIGNATURES["raster_bwd"]:
                call(tag, "raster_bwd", geom, colors, g, dgeom, dcol, s, h, w)
            else:
                call(tag, "raster_bwd", geom, colors, bbox, g, dgeom, dcol,
                     kc, s // kc, h, w)
            counter.launches += 1
            return dgeom, dcol
        return fwd, bwd
    return {tag: kernels(tag) for tag in tags}


def _raster_ab(cs, out_dir, tags, sigs):
    """Kernels R and RB from every build in turns (tags + reversed + tags)
    on chip_smoke.RASTER_WORKLOADS: the paper image's 720x720 render, the
    paper step's 3072x192 and the Ultra step's 8192x1024 slot canvases of
    the seeded networks' Gaussians, and phase 37's trained-like and
    init-like 720x720 renders of 518,400 Gaussians. Each build's R is held
    to the plain version within chip_smoke's KERNEL_ATOL/KERNEL_RTOL and to
    the same bits twice, and this tree's R to the first build's bits (R's
    per-pair arithmetic is unchanged); each build's RB to the plain version
    within GRAD_TOL and to the same bits twice. Times: one call (CUDA
    events, median of 10) in each turn, and ten back to back; bounds as
    chip_smoke.py's."""
    import gc

    import torch

    from gsasr_torch.ops import rasterizer as rz

    dev = torch.device("cuda")
    kern = _raster_kernels(out_dir, tags, sigs)
    gen = torch.Generator().manual_seed(18)
    out = {}
    for name in cs.RASTER_WORKLOADS:
        geom, col, bbox, h, w = cs.raster_workload(name, dev)
        g = torch.randn(h, w, 3, generator=gen).to(dev)
        pairs = cs.box_pairs(geom, h, w)
        for key, idx, args, ref in (
                ("R", 0, (geom, col, bbox, h, w),
                 rz.raster_fwd_plain(geom, col, bbox, h, w)),
                ("RB", 1, (geom, col, bbox, g, h, w),
                 rz.raster_bwd_plain(geom, col, bbox, g, h, w))):
            res, first = {}, {}
            for tag in tags:
                fn = kern[tag][idx]
                a, b = fn(*args), fn(*args)
                a, b = (a, b) if key == "RB" else ((a,), (b,))
                if not all(torch.equal(x, y) for x, y in zip(a, b)):
                    raise AssertionError(f"{key} {name}: the {tag}'s two "
                                         "launches differ")
                if key == "R":
                    err = cs._compare(a[0], ref, f"R {name} {tag}")
                else:
                    if not bool((a[0][:, 5:] == 0).all()):
                        raise AssertionError(f"RB {name} {tag}: cull-box "
                                             "columns got a gradient")
                    err = max(cs._compare_grad(o, r, f"RB {name} {tag} {n}")
                              for o, r, n in zip(a, ref, ("dgeom", "dcol")))
                first[tag] = a
                res[tag] = dict(max_abs_err=err, ms=[])
            same = all(torch.equal(x, y) for x, y in zip(first[tags[0]],
                                                         first["change"]))
            if key == "R" and not same:
                raise AssertionError(f"R {name}: the change's bits differ "
                                     f"from the {tags[0]}'s")
            for tag in list(tags) + list(tags)[::-1] + list(tags):
                res[tag]["ms"].append(round(cs._time_ms(
                    lambda: kern[tag][idx](*args), 10), 4))
            for tag in tags:
                res[tag]["back_to_back_ms"] = round(cs._batch_ms(
                    lambda: kern[tag][idx](*args)), 4)
            ops = cs.RASTER_OPS_PER_PAIR if key == "R" else cs.RB_OPS_PER_PAIR
            bound = max(pairs * ops / cs.PEAK_FP32, pairs / cs.PEAK_SFU) * 1e3
            out[f"{key} {name}"] = dict(builds=res, box_pairs=pairs,
                                        bound_ms=bound, same_bits=same)
            med = {t: sorted(r["ms"])[1] for t, r in res.items()}
            speed = ", ".join(f"{med[t] / med['change']:.2f}x over {t}"
                              for t in tags if t != "change")
            print(f"  {key} {name}: " + ", ".join(
                f"{t} {r['ms']} ms" for t, r in res.items())
                + "; back to back " + ", ".join(
                f"{t} {r['back_to_back_ms']}" for t, r in res.items())
                + f"; {speed} (bound {bound:.4f} by operations, "
                f"{pairs:.4e} box pairs); the same bits as the {tags[0]}'s: "
                f"{same}", flush=True)
        del geom, col, bbox, g
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _exact_ab(cs, out_dir, tags, sigs):
    """The exact render (phase 37's 720x720 render of 518,400 Gaussians,
    dmax 0.1) with each build in turns (tags + reversed + tags): R-exact's
    walk on the trained-like lists (one call, CUDA events, median of 10,
    and ten back to back), each build's image the same bits twice and this
    tree's the first build's bits; then the whole path
    (gs_render(binning="exact"), host clock, median of 9) on the
    trained-like and the init-like Gaussians, with each build's R-exact
    and lists: this tree's CUDA build (kernel XB) where the build's
    `_build.py` declares it, else `exact_tables` (the torch ops the parent
    ran); R's path (binning="auto") beside it, and the list build's host
    and device ms per build."""
    import numpy as np
    import torch

    from gsasr_torch.ops import _build
    from gsasr_torch.ops import rasterizer as rz

    dev = torch.device("cuda")
    ents = _entries(out_dir, tags, ("raster_fwd_exact",), sigs)
    _build.build(["raster_fwd_exact", "exact_build"])
    mine = _build._libs["raster_fwd_exact"]
    build_cuda = rz.exact_build
    hw, dmax = cs.EXACT_HW, cs.EXACT_DMAX
    box = dmax * (hw - 1) + 1
    mr, mc = rz._exact_spans(hw, hw, (box, box))

    def swap(tag):
        _build._libs["raster_fwd_exact"] = (mine if tag is None
                                            else ents[tag, "raster_fwd_exact"])
        cuda_build = tag is None or "exact_build" in sigs[tag]
        rz.exact_build = build_cuda if cuda_build else rz.exact_tables

    out = {}
    for kind in ("trained", "init"):
        sigmas, coords, colors = cs.exact_workload(kind, dev)
        geom = rz.pack_geometry(sigmas, coords, (hw, hw), dmax)
        res = {tag: dict(path_ms=[], build_ms=[]) for tag in tags}
        if kind == "trained":
            swap(None)
            g, col, _, lists, tab, ok = rz.exact_geometry(geom, colors,
                                                          (hw, hw), mr, mc)
            assert bool(ok)
            imgs = {}
            for tag in tags:
                swap(tag)
                a = rz.raster_fwd_exact(g, col, lists, tab, hw, hw)
                if not torch.equal(a, rz.raster_fwd_exact(g, col, lists, tab,
                                                          hw, hw)):
                    raise AssertionError(f"R-exact: the {tag}'s two "
                                         "launches differ")
                imgs[tag] = a
                res[tag].update(walk_ms=[])
            same = torch.equal(imgs[tags[0]], imgs["change"])
            if not same:
                raise AssertionError("R-exact: the change's bits differ "
                                     f"from the {tags[0]}'s")
            for tag in list(tags) + list(tags)[::-1] + list(tags):
                swap(tag)
                res[tag]["walk_ms"].append(round(cs._time_ms(
                    lambda: rz.raster_fwd_exact(g, col, lists, tab, hw, hw),
                    10), 4))
            for tag in tags:
                swap(tag)
                res[tag]["walk_back_to_back_ms"] = round(cs._batch_ms(
                    lambda: rz.raster_fwd_exact(g, col, lists, tab, hw, hw)),
                    4)
            del g, col, lists, tab
        for tag in list(tags) + list(tags)[::-1] + list(tags):
            swap(tag)
            res[tag]["path_ms"].append(round(float(np.median(cs._host_ms(
                lambda: rz.gs_render(sigmas, coords, colors, (hw, hw), dmax,
                                     binning="exact"), 9))), 4))
            res[tag]["build_ms"].append(round(float(np.median(cs._host_ms(
                lambda: rz.exact_geometry(geom, colors, (hw, hw), mr, mc),
                9))), 4))
        for tag in tags:
            swap(tag)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                rz.exact_geometry(geom, colors, (hw, hw), mr, mc)
                torch.cuda.synchronize()
            res[tag]["build_device_ms"] = round(sum(
                e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3, 4)
        swap(None)
        r_path = round(float(np.median(cs._host_ms(lambda: rz.gs_render(
            sigmas, coords, colors, (hw, hw), dmax), 9))), 4)
        out[kind] = dict(builds=res, r_path_ms=r_path)
        print(f"  exact {kind}: " + "; ".join(
            f"{t} " + ", ".join(f"{k} {v}" for k, v in r.items())
            for t, r in res.items()) + f"; R's path {r_path} ms", flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
