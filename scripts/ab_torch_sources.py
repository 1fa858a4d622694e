#!/usr/bin/env python3
"""Compare the port's CUDA sources of a parent checkout with this tree's on
one card: ptxas's registers of every kernel of the named sources, kernel
R's time, the bf16 window attention's up to 160 tokens (W-bf16, WB-bf16
and their masked forms WM-bf16, WMB-bf16) from both builds in turns
(parent, change, change, parent, ...), with the window-16 routing (this
tree's W-long-bf16 and WB-long-bf16 on the same operands) beside them, and
the fp32 window-16 backward (WB-long, WMB-long, WB4-long) from every build
in turns.

  python3 scripts/ab_torch_sources.py --parent DIR [--label NAME]
      [--parent DIR2 --label NAME2 ...] [--skip-raster] [--fp32-long-only]
      [--steps] [--json PATH]

DIR holds the parent's `gsasr_torch/ops/csrc` (for example
`git archive <parent> gsasr_torch/ops/csrc | tar -x -C DIR`), or a variant
of this tree's sources, named in the output by --label; further --parent
DIR --label NAME pairs add variants, which only the fp32 window-16
backward times (the other sections take the first). All builds use
`gsasr_torch/ops/_build.py`'s flags and go to build/ab_sources/. R runs
on chip_smoke.py's exact-render workloads (scripts/bench_exact_render.py's
720x720 render of 518,400 Gaussians, trained-like and init-like boxes),
chunked as `gs_render` chunks them for R, and both builds must give the
same bits (--skip-raster leaves it out). The attention runs at the
Enhanced training step's shape (256 windows of 144 tokens, 6 heads of 32,
no bias), at the bf16 SwinIR step's unshifted blocks (576 windows of 64
tokens, 6 heads of 30, a bias) and at its shifted blocks (the same with the
SW-MSA mask of period 36: WM-bf16, WMB-bf16); each build's result must
hold against the plain version within the bf16 tolerance (2^-7 |ref| +
2^-8 max|ref|), and the largest difference between the two builds is
printed. The fp32 window-16 backward runs at the fp32 Ultra step's shapes
(WB-long: 128 windows of 256 x 256 and 256 x 576, 6 heads of 32, no bias)
and the paper HAT step's (WMB-long: 144 windows of 256 x 256, 6 heads of
30, a bias and the SW-MSA mask of period 9), and WB4-long on the
head-major layout at 128 x 6 x 256 x 256 x 32 with a bias; each build's
dq, dk, dv (and dbias) must hold against the plain version within 1e-4 of
each column's largest entry, and give the same bits twice.
--fp32-long-only builds window_attn_bwd.cu alone and times only that
section. --steps then times two training steps that run the fp32
window-16 backward, chip_smoke.py's HAT-L Ultra step at model_dtype
float32 (WB-long 148 a step) and its paper HAT step (WB-long 24, WMB-long
18), with the first build's and this tree's window_attn_bwd.cu in turns
(parent, change, change, parent): their entry points are swapped into the
port's loaded kernels, and the rest of the port is this tree's. Each
kernel's registers in every build are printed beside its form.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCES = ("raster_fwd", "window_attn_fwd", "window_attn_bwd", "ln_attn",
           "ln_attn_bwd")


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


# The fp32 window-16 backward's kernels in the parent (the FMA body's
# instantiations: (T, kMask, kAtt, kRnd, kHM) for the dq launch, (T, kMask,
# kRnd, kHM) for the dk/dv launch) and in this tree (the 3xTF32 body, by its
# flags kMask, kHM).
LONG_FP32_KERNELS = {
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

    print(f"registers of the fp32 window-16 backward ({', '.join(tags)}):",
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, action="append",
                    help="directory holding the parent's gsasr_torch/ops/csrc"
                    " (repeat for more variants)")
    ap.add_argument("--label", action="append",
                    help="name of the other tree in the output (a variant "
                    "of this tree's sources, say), one per --parent")
    ap.add_argument("--skip-raster", action="store_true",
                    help="time the attention forms only, not kernel R")
    ap.add_argument("--fp32-long-only", action="store_true",
                    help="build window_attn_bwd.cu alone and time only the "
                    "fp32 window-16 backward")
    ap.add_argument("--steps", action="store_true",
                    help="also time the fp32 Ultra and paper HAT training "
                    "steps with the first build's and this tree's "
                    "window_attn_bwd.cu in turns")
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
    sources = ("window_attn_bwd",) if args.fp32_long_only else SOURCES
    jobs = [(tag, src, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
         os.path.join(out_dir, f"{tag}_{src}.so"),
         os.path.join(d, f"{src}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
        for tag, d in dirs.items()
        for src in (sources if tag in (old, "change") else
                    ("window_attn_bwd",))]
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
        print(f"  {key[:120]}: {r.get(old)} -> {r.get('change')}{mark}",
              flush=True)
    times, attn = {}, {}
    if not (args.skip_raster or args.fp32_long_only):
        times = _raster_ab(cs, out_dir, {old: dirs[old],
                                         "change": dirs["change"]})
    if not args.fp32_long_only:
        attn = _attention_ab(cs, out_dir, regs, (old, "change"))
    long_fp32 = _long_fp32_ab(cs, out_dir, regs, tuple(dirs))
    steps = _steps_ab(cs, out_dir, (old, "change")) if args.steps else {}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, registers=regs, r_ms=times,
                           attention=attn, long_fp32=long_fp32,
                           steps=steps), f, indent=1)
    return 0


def _steps_ab(cs, out_dir, tags):
    """chip_smoke.py's HAT-L Ultra step at model_dtype float32 and its paper
    HAT step, with each build's window_attn_bwd.cu in turns: the step
    medians of every turn by build."""
    import gc

    import torch

    from gsasr_torch.ops import _build

    dev = torch.device("cuda")
    kernels = cs.kernel_wrappers()
    _build.build(list(_build.SIGNATURES))
    names = [n for n in _build.SIGNATURES
             if _build.source_of(n) == "window_attn_bwd"]
    entries = {}
    for tag in tags:
        lib = ctypes.CDLL(os.path.join(out_dir, f"{tag}_window_attn_bwd.so"))
        for name in names:
            fn = getattr(lib, name)
            fn.argtypes = [_build._CTYPES[k] for k in _build.SIGNATURES[
                name]] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            entries[tag, name] = fn
    out = {}
    for label, kw in (("HAT-L Ultra float32 step",
                       dict(encoder="hat", ultra=torch.float32)),
                      ("paper HAT float32 step", dict(encoder="hat_paper"))):
        ms = {tag: [] for tag in tags}
        for tag in list(tags) + list(tags)[::-1]:
            for name in names:
                _build._libs[name] = entries[tag, name]
            res = cs.train_phase(dev, kernels, fused=False, **kw)
            ms[tag].append(res["step_ms_median"])
            gc.collect()
            torch.cuda.empty_cache()
        out[label] = ms
        print(f"  {label}: " + ", ".join(f"{t} {v} ms" for t, v in
                                         ms.items()), flush=True)
    return out


def _raster_ab(cs, out_dir, dirs):
    """Kernel R from both builds in turns on chip_smoke.py's exact-render
    workloads; both must give the same bits."""
    import torch

    from gsasr_torch.ops import _build
    from gsasr_torch.ops import rasterizer as rz

    old = next(iter(dirs))
    fns = {}
    for tag in dirs:
        fn = ctypes.CDLL(os.path.join(out_dir, f"{tag}_raster_fwd.so")
                         ).raster_fwd
        fn.argtypes = [_build._CTYPES[k] for k in _build.SIGNATURES[
            "raster_fwd"]] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[tag] = fn
    dev = torch.device("cuda")
    hw = cs.EXACT_HW
    times = {}
    for kind in ("trained", "init"):
        sigmas, coords, colors = cs.exact_workload(kind, dev)
        geom = rz.pack_geometry(sigmas, coords, (hw, hw), cs.EXACT_DMAX)
        g, col, bbox = rz.chunk_geometry(geom, colors, (hw, hw))
        outs = {}

        def run(tag):
            out = torch.empty(hw, hw, 3, device=dev)
            err = fns[tag](g.data_ptr(), col.data_ptr(), bbox.data_ptr(),
                           out.data_ptr(), bbox.shape[1], g.shape[0]
                           // bbox.shape[1], hw, hw,
                           torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"the {tag}'s R failed: cudaError {err}")
            outs[tag] = out

        ms = {tag: [] for tag in dirs}
        for tag in (old, "change", "change", old, old, "change"):
            ms[tag].append(cs._time_ms(lambda: run(tag), 20))
        same = torch.equal(outs[old], outs["change"])
        times[kind] = dict(ms, same_bits=same)
        print(f"  R {kind}: {old} {ms[old]} ms, change {ms['change']} ms; "
              f"the same bits: {same}", flush=True)
        if not same:
            raise AssertionError(f"R {kind}: the two builds differ")
    return times


if __name__ == "__main__":
    sys.exit(main())
