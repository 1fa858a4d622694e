#!/usr/bin/env python3
"""Compare the port's CUDA sources of a parent checkout with this tree's on
one card: ptxas's registers of every kernel of the named sources, kernel
R's time, and the bf16 window-16 attention's (W-long-bf16, WB-long-bf16 and
their masked forms WM-long-bf16, WMB-long-bf16) from both builds in turns
(parent, change, change, parent, ...).

  python3 scripts/ab_torch_sources.py --parent DIR [--json PATH]

DIR holds the parent's `gsasr_torch/ops/csrc` (for example
`git archive <parent> gsasr_torch/ops/csrc | tar -x -C DIR`). Both builds
use `gsasr_torch/ops/_build.py`'s flags and go to build/ab_sources/. R runs
on chip_smoke.py's exact-render workloads (scripts/bench_exact_render.py's
720x720 render of 518,400 Gaussians, trained-like and init-like boxes),
chunked as `gs_render` chunks them for R, and both builds must give the
same bits. The attention runs at the HAT-L Ultra step's shapes (128
windows of 256 queries against 256 and 576 keys, 6 heads of 32, no bias)
and the paper HAT's masked bf16 shape (144 windows of 256 x 256, 6 heads
of 30, its shifted blocks' bias and SW-MSA mask of period 9); each build's
result must hold against the plain version within the bf16 tolerance
(2^-7 |ref| + 2^-8 max|ref|), and the largest difference between the two
builds is printed. Each kernel's registers in both builds are printed
beside its form.
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
    translation unit's unique prefix."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}|(?<=_cu_)[0-9a-f]{8}",
                          "", m.group(1))
        r = re.search(r"Used (\d+) registers", line)
        if r and name:
            out[name] = int(r.group(1))
    return out


# The moved forms' kernels: (source, name key, argument key) in the parent
# (the FMA body's bf16 instantiations) and in this tree (the tensor-core
# body's kernels, named by their flags kMask, kHM).
MOVED_KERNELS = {
    "W-long-bf16": ([("window_attn_fwd", "window_attn_fwd_long_kernel",
                      "bfloat16")],
                    [("window_attn_fwd", "window_attn_fwd_long_mma_kernel",
                      "ILb0ELb0E")]),
    "WM-long-bf16": ([("window_attn_fwd",
                       "window_attn_fwd_long_masked_kernel", "bfloat16")],
                     [("window_attn_fwd", "window_attn_fwd_long_mma_kernel",
                       "ILb1ELb0E")]),
    "A-long-bf16 attention": ([("ln_attn", "attn_long_kernel", "bfloat16")],
                              [("ln_attn", "window_attn_fwd_long_mma_kernel",
                                "ILb0ELb0E")]),
    "WB-long-bf16": ([("window_attn_bwd", "window_attn_bwd_long_",
                       "bfloat16Lb0ELb0ELb0ELb0EE"),
                      ("window_attn_bwd", "window_attn_bwd_long_",
                       "bfloat16Lb0ELb0ELb0EE")],
                     [("window_attn_bwd", "window_attn_bwd_long_mma_",
                       "ILb0ELb0E")]),
    "WMB-long-bf16": ([("window_attn_bwd", "window_attn_bwd_long_",
                        "bfloat16Lb1E")],
                      [("window_attn_bwd", "window_attn_bwd_long_mma_",
                        "ILb1ELb0E")]),
    "W4-long-bf16": ([("window_attn_fwd", "window_attn_fwd_4d_long_kernel",
                       "bfloat16")],
                     [("window_attn_fwd", "window_attn_fwd_long_mma_kernel",
                       "ILb0ELb1E")]),
    "WB4-long-bf16": ([("window_attn_bwd", "window_attn_bwd_long_",
                        "bfloat16Lb0ELb0ELb0ELb1EE"),
                       ("window_attn_bwd", "window_attn_bwd_long_",
                        "bfloat16Lb0ELb0ELb1EE")],
                      [("window_attn_bwd", "window_attn_bwd_long_mma_",
                        "ILb0ELb1E")]),
}


def _attention_ab(cs, out_dir, regs):
    """W-long-bf16 and WB-long-bf16 at the Ultra step's shapes, WM-long-bf16
    and WMB-long-bf16 at the paper HAT's, from both builds in turns: ms of
    each, the speed-up, the bound, SDPA's time, and the registers of the
    kernels of each form."""
    import torch

    from gsasr_torch.models.swinir import swin_attn_mask
    from gsasr_torch.ops import _build
    from gsasr_torch.ops import attention as ta

    entries = {}
    for tag in ("parent", "change"):
        for name in ("window_attn_fwd_long_bf16", "window_attn_bwd_long_bf16",
                     "window_attn_fwd_long_masked_bf16",
                     "window_attn_bwd_long_masked_bf16"):
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

    print("registers of the moved forms (parent -> change):", flush=True)
    form_regs = {}
    for form, (old, new) in MOVED_KERNELS.items():
        pick = lambda keys, tag: {  # noqa: E731
            k: r[tag] for k, r in regs.items() if tag in r and any(
                k.startswith(src + " ") and name in k and arg in k
                for src, name, arg in keys)}
        form_regs[form] = dict(parent=pick(old, "parent"),
                               change=pick(new, "change"))
        print(f"  {form}: {sorted(form_regs[form]['parent'].values())} -> "
              f"{sorted(form_regs[form]['change'].values())}", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(31)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(dev)  # noqa: E731
    bf16 = torch.bfloat16
    mask9 = swin_attn_mask(48, 48, 16, 8, dev)
    # (forward and backward form, case, windows, Tq, Tk, C, heads, bias,
    # mask)
    cases = [(("W-long-bf16", "WB-long-bf16"), "Ultra 256x256", 128, 256,
              256, 192, 6, False, None),
             (("W-long-bf16", "WB-long-bf16"), "Ultra 256x576", 128, 256,
              576, 192, 6, False, None),
             (("WM-long-bf16", "WMB-long-bf16"), "paper HAT 256x256, period "
              "9", 144, 256, 256, 180, 6, True, mask9)]
    rows = []
    for forms, case, b, tq, tk, c, nh, has_bias, mask in cases:
        q, g = rnd(b, tq, c).to(bf16), rnd(b, tq, c).to(bf16)
        k, v = rnd(b, tk, c).to(bf16), rnd(b, tk, c).to(bf16)
        bias = 0.5 * rnd(nh, tq, tk) if has_bias else None
        scale = (c // nh) ** -0.5
        nw = 0 if mask is None else mask.shape[0]
        full = None if bias is None else (
            bias[None] + mask.repeat(b // nw, 1, 1)[:, None]).to(bf16)
        lib_f, lib_b, _ = cs._sdpa_ms(q, k, v, full, g, nh, scale)
        extra = 4 * nh * tq * tk * (0 if bias is None else 1) + (
            0 if mask is None else 4 * nw * tq * tk)
        for kind in ("fwd", "bwd"):
            name = (f"window_attn_{kind}_long"
                    f"{'' if mask is None else '_masked'}_bf16")
            label = forms[kind == "bwd"]
            outs = {}

            def run(tag):
                if kind == "fwd":
                    out = torch.empty_like(q)
                    args = [q, k, v, bias] + ([] if mask is None else [mask])
                    call(tag, name, *args, out, b, tq, tk, c, nh,
                         *([] if mask is None else [nw]), scale)
                    outs[tag] = (out,)
                    return
                dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
                stats = torch.empty(b, nh, tq, 3, device=dev)
                ds_w = (torch.empty(b, nh, tq, tk, device=dev)
                        if bias is not None else None)
                dbias = (torch.empty(nh, tq, tk, device=dev)
                         if bias is not None else None)
                args = [q, k, v, bias] + ([] if mask is None else [mask])
                call(tag, name, *args, g, dq, dk, dv, stats, ds_w, dbias, b,
                     tq, tk, c, nh, *([] if mask is None else [nw]), scale)
                outs[tag] = (dq, dk, dv)

            ms = {"parent": [], "change": []}
            for tag in ("parent", "change", "change", "parent", "parent",
                        "change"):
                ms[tag].append(cs._time_ms(lambda: run(tag), 10))
            if kind == "fwd":
                refs = (ta.window_attention_packed_plain(
                    q, k, v, bias, scale, nh,
                    None if mask is None else mask),)
                flops = 4.0 * b * nh * tq * tk * (c // nh)
                nbytes = 2 * (2 * b * tq * c + 2 * b * tk * c) + extra
            else:
                refs = ta.window_attention_packed_bwd_plain(
                    q, k, v, bias, g, scale, nh,
                    None if mask is None else mask)[:3]
                flops = 10.0 * b * nh * tq * tk * (c // nh)
                nbytes = 2 * (3 * b * tq * c + 4 * b * tk * c) + 2 * extra
            bound, by = cs._bound_ms(flops, nbytes, cs.PEAK_BF16)
            errs = {tag: max(cs._compare_bf16(o, r, f"{label} {case} "
                                              f"{tag}")
                             for o, r in zip(outs[tag], refs))
                    for tag in outs}
            between = max(float((a.float() - o.float()).abs().max())
                          for a, o in zip(outs["parent"], outs["change"]))
            med = {tag: sorted(v)[1] for tag, v in ms.items()}
            rows.append(dict(form=label, case=case, windows=b, ms=ms,
                             speedup=med["parent"] / med["change"],
                             bound_ms=bound, bound_by=by,
                             library_ms=lib_f if kind == "fwd" else lib_b,
                             max_abs_err=errs, max_between_builds=between))
            print(f"  {label} {case}: parent {ms['parent']} ms, change "
                  f"{ms['change']} ms, {rows[-1]['speedup']:.2f}x (bound "
                  f"{bound:.4f} by {by}, SDPA {rows[-1]['library_ms']}); "
                  f"builds differ by at most {between:.3e}", flush=True)
    return dict(rows=rows, registers=form_regs)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="directory holding the parent's gsasr_torch/ops/csrc")
    ap.add_argument("--json", help="write the results to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ab_torch_sources: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gsasr_torch.ops import _build
    from gsasr_torch.ops import rasterizer as rz

    out_dir = os.path.join(ROOT, "build", "ab_sources")
    os.makedirs(out_dir, exist_ok=True)
    dirs = {"parent": os.path.join(args.parent, "gsasr_torch", "ops", "csrc"),
            "change": str(_build.SRC_DIR)}
    jobs = [(tag, src, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
         os.path.join(out_dir, f"{tag}_{src}.so"),
         os.path.join(d, f"{src}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
        for tag, d in dirs.items() for src in SOURCES]
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
        mark = "" if r.get("parent") == r.get("change") else "  (differs)"
        print(f"  {key[:120]}: {r.get('parent')} -> {r.get('change')}{mark}",
              flush=True)

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
        for tag in ("parent", "change", "change", "parent", "parent",
                    "change"):
            ms[tag].append(cs._time_ms(lambda: run(tag), 20))
        same = torch.equal(outs["parent"], outs["change"])
        times[kind] = dict(ms, same_bits=same)
        print(f"  R {kind}: parent {ms['parent']} ms, change "
              f"{ms['change']} ms; the same bits: {same}", flush=True)
        if not same:
            raise AssertionError(f"R {kind}: the two builds differ")
    attn = _attention_ab(cs, out_dir, regs)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, registers=regs, r_ms=times,
                           attention=attn), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
