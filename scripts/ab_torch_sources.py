#!/usr/bin/env python3
"""Compare the port's CUDA sources of a parent checkout with this tree's on
one card: ptxas's registers of every kernel of the named sources, and kernel
R's time from both builds in turns (parent, change, change, parent, ...).

  python3 scripts/ab_torch_sources.py --parent DIR [--json PATH]

DIR holds the parent's `gsasr_torch/ops/csrc` (for example
`git archive <parent> gsasr_torch/ops/csrc | tar -x -C DIR`). Both builds
use `gsasr_torch/ops/_build.py`'s flags and go to build/ab_sources/. R runs
on chip_smoke.py's exact-render workloads (scripts/bench_exact_render.py's
720x720 render of 518,400 Gaussians, trained-like and init-like boxes),
chunked as `gs_render` chunks them for R, and both builds must give the
same bits.
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
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(card=card, registers=regs, r_ms=times), f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
