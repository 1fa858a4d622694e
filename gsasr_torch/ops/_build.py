"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles on first use into its own shared library
with a plain C interface (nvcc, sm_90a), written to
`build/gsasr_torch_kernels/` at the root of the checkout and keyed by a hash
of the sources and flags, then loaded with ctypes. Each library exports an
entry point of the same name and, where `SOURCES` says so, others (the
masked and bfloat16 forms of W and WB, the window-16 forms of W, WB, WM,
WMB, A and AB, the bfloat16 forms of MB and AB, the head-major (4D) forms
of W and WB, and R-exact beside R live in the same sources).
Each entry point's C signature is declared in `SIGNATURES`: it takes its
pointers and the CUDA stream as `void*` and returns `cudaGetLastError()`
after its launches; `launch` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gsasr_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Argument kinds of each entry point before its trailing stream:
# p = device pointer (a tensor, or None for null), i = int, f = float.
SIGNATURES = {
    "raster_fwd": "ppppiiii",
    "raster_fwd_exact": "pppppiiii",
    "ln_mlp": "p" * 10 + "iiiiii",
    "ln_attn": "p" * 20 + "iiiiii" + "f",
    "window_attn_fwd": "pppppiiiiif",
    "window_attn_bwd": "p" * 11 + "iiiii" + "f",
    "window_attn_fwd_masked": "ppppppiiiiiif",
    "window_attn_bwd_masked": "p" * 12 + "iiiiii" + "f",
    "window_attn_fwd_bf16": "pppppiiiiif",
    "window_attn_bwd_bf16": "ppppppppppiiiiif",
    "window_attn_fwd_long": "pppppiiiiif",
    "window_attn_fwd_long_bf16": "pppppiiiiif",
    "window_attn_bwd_long": "p" * 11 + "iiiii" + "f",
    "window_attn_bwd_long_bf16": "p" * 11 + "iiiii" + "f",
    "window_attn_fwd_masked_bf16": "ppppppiiiiiif",
    "window_attn_bwd_masked_bf16": "p" * 11 + "iiiiiif",
    "window_attn_fwd_long_masked": "ppppppiiiiiif",
    "window_attn_fwd_long_masked_bf16": "ppppppiiiiiif",
    "window_attn_bwd_long_masked": "p" * 12 + "iiiiii" + "f",
    "window_attn_bwd_long_masked_bf16": "p" * 12 + "iiiiii" + "f",
    "ln_attn_long": "p" * 23 + "iiiiii" + "f",
    "raster_bwd": "ppppppiiii",
    "ln_mlp_bwd": "p" * 16 + "iiiiii",
    "ln_mlp_bwd_bf16": "p" * 16 + "iiiiii",
    "ln_attn_bwd": "p" * 36 + "iiiiii" + "f",
    "ln_attn_bwd_bf16": "p" * 36 + "iiiiii" + "f",
    "ln_attn_bwd_long": "p" * 36 + "iiiiii" + "f",
    "ln_attn_bwd_long_bf16": "p" * 36 + "iiiiii" + "f",
    "bias_table_bwd": "pppiiii",
    "window_attn_fwd_4d": "pppppiiiiif",
    "window_attn_fwd_4d_bf16": "pppppiiiiif",
    "window_attn_bwd_4d": "p" * 11 + "iiiii" + "f",
    "window_attn_bwd_4d_bf16": "p" * 11 + "iiiii" + "f",
}
# Entry points compiled from another entry point's source.
SOURCES = {"raster_fwd_exact": "raster_fwd",
           "window_attn_fwd_masked": "window_attn_fwd",
           "window_attn_bwd_masked": "window_attn_bwd",
           "window_attn_fwd_bf16": "window_attn_fwd",
           "window_attn_bwd_bf16": "window_attn_bwd",
           "window_attn_fwd_long": "window_attn_fwd",
           "window_attn_fwd_long_bf16": "window_attn_fwd",
           "window_attn_bwd_long": "window_attn_bwd",
           "window_attn_bwd_long_bf16": "window_attn_bwd",
           "window_attn_fwd_masked_bf16": "window_attn_fwd",
           "window_attn_bwd_masked_bf16": "window_attn_bwd",
           "window_attn_fwd_long_masked": "window_attn_fwd",
           "window_attn_fwd_long_masked_bf16": "window_attn_fwd",
           "window_attn_bwd_long_masked": "window_attn_bwd",
           "window_attn_bwd_long_masked_bf16": "window_attn_bwd",
           "ln_attn_long": "ln_attn",
           "ln_mlp_bwd_bf16": "ln_mlp_bwd",
           "ln_attn_bwd_bf16": "ln_attn_bwd",
           "ln_attn_bwd_long": "ln_attn_bwd",
           "ln_attn_bwd_long_bf16": "ln_attn_bwd",
           "window_attn_fwd_4d": "window_attn_fwd",
           "window_attn_fwd_4d_bf16": "window_attn_fwd",
           "window_attn_bwd_4d": "window_attn_bwd",
           "window_attn_bwd_4d_bf16": "window_attn_bwd"}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}

_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def source_of(name: str) -> str:
    """The `csrc/<source>.cu` whose library exports entry point `name`."""
    return SOURCES.get(name, name)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((SRC_DIR / f"{name}.cu").read_bytes())
    for hdr in sorted(SRC_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library is already built.
    Returns (path, None or (process, tmp library, tmp log)). Each process
    writes its own tmp files, so builds of one source in two processes do
    not mix their output."""
    path = _lib_path(name)
    if path.exists():
        return path, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    tmp_log = tmp.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    fh = open(tmp_log, "w")
    try:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    finally:
        fh.close()
    return path, (proc, tmp, tmp_log)


def _finish(name: str, path: Path, job) -> None:
    if job is None:
        return
    proc, tmp, tmp_log = job
    if proc.wait() != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{tmp_log.read_text()}")
    os.replace(tmp_log, path.with_suffix(".log"))
    os.replace(tmp, path)


def build(names) -> None:
    """Compile the sources of the named entry points in parallel (one nvcc
    each) and load the entry points."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        srcs = list(dict.fromkeys(source_of(n) for n in todo))
        jobs = [(s, *_start(s)) for s in srcs]
        for s, path, job in jobs:
            _finish(s, path, job)
        paths = {s: path for s, path, _ in jobs}
        for n in todo:
            lib = ctypes.CDLL(str(paths[source_of(n)]))
            fn = getattr(lib, n)
            fn.argtypes = [_CTYPES[k] for k in SIGNATURES[n]] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _libs[n] = fn


def ptxas_report(name: str) -> str:
    """The compiler's register/shared-memory report of a built source (or
    of an entry point's source), or "" when its log is gone."""
    log = _lib_path(source_of(name)).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def launch(name: str, *args) -> None:
    """Call entry point `name` on the current stream with `args`, which
    follow `SIGNATURES[name]`: tensors (device pointers) or None for p, ints
    for i, floats for f."""
    sig = SIGNATURES[name]
    if len(args) != len(sig):
        raise TypeError(f"{name} takes {len(sig)} arguments, got {len(args)}")
    cargs = []
    for kind, a in zip(sig, args):
        if kind == "p" and (a is None or isinstance(a, torch.Tensor)):
            cargs.append(None if a is None else a.data_ptr())
        elif kind == "i" and isinstance(a, int) and not isinstance(a, bool):
            cargs.append(a)
        elif kind == "f" and isinstance(a, float):
            cargs.append(a)
        else:
            raise TypeError(f"{name}: argument {len(cargs)} is {type(a)}, "
                            f"expected kind '{kind}'")
    if name not in _libs:
        build([name])
    err = _libs[name](*cargs, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def check_tensor(t: torch.Tensor, name: str, dtype=torch.float32) -> None:
    """Raise on what the kernels do not take: another dtype than `dtype`
    (float32; bfloat16 for the activations of kernels M, A, MB and AB
    and the operands of the bf16 window attentions; int32 for R-exact's
    lists), a
    tensor that autograd would need a gradient for (a kernel differentiates
    only inside its autograd Function, where grad mode is off), or one off
    the card."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            f"{name} requires grad; this kernel has no backward")
    if not t.is_cuda:
        raise ValueError(f"{name} must lie on the CUDA device")
