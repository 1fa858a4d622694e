"""The ctypes binding of the port's CUDA kernels, checked without a card:
the declared signatures against the C entry points in the sources, and the
argument and tensor checks the wrappers make before any launch."""

import re
from pathlib import Path

import pytest
import torch

from gsasr_torch.ops import _build

_KIND = (("void* stream", "s"), ("*", "p"), ("int ", "i"), ("float ", "f"))


def _c_signature(name):
    """Argument kinds of `extern "C" int name(...)` in the entry point's
    source, csrc/<source_of(name)>.cu."""
    src_name = _build.source_of(name)
    src = (_build.SRC_DIR / f"{src_name}.cu").read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert m, f"no C entry point {name} in {src_name}.cu"
    kinds = []
    for param in " ".join(m.group(1).split()).split(","):
        param = param.strip() if "stream" in param else param.strip() + " "
        kinds.append(next(k for pat, k in _KIND if pat in param))
    return "".join(kinds)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_source(name):
    assert _c_signature(name) == _build.SIGNATURES[name] + "s"


def test_every_source_is_declared():
    """Each source exports its own entry point; the masked forms of W and
    WB (WM, WMB) live in W's and WB's sources."""
    assert sorted(p.stem for p in _build.SRC_DIR.glob("*.cu")) == \
        sorted({_build.source_of(n) for n in _build.SIGNATURES})
    assert {_build.source_of(n) for n in _build.SOURCES} <= \
        set(_build.SIGNATURES)
    for src in _build.SRC_DIR.glob("*.cu"):
        declared = {n for n in _build.SIGNATURES
                    if _build.source_of(n) == src.stem}
        exported = set(re.findall(r'extern "C" int (\w+)\(',
                                  src.read_text()))
        assert exported == declared, src.name


@pytest.mark.parametrize("args", [
    (None,) * 7,                                   # too few
    (None, None, None, None, 1, 2, 3, 4.0),        # float for an int
    (None, None, None, 7, 1, 2, 3, 4),             # int for a pointer
    (None, None, None, None, 1, 2, 3, True),       # bool for an int
])
def test_launch_rejects_bad_arguments(args):
    with pytest.raises(TypeError):
        _build.launch("raster_fwd", *args)


def test_check_tensor_rejects():
    with pytest.raises(TypeError):
        _build.check_tensor(torch.zeros(2, dtype=torch.float64), "t")
    with pytest.raises(NotImplementedError):
        _build.check_tensor(torch.zeros(2, requires_grad=True), "t")
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_tensor(torch.zeros(2), "t")
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA"):
            _build.check_tensor(torch.zeros(2, requires_grad=True), "t")


def test_ptxas_report_empty_without_log(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    assert _build.ptxas_report("raster_fwd") == ""


def test_build_log_lands_beside_library(monkeypatch, tmp_path):
    """The compiler writes into a log of its own process, which moves beside
    the library with it; nothing else is left in the build directory."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\necho "ptxas info : Used 7 registers"\n'
                    'while [ "$1" != "-o" ]; do shift; done\n: > "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    path, job = _build._start("raster_fwd")
    _build._finish("raster_fwd", path, job)
    assert "Used 7 registers" in _build.ptxas_report("raster_fwd")
    assert sorted(p.name for p in path.parent.iterdir()) == \
        sorted([path.name, path.with_suffix(".log").name])
    assert _build._start("raster_fwd") == (path, None)


def test_backward_wrappers_check_before_launch():
    """MB's, AB's and T's wrappers refuse inconsistent shapes and tensors
    off the card before any launch (meta tensors stand in for CUDA ones)."""
    from gsasr_torch.ops import bias_table, fused_layers

    meta = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    x = meta(2, 16, 24)
    mlp = dict(w1=meta(20, 24), b1=meta(20), w2=meta(24, 20), b2=meta(24))
    with pytest.raises(ValueError, match="inconsistent"):
        fused_layers.ln_mlp_residual_bwd(x, x, **dict(mlp, w2=meta(20, 24)))
    with pytest.raises(ValueError, match="must match"):
        fused_layers.ln_mlp_residual_bwd(x, meta(2, 16, 20), **mlp)
    with pytest.raises(ValueError, match="CUDA"):
        fused_layers.ln_mlp_residual_bwd(x, x, **mlp)
    attn = {k: meta(24, 24) if k[0] == "w" else meta(24)
            for k in ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")}
    attn.update(ln_w=meta(24), ln_b=meta(24), num_heads=4)
    with pytest.raises(ValueError, match="inconsistent"):
        fused_layers.ln_attn_proj_bwd(x, x, bias=meta(4, 16, 15), **attn)
    with pytest.raises(ValueError, match="CUDA"):
        fused_layers.ln_attn_proj_bwd(x, x, bias=meta(4, 16, 16), **attn)
    with pytest.raises(ValueError, match="CUDA"):
        bias_table.bias_table_bwd(meta(4, 16, 16),
                                  torch.zeros(9, 3, dtype=torch.int32))


def test_build_compiles_each_source_once(monkeypatch, tmp_path):
    """W and WM (and WB and WMB) come from one nvcc run of their source,
    and each entry point is loaded from that source's library."""
    import types

    started = []

    def start(src):
        started.append(src)
        return tmp_path / f"{src}.so", None

    loaded = []

    def cdll(path):
        loaded.append(path)
        return types.SimpleNamespace(
            **{n: types.SimpleNamespace() for n in _build.SIGNATURES})

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_start", start)
    monkeypatch.setattr(_build.ctypes, "CDLL", cdll)
    names = ["window_attn_fwd", "window_attn_fwd_masked",
             "window_attn_bwd_masked", "window_attn_bwd"]
    _build.build(names)
    assert started == ["window_attn_fwd", "window_attn_bwd"]
    assert [Path(p).name for p in loaded] == [
        "window_attn_fwd.so", "window_attn_fwd.so", "window_attn_bwd.so",
        "window_attn_bwd.so"]
    assert sorted(_build._libs) == sorted(names)
