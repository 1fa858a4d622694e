"""The ctypes binding of the port's CUDA kernels, checked without a card:
the declared signatures against the C entry points in the sources, and the
argument and tensor checks the wrappers make before any launch."""

import re

import pytest
import torch

from gsasr_torch.ops import _build

_KIND = (("void* stream", "s"), ("*", "p"), ("int ", "i"), ("float ", "f"))


def _c_signature(name):
    """Argument kinds of `extern "C" int name(...)` in csrc/name.cu."""
    src = (_build.SRC_DIR / f"{name}.cu").read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert m, f"no C entry point {name} in {name}.cu"
    kinds = []
    for param in " ".join(m.group(1).split()).split(","):
        param = param.strip() if "stream" in param else param.strip() + " "
        kinds.append(next(k for pat, k in _KIND if pat in param))
    return "".join(kinds)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_source(name):
    assert _c_signature(name) == _build.SIGNATURES[name] + "s"


def test_every_source_is_declared():
    assert sorted(p.stem for p in _build.SRC_DIR.glob("*.cu")) == \
        sorted(_build.SIGNATURES)


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
