"""The port's NIQE (`gsasr_torch/metrics_niqe.py`, with its own copy of the
pristine parameters) against the reference value and against the JAX
package's, and `metrics.calculate_metric`'s routes to NIQE, LPIPS and
DISTS."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import gsasr_torch.metrics_niqe as niqe
from gsasr_torch.metrics import calculate_metric

ROOT = Path(__file__).resolve().parents[1]


def _test_image():
    """tests/test_niqe.py's image."""
    rng = np.random.default_rng(42)
    img = (rng.random((128, 128, 3)) * 255).astype(np.float64)
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(img, (2, 2, 0)).astype(np.float32)


def test_niqe_bundled_golden(monkeypatch):
    """From the port's own asset (the override path removed): the value
    the reference implementation gives on this image, 8.445464."""
    monkeypatch.setattr(niqe, "_PARAMS_PATHS", [niqe._PARAMS_PATHS[1]])
    assert Path(niqe._PARAMS_PATHS[0]) == (
        ROOT / "gsasr_torch" / "assets" / "niqe_pris_params.npz")
    val = niqe.calculate_niqe(_test_image(), crop_border=0)
    assert abs(val - 8.4455) < 5e-3
    monkeypatch.setattr(niqe, "_PARAMS_PATHS", ["", "/nonexistent.npz"])
    with pytest.raises(FileNotFoundError, match="GSASR_NIQE_PARAMS"):
        niqe.calculate_niqe(_test_image())


def test_niqe_params_override(monkeypatch, tmp_path):
    """GSASR_NIQE_PARAMS, read when the module is imported, comes before
    the bundled asset."""
    import importlib

    d = dict(np.load(niqe._PARAMS_PATHS[-1]))
    d["mu_pris_param"] = d["mu_pris_param"] + 1.0
    np.savez(tmp_path / "p.npz", **d)
    monkeypatch.setenv("GSASR_NIQE_PARAMS", str(tmp_path / "p.npz"))
    try:
        importlib.reload(niqe)
        moved = niqe.calculate_niqe(_test_image())
    finally:
        monkeypatch.delenv("GSASR_NIQE_PARAMS")
        importlib.reload(niqe)
    assert niqe._PARAMS_PATHS[0] == ""
    assert abs(moved - niqe.calculate_niqe(_test_image())) > 0.1


@pytest.mark.parametrize("kw", [dict(crop_border=0),
                                dict(crop_border=5, channel_order="rgb"),
                                dict(crop_border=0, convert_to="gray")],
                         ids=["y-bgr", "y-rgb-crop", "first-channel"])
def test_niqe_equals_jax(kw):
    """The same numpy on the same image: the same float, bit for bit (a
    larger image of 2 x 2 blocks, and each channel path)."""
    from gsasr_tpu.metrics_niqe import calculate_niqe as jniqe

    img = np.concatenate([_test_image(), _test_image()[::-1]], axis=0)
    img = np.concatenate([img, img[:, ::-1]], axis=1)[:200, :210]
    assert niqe.calculate_niqe(img, **kw) == jniqe(img, **kw)


def test_calculate_metric_routes():
    """calculate_niqe, calculate_lpips and calculate_dists resolve through
    calculate_metric as JAX's do, the extra options passed on (the
    networks loaded on the CPU from official-layout files)."""
    from gsasr_torch import metrics_perceptual as mp

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rng = np.random.default_rng(17)
    a = rng.random((112, 108, 3)) * 255
    b = rng.random((112, 108, 3)) * 255
    data = dict(img=a, img2=b)
    assert calculate_metric(data, dict(
        type="calculate_niqe", crop_border=4, channel_order="rgb")) == \
        niqe.calculate_niqe(a, 4, channel_order="rgb")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        lp = mp.load_lpips(cs.lpips_official_state_dict("alex", 18),
                           device="cpu")
        assert calculate_metric(data, dict(
            type="calculate_lpips", crop_border=4, params=lp,
            channel_order="rgb")) == mp.calculate_lpips(a, b, 4, lp)
        ds = mp.load_dists(cs.dists_official_state_dict(19), device="cpu")
        assert calculate_metric(data, dict(
            type="calculate_dists", crop_border=4,
            params=ds)) == mp.calculate_dists(a, b, 4, ds)
    finally:
        torch.set_num_threads(n)
    with pytest.raises(ValueError, match="unknown metric"):
        calculate_metric(data, dict(type="calculate_fid"))
