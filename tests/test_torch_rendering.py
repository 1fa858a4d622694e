"""gsasr_torch rendering orchestration against gsasr_tpu on the CPU:
activations, kernel units, dmax, the static lattice permutation,
render_gaussians with the same static_perm and lat_hw, and the slot-stacked
training render, forward and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_tpu import rendering as jrend
from gsasr_torch import rendering as trend


def test_activations_match_jax(rng):
    p = rng.normal(size=(50, 9)).astype(np.float32)
    ref = jrend.gs_activations(jnp.asarray(p))
    out = trend.gs_activations(torch.from_numpy(p))
    # tolerances of tests/test_rendering.py's golden checks
    for r, o, rtol, atol in zip(ref, out, (1e-6, 1e-6, 1e-5, 1e-6, 1e-5),
                                (0, 0, 1e-7, 0, 0)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=rtol,
                                   atol=atol)


def test_kernel_units_match_jax(rng):
    n = 20
    sx, sy = rng.random(n, dtype=np.float32), rng.random(n, dtype=np.float32)
    rho = rng.random(n, dtype=np.float32) - 0.5
    coords = 2 * rng.random((n, 2), dtype=np.float32) - 1
    ref_s, ref_c = jrend.to_kernel_units(*map(jnp.asarray, (sx, sy, rho,
                                                            coords)),
                                         (48, 64), 0.3)
    out_s, out_c = trend.to_kernel_units(*map(torch.from_numpy, (sx, sy, rho,
                                                                 coords)),
                                         (48, 64), 0.3)
    np.testing.assert_allclose(out_s.numpy(), np.asarray(ref_s), rtol=1e-6)
    np.testing.assert_allclose(out_c.numpy(), np.asarray(ref_c), rtol=1e-5,
                               atol=1e-6)


def test_resolve_dmax():
    assert trend.resolve_dmax(25, "dynamic", (100, 200)) == 27 / 100
    assert trend.resolve_dmax(0.1, "fix", (100, 200)) == 0.1
    with pytest.raises(ValueError):
        trend.resolve_dmax(0.1, "bogus", (10, 10))


@pytest.mark.parametrize("args", [(24, 36, 48, 72), (720, 720, 720, 720),
                                  (16, 20, 51, 63), (8, 8, 8, 8, 8, 16)])
def test_static_lattice_perm_bitwise(args):
    np.testing.assert_array_equal(trend._static_lattice_perm(*args),
                                  jrend._static_lattice_perm(*args))


def test_device_lattice_perm_is_cached_per_shape():
    """The permutation reaches the device once per (shape, device) and then
    is reused, not copied anew for every image."""
    cpu = torch.device("cpu")
    a = trend._device_lattice_perm(24, 36, 48, 72, cpu)
    assert a is trend._device_lattice_perm(24, 36, 48, 72, cpu)
    np.testing.assert_array_equal(a.numpy(),
                                  jrend._static_lattice_perm(24, 36, 48, 72))


@pytest.mark.parametrize("lat,sr,static_perm,lat_hw", [
    ((24, 36), (48, 72), True, (24, 36)),   # rectangular static perm
    ((24, 36), (48, 72), True, None),       # non-square N: runtime sort
    ((24, 36), (48, 72), False, None),
    ((20, 20), (41, 37), True, None),       # square N: inferred lattice
])
def test_render_gaussians_matches_jax(rng, lat, sr, static_perm, lat_hw):
    g = (0.3 * rng.standard_normal((lat[0] * lat[1], 9))).astype(np.float32)
    ref = np.asarray(jrend.render_gaussians(
        sr, jnp.asarray(g), jnp.float32(2.0), dmax_mode="fix", dmax=0.5,
        static_perm=static_perm, lat_hw=lat_hw))
    out = trend.render_gaussians(sr, torch.from_numpy(g), 2.0,
                                 dmax_mode="fix", dmax=0.5,
                                 static_perm=static_perm, lat_hw=lat_hw,
                                 device="cpu").numpy()
    assert out.shape == (3, *sr)
    # 1e-5: the same Gaussians summed in another order
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_render_gaussians_dense_path_matches_jax(rng):
    """use_kernel=False renders with the dense reference, as use_pallas=False
    does in the JAX package."""
    g = rng.normal(size=(300, 9)).astype(np.float32)
    ref = np.asarray(jrend.render_gaussians(
        (24, 136), jnp.asarray(g), 2.0, dmax_mode="dynamic", dmax=25,
        use_pallas=False))
    out = trend.render_gaussians((24, 136), torch.from_numpy(g), 2.0,
                                 dmax_mode="dynamic", dmax=25,
                                 use_kernel=False, device="cpu").numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def _training_batch(rng, b=3, n=400, canvas=(40, 48)):
    g = (0.5 * rng.standard_normal((b, n, 9))).astype(np.float32)
    scales = np.asarray([2.0, 3.1, 4.0][:b], np.float32)
    gt_h = np.asarray([40, 31, 17][:b], np.int32)   # mixed sizes per sample
    gt_w = np.asarray([48, 23, 40][:b], np.int32)
    weight = rng.random((b, *canvas, 3), dtype=np.float32)
    return g, scales, gt_h, gt_w, weight


@pytest.mark.parametrize("dmax_mode,dmax,if_dmax", [
    ("fix", 0.5, True), ("dynamic", 25.0, True), ("fix", 0.5, False)])
def test_training_batch_geometry_matches_jax(rng, dmax_mode, dmax, if_dmax):
    g, scales, gt_h, gt_w, _ = _training_batch(rng)
    kw = dict(dmax_mode=dmax_mode, dmax=dmax, if_dmax=if_dmax)
    jg, jc, _ = jrend.training_batch_geometry(
        jnp.asarray(g), jnp.asarray(scales), jnp.asarray(gt_h),
        jnp.asarray(gt_w), (40, 48), **kw)
    tg, tc = trend.training_batch_geometry(
        torch.from_numpy(g), torch.from_numpy(scales),
        torch.from_numpy(gt_h), torch.from_numpy(gt_w), (40, 48), **kw)
    # 1e-5: the same float32 formulas, with XLA's and torch's own rounding
    # of the sigmoid and tanh
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)


def test_render_training_batch_matches_jax(rng):
    """Forward and gradients in the raw decoder outputs, with mixed
    (gt_h, gt_w) per sample; pixels beyond each sample's size stay 0."""
    g, scales, gt_h, gt_w, weight = _training_batch(rng)
    args = (jnp.asarray(scales), jnp.asarray(gt_h), jnp.asarray(gt_w))

    def jloss(p):
        out = jrend.render_training_batch(p, *args, (40, 48), dmax=0.5)
        return jnp.sum(out * weight), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(g))
    p = torch.from_numpy(g).requires_grad_()
    out = trend.render_training_batch(
        p, torch.from_numpy(scales), torch.from_numpy(gt_h),
        torch.from_numpy(gt_w), (40, 48), dmax=0.5)
    (out * torch.from_numpy(weight)).sum().backward()
    assert out.shape == (3, 40, 48, 3)
    # 1e-5: the same Gaussians summed in another order
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for i in range(3):
        assert torch.all(out[i, gt_h[i]:] == 0)
        assert torch.all(out[i, :, gt_w[i]:] == 0)
    ref = np.asarray(jgrad)
    # per-column scale: the moment sums behind each parameter cancel
    tol = 1e-4 * np.abs(ref).max(axis=(0, 1)) + 1e-4 * np.abs(ref)
    assert (np.abs(p.grad.numpy() - ref) <= tol).all(), \
        float(np.abs(p.grad.numpy() - ref).max())
