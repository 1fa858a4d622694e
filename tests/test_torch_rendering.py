"""gsasr_torch rendering orchestration against gsasr_tpu on the CPU:
activations, kernel units, dmax, the static lattice permutation and
render_gaussians with the same static_perm and lat_hw."""

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
