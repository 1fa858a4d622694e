"""gsasr_torch rasterizer against gsasr_tpu on the CPU: geometry packing,
the plain version of kernel R through gs_render / gs_render_px (padding,
rectangular canvases, Gaussians partly off the canvas, with and without the
spatial sort) and the dense reference renderer. The JAX side runs its
Pallas forward in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_tpu.ops import rasterizer as jr
from gsasr_tpu.ops.reference import gs_render_reference as j_reference
from gsasr_torch.ops import rasterizer as tr
from gsasr_torch.ops.reference import gs_render_reference


def _gaussians(rng, s, spread=1.0):
    """check.py-style random Gaussians; spread > 1 puts centers off the
    canvas."""
    sigmas = 0.999 * rng.random((s, 3), dtype=np.float32)
    sigmas[:, :2] = 0.2 * sigmas[:, :2] + 1e-3
    sigmas[:, 2] = 2 * sigmas[:, 2] - 0.999
    coords = (spread * (2 * rng.random((s, 2)) - 1)).astype(np.float32)
    colors = rng.random((s, 3), dtype=np.float32)
    return sigmas, coords, colors


def test_pack_geometry_matches(rng):
    sigmas, coords, _ = _gaussians(rng, 257, spread=1.3)
    for size, dmax in (((33, 129), 0.25), ((720, 720), 0.1)):
        ref = np.asarray(jr.pack_geometry(jnp.asarray(sigmas),
                                          jnp.asarray(coords), size, dmax))
        out = tr.pack_geometry(torch.from_numpy(sigmas),
                               torch.from_numpy(coords), size, dmax).numpy()
        # 1e-6 relative: the same float32 formulas
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s,size,dmax,spread,sort", [
    (700, (32, 160), 0.3, 1.0, True),    # padding: S not a multiple of 256
    (700, (32, 160), 0.3, 1.0, False),
    (300, (45, 23), 0.5, 1.3, True),     # tall canvas, centers off canvas
    (1000, (17, 300), 0.2, 1.2, False),  # wide canvas, off canvas, no sort
    (64, (16, 16), 100.0, 1.0, True),    # no dmax culling
])
def test_gs_render_matches_jax(rng, s, size, dmax, spread, sort):
    sigmas, coords, colors = _gaussians(rng, s, spread)
    ref = np.asarray(jr.gs_render(jnp.asarray(sigmas), jnp.asarray(coords),
                                  jnp.asarray(colors), size, dmax,
                                  spatial_sort=sort))
    out = tr.gs_render(torch.from_numpy(sigmas), torch.from_numpy(coords),
                       torch.from_numpy(colors), size, dmax,
                       spatial_sort=sort).numpy()
    assert out.shape == (*size, 3)
    # 1e-5: the same terms summed in another order
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_gs_render_px_matches_jax(rng):
    """Pixel-unit entry with hand-made cull boxes, some clipped by the
    canvas edge and one empty."""
    s, h, w = 600, 40, 70
    geom = np.zeros((s, 16), np.float32)
    geom[:, 0:2] = rng.uniform(0.5, 4.0, (s, 2))
    geom[:, 2] = rng.uniform(-0.9, 0.9, s)
    geom[:, 3] = rng.uniform(-5, w + 5, s)
    geom[:, 4] = rng.uniform(-5, h + 5, s)
    half = rng.uniform(1, 12, (s, 2)).astype(np.float32)
    geom[:, 5], geom[:, 6] = geom[:, 3] - half[:, 0], geom[:, 3] + half[:, 0]
    geom[:, 7], geom[:, 8] = geom[:, 4] - half[:, 1], geom[:, 4] + half[:, 1]
    geom[0, 5:9] = [10, 5, 10, 5]  # inverted: contributes nothing
    colors = rng.random((s, 3), dtype=np.float32)
    ref = np.asarray(jr.gs_render_px(jnp.asarray(geom), jnp.asarray(colors),
                                     (h, w)))
    out = tr.gs_render_px(torch.from_numpy(geom), torch.from_numpy(colors),
                          (h, w)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_raster_fwd_plain_matches_dense_reference(rng):
    """The chunk-windowed plain version equals the port's dense oracle."""
    sigmas, coords, colors = _gaussians(rng, 513, spread=1.1)
    size, dmax = (37, 61), 0.3
    ref = gs_render_reference(torch.from_numpy(sigmas),
                              torch.from_numpy(coords),
                              torch.from_numpy(colors), size, dmax)
    out = tr.gs_render(torch.from_numpy(sigmas), torch.from_numpy(coords),
                       torch.from_numpy(colors), size, dmax)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("s,chunk", [(64, 4096), (700, 256)])
def test_reference_matches_jax(rng, s, chunk):
    sigmas, coords, colors = _gaussians(rng, s, spread=1.2)
    size, dmax = (19, 27), 0.4
    ref = np.asarray(j_reference(jnp.asarray(sigmas), jnp.asarray(coords),
                                 jnp.asarray(colors), size, dmax,
                                 chunk=chunk))
    out = gs_render_reference(torch.from_numpy(sigmas),
                              torch.from_numpy(coords),
                              torch.from_numpy(colors), size, dmax,
                              chunk=chunk).numpy()
    # 1e-5: einsum over the Gaussians in another order
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_padding_rows_are_inverted_and_chunks_union(rng, monkeypatch):
    """gs_render_px pads to whole chunks with inverted boxes, which leave
    the chunk unions of real Gaussians untouched."""
    sigmas, coords, colors = _gaussians(rng, 300)
    geom = tr.pack_geometry(torch.from_numpy(sigmas), torch.from_numpy(coords),
                            (30, 40), 0.3)
    seen = {}

    def spy(g, c, bbox, h, w):
        seen.update(g=g, bbox=bbox)
        return tr.raster_fwd_plain(g, c, bbox, h, w)

    monkeypatch.setattr(tr, "raster_fwd", spy)
    tr.gs_render_px(geom, torch.from_numpy(colors), (30, 40),
                    spatial_sort=False)
    g, bbox = seen["g"], seen["bbox"]
    assert g.shape[0] == 512 and bbox.shape == (4, 2)
    assert torch.all(g[300:, 5] > g[300:, 6])
    assert bbox[0, 1] == geom[256:, 5].min() and bbox[1, 1] == geom[256:, 6].max()
