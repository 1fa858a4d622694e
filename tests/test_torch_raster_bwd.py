"""gsasr_torch rasterizer backward against gsasr_tpu on the CPU: the slot
and offset options of pack_geometry, gradients of gs_render_px and
gs_render against jax.grad of the JAX functions (whose custom VJP runs the
Pallas backward in interpret mode: the dense K4, and the windowed K5 where
its static conditions hold and no chunk overflows the window), and the
plain version of kernel RB against torch.autograd of the plain forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_tpu.ops import rasterizer as jr
from gsasr_torch.ops import rasterizer as tr


def _px_geometry(rng, s, h, w, half_max):
    """Pixel-unit Gaussians with inclusive boxes of half-size <= half_max,
    some partly off the canvas."""
    geom = np.zeros((s, 16), np.float32)
    geom[:, 0:2] = rng.uniform(0.5, 3.0, (s, 2))
    geom[:, 2] = rng.uniform(-0.9, 0.9, s)
    geom[:, 3] = rng.uniform(-3, w + 3, s)
    geom[:, 4] = rng.uniform(-3, h + 3, s)
    half = rng.uniform(1, half_max, (s, 2)).astype(np.float32)
    geom[:, 5], geom[:, 6] = geom[:, 3] - half[:, 0], geom[:, 3] + half[:, 0]
    geom[:, 7], geom[:, 8] = geom[:, 4] - half[:, 1], geom[:, 4] + half[:, 1]
    return geom, rng.random((s, 3), dtype=np.float32)


def _assert_grads_close(out, ref, name):
    """|d| <= 1e-4 max|ref| of the column + 1e-4 |ref|: the moment sums over
    many pixels cancel, so a column's error scales with its largest
    entry."""
    tol = 1e-4 * np.abs(ref).max(axis=0, keepdims=True) + 1e-4 * np.abs(ref)
    err = np.abs(out - ref)
    assert (err <= tol).all(), (name, float(err.max()))


def test_pack_geometry_offset_and_slots_match(rng):
    s = 300
    sig = 0.999 * rng.random((s, 3), dtype=np.float32)
    sig[:, :2] = 0.2 * sig[:, :2] + 1e-3
    sig[:, 2] = 2 * sig[:, 2] - 0.999
    co = (1.3 * (2 * rng.random((s, 2)) - 1)).astype(np.float32)
    hw = (37.0, 53.0)
    kw = dict(y_offset=74.0, y_slot=(74.0, 74.0 + 30.0), x_slot=(0.0, 45.0))
    ref = np.asarray(jr.pack_geometry(jnp.asarray(sig), jnp.asarray(co), hw,
                                      0.3, **kw))
    out = tr.pack_geometry(torch.from_numpy(sig), torch.from_numpy(co), hw,
                           0.3, **kw).numpy()
    # 1e-6 relative: the same float32 formulas
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    # per-Gaussian sizes and slots broadcast like scalars
    n = torch.full((s,), 1.0)
    out2 = tr.pack_geometry(torch.from_numpy(sig), torch.from_numpy(co),
                            (n * hw[0], n * hw[1]), n * 0.3,
                            y_offset=n * 74.0, y_slot=(n * 74.0, n * 104.0),
                            x_slot=(0.0, n * 45.0)).numpy()
    np.testing.assert_array_equal(out2, out)


def _jax_vs_port_px(geom, colors, hw, weight, max_box_px=None):
    def jloss(g, c):
        return jnp.sum(weight * jr.gs_render_px(g, c, hw,
                                                max_box_px=max_box_px))

    jg, jc = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(geom),
                                             jnp.asarray(colors))
    g = torch.from_numpy(geom).requires_grad_()
    c = torch.from_numpy(colors).requires_grad_()
    (torch.from_numpy(weight) * tr.gs_render_px(g, c, hw)).sum().backward()
    return (g.grad.numpy(), np.asarray(jg)), (c.grad.numpy(), np.asarray(jc))


def test_gs_render_px_grads_match_jax_dense(rng):
    """No max_box_px: the JAX backward takes the dense walk (K4)."""
    h, w = 40, 70
    geom, colors = _px_geometry(rng, 600, h, w, 12)
    weight = rng.random((h, w, 3), dtype=np.float32)
    (dg, jdg), (dc, jdc) = _jax_vs_port_px(geom, colors, (h, w), weight)
    _assert_grads_close(dg, jdg, "dgeom")
    _assert_grads_close(dc, jdc, "dcol")
    assert np.all(dg[:, 5:] == 0) and np.all(jdg[:, 5:] == 0)


def test_gs_render_px_grads_match_jax_windowed(rng):
    """max_box_px set, 8 backward chunks of 512 and a window of at most
    half the backward tiles: the JAX backward walks tile rectangles (K5).
    Guarded against its runtime fallback to the dense walk."""
    h, w, s, mb = 256, 128, 3100, (17, 9)
    geom, colors = _px_geometry(rng, s, h, w, 4)
    # gs_render_px's own sizing of the window and of the padded chunks
    nth, ntw = -(-h // jr._DEF_TH_BWD), -(-w // jr._DEF_TW)
    rows = min(nth, 3 * -(-mb[0] // jr._DEF_TH_BWD) + 6)
    cols = min(ntw, 3 * -(-mb[1] // jr._DEF_TW) + 4)
    window = rows * cols
    sp = -(-s // jr._DEF_GC) * jr._DEF_GC
    assert sp // jr._DEF_GC_BWD >= 8 and window <= nth * ntw // 2
    key = (np.clip(geom[:, 4], 0, h - 1).astype(np.int32) // jr._DEF_TH
           * ntw + np.clip(geom[:, 3], 0, w - 1).astype(np.int32)
           // jr._DEF_TW)
    g_sorted = geom[np.argsort(key, kind="stable")]
    pad = np.zeros((sp - s, 16), np.float32)
    pad[:, [5, 7]], pad[:, [6, 8]] = 1e9, -1e9
    bbox = jr._chunk_bboxes(jnp.asarray(np.concatenate([g_sorted, pad])).T,
                            jr._DEF_GC_BWD)
    rect = jr._chunk_tile_rects(bbox, h=h, w=w, th=jr._DEF_TH_BWD,
                                tw=jr._DEF_TW, n_th=nth, n_tw=ntw)
    assert int(np.asarray(rect[3]).max()) <= window, "window overflow"

    weight = rng.random((h, w, 3), dtype=np.float32)
    (dg, jdg), (dc, jdc) = _jax_vs_port_px(geom, colors, (h, w), weight,
                                           max_box_px=mb)
    _assert_grads_close(dg, jdg, "dgeom")
    _assert_grads_close(dc, jdc, "dcol")
    assert np.all(dg[:, 5:] == 0)


def test_gs_render_grads_match_jax(rng):
    """Normalized-unit entry: the 14.5-sigma box tightening carries no
    gradient on either side (sigma reaches the loss only through columns
    0-1 of the geometry)."""
    s, size, dmax = 500, (30, 41), 0.4
    sig = 0.999 * rng.random((s, 3), dtype=np.float32)
    sig[:, :2] = 0.05 * sig[:, :2] + 1e-3
    sig[:, 2] = 2 * sig[:, 2] - 0.999
    co = (1.2 * (2 * rng.random((s, 2)) - 1)).astype(np.float32)
    col = rng.random((s, 3), dtype=np.float32)
    weight = rng.random((*size, 3), dtype=np.float32)

    def jloss(a, b, c):
        return jnp.sum(weight * jr.gs_render(a, b, c, size, dmax))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (sig, co, col)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (sig, co, col)]
    (torch.from_numpy(weight) * tr.gs_render(*ts, size, dmax)).sum() \
        .backward()
    for t, jg, name in zip(ts, jgrads, ("sigmas", "coords", "colors")):
        _assert_grads_close(t.grad.numpy(), np.asarray(jg), name)


@pytest.mark.parametrize("s,hw", [(700, (33, 47)), (300, (20, 90))])
def test_raster_bwd_plain_matches_autograd(rng, s, hw):
    """The analytic moments equal autograd of the plain forward, in
    float64; the cull-box and pad columns get exactly zero."""
    h, w = hw
    geom, colors = _px_geometry(rng, s, h, w, 10)
    g, c, bbox = tr.chunk_geometry(torch.from_numpy(geom),
                                   torch.from_numpy(colors), hw)
    g = g.double().requires_grad_()
    c = c.double().requires_grad_()
    cot = torch.from_numpy(rng.standard_normal((h, w, 3)))
    out = tr.raster_fwd_plain(g, c, bbox.double(), h, w)
    rg, rc = torch.autograd.grad(out, (g, c), cot)
    dg, dc = tr.raster_bwd_plain(g.detach(), c.detach(), bbox.double(), cot,
                                 h, w)
    np.testing.assert_allclose(dg[:, :5].numpy(), rg[:, :5].numpy(),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(dc.numpy(), rc.numpy(), rtol=1e-12,
                               atol=1e-12)
    assert torch.all(dg[:, 5:] == 0)


def test_chunk_boxes_carry_no_gradient(rng):
    """The chunk-box unions are computed from detached geometry and the
    raster Function returns no gradient for them."""
    geom, colors = _px_geometry(rng, 300, 20, 30, 6)
    g = torch.from_numpy(geom).requires_grad_()
    _, _, bbox = tr.chunk_geometry(g, torch.from_numpy(colors), (20, 30))
    assert not bbox.requires_grad
