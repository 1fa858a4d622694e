"""The designs of kernels R and RB (`gsasr_torch/ops/csrc/raster_fwd.cu`,
`raster_bwd.cu`) emulated in torch on the CPU, where the kernels cannot
run, on small canvases that carry their edge cases: a ragged last tile row
and column, boxes across the canvas edge, `_pad`'s inverted rows, a chunk
that misses everything, the slot clamps of `training_batch_geometry`,
saturated boxes and boxes of one pixel.

R: the chunk walk in ascending order, each engaged chunk's Gaussians culled
against the 16 x 16 tile (clipped to the canvas) and compacted in ascending
order into staging lists of at most 512, each warp's 8 x 8 sub-rectangle
(two pixels a lane) culling a list 32 boxes at a time, and each pixel adding
the survivors whose inclusive box holds it, in order. No (pixel, Gaussian)
pair inside a box may be culled; the image matches `raster_fwd_plain` and
JAX's `gs_render_px` (Pallas in interpret mode) within 1e-5, the tolerance
of tests/test_torch_rasterizer.py.

RB: one warp per Gaussian, lane j dealt pixels j, j + 32, ... of the box
clipped to the canvas by the kernel's division-free stepping (which must
visit every pixel of the box once), eight partial sums per lane in order,
then the xor shuffle tree (the kernel's exp is the SFU's ex2, torch.exp
here). The gradients match `raster_bwd_plain` and
`jax.grad` of JAX's render within the tolerance of
tests/test_torch_raster_bwd.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsasr_tpu.ops import rasterizer as jr
from gsasr_torch.ops import rasterizer as tr
from raster_cases import CASES, edge_case

# raster_fwd.cu's kTileW, kTileH, kRectW, kRectH, kRectCols, kRWarps, kPix,
# kLaneRows, kStageCap
TILE_W, TILE_H, RECT_W, RECT_H, RECT_COLS, WARPS = 16, 16, 8, 8, 2, 4
PIX, LANE_ROWS, CAP = 2, 4, 512
LANES = 32


@pytest.fixture(autouse=True)
def _one_thread():
    """Torch on one intra-op thread: the tier-1 run's workers share the
    cores, and these many small ops spin on a pool of their own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kernel_values(g, fx, fy):
    """The kernel value of Gaussians g (..., 16) at pixels (fx, fy), with
    R's arithmetic (no box mask)."""
    inv_sx, inv_sy, w1, w2, w3, w4 = tr._coeffs(g)
    c2 = 2.0 * g[..., 2] * w3
    dx = fx - g[..., 3]
    dy = fy - g[..., 4]
    return torch.exp(w1 * (w2 * (dx * dx) - c2 * (dx * dy) + w4 * (dy * dy)))


def _in_box(g, fx, fy):
    return ((fx >= g[..., 5]) & (fx <= g[..., 6]) & (fy >= g[..., 7])
            & (fy <= g[..., 8]))


def emulate_r(geom, colors, bbox, h, w):
    """Kernel R's walk: returns (image (h, w, 3), visited (h * w, S) bool:
    the (pixel, Gaussian) pairs that reach the pixel's box test and pass
    it)."""
    s, kc = geom.shape[0], bbox.shape[1]
    gc = s // kc
    out = torch.zeros(h, w, 3)
    visited = torch.zeros(h * w, s, dtype=torch.bool)
    # lane l's PIX pixels: column l % 8, rows l // 8 + 4 p
    slot = torch.arange(LANES * PIX)
    lane, p = slot % LANES, slot // LANES
    for y0 in range(0, h, TILE_H):
        for x0 in range(0, w, TILE_W):
            tx1, ty1 = min(x0 + TILE_W, w) - 1, min(y0 + TILE_H, h) - 1
            chunks = [k for k in range(kc) if bbox[0, k] <= tx1
                      and bbox[1, k] >= x0 and bbox[2, k] <= ty1
                      and bbox[3, k] >= y0]
            lists, cur = [], torch.zeros(0, dtype=torch.long)
            for k in chunks:
                rows = torch.arange(k * gc, (k + 1) * gc)
                b = geom[rows]
                hit = rows[(b[:, 5] <= tx1) & (b[:, 6] >= x0)
                           & (b[:, 7] <= ty1) & (b[:, 8] >= y0)]
                if cur.numel() + hit.numel() > CAP:
                    lists.append(cur)
                    cur = torch.zeros(0, dtype=torch.long)
                cur = torch.cat([cur, hit])
            if cur.numel():
                lists.append(cur)
            staged = torch.cat(lists) if lists else cur
            assert bool((staged[1:] > staged[:-1]).all()), "not ascending"
            for warp in range(WARPS):
                rx = x0 + (warp % RECT_COLS) * RECT_W
                ry = y0 + (warp // RECT_COLS) * RECT_H
                if rx >= w or ry >= h:
                    continue
                rx1, ry1 = min(rx + RECT_W, w) - 1, min(ry + RECT_H, h) - 1
                px = rx + lane % RECT_W
                py = ry + lane // RECT_W + LANE_ROWS * p
                fx, fy = px.float()[:, None], py.float()[:, None]
                acc = torch.zeros(LANES * PIX, 3)
                for ids in lists:
                    b = geom[ids]
                    sel = ids[(b[:, 5] <= rx1) & (b[:, 6] >= rx) & (b[:, 7]
                              <= ry1) & (b[:, 8] >= ry)]
                    if not sel.numel():
                        continue
                    g = geom[sel]
                    inside = _in_box(g, fx, fy)          # (64, n)
                    v = _kernel_values(g, fx, fy)
                    terms = torch.where(inside[..., None],
                                        v[..., None] * colors[sel], 0.0)
                    # each pixel's sum in list order, one add at a time
                    acc = torch.cumsum(torch.cat([acc[:, None], terms], 1),
                                       dim=1)[:, -1]
                    ok = (px < w) & (py < h)
                    pix = (py * w + px)[ok]
                    visited[pix[:, None], sel[None]] |= inside[ok]
                ok = (px < w) & (py < h)
                out[py[ok], px[ok]] = acc[ok]
    return out, visited


@pytest.mark.parametrize("name", CASES)
def test_r_design_culls_nothing_and_matches(rng, name):
    geom_np, col_np, (h, w), sort = edge_case(name, rng)
    geom, colors, bbox = tr.chunk_geometry(
        torch.from_numpy(geom_np), torch.from_numpy(col_np), (h, w),
        spatial_sort=sort)
    out, visited = emulate_r(geom, colors, bbox, h, w)
    ys, xs = torch.meshgrid(torch.arange(h).float(), torch.arange(w).float(),
                            indexing="ij")
    mask = _in_box(geom[None], xs.reshape(-1, 1), ys.reshape(-1, 1))
    assert int(mask.sum()) > 0
    # every pair inside a box reaches its pixel's add, and nothing else
    assert torch.equal(visited, mask)
    # 1e-5: the same terms summed in another order
    ref = tr.raster_fwd_plain(geom, colors, bbox, h, w)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    jref = np.asarray(jr.gs_render_px(jnp.asarray(geom_np),
                                      jnp.asarray(col_np), (h, w),
                                      spatial_sort=sort))
    np.testing.assert_allclose(out.numpy(), jref, rtol=1e-5, atol=1e-5)


def _lane_pixels(x0, x1, y0, y1):
    """RB's dealing of each clipped box [x0, x1] x [y0, y1] (S,) to the 32
    lanes of its warp, with the kernel's float32 stepping: (fx, fy, live),
    each (T, S, 32)."""
    bw = (x1 - x0).long() + 1
    npix = bw * ((y1 - y0).long() + 1)
    q, r = LANES // bw, LANES % bw
    lane = torch.arange(LANES)
    ly = lane[None] // bw[:, None]
    fx = x0[:, None] + (lane[None] - ly * bw[:, None]).float()
    fy = y0[:, None] + ly.float()
    xs, ys, live = [], [], []
    for k0 in range(0, int(npix.max()), LANES):
        xs.append(fx)
        ys.append(fy)
        live.append(lane[None] + k0 < npix[:, None])
        fx = fx + r[:, None].float()
        fy = fy + q[:, None].float()
        wrap = fx > x1[:, None]
        fx = torch.where(wrap, fx - bw[:, None].float(), fx)
        fy = torch.where(wrap, fy + 1.0, fy)
    return torch.stack(xs), torch.stack(ys), torch.stack(live)


def emulate_rb(geom, colors, g, h, w):
    """Kernel RB's assignment and reduction order: (dgeom (S, 16), dcol (S,
    3))."""
    s = geom.shape[0]
    dgeom = torch.zeros(s, 16)
    dcol = torch.zeros(s, 3)
    xlo, xhi, ylo, yhi = geom[:, 5], geom[:, 6], geom[:, 7], geom[:, 8]
    x0 = torch.clamp(torch.ceil(xlo), min=0.0)
    x1 = torch.clamp(torch.floor(xhi), max=float(w - 1))
    y0 = torch.clamp(torch.ceil(ylo), min=0.0)
    y1 = torch.clamp(torch.floor(yhi), max=float(h - 1))
    ids = torch.nonzero((xlo <= xhi) & (ylo <= yhi) & (x0 <= x1)
                        & (y0 <= y1)).reshape(-1)
    fx, fy, on = _lane_pixels(x0[ids], x1[ids], y0[ids], y1[ids])
    # every pixel of each clipped box once, and no other
    pix = (fy.clamp(max=h - 1).long() * w + fx.clamp(max=w - 1).long())
    seen = torch.zeros(ids.numel(), h * w, dtype=torch.long)
    seen.scatter_add_(1, pix.permute(1, 0, 2).reshape(ids.numel(), -1),
                      on.permute(1, 0, 2).reshape(ids.numel(), -1).long())
    ys, xs = torch.meshgrid(torch.arange(h).float(), torch.arange(w).float(),
                            indexing="ij")
    box = ((xs.reshape(1, -1) >= x0[ids, None])
           & (xs.reshape(1, -1) <= x1[ids, None])
           & (ys.reshape(1, -1) >= y0[ids, None])
           & (ys.reshape(1, -1) <= y1[ids, None]))
    assert torch.equal(seen, box.long())
    gi = geom[ids]
    gp = torch.where(on[..., None], g.reshape(-1, 3)[pix], 0.0)  # (T, S, 32, 3)
    v = torch.where(on, _kernel_values(gi[:, None], fx, fy), 0.0)
    dx, dy = fx - gi[:, None, 3], fy - gi[:, None, 4]
    at = (gp * colors[ids][:, None]).sum(-1) * v
    terms = torch.stack([gp[..., 0] * v, gp[..., 1] * v, gp[..., 2] * v,
                         at * dx, at * dy, at * (dx * dx), at * (dy * dy),
                         at * (dx * dy)], dim=-1)          # (T, S, 32, 8)
    part = torch.cumsum(terms, dim=0)[-1]                # each lane in order
    lanes = torch.arange(LANES)
    for off in (16, 8, 4, 2, 1):
        part = part + part[:, lanes ^ off]
    d_r, d_g, d_b, s_x, s_y, s_xx, s_yy, s_xy = part[:, 0].unbind(-1)
    inv_sx, inv_sy, w1, w2, w3, w4 = tr._coeffs(gi)
    rho = gi[:, 2]
    c1, rw3 = 2.0 * w1, rho * w3
    s_q = w2 * s_xx - 2.0 * rw3 * s_xy + w4 * s_yy
    dgeom[ids, :5] = torch.stack([
        c1 * inv_sx * (rw3 * s_xy - w2 * s_xx),
        c1 * inv_sy * (rw3 * s_xy - w4 * s_yy),
        -c1 * (2.0 * w1 * rho * s_q + w3 * s_xy),
        c1 * (rw3 * s_y - w2 * s_x), c1 * (rw3 * s_x - w4 * s_y)], dim=1)
    dcol[ids] = torch.stack([d_r, d_g, d_b], dim=1)
    return dgeom, dcol


def _assert_grads_close(out, ref, name):
    """|d| <= 1e-4 max|ref| of the column + 1e-4 |ref|, as
    tests/test_torch_raster_bwd.py: moment sums over many pixels cancel."""
    out, ref = np.asarray(out), np.asarray(ref)
    tol = 1e-4 * np.abs(ref).max(axis=0, keepdims=True) + 1e-4 * np.abs(ref)
    err = np.abs(out - ref)
    assert (err <= tol).all(), (name, float(err.max()))


@pytest.mark.parametrize("name", CASES)
def test_rb_design_matches(rng, name):
    """Against the plain version on the chunked geometry, and against
    jax.grad of JAX's gs_render_px on the Gaussians as given (unsorted, so
    the chunked rows are the given ones and the pad)."""
    geom_np, col_np, (h, w), _ = edge_case(name, rng)
    s = geom_np.shape[0]
    cot = rng.standard_normal((h, w, 3)).astype(np.float32)
    geom, colors, bbox = tr.chunk_geometry(
        torch.from_numpy(geom_np), torch.from_numpy(col_np), (h, w),
        spatial_sort=False)
    g = torch.from_numpy(cot)
    dgeom, dcol = emulate_rb(geom, colors, g, h, w)
    assert torch.all(dgeom[:, 5:] == 0)
    assert torch.all(dgeom[s:] == 0) and torch.all(dcol[s:] == 0)
    rg, rc = tr.raster_bwd_plain(geom, colors, bbox, g, h, w)
    _assert_grads_close(dgeom, rg, "dgeom vs plain")
    _assert_grads_close(dcol, rc, "dcol vs plain")

    def jloss(gm, c):
        return jnp.sum(cot * jr.gs_render_px(gm, c, (h, w),
                                             spatial_sort=False))

    jg, jc = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(geom_np),
                                             jnp.asarray(col_np))
    _assert_grads_close(dgeom[:s], jg, "dgeom vs jax.grad")
    _assert_grads_close(dcol[:s], jc, "dcol vs jax.grad")
