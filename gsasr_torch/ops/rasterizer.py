"""Tile rasterizer for 2D Gaussian splatting, forward and analytic
backward (counterpart of `gsasr_tpu/ops/rasterizer.py`).

Gaussians are rasterized in pixel units with per-Gaussian inclusive cull
boxes, packed as (S, 16) float32 rows
  [sigma_x, sigma_y, rho, cx, cy, xlo, xhi, ylo, yhi, 0...0]
(sigma_x pairs with the x/width axis). `gs_render_px` optionally sorts the
Gaussians spatially, pads them to whole chunks with inverted (empty) cull
boxes, takes the per-chunk cull-box unions, and calls `raster_fwd`:
kernel R (`csrc/raster_fwd.cu`) on the card, `raster_fwd_plain` on the CPU.
Both walk the chunks in ascending order per pixel, so the sum is
deterministic and needs no atomics.

`gs_render_px` and `gs_render` are differentiable in the geometry and the
colors: the backward is `raster_bwd`, kernel RB (`csrc/raster_bwd.cu`) on
the card, `raster_bwd_plain` on the CPU. The gradient reaches geometry
columns 0-4 (sx, sy, rho, cx, cy) and the colors only; the cull boxes and
the zero pad (columns 5-15) get exactly zero, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from gsasr_torch.ops import _build

# geometry column indices
G_SX, G_SY, G_RHO, G_CX, G_CY, G_XLO, G_XHI, G_YLO, G_YHI = range(9)
GEOM_COLS = 16
# Far-away sentinel for padded Gaussians (their cull box is inverted).
_PAD = 1e9
# Gaussians per chunk: kernel R stages one chunk in shared memory, one
# Gaussian per thread of its 256-thread block.
_DEF_GC = 256
# Spatial-sort key tiles, as the JAX rasterizer's (32, 128) tiles.
_SORT_TH = 32
_SORT_TW = 128
# Pixels x Gaussians evaluated at once by the plain version.
_PLAIN_BLOCK = 1 << 22


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def pack_geometry(sigmas, coords, image_size, dmax, y_offset=None,
                  y_slot=None, x_slot=None):
    """Normalized-unit parameters -> (S, 16) pixel-unit packed geometry.

    The kernel value is invariant under rescaling distances and sigmas by
    (n-1)/2 per axis. The cull box is dmax (normalized) tightened to 14.5
    sigma: beyond that exp(-0.5 (dx/sigma_x)^2) underflows to f32 zero for
    any rho, so the tightening changes nothing in the output.

    image_size (h, w), dmax, y_offset and the bounds of y_slot and x_slot
    are numbers or tensors that broadcast against the S Gaussians (one value
    per Gaussian for a slot-stacked batch). y_offset shifts the rows; y_slot
    (row_lo, row_hi) and x_slot (col_lo, col_hi) clamp the inclusive cull
    box after the shift."""
    h, w = image_size[0], image_size[1]
    dev = sigmas.device
    half_w = (_f32(w, dev) - 1.0) * 0.5
    half_h = (_f32(h, dev) - 1.0) * 0.5
    sx = sigmas[:, 0] * half_w
    sy = sigmas[:, 1] * half_h
    rho = sigmas[:, 2]
    cx = (coords[:, 0] + 1.0) * half_w
    cy = (coords[:, 1] + 1.0) * half_h
    d = _f32(dmax, dev)
    dmx = torch.minimum(d * half_w, 14.5 * sx)
    dmy = torch.minimum(d * half_h, 14.5 * sy)
    xlo, xhi = cx - dmx, cx + dmx
    ylo, yhi = cy - dmy, cy + dmy
    if y_offset is not None:
        off = _f32(y_offset, dev)
        cy, ylo, yhi = cy + off, ylo + off, yhi + off
    if y_slot is not None:
        ylo = torch.maximum(ylo, _f32(y_slot[0], dev))
        yhi = torch.minimum(yhi, _f32(y_slot[1], dev))
    if x_slot is not None:
        xlo = torch.maximum(xlo, _f32(x_slot[0], dev))
        xhi = torch.minimum(xhi, _f32(x_slot[1], dev))
    cols = torch.broadcast_tensors(sx, sy, rho, cx, cy, xlo, xhi, ylo, yhi)
    zeros = torch.zeros((sigmas.shape[0], GEOM_COLS - 9), dtype=torch.float32,
                        device=dev)
    return torch.cat([torch.stack(cols, dim=1), zeros], dim=1)


def _chunk_bboxes(geom, gc: int):
    """Per-chunk cull-box unions, (4, kc): [xlo, xhi, ylo, yhi]."""
    return torch.stack([geom[:, G_XLO].reshape(-1, gc).amin(dim=1),
                        geom[:, G_XHI].reshape(-1, gc).amax(dim=1),
                        geom[:, G_YLO].reshape(-1, gc).amin(dim=1),
                        geom[:, G_YHI].reshape(-1, gc).amax(dim=1)])


def _chunk_window(box, h: int, w: int):
    """Integer pixel window [x0, x1] x [y0, y1] of a chunk-box union, clipped
    to the canvas, or None when it is empty."""
    bxlo, bxhi, bylo, byhi = box
    x0, x1 = max(math.ceil(bxlo), 0), min(math.floor(bxhi), w - 1)
    y0, y1 = max(math.ceil(bylo), 0), min(math.floor(byhi), h - 1)
    return None if x0 > x1 or y0 > y1 else (x0, x1, y0, y1)


def _coeffs(g):
    """Per-Gaussian quadratic-form coefficients of a chunk's rows:
    (inv_sx, inv_sy, w1, w2, w3, w4), w1 = -0.5/(1-rho^2), w2 = 1/sx^2,
    w3 = 1/(sx sy), w4 = 1/sy^2."""
    inv_sx = 1.0 / g[:, G_SX]
    inv_sy = 1.0 / g[:, G_SY]
    rho = g[:, G_RHO]
    return (inv_sx, inv_sy, -0.5 / (1.0 - rho * rho), inv_sx * inv_sx,
            inv_sx * inv_sy, inv_sy * inv_sy)


def _bands(g, gc: int, win):
    """Walk a chunk's pixel window in row bands that bound memory. Yields
    (b0, b1, dx, dy, v): offsets (G, Y, X) from each Gaussian's center and
    its masked kernel value."""
    x0, x1, y0, y1 = win
    dev = g.device
    _, _, w1, w2, w3, w4 = (c[:, None, None] for c in _coeffs(g))
    rho, cx, cy, xlo, xhi, ylo, yhi = (g[:, i, None, None] for i in (
        G_RHO, G_CX, G_CY, G_XLO, G_XHI, G_YLO, G_YHI))
    c2 = 2.0 * rho * w3
    xs = torch.arange(x0, x1 + 1, dtype=torch.float32, device=dev)[None, None]
    band = max(1, _PLAIN_BLOCK // (gc * (x1 - x0 + 1)))
    for b0 in range(y0, y1 + 1, band):
        b1 = min(b0 + band, y1 + 1)
        ys = torch.arange(b0, b1, dtype=torch.float32, device=dev)[None, :,
                                                                  None]
        dx = xs - cx
        dy = ys - cy
        quad = w2 * (dx * dx) - c2 * (dx * dy) + w4 * (dy * dy)
        v = torch.exp(w1 * quad)
        mask = (xs >= xlo) & (xs <= xhi) & (ys >= ylo) & (ys <= yhi)
        yield b0, b1, dx, dy, torch.where(mask, v, torch.zeros((), device=dev))


def raster_fwd_plain(geom, colors, bbox, h: int, w: int):
    """Plain PyTorch version of kernel R: (H, W, C) float32.

    Walks the chunks in ascending order and evaluates each one densely over
    the pixel window of its cull-box union (in row bands that bound memory),
    masked by each Gaussian's inclusive box, adding it into that canvas
    slice."""
    kc = bbox.shape[1]
    gc = geom.shape[0] // kc
    out = geom.new_zeros((h, w, colors.shape[1]))
    for k, box in enumerate(bbox.t().tolist()):
        win = _chunk_window(box, h, w)
        if win is None:
            continue
        x0, x1 = win[0], win[1]
        col = colors[k * gc:(k + 1) * gc]
        for b0, b1, _, _, v in _bands(geom[k * gc:(k + 1) * gc], gc, win):
            out[b0:b1, x0:x1 + 1] += torch.einsum("gyx,gc->yxc", v, col)
    return out


def _check_raster(geom, colors, bbox):
    for t, name in ((geom, "geom"), (colors, "colors"), (bbox, "bbox")):
        _build.check_tensor(t, name)
    s, kc = geom.shape[0], bbox.shape[1]
    if geom.shape[1] != GEOM_COLS or colors.shape != (s, 3):
        raise ValueError(f"geom {tuple(geom.shape)} / colors "
                         f"{tuple(colors.shape)}: expected (S, 16) / (S, 3)")
    if bbox.shape[0] != 4 or kc == 0 or s % kc or s // kc > _DEF_GC:
        raise ValueError(f"{s} Gaussians in {kc} chunks: chunks must be "
                         f"equal and hold at most {_DEF_GC}")
    return s, kc


def raster_fwd(geom, colors, bbox, h: int, w: int):
    """Rasterize chunked pixel-unit Gaussians: (H, W, C) float32.

    geom (S, 16) and colors (S, C) with S a whole number of chunks; bbox
    (4, kc) the per-chunk cull-box unions. CPU tensors take
    `raster_fwd_plain`; CUDA tensors launch kernel R."""
    if geom.device.type == "cpu":
        return raster_fwd_plain(geom, colors, bbox, h, w)
    s, kc = _check_raster(geom, colors, bbox)
    out = torch.empty((h, w, 3), dtype=torch.float32, device=geom.device)
    _build.launch("raster_fwd", geom.contiguous(), colors.contiguous(),
                  bbox.contiguous(), out, kc, s // kc, h, w)
    raster_fwd.launches += 1
    return out


raster_fwd.launches = 0


def raster_bwd_plain(geom, colors, bbox, g, h: int, w: int):
    """Plain PyTorch version of kernel RB: the analytic gradients of
    `raster_fwd` for the output cotangent g (H, W, C). Returns (dgeom (S,
    16), dcol (S, C)).

    Per Gaussian, dcol = sum_p g v, and with at = (g . col) v the moments
    sum_p at * {dx, dy, dx^2, dy^2, dx dy} over every pixel of the chunk
    window give dsx, dsy, drho, dcx and dcy once the per-Gaussian
    coefficients are applied after the walk (`_bwd_body` of the JAX
    package). Columns 5-15 of dgeom are zero."""
    kc = bbox.shape[1]
    gc = geom.shape[0] // kc
    dgeom = torch.zeros_like(geom)
    dcol = torch.zeros_like(colors)
    for k, box in enumerate(bbox.t().tolist()):
        win = _chunk_window(box, h, w)
        if win is None:
            continue
        x0, x1 = win[0], win[1]
        gk = geom[k * gc:(k + 1) * gc]
        col = colors[k * gc:(k + 1) * gc]
        mom = geom.new_zeros((5, gc))
        dc = torch.zeros_like(col)
        for b0, b1, dx, dy, v in _bands(gk, gc, win):
            gb = g[b0:b1, x0:x1 + 1]
            dc += torch.einsum("gyx,yxc->gc", v, gb)
            at = torch.einsum("yxc,gc->gyx", gb, col) * v
            mom += torch.stack([(at * m).sum(dim=(1, 2)) for m in (
                dx, dy, dx * dx, dy * dy, dx * dy)])
        s_x, s_y, s_xx, s_yy, s_xy = mom
        inv_sx, inv_sy, w1, w2, w3, w4 = _coeffs(gk)
        rho = gk[:, G_RHO]
        c1 = 2.0 * w1
        rw3 = rho * w3
        d_cx = c1 * (rw3 * s_y - w2 * s_x)
        d_cy = c1 * (rw3 * s_x - w4 * s_y)
        d_sx = c1 * inv_sx * (rw3 * s_xy - w2 * s_xx)
        d_sy = c1 * inv_sy * (rw3 * s_xy - w4 * s_yy)
        s_q = w2 * s_xx - 2.0 * rw3 * s_xy + w4 * s_yy
        d_rho = -c1 * (2.0 * w1 * rho * s_q + w3 * s_xy)
        dgeom[k * gc:(k + 1) * gc, :5] = torch.stack(
            [d_sx, d_sy, d_rho, d_cx, d_cy], dim=1)
        dcol[k * gc:(k + 1) * gc] = dc
    return dgeom, dcol


def raster_bwd(geom, colors, bbox, g, h: int, w: int):
    """Gradients of `raster_fwd` for the cotangent g (H, W, C): (dgeom (S,
    16), dcol (S, C)). CPU tensors take `raster_bwd_plain`; CUDA tensors
    launch kernel RB."""
    if geom.device.type == "cpu":
        return raster_bwd_plain(geom, colors, bbox, g, h, w)
    s, kc = _check_raster(geom, colors, bbox)
    _build.check_tensor(g, "g")
    if g.shape != (h, w, 3):
        raise ValueError(f"g {tuple(g.shape)}: expected {(h, w, 3)}")
    dgeom = torch.empty((s, GEOM_COLS), dtype=torch.float32,
                        device=geom.device)
    dcol = torch.empty((s, 3), dtype=torch.float32, device=geom.device)
    _build.launch("raster_bwd", geom.contiguous(), colors.contiguous(),
                  bbox.contiguous(), g.contiguous(), dgeom, dcol, kc,
                  s // kc, h, w)
    raster_bwd.launches += 1
    return dgeom, dcol


raster_bwd.launches = 0


class _Raster(torch.autograd.Function):
    """Forward R, backward RB (the custom VJP `_raster_core` of the JAX
    package). The chunk boxes get no gradient."""

    @staticmethod
    def forward(ctx, geom, colors, bbox, h, w):
        ctx.save_for_backward(geom, colors, bbox)
        ctx.hw = (h, w)
        return raster_fwd(geom, colors, bbox, h, w)

    @staticmethod
    def backward(ctx, g):
        geom, colors, bbox = ctx.saved_tensors
        dgeom, dcol = raster_bwd(geom, colors, bbox, g, *ctx.hw)
        return dgeom, dcol, None, None, None


def chunk_geometry(geom, colors, canvas_hw: Sequence[int], *,
                   spatial_sort: bool = True):
    """The host side of `gs_render_px`: the optional spatial sort, padding
    to whole chunks and the chunk-box unions. Returns the arguments of
    `raster_fwd`: (geom, colors, bbox)."""
    h, w = int(canvas_hw[0]), int(canvas_hw[1])
    geom = geom.to(torch.float32)
    colors = colors.to(torch.float32)
    s = geom.shape[0]
    if spatial_sort and s > _DEF_GC:
        cyt = geom[:, G_CY].clamp(0, h - 1).to(torch.int32) // _SORT_TH
        cxt = geom[:, G_CX].clamp(0, w - 1).to(torch.int32) // _SORT_TW
        perm = torch.argsort(cyt * _cdiv(w, _SORT_TW) + cxt, stable=True)
        geom = geom[perm]
        colors = colors[perm]
    pad = _cdiv(s, _DEF_GC) * _DEF_GC - s
    if pad:
        # INVERTED cull boxes (lo=+PAD, hi=-PAD): empty for the per-pixel
        # mask and neutral in the chunk-box unions.
        row = torch.zeros(GEOM_COLS, dtype=torch.float32, device=geom.device)
        row[[G_SX, G_SY]] = 1.0
        row[[G_CX, G_CY, G_XLO, G_YLO]] = _PAD
        row[[G_XHI, G_YHI]] = -_PAD
        geom = torch.cat([geom, row.expand(pad, GEOM_COLS)])
        colors = torch.cat([colors, colors.new_zeros(pad, colors.shape[1])])
    return geom, colors, _chunk_bboxes(geom.detach(), _DEF_GC)


def gs_render_px(geom, colors, canvas_hw: Sequence[int], *,
                 spatial_sort: bool = True):
    """Rasterize (S, 16) pixel-unit Gaussians onto an (H, W) canvas.

    spatial_sort stably reorders the Gaussians by the (32, 128) tile of
    their clamped centers, which only tightens the chunk boxes; the
    per-Gaussian cull boxes keep the result exact in any order.
    Differentiable in geom (columns 0-4) and colors. Returns (H, W, C)
    float32."""
    h, w = int(canvas_hw[0]), int(canvas_hw[1])
    return _Raster.apply(*chunk_geometry(geom, colors, (h, w),
                                         spatial_sort=spatial_sort), h, w)


def gs_render(sigmas, coords, colors, image_size: Sequence[int], dmax=100.0,
              *, spatial_sort: bool = True):
    """Render S Gaussians given in the reference's normalized convention
    (sigmas (S, 3), coords (S, 2) in [-1, 1], colors (S, C)): (h, w, C)."""
    h, w = int(image_size[0]), int(image_size[1])
    geom = pack_geometry(sigmas.to(torch.float32), coords.to(torch.float32),
                         (h, w), dmax)
    return gs_render_px(geom, colors, (h, w), spatial_sort=spatial_sort)
