"""Tile rasterizer forward for 2D Gaussian splatting (counterpart of
`gsasr_tpu/ops/rasterizer.py`, inference side).

Gaussians are rasterized in pixel units with per-Gaussian inclusive cull
boxes, packed as (S, 16) float32 rows
  [sigma_x, sigma_y, rho, cx, cy, xlo, xhi, ylo, yhi, 0...0]
(sigma_x pairs with the x/width axis). `gs_render_px` optionally sorts the
Gaussians spatially, pads them to whole chunks with inverted (empty) cull
boxes, takes the per-chunk cull-box unions, and calls `raster_fwd`:
kernel R (`csrc/raster_fwd.cu`) on the card, `raster_fwd_plain` on the CPU.
Both walk the chunks in ascending order per pixel, so the sum is
deterministic and needs no atomics.
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


def pack_geometry(sigmas, coords, image_size, dmax):
    """Normalized-unit parameters -> (S, 16) pixel-unit packed geometry.

    The kernel value is invariant under rescaling distances and sigmas by
    (n-1)/2 per axis. The cull box is dmax (normalized) tightened to 14.5
    sigma: beyond that exp(-0.5 (dx/sigma_x)^2) underflows to f32 zero for
    any rho, so the tightening changes nothing in the output."""
    h, w = image_size[0], image_size[1]
    dev = sigmas.device
    f32 = torch.float32
    half_w = (torch.tensor(float(w), dtype=f32, device=dev) - 1.0) * 0.5
    half_h = (torch.tensor(float(h), dtype=f32, device=dev) - 1.0) * 0.5
    sx = sigmas[:, 0] * half_w
    sy = sigmas[:, 1] * half_h
    rho = sigmas[:, 2]
    cx = (coords[:, 0] + 1.0) * half_w
    cy = (coords[:, 1] + 1.0) * half_h
    d = torch.tensor(float(dmax), dtype=f32, device=dev)
    dmx = torch.minimum(d * half_w, 14.5 * sx)
    dmy = torch.minimum(d * half_h, 14.5 * sy)
    zeros = torch.zeros((sigmas.shape[0], GEOM_COLS - 9), dtype=f32,
                        device=dev)
    return torch.cat([torch.stack([sx, sy, rho, cx, cy, cx - dmx, cx + dmx,
                                   cy - dmy, cy + dmy], dim=1), zeros], dim=1)


def _chunk_bboxes(geom, gc: int):
    """Per-chunk cull-box unions, (4, kc): [xlo, xhi, ylo, yhi]."""
    return torch.stack([geom[:, G_XLO].reshape(-1, gc).amin(dim=1),
                        geom[:, G_XHI].reshape(-1, gc).amax(dim=1),
                        geom[:, G_YLO].reshape(-1, gc).amin(dim=1),
                        geom[:, G_YHI].reshape(-1, gc).amax(dim=1)])


def raster_fwd_plain(geom, colors, bbox, h: int, w: int):
    """Plain PyTorch version of kernel R: (H, W, C) float32.

    Walks the chunks in ascending order and evaluates each one densely over
    the pixel window of its cull-box union (in row bands that bound memory),
    masked by each Gaussian's inclusive box, adding it into that canvas
    slice."""
    kc = bbox.shape[1]
    gc = geom.shape[0] // kc
    out = torch.zeros((h, w, colors.shape[1]), dtype=torch.float32,
                      device=geom.device)
    for k, (bxlo, bxhi, bylo, byhi) in enumerate(bbox.t().tolist()):
        x0, x1 = max(math.ceil(bxlo), 0), min(math.floor(bxhi), w - 1)
        y0, y1 = max(math.ceil(bylo), 0), min(math.floor(byhi), h - 1)
        if x0 > x1 or y0 > y1:
            continue
        g = geom[k * gc:(k + 1) * gc]
        col = colors[k * gc:(k + 1) * gc]
        sx, sy, rho, cx, cy = (g[:, i, None, None] for i in range(5))
        xlo, xhi, ylo, yhi = (g[:, i, None, None] for i in range(5, 9))
        inv_sx = 1.0 / sx
        inv_sy = 1.0 / sy
        w2 = inv_sx * inv_sx
        w3 = inv_sx * inv_sy
        w4 = inv_sy * inv_sy
        w1 = -0.5 / (1.0 - rho * rho)
        c2 = 2.0 * rho * w3
        xs = torch.arange(x0, x1 + 1, dtype=torch.float32,
                          device=geom.device)[None, None, :]
        band = max(1, _PLAIN_BLOCK // (gc * (x1 - x0 + 1)))
        for b0 in range(y0, y1 + 1, band):
            b1 = min(b0 + band, y1 + 1)
            ys = torch.arange(b0, b1, dtype=torch.float32,
                              device=geom.device)[None, :, None]
            dx = xs - cx
            dy = ys - cy
            quad = w2 * (dx * dx) - c2 * (dx * dy) + w4 * (dy * dy)
            v = torch.exp(w1 * quad)
            mask = (xs >= xlo) & (xs <= xhi) & (ys >= ylo) & (ys <= yhi)
            v = torch.where(mask, v, torch.zeros((), device=v.device))
            out[b0:b1, x0:x1 + 1] += torch.einsum("gyx,gc->yxc", v, col)
    return out


def raster_fwd(geom, colors, bbox, h: int, w: int):
    """Rasterize chunked pixel-unit Gaussians: (H, W, C) float32.

    geom (S, 16) and colors (S, C) with S a whole number of chunks; bbox
    (4, kc) the per-chunk cull-box unions. CPU tensors take
    `raster_fwd_plain`; CUDA tensors launch kernel R."""
    if geom.device.type == "cpu":
        return raster_fwd_plain(geom, colors, bbox, h, w)
    for t, name in ((geom, "geom"), (colors, "colors"), (bbox, "bbox")):
        _build.check_tensor(t, name)
    s, kc = geom.shape[0], bbox.shape[1]
    if geom.shape[1] != GEOM_COLS or colors.shape != (s, 3):
        raise ValueError(f"geom {tuple(geom.shape)} / colors "
                         f"{tuple(colors.shape)}: expected (S, 16) / (S, 3)")
    if bbox.shape[0] != 4 or kc == 0 or s % kc or s // kc > _DEF_GC:
        raise ValueError(f"{s} Gaussians in {kc} chunks: chunks must be "
                         f"equal and hold at most {_DEF_GC}")
    geom, colors, bbox = geom.contiguous(), colors.contiguous(), \
        bbox.contiguous()
    out = torch.empty((h, w, 3), dtype=torch.float32, device=geom.device)
    _build.launch("raster_fwd", geom, colors, bbox, out, kc,
                  s // kc, h, w)
    raster_fwd.launches += 1
    return out


raster_fwd.launches = 0


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
    return geom, colors, _chunk_bboxes(geom, _DEF_GC)


def gs_render_px(geom, colors, canvas_hw: Sequence[int], *,
                 spatial_sort: bool = True):
    """Rasterize (S, 16) pixel-unit Gaussians onto an (H, W) canvas.

    spatial_sort stably reorders the Gaussians by the (32, 128) tile of
    their clamped centers, which only tightens the chunk boxes; the
    per-Gaussian cull boxes keep the result exact in any order.
    Returns (H, W, C) float32."""
    h, w = int(canvas_hw[0]), int(canvas_hw[1])
    return raster_fwd(*chunk_geometry(geom, colors, (h, w),
                                      spatial_sort=spatial_sort), h, w)


def gs_render(sigmas, coords, colors, image_size: Sequence[int], dmax=100.0,
              *, spatial_sort: bool = True):
    """Render S Gaussians given in the reference's normalized convention
    (sigmas (S, 3), coords (S, 2) in [-1, 1], colors (S, C)): (h, w, C)."""
    h, w = int(image_size[0]), int(image_size[1])
    geom = pack_geometry(sigmas.to(torch.float32), coords.to(torch.float32),
                         (h, w), dmax)
    return gs_render_px(geom, colors, (h, w), spatial_sort=spatial_sort)
