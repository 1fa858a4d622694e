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

With binning="exact" (the JAX package's opt-in exact-list forward) the
Gaussians are sorted by the (8, 128) tile of their cull box's corner,
`exact_build` builds each such tile's list of exactly the Gaussians whose
boxes overlap it (kernel XB, `csrc/exact_build.cu`, on the card;
`exact_tables`, its plain version, on the CPU), and `raster_fwd_exact`
walks the lists: kernel R-exact
(also in `csrc/raster_fwd.cu`) on the card, `raster_fwd_exact_plain` on the
CPU. When a box spans more tiles than the lists were sized for, or the
lists overflow their capacity, R renders the same Gaussians instead, as
JAX's runtime fallback does.

`gs_render_px` and `gs_render` are differentiable in the geometry and the
colors: the backward is `raster_bwd`, kernel RB (`csrc/raster_bwd.cu`) on
the card, `raster_bwd_plain` on the CPU, on either forward's geometry. The
gradient reaches geometry columns 0-4 (sx, sy, rho, cx, cy) and the colors
only; the cull boxes and the zero pad (columns 5-15) get exactly zero, as
in the JAX package.
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
# Pixels x Gaussians evaluated at once by the plain versions.
_PLAIN_BLOCK = 1 << 22
# The exact lists' bins, as the JAX package's (_DEF_TH_BIN, _DEF_TW,
# _DEF_GC_LIST): tiles of 8 x 128 pixels, chunks of 256 slots. The lists
# are built only when a box spans at most _MAX_SPANS such tiles, hold about
# _LIST_BUDGET memberships a Gaussian, and the Gaussians are padded to a
# multiple of _LIST_ALIGN (the JAX package's default chunk).
_TH_BIN = 8
_TW_BIN = 128
_GC_LIST = 256
_MAX_SPANS = 64
_LIST_BUDGET = 10
_LIST_ALIGN = 1024


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
    """Per-Gaussian quadratic-form coefficients of geometry rows g (..., 16):
    (inv_sx, inv_sy, w1, w2, w3, w4), w1 = -0.5/(1-rho^2), w2 = 1/sx^2,
    w3 = 1/(sx sy), w4 = 1/sy^2."""
    inv_sx = 1.0 / g[..., G_SX]
    inv_sy = 1.0 / g[..., G_SY]
    rho = g[..., G_RHO]
    return (inv_sx, inv_sy, -0.5 / (1.0 - rho * rho), inv_sx * inv_sx,
            inv_sx * inv_sy, inv_sy * inv_sy)


def _values(g, xs, ys):
    """Offsets from each Gaussian's center and its kernel value, masked by
    its inclusive box, for geometry rows g (..., G, 16) at pixel columns xs
    (..., 1, 1, X) and rows ys (..., 1, Y, 1): (dx, dy, v), each (..., G, Y,
    X)."""
    _, _, w1, w2, w3, w4 = (c[..., None, None] for c in _coeffs(g))
    rho, cx, cy, xlo, xhi, ylo, yhi = (g[..., i, None, None] for i in (
        G_RHO, G_CX, G_CY, G_XLO, G_XHI, G_YLO, G_YHI))
    c2 = 2.0 * rho * w3
    dx = xs - cx
    dy = ys - cy
    quad = w2 * (dx * dx) - c2 * (dx * dy) + w4 * (dy * dy)
    v = torch.exp(w1 * quad)
    mask = (xs >= xlo) & (xs <= xhi) & (ys >= ylo) & (ys <= yhi)
    return dx, dy, torch.where(mask, v, torch.zeros((), device=g.device))


def _bands(g, gc: int, win):
    """Walk a chunk's pixel window in row bands that bound memory. Yields
    (b0, b1, dx, dy, v): offsets (G, Y, X) from each Gaussian's center and
    its masked kernel value."""
    x0, x1, y0, y1 = win
    dev = g.device
    xs = torch.arange(x0, x1 + 1, dtype=torch.float32, device=dev)[None, None]
    band = max(1, _PLAIN_BLOCK // (gc * (x1 - x0 + 1)))
    for b0 in range(y0, y1 + 1, band):
        b1 = min(b0 + band, y1 + 1)
        ys = torch.arange(b0, b1, dtype=torch.float32, device=dev)[None, :,
                                                                  None]
        yield (b0, b1, *_values(g, xs, ys))


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
    geom = geom.contiguous()
    if geom.data_ptr() % 16:  # R reads the rows as 16-byte vectors
        geom = geom.clone()
    _build.launch("raster_fwd", geom, colors.contiguous(), bbox.contiguous(),
                  out, kc, s // kc, h, w)
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
    launch kernel RB, whose warps each read one Gaussian's own box (the
    chunk boxes bbox serve the plain version's walk)."""
    if geom.device.type == "cpu":
        return raster_bwd_plain(geom, colors, bbox, g, h, w)
    s, _ = _check_raster(geom, colors, bbox)
    _build.check_tensor(g, "g")
    if g.shape != (h, w, 3):
        raise ValueError(f"g {tuple(g.shape)}: expected {(h, w, 3)}")
    dgeom = torch.empty((s, GEOM_COLS), dtype=torch.float32,
                        device=geom.device)
    dcol = torch.empty((s, 3), dtype=torch.float32, device=geom.device)
    _build.launch("raster_bwd", geom.contiguous(), colors.contiguous(),
                  g.contiguous(), dgeom, dcol, s, h, w)
    raster_bwd.launches += 1
    return dgeom, dcol


raster_bwd.launches = 0


def _corner_tiles(geom, h: int, w: int, th: int, tw: int):
    """Clipped corner tile coordinates and tile extents of each cull box of
    geom (S, 16): (fy0, fx0, nrows, ncols, vis), int32 but vis. An invisible
    box is forced to corner (n_th, 0), one tile row past the canvas, so it
    sorts after every visible one under the y-major corner key fy0 * n_tw +
    fx0."""
    n_th = _cdiv(h, th)
    xlo, xhi, ylo, yhi = (geom[:, i] for i in (G_XLO, G_XHI, G_YLO, G_YHI))
    vis = ((xhi >= 0) & (xlo <= w - 1) & (yhi >= 0) & (ylo <= h - 1)
           & (xhi >= xlo) & (yhi >= ylo))

    def tile(x, hi, n):
        return torch.div(x.clamp(0, hi), n, rounding_mode="floor").to(
            torch.int32)

    fx0, fx1 = tile(xlo, w - 1, tw), tile(xhi, w - 1, tw)
    fy0, fy1 = tile(ylo, h - 1, th), tile(yhi, h - 1, th)
    zero = torch.zeros((), dtype=torch.int32, device=geom.device)
    nrows = torch.where(vis, fy1 - fy0 + 1, zero)
    ncols = torch.where(vis, fx1 - fx0 + 1, zero)
    return (torch.where(vis, fy0, zero + n_th), torch.where(vis, fx0, zero),
            nrows, ncols, vis)


def _cumsum(x, dim: int):
    return torch.cumsum(x, dim=dim, dtype=torch.int32)


def _row_cumsum(x):
    """Inclusive prefix sums along the rows of an (R, N) int32 tensor with a
    few long rows, through one scan of the flattened tensor: each row's sums
    are the flat sums less the flat sum before the row. A scan of the rows
    themselves runs one row at a time per block and is several times
    slower on the card at the lists' (20, 519168). Integer sums: exact."""
    flat = _cumsum(x.reshape(-1), 0).view(x.shape)
    before = torch.cat([flat.new_zeros(1), flat[:-1, -1]])
    return flat - before[:, None]


def exact_tables(geom, h: int, w: int, th: int, tw: int, gc: int, mr: int,
                 mc: int, cap: int):
    """Per-tile EXACT Gaussian lists of geom (S, 16), sorted by
    `_corner_tiles`' key (the JAX package's `_exact_tables`, integer for
    integer).

    For such a sorted array the memberships at a fixed tile offset q = (r,
    c) of the (mr, mc) lattice (Gaussian i covering tile (fy0_i + r, fx0_i +
    c)) are nondecreasing in tile id, so each membership's slot is
    computed: seg_start[t] * gc + offset_q[t] + rank_q(i), with per-(q,
    tile) counts from a left searchsorted at the tile edges, each tile's
    segment padded to whole chunks of gc slots (at least one), and the ranks
    from prefix sums; one scatter writes the source indices. Plain torch
    ops on geom's device, no float atomics: the integer scatters give the
    same result in any order; nothing waits on the device.

    Returns (list_idx (cap,) int32 indices into geom, S marking an empty
    slot; tab (cap // gc,) int32 packed tile * 4 + flag + 1, flag 1 for a
    tile's first chunk, 0 for the rest of its segment, -1 for unused
    capacity (tile n_tiles - 1); ok, a bool tensor: no box spans more than
    (mr, mc) tiles and the segments fit cap)."""
    dev = geom.device
    i32 = dict(dtype=torch.int32, device=dev)
    sp = geom.shape[0]
    n_th, n_tw = _cdiv(h, th), _cdiv(w, tw)
    nt = n_th * n_tw
    nchunks = cap // gc
    q_n = mr * mc
    fy0, fx0, nrows, ncols, vis = _corner_tiles(geom, h, w, th, tw)
    ok_span = (nrows <= mr).all() & (ncols <= mc).all()

    # (Q, sp) membership lattice; each key row is nondecreasing
    rr = torch.arange(mr, **i32).repeat_interleave(mc)[:, None]
    cc = torch.arange(mc, **i32).repeat(mr)[:, None]
    key = (fy0[None] + rr) * n_tw + torch.clamp(fx0[None] + cc, max=n_tw - 1)
    valid = vis[None] & (rr < nrows[None]) & (cc < ncols[None])
    cvx = torch.cat([torch.zeros((q_n, 1), **i32), _row_cumsum(valid.to(
        torch.int32))], dim=1)                       # (Q, sp+1) prefix
    t_edges = torch.arange(nt + 1, **i32).expand(q_n, nt + 1).contiguous()
    pos = torch.searchsorted(key.contiguous(), t_edges, out_int32=True)
    cv_at = torch.gather(cvx, 1, pos)               # valid count at starts
    vcnt = cv_at[:, 1:] - cv_at[:, :-1]             # (Q, nt) per-tile counts

    counts = vcnt.sum(dim=0, dtype=torch.int32)
    seg_chunks = torch.clamp(-torch.div(-counts, gc, rounding_mode="floor"),
                             min=1)
    seg_start_c = torch.cat([torch.zeros(1, **i32), _cumsum(seg_chunks, 0)])
    used_chunks = seg_start_c[nt]
    ok = ok_span & (used_chunks <= nchunks)

    # element offset of sequence q inside tile t's segment
    off_q = torch.cat([torch.zeros((1, nt), **i32), _cumsum(vcnt, 0)[:-1]])
    base = seg_start_c[:-1][None] * gc + off_q      # (Q, nt)

    def pcw(table):
        """Piecewise-constant expansion table[q, key_q(i)] -> (Q, sp): the
        run starts' deltas scattered (an integer sum), then a prefix sum."""
        prev = torch.cat([torch.zeros((q_n, 1), **i32), table[:, :-1]], 1)
        arr = torch.zeros((q_n, sp + 1), **i32)
        arr.scatter_add_(1, pos[:, :-1].to(torch.int64), table - prev)
        return _row_cumsum(arr)[:, :sp]

    rank = cvx[:, :sp] - pcw(cv_at[:, :-1])         # index within (q, tile)
    dest = torch.where(valid, pcw(base) + rank, cap)
    # JAX's mode="drop" without a host sync: each membership past the
    # capacity goes to a spare slot of its own, cut off after, so every
    # slot is written at most once
    src = torch.arange(sp, **i32).expand(q_n, sp).reshape(-1)
    spare = cap + torch.arange(q_n * sp, dtype=torch.int64, device=dev)
    list_idx = torch.full((cap + q_n * sp,), sp, **i32)
    list_idx[torch.where(dest.reshape(-1) < cap, dest.reshape(-1).to(
        torch.int64), spare)] = src
    list_idx = list_idx[:cap]

    ck = torch.arange(nchunks, **i32)
    tile_of = torch.clamp(torch.searchsorted(
        seg_start_c, ck, right=True, out_int32=True) - 1, 0, nt - 1)
    is_start = torch.zeros(nchunks + 1, dtype=torch.bool, device=dev)
    is_start[torch.clamp(seg_start_c[:-1], max=nchunks).to(torch.int64)] = True
    unused = ck >= used_chunks
    flag = torch.where(unused, -1, is_start[:nchunks].to(torch.int32))
    tile_of = torch.where(unused, nt - 1, tile_of)
    return list_idx, (tile_of * 4 + flag + 1).to(torch.int32), ok


def exact_build(geom, h: int, w: int, th: int, tw: int, gc: int, mr: int,
                mc: int, cap: int):
    """`exact_tables` on the card: kernel XB (`csrc/exact_build.cu`), three
    launches that give its (list_idx, tab, ok) integer for integer from
    geom (S, 16) sorted by corner tile. CPU tensors take `exact_tables`,
    the plain version."""
    if geom.device.type == "cpu":
        return exact_tables(geom, h, w, th, tw, gc, mr, mc, cap)
    _build.check_tensor(geom, "geom")
    sp = geom.shape[0]
    if geom.shape[1] != GEOM_COLS or cap % gc or cap < gc:
        raise ValueError(f"geom {tuple(geom.shape)}, cap {cap}, gc {gc}: "
                         f"expected (S, 16) and a capacity of whole chunks")
    nt = _cdiv(h, th) * _cdiv(w, tw)
    i32 = dict(dtype=torch.int32, device=geom.device)
    spans = torch.empty(sp, **i32)
    run_start = torch.empty(nt + 2, **i32)
    counts = torch.empty(nt, **i32)
    span_bad = torch.empty(nt, **i32)
    list_idx = torch.empty(cap, **i32)
    tab = torch.empty(cap // gc, **i32)
    ok = torch.empty((), dtype=torch.bool, device=geom.device)
    _build.launch("exact_build", geom.contiguous(), spans, run_start, counts,
                  span_bad, list_idx, tab, ok, sp, h, w, th, tw, gc, mr, mc,
                  cap)
    exact_build.launches += 1
    return list_idx, tab, ok


exact_build.launches = 0


def raster_fwd_exact_plain(geom, colors, list_idx, tab, h: int, w: int):
    """Plain PyTorch version of kernel R-exact: (H, W, C) float32.

    Each chunk k with flag >= 0 evaluates its 256 list slots (indices into
    geom; S or more is the empty pad slot, an inverted box) densely on its
    8 x 128 tile, tab[k] // 4, with R's quadratic form and inclusive-box
    mask, a batch of chunks at a time; a tile's image is the sum of its
    chunks (zeroed at its first). The slots are gathered here, so no
    list-ordered copy of the geometry is kept."""
    th, tw, gc = _TH_BIN, _TW_BIN, _GC_LIST
    n, nc = geom.shape[0], colors.shape[1]
    n_th, n_tw = _cdiv(h, th), _cdiv(w, tw)
    dev = geom.device
    pad = geom.new_zeros((1, GEOM_COLS))
    pad[0, [G_SX, G_SY]] = 1.0
    pad[0, [G_XLO, G_YLO]] = _PAD
    pad[0, [G_XHI, G_YHI]] = -_PAD
    gext = torch.cat([geom, pad])
    cext = torch.cat([colors, colors.new_zeros((1, nc))])
    code = tab.reshape(-1).to(torch.int64)
    live = torch.nonzero(code % 4 >= 1).reshape(-1)  # flag = code % 4 - 1
    tiles = geom.new_zeros((n_th * n_tw, th, tw, nc))
    slots = list_idx.reshape(-1, gc).to(torch.int64).clamp(0, n)
    rows = torch.arange(th, dtype=torch.float32, device=dev)
    cols = torch.arange(tw, dtype=torch.float32, device=dev)
    batch = max(1, _PLAIN_BLOCK // (gc * th * tw))
    for b0 in range(0, live.numel(), batch):
        ks = live[b0:b0 + batch]
        t = code[ks] // 4
        ys = ((t // n_tw) * th).to(torch.float32)[:, None] + rows
        xs = ((t % n_tw) * tw).to(torch.float32)[:, None] + cols
        _, _, v = _values(gext[slots[ks]], xs[:, None, None, :],
                          ys[:, None, :, None])
        tiles.index_add_(0, t, torch.einsum("kgyx,kgc->kyxc", v,
                                            cext[slots[ks]]))
    img = tiles.reshape(n_th, n_tw, th, tw, nc).permute(0, 2, 1, 3, 4)
    return img.reshape(n_th * th, n_tw * tw, nc)[:h, :w]


def raster_fwd_exact(geom, colors, list_idx, tab, h: int, w: int):
    """Rasterize pixel-unit Gaussians over the exact lists of
    `exact_tables` (8 x 128 tiles, 256-slot chunks): (H, W, C) float32.
    CPU tensors take `raster_fwd_exact_plain`; CUDA tensors launch kernel
    R-exact."""
    if geom.device.type == "cpu":
        return raster_fwd_exact_plain(geom, colors, list_idx, tab, h, w)
    for t, name in ((geom, "geom"), (colors, "colors")):
        _build.check_tensor(t, name)
    for t, name in ((list_idx, "list_idx"), (tab, "tab")):
        _build.check_tensor(t, name, torch.int32)
    n, nchunks = geom.shape[0], tab.numel()
    if (geom.shape[1] != GEOM_COLS or colors.shape != (n, 3)
            or list_idx.numel() != nchunks * _GC_LIST):
        raise ValueError(f"geom {tuple(geom.shape)}, colors "
                         f"{tuple(colors.shape)}, {list_idx.numel()} slots in "
                         f"{nchunks} chunks: expected (S, 16), (S, 3) and "
                         f"{_GC_LIST} slots a chunk")
    out = torch.empty((h, w, 3), dtype=torch.float32, device=geom.device)
    _build.launch("raster_fwd_exact", geom.contiguous(), colors.contiguous(),
                  list_idx.contiguous(), tab.contiguous(), out, n, nchunks,
                  h, w)
    raster_fwd_exact.launches += 1
    return out


raster_fwd_exact.launches = 0


class _Raster(torch.autograd.Function):
    """Forward R, or over exact lists (list_idx, tab) R-exact; backward RB
    on the same chunked geometry (the custom VJP `_raster_core` of the JAX
    package). The chunk boxes and lists get no gradient."""

    @staticmethod
    def forward(ctx, geom, colors, bbox, h, w, list_idx=None, tab=None):
        ctx.save_for_backward(geom, colors, bbox)
        ctx.hw = (h, w)
        if list_idx is not None:
            return raster_fwd_exact(geom, colors, list_idx, tab, h, w)
        return raster_fwd(geom, colors, bbox, h, w)

    @staticmethod
    def backward(ctx, g):
        geom, colors, bbox = ctx.saved_tensors
        dgeom, dcol = raster_bwd(geom, colors, bbox, g, *ctx.hw)
        return dgeom, dcol, None, None, None, None, None


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
    geom, colors = _pad(geom, colors, _DEF_GC)
    return geom, colors, _chunk_bboxes(geom.detach(), _DEF_GC)


def _pad(geom, colors, align: int):
    """Pad the Gaussians to a multiple of `align` with rows whose cull boxes
    are INVERTED (lo=+PAD, hi=-PAD): empty for the per-pixel mask, neutral in
    the chunk-box unions, and invisible to `_corner_tiles`."""
    s = geom.shape[0]
    pad = _cdiv(s, align) * align - s
    if pad:
        row = torch.zeros(GEOM_COLS, dtype=torch.float32, device=geom.device)
        row[[G_SX, G_SY]] = 1.0
        row[[G_CX, G_CY, G_XLO, G_YLO]] = _PAD
        row[[G_XHI, G_YHI]] = -_PAD
        geom = torch.cat([geom, row.expand(pad, GEOM_COLS)])
        colors = torch.cat([colors, colors.new_zeros(pad, colors.shape[1])])
    return geom, colors


def _exact_spans(h: int, w: int, max_box_px):
    """(mr, mc): the most 8 x 128 list tiles a cull box can span, from a
    static bound (box_h, box_w) on the boxes' extents in pixels, else the
    whole canvas."""
    n_th, n_tw = _cdiv(h, _TH_BIN), _cdiv(w, _TW_BIN)
    if max_box_px is None:
        return n_th, n_tw
    mbh, mbw = (math.ceil(float(x)) for x in max_box_px)
    return (min(n_th, _cdiv(max(mbh - 1, 1), _TH_BIN) + 1),
            min(n_tw, _cdiv(max(mbw - 1, 1), _TW_BIN) + 1))


def exact_geometry(geom, colors, canvas_hw: Sequence[int], mr: int, mc: int):
    """The host side of the exact-list forward: the Gaussians stably sorted
    by `_corner_tiles`' key, padded to a multiple of 1024, their 256-chunk
    boxes (RB's and, on overflow, R's) and the lists (`exact_build`:
    kernel XB on the card, `exact_tables` on the CPU). Returns (geom,
    colors, bbox, list_idx, tab, ok); the list capacity is a tile's chunk
    plus 10 memberships a Gaussian (every membership when a box spans at
    most 10 tiles), as the JAX package sizes it."""
    h, w = int(canvas_hw[0]), int(canvas_hw[1])
    geom = geom.to(torch.float32)
    colors = colors.to(torch.float32)
    fy0, fx0, _, _, _ = _corner_tiles(geom.detach(), h, w, _TH_BIN, _TW_BIN)
    perm = torch.argsort(fy0 * _cdiv(w, _TW_BIN) + fx0, stable=True)
    geom, colors = _pad(geom[perm], colors[perm], _LIST_ALIGN)
    nt = _cdiv(h, _TH_BIN) * _cdiv(w, _TW_BIN)
    cap = _cdiv(nt * _GC_LIST + min(mr * mc, _LIST_BUDGET) * geom.shape[0],
                _GC_LIST) * _GC_LIST
    tables = exact_build(geom.detach(), h, w, _TH_BIN, _TW_BIN, _GC_LIST,
                         mr, mc, cap)
    return (geom, colors, _chunk_bboxes(geom.detach(), _DEF_GC), *tables)


def gs_render_px(geom, colors, canvas_hw: Sequence[int], *,
                 spatial_sort: bool = True, binning: str = "auto",
                 max_box_px=None):
    """Rasterize (S, 16) pixel-unit Gaussians onto an (H, W) canvas.

    spatial_sort stably reorders the Gaussians by the (32, 128) tile of
    their clamped centers, which only tightens the chunk boxes; the
    per-Gaussian cull boxes keep the result exact in any order.

    binning="exact" takes the exact-list forward where a box spans at most
    64 list tiles of 8 x 128 (max_box_px, a static (box_h, box_w) bound on
    the boxes' extents, sizes the span; without it the whole canvas):
    `exact_geometry` sorts by corner tile (whatever spatial_sort says, as
    the JAX package's exact call sorts) and builds the lists, one host read
    of their `ok` decides, and R-exact renders them, or R the same sorted
    Gaussians when they overflow. Any other binning takes R.

    Differentiable in geom (columns 0-4) and colors. Returns (H, W, C)
    float32."""
    h, w = int(canvas_hw[0]), int(canvas_hw[1])
    if binning == "exact":
        mr, mc = _exact_spans(h, w, max_box_px)
        if mr * mc <= _MAX_SPANS:
            geom, colors, bbox, list_idx, tab, ok = exact_geometry(
                geom, colors, (h, w), mr, mc)
            if bool(ok):
                return _Raster.apply(geom, colors, bbox, h, w, list_idx, tab)
            return _Raster.apply(geom, colors, bbox, h, w)
    return _Raster.apply(*chunk_geometry(geom, colors, (h, w),
                                         spatial_sort=spatial_sort), h, w)


def gs_render(sigmas, coords, colors, image_size: Sequence[int], dmax=100.0,
              *, spatial_sort: bool = True, binning: str = "auto"):
    """Render S Gaussians given in the reference's normalized convention
    (sigmas (S, 3), coords (S, 2) in [-1, 1], colors (S, C)): (h, w, C).
    A dmax given as a number bounds the cull boxes' extents (2 dmax half
    the canvas), which sizes the exact lists of binning="exact"."""
    h, w = int(image_size[0]), int(image_size[1])
    geom = pack_geometry(sigmas.to(torch.float32), coords.to(torch.float32),
                         (h, w), dmax)
    max_box_px = None
    if isinstance(dmax, (int, float)):
        max_box_px = (min(h, dmax * (h - 1) + 1), min(w, dmax * (w - 1) + 1))
    return gs_render_px(geom, colors, (h, w), spatial_sort=spatial_sort,
                        binning=binning, max_box_px=max_box_px)
