"""Edge cases of the tile rasterizer's kernels R and RB, shared by the CPU
emulation of their designs (tests/test_torch_raster_design.py) and the
card tests (tests/test_torch_kernels_gpu.py): numpy from a generator, no
JAX."""

import numpy as np
import torch

from gsasr_torch.rendering import training_batch_geometry


def px_gaussians(rng, s, h, w, half_lo=0.3, half_hi=12.0, spread=5.0):
    """Pixel-unit Gaussians with boxes of half-size in [half_lo, half_hi],
    centers up to `spread` px off the canvas."""
    geom = np.zeros((s, 16), np.float32)
    geom[:, 0:2] = rng.uniform(0.5, 4.0, (s, 2))
    geom[:, 2] = rng.uniform(-0.9, 0.9, s)
    geom[:, 3] = rng.uniform(-spread, w + spread, s)
    geom[:, 4] = rng.uniform(-spread, h + spread, s)
    half = rng.uniform(half_lo, half_hi, (s, 2)).astype(np.float32)
    geom[:, 5], geom[:, 6] = geom[:, 3] - half[:, 0], geom[:, 3] + half[:, 0]
    geom[:, 7], geom[:, 8] = geom[:, 4] - half[:, 1], geom[:, 4] + half[:, 1]
    return geom, rng.random((s, 3), dtype=np.float32)


def edge_case(name, rng):
    """(geom (S, 16), colors (S, 3), (h, w), spatial_sort) of one edge
    case, numpy float32."""
    if name == "edges":
        # ragged tiles (45 = 2 x 16 + 13, 70 = 4 x 16 + 6), boxes across
        # every edge, a few saturated and inverted boxes, S = 700 padded
        h, w = 45, 70
        geom, col = px_gaussians(rng, 700, h, w)
        geom[:8, 5:9] = [-1e3, 1e3, -1e3, 1e3]       # saturated
        geom[8:12, 5:9] = [30, 20, 10, 40]           # inverted in x
        geom[12:16, 5:9] = [20, 30, 40, 10]          # inverted in y
        # boxes whose bounds fall on the tiles' and sub-rectangles' edges
        # (one pixel or one row or column wide): an inclusive test taken
        # as strict culls them
        for i, (xa, xb, ya, yb) in enumerate(
                [(15, 15, 3, 3), (16, 16, 16, 16), (7, 8, 31, 32),
                 (63, 69, 44, 44), (0, 0, 0, 0), (69, 69, 40, 47),
                 (23, 24, 11, 12), (47, 48, 19, 20)]):
            geom[16 + i, 3:9] = [xa, ya, xa, xb, ya, yb]
        return geom, col, (h, w), True
    if name == "far_chunk":
        # unsorted: Gaussians 256-511 lie far off the canvas, so their
        # chunk misses every tile; small boxes of one pixel or none
        h, w = 33, 50
        geom, col = px_gaussians(rng, 600, h, w, half_lo=0.2, half_hi=6.0)
        geom[256:512, 3] += 500.0
        geom[256:512, 5:7] += 500.0
        return geom, col, (h, w), False
    if name == "slots":
        # three samples of the training canvas (32 x 40 each), boxes
        # clamped to their slots by training_batch_geometry
        b, n, hmax, wmax = 3, 150, 32, 40
        gs = torch.from_numpy(rng.standard_normal((b, n, 9)).astype(
            np.float32))
        scales = torch.tensor([1.0, 2.5, 4.0])
        gt = torch.tensor([14.0, 27.0, 32.0])
        geoms, cols = training_batch_geometry(gs, scales, gt, gt - 3.0,
                                              (hmax, wmax), dmax=0.4)
        return (geoms.reshape(-1, 16).numpy(), cols.reshape(-1, 3).numpy(),
                (b * hmax, wmax), True)
    if name == "saturated":
        # init-like: every box covers the canvas, so every Gaussian meets
        # every tile (the culling's worst case)
        # (600: a tile's hits overflow one staging list of 512)
        h, w = 40, 48
        geom, col = px_gaussians(rng, 600, h, w)
        geom[:, 0:2] = rng.uniform(20.0, 60.0, (600, 2))
        geom[:, 5:9] = [-80.0, 130.0, -90.0, 120.0]
        return geom, col, (h, w), True
    raise ValueError(name)


CASES = ["edges", "far_chunk", "slots", "saturated"]
