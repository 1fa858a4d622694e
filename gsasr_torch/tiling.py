"""Tiled large-image inference (counterpart of `gsasr_tpu/tiling.py`, the
reference's `utils/split_and_joint_image.py:98-232`).

The LR image is cut on the host into `split_size` tiles that overlap by
`overlap_size` LR pixels, reflect-padded on the bottom and right to a whole
tile count. The tiles go through the encoder, the fused decoder (kernels M
and A, in `model.fused_dtype(dec)` as `sr_forward` runs it) and the tile
rasterizer (kernel R) on the card, `tile_batch` tiles at a time; each
renders at ceil(split_size * scale). `paste_tiles`, host numpy as in JAX,
pastes them at stride split_sr - ceil(overlap * scale) with a
`crop_size`-pixel seam trim on non-leading edges, and at a fractional
scale clamps the trailing tiles to the canvas with the reference's
last-column quirk. The caller crops the canvas to floor(scale * HW).

Each tile renders as JAX's `_jitted_render` renders it, without the
decoder lattice (`lat_hw`), so that the Gaussians are summed in the same
order (`rendering.raster_inputs`: a square tile's lattice is found from
its Gaussian count). The last batch is not padded to `tile_batch`: every
stage is per image, so the tiles' results do not depend on it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gsasr_torch import resolve_device
from gsasr_torch.model import fused_dtype
from gsasr_torch.models import Fea2GSRopeAMP
from gsasr_torch.models.fea2gs_fast import fea2gs_apply_fused
from gsasr_torch.models.fea2gs_rope_fast import fea2gs_rope_apply_fused
from gsasr_torch.rendering import DEFAULT_STEP_SIZE, render_gaussians


@torch.no_grad()
def split_and_joint_image(lq, scale_factor: float, split_size: int,
                          overlap_size: int, enc, dec, *, crop_size: int = 2,
                          default_step_size: float = DEFAULT_STEP_SIZE,
                          if_dmax: bool = True, dmax_mode: str = "fix",
                          dmax: float = 0.1, tile_batch: int = 8,
                          device=None):
    """lq: (1, H, W, 3) in [0, 1] (array or tensor). enc and dec are on
    `device` (default: the CUDA card). Returns the (1, H', W', 3) float32
    numpy canvas, which the caller crops to floor(scale * HW). JAX's
    function takes default_step_size and if_dmax and renders at their
    defaults; the port passes them to the render."""
    dev = resolve_device(device)
    lq = lq.detach().cpu().numpy() if torch.is_tensor(lq) else np.asarray(lq)
    _, h_lq, w_lq, _ = lq.shape
    if not 0 < overlap_size < split_size // 2:
        raise ValueError(f"overlap {overlap_size} must lie in (0, "
                         f"{split_size // 2}) for tiles of {split_size}")

    stride = split_size - overlap_size
    tiles_h = math.ceil((h_lq - overlap_size) / stride)
    tiles_w = math.ceil((w_lq - overlap_size) / stride)
    pad_h = tiles_h * stride + overlap_size - h_lq
    pad_w = tiles_w * stride + overlap_size - w_lq
    if pad_h >= h_lq or pad_w >= w_lq:
        raise ValueError(f"tiles of {split_size} pad the {h_lq} x {w_lq} "
                         "image by more than itself: decrease split_size")

    lq_pad = np.pad(lq, ((0, 0), (0, pad_h), (0, pad_w), (0, 0)),
                    mode="reflect")
    tiles = np.stack([lq_pad[0, y:y + split_size, x:x + split_size]
                      for y in range(0, tiles_h * stride, stride)
                      for x in range(0, tiles_w * stride, stride)])

    split_sr = math.ceil(split_size * scale_factor)
    overlap_sr = math.ceil(overlap_size * scale_factor)
    fused = (fea2gs_rope_apply_fused if isinstance(dec, Fea2GSRopeAMP)
             else fea2gs_apply_fused)
    dt = fused_dtype(dec)
    outs = []
    for start in range(0, tiles.shape[0], tile_batch):
        chunk = torch.from_numpy(
            np.ascontiguousarray(tiles[start:start + tile_batch],
                                 np.float32)).to(dev)
        feat = enc(chunk)
        scales = torch.full((chunk.shape[0],), float(scale_factor),
                            dtype=torch.float32, device=dev)
        gs = fused(dec, feat, scales, None if dt == torch.float32 else dt)
        for g in gs:
            img = render_gaussians((split_sr, split_sr), g, scale_factor,
                                   default_step_size=default_step_size,
                                   if_dmax=if_dmax, dmax_mode=dmax_mode,
                                   dmax=dmax, device=dev)
            outs.append(img.permute(1, 2, 0).cpu().numpy())
    return paste_tiles(np.stack(outs), tiles_h, tiles_w,
                       split_sr - overlap_sr, split_sr, crop_size,
                       fractional=scale_factor != int(scale_factor))


def paste_tiles(sr_tiles, tiles_h: int, tiles_w: int, stride_sr: int,
                split_sr: int, crop_size: int, *, fractional: bool):
    """Seam-trimmed tile pasting, the reference's canvas-assembly branches
    (`utils/split_and_joint_image.py:168-225`). sr_tiles: (tiles_h *
    tiles_w, split_sr, split_sr, C), row-major. Returns (1, canvas_h,
    canvas_w, C) float32."""
    canvas_h = (tiles_h - 1) * stride_sr + split_sr
    canvas_w = (tiles_w - 1) * stride_sr + split_sr
    canvas = np.zeros((1, canvas_h, canvas_w, sr_tiles.shape[-1]),
                      np.float32)
    idx = 0
    for i in range(tiles_h):
        for j in range(tiles_w):
            y, x = i * stride_sr, j * stride_sr
            tile = sr_tiles[idx]
            cy = 0 if i == 0 else crop_size
            cx = 0 if j == 0 else crop_size
            y0, x0 = y + cy, x + cx
            y1, x1 = y + split_sr, x + split_sr
            if fractional:
                # trailing tiles clamp to the canvas (reference :178-204);
                # interior writes are unchanged
                last_i = i == tiles_h - 1
                last_j = j == tiles_w - 1
                if last_j and i != 0 and not last_i:
                    # reference quirk (:196-198): last-column interior rows
                    # write without the vertical seam trim
                    y0, cy = y, 0
                y1 = min(y1, canvas_h)
                x1 = min(x1, canvas_w)
            canvas[0, y0:y1, x0:x1] = tile[cy:cy + (y1 - y0),
                                           cx:cx + (x1 - x0)]
            idx += 1
    return canvas
