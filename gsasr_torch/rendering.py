"""Rendering orchestration: raw decoder outputs -> rendered SR image
(counterpart of `gsasr_tpu/rendering.py`): single images for inference and
slot-stacked training batches on one canvas, differentiable in the decoder
outputs.

- activations: sigma = 0.99999 * sigmoid(p) + 1e-6, rho = 0.999999 * tanh(p),
  colors = sigmoid(rgb) * sigmoid(alpha), coords = 2 * p - 1;
- step size = default_step_size / scale;
- kernel units: kernel sigma_x (w axis) = sigma_y / step * 2 / (W - 1) and
  kernel sigma_y (h axis) = sigma_x / step * 2 / (H - 1) (the x/y swap of the
  reference CUDA kernel), centers remapped from align-corners-False to the
  pixel-center grid;
- dmax 'fix' passes dmax through, 'dynamic' uses (dmax + 2) / min(H, W).
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch

from gsasr_torch import resolve_device
from gsasr_torch.ops.rasterizer import (GEOM_COLS, chunk_geometry,
                                         gs_render_px, pack_geometry,
                                         raster_fwd)
from gsasr_torch.ops.reference import gs_render_reference

DEFAULT_STEP_SIZE = 1.2


@functools.lru_cache(maxsize=64)
def _static_lattice_perm(lat_h: int, lat_w: int, sr_h: int, sr_w: int,
                         th: int = 32, tw: int = 128):
    """Static tile-coherent permutation of decoder outputs.

    Decoder Gaussian i anchors at lattice cell (i // lat_w, i % lat_w), near
    pixel ((row+.5)/lat_h*sr_h, (col+.5)/lat_w*sr_w); sorting by the tile of
    that anchor gives chunk locality without a runtime sort. The cull boxes
    keep the render exact in any order."""
    n = lat_h * lat_w
    rows = np.arange(n) // lat_w
    cols = np.arange(n) % lat_w
    py = ((rows + 0.5) / lat_h * sr_h).astype(np.int64)
    px = ((cols + 0.5) / lat_w * sr_w).astype(np.int64)
    key = (py // th) * (-(-sr_w // tw)) + (px // tw)
    return np.argsort(key, kind="stable")


@functools.lru_cache(maxsize=64)
def _device_lattice_perm(lat_h: int, lat_w: int, sr_h: int, sr_w: int,
                         device: torch.device) -> torch.Tensor:
    """`_static_lattice_perm` as an index tensor on `device`, copied there
    once per shape, as the JAX side bakes it in as a constant."""
    return torch.from_numpy(
        _static_lattice_perm(lat_h, lat_w, sr_h, sr_w)).to(device)


def gs_activations(gs_parameters):
    """(N, 9) raw outputs -> (sigma_x, sigma_y, rho, coords (N, 2),
    colors_with_alpha (N, 3))."""
    sigma_x = 0.99999 * torch.sigmoid(gs_parameters[:, 0]) + 1e-6
    sigma_y = 0.99999 * torch.sigmoid(gs_parameters[:, 1]) + 1e-6
    rho = 0.999999 * torch.tanh(gs_parameters[:, 2])
    alpha = torch.sigmoid(gs_parameters[:, 3:4])
    colors = torch.sigmoid(gs_parameters[:, 4:7])
    coords = gs_parameters[:, 7:9] * 2.0 - 1.0
    return sigma_x, sigma_y, rho, coords, colors * alpha


def to_kernel_units(sigma_x, sigma_y, rho, coords, sr_size, step_size):
    """Physical units -> rasterizer units, with the x/y swap and the
    align-corners remap of centers. sr_size and step_size are numbers, or
    tensors with one value per Gaussian (a slot-stacked training batch)."""
    sr_h, sr_w = sr_size
    ksig_x = sigma_y / step_size * 2.0 / (sr_w - 1)
    ksig_y = sigma_x / step_size * 2.0 / (sr_h - 1)
    sigmas = torch.stack([ksig_x, ksig_y, rho], dim=-1)
    cx = (coords[:, 0] + 1.0 - 1.0 / sr_w) * sr_w / (sr_w - 1) - 1.0
    cy = (coords[:, 1] + 1.0 - 1.0 / sr_h) * sr_h / (sr_h - 1) - 1.0
    return sigmas, torch.stack([cx, cy], dim=-1)


def resolve_dmax(dmax, dmax_mode: str, sr_size):
    if dmax_mode == "dynamic":
        return (dmax + 2.0) / min(int(sr_size[0]), int(sr_size[1]))
    if dmax_mode == "fix":
        return dmax
    raise ValueError(f"dmax_mode '{dmax_mode}' must be 'fix' or 'dynamic'")


def prepare_kernel_inputs(sr_size, gs_parameters, scale, *,
                          default_step_size: float = DEFAULT_STEP_SIZE,
                          if_dmax: bool = True, dmax_mode: str = "fix",
                          dmax: float = 25.0):
    """Activations, kernel units and dmax: (sigmas, kcoords, colors,
    final_dmax). Rendering is always float32."""
    sr = (int(sr_size[0]), int(sr_size[1]))
    gs_parameters = gs_parameters.to(torch.float32)
    step_size = default_step_size / scale
    sigma_x, sigma_y, rho, coords, colors = gs_activations(gs_parameters)
    sigmas, kcoords = to_kernel_units(sigma_x, sigma_y, rho, coords, sr,
                                      step_size)
    final_dmax = resolve_dmax(dmax, dmax_mode, sr) if if_dmax else 100.0
    return sigmas, kcoords, colors, final_dmax


def raster_inputs(sr_size, gs_parameters, scale, *,
                  default_step_size: float = DEFAULT_STEP_SIZE,
                  if_dmax: bool = True, dmax_mode: str = "fix",
                  dmax: float = 25.0, static_perm: bool = True,
                  lat_hw=None):
    """(geom, colors, bbox) that `render_gaussians` hands to the tile
    rasterizer for (N, 9) raw decoder outputs.

    static_perm reorders the Gaussians by their lattice anchors (lat_hw,
    inferred for square N) instead of a runtime sort; neither order changes
    the result beyond summation order."""
    sr_size = (int(sr_size[0]), int(sr_size[1]))
    n = gs_parameters.shape[0]
    if lat_hw is None and math.isqrt(n) ** 2 == n:
        lat_hw = (math.isqrt(n), math.isqrt(n))
    use_static_perm = (static_perm and lat_hw is not None
                       and lat_hw[0] * lat_hw[1] == n)
    if use_static_perm:
        gs_parameters = gs_parameters[_device_lattice_perm(
            int(lat_hw[0]), int(lat_hw[1]), sr_size[0], sr_size[1],
            gs_parameters.device)]
    sigmas, kcoords, colors, final_dmax = prepare_kernel_inputs(
        sr_size, gs_parameters, scale, default_step_size=default_step_size,
        if_dmax=if_dmax, dmax_mode=dmax_mode, dmax=dmax)
    geom = pack_geometry(sigmas, kcoords, sr_size, final_dmax)
    return chunk_geometry(geom, colors, sr_size,
                          spatial_sort=not use_static_perm)


def render_gaussians(sr_size: Sequence[int], gs_parameters, scale, *,
                     default_step_size: float = DEFAULT_STEP_SIZE,
                     if_dmax: bool = True, dmax_mode: str = "fix",
                     dmax: float = 25.0, use_kernel: bool = True,
                     static_perm: bool = True, lat_hw=None, device=None):
    """Render (N, 9) raw decoder outputs at sr_size: (3, H, W) float32.

    use_kernel renders with the tile rasterizer (see `raster_inputs` for
    static_perm and lat_hw), otherwise with the dense reference. Runs on
    `device` (default: the CUDA card)."""
    dev = resolve_device(device)
    gs_parameters = torch.as_tensor(gs_parameters).to(dev)
    sr_size = (int(sr_size[0]), int(sr_size[1]))
    kw = dict(default_step_size=default_step_size, if_dmax=if_dmax,
              dmax_mode=dmax_mode, dmax=dmax)
    if use_kernel:
        img = raster_fwd(*raster_inputs(sr_size, gs_parameters, scale,
                                        static_perm=static_perm,
                                        lat_hw=lat_hw, **kw), *sr_size)
    else:
        sigmas, kcoords, colors, final_dmax = prepare_kernel_inputs(
            sr_size, gs_parameters, scale, **kw)
        img = gs_render_reference(sigmas, kcoords, colors, sr_size,
                                  final_dmax)
    return img.permute(2, 0, 1)


def training_batch_geometry(gs_parameters, scales, gt_h, gt_w, canvas_hw, *,
                            default_step_size: float = DEFAULT_STEP_SIZE,
                            if_dmax: bool = True, dmax_mode: str = "fix",
                            dmax: float = 25.0):
    """Slot-stacked pixel-unit geometry for a training batch.

    Sample i renders into rows [i*Hmax, i*Hmax + gt_h[i]) and columns
    [0, gt_w[i]) of one (B*Hmax, Wmax) canvas: its effective size
    (gt_h[i], gt_w[i]) is folded into the pixel-unit parameters and its
    cull boxes are clamped to that region, so nothing bleeds between
    samples and pixels beyond the size stay zero.

    gs_parameters (B, N, 9) raw decoder outputs; scales, gt_h, gt_w (B,)
    tensors. Returns (geoms (B, N, 16), colors (B, N, 3))."""
    b, n, _ = gs_parameters.shape
    hmax = int(canvas_hw[0])
    dev = gs_parameters.device
    g = gs_parameters.to(torch.float32).reshape(b * n, 9)

    def rows(x):  # (B,) per-sample value -> (B*N,) per-Gaussian
        x = torch.as_tensor(x, device=dev).to(torch.float32)
        return x[:, None].expand(b, n).reshape(-1)

    h_f, w_f = rows(gt_h), rows(gt_w)
    step_size = default_step_size / rows(scales)
    sigma_x, sigma_y, rho, coords, colors = gs_activations(g)
    sigmas, kcoords = to_kernel_units(sigma_x, sigma_y, rho, coords,
                                      (h_f, w_f), step_size)
    if not if_dmax:
        d = 100.0
    elif dmax_mode == "dynamic":
        d = (dmax + 2.0) / torch.minimum(h_f, w_f)
    else:
        d = dmax
    lo = rows(torch.arange(b, device=dev)) * hmax
    hi = lo + torch.clamp(h_f, 0.0, float(hmax)) - 1.0
    geom = pack_geometry(sigmas, kcoords, (h_f, w_f), d, y_offset=lo,
                         y_slot=(lo, hi), x_slot=(0.0, w_f - 1.0))
    return geom.reshape(b, n, GEOM_COLS), colors.reshape(b, n, 3)


def render_training_batch(gs_parameters, scales, gt_h, gt_w, canvas_hw, *,
                          default_step_size: float = DEFAULT_STEP_SIZE,
                          if_dmax: bool = True, dmax_mode: str = "fix",
                          dmax: float = 25.0):
    """Render a training batch on one slot-stacked (B*Hmax, Wmax) canvas
    (see `training_batch_geometry`), differentiable in gs_parameters.

    Returns (B, Hmax, Wmax, 3) float32; rows and columns beyond
    (gt_h[i], gt_w[i]) are 0."""
    b, n, _ = gs_parameters.shape
    hmax, wmax = int(canvas_hw[0]), int(canvas_hw[1])
    geoms, colors = training_batch_geometry(
        gs_parameters, scales, gt_h, gt_w, canvas_hw,
        default_step_size=default_step_size, if_dmax=if_dmax,
        dmax_mode=dmax_mode, dmax=dmax)
    canvas = gs_render_px(geoms.reshape(b * n, GEOM_COLS),
                          colors.reshape(b * n, 3), (b * hmax, wmax))
    return canvas.reshape(b, hmax, wmax, 3)
