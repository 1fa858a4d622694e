"""Dense normalized-unit reference renderer (counterpart of
`gsasr_tpu/ops/reference.py`).

Pixel (hi, wi) of an (h, w) image sits at ``(2*wi/(w-1) - 1, 2*hi/(h-1) - 1)``;
each Gaussian adds
``exp(-0.5/(1-rho^2) * (dx^2/sx^2 - 2 rho dx dy/(sx sy) + dy^2/sy^2)) * color``
where ``|dx| <= dmax`` and ``|dy| <= dmax``. Dense over pixels, chunked over
Gaussians to bound memory; the oracle the tile rasterizer is held against.
"""

from __future__ import annotations

import torch


def _pixel_axes(h: int, w: int, dtype, device):
    ys = 2.0 * torch.arange(h, dtype=dtype, device=device) / (h - 1) - 1.0
    xs = 2.0 * torch.arange(w, dtype=dtype, device=device) / (w - 1) - 1.0
    return ys, xs


def _render_chunk(sigmas, coords, colors, ys, xs, dmax):
    sx = sigmas[:, 0]  # pairs with dx (the w axis)
    sy = sigmas[:, 1]
    rho = sigmas[:, 2]
    dy = ys[None, :, None] - coords[:, 1][:, None, None]
    dx = xs[None, None, :] - coords[:, 0][:, None, None]
    inv_sx2 = 1.0 / (sx * sx)
    inv_sy2 = 1.0 / (sy * sy)
    rho_term = 2.0 * rho / (sx * sy)
    neg_half = -0.5 / (1.0 - rho * rho)
    quad = (inv_sx2[:, None, None] * dx * dx
            - rho_term[:, None, None] * dx * dy
            + inv_sy2[:, None, None] * dy * dy)
    v = torch.exp(neg_half[:, None, None] * quad)
    mask = (dx.abs() <= dmax) & (dy.abs() <= dmax)
    v = torch.where(mask, v, torch.zeros((), dtype=v.dtype, device=v.device))
    return torch.einsum("shw,sc->hwc", v, colors)


def gs_render_reference(sigmas, coords, colors, image_size, dmax=100.0,
                        chunk: int = 4096):
    """Dense reference 2D Gaussian splatting.

    sigmas (S, 3) [sigma_x, sigma_y, rho] and coords (S, 2) [x, y] in
    normalized kernel units, colors (S, C); returns (h, w, C)."""
    h, w = int(image_size[0]), int(image_size[1])
    ys, xs = _pixel_axes(h, w, sigmas.dtype, sigmas.device)
    out = torch.zeros((h, w, colors.shape[-1]), dtype=sigmas.dtype,
                      device=sigmas.device)
    for s0 in range(0, sigmas.shape[0], chunk):
        sl = slice(s0, s0 + chunk)
        out = out + _render_chunk(sigmas[sl], coords[sl], colors[sl], ys, xs,
                                  dmax)
    return out
