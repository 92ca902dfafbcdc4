"""Naive per-pixel compositing over all Gaussians (port of
`bags_tpu/raster/reference.py`) — the oracle for the tiled path, used by
the tests only. O(pixels x Gaussians): tiny scenes only.

  alpha = min(0.99, opacity * exp(-0.5 d^T conic d)), skipped if < 1/255
  front-to-back by view depth; a Gaussian whose blend would push T below
  1e-4 is excluded, and so is everything behind it
  C = sum c_i alpha_i T_i + T_final * bg
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.camera import CameraParams, CameraStatic, GlobalAlignment
from ..core.projection import Projected, project_gaussians
from .tiles import ALPHA_MAX, ALPHA_MIN, T_EPS


def composite_pixels(proj: Projected, pix_x: torch.Tensor, pix_y: torch.Tensor,
                     bg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Composite all Gaussians, depth-sorted here, at pixels (P,).
    Returns (color (P, 3), T (P,))."""
    order = torch.argsort(proj.depth, stable=True)
    mean2d = proj.mean2d[order]
    conic = proj.conic[order]
    color = proj.color[order]
    opacity = proj.opacity[order]
    radius = proj.radius[order]

    dx = pix_x[None, :] - mean2d[:, 0:1]                 # (N, P)
    dy = pix_y[None, :] - mean2d[:, 1:2]
    power = -0.5 * (conic[:, 0:1] * dx * dx + conic[:, 2:3] * dy * dy) \
        - conic[:, 1:2] * dx * dy
    alpha = torch.clamp(opacity[:, None] * torch.exp(power), max=ALPHA_MAX)
    valid = (alpha >= ALPHA_MIN) & (power <= 0.0) & (radius[:, None] > 0)
    a = torch.where(valid, alpha, torch.zeros_like(alpha))

    one_minus = 1.0 - a
    t_before = torch.cat([torch.ones_like(a[:1]),
                          torch.cumprod(one_minus, dim=0)[:-1]], dim=0)
    kill = valid & (t_before * one_minus < T_EPS)
    done_before = torch.cumsum(kill.to(torch.int32), dim=0) > 0
    include = valid & ~done_before

    a_inc = torch.where(include, a, torch.zeros_like(a))
    one_minus_inc = 1.0 - a_inc
    t_before_inc = torch.cat([torch.ones_like(a[:1]),
                              torch.cumprod(one_minus_inc, dim=0)[:-1]], dim=0)
    w = a_inc * t_before_inc
    out = torch.einsum("np,nc->pc", w, color)
    t_final = torch.prod(one_minus_inc, dim=0)
    return out + t_final[:, None] * bg[None, :], t_final


def render_reference(
    xyz, scales, quats, opacity, sh_coeffs,
    cam: CameraParams, static: CameraStatic, sh_degree: int,
    bg: Optional[torch.Tensor] = None,
    align: Optional[GlobalAlignment] = None,
) -> dict:
    """Render a full image the naive way; 'render' is (3, H, W)."""
    if bg is None:
        bg = xyz.new_zeros(3)
    proj = project_gaussians(xyz, scales, quats, opacity, sh_coeffs, cam,
                             static, sh_degree, align=align)
    ys = torch.arange(static.height, dtype=torch.float32, device=xyz.device)
    xs = torch.arange(static.width, dtype=torch.float32, device=xyz.device)
    Y, X = torch.meshgrid(ys, xs, indexing="ij")
    out, t_final = composite_pixels(proj, X.reshape(-1), Y.reshape(-1), bg)
    return {
        "render": out.reshape(static.height, static.width, 3).permute(2, 0, 1),
        "T_final": t_final.reshape(static.height, static.width),
        "radii": proj.radius,
        "depth_gaussians": proj.depth,
    }
