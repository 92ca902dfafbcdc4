"""Public render(): project -> bin -> gather -> composite (port of
`bags_tpu/raster/render.py`).

  * projection and SH colour: `core/projection.py`, elementwise over N;
  * binning: `binning.py`, one int64-key sort, dynamic instance count;
  * gather: one column gather of the feature-major (10, N) packet table by
    the per-slot Gaussian id;
  * compositing: `composite.composite_fwd`, the CUDA kernel on the card and
    its plain version on the CPU;
  * the background blend stays outside the kernel.

The backward of the compositing kernel is slice 2 of the port, so on the
card render() is forward-only; on the CPU autograd runs through the plain
compositor, and `probe2d` gives the per-Gaussian screen-space gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.camera import CameraParams, CameraStatic, GlobalAlignment
from ..core.projection import Projected, distance_to_camera, project_gaussians
from . import binning, tiles
from .composite import composite_fwd


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    sh_degree: int = 3
    max_instances: Optional[int] = None  # None: no budget, nothing dropped
    sort_by_distance: bool = False       # cubemap variant: camera distance


@dataclasses.dataclass
class RenderOutput:
    render: torch.Tensor      # (3, H, W)
    t_final: torch.Tensor     # (H, W) final transmittance
    depth_map: torch.Tensor   # (H, W) expected depth sum(w_i d_i)
    radii: torch.Tensor       # (N,) int32
    visibility: torch.Tensor  # (N,) bool, radii > 0
    depth: torch.Tensor       # (N,) per-Gaussian view z
    mean2d: torch.Tensor      # (N, 2) projected screen means
    n_dropped: int            # instances past the budget
    gauss_id: torch.Tensor    # (M,) slot -> Gaussian


def build_packet_table(proj: Projected, x2d: torch.Tensor,
                       y2d: torch.Tensor) -> torch.Tensor:
    """(10, N) feature-major packet table, rows in the kernel's order
    mx my | conic a b c | opacity | r g b | depth."""
    return torch.stack([x2d, y2d, proj.conic_a, proj.conic_b, proj.conic_c,
                        proj.opacity, proj.col_r, proj.col_g, proj.col_b,
                        proj.depth], dim=0)


def render(
    xyz: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacity: torch.Tensor,
    sh_coeffs: torch.Tensor,
    cam: CameraParams,
    static: CameraStatic,
    cfg: RenderConfig,
    bg: Optional[torch.Tensor] = None,
    align: Optional[GlobalAlignment] = None,
    probe2d: Optional[torch.Tensor] = None,
    extra_color: Optional[torch.Tensor] = None,
) -> RenderOutput:
    """Render one camera view on the device of `xyz`.

    probe2d: optional (N, 2) zeros added to the projected means; its
    gradient is the per-Gaussian signed screen-space gradient sum.
    """
    if bg is None:
        bg = xyz.new_zeros(3)
    proj = project_gaussians(
        xyz, scales, quats, opacity, sh_coeffs, cam, static, cfg.sh_degree,
        align=align, extra_color=extra_color)

    x2d, y2d = proj.x2d, proj.y2d
    if probe2d is not None:
        x2d = x2d + probe2d[:, 0]
        y2d = y2d + probe2d[:, 1]

    tiles_x, tiles_y = tiles.tile_grid(static.width, static.height)
    sort_key = (distance_to_camera(xyz, cam, align).detach()
                if cfg.sort_by_distance else None)
    bins = binning.bin_gaussians(
        dataclasses.replace(proj, x2d=x2d, y2d=y2d).detach(),
        tiles_x, tiles_y, cfg.max_instances, sort_key_depth=sort_key)

    rows = build_packet_table(proj, x2d, y2d).index_select(1, bins.gauss_id)
    color4, t_final = composite_fwd(rows, bins.tile_start, bins.tile_count,
                                    tiles_x, tiles_y)
    out = color4.transpose(1, 2)                                 # (T, NPIX, 4)
    color = out[..., :3] + t_final[..., None] * bg[None, None, :]
    img = tiles.tiles_to_image(color, tiles_x, tiles_y,
                               static.width, static.height)
    aux = tiles.tiles_to_image(torch.stack([t_final, out[..., 3]], dim=-1),
                               tiles_x, tiles_y, static.width, static.height)
    return RenderOutput(
        render=img,
        t_final=aux[0],
        depth_map=aux[1],
        radii=proj.radius,
        visibility=proj.radius > 0,
        depth=proj.depth,
        mean2d=proj.mean2d,
        n_dropped=bins.n_dropped,
        gauss_id=bins.gauss_id,
    )
