"""Public render(): project -> bin -> gather -> composite (port of
`bags_tpu/raster/render.py`).

  * projection and SH colour: `core/projection.py`, elementwise over N;
  * binning: `binning.py`, one int64-key sort, dynamic instance count;
  * gather: one column gather of the feature-major (10, N) packet table by
    the per-slot Gaussian id; its backward reduces the per-instance
    gradients to Gaussians with one `index_add_` (the JAX package's MXU
    segment sum, `raster/segsum.py`, is not ported);
  * compositing: `composite.composite_fwd`, the CUDA kernels (forward and
    backward) on the card and the plain version on the CPU;
  * the background blend stays outside the kernel.

`probe2d` gives the per-Gaussian signed screen-space gradient and
`abs_probe` the per-Gaussian sum of |per-instance screen gradient| (the
densification statistics).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.camera import CameraParams, CameraStatic, GlobalAlignment
from ..core.projection import Projected, distance_to_camera, project_gaussians
from ..utils.spans import span
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


class _GatherRowsAbs(torch.autograd.Function):
    """Column gather whose backward also harvests the abs channel: the
    per-Gaussian sums of |d mx| and |d my| over the Gaussian's instances
    (the fork's `means2D_densify`), in the same `index_add_` pass."""

    @staticmethod
    def forward(ctx, table, abs_probe, gauss_id):
        ctx.save_for_backward(gauss_id)
        ctx.n = table.shape[1]
        return table.index_select(1, gauss_id)

    @staticmethod
    def backward(ctx, d_rows):
        (gauss_id,) = ctx.saved_tensors
        aug = torch.cat([d_rows, d_rows[0:2].abs()])                  # (12, M)
        by_gauss = aug.new_zeros((aug.shape[0], ctx.n)).index_add_(
            1, gauss_id, aug)
        return by_gauss[:-2], by_gauss[-2:].t(), None


def gather_rows(table: torch.Tensor, abs_probe: Optional[torch.Tensor],
                gauss_id: torch.Tensor) -> torch.Tensor:
    """(10, N) packet table -> (10, M) instance rows by `gauss_id`.

    abs_probe (N, 2) or None: inert in the forward; its gradient is the
    per-Gaussian sum of |d row[0:2]|. None keeps the plain `index_select`.
    """
    if abs_probe is None:
        return table.index_select(1, gauss_id)
    return _GatherRowsAbs.apply(table, abs_probe, gauss_id)


def rasterize(proj: Projected, width: int, height: int, bg: torch.Tensor,
              max_instances: Optional[int],
              abs_probe: Optional[torch.Tensor] = None, y0: int = 0,
              sort_key: Optional[torch.Tensor] = None):
    """Bin, gather and composite projected Gaussians over the tiles of a
    width x height image whose first pixel row is y0 of the view (a slab
    of a taller view, `dist/sharded.py`), the background blended; each
    stage under its span ("binning", "gather", "composite").

    proj: its x2d / y2d as the tiles see them (a densify probe added);
    abs_probe: as in `gather_rows`; sort_key: optional per-Gaussian sort
    depth (`binning.bin_gaussians`). Returns (image (3, height, width),
    (t_final, depth) (2, height, width), the binning)."""
    tiles_x, tiles_y = tiles.tile_grid(width, height)
    if y0:
        proj = dataclasses.replace(proj, y2d=proj.y2d - float(y0))
    with span("binning"):
        bins = binning.bin_gaussians(proj.detach(), tiles_x, tiles_y,
                                     max_instances, sort_key_depth=sort_key)
    with span("gather"):
        rows = gather_rows(build_packet_table(proj, proj.x2d, proj.y2d),
                           abs_probe, bins.gauss_id)
    with span("composite"):
        color4, t_final = composite_fwd(rows, bins.tile_start,
                                        bins.tile_count, tiles_x, tiles_y)
        out = color4.transpose(1, 2)                             # (T, NPIX, 4)
        color = out[..., :3] + t_final[..., None] * bg[None, None, :]
        img = tiles.tiles_to_image(color, tiles_x, tiles_y, width, height)
        aux = tiles.tiles_to_image(torch.stack([t_final, out[..., 3]], dim=-1),
                                   tiles_x, tiles_y, width, height)
    return img, aux, bins


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
    abs_probe: Optional[torch.Tensor] = None,
    extra_color: Optional[torch.Tensor] = None,
    shift_factors: Optional[torch.Tensor] = None,
) -> RenderOutput:
    """Render one camera view on the device of `xyz`, under the span
    "render": "projection" (the projection, the probe and the sort key),
    then `rasterize`'s.

    probe2d: optional (N, 2) zeros added to the projected means; its
    gradient is the per-Gaussian signed screen-space gradient sum.
    abs_probe: optional (N, 2) zeros; its gradient is the per-Gaussian sum
    of per-instance |screen gradients|.
    shift_factors: optional (3,) entrance-pupil shift (`project_gaussians`).
    """
    with span("render"):
        if bg is None:
            bg = xyz.new_zeros(3)
        with span("projection"):
            proj = project_gaussians(
                xyz, scales, quats, opacity, sh_coeffs, cam, static,
                cfg.sh_degree, align=align, extra_color=extra_color,
                shift_factors=shift_factors)
            seen = proj if probe2d is None else dataclasses.replace(
                proj, x2d=proj.x2d + probe2d[:, 0], y2d=proj.y2d + probe2d[:, 1])
            sort_key = (distance_to_camera(xyz, cam, align).detach()
                        if cfg.sort_by_distance else None)
            visibility = proj.radius > 0
        img, aux, bins = rasterize(seen, static.width, static.height, bg,
                                   cfg.max_instances, abs_probe,
                                   sort_key=sort_key)
        return RenderOutput(
            render=img,
            t_final=aux[0],
            depth_map=aux[1],
            radii=proj.radius,
            visibility=visibility,
            depth=proj.depth,
            mean2d=proj.mean2d,
            n_dropped=bins.n_dropped,
            gauss_id=bins.gauss_id,
        )
