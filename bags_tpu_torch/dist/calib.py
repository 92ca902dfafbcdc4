"""The calibrated modes tile-parallel over `torch.distributed` ranks (port
of `bags_tpu/dist/calib.py`, its gather path), one program per rank.

Fisheye (`--outside_rasterizer`), apply-to-render: each rank renders its
slab of the extended-FoV view as the pose path does (`sharded.render_slab`),
and one all-gather of the slabs (`mesh.all_gather_image_rows`) gives every
rank the whole perspective frame, since the lens warp taps it anywhere.
Each rank then warps the frame and keeps its own rows of the fisheye
output (`fisheye_warp_rows`), nr = ceil(fh / D) rows a rank, which are not
tile-aligned, applies the vignetting computed at the true fisheye size,
and takes the 5-row halo loss of its rows against its rows of the
fisheye GT (`sharded.halo_slab_loss`, true height fh). With `--apply2gt`
each rank warps only its band of the replicated fisheye GT into its render
slab's rows (`gt_warp_rows`, the slab's tile rows, true height the
render's): no image-sized collective at all.

Cubemap (`--cubemap`): the ray field of the cubemap net on every rank,
then for each of the five faces (sorted by distance; the densify probes on
the main face only) a slab render, one image all-gather, the 90-degree
square mask, this rank's rows of the face's warp, and the face's masked
halo loss; the five losses add up to the single-device objective.

Each rank backpropagates its own partial loss; the image all-gather's
backward reduce-scatters the frame's gradient onto the rows' owners and
the packet's brings each Gaussian's gradients home. The replicated
tensors' gradients are per-rank parts that ONE all-reduce sums: the camera
row, the lens (within its window), vignetting, shift, the cubemap net and,
with `--hybrid`, the specular MLP; the NaN guards then run on the sums, so
every rank takes the same decision. The optimizer steps are the
single-device steps' own (`train/calibrated.py::fisheye_optimizers`,
`cubemap_optimizers`).

`--hybrid` in the fisheye mode adds the specular colour here, as the
port's single-device step does; the JAX package's sharded fisheye step
leaves it out (`bags_tpu/dist/calib.py:220`, ROADMAP.md Queue 3). The
banded warp (`warp_ky`) is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.nn.functional as F

from ..calib import cubemap as cubemap_lib
from ..calib import distortion as dist_lib
from ..calib.vignetting import vignetting_mask
from ..core.camera import CameraStatic
from ..raster.render import RenderConfig
from ..raster.tiles import TILE_H
from ..train.calibrated import (CalibState, CubemapSetup, FisheyeSetup,
                                _half_masks, _proj_scale, begin_cubemap_step,
                                begin_fisheye_step, cubemap_optimizers,
                                face_cameras, fisheye_optimizers,
                                fisheye_replicated)
from ..train.config import TrainConfig
from ..train.loop import StepMetrics, extra_color, sample_views
from ..utils.image import grid_sample
from .mesh import (all_gather_image_rows, all_reduce_sum, rank_world,
                   row_block, tiles_y_local)
from .sharded import halo_slab_loss, render_slab, total_loss


def _pad_rows(x: torch.Tensor, rows: int, dim: int) -> torch.Tensor:
    """x zero-padded at the end of dimension `dim` to `rows` rows."""
    extra = rows - x.shape[dim]
    if extra <= 0:
        return x
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, extra]
    return F.pad(x, pad)


def fisheye_warp_rows(lens, p_view, grid_hw, image, proj_scale, flow_hw,
                      fish_hw, fh_pad: int, row0: int, n_rows: int):
    """Rows [row0, row0 + n_rows) of `apply_distortion(...)`'s fisheye
    output and mask (apply-to-render, with the centre crop where the flow
    is larger than the fisheye frame) from the whole perspective `image`
    (3, H, W) (`_fisheye_warp_rows`, calib.py:55): the whole warp, its rows
    zero-padded to fh_pad >= row0 + n_rows (rows past the true fisheye
    height are masked out and the caller's loss drops them). Every rank
    computes the whole frame's flow anyway; the whole warp's one
    `grid_sample` beside it is cheap, and slicing it keeps the crop's
    rounding the single-device step's own."""
    warped, mask, _ = dist_lib.apply_distortion(lens, p_view, grid_hw, image,
                                                proj_scale, flow_hw,
                                                final_hw=fish_hw)
    rows = slice(row0, row0 + n_rows)
    return _pad_rows(warped, fh_pad, 1)[:, rows], _pad_rows(mask, fh_pad, 1)[:, rows]


def gt_warp_rows(lens, p_view, grid_hw, fish_gt, proj_scale, flow_hw,
                 h_pad: int, row0: int, n_rows: int):
    """Rows [row0, row0 + n_rows) of the `--apply2gt` warp and its mask
    (`apply_distortion(..., apply2gt=True)`: the fisheye GT into the
    perspective frame, no crop; `_gt_warp_rows`, calib.py:158): the flow of
    the whole frame, its rows padded to h_pad, and `grid_sample` of the
    replicated GT at this band. The mask is the near-zero test (< 1e-5)."""
    flow = dist_lib.compute_flow(lens, p_view, grid_hw, proj_scale, flow_hw,
                                 sensor_to_frustum=True)
    warped = grid_sample(fish_gt, _pad_rows(flow, h_pad, 0)[row0:row0 + n_rows])
    return warped, dist_lib.warp_mask(warped, True)


def fisheye_gt_rows(fish_gt: torch.Tensor, apply2gt: bool) -> torch.Tensor:
    """The fisheye step's GT on this rank: its rows of `fish_gt` (3, fh, fw)
    zero-padded to D ceil(fh / D) rows, or with `--apply2gt` all of it
    (each rank warps its band from anywhere in it)."""
    if apply2gt:
        return fish_gt
    rank, d = rank_world()
    n = -(-fish_gt.shape[-2] // d)
    return _pad_rows(fish_gt, n * d, 1)[:, rank * n:(rank + 1) * n]


def _vignetting_rows(state: CalibState, height: int, width: int, h_pad: int,
                     row0: int, n_rows: int) -> torch.Tensor:
    """Rows of the vignetting mask computed at its true size (1, n, w)."""
    mask = _pad_rows(vignetting_mask(state.vig, height, width), h_pad, 0)
    return mask[row0:row0 + n_rows][None]


def _reduce(state: CalibState, views, calib_tensors: List[torch.Tensor],
            sums: List[torch.Tensor], n_dropped: int) -> torch.Tensor:
    """Sum over the ranks, in place, every replicated tensor's gradient
    (the views' camera rows, `calib_tensors`, the specular MLP's) with one
    all-reduce, then the loss sums, the instances dropped and the live
    count with another (float64). Returns the second."""
    b = state.base
    replicated = [v.row[f] for v in views for f in sorted(v.row)] + calib_tensors
    if b.spec is not None:
        replicated += list(b.spec.named_tensors().values())
    for t in replicated:
        if t.grad is None:
            t.grad = torch.zeros_like(t)
    all_reduce_sum([t.grad for t in replicated])
    scalars = torch.cat([torch.stack(sums).to(torch.float64), torch.tensor(
        [float(n_dropped)], dtype=torch.float64, device=sums[0].device),
        b.alive.sum().to(torch.float64).reshape(1)])
    all_reduce_sum([scalars])
    return scalars


def sharded_fisheye_step(state: CalibState, fish_gt: torch.Tensor,
                         p_view: torch.Tensor, cam_idx: int, bg: torch.Tensor,
                         setup: FisheyeSetup, rcfg: RenderConfig,
                         cfg: TrainConfig, schedules, opt_lens: bool,
                         use_vignetting: bool) -> StepMetrics:
    """One tile-parallel fisheye step on camera `cam_idx`
    (`make_sharded_fisheye_step`, calib.py:192; the port's
    `fisheye_train_step` over the ranks); `state` holds this rank's block
    of the Gaussians and the replicated rest. fish_gt: this rank's
    `fisheye_gt_rows` of the fisheye GT. Returns the whole step's loss,
    live count and instances dropped; the image is this rank's rows of
    what the loss compared, the Gaussian gradients its block's."""
    rank, d = rank_world()
    calib = cfg.calib
    b = state.base
    static = setup.render_static
    lam = cfg.opt.lambda_dssim
    view = sample_views(b, [cam_idx], b.capacity)[0]
    begin_fisheye_step(state, opt_lens)
    r = render_slab(b.g, b.alive, view.cam, static, rcfg, bg, align=b.align,
                    probe2d=view.probe, abs_probe=view.absp,
                    extra=extra_color(b, view.cam),
                    shift=state.shift if calib.opt_shift else None)
    ps = _proj_scale(view.cam)
    if not calib.apply2gt:
        fh, fw = setup.fish_hw
        n_rows = -(-fh // d)
        row0 = rank * n_rows
        image = all_gather_image_rows(r.slab)[:, :static.height]
        pred, mask = fisheye_warp_rows(state.lens, p_view, setup.grid_hw,
                                       image, ps, setup.flow_hw, setup.fish_hw,
                                       n_rows * d, row0, n_rows)
        if use_vignetting:
            mask = mask * _vignetting_rows(state, fh, fw, n_rows * d, row0, n_rows)
        gt = fish_gt if calib.no_distortion_mask else fish_gt * mask
        true_height, width = fh, fw
    else:
        n_rows, row0 = r.slab.shape[1], r.y0
        gt, mask = gt_warp_rows(state.lens, p_view, setup.grid_hw, fish_gt, ps,
                                setup.flow_hw, n_rows * d, row0, n_rows)
        if use_vignetting:
            mask = mask * _vignetting_rows(state, static.height, static.width,
                                           n_rows * d, row0, n_rows)
        pred = r.slab if calib.no_distortion_mask else r.slab * mask
        true_height, width = static.height, static.width
    partial, l1_sum, ssim_sum = halo_slab_loss(pred, gt, row0, true_height, lam)
    b.g_opt.zero_grad()
    partial.backward()

    scalars = _reduce(state, [view], fisheye_replicated(
        state, cfg, opt_lens, use_vignetting), [l1_sum, ssim_sum], r.n_dropped)
    rows = row_block(b.capacity * d, rank, d)
    grads = fisheye_optimizers(state, cfg, [view], cam_idx, schedules, opt_lens,
                               use_vignetting, [r.radii[rows]])
    loss = total_loss(scalars[0], scalars[1], CameraStatic(width, true_height),
                      lam).to(torch.float32)
    return StepMetrics(loss=loss, l1=loss, n_alive=scalars[3].to(torch.int64),
                       n_dropped=int(scalars[2]), image=pred.detach(),
                       grads=grads)


def sharded_cubemap_step(state: CalibState, gt: torch.Tensor, cam_idx: int,
                         bg: torch.Tensor, sub_q: torch.Tensor,
                         sub_t: torch.Tensor, setup: CubemapSetup,
                         rcfg: RenderConfig, cfg: TrainConfig,
                         schedules) -> StepMetrics:
    """One tile-parallel cubemap step on camera `cam_idx`
    (`make_sharded_cubemap_step`, calib.py:376; the port's
    `cubemap_train_step` over the ranks). gt: this rank's slab of the
    perspective GT, its tile rows zero-padded as the pose path pads them.
    Five slab renders sorted by distance, the probes on the main one, the
    radii from it; each face's image all-gather, mask, warp rows and halo
    loss. Returns the whole step's loss, live count and instances dropped
    over the faces; the image is this rank's rows of the main face."""
    rank, d = rank_world()
    b = state.base
    static = setup.static
    h, w = static.height, static.width
    rcfg = dataclasses.replace(rcfg, sort_by_distance=True)
    lam = cfg.opt.lambda_dssim
    n_rows = tiles_y_local(static, d) * TILE_H
    row0 = rank * n_rows
    view = begin_cubemap_step(state, cam_idx)
    extra = extra_color(b, view.cam)
    rays = cubemap_lib.distorted_rays(state.cubemap_net, setup.K, w, h,
                                      setup.scale)
    partial, sums, n_dropped = 0.0, [], 0
    for i, (face, cam, half) in enumerate(zip(
            cubemap_lib.FACES, face_cameras(view.cam, sub_q, sub_t),
            _half_masks(setup.circ))):
        main = i == 0
        r = render_slab(b.g, b.alive, cam, static, rcfg, bg, align=b.align,
                        probe2d=view.probe if main else None,
                        abs_probe=view.absp if main else None, extra=extra)
        img = all_gather_image_rows(r.slab)[:, :h] * setup.mask90
        grid = cubemap_lib.face_grid(setup.K, rays, face, h, w, (h, w))
        warped = grid_sample(img, _pad_rows(grid, n_rows * d, 0)[row0:row0 + n_rows])
        mask = _pad_rows(setup.circ * half, n_rows * d, 1)[:, row0:row0 + n_rows]
        p, l1_sum, ssim_sum = halo_slab_loss(warped * mask, gt * mask, row0, h, lam)
        partial = partial + p
        sums += [l1_sum, ssim_sum]
        n_dropped += r.n_dropped
        if main:
            radii, image = r.radii, warped.detach()
    b.g_opt.zero_grad()
    partial.backward()

    scalars = _reduce(state, [view], list(state.cubemap_net.named_tensors(
        trained_only=True).values()), sums, n_dropped)
    rows = row_block(b.capacity * d, rank, d)
    grads = cubemap_optimizers(state, cfg, view, cam_idx, schedules, radii[rows])
    loss = sum(total_loss(scalars[2 * i], scalars[2 * i + 1], static, lam)
               for i in range(len(cubemap_lib.FACES)))
    n = 2 * len(cubemap_lib.FACES)
    return StepMetrics(loss=loss.to(torch.float32), l1=loss.to(torch.float32),
                       n_alive=scalars[n + 1].to(torch.int64),
                       n_dropped=int(scalars[n]), image=image,
                       grads=grads)
