"""Tile-parallel render, loss and train step (port of
`bags_tpu/dist/sharded.py`), one program per `torch.distributed` rank.

Forward, on each rank (`render_slab`):
  1. project this rank's own C / D Gaussian rows (EWA + SH, and with
     `--hybrid` their specular colour, folded into the colour rows), the
     block's densify probe added to the projected means;
  2. all-gather the packets (`mesh.all_gather_cols_grad`, feature-major):
     15 floats per Gaussian (the 10 packet rows, the block's abs probe
     (zeros), the radius and the binning rect, the last three small
     integers carried exactly as floats);
  3.-4. the single-device render's `raster/render.rasterize` on the
     gathered rows over the rank's own slab of `tiles_y_local` tile rows,
     the projected y moved by the slab's first pixel row (projection keeps
     the true image height, so the pixel mapping does not change): the
     binning and the compositing kernels on the slab's own tile grid (the
     CUDA kernels on the card, the plain version on the CPU).
The loss (`halo_slab_loss`) exchanges 5-row halos with the two neighbours
for the SSIM window and sums three scalars over the ranks.

Backward: each rank calls `backward()` on its OWN partial loss (its slab's
sums over the whole image's pixel count, plus its block's share of the MCMC
regularisers). The packet all-gather's backward reduce-scatters the
per-Gaussian gradients onto their owners, so the Gaussian gradients and
both densify probes' come out whole on the owning rank; the gradients of
the replicated tensors (the camera rows, the alignment, the specular MLP)
are per-rank parts, which one all-reduce sums (`sharded_train_step`).
Calling `backward()` on the all-reduced total instead would count every
gradient D times.

The JAX package's sharded Pallas call passes `fast=` where the kernel takes
`terms` (sharded.py:152-154); the port's slab goes through the same
kernels as the single-device render.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.camera import CameraParams, CameraStatic, GlobalAlignment
from ..core.projection import Projected, distance_to_camera, project_gaussians
from ..model.gaussians import Gaussians
from ..raster.render import RenderConfig, rasterize
from ..raster.tiles import TILE_H
from ..train.config import TrainConfig
from ..train.loop import (StepMetrics, TrainState, accumulate_stats,
                          extra_color, mcmc_regularisers, sample_views,
                          split_views, step_optimizers, zero_step_grads)
from ..train.losses import ssim_map
from .mesh import (HaloExchange, all_gather_cols_grad, all_gather_rows,
                   all_reduce_sum, depend, local_budget, rank_world, row_block,
                   tiles_y_local)

HALO = 5  # the SSIM window's half width: 11 // 2

# The packet fields of the all-gather, in order: floats, then the small
# integers (exact in float32).
PACKET_FLOATS = ("x2d", "y2d", "conic_a", "conic_b", "conic_c", "opacity",
                 "col_r", "col_g", "col_b", "depth")
PACKET_INTS = ("radius", "rect_rx", "rect_ry")


def gather_projection(proj: Projected, abs_probe: Optional[torch.Tensor] = None):
    """Every rank's projected rows, in slot order, and with `abs_probe`
    (this rank's (C / D, 2) block) the gathered (C, 2) abs probe, else
    None. Differentiable in the float fields and the abs probe: the
    backward is a reduce-scatter, which brings each Gaussian's gradients
    to the rank that owns it. The packet travels feature-major, (F, C / D)
    -> (F, C), so each field stays contiguous and `unbind`'s backward
    stacks the fields' gradients in one pass."""
    floats = [getattr(proj, f) for f in PACKET_FLOATS]
    if abs_probe is not None:
        floats += list(abs_probe.t())
    local = torch.stack(floats + [getattr(proj, f).to(torch.float32)
                                  for f in PACKET_INTS])
    full = all_gather_cols_grad(local).unbind(0)
    n = len(floats)
    fields = dict(zip(PACKET_FLOATS, full))
    fields.update({f: full[n + i].detach().to(torch.int32)
                   for i, f in enumerate(PACKET_INTS)})
    absp = (torch.stack(full[len(PACKET_FLOATS):n], dim=1)
            if abs_probe is not None else None)
    return Projected(**fields), absp


@dataclasses.dataclass
class SlabRender:
    slab: torch.Tensor      # (3, tiles_y_local * 16, W), background blended
    radii: torch.Tensor     # (C,) int32 of the whole population
    n_dropped: int          # this rank's instances past its budget
    n_instances: int        # this rank's instances
    y0: int                 # the slab's first pixel row


def render_slab(g: Gaussians, alive: torch.Tensor, cam: CameraParams,
                static: CameraStatic, rcfg: RenderConfig, bg: torch.Tensor,
                align: Optional[GlobalAlignment] = None,
                probe2d: Optional[torch.Tensor] = None,
                abs_probe: Optional[torch.Tensor] = None,
                extra: Optional[torch.Tensor] = None,
                shift: Optional[torch.Tensor] = None) -> SlabRender:
    """This rank's slab of the view (module docstring, steps 1-4): the
    single-device render's `rasterize` on the gathered projection, over
    the slab's tile rows. g, alive, extra, probe2d, abs_probe: this rank's
    block of rows (the probes' gradients come back to it through the
    gather). With `rcfg.max_instances`, each rank's budget is
    `mesh.local_budget` of it; with `rcfg.sort_by_distance` the camera
    distances are gathered beside the packet. shift: the entrance-pupil
    shift of the fisheye mode (`project_gaussians`' shift_factors)."""
    rank, d = rank_world()
    ty = tiles_y_local(static, d)
    proj = project_gaussians(
        g.xyz, g.scaling(), g.quats, g.opacity(alive), g.sh_coeffs(), cam,
        static, rcfg.sh_degree, align=align, extra_color=extra,
        shift_factors=shift)
    if probe2d is not None:
        proj = dataclasses.replace(proj, x2d=proj.x2d + probe2d[:, 0],
                                   y2d=proj.y2d + probe2d[:, 1])
    full, absp = gather_projection(proj, abs_probe)
    sort_key = (all_gather_rows(distance_to_camera(g.xyz, cam, align))
                if rcfg.sort_by_distance else None)
    y0 = rank * ty * TILE_H
    slab, _, bins = rasterize(full, static.width, ty * TILE_H, bg,
                              local_budget(rcfg.max_instances, d), absp,
                              y0=y0, sort_key=sort_key)
    if not slab.requires_grad:          # no instance in this slab
        slab = depend(slab, full.x2d)
    return SlabRender(slab=slab, radii=full.radius, n_dropped=bins.n_dropped,
                      n_instances=bins.n_instances, y0=y0)


def halo_slab_loss(pred: torch.Tensor, gt: torch.Tensor, y0: int,
                   true_height: int, lambda_dssim: float):
    """The photometric loss of the slab (`_halo_slab_loss`, sharded.py:43):
    rows past the true height are zeroed, the 5-row halos of the
    neighbouring slabs (zeros past the image's edges) give the SSIM window
    its context, and only the true rows enter the sums. Returns (this
    rank's differentiable part of (1 - lambda) L1 - lambda SSIM over the
    whole image, its L1 sum, its SSIM sum); the loss is
    `total_loss` of the sums over the ranks."""
    h_local, width = pred.shape[1], pred.shape[2]
    rows = y0 + torch.arange(h_local, device=pred.device)
    valid = (rows < true_height)[None, :, None]
    zero = torch.zeros((), device=pred.device)
    pred = torch.where(valid, pred, zero)
    gt = torch.where(valid, gt, zero)
    both = torch.cat([pred, gt])                                 # (6, Hl, W)
    top, bot = HaloExchange.apply(both, HALO)
    ext = torch.cat([top, both, bot], dim=1)
    smap = ssim_map(ext[:3], ext[3:])[:, HALO:-HALO]
    ssim_sum = torch.sum(torch.where(valid, smap, zero))
    l1_sum = torch.sum(torch.abs(pred - gt))             # padded rows are 0 - 0
    denom = 3.0 * true_height * width
    partial = ((1.0 - lambda_dssim) * l1_sum - lambda_dssim * ssim_sum) / denom
    return partial, l1_sum.detach(), ssim_sum.detach()


def total_loss(l1_sum, ssim_sum, static: CameraStatic, lambda_dssim: float):
    """(1 - lambda) L1 + lambda (1 - SSIM) from the sums over the ranks."""
    denom = 3.0 * static.height * static.width
    return (1.0 - lambda_dssim) * l1_sum / denom + \
        lambda_dssim * (1.0 - ssim_sum / denom)


def sharded_train_step(state: TrainState, gt: torch.Tensor, cam_idx,
                       bg: torch.Tensor, static: CameraStatic,
                       rcfg: RenderConfig, cfg: TrainConfig) -> StepMetrics:
    """One tile-parallel training step (`make_sharded_train_step`,
    sharded.py:250-344); `state` holds this rank's block of the Gaussians,
    their Adam moments, alive mask and statistics, and the replicated
    cameras, alignment and specular MLP. gt: this rank's slab of the GT
    padded to `mesh.padded_height` rows ((3, Hl, W), or (K, 3, Hl, W) for K
    distinct cameras `cam_idx` with `--batch_cams`, their K slab renders
    one after another).

    Each rank backpropagates its partial loss (with `--mcmc` its block's
    share of the regularisers), one all-reduce sums the gradients of the
    camera rows, alignment and specular MLP and the loss sums;
    every rank then takes the same camera, alignment and specular steps
    and the Adam step of its own Gaussian rows. Returns the metrics of the
    whole step (loss, L1 over the true pixels, the live count, the
    instances dropped over the ranks and views); the image is this rank's
    slab (K slabs stacked) and the Gaussian gradients its block's."""
    rank, d = rank_world()
    batch, idxs, gts = split_views(cam_idx, gt)
    g = state.g
    capacity = state.capacity * d
    rows = row_block(capacity, rank, d)
    lam = cfg.opt.lambda_dssim
    device = g.xyz.device
    n_alive = state.alive.sum().to(torch.float64).reshape(1)
    all_reduce_sum([n_alive])
    views = sample_views(state, idxs, state.capacity)
    partials, sums, renders = [], [], []
    for v, gt_k in zip(views, gts):
        r = render_slab(g, state.alive, v.cam, static, rcfg, bg,
                        align=state.align, probe2d=v.probe, abs_probe=v.absp,
                        extra=extra_color(state, v.cam))
        partial, l1_sum, ssim_sum = halo_slab_loss(r.slab, gt_k, r.y0,
                                                   static.height, lam)
        partials.append(partial)
        sums += [l1_sum, ssim_sum]
        renders.append(r)
    partial = partials[0] if batch is None else torch.stack(partials).mean()
    reg = torch.zeros((), device=device)
    if cfg.mcmc:
        reg = mcmc_regularisers(g, state.alive, cfg, n_alive=n_alive[0])
        partial = partial + reg
    zero_step_grads(state)
    partial.backward()

    # the replicated tensors' gradients: this rank's part -> the sum
    replicated = [v.row[f] for v in views for f in sorted(v.row)]
    if cfg.calib.opt_global_alignment:
        replicated += [state.align.quaternion, state.align.log_scale]
    if state.spec is not None:
        replicated += list(state.spec.named_tensors().values())
    for t in replicated:
        if t.grad is None:
            t.grad = torch.zeros_like(t)
    all_reduce_sum([t.grad for t in replicated])
    scalars = torch.stack(sums + [reg.detach()]).to(torch.float64)
    scalars = torch.cat([scalars, torch.tensor(
        [float(sum(r.n_dropped for r in renders))], dtype=torch.float64,
        device=device)])
    all_reduce_sum([scalars])

    grads = step_optimizers(state, cfg, views, cam_idx)
    k = len(views)
    accumulate_stats(state, [v.probe.grad for v in views],
                     [v.absp.grad for v in views],
                     [r.radii[rows] for r in renders])
    losses = [total_loss(scalars[2 * i], scalars[2 * i + 1], static, lam)
              for i in range(k)]
    loss = sum(losses) / k + scalars[2 * k]
    l1 = sum(scalars[2 * i] for i in range(k)) / (
        k * 3.0 * static.height * static.width)
    state.step += 1
    slabs = [r.slab.detach() for r in renders]
    return StepMetrics(
        loss=loss.to(torch.float32), l1=l1.to(torch.float32),
        n_alive=n_alive[0].to(torch.int64), n_dropped=int(scalars[-1]),
        image=slabs[0] if batch is None else torch.stack(slabs), grads=grads)
