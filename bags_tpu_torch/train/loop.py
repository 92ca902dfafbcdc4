"""Training loop (port of `bags_tpu/train/loop.py`): one eager train step and
the host-side cadences.

Each step renders the sampled camera, takes (1 - lambda) L1 +
lambda (1 - SSIM), runs `backward()` (on the card through the compositing
backward kernel) to the Gaussians, the camera row's dq / dt / FoV and the
global alignment, steps the six-group Adam and the camera's row Adam (and
the alignment Adam with `--opt_global_alignment`), and accumulates the
densification statistics from the `probe2d` and `abs_probe` gradients.
`Trainer.run` adds the SH-degree ramp every 1000 iterations, densify and
prune inside (densify_from_iter, densify_until_iter), the opacity reset, a
camera stack drawn from `np.random.default_rng(seed).permutation` (so both
packages visit cameras in the same order) and a 1-deep GT prefetch thread.

The population keeps the JAX package's fixed capacity and `alive` mask; the
instance count of each view is dynamic, so there is no instance budget and
no capacity ladder.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core.camera import CameraParams, CameraStatic, GlobalAlignment
from ..model.densify import (DensifyResult, DensifyStats, densify_and_prune,
                             reset_opacity, update_stats, zero_moments_at)
from ..model.gaussians import Gaussians
from ..raster.render import RenderConfig, render
from .config import TrainConfig
from .losses import photometric_loss
from .optim import (CAMERA_FIELDS, RowAdamState, camera_lrs,
                    make_alignment_optimizer, make_gaussian_optimizer,
                    row_adam_init, row_adam_update)


@dataclasses.dataclass
class TrainState:
    g: Gaussians                      # leaf tensors of capacity C
    alive: torch.Tensor               # (C,) bool
    g_opt: torch.optim.Adam
    xyz_sched: Callable[[int], float]
    cams: CameraParams                # batched (n_cams, ...)
    cam_opt: RowAdamState
    align: GlobalAlignment
    align_opt: torch.optim.Adam
    stats: DensifyStats
    step: int
    gen: torch.Generator              # split offsets

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]


@dataclasses.dataclass
class StepMetrics:
    loss: torch.Tensor
    l1: torch.Tensor
    n_alive: torch.Tensor
    n_dropped: int


def init_train_state(g: Gaussians, alive: torch.Tensor, cams: CameraParams,
                     cfg: TrainConfig, spatial_lr_scale: float,
                     seed: int = 0) -> TrainState:
    """Make `g`'s tensors the optimizer's leaves (in place: the state owns
    them from here on) and build every optimizer state. The cameras are
    copied, so that the caller's (the dataset's initial poses) stay as they
    are while the state's are optimised in place."""
    for f in dataclasses.fields(g):
        getattr(g, f.name).requires_grad_(True)
    cams = CameraParams(**{f.name: getattr(cams, f.name).detach().clone()
                           for f in dataclasses.fields(cams)})
    device = g.xyz.device
    align = GlobalAlignment.identity(device)
    align.quaternion.requires_grad_(cfg.calib.opt_global_alignment)
    align.log_scale.requires_grad_(cfg.calib.opt_global_alignment)
    g_opt, xyz_sched = make_gaussian_optimizer(g, cfg.opt, spatial_lr_scale)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return TrainState(
        g=g, alive=alive, g_opt=g_opt, xyz_sched=xyz_sched, cams=cams,
        cam_opt=row_adam_init(cams), align=align,
        align_opt=make_alignment_optimizer(align, cfg.calib),
        stats=DensifyStats.zeros(alive.shape[0], device), step=0, gen=gen)


def train_step(state: TrainState, gt: torch.Tensor, cam_idx: int,
               bg: torch.Tensor, static: CameraStatic, rcfg: RenderConfig,
               cfg: TrainConfig) -> StepMetrics:
    """One training step on camera `cam_idx` against `gt` (3, H, W); updates
    `state` in place (`make_train_step`, loop.py:148-270)."""
    g, cams = state.g, state.cams
    row = {f: getattr(cams, f)[cam_idx].detach().clone().requires_grad_(True)
           for f in CAMERA_FIELDS}
    cam = CameraParams(q_init=cams.q_init[cam_idx],
                       t_init=cams.t_init[cam_idx], **row)
    probe = torch.zeros((state.capacity, 2), device=g.xyz.device,
                        requires_grad=True)
    absp = torch.zeros_like(probe, requires_grad=True)
    out = render(g.xyz, g.scaling(), g.quats, g.opacity(state.alive),
                 g.sh_coeffs(), cam, static, rcfg, bg=bg, align=state.align,
                 probe2d=probe, abs_probe=absp)
    loss = photometric_loss(out.render, gt, cfg.opt.lambda_dssim)
    state.g_opt.zero_grad()
    state.align_opt.zero_grad()
    loss.backward()

    # Gaussians: the xyz lr follows the global step, as optax's schedule
    # follows its update count.
    state.g_opt.param_groups[0]["lr"] = state.xyz_sched(state.step)
    state.g_opt.step()
    # camera: only the sampled row moves
    row_adam_update(cams, state.cam_opt, {f: row[f].grad for f in row},
                    cam_idx, camera_lrs(cfg.calib, state.step))
    # global alignment: opt-in (the reference never steps it)
    if cfg.calib.opt_global_alignment:
        state.align_opt.step()

    with torch.no_grad():
        state.stats = update_stats(state.stats, probe.grad, absp.grad,
                                   out.radii, out.visibility)
        l1 = torch.mean(torch.abs(out.render - gt))
    state.step += 1
    return StepMetrics(loss=loss.detach(), l1=l1, n_alive=state.alive.sum(),
                       n_dropped=out.n_dropped)


def densify_step(state: TrainState, cfg: TrainConfig, scene_extent: float,
                 max_screen_size: float) -> DensifyResult:
    """Densify + prune, zero the touched Adam rows, reset the statistics."""
    thr = (cfg.opt.abs_densify_grad_threshold if cfg.abs_grad
           else cfg.opt.densify_grad_threshold)
    res = densify_and_prune(
        state.g, state.alive, state.stats, state.gen, grad_threshold=thr,
        min_opacity=cfg.opacity_threshold, scene_extent=scene_extent,
        max_screen_size=max_screen_size, percent_dense=cfg.opt.percent_dense,
        use_abs_grad=cfg.abs_grad)
    zero_moments_at(state.g_opt, res.reset_mask)
    state.alive = res.alive
    state.stats = DensifyStats.zeros(state.capacity, state.alive.device)
    return res


@torch.no_grad()
def opacity_reset_step(state: TrainState) -> None:
    """Opacity clamp and zeroing of all the opacity Adam moments
    (`reset_opacity` + `replace_tensor_to_optimizer`)."""
    reset_opacity(state.g)
    st = state.g_opt.state.get(state.g.opacity_raw)
    if st:
        st["exp_avg"].zero_()
        st["exp_avg_sq"].zero_()


class Trainer:
    """Host-side orchestration: cadences, SH ramp, camera order, GT
    prefetch. gt_images: (n_cams, 3, H, W) tensor or a callable
    idx -> (3, H, W) tensor. `close()` stops the prefetch thread."""

    def __init__(self, g, alive, cams, static: CameraStatic, cfg: TrainConfig,
                 scene_extent: float, gt_images, bg=None,
                 rcfg: Optional[RenderConfig] = None, seed: int = 0):
        self.cfg = cfg
        self.static = static
        self.scene_extent = scene_extent
        self.gt_images = gt_images
        device = g.xyz.device
        self.bg = bg if bg is not None else torch.full(
            (3,), 1.0 if cfg.model.white_background else 0.0, device=device)
        self.rcfg = rcfg or RenderConfig(sh_degree=cfg.model.sh_degree)
        self.state = init_train_state(g, alive, cams, cfg, scene_extent, seed)
        self.active_sh_degree = 0
        self.max_sh_degree = cfg.model.sh_degree
        self._rng = np.random.default_rng(seed)
        self._camera_stack: list[int] = []
        self._io: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._prefetched = None
        self.densify_log: list[tuple] = []

    def close(self) -> None:
        if self._io is not None:
            self._io.shutdown(wait=True)
            self._io = None

    @property
    def base(self) -> TrainState:
        """The TrainState (a calibrated trainer's state wraps it)."""
        return self.state

    def save_checkpoint(self, path: str) -> None:
        """Write the state to `path` (`checkpoint.save_checkpoint`)."""
        from .checkpoint import save_checkpoint
        save_checkpoint(path, self.state)

    def load_checkpoint(self, path: str, with_optimizer: bool = True) -> None:
        """Restore the state from `path` (`checkpoint.load_checkpoint`)."""
        from .checkpoint import load_checkpoint
        load_checkpoint(path, self.state, with_optimizer)

    def _refill_camera_stack(self) -> None:
        if not self._camera_stack:
            n = int(self.base.cams.fovx.shape[0])
            self._camera_stack = list(self._rng.permutation(n))

    def _next_camera(self) -> int:
        """Random camera from a reshuffled stack (train.py:206-208)."""
        self._refill_camera_stack()
        return int(self._camera_stack.pop())

    def _peek_camera(self) -> int:
        """The camera the next iteration will draw (for the prefetch)."""
        self._refill_camera_stack()
        return int(self._camera_stack[-1])

    def _fetch_gt(self, idx: int) -> torch.Tensor:
        """GT of camera idx; while this step runs, one IO thread loads the
        next step's image."""
        if not callable(self.gt_images):
            return self.gt_images[idx]
        pre = self._prefetched
        gt = (pre[1].result() if pre is not None and pre[0] == idx
              else self.gt_images(idx))
        if self._io is None:
            self._io = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="bags-gt-io")
        nidx = self._peek_camera()
        self._prefetched = (nidx, self._io.submit(self.gt_images, nidx))
        return gt

    def step(self, idx: int, gt: torch.Tensor, it: Optional[int] = None
             ) -> StepMetrics:
        """One step on camera idx; `it`, the iteration of `run`, matters
        only to a calibrated trainer's lens window."""
        rcfg = dataclasses.replace(self.rcfg, sh_degree=self.active_sh_degree)
        return train_step(self.state, gt, idx, self.bg, self.static, rcfg,
                          self.cfg)

    def run(self, iterations: Optional[int] = None, log_every: int = 0,
            callback=None):
        """Iterations 1..iterations after `state.step`'s; returns
        [(it, loss, n_alive)] every `log_every` iterations."""
        opt = self.cfg.opt
        iterations = iterations or opt.iterations
        history = []
        for it in range(1, iterations + 1):
            # SH degree ramp every 1000 iterations (train.py:202)
            if it % 1000 == 0 and self.active_sh_degree < self.max_sh_degree:
                self.active_sh_degree += 1
            idx = self._next_camera()
            metrics = self.step(idx, self._fetch_gt(idx), it)

            if it < opt.densify_until_iter:
                # densification cadence (train.py:374-389)
                if it > opt.densify_from_iter and \
                        it % opt.densification_interval == 0:
                    max_screen = 20.0 if it > opt.opacity_reset_interval else 0.0
                    before = int(self.base.alive.sum())
                    res = densify_step(self.base, self.cfg,
                                       self.scene_extent, max_screen)
                    self.densify_log.append(
                        (it, res.n_cloned, res.n_split, res.n_pruned, before,
                         int(self.base.alive.sum())))
                if it % opt.opacity_reset_interval == 0 or (
                        self.cfg.model.white_background
                        and it == opt.densify_from_iter):
                    opacity_reset_step(self.base)

            if log_every and it % log_every == 0:
                history.append((it, float(metrics.loss),
                                int(metrics.n_alive)))
            if callback is not None:
                callback(it, self.state, metrics)
        return history
