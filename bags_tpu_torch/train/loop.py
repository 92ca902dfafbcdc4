"""Training loop (port of `bags_tpu/train/loop.py`): one eager train step and
the host-side cadences.

Each step renders the sampled camera, takes (1 - lambda) L1 +
lambda (1 - SSIM), runs `backward()` (on the card through the compositing
backward kernel) to the Gaussians, the camera row's dq / dt / FoV and the
global alignment, steps the six-group Adam and the camera's row Adam (and
the alignment Adam with `--opt_global_alignment`), and accumulates the
densification statistics from the `probe2d` and `abs_probe` gradients.
With `--hybrid` the render adds each Gaussian's specular colour
(`calib/specular.py`) and the specular MLP takes its own Adam step; with
`--mcmc` the loss adds the opacity and scale regularisers (means over the
live count). `Trainer.run` adds the SH-degree ramp every 1000 iterations,
densify and prune inside (densify_from_iter, densify_until_iter) and the
opacity reset, or with `--mcmc` the relocation step (`mcmc_step`) at the
densification interval and position noise (`mcmc_noise_step`) every step,
a camera stack drawn from `np.random.default_rng(seed).permutation` (so
both packages visit cameras in the same order) and a 1-deep GT prefetch
thread.

The population keeps the JAX package's fixed capacity and `alive` mask; the
instance count of each view is dynamic, so there is no instance budget and
no capacity ladder.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..calib.specular import (SpecularParams, init_specular_params,
                              specular_extra_color)
from ..core.camera import CameraParams, CameraStatic, GlobalAlignment
from ..model.densify import (DensifyResult, DensifyStats, densify_and_prune,
                             reset_opacity, update_stats, zero_moments_at)
from ..model import mcmc
from ..model.gaussians import Gaussians
from ..raster.render import RenderConfig, render
from .config import TrainConfig
from .losses import photometric_loss
from .optim import (CAMERA_FIELDS, AdamMoments, RowAdamState,
                    adam_moments_init, adam_moments_step, camera_lrs,
                    make_alignment_optimizer, make_gaussian_optimizer,
                    row_adam_init, row_adam_update, specular_schedule)


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
    gen: torch.Generator              # split offsets, MCMC draws and noise
    # --hybrid: the specular MLP, its Adam moments and lr schedule
    spec: Optional[SpecularParams] = None
    spec_opt: Optional[AdamMoments] = None
    spec_sched: Optional[Callable[[int], float]] = None

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]


@dataclasses.dataclass
class StepMetrics:
    loss: torch.Tensor
    l1: torch.Tensor
    n_alive: torch.Tensor
    n_dropped: int
    image: torch.Tensor               # the image the loss compared
    grads: Dict[str, torch.Tensor]    # every gradient the step took


def init_train_state(g: Gaussians, alive: torch.Tensor, cams: CameraParams,
                     cfg: TrainConfig, spatial_lr_scale: float,
                     seed: int = 0) -> TrainState:
    """Make `g`'s tensors the optimizer's leaves (in place: the state owns
    them from here on) and build every optimizer state. The cameras are
    copied, so that the caller's (the dataset's initial poses) stay as they
    are while the state's are optimised in place. With `--hybrid`, `g`
    gains zero ASG features (unless it has them) and the state the
    specular MLP of `init_specular_params(seed)`."""
    if cfg.calib.hybrid and g.asg is None:
        g = g.with_asg()
    for t in g.fields().values():
        t.requires_grad_(True)
    cams = CameraParams(**{f.name: getattr(cams, f.name).detach().clone()
                           for f in dataclasses.fields(cams)})
    device = g.xyz.device
    align = GlobalAlignment.identity(device)
    align.quaternion.requires_grad_(cfg.calib.opt_global_alignment)
    align.log_scale.requires_grad_(cfg.calib.opt_global_alignment)
    g_opt, xyz_sched = make_gaussian_optimizer(g, cfg.opt, spatial_lr_scale)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    spec = spec_opt = spec_sched = None
    if cfg.calib.hybrid:
        spec = init_specular_params(seed, device)
        spec_opt = adam_moments_init(spec.named_tensors())
        spec_sched = specular_schedule(cfg.opt)
    return TrainState(
        g=g, alive=alive, g_opt=g_opt, xyz_sched=xyz_sched, cams=cams,
        cam_opt=row_adam_init(cams), align=align,
        align_opt=make_alignment_optimizer(align, cfg.calib),
        stats=DensifyStats.zeros(alive.shape[0], device), step=0, gen=gen,
        spec=spec, spec_opt=spec_opt, spec_sched=spec_sched)


def extra_color(state: TrainState, cam: CameraParams) -> Optional[torch.Tensor]:
    """The specular colour offsets (C, 3) seen from `cam` (with the state's
    alignment) when the state is hybrid, else None."""
    if state.spec is None:
        return None
    return specular_extra_color(state.spec, state.g.xyz, state.g.asg, cam,
                                state.align)


def zero_spec_grads(state: TrainState) -> None:
    if state.spec is not None:
        for p in state.spec.named_tensors().values():
            p.grad = None


def step_specular(state: TrainState) -> dict:
    """The specular MLP's Adam step from its gradients (zeros where it has
    none) at the lr of its update count, as optax's schedule takes its own
    count. Returns the gradients by their `.spec.` names, {} when the state
    is not hybrid."""
    if state.spec is None:
        return {}
    named = state.spec.named_tensors()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in named.items()}
    with torch.no_grad():
        adam_moments_step(named, grads, state.spec_opt,
                          state.spec_sched(state.spec_opt.count))
    return {".spec" + k: v for k, v in grads.items()}


def mcmc_regularisers(g: Gaussians, alive: torch.Tensor,
                      cfg: TrainConfig) -> torch.Tensor:
    """opacity_reg mean|o| + scale_reg mean|s| over the live Gaussians (the
    reference's means over its actual Gaussians, not the capacity)."""
    n_alive = torch.clamp(alive.sum(), min=1).to(g.opacity_raw.dtype)
    reg = cfg.opt.opacity_reg * torch.sum(torch.abs(g.opacity(alive))) / n_alive
    return reg + cfg.opt.scale_reg * torch.sum(torch.abs(
        g.scaling() * alive[:, None])) / (3.0 * n_alive)


def train_step(state: TrainState, gt: torch.Tensor, cam_idx: int,
               bg: torch.Tensor, static: CameraStatic, rcfg: RenderConfig,
               cfg: TrainConfig) -> StepMetrics:
    """One training step on camera `cam_idx` against `gt` (3, H, W); updates
    `state` in place (`make_train_step`, loop.py:148-270). Returns the
    metrics with every gradient the step took (`grads`, by the JAX
    package's names)."""
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
                 probe2d=probe, abs_probe=absp,
                 extra_color=extra_color(state, cam))
    loss = photometric_loss(out.render, gt, cfg.opt.lambda_dssim)
    if cfg.mcmc:
        loss = loss + mcmc_regularisers(g, state.alive, cfg)
    state.g_opt.zero_grad()
    state.align_opt.zero_grad()
    zero_spec_grads(state)
    loss.backward()

    # Gaussians: the xyz lr follows the global step, as optax's schedule
    # follows its update count.
    state.g_opt.param_groups[0]["lr"] = state.xyz_sched(state.step)
    state.g_opt.step()
    grads = {f".g.{k}": t.grad for k, t in g.fields().items()}
    grads.update(step_specular(state))
    # camera: only the sampled row moves
    row_grads = {f: row[f].grad for f in row}
    grads.update({f".cam.{f}": v for f, v in row_grads.items()})
    row_adam_update(cams, state.cam_opt, row_grads, cam_idx,
                    camera_lrs(cfg.calib, state.step))
    # global alignment: opt-in (the reference never steps it)
    if cfg.calib.opt_global_alignment:
        state.align_opt.step()

    with torch.no_grad():
        state.stats = update_stats(state.stats, probe.grad, absp.grad,
                                   out.radii, out.visibility)
        l1 = torch.mean(torch.abs(out.render - gt))
    state.step += 1
    return StepMetrics(loss=loss.detach(), l1=l1, n_alive=state.alive.sum(),
                       n_dropped=out.n_dropped, image=out.render.detach(),
                       grads=grads)


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


def mcmc_step(state: TrainState, cfg: TrainConfig):
    """Relocate the dead Gaussians, grow toward cap_max (`--cap_max`, else
    the capacity), then zero the Adam moments at both reset masks
    (`make_mcmc_step`, loop.py:273-290). Returns (n_relocated, n_added)."""
    cap = cfg.model.cap_max if cfg.model.cap_max > 0 else None
    r1 = mcmc.relocate_dead(state.g, state.alive, state.gen,
                            min_opacity=cfg.opacity_threshold)
    r2 = mcmc.add_new_gaussians(state.g, r1.alive, state.gen, cap_max=cap)
    zero_moments_at(state.g_opt, r1.reset_mask | r2.reset_mask)
    state.alive = r2.alive
    return r1.n_relocated, r2.n_relocated


@torch.no_grad()
def mcmc_noise_step(state: TrainState, cfg: TrainConfig,
                    eps: Optional[torch.Tensor] = None) -> None:
    """SGLD position noise after the optimizer step, at the xyz lr of the
    step count after its increment (`make_mcmc_noise_step`,
    loop.py:293-316). eps: the standard normal draws (C, 3), by default
    drawn from the state's generator."""
    if eps is None:
        eps = torch.randn(state.g.xyz.shape, generator=state.gen,
                          device=state.gen.device)
    state.g.xyz.copy_(mcmc.position_noise(
        state.g, state.alive, eps, state.xyz_sched(state.step),
        cfg.opt.noise_lr))


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
        # (it, n_relocated, n_added, alive_before, alive_after) with --mcmc
        self.mcmc_log: list[tuple] = []

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

            if self.cfg.mcmc:
                # MCMC cadence (train.py:363-372,434-441): relocation at the
                # densification interval, position noise every step; no
                # densify, no opacity reset
                if opt.densify_from_iter < it < opt.densify_until_iter and \
                        it % opt.densification_interval == 0:
                    before = int(self.base.alive.sum())
                    n_rel, n_add = mcmc_step(self.base, self.cfg)
                    self.mcmc_log.append((it, n_rel, n_add, before,
                                          int(self.base.alive.sum())))
                mcmc_noise_step(self.base, self.cfg)
            elif it < opt.densify_until_iter:
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
            # the metrics hold the step's gradients: let them go before the
            # next step's backward allocates its own
            metrics = None
        return history
