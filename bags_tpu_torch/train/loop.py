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
thread. With `--batch_cams K` a step takes K distinct cameras of that
stack: the K views render one after another, one backward of the mean
loss steps the Gaussians once and each camera row once, and the
statistics are scaled back to a single view's.

`Trainer.run` opens the span "step" around each step, and the step its
layers' spans (`utils/spans.py`): "projection" (the activations and the
specular colour too), `render()`'s, "loss", "backward" and "optimizers"
(the gradients' zeroing, every optimizer and the statistics).

The population keeps the JAX package's fixed capacity and `alive` mask; the
instance count of each view is dynamic, so there is no instance budget and
no capacity ladder.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import Callable, Dict, List, Optional

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
from ..utils.spans import span
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
    # a cubemap step's binned instances, one count a face (FACES order)
    face_instances: Optional[List[int]] = None


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
    with span("projection"):
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


def mcmc_regularisers(g: Gaussians, alive: torch.Tensor, cfg: TrainConfig,
                      n_alive: Optional[torch.Tensor] = None) -> torch.Tensor:
    """opacity_reg mean|o| + scale_reg mean|s| over the live Gaussians (the
    reference's means over its actual Gaussians, not the capacity). Under a
    mesh `g` and `alive` are this rank's block and `n_alive` the live count
    of the whole population, so the ranks' terms add up to the whole."""
    if n_alive is None:
        n_alive = alive.sum()
    n_alive = torch.clamp(n_alive, min=1).to(g.opacity_raw.dtype)
    reg = cfg.opt.opacity_reg * torch.sum(torch.abs(g.opacity(alive))) / n_alive
    return reg + cfg.opt.scale_reg * torch.sum(torch.abs(
        g.scaling() * alive[:, None])) / (3.0 * n_alive)


def camera_batch(cam_idx) -> Optional[List[int]]:
    """The K cameras of a `--batch_cams` step as a list, or None for a
    single camera index (an int)."""
    if isinstance(cam_idx, (int, np.integer)):
        return None
    return [int(i) for i in cam_idx]


def split_views(cam_idx, gt):
    """(`camera_batch(cam_idx)`, the step's camera rows, their GTs): one
    camera and its (3, H, W) GT, or K cameras and the (K, 3, H, W) GT."""
    batch = camera_batch(cam_idx)
    if batch is None:
        return None, [cam_idx], [gt]
    return batch, batch, list(gt)


@dataclasses.dataclass
class View:
    """One sampled camera of a step: its learnable row (leaf tensors that
    take the gradients), the camera built on them, and its densification
    probes (zeros whose gradients are the statistics)."""

    row: Dict[str, torch.Tensor]
    cam: CameraParams
    probe: torch.Tensor
    absp: torch.Tensor


def sample_views(state: TrainState, idxs: List[int], n_probe: int) -> List[View]:
    """A View of each camera row in `idxs`, with (n_probe, 2) probes."""
    cams, views = state.cams, []
    for i in idxs:
        row = {f: getattr(cams, f)[i].detach().clone().requires_grad_(True)
               for f in CAMERA_FIELDS}
        probe = torch.zeros((n_probe, 2), device=state.g.xyz.device,
                            requires_grad=True)
        views.append(View(row=row, cam=CameraParams(
            q_init=cams.q_init[i], t_init=cams.t_init[i], **row), probe=probe,
            absp=torch.zeros_like(probe, requires_grad=True)))
    return views


def zero_step_grads(state: TrainState) -> None:
    """Clear the gradients of every tensor the step optimises."""
    state.g_opt.zero_grad()
    state.align_opt.zero_grad()
    zero_spec_grads(state)


def step_optimizers(state: TrainState, cfg: TrainConfig, views: List[View],
                    cam_idx, alignment: bool = True) -> Dict[str, torch.Tensor]:
    """After the backward: the Gaussians' Adam, the specular MLP, the
    sampled camera rows' row Adam (one row, or the K rows of a batch, their
    gradients stacked) and, with `alignment` and `--opt_global_alignment`,
    the global alignment (the JAX fisheye step never steps it). Returns
    every gradient by the JAX package's names."""
    g = state.g
    # the xyz lr follows the global step, as optax's schedule follows its
    # update count
    state.g_opt.param_groups[0]["lr"] = state.xyz_sched(state.step)
    state.g_opt.step()
    grads = {f".g.{k}": t.grad for k, t in g.fields().items()}
    grads.update(step_specular(state))
    if camera_batch(cam_idx) is None:
        row_grads = {f: views[0].row[f].grad for f in CAMERA_FIELDS}
    else:
        row_grads = {f: torch.stack([v.row[f].grad for v in views])
                     for f in CAMERA_FIELDS}
    grads.update({f".cam.{f}": v for f, v in row_grads.items()})
    row_adam_update(state.cams, state.cam_opt, row_grads, cam_idx,
                    camera_lrs(cfg.calib, state.step))
    # global alignment: opt-in (the reference never steps it)
    if alignment and cfg.calib.opt_global_alignment:
        state.align_opt.step()
    return grads


@torch.no_grad()
def accumulate_stats(state: TrainState, probe_grads, abs_grads, radii) -> None:
    """Add each view's statistics. With K > 1 views the mean over views
    scales every probe gradient by 1 / K, and the densify thresholds are a
    single view's magnitudes, so they are scaled back by K (loop.py:247-256)."""
    k = len(radii)
    for pg, ag, r in zip(probe_grads, abs_grads, radii):
        if k > 1:
            pg, ag = pg * k, ag * k
        state.stats = update_stats(state.stats, pg, ag, r, r > 0)


def train_step(state: TrainState, gt: torch.Tensor, cam_idx,
               bg: torch.Tensor, static: CameraStatic, rcfg: RenderConfig,
               cfg: TrainConfig) -> StepMetrics:
    """One training step on camera `cam_idx` against `gt` (3, H, W); updates
    `state` in place (`make_train_step`, loop.py:148-270). Returns the
    metrics with every gradient the step took (`grads`, by the JAX
    package's names).

    `--batch_cams` K > 1: `cam_idx` is K distinct camera rows and `gt`
    (K, 3, H, W). The K views render one after another, each with its own
    probes; one backward of mean(losses) (+ the MCMC regularisers) steps
    the Gaussians once and each camera row once. The metrics' image is
    then (K, 3, H, W), the camera gradients (K, ...), and n_dropped the
    largest of the views'."""
    batch, idxs, gts = split_views(cam_idx, gt)
    g = state.g
    views = sample_views(state, idxs, state.capacity)
    outs, losses = [], []
    for v, gt_k in zip(views, gts):
        out = render(g.xyz, g.scaling(), g.quats, g.opacity(state.alive),
                     g.sh_coeffs(), v.cam, static, rcfg, bg=bg,
                     align=state.align, probe2d=v.probe, abs_probe=v.absp,
                     extra_color=extra_color(state, v.cam))
        with span("loss"):
            losses.append(photometric_loss(out.render, gt_k,
                                           cfg.opt.lambda_dssim))
        outs.append(out)
    with span("loss"):
        loss = losses[0] if batch is None else torch.stack(losses).mean()
        if cfg.mcmc:
            loss = loss + mcmc_regularisers(g, state.alive, cfg)
    with span("optimizers"):
        zero_step_grads(state)
    with span("backward"):
        loss.backward()

    with span("optimizers"):
        grads = step_optimizers(state, cfg, views, cam_idx)
        accumulate_stats(state, [v.probe.grad for v in views],
                         [v.absp.grad for v in views], [o.radii for o in outs])
    with torch.no_grad(), span("loss"):
        if batch is None:
            image = outs[0].render.detach()
        else:
            image, gt = torch.stack([o.render for o in outs]), torch.stack(gts)
        l1 = torch.mean(torch.abs(image - gt))
    state.step += 1
    return StepMetrics(loss=loss.detach(), l1=l1, n_alive=state.alive.sum(),
                       n_dropped=max(o.n_dropped for o in outs), image=image,
                       grads=grads)


def densify_population(g: Gaussians, alive: torch.Tensor, stats: DensifyStats,
                       gen: torch.Generator, cfg: TrainConfig,
                       scene_extent: float, max_screen_size: float
                       ) -> DensifyResult:
    """Densify + prune `g` in place with the configuration's thresholds."""
    thr = (cfg.opt.abs_densify_grad_threshold if cfg.abs_grad
           else cfg.opt.densify_grad_threshold)
    return densify_and_prune(
        g, alive, stats, gen, grad_threshold=thr,
        min_opacity=cfg.opacity_threshold, scene_extent=scene_extent,
        max_screen_size=max_screen_size, percent_dense=cfg.opt.percent_dense,
        use_abs_grad=cfg.abs_grad)


def densify_step(state: TrainState, cfg: TrainConfig, scene_extent: float,
                 max_screen_size: float) -> DensifyResult:
    """Densify + prune, zero the touched Adam rows, reset the statistics."""
    res = densify_population(state.g, state.alive, state.stats, state.gen,
                             cfg, scene_extent, max_screen_size)
    zero_moments_at(state.g_opt, res.reset_mask)
    state.alive = res.alive
    state.stats = DensifyStats.zeros(state.capacity, state.alive.device)
    return res


def relocate_population(g: Gaussians, alive: torch.Tensor,
                        gen: torch.Generator, cfg: TrainConfig):
    """Relocate the dead Gaussians of `g` in place, then grow toward
    cap_max (`--cap_max`, else the capacity). Returns (alive, the reset
    mask, n_relocated, n_added)."""
    cap = cfg.model.cap_max if cfg.model.cap_max > 0 else None
    r1 = mcmc.relocate_dead(g, alive, gen, min_opacity=cfg.opacity_threshold)
    r2 = mcmc.add_new_gaussians(g, r1.alive, gen, cap_max=cap)
    return r2.alive, r1.reset_mask | r2.reset_mask, r1.n_relocated, r2.n_relocated


def mcmc_step(state: TrainState, cfg: TrainConfig):
    """Relocate the dead Gaussians, grow toward cap_max, then zero the Adam
    moments at both reset masks (`make_mcmc_step`, loop.py:273-290).
    Returns (n_relocated, n_added)."""
    alive, reset, n_rel, n_add = relocate_population(state.g, state.alive,
                                                     state.gen, cfg)
    zero_moments_at(state.g_opt, reset)
    state.alive = alive
    return n_rel, n_add


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

    def _draw(self, k: int, pop: bool) -> List[int]:
        """The next k distinct cameras of the reshuffled stack
        (train.py:206-208; `_next_cameras`, loop.py:498-508, a camera drawn
        twice within the k being dropped), taken off the stack with `pop`,
        else only looked at. A permutation the draw runs into goes below
        the rest of the stack, which is where refilling the emptied stack
        would put it: looking ahead does not change the order."""
        n = int(self.base.cams.fovx.shape[0])
        if k > n:
            raise ValueError(f"batch_cams={k} exceeds the {n} training cameras")
        stack, out, j = self._camera_stack, [], 0
        while len(out) < k:
            if j == len(stack):
                stack[:0] = [int(i) for i in self._rng.permutation(n)]
            i = stack[-1 - j]
            j += 1
            if i not in out:
                out.append(i)
        if pop:
            del stack[len(stack) - j:]
        return out

    def _next_camera(self) -> int:
        """Random camera from a reshuffled stack (train.py:206-208)."""
        return self._draw(1, pop=True)[0]

    def _next_cameras(self, k: int) -> List[int]:
        """k distinct cameras (`--batch_cams`) from the same reshuffled
        stack: the row Adam steps each row once."""
        return self._draw(k, pop=True)

    def _step_cameras(self, pop: bool):
        """The camera of the next step, or the list of its k cameras with
        `--batch_cams k`; taken with `pop`, else only looked at."""
        k = self.cfg.opt.batch_cams
        idx = self._draw(k, pop)
        return idx if k > 1 else idx[0]

    def _load_gt(self, idx) -> torch.Tensor:
        """GT of camera idx ((3, H, W)), or of a list of cameras stacked
        ((K, 3, H, W))."""
        load = (self.gt_images if callable(self.gt_images)
                else self.gt_images.__getitem__)
        if isinstance(idx, list):
            return torch.stack([load(i) for i in idx])
        return load(idx)

    def _fetch_gt(self, idx) -> torch.Tensor:
        """`_load_gt(idx)`; while this step runs, one IO thread loads the
        next step's GT."""
        if not callable(self.gt_images):
            return self._load_gt(idx)
        pre = self._prefetched
        gt = (pre[1].result() if pre is not None and pre[0] == idx
              else self._load_gt(idx))
        if self._io is None:
            self._io = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="bags-gt-io")
        nidx = self._step_cameras(pop=False)
        self._prefetched = (nidx, self._io.submit(self._load_gt, nidx))
        return gt

    def step(self, idx, gt: torch.Tensor, it: Optional[int] = None
             ) -> StepMetrics:
        """One step on camera idx (K distinct cameras and their stacked GT
        with `--batch_cams`); `it`, the iteration of `run`, matters only
        to a calibrated trainer's lens window."""
        rcfg = dataclasses.replace(self.rcfg, sh_degree=self.active_sh_degree)
        return train_step(self.state, gt, idx, self.bg, self.static, rcfg,
                          self.cfg)

    # The population transforms of `run`'s cadences. A sharded trainer
    # (`dist/trainer.py`) runs them on the whole population.

    def n_alive(self) -> int:
        return int(self.base.alive.sum())

    def densify(self, max_screen: float) -> DensifyResult:
        return densify_step(self.base, self.cfg, self.scene_extent, max_screen)

    def relocate(self):
        return mcmc_step(self.base, self.cfg)

    def add_noise(self) -> None:
        mcmc_noise_step(self.base, self.cfg)

    def population(self):
        """(Gaussians, alive) of the whole population, for evaluation and
        saving: the state's own here."""
        return self.base.g, self.base.alive

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
            idx = self._step_cameras(pop=True)
            with span("step"):
                metrics = self.step(idx, self._fetch_gt(idx), it)

            if self.cfg.mcmc:
                # MCMC cadence (train.py:363-372,434-441): relocation at the
                # densification interval, position noise every step; no
                # densify, no opacity reset
                if opt.densify_from_iter < it < opt.densify_until_iter and \
                        it % opt.densification_interval == 0:
                    before = self.n_alive()
                    n_rel, n_add = self.relocate()
                    self.mcmc_log.append((it, n_rel, n_add, before,
                                          self.n_alive()))
                self.add_noise()
            elif it < opt.densify_until_iter:
                # densification cadence (train.py:374-389)
                if it > opt.densify_from_iter and \
                        it % opt.densification_interval == 0:
                    max_screen = 20.0 if it > opt.opacity_reset_interval else 0.0
                    before = self.n_alive()
                    res = self.densify(max_screen)
                    self.densify_log.append(
                        (it, res.n_cloned, res.n_split, res.n_pruned, before,
                         self.n_alive()))
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
