"""Calibrated training, the fisheye and cubemap modes (port of
`bags_tpu/train/calibrated.py`).

`--outside_rasterizer` (fisheye): render the scene at an extended field of
view, warp the render into the fisheye frame through the iResNet lens
field (or, with `--apply2gt`, the fisheye GT into perspective), take the
masked (1 - lambda) L1 + lambda (1 - SSIM), and optimise jointly the
Gaussians, the sampled camera's pose and FoV, the lens net
(`--iresnet_lr`, within `--iresnet_opt_duration`), the vignetting model
after `--start_vignetting` and the entrance-pupil shift (`--opt_shift`).
The extended-FoV geometry (`make_fisheye_setup`) follows the JAX package:
for apply2render the render spans focal2fov(f, flow_scale * W) at the
perspective size, and the camera FoVs the trainer optimises are reset to
those extended values.

`--cubemap` (fields of view past 180 degrees): five renders a step, the
camera and its four +-90 degree sub-cameras, each sorted by distance to
the camera, warped through the cubemap net's distortion field
(`calib/cubemap.py`), each face's masked L1 and SSIM against the
circular-masked perspective GT, (1 - lambda) sum L1 + lambda (5 - sum
SSIM). The Gaussians, the camera row and the cubemap net (every step, NaN
guarded) are optimised; evaluation stitches the faces by maximum
intensity.

The lens, cubemap, vignetting and shift groups keep Adam moments
(`optim.AdamMoments`, eps `ADAM_EPS`) with the learning rate applied
outside, from MultiStepLR schedules of the global step: lens x0.5 at
7000, cubemap x0.5 at 2000, 7000 and 9000, vignetting x10 at 1000, shift
x0.1 at 30000. The moments are optax's, in its order of rounding, not
`torch.optim.Adam`'s: the vignetting's first step (a_k 0.01, lr 0.01)
lands a_k on 0 within an ulp, and the sign of that ulp decides whether
the mask's clamp passes any gradient afterwards.

Checkpoints (`save_calib_checkpoint`, `load_calib_checkpoint`) hold the
base state under `.base` and the lens, cubemap, vignetting and shift
leaves and their Adam states under the JAX package's names
(`.lens.weights[0][1]`, `.cubemap_net.u_vecs[0][1]`, `.lens_opt.count`,
`.cubemap_opt.mu.weights[0][1]`, `.vig.a_k`, `.shift`, `.shift_opt.nu`,
...), so either package's checkpoint restores. The power-iteration vectors
`u_vecs` are constants, never trained: their moments are written as zeros
(what the JAX package holds for them) and not read.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..calib import cubemap as cubemap_lib
from ..calib import distortion as dist_lib
from ..calib.iresnet import IResNetParams, init_iresnet_params
from ..calib.vignetting import VignettingParams, vignetting_mask
from ..core.camera import CameraParams, CameraStatic, rotate_camera_pose
from ..core.lie import quat_to_rotmat
from ..model.densify import update_stats
from ..raster.render import RenderConfig, render
from ..utils.spans import span
from .checkpoint import PREFIX, copy_leaves, load_checkpoint, save_checkpoint
from .config import TrainConfig
from .loop import (StepMetrics, Trainer, TrainState, accumulate_stats,
                   extra_color, sample_views, split_views, step_optimizers,
                   step_specular, zero_spec_grads)
from .losses import l1_loss, photometric_loss, ssim
from .optim import (CAMERA_FIELDS, AdamMoments, adam_moments_init,
                    adam_moments_step, camera_lrs, multistep_schedule,
                    row_adam_update)

# Adam steps of the lens net's pre-fit to the COLMAP coefficients (the JAX
# package's count, `bags_tpu/train/calibrated.py:629`)
LENS_PREFIT_ITERS = 5000


# ---------------------------------------------------------------------------
# Extended-FoV fisheye geometry
# ---------------------------------------------------------------------------

def _focal2fov(f, px):
    return 2.0 * np.arctan(px / (2.0 * f))


@dataclasses.dataclass(frozen=True)
class FisheyeSetup:
    render_static: CameraStatic       # extended-FoV render size
    fish_hw: Tuple[int, int]          # fisheye GT (H, W)
    grid_hw: Tuple[int, int]          # control grid (h, w)
    flow_hw: Tuple[int, int]          # flow upsampling target (H, W)
    fovx: float                       # extended FoVs (the cameras' init)
    fovy: float


def make_fisheye_setup(focal_x: float, focal_y: float, persp_wh, fish_wh,
                       flow_scale=(1.0, 1.0), render_resolution: float = 1.0,
                       control_point_sample_scale: int = 8,
                       apply2gt: bool = False) -> FisheyeSetup:
    pw, ph = persp_wh
    fw, fh = fish_wh
    if not apply2gt:
        fovx = _focal2fov(focal_x, int(flow_scale[0] * pw))
        fovy = _focal2fov(focal_y, int(flow_scale[1] * ph))
        rw, rh = int(render_resolution * pw), int(render_resolution * ph)
        # the reference pairs the fisheye height with flow_scale[0] and the
        # width with flow_scale[1] (util_distortion.py:299); kept as it is
        flow_hw = (int(fh * flow_scale[0]), int(fw * flow_scale[1]))
    else:
        fovx = _focal2fov(focal_x, int(flow_scale[0] * fw))
        fovy = _focal2fov(focal_y, int(flow_scale[1] * fh))
        rw = int((flow_scale[0] / flow_scale[1]) * render_resolution * fw)
        rh = int(render_resolution * fh)
        flow_hw = (rh, rw)
    grid_hw = (max(rh // control_point_sample_scale, 2),
               max(rw // control_point_sample_scale, 2))
    return FisheyeSetup(
        render_static=CameraStatic(width=rw, height=rh),
        fish_hw=(fh, fw), grid_hw=grid_hw, flow_hw=flow_hw,
        fovx=float(fovx), fovy=float(fovy))


def fisheye_control_points(setup: FisheyeSetup, focal_x: float,
                           focal_y: float, flow_scale=(1.0, 1.0),
                           device=None) -> torch.Tensor:
    """The control grid over the flow-scaled fisheye sensor, back-projected
    through the recentred K: (grid_h * grid_w, 2)."""
    fh, fw = setup.fish_hw
    sensor_w = int(fw * flow_scale[0])
    sensor_h = int(fh * flow_scale[1])
    K = np.array([[focal_x, 0, sensor_w / 2],
                  [0, focal_y, sensor_h / 2],
                  [0, 0, 1.0]])
    _, view = dist_lib.make_control_grid(
        K, sensor_w, sensor_h, setup.grid_hw[1], setup.grid_hw[0],
        device=device)
    return view


# ---------------------------------------------------------------------------
# Calibrated state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CalibState:
    base: TrainState
    lens: IResNetParams
    lens_opt: AdamMoments
    cubemap_net: IResNetParams
    cubemap_opt: AdamMoments
    vig: VignettingParams
    vig_opt: AdamMoments
    shift: torch.Tensor
    shift_opt: AdamMoments

    def groups(self) -> Dict[str, Tuple[Dict[str, torch.Tensor],
                                        AdamMoments]]:
        """Each Adam group by its JAX name: (its tensors by their JAX
        paths, its moments)."""
        return {".lens_opt": (self.lens.named_tensors(True), self.lens_opt),
                ".cubemap_opt": (self.cubemap_net.named_tensors(True),
                                 self.cubemap_opt),
                ".vig_opt": (self.vig.named_tensors(), self.vig_opt),
                ".shift_opt": ({"": self.shift}, self.shift_opt)}


def calib_schedules(cfg: TrainConfig) -> Dict[str, Callable[[int], float]]:
    """Each group's learning rate at a global step (MultiStepLR)."""
    return {
        "lens": multistep_schedule(cfg.calib.iresnet_lr, (7000,), 0.5),
        "cubemap": multistep_schedule(cfg.calib.iresnet_lr,
                                      (2000, 7000, 9000), 0.5),
        "vig": multistep_schedule(0.01, (1000,), 10.0),
        "shift": multistep_schedule(1e-5, (30000,), 0.1),
    }


def init_calib_state(base: TrainState, cfg: TrainConfig, seed: int = 0
                     ) -> Tuple[CalibState, Dict[str, Callable[[int], float]]]:
    """The state around `base` (lens net from `seed`, cubemap net from
    seed + 1, vignetting, zero shift, zero moments) and the schedules."""
    device = base.g.xyz.device
    lens = init_iresnet_params(seed=seed, device=device)
    cub = init_iresnet_params(seed=seed + 1, device=device)
    vig = VignettingParams.create(device=device)
    shift = torch.zeros(3, device=device)
    for t in [vig.a_k, vig.beta_k, shift]:
        t.requires_grad_(True)
    state = CalibState(
        base=base,
        lens=lens, lens_opt=adam_moments_init(lens.named_tensors(True)),
        cubemap_net=cub, cubemap_opt=adam_moments_init(cub.named_tensors(True)),
        vig=vig, vig_opt=adam_moments_init(vig.named_tensors()),
        shift=shift, shift_opt=adam_moments_init({"": shift}))
    return state, calib_schedules(cfg)


def _calib_leaves(cs: CalibState) -> Dict[str, torch.Tensor]:
    """The lens, cubemap, vignetting and shift leaves by their JAX names."""
    out = {".lens" + k: t for k, t in cs.lens.named_tensors().items()}
    out.update({".cubemap_net" + k: t
                for k, t in cs.cubemap_net.named_tensors().items()})
    out.update({".vig" + k: t for k, t in cs.vig.named_tensors().items()})
    out[".shift"] = cs.shift
    return out


def save_calib_checkpoint(path: str, cs: CalibState,
                          gather: Optional[Callable] = None,
                          write: bool = True) -> None:
    """Write `cs`: the base state under `.base`, then the calibration
    leaves and each group's step count and moments (the u_vecs' as
    zeros) under their JAX names. gather, write: a sharded base's, as
    `checkpoint.save_checkpoint` takes them (the calibration leaves are
    replicated)."""
    arrays = {k: t.detach().cpu().numpy() for k, t in _calib_leaves(cs).items()}
    for name, (named, st) in cs.groups().items():
        arrays[name + ".count"] = np.asarray(st.count, np.int32)
        for k in named:
            arrays[f"{name}.mu{k}"] = st.mu[k].cpu().numpy()
            arrays[f"{name}.nu{k}"] = st.nu[k].cpu().numpy()
    for net, name in ((cs.lens, ".lens_opt"), (cs.cubemap_net, ".cubemap_opt")):
        for k, t in net.named_tensors().items():
            if k.startswith(".u_vecs"):
                for m in ("mu", "nu"):
                    arrays[f"{name}.{m}{k}"] = np.zeros(tuple(t.shape),
                                                        np.float32)
    save_checkpoint(path, cs.base, pre=".base",
                    extra={PREFIX + k: v for k, v in arrays.items()},
                    gather=gather, write=write)


@torch.no_grad()
def load_calib_checkpoint(path: str, cs: CalibState,
                          with_optimizer: bool = True,
                          rows: Optional[slice] = None) -> CalibState:
    """Restore `cs` in place from either package's checkpoint and return
    it: the base state as `load_checkpoint` restores it (under `.base`;
    rows: a sharded base's block), and, `with_optimizer` or not, the
    calibration leaves and their Adam states, which carry the JAX names."""
    load_checkpoint(path, cs.base, with_optimizer, pre=".base", rows=rows)
    data = np.load(path)
    leaves = _calib_leaves(cs)
    for name, (named, st) in cs.groups().items():
        leaves.update({f"{name}.mu{k}": t for k, t in st.mu.items()})
        leaves.update({f"{name}.nu{k}": t for k, t in st.nu.items()})
    copy_leaves(data, path, leaves)
    for name, (_, st) in cs.groups().items():
        st.count = int(data[PREFIX + name + ".count"])
    return cs


# ---------------------------------------------------------------------------
# Fisheye train step
# ---------------------------------------------------------------------------

def _proj_scale(cam: CameraParams) -> torch.Tensor:
    return torch.stack([1.0 / torch.tan(cam.fovx * 0.5),
                        1.0 / torch.tan(cam.fovy * 0.5)])


def _grads_or_zeros(named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p))
            for k, p in named.items()}


def begin_fisheye_step(state: CalibState, opt_lens: bool) -> None:
    """Clear the gradients a fisheye step takes (the lens net's trained
    tensors require one only with opt_lens)."""
    for p in state.lens.named_tensors(trained_only=True).values():
        p.requires_grad_(opt_lens)
        p.grad = None
    for p in [state.vig.a_k, state.vig.beta_k, state.shift]:
        p.grad = None
    zero_spec_grads(state.base)


def fisheye_replicated(state: CalibState, cfg: TrainConfig, opt_lens: bool,
                       use_vignetting: bool) -> List[torch.Tensor]:
    """The calibration tensors a fisheye step trains: the lens net's with
    opt_lens, the vignetting's with use_vignetting, the shift with
    `--opt_shift`."""
    out = []
    if opt_lens:
        out += list(state.lens.named_tensors(trained_only=True).values())
    if use_vignetting:
        out += list(state.vig.named_tensors().values())
    if cfg.calib.opt_shift:
        out.append(state.shift)
    return out


def fisheye_optimizers(state: CalibState, cfg: TrainConfig, views, cam_idx,
                       schedules, opt_lens: bool, use_vignetting: bool,
                       radii: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """After a fisheye step's backward: the Gaussians', specular MLP's and
    camera rows' steps (`loop.step_optimizers`, no alignment), the lens
    net's (with opt_lens) behind the NaN guard, the vignetting's (with
    use_vignetting) and the shift's (`--opt_shift`) moments steps, the
    views' densify statistics (radii: each view's) and the step count.
    Returns every gradient by its JAX name."""
    b = state.base
    grads = step_optimizers(b, cfg, views, cam_idx, alignment=False)
    if opt_lens:
        lens_named = state.lens.named_tensors(trained_only=True)
        lens_grads = _grads_or_zeros(lens_named)
        grads.update({".lens" + k: v for k, v in lens_grads.items()})
        bad = torch.stack([~torch.isfinite(v).all()
                           for v in lens_grads.values()]).any()
        lens_grads = {k: torch.where(bad, torch.zeros_like(v), v)
                      for k, v in lens_grads.items()}
        adam_moments_step(lens_named, lens_grads, state.lens_opt,
                          schedules["lens"](b.step))
    if use_vignetting:
        vig_named = state.vig.named_tensors()
        vig_grads = _grads_or_zeros(vig_named)
        grads.update({".vig" + k: v for k, v in vig_grads.items()})
        adam_moments_step(vig_named, vig_grads, state.vig_opt,
                          schedules["vig"](b.step))
    if cfg.calib.opt_shift:
        shift_grads = _grads_or_zeros({"": state.shift})
        grads[".shift"] = shift_grads[""]
        adam_moments_step({"": state.shift}, shift_grads, state.shift_opt,
                          schedules["shift"](b.step))
    accumulate_stats(b, [v.probe.grad for v in views],
                     [v.absp.grad for v in views], radii)
    b.step += 1
    return grads


def fisheye_train_step(state: CalibState, fish_gt: torch.Tensor,
                       p_view: torch.Tensor, cam_idx, bg: torch.Tensor,
                       setup: FisheyeSetup, rcfg: RenderConfig,
                       cfg: TrainConfig, schedules, opt_lens: bool,
                       use_vignetting: bool) -> StepMetrics:
    """One fisheye step on camera `cam_idx` against `fish_gt` (3, H, W);
    updates `state` in place (`make_fisheye_train_step`, calibrated.py:206).

    The Gaussians take the six-group Adam step, the camera row its row Adam
    step, the lens net (with opt_lens) its moments step behind the NaN
    guard: a non-finite lens gradient zeroes every lens gradient and the
    moments still step, so the lens moves by its decayed first moment. The
    vignetting model steps with use_vignetting, the shift with
    `--opt_shift`. A hybrid state's render adds the specular colour and its
    MLP steps (`loop.step_specular`). The lens flow and warp run under the
    span "lens", the masks, vignetting and loss under "loss".

    `--batch_cams` K > 1: `cam_idx` is K distinct camera rows and `fish_gt`
    (K, 3, H, W); the K views (render, lens flow, warp, loss) run one after
    another and one backward of their mean loss steps every group once
    (calibrated.py:280-300); the image is then (K, 3, H, W) and n_dropped
    the sum of the views'."""
    calib = cfg.calib
    b = state.base
    g = b.g
    static = setup.render_static
    apply2gt = calib.apply2gt
    batch, idxs, gts = split_views(cam_idx, fish_gt)
    views = sample_views(b, idxs, b.capacity)
    begin_fisheye_step(state, opt_lens)

    outs, images, losses = [], [], []
    for v, gt_k in zip(views, gts):
        out = render(g.xyz, g.scaling(), g.quats, g.opacity(b.alive),
                     g.sh_coeffs(), v.cam, static, rcfg, bg=bg, align=b.align,
                     probe2d=v.probe, abs_probe=v.absp,
                     extra_color=extra_color(b, v.cam),
                     shift_factors=state.shift if calib.opt_shift else None)
        with span("lens"):
            flow = dist_lib.compute_flow(state.lens, p_view, setup.grid_hw,
                                         _proj_scale(v.cam), setup.flow_hw,
                                         sensor_to_frustum=apply2gt)
            warped, mask, _ = dist_lib.apply_distortion(
                state.lens, p_view, setup.grid_hw,
                gt_k if apply2gt else out.render, None, setup.flow_hw,
                final_hw=None if apply2gt else setup.fish_hw,
                apply2gt=apply2gt, flow=flow)
        with span("loss"):
            if not apply2gt:
                gt_img = gt_k
                if use_vignetting:
                    mask = mask * vignetting_mask(state.vig,
                                                  *setup.fish_hw)[None]
                if not calib.no_distortion_mask:
                    gt_img = gt_img * mask
                image = warped
                loss = photometric_loss(warped, gt_img, cfg.opt.lambda_dssim)
            else:
                # the render against the GT warped into perspective
                image = out.render
                if use_vignetting:
                    mask = mask * vignetting_mask(state.vig, static.height,
                                                  static.width)[None]
                if not calib.no_distortion_mask:
                    image = image * mask
                loss = photometric_loss(image, warped, cfg.opt.lambda_dssim)
        outs.append(out)
        images.append(image)
        losses.append(loss)
    with span("loss"):
        loss = losses[0] if batch is None else torch.stack(losses).mean()

    with span("optimizers"):
        b.g_opt.zero_grad()
    with span("backward"):
        loss.backward()

    with span("optimizers"):
        grads = fisheye_optimizers(state, cfg, views, cam_idx, schedules,
                                   opt_lens, use_vignetting,
                                   [o.radii for o in outs])
    image = images[0] if batch is None else torch.stack(images)
    return StepMetrics(loss=loss.detach(), l1=loss.detach(),
                       n_alive=b.alive.sum(),
                       n_dropped=sum(o.n_dropped for o in outs),
                       image=image.detach(), grads=grads)


# ---------------------------------------------------------------------------
# Cubemap train step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CubemapSetup:
    """The cubemap mode's constants: the scene's own render size, K of
    the dataset's focal lengths, the forward face's 90-degree square mask
    (1, H, W), the circular mask (3, H, W) and the control grid's sample
    scale."""
    static: CameraStatic
    K: np.ndarray
    mask90: torch.Tensor
    circ: torch.Tensor
    scale: int


def make_cubemap_setup(static: CameraStatic, focal_x: float, focal_y: float,
                       cfg: TrainConfig, device=None) -> CubemapSetup:
    K = np.array([[focal_x, 0, static.width / 2],
                  [0, focal_y, static.height / 2], [0, 0, 1.0]])
    return CubemapSetup(
        static=static, K=K,
        mask90=cubemap_lib.fov90_square_mask(static.height, static.width,
                                             focal_x, focal_y, device),
        circ=cubemap_lib.circular_mask(static.height, static.width,
                                       cfg.calib.mask_radius, device),
        scale=int(cfg.calib.control_point_sample_scale))


def build_sub_cameras(cams: CameraParams) -> List[CameraParams]:
    """The five +-90 degree sub-camera batches of `cams` (n, ...), in
    `cubemap.SUB_CAMERA_ROTATIONS` order, from each camera's effective pose
    quat_to_rotmat(q_init + dq), t_init + dt (the additive quaternion of
    `core.camera.pose_w2c`). Each keeps the cameras' FoVs."""
    with torch.no_grad():
        R = quat_to_rotmat(cams.q_init + cams.dq)
        t = cams.t_init + cams.dt
        subs = []
        for degs in cubemap_lib.SUB_CAMERA_ROTATIONS:
            poses = [rotate_camera_pose(R[i], t[i], *degs)
                     for i in range(R.shape[0])]
            subs.append(CameraParams.create(
                torch.stack([r for r, _ in poses]),
                torch.stack([tt for _, tt in poses]),
                cams.fovx.detach().clone(), cams.fovy.detach().clone()))
    return subs


def sub_camera_poses(cams: CameraParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """The up, down, left and right sub-cameras' base poses of `cams` (n,
    ...): q (n, 4, 4) and t (n, 4, 3)."""
    subs = build_sub_cameras(cams)[:4]
    return (torch.stack([s.q_init for s in subs], dim=1),
            torch.stack([s.t_init for s in subs], dim=1))


def face_cameras(cam: CameraParams, sub_q: torch.Tensor,
                 sub_t: torch.Tensor) -> List[CameraParams]:
    """The five face cameras of one camera row (FACES order): the camera
    itself, then its sub-cameras, which replace only q_init / t_init by
    sub_q[f] / sub_t[f] (4, ...) and so share the row's dq, dt and FoVs."""
    return [cam] + [dataclasses.replace(cam, q_init=sub_q[f], t_init=sub_t[f])
                    for f in range(4)]


def _half_masks(circ: torch.Tensor) -> List[torch.Tensor]:
    """Each face's half mask, FACES order (the forward face's is ones)."""
    ones = torch.ones_like(circ)
    return [ones] + [cubemap_lib.mask_half(ones, f)
                     for f in cubemap_lib.FACES[1:]]


def begin_cubemap_step(state: CalibState, cam_idx: int):
    """The sampled camera's View (`loop.sample_views`, probes of the
    state's capacity) with the cubemap net's and the specular MLP's
    gradients cleared."""
    for p in state.cubemap_net.named_tensors(trained_only=True).values():
        p.requires_grad_(True)
        p.grad = None
    zero_spec_grads(state.base)
    return sample_views(state.base, [cam_idx], state.base.capacity)[0]


def cubemap_optimizers(state: CalibState, cfg: TrainConfig, view, cam_idx: int,
                       schedules, radii: torch.Tensor) -> Dict[str, torch.Tensor]:
    """After a cubemap step's backward: the Gaussians' Adam step, the camera
    row's row Adam step, the specular MLP's, the cubemap net's moments step
    behind the NaN guard, the densify statistics of the main render (its
    radii) and the step count. Returns every gradient by its JAX name."""
    b = state.base
    b.g_opt.param_groups[0]["lr"] = b.xyz_sched(b.step)
    b.g_opt.step()
    row_grads = {f: view.row[f].grad for f in CAMERA_FIELDS}
    row_adam_update(b.cams, b.cam_opt, row_grads, cam_idx,
                    camera_lrs(cfg.calib, b.step))
    cub_named = state.cubemap_net.named_tensors(trained_only=True)
    cub_grads = _grads_or_zeros(cub_named)
    grads = {f".g.{k}": t.grad for k, t in b.g.fields().items()}
    grads.update({f".cam.{f}": v for f, v in row_grads.items()})
    grads.update(step_specular(b))
    grads.update({".cubemap_net" + k: v for k, v in cub_grads.items()})
    bad = torch.stack([~torch.isfinite(v).all()
                       for v in cub_grads.values()]).any()
    cub_grads = {k: torch.where(bad, torch.zeros_like(v), v)
                 for k, v in cub_grads.items()}
    adam_moments_step(cub_named, cub_grads, state.cubemap_opt,
                      schedules["cubemap"](b.step))
    with torch.no_grad():
        b.stats = update_stats(b.stats, view.probe.grad, view.absp.grad, radii,
                               radii > 0)
    b.step += 1
    return grads


def cubemap_train_step(state: CalibState, gt: torch.Tensor, cam_idx: int,
                       bg: torch.Tensor, sub_q: torch.Tensor,
                       sub_t: torch.Tensor, setup: CubemapSetup,
                       rcfg: RenderConfig, cfg: TrainConfig, schedules
                       ) -> StepMetrics:
    """One cubemap step on camera `cam_idx` against its GT (3, H, W), the
    dataset's perspective image; updates `state` in place
    (`make_cubemap_train_step`, calibrated.py:453).

    Five renders sorted by distance to the camera, one of each of
    `face_cameras`, so that the row's gradient sums over them. Only the
    main render carries the densify probes. The faces are warped
    (`cubemap.render_cubemap_faces`) and the loss is (1 - lambda) sum L1 +
    lambda (5 - sum SSIM) of img * circ * half_mask against
    gt * circ * half_mask. The Gaussians take their Adam step, the camera
    row its row Adam step and the cubemap net its moments step on every
    step behind the NaN guard (a non-finite gradient zeroes them all; the
    moments still step). A hybrid state adds the specular colour seen from
    the camera to all five renders (the faces share its centre) and steps
    its MLP. The ray field and warps run under the span "lens"
    (`render_cubemap_faces`), the masked losses under "loss". The metrics
    carry each face's binned instance count (`face_instances`), which
    binning holds on the host."""
    b = state.base
    g = b.g
    rcfg = dataclasses.replace(rcfg, sort_by_distance=True)
    view = begin_cubemap_step(state, cam_idx)

    gauss = (g.xyz, g.scaling(), g.quats, g.opacity(b.alive), g.sh_coeffs())
    extra = extra_color(b, view.cam)
    main_cam, *side_cams = face_cameras(view.cam, sub_q, sub_t)
    main = render(*gauss, main_cam, setup.static, rcfg, bg=bg, align=b.align,
                  probe2d=view.probe, abs_probe=view.absp, extra_color=extra)
    outs = [main] + [render(*gauss, c, setup.static, rcfg, bg=bg,
                            align=b.align, extra_color=extra)
                     for c in side_cams]
    faces, _ = cubemap_lib.render_cubemap_faces(
        lambda i: outs[i].render, state.cubemap_net, setup.K,
        setup.static.width, setup.static.height, setup.scale, setup.mask90)
    with span("loss"):
        l1_sum = ssim_sum = 0.0
        for img, hm in zip(faces, _half_masks(setup.circ)):
            a, ref = img * setup.circ * hm, gt * setup.circ * hm
            l1_sum = l1_sum + l1_loss(a, ref)
            ssim_sum = ssim_sum + ssim(a, ref)
        lam = cfg.opt.lambda_dssim
        loss = (1 - lam) * l1_sum + lam * (5.0 - ssim_sum)

    with span("optimizers"):
        b.g_opt.zero_grad()
    with span("backward"):
        loss.backward()

    with span("optimizers"):
        grads = cubemap_optimizers(state, cfg, view, cam_idx, schedules,
                                   main.radii)
    return StepMetrics(loss=loss.detach(), l1=loss.detach(),
                       n_alive=b.alive.sum(),
                       n_dropped=sum(o.n_dropped for o in outs),
                       image=faces[0].detach(), grads=grads,
                       face_instances=[o.gauss_id.shape[0] for o in outs])


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

class CalibTrainer(Trainer):
    """Trainer of the fisheye mode (`--outside_rasterizer`) and the cubemap
    mode (`--cubemap`, which takes precedence).

    Fisheye: builds the extended-FoV setup and control points, resets the
    camera FoVs to the extended ones, pre-fits the lens net to the COLMAP
    coefficients (`--opt_distortion` without `--no_init_iresnet`;
    `LENS_PREFIT_ITERS` Adam steps, the time in `prefit_s`) and drives
    `fisheye_train_step`. The lens steps while iresnet_opt_duration[0] <=
    it < iresnet_opt_duration[1] and it >= start_opt_lens; vignetting after
    start_vignetting. The step's GT is the fisheye image: `fish_images`
    (idx -> (3, H, W)) when given, else `gt_images`.

    Cubemap: keeps the scene's size and FoVs, pre-fits the cubemap net
    (`init_cubemap_net`, unless `--no_init_iresnet`; the time in
    `prefit_s`), builds every camera's sub-camera poses once (`sub_q`,
    `sub_t`) and drives `cubemap_train_step` against `gt_images`. Its net
    steps on every iteration, as the JAX package's does: the lens window
    does not apply to it.

    Either way the TrainState is wrapped in a CalibState, and the base
    trainer's cadences and prefetch run the steps."""

    def __init__(self, g, alive, cams, static, cfg: TrainConfig,
                 scene_extent: float, gt_images, focal_x: float,
                 focal_y: float, persp_wh, fish_wh=None, source_path: str = "",
                 bg=None, rcfg: Optional[RenderConfig] = None, seed: int = 0,
                 fish_images=None):
        calib = cfg.calib
        if cfg.opt.batch_cams > 1 and calib.cubemap:
            raise ValueError("--batch_cams > 1 is not supported with "
                             "--cubemap (use the fisheye mode or K=1)")
        self.mode = "cubemap" if calib.cubemap else "fisheye"
        self.focal = (float(focal_x), float(focal_y))
        self.prefit_s = None
        device = g.xyz.device
        if self.mode == "cubemap":
            super().__init__(g, alive, cams, static, cfg, scene_extent,
                             gt_images, bg=bg, rcfg=rcfg, seed=seed)
            self.setup = make_cubemap_setup(static, focal_x, focal_y, cfg,
                                            device)
            self.state, self.schedules = init_calib_state(self.state, cfg,
                                                          seed)
            if not calib.no_init_iresnet:
                coeff = (dist_lib.read_colmap_coeff(source_path)
                         if source_path else [0.0, 0.0, 0.0, 0.0])
                print(f"pre-fitting the cubemap net to coeff {coeff} ...",
                      flush=True)
                self.prefit_s = _timed(lambda: dist_lib.init_cubemap_net(
                    self.state.cubemap_net, coeff), device)
                print(f"cubemap pre-fit: {self.prefit_s:.2f} s", flush=True)
            self.sub_q, self.sub_t = sub_camera_poses(self.base.cams)
            return
        fish_wh = fish_wh or persp_wh
        self.setup = make_fisheye_setup(
            focal_x, focal_y, persp_wh, fish_wh, flow_scale=calib.flow_scale,
            render_resolution=calib.render_resolution,
            control_point_sample_scale=int(calib.control_point_sample_scale),
            apply2gt=calib.apply2gt)
        cams = dataclasses.replace(
            cams, fovx=torch.full_like(cams.fovx, self.setup.fovx),
            fovy=torch.full_like(cams.fovy, self.setup.fovy))
        super().__init__(g, alive, cams, self.setup.render_static, cfg,
                         scene_extent,
                         fish_images if fish_images is not None else gt_images,
                         bg=bg, rcfg=rcfg, seed=seed)
        self.p_view = fisheye_control_points(
            self.setup, focal_x, focal_y, calib.flow_scale, device=device)
        self.state, self.schedules = init_calib_state(self.state, cfg, seed)
        if calib.opt_distortion and not calib.no_init_iresnet:
            coeff = (dist_lib.read_colmap_coeff(source_path) if source_path
                     else [0.0, 0.0, 0.0, 0.0])
            K = np.array([[focal_x, 0, fish_wh[0] / 2],
                          [0, focal_y, fish_wh[1] / 2], [0, 0, 1.0]])
            print(f"pre-fitting lens net to coeff {coeff} "
                  f"({LENS_PREFIT_ITERS} Adam steps) ...", flush=True)
            self.prefit_s = _timed(lambda: dist_lib.init_iresnet_from_colmap(
                self.state.lens, K, fish_wh[0], fish_wh[1], coeff,
                iters=LENS_PREFIT_ITERS), device)
            print(f"lens pre-fit: {self.prefit_s:.2f} s", flush=True)

    @property
    def base(self) -> TrainState:
        return self.state.base

    def save_checkpoint(self, path: str) -> None:
        save_calib_checkpoint(path, self.state)

    def load_checkpoint(self, path: str, with_optimizer: bool = True) -> None:
        load_calib_checkpoint(path, self.state, with_optimizer)

    def lens_window(self, it: int) -> Tuple[bool, bool]:
        """(opt_lens, use_vignetting) at iteration `it`."""
        calib = self.cfg.calib
        opt_lens = (calib.opt_distortion
                    and calib.iresnet_opt_duration[0] <= it
                    < calib.iresnet_opt_duration[1]
                    and it >= calib.start_opt_lens)
        return opt_lens, it > calib.start_vignetting

    def step(self, idx: int, gt: torch.Tensor, it: Optional[int] = None
             ) -> StepMetrics:
        """One step of the trainer's mode on camera idx against its GT (the
        fisheye image, or the cubemap mode's perspective image) at
        iteration `it` of `run` (the next step's number when None)."""
        rcfg = dataclasses.replace(self.rcfg, sh_degree=self.active_sh_degree)
        if self.mode == "cubemap":
            return cubemap_train_step(self.state, gt, idx, self.bg,
                                      self.sub_q[idx], self.sub_t[idx],
                                      self.setup, rcfg, self.cfg,
                                      self.schedules)
        opt_lens, use_vig = self.lens_window(
            self.base.step + 1 if it is None else it)
        return fisheye_train_step(self.state, gt, self.p_view, idx, self.bg,
                                  self.setup, rcfg, self.cfg, self.schedules,
                                  opt_lens, use_vig)


def _timed(fn, device) -> float:
    """Seconds of fn(), the device synchronised after it."""
    t0 = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def _eval_state(trainer: CalibTrainer, population) -> CalibState:
    """The trainer's state, or with population = (Gaussians, alive) (a
    sharded trainer's gathered population) the state on those."""
    if population is None:
        return trainer.state
    g, alive = population
    return dataclasses.replace(trainer.state, base=dataclasses.replace(
        trainer.base, g=g, alive=alive))


def fisheye_eval_view(trainer: CalibTrainer, eval_one, scene, split: str,
                      cams: CameraParams, i: int, population=None):
    """View i of a split as evaluation and the render CLI take it: camera i
    of `cams` at the extended FoV, through `eval_one` (of
    `make_fisheye_eval_fn`) against its fisheye GT, or its perspective
    image where the view has no fisheye pair; population: (Gaussians,
    alive) in place of the trainer's own (under a mesh, the gathered
    one). Returns (image, gt, instances dropped)."""
    test = split == "test"
    infos = scene.test_infos if test else scene.train_infos
    gt_fn = ((scene.test_fish_image if test else scene.fish_image)
             if infos[i].fish_image_path else
             (scene.test_image if test else scene.train_image))
    cam = dataclasses.replace(
        cams[i], fovx=torch.full_like(cams.fovx[i], trainer.setup.fovx),
        fovy=torch.full_like(cams.fovy[i], trainer.setup.fovy))
    return eval_one(_eval_state(trainer, population), cam, gt_fn(i))


def make_fisheye_eval_fn(trainer: CalibTrainer,
                         max_instances: Optional[int] = None):
    """Held-out evaluation of the fisheye mode: render at the extended FoV
    (no background, no alignment, the full SH degree, at most
    `max_instances` instances; a hybrid model's specular colour seen from
    the aligned camera), warp through the current lens field and
    compare with the fisheye GT. Returns eval_one(state, cam, fish_gt) ->
    (image, gt, instances dropped), image and gt clipped / masked."""
    setup = trainer.setup
    rcfg = dataclasses.replace(trainer.rcfg, sh_degree=trainer.max_sh_degree,
                               max_instances=max_instances)
    static = setup.render_static
    apply2gt = trainer.cfg.calib.apply2gt

    @torch.no_grad()
    def eval_one(state: CalibState, cam: CameraParams, fish_gt: torch.Tensor):
        g = state.base.g
        out = render(g.xyz, g.scaling(), g.quats, g.opacity(state.base.alive),
                     g.sh_coeffs(), cam, static, rcfg,
                     bg=torch.zeros(3, device=g.xyz.device),
                     extra_color=extra_color(state.base, cam))
        if not apply2gt:
            warped, mask, _ = dist_lib.apply_distortion(
                state.lens, trainer.p_view, setup.grid_hw, out.render,
                _proj_scale(cam), setup.flow_hw, final_hw=setup.fish_hw,
                apply2gt=False)
            return torch.clamp(warped, 0.0, 1.0), fish_gt * mask, out.n_dropped
        gt_warped, mask, _ = dist_lib.apply_distortion(
            state.lens, trainer.p_view, setup.grid_hw, fish_gt,
            _proj_scale(cam), setup.flow_hw, apply2gt=True)
        return (torch.clamp(out.render * mask, 0.0, 1.0), gt_warped,
                out.n_dropped)

    return eval_one


def max_intensity_stitch(faces: List[torch.Tensor]) -> torch.Tensor:
    """The warped faces (FACES order) stitched into one image: each pixel
    takes the half-masked face of largest channel sum, the first one on a
    tie, 0 where every face is 0."""
    final = torch.zeros_like(faces[0])
    intensity = final.sum(dim=0, keepdim=True)
    for img, hm in zip(faces, _half_masks(faces[0])):
        masked = img * hm
        inten = masked.sum(dim=0, keepdim=True)
        sel = inten > intensity
        final = torch.where(sel, masked, final)
        intensity = torch.where(sel, inten, intensity)
    return final


def make_cubemap_eval_fn(trainer: CalibTrainer):
    """Held-out evaluation of the cubemap mode: the five faces rendered at
    the full SH degree (sorted by distance, no background, the trainer's
    instance budget; a hybrid model's specular colour seen from the
    camera on all five), warped through the current cubemap net, stitched by
    `max_intensity_stitch` and circular-masked, against the
    circular-masked GT. Returns eval_one(state, cam, gt, sub_q, sub_t) ->
    (image clipped to [0, 1], gt, instances dropped)."""
    setup = trainer.setup
    rcfg = dataclasses.replace(trainer.rcfg, sh_degree=trainer.max_sh_degree,
                               sort_by_distance=True)

    @torch.no_grad()
    def eval_one(state: CalibState, cam: CameraParams, gt: torch.Tensor,
                 sub_q: torch.Tensor, sub_t: torch.Tensor):
        b = state.base
        g = b.g
        gauss = (g.xyz, g.scaling(), g.quats, g.opacity(b.alive),
                 g.sh_coeffs())
        bg = torch.zeros(3, device=g.xyz.device)
        extra = extra_color(b, cam)
        outs = [render(*gauss, c, setup.static, rcfg, bg=bg, align=b.align,
                       extra_color=extra)
                for c in face_cameras(cam, sub_q, sub_t)]
        faces, _ = cubemap_lib.render_cubemap_faces(
            lambda i: outs[i].render, state.cubemap_net, setup.K,
            setup.static.width, setup.static.height, setup.scale,
            setup.mask90)
        final = max_intensity_stitch(faces)
        return (torch.clamp(final * setup.circ, 0.0, 1.0), gt * setup.circ,
                sum(o.n_dropped for o in outs))

    return eval_one


def cubemap_eval_view(trainer: CalibTrainer, eval_one, scene, split: str,
                      cams: CameraParams, i: int, population=None):
    """View i of a split through `eval_one` (of `make_cubemap_eval_fn`)
    against its perspective image: a training view with the sub-camera
    poses the trainer built at its start, a test view with its own;
    population as `fisheye_eval_view` takes it. Returns (image, gt,
    instances dropped)."""
    if split == "test":
        sub_q, sub_t = sub_camera_poses(cams[i:i + 1])
        sub_q, sub_t, gt = sub_q[0], sub_t[0], scene.test_image(i)
    else:
        sub_q, sub_t = trainer.sub_q[i], trainer.sub_t[i]
        gt = scene.train_image(i)
    return eval_one(_eval_state(trainer, population), cams[i], gt, sub_q, sub_t)
