"""Optimizers (port of `bags_tpu/train/optim.py` and the row Adam of
`bags_tpu/train/loop.py:45-112`).

  * The Gaussians: one `torch.optim.Adam` with six parameter groups, betas
    0.9 / 0.999, eps 1e-15: xyz with the exponential schedule (set each
    step from the global iteration), f_dc 2.5e-3, f_rest / 20, opacity
    5e-2, scaling 5e-3, rotation 1e-3, and with `--hybrid` a seventh,
    the ASG features at feature_lr.
  * The specular MLP (`--hybrid`): optax-ordered Adam moments
    (`AdamMoments`) at the linear-noise schedule of its own update count,
    feature_lr -> feature_lr / 20 over specular_lr_max_steps.
  * The cameras: one Adam state per camera row with its own step count;
    only the sampled row moves, and its learning rates follow MultiStepLR
    counted in GLOBAL iterations (the reference steps its schedulers once
    per iteration).
  * The global alignment: a plain Adam (lr 0.01), stepped only with
    `--opt_global_alignment`.

torch.optim.Adam(lr, eps) is optax.adam(lr, eps=eps, eps_root=0): eps sits
outside the square root.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence

import torch

from ..core.camera import CameraParams, GlobalAlignment
from ..model.gaussians import Gaussians
from .config import CalibConfig, OptimizationConfig

ADAM_EPS = 1e-15
BETAS = (0.9, 0.999)

# Adam group name -> Gaussians field, in the JAX package's label order.
GAUSSIAN_GROUPS = (("xyz", "xyz"), ("f_dc", "sh_dc"), ("f_rest", "sh_rest"),
                   ("opacity", "opacity_raw"), ("scaling", "scales_log"),
                   ("rotation", "quats"))
ASG_GROUP = ("asg", "asg")        # the seventh group, with --hybrid
# Learnable camera fields; q_init / t_init are frozen.
CAMERA_FIELDS = ("dq", "dt", "fovx", "fovy")


def expon_lr_schedule(lr_init: float, lr_final: float, max_steps: int,
                      lr_delay_steps: int = 0, lr_delay_mult: float = 1.0):
    """The 3DGS exponential schedule (`get_expon_lr_func`): log-space
    interpolation with an optional sine-eased warm-up delay."""

    def schedule(step) -> float:
        t = min(max(step / max_steps, 0.0), 1.0)
        log_lerp = math.exp(math.log(lr_init) * (1 - t)
                            + math.log(lr_final) * t)
        if lr_delay_steps > 0:
            delay = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
                0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
        else:
            delay = 1.0
        return delay * log_lerp

    return schedule


def multistep_schedule(base_lr: float, milestones: Sequence[int], gamma: float):
    """torch MultiStepLR: lr * gamma^(#milestones passed)."""

    def schedule(step) -> float:
        return base_lr * gamma ** sum(step >= m for m in milestones)

    return schedule


def linear_noise_schedule(lr_init: float, lr_final: float, max_steps: int):
    """The reference's `get_linear_noise_func` as the specular MLP uses it:
    LINEAR interpolation (its warm-up delay is off there)."""

    def schedule(step) -> float:
        t = min(max(step / max_steps, 0.0), 1.0)
        return lr_init * (1 - t) + lr_final * t

    return schedule


def specular_schedule(opt: OptimizationConfig):
    """The specular MLP's lr at its update count (`make_specular_optimizer`,
    bags_tpu/train/optim.py:112-120, whose lr_delay_steps of 0 leaves no
    delay)."""
    return linear_noise_schedule(opt.feature_lr, opt.feature_lr / 20.0,
                                 opt.specular_lr_max_steps)


def gaussian_groups(g: Gaussians):
    """(Adam group name, Gaussians field) of every group of `g`, in the JAX
    package's label order: six, and the ASG group when g.asg is set."""
    return GAUSSIAN_GROUPS + ((ASG_GROUP,) if g.asg is not None else ())


def make_gaussian_optimizer(g: Gaussians, opt: OptimizationConfig,
                            spatial_lr_scale: float):
    """Adam over the Gaussians' leaf tensors, a group a field
    (`gaussian_groups`). Returns the optimizer and the xyz schedule, whose
    value the caller sets as the xyz group's lr before each step."""
    xyz_sched = expon_lr_schedule(
        opt.position_lr_init * spatial_lr_scale,
        opt.position_lr_final * spatial_lr_scale,
        opt.position_lr_max_steps, lr_delay_mult=opt.position_lr_delay_mult)
    lrs = {"xyz": xyz_sched(0), "f_dc": opt.feature_lr,
           "f_rest": opt.feature_lr / 20.0, "opacity": opt.opacity_lr,
           "scaling": opt.scaling_lr, "rotation": opt.rotation_lr,
           "asg": opt.feature_lr}
    groups = [{"params": [getattr(g, field)], "lr": lrs[name], "name": name}
              for name, field in gaussian_groups(g)]
    return torch.optim.Adam(groups, betas=BETAS, eps=ADAM_EPS), xyz_sched


def make_alignment_optimizer(align: GlobalAlignment, calib: CalibConfig):
    """Global SIM(3) alignment Adam (`scene/__init__.py:200-202`)."""
    return torch.optim.Adam([align.quaternion, align.log_scale],
                            lr=calib.global_alignment_lr, betas=BETAS,
                            eps=ADAM_EPS)


@dataclasses.dataclass
class RowAdamState:
    """Adam moments batched over cameras with per-row step counts, so that
    stepping only the sampled camera each iteration reproduces the
    reference's one optimizer per camera."""

    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: torch.Tensor  # (n_cams,) int32


def row_adam_init(cams: CameraParams) -> RowAdamState:
    return RowAdamState(
        mu={f: torch.zeros_like(getattr(cams, f)) for f in CAMERA_FIELDS},
        nu={f: torch.zeros_like(getattr(cams, f)) for f in CAMERA_FIELDS},
        count=torch.zeros(cams.fovx.shape[0], dtype=torch.int32,
                          device=cams.fovx.device))


def camera_lrs(calib: CalibConfig, global_step: int) -> Dict[str, float]:
    """Per-field learning rates at global iteration `global_step`
    (`_camera_lr_tree`, loop.py:64-81): the MultiStepLR milestones count
    global iterations, not per-camera steps."""
    rot_lr, trans_lr = calib.r_t_lr
    rot = multistep_schedule(rot_lr if calib.opt_cam else 0.0,
                             calib.pose_lr_milestones, calib.pose_lr_gamma)
    trans = multistep_schedule(trans_lr if calib.opt_cam else 0.0,
                               calib.pose_lr_milestones, calib.pose_lr_gamma)
    fov = calib.fov_lr if calib.opt_intrinsic else 0.0
    return {"dq": rot(global_step), "dt": trans(global_step), "fovx": fov,
            "fovy": fov}


@torch.no_grad()
def row_adam_update(cams: CameraParams, st: RowAdamState,
                    row_grads: Dict[str, torch.Tensor], idx,
                    lrs: Dict[str, float]) -> None:
    """One Adam step of camera row `idx` in place; every other row, its
    moments and its step count stay as they are. With a sequence of K
    distinct rows (`--batch_cams`), `row_grads` holds (K, ...) gradients
    and each row takes its own step with its own count's bias correction
    (`row_adam_update`, loop.py:84-112); the learning rates are the global
    step's for all of them."""
    if not isinstance(idx, int):
        rows = [int(i) for i in idx]
        if len(set(rows)) != len(rows):
            raise ValueError(f"camera rows {rows} are not distinct")
        for k, i in enumerate(rows):
            row_adam_update(cams, st, {f: g[k] for f, g in row_grads.items()},
                            i, lrs)
        return
    b1, b2 = BETAS
    t = int(st.count[idx]) + 1
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    for f in CAMERA_FIELDS:
        g = row_grads[f]
        mu = b1 * st.mu[f][idx] + (1 - b1) * g
        nu = b2 * st.nu[f][idx] + (1 - b2) * g * g
        step = lrs[f] * (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
        getattr(cams, f)[idx] -= step
        st.mu[f][idx] = mu
        st.nu[f][idx] = nu
    st.count[idx] = t


@dataclasses.dataclass
class AdamMoments:
    """optax.scale_by_adam's state (b1 0.9, b2 0.999, eps `ADAM_EPS`,
    eps_root 0) over named tensors: one step count and the first and second
    moments. The learning rate is applied outside it, from a schedule of the
    global iteration (the calibration groups)."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def adam_moments_init(params: Dict[str, torch.Tensor]) -> AdamMoments:
    return AdamMoments(
        count=0,
        mu={k: torch.zeros_like(p, requires_grad=False) for k, p in params.items()},
        nu={k: torch.zeros_like(p, requires_grad=False) for k, p in params.items()})


@torch.no_grad()
def adam_moments_step(params: Dict[str, torch.Tensor],
                      grads: Dict[str, torch.Tensor], st: AdamMoments,
                      lr: float) -> None:
    """One Adam step of every tensor in `params` in place. Every tensor
    steps, a zero gradient included: its moments decay and it moves by the
    decayed first moment, as optax's update does."""
    b1, b2 = BETAS
    st.count += 1
    bc1 = 1.0 - b1 ** st.count
    bc2 = 1.0 - b2 ** st.count
    for k, p in params.items():
        g = grads[k]
        mu = b1 * st.mu[k] + (1 - b1) * g
        nu = b2 * st.nu[k] + (1 - b2) * g * g
        p -= lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS))
        st.mu[k] = mu
        st.nu[k] = nu
