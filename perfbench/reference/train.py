"""Plain training steps of the two modes the benchmark trains: pose
refinement and the fisheye lens.

`train_steps` runs `n` steps from the benchmark's own initial state and
returns what the comparison reads: each step's loss, every leaf's first
gradient and every leaf after the last step. A step renders the camera
of the step (`render.render`, SH at the active degree), takes
(1 - lambda) L1 + lambda (1 - SSIM) against the GT (in the fisheye mode
after the lens warp, the GT masked where the warp reads nothing),
back-propagates to the Gaussians, the camera row and the lens net, and
takes Adam's step of each: the Gaussians' six groups (the positions on
the exponential schedule of the global step), the camera row (its own
step count), the lens net's moments while its window is open.

`dtype` and `tf32` choose the precision of the control; `fault` plants
a fault for the benchmark's own checks: "half" takes the loss over the
top half of the image rows only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from . import lens as lens_lib
from . import render as R
from .loss import AdamState, expon_lr, multistep, photometric

GAUSS_LEAVES = ("xyz", "sh_dc", "sh_rest", "scales_log", "quats", "opacity_raw")
CAM_LEAVES = ("dq", "dt", "fovx", "fovy")


@dataclasses.dataclass
class Hyper:
    """The learning rates and switches a configuration trains with."""

    lambda_dssim: float
    xyz_lr: tuple            # (init, final, max_steps), scaled by the extent
    feature_lr: float
    opacity_lr: float
    scaling_lr: float
    rotation_lr: float
    rot_lr: float            # camera rows, 0 without pose optimisation
    trans_lr: float
    fov_lr: float
    pose_milestones: tuple
    pose_gamma: float
    sh_degree: int
    lens_lr: float = 0.0     # fisheye: the lens net's Adam
    lens_milestones: tuple = (7000,)
    opt_lens: bool = False


@dataclasses.dataclass
class FisheyeGeometry:
    """The extended-FoV render and lens warp of the fisheye mode."""

    width: int               # render size
    height: int
    grid_hw: tuple
    flow_hw: tuple
    fish_hw: tuple
    p_view: torch.Tensor     # (gh * gw, 2) control points
    lens_seed: int


def _cast(t, dtype):
    return t.detach().to(dtype).clone()


def train_steps(params: Dict[str, torch.Tensor], cams: Dict[str, torch.Tensor],
                gts: torch.Tensor, order: List[int], hp: Hyper, bg: torch.Tensor,
                geometry: Optional[FisheyeGeometry] = None,
                dtype=torch.float32, tf32: bool = False,
                fault: Optional[str] = None) -> dict:
    """`len(order)` steps on the cameras `order` from the live parameters
    `params` (the Gaussians' raw leaves by GAUSS_LEAVES) and the camera
    table `cams` (q_init, t_init and the CAM_LEAVES, one row a camera).
    Returns dict(losses, grads (the first step's, by leaf), after (every
    leaf after the last step), all float32 on the device of `params`)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        return _run(params, cams, gts, order, hp, bg, geometry, dtype, fault)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _run(params, cams, gts, order, hp, bg, geometry, dtype, fault):
    g = {k: _cast(params[k], dtype).requires_grad_(True) for k in GAUSS_LEAVES}
    cam = {k: _cast(v, dtype) for k, v in cams.items()}
    bg = bg.to(dtype)
    lens = None
    if geometry is not None:
        ws, bs, us = lens_lib.init_lens(geometry.lens_seed, device=bg.device,
                                        dtype=dtype)
        lens = {"w": ws, "b": bs, "u": us}
    named = dict(g)
    if lens is not None:
        for b, blk in enumerate(lens["w"]):
            for l, t in enumerate(blk):
                named[f"lens.w[{b}][{l}]"] = t
        for b, blk in enumerate(lens["b"]):
            for l, t in enumerate(blk):
                named[f"lens.b[{b}][{l}]"] = t
    for k in list(named)[len(GAUSS_LEAVES):]:
        named[k].requires_grad_(hp.opt_lens)
    adam = {k: AdamState(t) for k, t in named.items()}
    cam_adam = {k: (torch.zeros_like(cam[k]), torch.zeros_like(cam[k]))
                for k in CAM_LEAVES}
    cam_count = [0] * cam["fovx"].shape[0]
    lrs = {"sh_dc": hp.feature_lr, "sh_rest": hp.feature_lr / 20.0,
           "opacity_raw": hp.opacity_lr, "scales_log": hp.scaling_lr,
           "quats": hp.rotation_lr}
    losses, first = [], None
    for step, ci in enumerate(order):
        row = {k: cam[k][ci].clone().requires_grad_(True) for k in CAM_LEAVES}
        Rw, tw = R.camera_pose(cam["q_init"][ci], cam["t_init"][ci], row["dq"],
                               row["dt"])
        scales = torch.exp(g["scales_log"])
        opac = torch.sigmoid(g["opacity_raw"])
        sh = torch.cat([g["sh_dc"], g["sh_rest"]], dim=1)
        if geometry is None:
            h, w = gts.shape[-2:]
            img = R.render(g["xyz"], scales, g["quats"], opac, sh, Rw, tw,
                           row["fovx"], row["fovy"], w, h, bg, hp.sh_degree)
            gt = gts[ci].to(dtype)
            pred = img
        else:
            img = R.render(g["xyz"], scales, g["quats"], opac, sh, Rw, tw,
                           row["fovx"], row["fovy"], geometry.width,
                           geometry.height, bg, hp.sh_degree)
            ctrl = lens_lib.inverse(lens["w"], lens["b"], lens["u"],
                                    geometry.p_view.to(dtype))
            scale = torch.stack([1.0 / torch.tan(row["fovx"] * 0.5),
                                 1.0 / torch.tan(row["fovy"] * 0.5)])
            flow = lens_lib.upsample(ctrl, geometry.grid_hw, scale,
                                     geometry.flow_hw)
            pred, mask = lens_lib.warp(img, flow, geometry.fish_hw)
            gt = gts[ci].to(dtype) * mask
        if fault == "half":
            half = pred.shape[-2] // 2
            pred, gt = pred[:, :half], gt[:, :half]
        loss = photometric(pred, gt, hp.lambda_dssim)
        trained = [t for t in named.values() if t.requires_grad]
        grads = torch.autograd.grad(loss, trained + [row[k] for k in CAM_LEAVES],
                                    allow_unused=True)
        by_name = {}
        names = [k for k, t in named.items() if t.requires_grad]
        for k, gr in zip(names + [f"cam.{c}" for c in CAM_LEAVES], grads):
            ref = named[k] if k in named else row[k[4:]]
            by_name[k] = gr if gr is not None else torch.zeros_like(ref)
        if hp.opt_lens and lens is not None:
            lens_g = [by_name[k] for k in names if k.startswith("lens.")]
            if not all(bool(torch.isfinite(x).all()) for x in lens_g):
                for k in names:
                    if k.startswith("lens."):
                        by_name[k] = torch.zeros_like(by_name[k])
        losses.append(float(loss.detach()))
        if first is None:
            first = {}
            for k, v in by_name.items():
                if k.startswith("cam."):
                    full = torch.zeros_like(cam[k[4:]])
                    full[ci] = v
                    first[k] = full.float()
                else:
                    first[k] = v.float()
        with torch.no_grad():
            xyz_lr = expon_lr(step, *hp.xyz_lr)
            for k in GAUSS_LEAVES:
                adam[k].step(g[k], by_name[k], xyz_lr if k == "xyz" else lrs[k])
            if hp.opt_lens and lens is not None:
                lr = multistep(step, hp.lens_lr, hp.lens_milestones, 0.5)
                for k in names:
                    if k.startswith("lens."):
                        adam[k].step(named[k], by_name[k], lr)
            cam_count[ci] += 1
            n = cam_count[ci]
            cam_lr = {"dq": multistep(step, hp.rot_lr, hp.pose_milestones, hp.pose_gamma),
                      "dt": multistep(step, hp.trans_lr, hp.pose_milestones, hp.pose_gamma),
                      "fovx": hp.fov_lr, "fovy": hp.fov_lr}
            for k in CAM_LEAVES:
                m, v = cam_adam[k]
                gr = by_name[f"cam.{k}"]
                m[ci] = 0.9 * m[ci] + 0.1 * gr
                v[ci] = 0.999 * v[ci] + 0.001 * gr * gr
                cam[k][ci] -= cam_lr[k] * (m[ci] / (1 - 0.9 ** n)) / (
                    torch.sqrt(v[ci] / (1 - 0.999 ** n)) + 1e-15)
    after = {k: t.detach().float() for k, t in named.items()}
    after.update({f"cam.{k}": cam[k].float() for k in CAM_LEAVES})
    return dict(losses=losses, grads=first, after=after)
