"""Differentiable camera parameterization (port of `bags_tpu/core/camera.py`).

A base world-to-camera pose plus learnable residuals dq (4,) / dt (3,) and
learnable FoVs; every derived quantity is a function of those tensors, so
autograd reaches the pose and the intrinsics.

Conventions (column vectors): x_cam = R_w2c @ x_world + t_w2c, camera looks
down +z. q is (w, x, y, z) and encodes R_w2c; q_eff = q_init + dq, raw
addition, normalized inside `quat_to_rotmat`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .lie import quat_to_rotmat, rotmat_to_quat


@dataclasses.dataclass
class CameraParams:
    """Per-camera differentiable parameters; leading batch dims allowed."""

    q_init: torch.Tensor   # (..., 4) base w2c rotation quaternion
    t_init: torch.Tensor   # (..., 3) base w2c translation
    dq: torch.Tensor       # (..., 4) learnable residual quaternion
    dt: torch.Tensor       # (..., 3) learnable residual translation
    fovx: torch.Tensor     # (...,) horizontal field of view (radians)
    fovy: torch.Tensor     # (...,) vertical field of view (radians)

    @staticmethod
    def create(R_w2c, t_w2c, fovx, fovy, device=None) -> "CameraParams":
        """From a w2c rotation and translation (arrays or tensors). Tensor
        inputs keep their device unless `device` is given."""
        if device is None and isinstance(R_w2c, torch.Tensor):
            dev = R_w2c.device
        else:
            dev = resolve_device(device)

        def f32(x):
            return torch.as_tensor(np.array(x, np.float32)
                                   if not isinstance(x, torch.Tensor) else x,
                                   dtype=torch.float32, device=dev)

        R = f32(R_w2c)
        t = f32(t_w2c)
        q = rotmat_to_quat(R)
        return CameraParams(q_init=q, t_init=t, dq=torch.zeros_like(q),
                            dt=torch.zeros_like(t), fovx=f32(fovx),
                            fovy=f32(fovy))

    @staticmethod
    def stack(cams) -> "CameraParams":
        """Batch a list of cameras along a new leading dim."""
        return CameraParams(**{
            f.name: torch.stack([getattr(c, f.name) for c in cams])
            for f in dataclasses.fields(CameraParams)})

    def __getitem__(self, i) -> "CameraParams":
        """Camera `i` of a batched CameraParams."""
        return CameraParams(**{f.name: getattr(self, f.name)[i]
                               for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class CameraStatic:
    """Camera metadata that is not optimized."""

    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0


@dataclasses.dataclass
class GlobalAlignment:
    """Global SIM(3) alignment applied to all cameras: a rotation quaternion
    and a log scale on the w2c translation (t <- s * t)."""

    quaternion: torch.Tensor  # (4,) (w, x, y, z)
    log_scale: torch.Tensor   # ()

    @property
    def rotation(self) -> torch.Tensor:
        return quat_to_rotmat(self.quaternion)


def pose_w2c(cam: CameraParams, align: GlobalAlignment | None = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Effective (R_w2c, t_w2c): R = G @ quat2R(q_init + dq),
    t = s * (t_init + dt)."""
    R = quat_to_rotmat(cam.q_init + cam.dq)
    t = cam.t_init + cam.dt
    if align is not None:
        R = align.rotation @ R
        t = torch.exp(align.log_scale) * t
    return R, t


def camera_center(cam: CameraParams, align: GlobalAlignment | None = None) -> torch.Tensor:
    """World-space camera center C = -R^T t."""
    R, t = pose_w2c(cam, align)
    return -torch.einsum("...ji,...j->...i", R, t)


def projection_matrix(fovx: torch.Tensor, fovy: torch.Tensor,
                      znear: float = 0.01, zfar: float = 100.0) -> torch.Tensor:
    """Symmetric-frustum perspective projection, column-vector convention:
    P[0,0] = 1/tan(fovx/2), P[1,1] = 1/tan(fovy/2), P[2,2] = zf/(zf-zn),
    P[2,3] = -zf*zn/(zf-zn), P[3,2] = 1."""
    tx = torch.tan(fovx * 0.5)
    ty = torch.tan(fovy * 0.5)
    zero = torch.zeros_like(tx)
    one = torch.ones_like(tx)
    zf = zfar / (zfar - znear)
    rows = [
        torch.stack([1.0 / tx, zero, zero, zero], dim=-1),
        torch.stack([zero, 1.0 / ty, zero, zero], dim=-1),
        torch.stack([zero, zero, zf * one,
                     -(zfar * znear) / (zfar - znear) * one], dim=-1),
        torch.stack([zero, zero, one, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def focals(cam: CameraParams, static: CameraStatic) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel focal lengths fx, fy from the (learnable) FoVs."""
    fx = static.width / (2.0 * torch.tan(cam.fovx * 0.5))
    fy = static.height / (2.0 * torch.tan(cam.fovy * 0.5))
    return fx, fy
