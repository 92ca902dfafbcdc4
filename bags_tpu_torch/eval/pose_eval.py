"""SIM(3) trajectory alignment and pose-error metrics (port of
`bags_tpu/eval/pose_eval.py`), as numpy on host copies of the cameras.

Align the optimized camera centres to the ground truth with a similarity
transform (outlier pre-filter, centroid / scale normalisation, SVD rotation
with reflection fix), then report rotation (deg) and translation errors.
Rotations are composed in float64 on the host: arccos near 1 amplifies
float32 rounding into phantom degrees.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..core.camera import CameraParams


@dataclasses.dataclass
class Sim3:
    t0: np.ndarray  # (3,) target centroid
    t1: np.ndarray  # (3,) source centroid
    s0: float
    s1: float
    R: np.ndarray   # (3, 3)


def procrustes_analysis(X0: np.ndarray, X1: np.ndarray) -> Sim3:
    """Similarity alignment of X1 (pred) to X0 (GT), both (N, 3), with the
    (X0 - X1 > 1) outlier filter and a double-precision SVD."""
    diff = X0 - X1
    keep = ~(diff > 1).any(axis=1)
    if keep.sum() >= 3:  # the outlier filter must leave a solvable system
        X0, X1 = X0[keep], X1[keep]
    t0 = X0.mean(axis=0)
    t1 = X1.mean(axis=0)
    X0c, X1c = X0 - t0, X1 - t1
    eps = 1e-12
    s0 = max(float(np.sqrt((X0c ** 2).sum(-1).mean())), eps)
    s1 = max(float(np.sqrt((X1c ** 2).sum(-1).mean())), eps)
    U, _, Vt = np.linalg.svd((X0c / s0).T.astype(np.float64)
                             @ (X1c / s1).astype(np.float64))
    R = (U @ Vt).astype(np.float32)
    if np.linalg.det(R) < 0:
        R[2] *= -1
    return Sim3(t0=t0, t1=t1, s0=float(s0), s1=float(s1), R=R)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


def _rotations_f64(cams: CameraParams) -> np.ndarray:
    """(N, 3, 3) w2c rotations in float64, composed on the host."""
    q = _host(cams.q_init) + _host(cams.dq)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)


def camera_centers(cams: CameraParams) -> np.ndarray:
    R = _rotations_f64(cams)
    t = _host(cams.t_init) + _host(cams.dt)
    return np.einsum("...ji,...j->...i", -R, t)


def align_and_pose_error(pred: CameraParams, gt: CameraParams
                         ) -> Tuple[Sim3, dict]:
    """Align pred to gt by SIM(3) on the camera centres, then per-camera
    rotation (deg) and translation errors (`loadAlignCameras`)."""
    c_pred = camera_centers(pred)
    c_gt = camera_centers(gt)
    try:
        sim3 = procrustes_analysis(c_gt, c_pred)
    except np.linalg.LinAlgError:
        sim3 = Sim3(t0=np.zeros(3), t1=np.zeros(3), s0=1.0, s1=1.0,
                    R=np.eye(3, dtype=np.float32))

    c_aligned = (c_pred - sim3.t1) / sim3.s1 @ sim3.R.T * sim3.s0 + sim3.t0
    R_aligned = _rotations_f64(pred) @ sim3.R.T.astype(np.float64)
    R_rel = np.einsum("...ij,...kj->...ik", R_aligned, _rotations_f64(gt))
    tr = np.trace(R_rel, axis1=-2, axis2=-1)
    rot_err = np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0))
    t_err = np.linalg.norm(c_aligned - c_gt, axis=-1)
    return sim3, {
        "rotation_deg": np.degrees(rot_err),
        "translation": t_err,
        "rotation_deg_mean": float(np.degrees(rot_err).mean()),
        "translation_mean": float(t_err.mean()),
    }
