"""Novel-view camera trajectories for offline video rendering (port of
`bags_tpu/eval/trajectory.py`).

LLFF-style look-at view matrices, the average pose, spiral paths, orbit
paths, an elliptical wander around one view and keyframe-interpolated
(sequential) paths through the training cameras. The generators are numpy
and return lists of (R_w2c, t_w2c) pairs; `path_to_cameras` batches a
path into one CameraParams.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..core.camera import CameraParams


def _normalize(x):
    return x / np.linalg.norm(x)


def look_at_c2w(forward: np.ndarray, up: np.ndarray,
                pos: np.ndarray) -> np.ndarray:
    """LLFF `viewmatrix`: orthonormal c2w basis from a forward (z) direction
    and an approximate up vector."""
    z = _normalize(forward)
    x = _normalize(np.cross(z, up))
    y = _normalize(np.cross(x, z))
    return np.stack([y, x, z, pos], axis=1)  # columns: right-ish basis, pos


def _c2w_to_w2c(c2w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    R = c2w[:3, :3].T
    return R, -R @ c2w[:3, 3]


def average_pose(c2ws: np.ndarray) -> np.ndarray:
    """`poses_avg`: mean center, summed z / up."""
    center = c2ws[:, :3, 3].mean(axis=0)
    z = _normalize(c2ws[:, :3, 2].sum(axis=0))
    up = c2ws[:, :3, 0].sum(axis=0)
    return look_at_c2w(z, up, center)


def spiral_path(c2ws: np.ndarray, n_frames: int = 120, rots: float = 2.0,
                zrate: float = 0.5, focal: float = 1.0,
                rad_percentile: float = 90.0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """`render_path_spiral` around the average pose, radii from the 90th
    percentile of camera offsets."""
    avg = average_pose(c2ws)
    up = _normalize(c2ws[:, :3, 0].sum(axis=0))
    offsets = np.einsum("ij,nj->ni", avg[:3, :3].T,
                        c2ws[:, :3, 3] - avg[:3, 3])
    rads = np.percentile(np.abs(offsets), rad_percentile, axis=0)
    out = []
    for theta in np.linspace(0, 2 * np.pi * rots, n_frames, endpoint=False):
        delta = np.array([-np.sin(theta), np.cos(theta),
                          -np.sin(theta * zrate)]) * rads
        c = avg[:3, 3] + avg[:3, :3] @ delta
        z = _normalize(c - (avg[:3, 3] + avg[:3, :3] @ np.array([0, 0, -focal])))
        out.append(_c2w_to_w2c(look_at_c2w(z, up, c)))
    return out


def orbit_path(center: np.ndarray, radius: float, height: float,
               n_frames: int = 120, up=(0.0, -1.0, 0.0)
               ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Circular orbit looking at `center`."""
    up = np.asarray(up, np.float64)
    out = []
    for theta in np.linspace(0, 2 * np.pi, n_frames, endpoint=False):
        pos = center + np.array([radius * np.cos(theta), height,
                                 radius * np.sin(theta)])
        z = _normalize(center - pos)
        out.append(_c2w_to_w2c(look_at_c2w(z, up, pos)))
    return out


def wander_path(R_w2c: np.ndarray, t_w2c: np.ndarray, fovy: float,
                image_height: int, n_frames: int = 60,
                max_disp: float = 5000.0
                ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """In-place elliptical wander around one anchor view
    (`render_wander_path`): translation amplitude max_disp / focal, x full,
    y and z one third, rotation fixed."""
    focal = image_height / (2.0 * np.tan(0.5 * fovy))
    max_trans = max_disp / focal
    # the anchor in the reference's OpenGL-like convention (y / z flipped)
    R = np.array(R_w2c, np.float64)
    R[:, 1] *= -1.0
    R[:, 2] *= -1.0
    T = -np.asarray(t_w2c, np.float64).reshape(3, 1)
    ref = np.concatenate([np.concatenate([R, T], axis=1),
                          np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)
    out = []
    for i in range(n_frames):
        ang = 2.0 * np.pi * i / n_frames
        trans = np.array([max_trans * np.sin(ang),
                          max_trans * np.cos(ang) / 3.0,
                          max_trans * np.cos(ang) / 3.0])
        i_pose = np.eye(4)
        i_pose[:3, 3] = trans
        render_pose = ref @ np.linalg.inv(i_pose)
        Rw = render_pose[:3, :3].copy()
        Rw[:, 1] *= -1.0
        Rw[:, 2] *= -1.0
        out.append((Rw, -render_pose[:3, 3]))
    return out


def interpolate_path(cams: CameraParams, n_frames_per_segment: int = 10
                     ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Keyframe interpolation through the cameras (n, ...) in order: slerp
    on rotations, linear on centers."""
    from scipy.spatial.transform import Rotation, Slerp

    from ..core.camera import pose_w2c

    R_all, t_all = (x.detach().cpu().numpy() for x in pose_w2c(cams))
    centers = -np.einsum("nji,nj->ni", R_all, t_all)
    slerp = Slerp(np.arange(len(R_all)), Rotation.from_matrix(R_all))
    out = []
    for i in range(len(R_all) - 1):
        for s in np.linspace(0, 1, n_frames_per_segment, endpoint=False):
            c = (1 - s) * centers[i] + s * centers[i + 1]
            R = slerp(i + s).as_matrix()
            out.append((R, -R @ c))
    out.append((R_all[-1], t_all[-1]))
    return out


def path_to_cameras(path: Sequence[Tuple[np.ndarray, np.ndarray]],
                    fovx: float, fovy: float, device=None) -> CameraParams:
    """Batch a pose path into one CameraParams (n, ...) on `device`."""
    return CameraParams.stack([
        CameraParams.create(R.astype(np.float32), t.astype(np.float32),
                            fovx, fovy, device=device) for R, t in path])
