"""Synthetic scenes and datasets for tests and the on-card smoke run (port
of `bags_tpu/utils/testing.py`).

The builders draw from numpy with the same seeds and in the same order as
the JAX package's, so both packages get identical inputs.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.camera import CameraParams, CameraStatic
from ..data import colmap
from .device import resolve_device


def make_lookat_cameras(n_cams: int, fovx: float, fovy: float,
                        center=(0.0, 0.0, 6.0), radius: float = 6.0,
                        spread: float = 0.5, elev: float = 0.12, device=None):
    """Cameras on an arc with distinct centers, all looking at `center`.
    Returns a list of CameraParams (w2c: X_cam = R X + t, t = -R C)."""
    dev = resolve_device(device)
    center = np.asarray(center, np.float64)
    cams = []
    for i in range(n_cams):
        a = spread * (i - (n_cams - 1) / 2) / max(n_cams - 1, 1) * 2
        b = elev * np.sin(1.7 * i)
        C = center + radius * np.array([np.sin(a), np.sin(b),
                                        -np.cos(a) * np.cos(b)])
        f = center - C
        f = f / np.linalg.norm(f)
        r = np.cross([0.0, 1.0, 0.0], f)
        r = r / np.linalg.norm(r)
        u = np.cross(f, r)
        R = np.stack([r, u, f]).astype(np.float32)
        t = (-R @ C.astype(np.float32)).astype(np.float32)
        cams.append(CameraParams.create(R, t, fovx, fovy, device=dev))
    return cams


def make_toy_scene(n: int = 500, seed: int = 0, width: int = 64,
                   height: int = 64, sh_degree: int = 0, depth_range=(4.0, 8.0),
                   scale_range=(0.02, 0.12), device=None):
    """Random Gaussians in a box in front of a camera at the origin looking
    +z. Same numbers as `bags_tpu.utils.testing.make_toy_scene`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    fovx = fovy = 0.8
    extent_x = np.tan(fovx / 2) * depth_range[0]
    xyz = np.stack([
        rng.uniform(-extent_x, extent_x, n),
        rng.uniform(-extent_x, extent_x, n),
        rng.uniform(*depth_range, n),
    ], axis=-1).astype(np.float32)
    k = (sh_degree + 1) ** 2
    sh = np.zeros((n, k, 3), np.float32)
    sh[:, 0, :] = rng.normal(0, 1.0, size=(n, 3))
    if k > 1:
        sh[:, 1:, :] = rng.normal(0, 0.1, size=(n, k - 1, 3))
    scales = np.exp(rng.uniform(np.log(scale_range[0]), np.log(scale_range[1]),
                                size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opacity = rng.uniform(0.2, 0.95, size=(n,)).astype(np.float32)

    def t(x):
        return torch.as_tensor(x, device=dev)

    cam = CameraParams.create(np.eye(3, dtype=np.float32),
                              np.zeros(3, np.float32), fovx, fovy, device=dev)
    return dict(xyz=t(xyz), scales=t(scales), quats=t(quats),
                opacity=t(opacity), sh_coeffs=t(sh), cam=cam,
                static=CameraStatic(width=width, height=height),
                sh_degree=sh_degree)


def write_colmap_scene(root: str, cams, width: int, height: int,
                       fx: float, fy: float, points: np.ndarray,
                       colors: np.ndarray, images=None) -> list[str]:
    """Write a COLMAP dataset (binary `sparse/0` + `images/`) for PINHOLE
    cameras `cams` (CameraParams list; w2c quaternion and translation).

    images: one (H, W, 3) uint8 array per camera, or None to write them
    later with `write_image` at the returned paths. The counterpart of
    `tests/test_data.py::_write_colmap_scene`, with given poses.
    """
    sparse = os.path.join(root, "sparse", "0")
    imgdir = os.path.join(root, "images")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(imgdir, exist_ok=True)
    colmap.write_cameras_binary(
        os.path.join(sparse, "cameras.bin"),
        {1: colmap.ColmapCamera(1, "PINHOLE", width, height,
                                np.array([fx, fy, width / 2, height / 2]))})
    records, paths = {}, []
    for i, cam in enumerate(cams, start=1):
        name = f"img_{i:03d}.png"
        records[i] = colmap.ColmapImage(
            i, cam.q_init.detach().cpu().double().numpy(),
            cam.t_init.detach().cpu().double().numpy(), 1, name,
            np.zeros((0, 2)), np.zeros(0, int))
        paths.append(os.path.join(imgdir, name))
    colmap.write_images_binary(os.path.join(sparse, "images.bin"), records)
    colmap.write_points3d_binary(
        os.path.join(sparse, "points3D.bin"), np.asarray(points, np.float64),
        (np.clip(np.asarray(colors), 0, 1) * 255).astype(np.uint8))
    if images is not None:
        for path, img in zip(paths, images):
            write_image(path, img)
    return paths


def write_image(path: str, img: np.ndarray) -> None:
    """(H, W, 3) uint8 -> PNG."""
    from PIL import Image

    Image.fromarray(img).save(path)
