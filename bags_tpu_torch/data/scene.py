"""Scene: camera batches, GT image cache, pose/FoV noise injection (port of
`bags_tpu/data/scene.py`).

Dataset dispatch, seeded noise injection over rotations/translations/FoVs
with noise-free copies kept for pose evaluation, the -1 -> cap-1.6k-width
resolution policy, the scene extent from NeRF++ normalization, and the
point-cloud Gaussian init. Cameras are one batched `CameraParams` (n_cams
leading dim) with one `CameraStatic`; GT images are decoded on the host,
cached as numpy and moved to the scene's device on access.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.camera import CameraParams, CameraStatic
from ..core.lie import so3_exp
from ..model.gaussians import create_from_points
from ..utils.device import resolve_device
from .readers import CameraInfo, SceneInfo, load_scene_info

MAX_IMAGE_CACHE = 512  # decoded GT images kept on the host


def resolve_resolution(width: int, height: int, resolution: int = -1,
                       scale: float = 1.0) -> Tuple[int, int]:
    """Explicit downscale factor, or -1 -> cap the width at 1600 px."""
    if resolution in (1, -1):
        if resolution == -1 and width > 1600:
            global_down = width / 1600
        else:
            global_down = 1.0
    else:
        global_down = float(resolution)
    factor = global_down * scale
    return int(round(width / factor)), int(round(height / factor))


def load_image(path: str, wh: Tuple[int, int],
               white_background: bool = False) -> np.ndarray:
    """Image file -> (3, H, W) float32 in [0, 1], resized, alpha composited
    over the background."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.resize(wh, Image.LANCZOS)
        arr = np.asarray(img).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, -1)
    if arr.shape[-1] == 4:
        bg = 1.0 if white_background else 0.0
        arr = arr[..., :3] * arr[..., 3:4] + bg * (1 - arr[..., 3:4])
    return np.clip(arr.transpose(2, 0, 1), 0.0, 1.0)


def batch_cameras(infos: List[CameraInfo], device) -> CameraParams:
    """CameraInfo list -> one batched CameraParams (q_init from R^T, the
    w2c rotation)."""
    return CameraParams.stack([
        CameraParams.create(np.asarray(c.R, np.float32).T,
                            np.asarray(c.T, np.float32), c.fovx, c.fovy,
                            device=device) for c in infos])


def inject_noise(infos: List[CameraInfo], r_t_noise=(0.0, 0.0, 1.0),
                 seed: int = 55) -> List[CameraInfo]:
    """Seeded pose/FoV perturbation: R <- exp(so3 noise) R, T <- T + eps,
    FoV <- FoV * exp(N(0, ln sigma)). The noise is drawn with numpy from
    `seed`, so it is the JAX package's noise."""
    rng = np.random.default_rng(seed)
    n = len(infos)
    so3_noise = rng.normal(0.0, 1.0, (n, 3)).astype(np.float32) * r_t_noise[0]
    t_noise = rng.normal(0.0, 1.0, (n, 3)).astype(np.float32) * r_t_noise[1]
    if len(r_t_noise) > 2 and r_t_noise[2] != 1.0:
        fov_noise = np.exp(rng.normal(0.0, np.log(r_t_noise[2]), n))
    else:
        fov_noise = np.ones(n)
    rots = so3_exp(torch.as_tensor(so3_noise)).numpy()
    return [dataclasses.replace(
        c, R=rots[i] @ c.R, T=c.T + t_noise[i],
        fovx=c.fovx * fov_noise[i], fovy=c.fovy * fov_noise[i])
        for i, c in enumerate(infos)]


class Scene:
    """Loads a dataset directory into batched cameras + Gaussian init."""

    def __init__(self, source_path: str, eval_split: bool = False,
                 resolution: int = -1, r_t_noise=(0.0, 0.0, 1.0),
                 white_background: bool = False,
                 capacity: Optional[int] = None, sh_degree: int = 3,
                 images_dir: str = "images", init_type: str = "sfm",
                 noise_seed: int = 55, num_pts: int = 100_000, device=None):
        self.device = resolve_device(device)
        self.info: SceneInfo = load_scene_info(
            source_path, eval_split=eval_split, images_dir=images_dir,
            white_background=white_background, init_type=init_type,
            num_pts=num_pts)
        self.cameras_extent = float(self.info.nerf_normalization["radius"])
        self.white_background = white_background
        self.resolution = resolution

        # noise-free copies retained for pose eval
        self.train_infos_clean = list(self.info.train_cameras)
        self.train_infos = inject_noise(self.info.train_cameras, r_t_noise,
                                        noise_seed)
        self.test_infos = list(self.info.test_cameras) or [self.train_infos[0]]

        sizes = {resolve_resolution(c.width, c.height, resolution)
                 for c in self.train_infos}
        if len(sizes) != 1:
            raise ValueError(f"mixed image sizes {sizes}: resolution "
                             "bucketing is not supported")
        w, h = next(iter(sizes))
        self.static = CameraStatic(width=w, height=h)

        self.train_cams = batch_cameras(self.train_infos, self.device)
        self.train_cams_clean = batch_cameras(self.train_infos_clean, self.device)
        self.test_cams = batch_cameras(self.test_infos, self.device)

        pcd = self.info.point_cloud
        n_pts = len(pcd.points)
        cap = capacity or max(2 ** int(np.ceil(np.log2(max(n_pts, 1) * 4))),
                              1024)
        self.gaussians, self.alive = create_from_points(
            pcd.points, pcd.colors, cap, sh_degree, device=self.device)
        self._cache: Dict[Tuple[str, int], np.ndarray] = {}
        self._cache_lock = threading.Lock()

    def _load(self, infos, idx: int, fish: bool = False) -> torch.Tensor:
        info = infos[idx]
        path = info.fish_image_path if fish else info.image_path
        key = (path, id(infos))
        with self._cache_lock:
            img = self._cache.get(key)
        if img is None:
            img = load_image(path,
                             (self.static.width, self.static.height),
                             info.white_background or self.white_background)
            with self._cache_lock:
                if len(self._cache) >= MAX_IMAGE_CACHE:
                    self._cache.pop(next(iter(self._cache)))
                self._cache[key] = img
        return torch.as_tensor(img, device=self.device)

    def train_image(self, idx: int) -> torch.Tensor:
        return self._load(self.train_infos, idx)

    def test_image(self, idx: int) -> torch.Tensor:
        return self._load(self.test_infos, idx)

    def fish_image(self, idx: int) -> torch.Tensor:
        """The paired fisheye GT (`fish/images`) of train camera idx."""
        return self._load(self.train_infos, idx, fish=True)

    def test_fish_image(self, idx: int) -> torch.Tensor:
        return self._load(self.test_infos, idx, fish=True)

    @property
    def n_train(self) -> int:
        return len(self.train_infos)

    @property
    def n_test(self) -> int:
        return len(self.test_infos)
