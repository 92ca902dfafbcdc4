"""The benchmark's inputs, made on the device from the seed: the scene's
Gaussians, the training population, the cameras and the GT images.

Everything here belongs to the benchmark, not to the program: both the
program and the plain reference are handed the same tensors. The scene is
the repository's full-width recipe (`chip_smoke.py` steps 5, 6 and 11):
Gaussians uniform in a box in front of an arc of look-at cameras, SH
coefficients N(0, 1) for the DC band and N(0, 0.1) above it, scales
log-uniform in the configuration's range, random rotations and opacities
uniform in (0.2, 0.95). The seed draws the values; the sizes, the cameras
and the pose noise are fixed by the configuration, so every seed gives
the same work in another arrangement.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

from reference import lens as ref_lens
from reference import render as ref_render


def sub_seeds(seed: int, n: int = 4) -> List[int]:
    """n independent 63-bit seeds from the run's seed."""
    return [int(s) & (2 ** 63 - 1) for s in
            np.random.SeedSequence(int(seed)).generate_state(n, dtype=np.uint64)]


@dataclasses.dataclass
class Scene:
    """The scene's Gaussians (activated and raw) of N rows."""

    xyz: torch.Tensor
    sh: torch.Tensor          # (N, 16, 3)
    scales: torch.Tensor
    quats: torch.Tensor       # unit
    opacity: torch.Tensor

    def raw(self) -> Dict[str, torch.Tensor]:
        op = self.opacity
        return dict(xyz=self.xyz, sh_dc=self.sh[:, :1].contiguous(),
                    sh_rest=self.sh[:, 1:].contiguous(),
                    scales_log=torch.log(self.scales), quats=self.quats,
                    opacity_raw=torch.log(op / (1 - op)))


def make_scene(cfg: dict, seed: int, device) -> Scene:
    """The configuration's scene from one torch generator on the device."""
    s = cfg["scene"]
    n, k = s["n_gaussians"], (s["sh_degree"] + 1) ** 2
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kw = dict(generator=gen, device=device)
    d0, d1 = s["depth_range"]
    ext = math.tan(s["box_fov"] / 2) * d0
    u = torch.rand((n, 3), **kw)
    xyz = torch.stack([(2 * u[:, 0] - 1) * ext, (2 * u[:, 1] - 1) * ext,
                       d0 + (d1 - d0) * u[:, 2]], dim=-1)
    sh = torch.randn((n, k, 3), **kw)
    sh[:, 1:] *= 0.1
    lo, hi = (math.log(x) for x in s["scale_range"])
    scales = torch.exp(lo + (hi - lo) * torch.rand((n, 3), **kw))
    quats = torch.randn((n, 4), **kw)
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    o0, o1 = s["opacity_range"]
    opacity = o0 + (o1 - o0) * torch.rand((n,), **kw)
    return Scene(xyz=xyz, sh=sh, scales=scales, quats=quats, opacity=opacity)


def perturb(raw: Dict[str, torch.Tensor], sigma: Dict[str, float], seed: int,
            device) -> Dict[str, torch.Tensor]:
    """The training population: the scene's raw leaves plus seeded normal
    noise of the configuration's sizes (a model part way through training)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for key, t in raw.items():
        out[key] = (t + sigma[key] * torch.randn(t.shape, generator=gen, device=device)
                    if sigma.get(key) else t.clone())
    return out


def _so3_exp(w: np.ndarray) -> np.ndarray:
    th = float(np.linalg.norm(w))
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + math.sin(th) / th * K + (1 - math.cos(th)) / th ** 2 * K @ K


def lookat_cameras(cfg: dict):
    """The configuration's arc of cameras, all looking at the arc's centre:
    a list of (R (3, 3), t (3,)) world-to-camera, float64 numpy."""
    c = cfg["cameras"]
    n, center = c["n"], np.asarray(c["center"], np.float64)
    out = []
    for i in range(n):
        a = c["spread"] * (i - (n - 1) / 2) / max(n - 1, 1) * 2
        b = c["elev"] * math.sin(1.7 * i)
        C = center + c["radius"] * np.array([math.sin(a), math.sin(b),
                                             -math.cos(a) * math.cos(b)])
        out.append(_lookat(C, center))
    return out


def _lookat(C: np.ndarray, target: np.ndarray):
    f = target - C
    f = f / np.linalg.norm(f)
    r = np.cross([0.0, 1.0, 0.0], f)
    r = r / np.linalg.norm(r)
    R = np.stack([r, np.cross(f, r), f])
    return R, -R @ C


def orbit_cameras(cfg: dict, traffic: dict, phase_seed: int):
    """The render traffic's orbit: `period` views evenly around the arc's
    centre at its radius, a gentle elevation wave, starting at a seeded
    azimuth. Returns a list of (R, t) in visiting order."""
    c, o = cfg["cameras"], traffic["orbit"]
    center = np.asarray(c["center"], np.float64)
    phase = np.random.default_rng(phase_seed).uniform(0, 2 * math.pi)
    out = []
    for i in range(o["period"]):
        az = phase + 2 * math.pi * i / o["period"]
        el = o["elevation"] * math.sin(2 * az)
        C = center + o["radius"] * np.array([math.sin(az) * math.cos(el), math.sin(el),
                                             -math.cos(az) * math.cos(el)])
        out.append(_lookat(C, center))
    return out


def noisy(poses, noise, noise_seed: int):
    """The preset's pose noise, fixed by the dataset's noise seed as the
    program's Scene draws it: R <- exp(N(0, 1) r) R, t <- t + N(0, 1) t."""
    rng = np.random.default_rng(noise_seed)
    n = len(poses)
    rot = rng.normal(0.0, 1.0, (n, 3)) * noise[0]
    tr = rng.normal(0.0, 1.0, (n, 3)) * noise[1]
    return [(_so3_exp(rot[i]) @ R, t + tr[i]) for i, (R, t) in enumerate(poses)]


def camera_table(poses, fovx: float, fovy: float, device) -> Dict[str, torch.Tensor]:
    """(q_init, t_init, dq, dt, fovx, fovy), one row a camera, float32."""
    q = torch.tensor([ref_render.rotmat_to_quat(R) for R, _ in poses],
                     dtype=torch.float32, device=device)
    t = torch.tensor(np.stack([t for _, t in poses]), dtype=torch.float32,
                     device=device)
    n = len(poses)
    return dict(q_init=q, t_init=t, dq=torch.zeros_like(q), dt=torch.zeros_like(t),
                fovx=torch.full((n,), fovx, device=device),
                fovy=torch.full((n,), fovy, device=device))


def extent(poses) -> float:
    """NeRF++'s scene radius: 1.1 x the largest camera distance from the
    cameras' mean centre."""
    centers = np.stack([-R.T @ t for R, t in poses])
    return float(1.1 * np.linalg.norm(centers - centers.mean(0), axis=1).max())


def focal(width: int, fov: float) -> float:
    return width / (2 * math.tan(fov / 2))


def fisheye_geometry(cfg: dict, device) -> dict:
    """The fisheye mode's sizes as the preset sets them: the extended
    FoVs, the render, control-grid, flow and fisheye sizes and the control
    points (`train/calibrated.py::make_fisheye_setup`'s rules)."""
    f = cfg["fisheye"]
    w, h = cfg["width"], cfg["height"]
    fx, fy = focal(w, cfg["fov"]), focal(h, cfg["fov"])
    fs = f["flow_scale"]
    s = f["control_point_sample_scale"]
    grid_hw = (max(h // s, 2), max(w // s, 2))
    return dict(fovx=2 * math.atan(int(fs[0] * w) / (2 * fx)),
                fovy=2 * math.atan(int(fs[1] * h) / (2 * fy)),
                width=w, height=h, grid_hw=grid_hw,
                flow_hw=(int(h * fs[0]), int(w * fs[1])), fish_hw=(h, w),
                focal=(fx, fy),
                p_view=ref_lens.control_points(fx, fy, w, h, fs, grid_hw, device))


@torch.no_grad()
def gt_images(scene: Scene, poses, cfg: dict, device, fisheye=None) -> torch.Tensor:
    """(n, 3, H, W) GT of the cameras `poses`, rendered by the plain
    reference; in the fisheye mode rendered at the extended FoV and warped
    through the configuration's known lens."""
    w, h = cfg["width"], cfg["height"]
    out = []
    for R, t in poses:
        Rt = torch.tensor(R, dtype=torch.float32, device=device)
        tt = torch.tensor(t, dtype=torch.float32, device=device)
        if fisheye is None:
            fov = torch.tensor(cfg["fov"], device=device)
            img = ref_render.render(scene.xyz, scene.scales, scene.quats,
                                    scene.opacity, scene.sh, Rt, tt, fov, fov, w, h)
        else:
            fx = torch.tensor(fisheye["fovx"], device=device)
            fy = torch.tensor(fisheye["fovy"], device=device)
            img = ref_render.render(scene.xyz, scene.scales, scene.quats,
                                    scene.opacity, scene.sh, Rt, tt, fx, fy, w, h)
            scale = [1 / math.tan(fisheye["fovx"] / 2), 1 / math.tan(fisheye["fovy"] / 2)]
            flow = ref_lens.known_lens_flow(cfg["fisheye"]["known_lens"],
                                            fisheye["p_view"], fisheye["grid_hw"],
                                            scale, fisheye["flow_hw"])
            img = ref_lens.warp(img, flow, fisheye["fish_hw"])[0]
        # an 8-bit image, as a dataset holds it
        out.append(torch.round(torch.clamp(img, 0.0, 1.0) * 255.0) / 255.0)
    return torch.stack(out)
