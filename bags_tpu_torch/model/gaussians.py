"""Gaussian splat parameters (port of `bags_tpu/model/gaussians.py`).

The six trainable fields with the reference activations (exp scales,
sigmoid opacity, normalized quaternions), SfM-point initialization with
knn-3 scales, and PLY import/export in the standard 3DGS layout. As in the
JAX package, the population has a capacity and an `alive` mask carried
beside the parameters. `--hybrid` adds the per-Gaussian ASG specular
features `asg` (C, 24), None otherwise; every function that walks the
fields skips a None one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..calib.specular import ASG_FEATURE
from ..core import sh as sh_lib
from ..utils.device import resolve_device
from ..utils.spans import span


@dataclasses.dataclass
class Gaussians:
    """Trainable splat parameters, all shaped (C, ...) with C = capacity."""

    xyz: torch.Tensor          # (C, 3)
    sh_dc: torch.Tensor        # (C, 1, 3)
    sh_rest: torch.Tensor      # (C, K-1, 3)
    scales_log: torch.Tensor   # (C, 3)
    quats: torch.Tensor        # (C, 4)
    opacity_raw: torch.Tensor  # (C,)
    asg: Optional[torch.Tensor] = None  # (C, 24) with --hybrid, else None

    def fields(self) -> dict:
        """The fields that are set, by name, in declaration order."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}

    @property
    def max_sh_degree(self) -> int:
        return int(np.sqrt(1 + self.sh_rest.shape[1])) - 1

    # The activations are the projection's first work: each runs under the
    # "projection" span unless another layer's span is open.

    def scaling(self) -> torch.Tensor:
        with span("projection"):
            return torch.exp(self.scales_log)

    def opacity(self, alive: torch.Tensor) -> torch.Tensor:
        with span("projection"):
            return torch.sigmoid(self.opacity_raw) * alive.to(self.opacity_raw.dtype)

    def sh_coeffs(self) -> torch.Tensor:
        with span("projection"):
            return torch.cat([self.sh_dc, self.sh_rest], dim=1)  # (C, K, 3)

    def with_asg(self) -> "Gaussians":
        """The same Gaussians with zero ASG specular features (--hybrid)."""
        return dataclasses.replace(self, asg=self.xyz.new_zeros(
            (self.xyz.shape[0], ASG_FEATURE)))


def inverse_sigmoid(x):
    return np.log(x / (1.0 - x))


def create_from_points(points: np.ndarray, colors: np.ndarray, capacity: int,
                       sh_degree: int = 3, device=None
                       ) -> Tuple[Gaussians, torch.Tensor]:
    """Initialize from an SfM point cloud: SH-DC from RGB, opacity
    sigmoid^-1(0.1), scales log(sqrt(mean 3-NN squared distance)), identity
    quaternions. Rows past len(points) are dead. Returns (gaussians, alive).
    """
    dev = resolve_device(device)
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points > capacity {capacity}")
    k = (sh_degree + 1) ** 2

    dist2 = np.maximum(mean_sq_dist_knn3(points.astype(np.float32)), 1e-7)
    scales = np.log(np.sqrt(dist2))[:, None].repeat(3, axis=1)

    def pad(x, fill=0.0):
        shape = (capacity - n,) + x.shape[1:]
        x = np.concatenate([x, np.full(shape, fill, np.float32)], axis=0)
        return torch.as_tensor(x.astype(np.float32), device=dev)

    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    sh_dc = sh_lib.rgb_to_sh_dc(colors.astype(np.float32))[:, None, :]
    g = Gaussians(
        xyz=pad(points.astype(np.float32)),
        sh_dc=pad(sh_dc),
        sh_rest=pad(np.zeros((n, k - 1, 3), np.float32)),
        scales_log=pad(scales.astype(np.float32), fill=-10.0),
        quats=pad(quats) + torch.tensor([1e-8, 0, 0, 0], device=dev),
        opacity_raw=pad(np.full((n,), inverse_sigmoid(np.float32(0.1)),
                                np.float32), fill=-10.0),
    )
    alive = torch.arange(capacity, device=dev) < n
    return g, alive


def mean_sq_dist_knn3(points: np.ndarray) -> np.ndarray:
    """Mean squared distance to the 3 nearest neighbours (host-side, at
    initialization only): scipy's cKDTree, its queries spread over every
    core (the same neighbours; on one core they were half of a 1M-point
    scene's set-up), else blocked numpy."""
    try:
        from scipy.spatial import cKDTree
    except ImportError:
        cKDTree = None
    if cKDTree is not None:
        d, _ = cKDTree(points).query(points, k=4, workers=-1)  # self + 3
        return (d[:, 1:] ** 2).mean(axis=1).astype(np.float32)
    n = points.shape[0]
    out = np.empty(n, np.float32)
    block = 2048
    for i in range(0, n, block):
        d2 = ((points[i:i + block, None, :] - points[None, :, :]) ** 2).sum(-1)
        d2.partition(3, axis=1)
        out[i:i + block] = d2[:, 1:4].mean(axis=1)
    return out


# ---------------------------------------------------------------------------
# PLY interop, standard 3DGS layout, binary little-endian float32.
# ---------------------------------------------------------------------------

def save_ply(path: str, g: Gaussians, alive) -> None:
    alive = torch.as_tensor(alive).cpu().numpy().astype(bool)

    def host(x):
        return x.detach().cpu().numpy()[alive]

    xyz = host(g.xyz)
    n = xyz.shape[0]
    f_dc = host(g.sh_dc).transpose(0, 2, 1).reshape(n, -1)
    f_rest = host(g.sh_rest).transpose(0, 2, 1).reshape(n, -1)
    opac = host(g.opacity_raw)[:, None]
    scale = host(g.scales_log)
    rot = host(g.quats)

    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(f_dc.shape[1])]
             + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
             + ["opacity"]
             + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    data = np.concatenate(
        [xyz, np.zeros_like(xyz), f_dc, f_rest, opac, scale, rot],
        axis=1).astype("<f4")

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {nm}" for nm in names]
    header += ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(data.tobytes())


def load_ply(path: str, capacity: Optional[int] = None, device=None
             ) -> Tuple[Gaussians, torch.Tensor]:
    dev = resolve_device(device)
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = next(int(l.split()[-1]) for l in header
                 if l.startswith("element vertex"))
        names = [l.split()[-1] for l in header if l.startswith("property float")]
        raw = np.frombuffer(f.read(n * len(names) * 4), dtype="<f4")
    arr = raw.reshape(n, len(names))
    col = {nm: i for i, nm in enumerate(names)}

    def grab(prefix, count):
        return arr[:, [col[f"{prefix}_{i}"] for i in range(count)]]

    xyz = arr[:, [col["x"], col["y"], col["z"]]]
    n_rest = sum(1 for nm in names if nm.startswith("f_rest_"))
    f_dc = grab("f_dc", 3).reshape(n, 3, 1).transpose(0, 2, 1)
    f_rest = grab("f_rest", n_rest).reshape(n, 3, n_rest // 3).transpose(0, 2, 1)
    cap = capacity or n

    def pad(x, fill=0.0):
        x = np.concatenate(
            [x, np.full((cap - n,) + x.shape[1:], fill, np.float32)], axis=0)
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)

    g = Gaussians(
        xyz=pad(xyz),
        sh_dc=pad(f_dc),
        sh_rest=pad(f_rest),
        scales_log=pad(grab("scale", 3), fill=-10.0),
        quats=pad(grab("rot", 4)),
        opacity_raw=pad(arr[:, col["opacity"]][:, None], fill=-10.0)[:, 0].contiguous(),
    )
    alive = torch.arange(cap, device=dev) < n
    return g, alive
