"""Carry weights and cameras across from the JAX package as numpy arrays.

The port never imports JAX: the caller flattens a JAX pytree to a dict of
numpy arrays named like its dataclass fields (e.g. with
`{f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}`)
and hands the dict here. PLY files are the other route
(`model/gaussians.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import numpy as np
import torch

from .core.camera import CameraParams
from .model.densify import DensifyStats
from .model.gaussians import Gaussians
from .utils.device import resolve_device


def _fields(cls, d: Mapping[str, np.ndarray], dev, extra=()):
    names = {f.name for f in dataclasses.fields(cls)}
    missing = names - set(d)
    unknown = set(d) - names - set(extra)
    if missing or unknown:
        raise KeyError(f"{cls.__name__}: missing {sorted(missing)}, not "
                       f"ported {sorted(unknown)}")
    return {k: torch.as_tensor(np.array(d[k]), device=dev) for k in names}


def gaussians_from_numpy(d: Mapping[str, np.ndarray], device=None
                         ) -> Tuple[Gaussians, torch.Tensor]:
    """{xyz, sh_dc, sh_rest, scales_log, quats, opacity_raw, alive}
    -> (Gaussians, alive). The specular `asg` features of `--hybrid`
    models are not ported yet and are refused."""
    dev = resolve_device(device)
    g = Gaussians(**_fields(Gaussians, d, dev, extra=("alive",)))
    return g, torch.as_tensor(np.array(d["alive"], bool), device=dev)


def camera_from_numpy(d: Mapping[str, np.ndarray], device=None) -> CameraParams:
    """{q_init, t_init, dq, dt, fovx, fovy} -> CameraParams."""
    return CameraParams(**_fields(CameraParams, d, resolve_device(device)))


def densify_stats_from_numpy(d: Mapping[str, np.ndarray], device=None
                             ) -> DensifyStats:
    """{grad_accum, grad_accum_abs, denom, max_radii2d} -> DensifyStats."""
    return DensifyStats(**_fields(DensifyStats, d, resolve_device(device)))
