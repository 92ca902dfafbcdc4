"""Carry weights and cameras across from the JAX package as numpy arrays.

The port never imports JAX: the caller flattens a JAX pytree to a dict of
numpy arrays named like its dataclass fields (e.g. with
`{f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}`)
and hands the dict here. PLY files are the other route
(`model/gaussians.py`). The lens net keeps the JAX layout, weights (in,
out), so it is copied as it is, and its shapes are checked.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import numpy as np
import torch

from .calib.iresnet import IResNetParams
from .calib.specular import SpecularParams
from .calib.vignetting import VignettingParams
from .core.camera import CameraParams
from .model.densify import DensifyStats
from .model.gaussians import Gaussians
from .utils.device import resolve_device


def _fields(cls, d: Mapping[str, np.ndarray], dev, extra=(), optional=()):
    names = {f.name for f in dataclasses.fields(cls)} - (set(optional) - set(d))
    missing = names - set(d)
    unknown = set(d) - names - set(extra)
    if missing or unknown:
        raise KeyError(f"{cls.__name__}: missing {sorted(missing)}, not "
                       f"ported {sorted(unknown)}")
    return {k: torch.as_tensor(np.array(d[k]), device=dev) for k in names}


def gaussians_from_numpy(d: Mapping[str, np.ndarray], device=None
                         ) -> Tuple[Gaussians, torch.Tensor]:
    """{xyz, sh_dc, sh_rest, scales_log, quats, opacity_raw, alive} and,
    for a `--hybrid` model, its ASG features `asg` -> (Gaussians, alive)."""
    dev = resolve_device(device)
    g = Gaussians(**_fields(Gaussians, d, dev, extra=("alive",),
                            optional=("asg",)))
    return g, torch.as_tensor(np.array(d["alive"], bool), device=dev)


def camera_from_numpy(d: Mapping[str, np.ndarray], device=None) -> CameraParams:
    """{q_init, t_init, dq, dt, fovx, fovy} -> CameraParams."""
    return CameraParams(**_fields(CameraParams, d, resolve_device(device)))


def densify_stats_from_numpy(d: Mapping[str, np.ndarray], device=None
                             ) -> DensifyStats:
    """{grad_accum, grad_accum_abs, denom, max_radii2d} -> DensifyStats."""
    return DensifyStats(**_fields(DensifyStats, d, resolve_device(device)))


def specular_from_numpy(d: Mapping[str, np.ndarray], device=None
                        ) -> SpecularParams:
    """{feat_w, feat_b, w1, b1, w2, b2, w3, b3} in the JAX layout (weights
    (in, out)) -> SpecularParams, each tensor requiring grad."""
    return SpecularParams(**{k: t.requires_grad_(True) for k, t in _fields(
        SpecularParams, d, resolve_device(device)).items()})


def iresnet_from_numpy(d: Mapping[str, list], device=None) -> IResNetParams:
    """{weights, biases, u_vecs}, each a list per block of a list per layer
    of arrays in the JAX layout (weights (in, out), biases (out,), u_vecs
    (in,)) -> IResNetParams, in the arrays' dtype, weights and biases
    requiring grad. A weight in the (out, in) layout raises."""
    dev = resolve_device(device)
    out = {"weights": [], "biases": [], "u_vecs": []}
    for b, (ws, bs, us) in enumerate(zip(d["weights"], d["biases"], d["u_vecs"])):
        dims = [np.shape(ws[0])[0]] + [np.shape(w)[1] for w in ws]
        if dims[0] != 2 or dims[-1] != 2:
            raise ValueError(f"lens block {b} maps width {dims[0]} to "
                             f"{dims[-1]}, not 2 to 2: weights must be (in, out)")
        for l, (w, bias, u) in enumerate(zip(ws, bs, us)):
            want = ((dims[l], dims[l + 1]), (dims[l + 1],), (dims[l],))
            got = (np.shape(w), np.shape(bias), np.shape(u))
            if got != want:
                raise ValueError(f"lens block {b} layer {l}: weight, bias, u "
                                 f"shapes {got}, want the (in, out) layout "
                                 f"{want}")
        for field, arrs in (("weights", ws), ("biases", bs), ("u_vecs", us)):
            out[field].append([
                torch.as_tensor(np.array(a), device=dev).requires_grad_(
                    field != "u_vecs") for a in arrs])
    return IResNetParams(**out)


def calib_state_from_numpy(base, cfg, d: Mapping, device=None):
    """A CalibState around the TrainState `base` with the lens net
    (`d["lens"]`, see `iresnet_from_numpy`), the vignetting model
    (`d["vig"]`: {a_k, beta_k}) and the shift (`d["shift"]`, (3,)) from
    numpy, zero moments, and the cubemap net `d["cubemap_net"]` if given
    (else initialised). Returns (state, schedules) as `init_calib_state`."""
    from .train.calibrated import init_calib_state
    from .train.optim import adam_moments_init

    dev = resolve_device(device)
    state, schedules = init_calib_state(base, cfg)
    state.lens = iresnet_from_numpy(d["lens"], dev)
    state.lens_opt = adam_moments_init(state.lens.named_tensors(True))
    if "cubemap_net" in d:
        state.cubemap_net = iresnet_from_numpy(d["cubemap_net"], dev)
        state.cubemap_opt = adam_moments_init(
            state.cubemap_net.named_tensors(True))
    state.vig = VignettingParams(**{
        k: v.requires_grad_(True) for k, v in _fields(
            VignettingParams, d["vig"], dev).items()})
    state.vig_opt = adam_moments_init(state.vig.named_tensors())
    state.shift = torch.as_tensor(np.array(d["shift"]), device=dev
                                  ).requires_grad_(True)
    state.shift_opt = adam_moments_init({"": state.shift})
    return state, schedules
