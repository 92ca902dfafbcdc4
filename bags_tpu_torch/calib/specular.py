"""View-dependent specular colour from anisotropic spherical Gaussians (port
of `bags_tpu/calib/specular.py`).

The `--hybrid` path: each Gaussian's 24 ASG features are lifted linearly to
4 x 8 lobes (a[2], lambda, mu), encoded against fixed lobe frames, and a
three-layer MLP of that encoding and the positional-encoded view direction
gives an RGB offset that the projection adds to the SH colour. The
products are `torch.matmul` in float32 (TF32 off, `bags_tpu_torch/__init__`),
as the JAX package computes them outside any kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NUM_THETA = 4
NUM_PHI = 8
ASG_FEATURE = 24
ASG_HIDDEN = NUM_THETA * NUM_PHI * 4   # a(2) + lambda + mu per lobe
VIEW_PE = 2
MLP_WIDTH = 128
PARAM_NAMES = ("feat_w", "feat_b", "w1", "b1", "w2", "b2", "w3", "b3")


def _spherical2cartesian(theta, phi):
    return np.stack([np.cos(phi) * np.sin(theta),
                     np.sin(phi) * np.sin(theta),
                     np.cos(theta)], axis=-1)


def init_predefined_omega() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The fixed lobe frames: directions omega, tangents omega_lambda (theta
    + pi/2) and bitangents omega_mu (omega_lambda turned pi/2 about omega),
    float32 (NUM_THETA * NUM_PHI, 3) each."""
    omega, om_la, om_mu = [], [], []
    for th in np.linspace(0, np.pi, NUM_THETA):
        for ph in np.linspace(0, 2 * np.pi, NUM_PHI):
            o = _spherical2cartesian(th, ph)
            la = _spherical2cartesian(th + np.pi / 2, ph)
            mu = (la * np.cos(np.pi / 2) + np.cross(o, la) * np.sin(np.pi / 2)
                  + o * np.dot(o, la) * (1 - np.cos(np.pi / 2)))
            omega.append(o)
            om_la.append(la)
            om_mu.append(mu)
    return (np.array(omega, np.float32), np.array(om_la, np.float32),
            np.array(om_mu, np.float32))


_OMEGA = np.stack(init_predefined_omega())        # (3, T*P, 3)


@dataclasses.dataclass
class SpecularParams:
    feat_w: torch.Tensor   # (ASG_FEATURE, ASG_HIDDEN)
    feat_b: torch.Tensor
    w1: torch.Tensor       # MLP layers, (in, out)
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor

    def named_tensors(self) -> Dict[str, torch.Tensor]:
        """The tensors by their JAX pytree paths (".feat_w", ...)."""
        return {"." + k: getattr(self, k) for k in PARAM_NAMES}


def init_specular_params(seed: int, device=None) -> SpecularParams:
    """The JAX package's initialisation draw for draw from
    `np.random.default_rng(seed)` (uniform +-1/sqrt(fan_in), b3 zero),
    every tensor requiring grad."""
    rng = np.random.default_rng(seed)
    in_mlp = 2 * VIEW_PE * 3 + 3 + NUM_THETA * NUM_PHI * 2
    arrs = []
    for i, o in ((ASG_FEATURE, ASG_HIDDEN), (in_mlp, MLP_WIDTH),
                 (MLP_WIDTH, MLP_WIDTH), (MLP_WIDTH, 3)):
        bound = 1.0 / np.sqrt(i)
        arrs.append(rng.uniform(-bound, bound, (i, o)).astype(np.float32))
        arrs.append(rng.uniform(-bound, bound, (o,)).astype(np.float32))
    arrs[-1] = np.zeros_like(arrs[-1])
    return SpecularParams(*(torch.as_tensor(a, device=device).requires_grad_(True)
                            for a in arrs))


def _positional_encoding(x: torch.Tensor, freqs: int) -> torch.Tensor:
    bands = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    pts = (x[..., None] * bands).reshape(x.shape[:-1] + (freqs * x.shape[-1],))
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)


def specular_color(params: SpecularParams, asg_features: torch.Tensor,
                   viewdirs: torch.Tensor) -> torch.Tensor:
    """asg_features (N, 24), viewdirs (N, 3) unit -> (N, 3) RGB offset."""
    n = viewdirs.shape[0]
    feat = asg_features @ params.feat_w + params.feat_b        # (N, 4*8*4)
    asg = feat.reshape(-1, NUM_THETA * NUM_PHI, 4)
    a, la, mu = asg[..., :2], asg[..., 2:3], asg[..., 3:4]
    omega, om_la, om_mu = torch.as_tensor(
        _OMEGA, dtype=viewdirs.dtype, device=viewdirs.device)
    smooth = F.relu(viewdirs @ omega.T)[..., None]
    la = F.softplus(la - 1.0)
    mu = F.softplus(mu - 1.0)
    exp_in = -la * (viewdirs @ om_la.T)[..., None] ** 2 \
        - mu * (viewdirs @ om_mu.T)[..., None] ** 2
    color_feat = (a * smooth * torch.exp(exp_in)).reshape(n, -1)
    h = torch.cat([color_feat, viewdirs,
                   _positional_encoding(viewdirs, VIEW_PE)], dim=-1)
    h = F.relu(h @ params.w1 + params.b1)
    h = F.relu(h @ params.w2 + params.b2)
    return h @ params.w3 + params.b3


def specular_extra_color(params: SpecularParams, xyz: torch.Tensor,
                         asg_features: torch.Tensor, cam, align=None
                         ) -> torch.Tensor:
    """Each Gaussian's specular colour offset (N, 3) seen from `cam`: the
    camera-to-Gaussian directions normalised with the squared norm clipped
    at 1e-16 before the square root (clipping after it gives 0 x inf in the
    VJP at a Gaussian on the camera centre), through `specular_color`."""
    from ..core.camera import camera_center

    dirs = xyz - camera_center(cam, align)[None, :]
    dirs = dirs / torch.sqrt(torch.clamp(
        torch.sum(dirs * dirs, dim=-1, keepdim=True), min=1e-16))
    return specular_color(params, asg_features, dirs)
