"""Radial vignetting model (port of `bags_tpu/calib/vignetting.py`).

Learnable coefficients a_k and exponents beta_k (4 terms) give the mask
1 - clamp(sum_k a_k arctan(r)^beta_k, 0, 1), r the pixel distance from the
image centre; the fisheye step multiplies it into its validity mask after
`--start_vignetting` iterations. Also the piecewise-linear radial mask.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class VignettingParams:
    a_k: torch.Tensor     # (n_terms,), init 0.01
    beta_k: torch.Tensor  # (n_terms,), init linspace(2, 8)

    @staticmethod
    def create(n_terms: int = 4, device=None) -> "VignettingParams":
        return VignettingParams(
            a_k=torch.full((n_terms,), 0.01, device=device),
            beta_k=torch.as_tensor(np.linspace(2.0, 8.0, n_terms),
                                   dtype=torch.float32, device=device))

    def named_tensors(self):
        """The tensors by their JAX pytree paths."""
        return {".a_k": self.a_k, ".beta_k": self.beta_k}


def vignetting_mask(params: VignettingParams, height: int, width: int
                    ) -> torch.Tensor:
    """(H, W) multiplicative mask."""
    opts = dict(dtype=params.a_k.dtype, device=params.a_k.device)
    yc, xc = height / 2.0, width / 2.0
    ys = torch.arange(height, **opts)
    xs = torch.arange(width, **opts)
    Y, X = torch.meshgrid(ys, xs, indexing="ij")
    r = torch.sqrt((X - xc) ** 2 + (Y - yc) ** 2)
    rn = torch.where(r == 0, torch.ones_like(r), torch.arctan(r))
    mask = torch.sum(params.a_k[:, None, None]
                     * rn[None] ** params.beta_k[:, None, None], dim=0)
    return 1.0 - torch.clamp(mask, 0.0, 1.0)


def interpolated_radial_mask(scaling_factors: torch.Tensor, height: int,
                             width: int) -> torch.Tensor:
    """Piecewise-linear radial mask from per-ring scale factors (n,)."""
    n = scaling_factors.shape[0]
    opts = dict(dtype=scaling_factors.dtype, device=scaling_factors.device)
    ys = torch.arange(height, **opts) - (height - 1) / 2
    xs = torch.arange(width, **opts) - (width - 1) / 2
    Y, X = torch.meshgrid(ys, xs, indexing="ij")
    d = torch.sqrt(X ** 2 + Y ** 2)
    dn = d / torch.max(d) * (n - 1)
    lo = torch.clamp(torch.floor(dn).long(), 0, n - 2)
    w_hi = dn - lo
    return (1 - w_hi) * scaling_factors[lo] + w_hi * scaling_factors[lo + 1]
