"""Real spherical harmonics, bands 0-4 (port of `bags_tpu/core/sh.py`).

Standard PlenOctree constants. `sh_basis` returns the basis values at unit
directions; the projection contracts them with the coefficients.
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)
C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
      -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
      0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def sh_basis(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit directions -> (..., (degree+1)**2) basis values."""
    if not 0 <= degree <= 4:
        raise ValueError(f"SH degree must be in [0, 4], got {degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [C0 * torch.ones_like(x)]
    if degree >= 1:
        out += [-C1 * y, C1 * z, -C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            C2[0] * xy,
            C2[1] * yz,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz,
            C2[4] * (xx - yy),
        ]
    if degree >= 3:
        out += [
            C3[0] * y * (3 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4 * zz - xx - yy),
            C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            C3[4] * x * (4 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3 * yy),
        ]
    if degree >= 4:
        out += [
            C4[0] * xy * (xx - yy),
            C4[1] * yz * (3 * xx - yy),
            C4[2] * xy * (7 * zz - 1),
            C4[3] * yz * (7 * zz - 3),
            C4[4] * (zz * (35 * zz - 30) + 3),
            C4[5] * xz * (7 * zz - 3),
            C4[6] * (xx - yy) * (7 * zz - 1),
            C4[7] * xz * (xx - 3 * yy),
            C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return torch.stack(out, dim=-1)


def eval_sh(degree: int, sh_coeffs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """sh_coeffs (..., C, K) with K >= (degree+1)**2, dirs (..., 3) -> (..., C)."""
    k = num_sh_coeffs(degree)
    basis = sh_basis(degree, dirs)
    return torch.sum(sh_coeffs[..., :k] * basis[..., None, :], dim=-1)


def sh_to_rgb(degree: int, sh_coeffs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH -> clamped RGB as the rasterizer does: max(eval + 0.5, 0)."""
    return torch.clamp(eval_sh(degree, sh_coeffs, dirs) + 0.5, min=0.0)


def rgb_to_sh_dc(rgb):
    return (rgb - 0.5) / C0


def sh_dc_to_rgb(sh):
    return sh * C0 + 0.5


def sh_basis_vjp(degree: int, dirs: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The vector-Jacobian product of `sh_basis` at `dirs` (..., 3) with
    `g` (..., (degree+1)**2): d(sum g * basis) / d dirs, (..., 3). The
    derivatives written out, as `csrc/projection.cu` computes them."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    dx = torch.zeros_like(x)
    dy = torch.zeros_like(x)
    dz = torch.zeros_like(x)
    if degree >= 1:
        dy = dy - C1 * g[..., 1]
        dz = dz + C1 * g[..., 2]
        dx = dx - C1 * g[..., 3]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        dx = dx + C2[0] * y * g[..., 4]
        dy = dy + C2[0] * x * g[..., 4]
        dy = dy + C2[1] * z * g[..., 5]
        dz = dz + C2[1] * y * g[..., 5]
        dx = dx - 2.0 * C2[2] * x * g[..., 6]
        dy = dy - 2.0 * C2[2] * y * g[..., 6]
        dz = dz + 4.0 * C2[2] * z * g[..., 6]
        dx = dx + C2[3] * z * g[..., 7]
        dz = dz + C2[3] * x * g[..., 7]
        dx = dx + 2.0 * C2[4] * x * g[..., 8]
        dy = dy - 2.0 * C2[4] * y * g[..., 8]
    if degree >= 3:
        g9, g10, g11, g12, g13, g14, g15 = (g[..., i] for i in range(9, 16))
        dx = dx + C3[0] * 6.0 * x * y * g9
        dy = dy + C3[0] * 3.0 * (xx - yy) * g9
        dx = dx + C3[1] * y * z * g10
        dy = dy + C3[1] * x * z * g10
        dz = dz + C3[1] * x * y * g10
        dx = dx - C3[2] * 2.0 * x * y * g11
        dy = dy + C3[2] * (4.0 * zz - xx - 3.0 * yy) * g11
        dz = dz + C3[2] * 8.0 * y * z * g11
        dx = dx - C3[3] * 6.0 * x * z * g12
        dy = dy - C3[3] * 6.0 * y * z * g12
        dz = dz + C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy) * g12
        dx = dx + C3[4] * (4.0 * zz - 3.0 * xx - yy) * g13
        dy = dy - C3[4] * 2.0 * x * y * g13
        dz = dz + C3[4] * 8.0 * x * z * g13
        dx = dx + C3[5] * 2.0 * x * z * g14
        dy = dy - C3[5] * 2.0 * y * z * g14
        dz = dz + C3[5] * (xx - yy) * g14
        dx = dx + C3[6] * 3.0 * (xx - yy) * g15
        dy = dy - C3[6] * 6.0 * x * y * g15
    if degree >= 4:
        g16, g17, g18, g19, g20, g21, g22, g23, g24 = (
            g[..., i] for i in range(16, 25))
        dx = dx + C4[0] * y * (3.0 * xx - yy) * g16
        dy = dy + C4[0] * x * (xx - 3.0 * yy) * g16
        dx = dx + C4[1] * 6.0 * x * y * z * g17
        dy = dy + C4[1] * 3.0 * z * (xx - yy) * g17
        dz = dz + C4[1] * y * (3.0 * xx - yy) * g17
        dx = dx + C4[2] * y * (7.0 * zz - 1.0) * g18
        dy = dy + C4[2] * x * (7.0 * zz - 1.0) * g18
        dz = dz + C4[2] * 14.0 * x * y * z * g18
        dy = dy + C4[3] * z * (7.0 * zz - 3.0) * g19
        dz = dz + C4[3] * y * (21.0 * zz - 3.0) * g19
        dz = dz + C4[4] * z * (140.0 * zz - 60.0) * g20
        dx = dx + C4[5] * z * (7.0 * zz - 3.0) * g21
        dz = dz + C4[5] * x * (21.0 * zz - 3.0) * g21
        dx = dx + C4[6] * 2.0 * x * (7.0 * zz - 1.0) * g22
        dy = dy - C4[6] * 2.0 * y * (7.0 * zz - 1.0) * g22
        dz = dz + C4[6] * 14.0 * z * (xx - yy) * g22
        dx = dx + C4[7] * 3.0 * z * (xx - yy) * g23
        dy = dy - C4[7] * 6.0 * x * y * z * g23
        dz = dz + C4[7] * x * (xx - 3.0 * yy) * g23
        dx = dx + C4[8] * 4.0 * x * (xx - 3.0 * yy) * g24
        dy = dy + C4[8] * 4.0 * y * (yy - 3.0 * xx) * g24
    return torch.stack([dx, dy, dz], dim=-1)
