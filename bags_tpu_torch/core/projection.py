"""EWA projection of 3D Gaussians to screen space (port of
`bags_tpu/core/projection.py::_project_gaussians_impl`).

Standard 3DGS math, elementwise over all N Gaussians:
  * view point t = R_w2c p + t_w2c; frustum cull at t.z <= 0.2
  * 3D covariance from quaternion + scales, Σ = (R S)(R S)^T
  * perspective Jacobian J with the 1.3*tan(fov/2) clamp of x/z, y/z
  * cov2d = J W Σ W^T J^T + 0.3 I; conic = cov2d^-1; radius = ceil(3σ_max)
  * pixel center via ndc2Pix: ((ndc + 1) * S - 1) / 2
The operations keep the reference's order so that float32 results agree
to rounding and the integer radii agree exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import sh as sh_lib
from .camera import (CameraParams, CameraStatic, GlobalAlignment, camera_center,
                     focals, pose_w2c, projection_matrix)
from .lie import quat_normalize

FRUSTUM_NEAR = 0.2
DILATION = 0.3
RADIUS_SIGMA = 3.0


@dataclasses.dataclass
class Projected:
    """Per-Gaussian screen-space quantities, structure-of-arrays (all (N,))."""

    x2d: torch.Tensor
    y2d: torch.Tensor
    depth: torch.Tensor     # view-space z (sort key)
    conic_a: torch.Tensor   # inverse 2D covariance upper triangle
    conic_b: torch.Tensor
    conic_c: torch.Tensor
    col_r: torch.Tensor     # RGB from SH (+ optional extra color)
    col_g: torch.Tensor
    col_b: torch.Tensor
    opacity: torch.Tensor   # activated opacity, 0 when culled
    radius: torch.Tensor    # int32 pixel radius (0 => culled)
    # Opacity-aware per-axis binning extents (<= radius): a pixel outside
    # them cannot pass alpha >= 1/255, so binning culls those tiles.
    rect_rx: torch.Tensor
    rect_ry: torch.Tensor

    @property
    def mean2d(self) -> torch.Tensor:
        return torch.stack([self.x2d, self.y2d], dim=-1)

    @property
    def conic(self) -> torch.Tensor:
        return torch.stack([self.conic_a, self.conic_b, self.conic_c], dim=-1)

    @property
    def color(self) -> torch.Tensor:
        return torch.stack([self.col_r, self.col_g, self.col_b], dim=-1)

    def detach(self) -> "Projected":
        return Projected(**{f.name: getattr(self, f.name).detach()
                            for f in dataclasses.fields(self)})


def _rotmat_entries(quats):
    """Rotation-matrix entries from (N, 4) quaternions, as 9 flat (N,) tensors."""
    q = quat_normalize(quats)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return ((1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)),
            (2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)),
            (2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)))


def _covariance_entries(sx, sy, sz, quats):
    """The 6 unique entries of Σ = (R S)(R S)^T, elementwise (N,)."""
    R = _rotmat_entries(quats)
    m = [[R[i][0] * sx, R[i][1] * sy, R[i][2] * sz] for i in range(3)]

    def dot3(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    return (dot3(m[0], m[0]), dot3(m[0], m[1]), dot3(m[0], m[2]),
            dot3(m[1], m[1]), dot3(m[1], m[2]), dot3(m[2], m[2]))


def build_covariance(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """Σ = (R S)(R S)^T as full (N, 3, 3) matrices."""
    s00, s01, s02, s11, s12, s22 = _covariance_entries(
        scales[..., 0], scales[..., 1], scales[..., 2], quats)
    return torch.stack([torch.stack([s00, s01, s02], dim=-1),
                        torch.stack([s01, s11, s12], dim=-1),
                        torch.stack([s02, s12, s22], dim=-1)], dim=-2)


def project_gaussians(
    xyz: torch.Tensor,          # (N, 3) world means
    scales: torch.Tensor,       # (N, 3) activated scales
    quats: torch.Tensor,        # (N, 4) unnormalized rotations
    opacity: torch.Tensor,      # (N,) activated opacity
    sh_coeffs: torch.Tensor,    # (N, K, 3) SH features (DC first)
    cam: CameraParams,
    static: CameraStatic,
    sh_degree: int,
    align: Optional[GlobalAlignment] = None,
    extra_color: Optional[torch.Tensor] = None,    # (N, 3)
    shift_factors: Optional[torch.Tensor] = None,  # (3,)
) -> Projected:
    """Differentiable EWA projection of all Gaussians for one camera.

    shift_factors: the entrance-pupil shift; the view-space point moves by
    shift_factors / clamp(z, 1e-6) before the pixel projection and the
    Jacobian, while `depth` (the cull and the sort key) keeps the unshifted
    z, as in the JAX package.

    The few 3x3 camera products run in full float32: the package switches
    TF32 off (`bags_tpu_torch/__init__.py`); the rest is elementwise.
    """
    R_w2c, t_w2c = pose_w2c(cam, align)
    r = [[R_w2c[i, j] for j in range(3)] for i in range(3)]
    wx, wy, wz = xyz[:, 0], xyz[:, 1], xyz[:, 2]

    # --- view space -------------------------------------------------------
    tx = r[0][0] * wx + r[0][1] * wy + r[0][2] * wz + t_w2c[0]
    ty = r[1][0] * wx + r[1][1] * wy + r[1][2] * wz + t_w2c[1]
    depth = r[2][0] * wx + r[2][1] * wy + r[2][2] * wz + t_w2c[2]
    in_front = depth > FRUSTUM_NEAR
    tz = depth
    if shift_factors is not None:
        inv_d = 1.0 / torch.clamp(depth, min=1e-6)
        tx = tx + shift_factors[0] * inv_d
        ty = ty + shift_factors[1] * inv_d
        tz = tz + shift_factors[2] * inv_d

    # --- pixel projection -------------------------------------------------
    P = projection_matrix(cam.fovx, cam.fovy, static.znear, static.zfar)
    clip_x = P[0, 0] * tx
    clip_y = P[1, 1] * ty
    w_clip = tz + 1e-7
    x2d = ((clip_x / w_clip + 1.0) * static.width - 1.0) * 0.5
    y2d = ((clip_y / w_clip + 1.0) * static.height - 1.0) * 0.5

    # --- 2D covariance (EWA) ---------------------------------------------
    s00, s01, s02, s11, s12, s22 = _covariance_entries(
        scales[:, 0], scales[:, 1], scales[:, 2], quats)
    fx, fy = focals(cam, static)
    tzc = torch.clamp(depth, min=1e-6)
    limx = 1.3 * torch.tan(cam.fovx * 0.5)
    limy = 1.3 * torch.tan(cam.fovy * 0.5)
    txz = torch.minimum(torch.maximum(tx / tzc, -limx), limx)
    tyz = torch.minimum(torch.maximum(ty / tzc, -limy), limy)

    inv_z = 1.0 / tzc
    j00, j02 = fx * inv_z, -fx * txz * inv_z
    j11, j12 = fy * inv_z, -fy * tyz * inv_z
    a0 = j00 * r[0][0] + j02 * r[2][0]
    a1 = j00 * r[0][1] + j02 * r[2][1]
    a2 = j00 * r[0][2] + j02 * r[2][2]
    b0 = j11 * r[1][0] + j12 * r[2][0]
    b1 = j11 * r[1][1] + j12 * r[2][1]
    b2 = j11 * r[1][2] + j12 * r[2][2]

    sa0 = s00 * a0 + s01 * a1 + s02 * a2
    sa1 = s01 * a0 + s11 * a1 + s12 * a2
    sa2 = s02 * a0 + s12 * a1 + s22 * a2
    sb0 = s00 * b0 + s01 * b1 + s02 * b2
    sb1 = s01 * b0 + s11 * b1 + s12 * b2
    sb2 = s02 * b0 + s12 * b1 + s22 * b2
    c00 = a0 * sa0 + a1 * sa1 + a2 * sa2 + DILATION
    c01 = b0 * sa0 + b1 * sa1 + b2 * sa2
    c11 = b0 * sb0 + b1 * sb1 + b2 * sb2 + DILATION

    det = c00 * c11 - c01 * c01
    det_safe = torch.where(det > 0, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe
    conic_a = c11 * inv_det
    conic_b = -c01 * inv_det
    conic_c = c00 * inv_det

    # --- radius & validity ------------------------------------------------
    mid = 0.5 * (c00 + c11)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(RADIUS_SIGMA * torch.sqrt(torch.clamp(lam1, min=0.0)))
    valid = in_front & (det > 0) & (opacity > 0)
    zero = torch.zeros_like(radius_f)
    radius = torch.where(valid, radius_f, zero).to(torch.int32)
    # alpha(d) = o exp(-d^2 / 2σ^2) >= 1/255 <=> d <= sqrt(2 ln(255 o)) σ,
    # per axis with σ^2 the dilated cov2d diagonal.
    cut = torch.sqrt(torch.clamp(2.0 * torch.log(255.0 * opacity), min=0.0))
    rect_fx = torch.minimum(
        radius_f, torch.ceil(cut * torch.sqrt(torch.clamp(c00, min=0.0))))
    rect_fy = torch.minimum(
        radius_f, torch.ceil(cut * torch.sqrt(torch.clamp(c11, min=0.0))))
    rect_rx = torch.where(valid, rect_fx, zero).to(torch.int32)
    rect_ry = torch.where(valid, rect_fy, zero).to(torch.int32)

    # --- color from SH ----------------------------------------------------
    campos = camera_center(cam, align)
    dx = wx - campos[0]
    dy = wy - campos[1]
    dz = wz - campos[2]
    # Clamp the squared norm before the sqrt: clamp(sqrt(s)) has a 0*inf
    # gradient at s == 0 (a dead slot at the camera center).
    inv_n = 1.0 / torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-16))
    dx, dy, dz = dx * inv_n, dy * inv_n, dz * inv_n
    k = sh_lib.num_sh_coeffs(sh_degree)
    basis = sh_lib.sh_basis(sh_degree, torch.stack([dx, dy, dz], dim=-1))
    shT = sh_coeffs[:, :k, :].permute(2, 1, 0)  # (3, k, N)
    cols = []
    for c in range(3):
        acc = shT[c, 0] * basis[..., 0]
        for i in range(1, k):
            acc = acc + shT[c, i] * basis[..., i]
        cols.append(torch.clamp(acc + 0.5, min=0.0))
    col_r, col_g, col_b = cols
    if extra_color is not None:
        col_r = col_r + extra_color[:, 0]
        col_g = col_g + extra_color[:, 1]
        col_b = col_b + extra_color[:, 2]

    return Projected(
        x2d=x2d, y2d=y2d, depth=depth,
        conic_a=conic_a, conic_b=conic_b, conic_c=conic_c,
        col_r=col_r, col_g=col_g, col_b=col_b,
        opacity=torch.where(valid, opacity, torch.zeros_like(opacity)),
        radius=radius, rect_rx=rect_rx, rect_ry=rect_ry,
    )


def distance_to_camera(xyz: torch.Tensor, cam: CameraParams,
                       align: Optional[GlobalAlignment] = None) -> torch.Tensor:
    """Euclidean distance sort key (the cubemap sort-by-distance variant)."""
    c = camera_center(cam, align)
    return torch.linalg.norm(xyz - c[None, :], dim=-1)
