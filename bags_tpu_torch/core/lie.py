"""Quaternion / SO(3) / SE(3) math on tensors (port of `bags_tpu/core/lie.py`).

Conventions: quaternions are (w, x, y, z); rotations act on column vectors.
Everything is batched over leading dimensions; the small-angle branches use
`torch.where` with both branches finite, so autograd stays NaN-free at 0.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


# ---------------------------------------------------------------------------
# Quaternions
# ---------------------------------------------------------------------------

def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, (..., 4) x (..., 4) -> (..., 4)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) unit-or-not quaternion -> (..., 3, 3) rotation.

    Normalizes internally, so gradients w.r.t. an unnormalized residual
    quaternion flow as in the reference.
    """
    w, x, y, z = quat_normalize(q).unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
    ], dim=-2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) (w, x, y, z), branchless Shepperd's method
    with the canonical sign w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    # Four candidate (unnormalized) quaternions, one per dominant component.
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11], dim=-1)
    scores = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22,
         1.0 + m22 - m00 - m11], dim=-1)
    best = torch.argmax(scores, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)            # (..., 4, 4)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = quat_normalize(torch.gather(cands, -2, idx)[..., 0, :])
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    return torch.einsum("...ij,...j->...i", quat_to_rotmat(q), v)


# ---------------------------------------------------------------------------
# so(3) / SE(3)
# ---------------------------------------------------------------------------

def skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    wx, wy, wz = w.unbind(-1)
    zeros = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zeros, -wz, wy], dim=-1),
        torch.stack([wz, zeros, -wx], dim=-1),
        torch.stack([-wy, wx, zeros], dim=-1),
    ], dim=-2)


def _sinc_coeffs(theta2: torch.Tensor):
    """A = sin(t)/t, B = (1-cos t)/t^2, C = (t - sin t)/t^3 with Taylor
    branches near 0."""
    theta2_safe = torch.clamp(theta2, min=_EPS ** 2)
    theta = torch.sqrt(theta2_safe)
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2_safe * theta))
    return A, B, C


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """so(3) tangent (..., 3) -> SO(3) matrix (..., 3, 3) via Rodrigues."""
    A, B, _ = _sinc_coeffs(torch.sum(w * w, dim=-1))
    K = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + A[..., None, None] * K + B[..., None, None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """SO(3) (..., 3, 3) -> so(3) (..., 3)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((tr - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                       R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    scale = torch.where(
        theta < 1e-6, 0.5 + theta * theta / 12.0,
        theta / (2.0 * torch.clamp(torch.sin(theta), min=_EPS)))
    return scale[..., None] * vee


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) tangent (..., 6) [w | u] -> (..., 4, 4) homogeneous transform."""
    w, u = xi[..., :3], xi[..., 3:]
    A, B, C = _sinc_coeffs(torch.sum(w * w, dim=-1))
    K = skew(w)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(K.shape)
    KK = K @ K
    R = eye + A[..., None, None] * K + B[..., None, None] * KK
    V = eye + B[..., None, None] * K + C[..., None, None] * KK
    t = torch.einsum("...ij,...j->...i", V, u)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = xi.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(*top.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def rotation_distance(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Angle (radians) between rotations."""
    R_rel = torch.einsum("...ij,...kj->...ik", R1, R2)  # R1 @ R2^T
    tr = R_rel[..., 0, 0] + R_rel[..., 1, 1] + R_rel[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7))
