"""EWA projection of 3D Gaussians to screen space (port of
`bags_tpu/core/projection.py::_project_gaussians_impl`).

Standard 3DGS math, elementwise over all N Gaussians:
  * view point t = R_w2c p + t_w2c; frustum cull at t.z <= 0.2
  * 3D covariance from quaternion + scales, Σ = (R S)(R S)^T
  * perspective Jacobian J with the 1.3*tan(fov/2) clamp of x/z, y/z
  * cov2d = J W Σ W^T J^T + 0.3 I; conic = cov2d^-1; radius = ceil(3σ_max)
  * pixel center via ndc2Pix: ((ndc + 1) * S - 1) / 2
  * colour from SH at the view direction, max(eval + 0.5, 0)
The operations keep the reference's order so that float32 results agree
to rounding and the integer radii agree exactly.

Everything the camera contributes is one small vector, `camera_vector`
(built in PyTorch, so autograd carries its gradient to the pose, the FoVs,
the global alignment and the pupil shift). For CUDA tensors
`project_gaussians` runs the layer as two hand-written kernels
(`bags_tpu_torch/csrc/projection.cu`, built and loaded like the compositing
kernels by `raster/composite.py`) behind `_ProjectKernel`: one pass a slot
forward, one backward that recomputes the forward from the inputs and
reduces the camera vector's gradient in the kernel, or it raises. For CPU
tensors it runs `project_plain`, the same arithmetic as PyTorch operations,
which autograd differentiates; `project_backward_plain` is the backward
kernel's hand-derived arithmetic in PyTorch, which the CPU tests hold
against that autograd.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import torch

from . import sh as sh_lib
from .camera import CameraParams, CameraStatic, GlobalAlignment, camera_center, pose_w2c
from .lie import quat_normalize

FRUSTUM_NEAR = 0.2
DILATION = 0.3
RADIUS_SIGMA = 3.0

# The camera vector (`camera_vector`): R_w2c row-major, t_w2c, P[0,0],
# P[1,1], fx, fy, the Jacobian's clamps limx and limy, the camera centre
# and the pupil shift (zeros without one). `csrc/projection.cu` reads the
# same layout.
CAM_R, CAM_T, CAM_P00, CAM_P11, CAM_FX, CAM_FY = 0, 9, 12, 13, 14, 15
CAM_LIMX, CAM_LIMY, CAM_CENTER, CAM_SHIFT, CAM_SIZE = 16, 17, 18, 21, 24

# The float outputs in the order of the kernel's (10, N) buffer; the int32
# outputs in the order of its (3, N) buffer.
FLOAT_FIELDS = ("x2d", "y2d", "depth", "conic_a", "conic_b", "conic_c",
                "col_r", "col_g", "col_b", "opacity")
INT_FIELDS = ("radius", "rect_rx", "rect_ry")
MAX_SH_COEFFS = 25
PROJECT_BLOCK = 128   # threads a block of both kernels (`csrc/projection.cu`)

# Kernel launches made through `project_gaussians` on CUDA tensors (the
# forward) and through their backward, in this process.
project_fwd_launches = 0
project_bwd_launches = 0


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


def _covariance_terms(sx, sy, sz, quats):
    """The rotation entries, M = R S and the 6 unique entries of
    Σ = M M^T, elementwise (N,)."""
    R = _rotmat_entries(quats)
    m = [[R[i][0] * sx, R[i][1] * sy, R[i][2] * sz] for i in range(3)]

    def dot3(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    return R, m, (dot3(m[0], m[0]), dot3(m[0], m[1]), dot3(m[0], m[2]),
                  dot3(m[1], m[1]), dot3(m[1], m[2]), dot3(m[2], m[2]))


def build_covariance(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """Σ = (R S)(R S)^T as full (N, 3, 3) matrices."""
    s00, s01, s02, s11, s12, s22 = _covariance_terms(
        scales[..., 0], scales[..., 1], scales[..., 2], quats)[2]
    return torch.stack([torch.stack([s00, s01, s02], dim=-1),
                        torch.stack([s01, s11, s12], dim=-1),
                        torch.stack([s02, s12, s22], dim=-1)], dim=-2)


def camera_vector(cam: CameraParams, static: CameraStatic,
                  align: Optional[GlobalAlignment] = None,
                  shift_factors: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (CAM_SIZE,) camera vector of one view (layout at CAM_*), each
    entry computed as the reference computes it (P[0,0] = 1/tan(fovx/2) as
    `camera.projection_matrix`, fx as `camera.focals`), so that both paths
    see the same float32 values. Differentiable.

    The few 3x3 camera products run in full float32: the package switches
    TF32 off (`bags_tpu_torch/__init__.py`)."""
    R, t = pose_w2c(cam, align)
    tan_x = torch.tan(cam.fovx * 0.5)
    tan_y = torch.tan(cam.fovy * 0.5)
    scalars = torch.stack([
        1.0 / tan_x, 1.0 / tan_y,
        static.width / (2.0 * tan_x), static.height / (2.0 * tan_y),
        1.3 * tan_x, 1.3 * tan_y])
    center = -torch.einsum("...ji,...j->...i", R, t)   # `camera_center`
    shift = t.new_zeros(3) if shift_factors is None else shift_factors
    return torch.cat([R.reshape(9), t, scalars, center, shift])


def _forward_terms(xyz, scales, quats, opacity, sh_coeffs, camvec, static,
                   sh_degree, has_shift) -> dict:
    """Every intermediate of the projection, as PyTorch operations in the
    reference's order (the plain forward, and the backward's recompute)."""
    c = [camvec[i] for i in range(CAM_SIZE)]
    r = [c[CAM_R + 3 * i: CAM_R + 3 * i + 3] for i in range(3)]
    t_w2c = c[CAM_T: CAM_T + 3]
    f = dict(wx=xyz[:, 0], wy=xyz[:, 1], wz=xyz[:, 2], r=r)
    wx, wy, wz = f["wx"], f["wy"], f["wz"]

    # --- view space -------------------------------------------------------
    tx = r[0][0] * wx + r[0][1] * wy + r[0][2] * wz + t_w2c[0]
    ty = r[1][0] * wx + r[1][1] * wy + r[1][2] * wz + t_w2c[1]
    depth = r[2][0] * wx + r[2][1] * wy + r[2][2] * wz + t_w2c[2]
    f.update(tx0=tx, ty0=ty, depth=depth)
    in_front = depth > FRUSTUM_NEAR
    tz = depth
    if has_shift:
        shift = c[CAM_SHIFT: CAM_SHIFT + 3]
        inv_d = 1.0 / torch.clamp(depth, min=1e-6)
        tx = tx + shift[0] * inv_d
        ty = ty + shift[1] * inv_d
        tz = tz + shift[2] * inv_d
        f.update(shift=shift, inv_d=inv_d)
    f.update(tx=tx, ty=ty, tz=tz)

    # --- pixel projection -------------------------------------------------
    clip_x = c[CAM_P00] * tx
    clip_y = c[CAM_P11] * ty
    w_clip = tz + 1e-7
    f["x2d"] = ((clip_x / w_clip + 1.0) * static.width - 1.0) * 0.5
    f["y2d"] = ((clip_y / w_clip + 1.0) * static.height - 1.0) * 0.5
    f.update(clip_x=clip_x, clip_y=clip_y, w_clip=w_clip)

    # --- 2D covariance (EWA) ---------------------------------------------
    qr, m, (s00, s01, s02, s11, s12, s22) = _covariance_terms(
        scales[:, 0], scales[:, 1], scales[:, 2], quats)
    fx, fy, limx, limy = c[CAM_FX], c[CAM_FY], c[CAM_LIMX], c[CAM_LIMY]
    tzc = torch.clamp(depth, min=1e-6)
    vx, vy = tx / tzc, ty / tzc
    mx, my = torch.maximum(vx, -limx), torch.maximum(vy, -limy)
    txz = torch.minimum(mx, limx)
    tyz = torch.minimum(my, limy)

    inv_z = 1.0 / tzc
    j00, j02 = fx * inv_z, -fx * txz * inv_z
    j11, j12 = fy * inv_z, -fy * tyz * inv_z
    a = [j00 * r[0][k] + j02 * r[2][k] for k in range(3)]
    b = [j11 * r[1][k] + j12 * r[2][k] for k in range(3)]

    def sdot(v):
        return (s00 * v[0] + s01 * v[1] + s02 * v[2],
                s01 * v[0] + s11 * v[1] + s12 * v[2],
                s02 * v[0] + s12 * v[1] + s22 * v[2])

    sa, sb = sdot(a), sdot(b)
    c00 = a[0] * sa[0] + a[1] * sa[1] + a[2] * sa[2] + DILATION
    c01 = b[0] * sa[0] + b[1] * sa[1] + b[2] * sa[2]
    c11 = b[0] * sb[0] + b[1] * sb[1] + b[2] * sb[2] + DILATION

    det = c00 * c11 - c01 * c01
    det_safe = torch.where(det > 0, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe
    f.update(qr=qr, m=m, s=(s00, s01, s02, s11, s12, s22), fx=fx, fy=fy,
             limx=limx, limy=limy, tzc=tzc, vx=vx, vy=vy, mx=mx, my=my,
             txz=txz, tyz=tyz, inv_z=inv_z, j00=j00, j02=j02, j11=j11,
             j12=j12, a=a, b=b, sa=sa, sb=sb, c00=c00, c01=c01, c11=c11,
             det=det, inv_det=inv_det)
    f["conic_a"] = c11 * inv_det
    f["conic_b"] = -c01 * inv_det
    f["conic_c"] = c00 * inv_det

    # --- radius & validity ------------------------------------------------
    mid = 0.5 * (c00 + c11)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(RADIUS_SIGMA * torch.sqrt(torch.clamp(lam1, min=0.0)))
    valid = in_front & (det > 0) & (opacity > 0)
    zero = torch.zeros_like(radius_f)
    f["valid"] = valid
    f["radius"] = torch.where(valid, radius_f, zero).to(torch.int32)
    # alpha(d) = o exp(-d^2 / 2σ^2) >= 1/255 <=> d <= sqrt(2 ln(255 o)) σ,
    # per axis with σ^2 the dilated cov2d diagonal.
    cut = torch.sqrt(torch.clamp(2.0 * torch.log(255.0 * opacity), min=0.0))
    rect_fx = torch.minimum(
        radius_f, torch.ceil(cut * torch.sqrt(torch.clamp(c00, min=0.0))))
    rect_fy = torch.minimum(
        radius_f, torch.ceil(cut * torch.sqrt(torch.clamp(c11, min=0.0))))
    f["rect_rx"] = torch.where(valid, rect_fx, zero).to(torch.int32)
    f["rect_ry"] = torch.where(valid, rect_fy, zero).to(torch.int32)
    f["opacity"] = torch.where(valid, opacity, torch.zeros_like(opacity))

    # --- color from SH ----------------------------------------------------
    campos = c[CAM_CENTER: CAM_CENTER + 3]
    dx = wx - campos[0]
    dy = wy - campos[1]
    dz = wz - campos[2]
    # Clamp the squared norm before the sqrt: clamp(sqrt(s)) has a 0*inf
    # gradient at s == 0 (a dead slot at the camera center).
    sq = dx * dx + dy * dy + dz * dz
    inv_n = 1.0 / torch.sqrt(torch.clamp(sq, min=1e-16))
    f.update(dx=dx, dy=dy, dz=dz, sq=sq, inv_n=inv_n)
    dx, dy, dz = dx * inv_n, dy * inv_n, dz * inv_n
    k = sh_lib.num_sh_coeffs(sh_degree)
    dirs = torch.stack([dx, dy, dz], dim=-1)
    basis = sh_lib.sh_basis(sh_degree, dirs)
    shT = sh_coeffs[:, :k, :].permute(2, 1, 0)  # (3, k, N)
    pre = []
    for ch in range(3):
        acc = shT[ch, 0] * basis[..., 0]
        for i in range(1, k):
            acc = acc + shT[ch, i] * basis[..., i]
        pre.append(acc + 0.5)
    f.update(dirs=dirs, basis=basis, pre=pre)
    f["col_r"], f["col_g"], f["col_b"] = (torch.clamp(p, min=0.0) for p in pre)
    return f


def project_plain(xyz, scales, quats, opacity, sh_coeffs, camvec: torch.Tensor,
                  static: CameraStatic, sh_degree: int, has_shift: bool
                  ) -> Projected:
    """The projection as PyTorch operations on any device (the plain
    version of `_ProjectKernel`), without extra colour; autograd
    differentiates it."""
    f = _forward_terms(xyz, scales, quats, opacity, sh_coeffs, camvec, static,
                       sh_degree, has_shift)
    return Projected(**{name: f[name] for name in FLOAT_FIELDS + INT_FIELDS})


def project_backward_plain(xyz, scales, quats, opacity, sh_coeffs,
                           camvec: torch.Tensor, static: CameraStatic,
                           sh_degree: int, has_shift: bool,
                           grads: Sequence[Optional[torch.Tensor]]):
    """The backward kernel's arithmetic in PyTorch: the gradients of
    (xyz, scales, quats, opacity, sh_coeffs, camvec) from those of the
    FLOAT_FIELDS outputs (`grads`, None for an output without one), by the
    hand-derived chain rule with autograd's subgradients (clamp passes at
    the bound, minimum and maximum split a tie, where picks a side).
    Coefficients above the active degree get zero."""
    with torch.no_grad():
        f = _forward_terms(xyz, scales, quats, opacity, sh_coeffs, camvec,
                           static, sh_degree, has_shift)
        zero = torch.zeros_like(f["depth"])
        (g_x2d, g_y2d, g_depth, g_ca, g_cb, g_cc, g_r, g_g, g_b,
         g_op) = (zero if g is None else g for g in grads)
        r, a, b, sa, sb = f["r"], f["a"], f["b"], f["sa"], f["sb"]
        d_cam = [zero] * CAM_SIZE

        # opacity and colour
        d_opacity = torch.where(f["valid"], g_op, zero)
        k = sh_lib.num_sh_coeffs(sh_degree)
        g_pre = [torch.where(p >= 0.0, g, zero)
                 for p, g in zip(f["pre"], (g_r, g_g, g_b))]
        g_pre = torch.stack(g_pre, dim=-1)                            # (N, 3)
        d_sh = torch.zeros_like(sh_coeffs)
        d_sh[:, :k, :] = f["basis"][:, :, None] * g_pre[:, None, :]
        d_basis = (sh_coeffs[:, :k, :] * g_pre[:, None, :]).sum(-1)   # (N, k)
        d_dir = sh_lib.sh_basis_vjp(sh_degree, f["dirs"], d_basis)
        inv_n = f["inv_n"]
        raw = (f["dx"], f["dy"], f["dz"])
        g_inv_n = sum(d_dir[:, j] * raw[j] for j in range(3))
        g_sq = torch.where(f["sq"] >= 1e-16, -0.5 * g_inv_n * inv_n ** 3, zero)
        d_xyz = [d_dir[:, j] * inv_n + 2.0 * raw[j] * g_sq for j in range(3)]
        for j in range(3):
            d_cam[CAM_CENTER + j] = -d_xyz[j]

        # conic
        c00, c01, c11, inv_det = f["c00"], f["c01"], f["c11"], f["inv_det"]
        d_c00 = g_cc * inv_det
        d_c01 = -g_cb * inv_det
        d_c11 = g_ca * inv_det
        g_inv_det = g_ca * c11 - g_cb * c01 + g_cc * c00
        d_det = torch.where(f["det"] > 0, -g_inv_det * inv_det * inv_det, zero)
        d_c00 = d_c00 + d_det * c11
        d_c11 = d_c11 + d_det * c00
        d_c01 = d_c01 - 2.0 * d_det * c01

        # 2D covariance c = [a; b] Σ [a; b]^T
        d_a = [2.0 * d_c00 * sa[i] + d_c01 * sb[i] for i in range(3)]
        d_b = [d_c01 * sa[i] + 2.0 * d_c11 * sb[i] for i in range(3)]
        d_s = {}   # Σ's unique entries: an off-diagonal one sits twice
        for i in range(3):
            for j in range(i, 3):
                if i == j:
                    d_s[i, i] = (d_c00 * a[i] * a[i] + d_c01 * b[i] * a[i]
                                 + d_c11 * b[i] * b[i])
                else:
                    d_s[i, j] = (2.0 * d_c00 * a[i] * a[j]
                                 + d_c01 * (b[i] * a[j] + b[j] * a[i])
                                 + 2.0 * d_c11 * b[i] * b[j])

        # Jacobian rows a = j00 R0 + j02 R2, b = j11 R1 + j12 R2
        j00, j02, j11, j12 = f["j00"], f["j02"], f["j11"], f["j12"]
        d_j00 = sum(d_a[i] * r[0][i] for i in range(3))
        d_j02 = sum(d_a[i] * r[2][i] for i in range(3))
        d_j11 = sum(d_b[i] * r[1][i] for i in range(3))
        d_j12 = sum(d_b[i] * r[2][i] for i in range(3))
        d_r = [[None] * 3 for _ in range(3)]
        for i in range(3):
            d_r[0][i] = d_a[i] * j00
            d_r[1][i] = d_b[i] * j11
            d_r[2][i] = d_a[i] * j02 + d_b[i] * j12
        fx, fy, txz, tyz, inv_z = f["fx"], f["fy"], f["txz"], f["tyz"], f["inv_z"]
        d_cam[CAM_FX] = d_j00 * inv_z - d_j02 * txz * inv_z
        d_cam[CAM_FY] = d_j11 * inv_z - d_j12 * tyz * inv_z
        d_txz = -d_j02 * fx * inv_z
        d_tyz = -d_j12 * fy * inv_z
        d_inv_z = d_j00 * fx - d_j02 * fx * txz + d_j11 * fy - d_j12 * fy * tyz
        d_tzc = -d_inv_z * inv_z * inv_z

        # the clamps of x/z and y/z: min(max(v, -lim), lim)
        tzc = f["tzc"]
        d_t = {}
        for axis, d_clamped, lim_at in (("x", d_txz, CAM_LIMX),
                                        ("y", d_tyz, CAM_LIMY)):
            v, mm, lim = f["v" + axis], f["m" + axis], f["lim" + axis]
            to_m = torch.where(mm < lim, 1.0, torch.where(mm == lim, 0.5, 0.0))
            d_m = d_clamped * to_m
            to_v = torch.where(v > -lim, 1.0, torch.where(v == -lim, 0.5, 0.0))
            d_v = d_m * to_v
            d_cam[lim_at] = (d_clamped - d_m) - (d_m - d_v)
            d_t[axis] = d_v / tzc
            d_tzc = d_tzc - d_v * v / tzc

        # pixel centre
        w_clip = f["w_clip"]
        d_px = g_x2d * 0.5 * static.width
        d_py = g_y2d * 0.5 * static.height
        d_clip_x = d_px / w_clip
        d_clip_y = d_py / w_clip
        d_w = -(d_px * f["clip_x"] + d_py * f["clip_y"]) / (w_clip * w_clip)
        d_cam[CAM_P00] = d_clip_x * f["tx"]
        d_cam[CAM_P11] = d_clip_y * f["ty"]
        d_tx = d_t["x"] + d_clip_x * camvec[CAM_P00]
        d_ty = d_t["y"] + d_clip_y * camvec[CAM_P11]
        d_tz = d_w

        # pupil shift, depth clamp
        depth = f["depth"]
        d_depth = g_depth + d_tz
        d_clamp = d_tzc
        if has_shift:
            inv_d, shift = f["inv_d"], f["shift"]
            d_cam[CAM_SHIFT] = d_tx * inv_d
            d_cam[CAM_SHIFT + 1] = d_ty * inv_d
            d_cam[CAM_SHIFT + 2] = d_tz * inv_d
            d_inv_d = d_tx * shift[0] + d_ty * shift[1] + d_tz * shift[2]
            d_clamp = d_clamp - d_inv_d * inv_d * inv_d
        d_depth = d_depth + torch.where(depth >= 1e-6, d_clamp, zero)

        # view space t = R p + t_w2c
        p = (f["wx"], f["wy"], f["wz"])
        d_view = (d_tx, d_ty, d_depth)
        for i in range(3):
            d_cam[CAM_T + i] = d_view[i]
            for j in range(3):
                d_r[i][j] = d_r[i][j] + d_view[i] * p[j]
                d_xyz[j] = d_xyz[j] + d_view[i] * r[i][j]
                d_cam[CAM_R + 3 * i + j] = d_r[i][j]

        # 3D covariance Σ = M M^T, M = Q diag(s)
        qr, m = f["qr"], f["m"]
        sc = (scales[:, 0], scales[:, 1], scales[:, 2])

        def ds(i, j):
            return d_s[min(i, j), max(i, j)]

        d_m = [[2.0 * ds(i, i) * m[i][kk]
                + sum(ds(i, j) * m[j][kk] for j in range(3) if j != i)
                for kk in range(3)] for i in range(3)]
        d_scales = [sum(d_m[i][kk] * qr[i][kk] for i in range(3))
                    for kk in range(3)]
        dq = [[d_m[i][kk] * sc[kk] for kk in range(3)] for i in range(3)]
        norm = torch.linalg.norm(quats, dim=-1)
        nc = torch.clamp(norm, min=1e-8)
        qw, qx, qy, qz = (quats[:, i] / nc for i in range(4))
        d_qn = (
            2.0 * (-dq[0][1] * qz + dq[0][2] * qy + dq[1][0] * qz
                   - dq[1][2] * qx - dq[2][0] * qy + dq[2][1] * qx),
            2.0 * (dq[0][1] * qy + dq[0][2] * qz + dq[1][0] * qy
                   - 2.0 * dq[1][1] * qx - dq[1][2] * qw + dq[2][0] * qz
                   + dq[2][1] * qw - 2.0 * dq[2][2] * qx),
            2.0 * (-2.0 * dq[0][0] * qy + dq[0][1] * qx + dq[0][2] * qw
                   + dq[1][0] * qx + dq[1][2] * qz - dq[2][0] * qw
                   + dq[2][1] * qz - 2.0 * dq[2][2] * qy),
            2.0 * (-2.0 * dq[0][0] * qz - dq[0][1] * qw + dq[0][2] * qx
                   + dq[1][0] * qw - 2.0 * dq[1][1] * qz + dq[1][2] * qy
                   + dq[2][0] * qx + dq[2][1] * qy))
        # q / clamp(|q|, 1e-8)
        d_nc = -sum(d_qn[i] * quats[:, i] for i in range(4)) / (nc * nc)
        d_norm = torch.where(norm >= 1e-8, d_nc, zero)
        d_norm = torch.where(norm != 0, d_norm / torch.where(norm != 0, norm, 1.0),
                             zero)
        d_quats = [d_qn[i] / nc + d_norm * quats[:, i] for i in range(4)]

        return (torch.stack(d_xyz, dim=-1), torch.stack(d_scales, dim=-1),
                torch.stack(d_quats, dim=-1), d_opacity, d_sh,
                torch.stack([x.sum() for x in d_cam]))


def _check_kernel_inputs(xyz, scales, quats, opacity, sh_coeffs, camvec,
                         sh_degree):
    """Raise on inputs the kernels do not take."""
    n = xyz.shape[0]
    shapes = {"xyz": (xyz, (n, 3)), "scales": (scales, (n, 3)),
              "quats": (quats, (n, 4)), "opacity": (opacity, (n,)),
              "camera vector": (camvec, (CAM_SIZE,))}
    for name, (x, shape) in shapes.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    if not 0 <= sh_degree <= 4:
        raise ValueError(f"SH degree must be in [0, 4], got {sh_degree}")
    k = sh_lib.num_sh_coeffs(sh_degree)
    if (sh_coeffs.dim() != 3 or sh_coeffs.shape[0] != n
            or not k <= sh_coeffs.shape[1] <= MAX_SH_COEFFS
            or sh_coeffs.shape[2] != 3):
        raise ValueError(f"sh_coeffs must be ({n}, K, 3) with {k} <= K <= "
                         f"{MAX_SH_COEFFS}, got {tuple(sh_coeffs.shape)}")
    named = shapes | {"sh_coeffs": (sh_coeffs, None)}
    for name, (x, _) in named.items():
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if x.device != xyz.device:
            raise ValueError(f"{name} on {x.device}, xyz on {xyz.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if quats.data_ptr() % 16:
        raise ValueError("quats must start on a 16-byte boundary (the kernels "
                         "read a row as one float4)")


def _launch_fwd(xyz, scales, quats, opacity, sh_coeffs, camvec, static,
                sh_degree, has_shift):
    """The forward kernel on the current stream. Returns the (10, N) float
    and (3, N) int32 outputs."""
    global project_fwd_launches
    from ..raster import composite

    fn = composite.load_kernel("project_fwd_launch")
    n = xyz.shape[0]
    out = torch.empty((len(FLOAT_FIELDS), n), dtype=torch.float32,
                      device=xyz.device)
    iout = torch.empty((len(INT_FIELDS), n), dtype=torch.int32,
                       device=xyz.device)
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(sh_degree, xyz.data_ptr(), scales.data_ptr(), quats.data_ptr(),
                 opacity.data_ptr(), sh_coeffs.data_ptr(), sh_coeffs.shape[1],
                 camvec.data_ptr(), int(has_shift), static.width,
                 static.height, n, out.data_ptr(), iout.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"project_fwd kernel launch failed: cudaError {err}")
    project_fwd_launches += 1
    return out, iout


def _launch_bwd(xyz, scales, quats, opacity, sh_coeffs, camvec, static,
                sh_degree, has_shift, grads, needs):
    """The backward kernel and its fixed-order reduction of the camera
    partials. `grads`: the 10 output gradients, None where autograd has
    none (passed as a null pointer); `needs`: which of the 6 input
    gradients to write (a null pointer for the others)."""
    global project_bwd_launches
    from ..raster import composite

    fn = composite.load_kernel("project_bwd_launch")
    n = xyz.shape[0]
    outs = [torch.empty_like(x) if need else None for x, need in zip(
        (xyz, scales, quats, opacity, sh_coeffs), needs)]
    blocks = -(-n // PROJECT_BLOCK)
    partials = torch.empty((blocks, CAM_SIZE), dtype=torch.float32,
                           device=xyz.device)
    d_cam = torch.empty(CAM_SIZE, dtype=torch.float32, device=xyz.device)
    ptr = [None if g is None else g.data_ptr() for g in grads]
    out_ptr = [None if x is None else x.data_ptr() for x in outs]
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(sh_degree, xyz.data_ptr(), scales.data_ptr(), quats.data_ptr(),
                 opacity.data_ptr(), sh_coeffs.data_ptr(), sh_coeffs.shape[1],
                 camvec.data_ptr(), int(has_shift), static.width,
                 static.height, n, *ptr, *out_ptr, partials.data_ptr(), blocks,
                 d_cam.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"project_bwd kernel launch failed: cudaError {err}")
    project_bwd_launches += 1
    return (*outs, d_cam)


def kernel_info(which: str, sh_degree: int, k: int) -> dict:
    """The resources of the forward ("fwd") or backward ("bwd") kernel at
    SH degree `sh_degree` with k coefficients a row, on the current card:
    resident blocks per SM (at PROJECT_BLOCK threads and the block's
    dynamic shared memory), registers per thread, shared memory per block
    (bytes) and local memory per thread (bytes; spills)."""
    from ..raster import composite

    out = (ctypes.c_int * 4)()
    err = composite.load_kernel("project_info")(int(which == "bwd"), sh_degree,
                                                k, out)
    if err != 0:
        raise RuntimeError(f"project_info failed: cudaError {err}")
    return dict(zip(("blocks_per_sm", "registers", "smem_bytes", "local_bytes"),
                    out))


class _ProjectKernel(torch.autograd.Function):
    """`project_plain` on the card: the forward kernel writes the float
    outputs into one (10, N) buffer whose rows the fields take as views;
    the backward kernel recomputes the forward from the saved inputs and
    the camera vector."""

    @staticmethod
    def forward(ctx, xyz, scales, quats, opacity, sh_coeffs, camvec, static,
                sh_degree, has_shift):
        out, iout = _launch_fwd(xyz, scales, quats, opacity, sh_coeffs, camvec,
                                static, sh_degree, has_shift)
        ints = iout.unbind(0)
        ctx.mark_non_differentiable(*ints)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xyz, scales, quats, opacity, sh_coeffs, camvec)
        ctx.args = (static, sh_degree, has_shift)
        return (*out.unbind(0), *ints)

    @staticmethod
    def backward(ctx, *grads):
        grads = [None if g is None else g.contiguous()
                 for g in grads[:len(FLOAT_FIELDS)]]
        saved = ctx.saved_tensors
        n = saved[0].shape[0]
        for g in grads:
            if g is not None and (g.dtype != torch.float32
                                  or tuple(g.shape) != (n,)):
                raise ValueError(f"output gradients must be float32 ({n},), "
                                 f"got {g.dtype} {tuple(g.shape)}")
        needs = ctx.needs_input_grad[:5]
        *d_inputs, d_cam = _launch_bwd(*saved, *ctx.args, grads, needs)
        return (*d_inputs, d_cam if ctx.needs_input_grad[5] else None,
                None, None, None)


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
    """Differentiable EWA projection of all Gaussians for one camera: the
    kernels for CUDA tensors (float32, contiguous, on one device, or it
    raises), `project_plain` for CPU tensors.

    shift_factors: the entrance-pupil shift; the view-space point moves by
    shift_factors / clamp(z, 1e-6) before the pixel projection and the
    Jacobian, while `depth` (the cull and the sort key) keeps the unshifted
    z, as in the JAX package. extra_color is added to the clamped SH colour.
    """
    camvec = camera_vector(cam, static, align, shift_factors)
    has_shift = shift_factors is not None
    if xyz.device.type == "cuda":
        _check_kernel_inputs(xyz, scales, quats, opacity, sh_coeffs, camvec,
                             sh_degree)
        outs = _ProjectKernel.apply(xyz, scales, quats, opacity, sh_coeffs,
                                    camvec, static, sh_degree, has_shift)
        proj = Projected(**dict(zip(FLOAT_FIELDS + INT_FIELDS, outs)))
    else:
        proj = project_plain(xyz, scales, quats, opacity, sh_coeffs, camvec,
                             static, sh_degree, has_shift)
    if extra_color is not None:
        proj = dataclasses.replace(proj, col_r=proj.col_r + extra_color[:, 0],
                                   col_g=proj.col_g + extra_color[:, 1],
                                   col_b=proj.col_b + extra_color[:, 2])
    return proj


def distance_to_camera(xyz: torch.Tensor, cam: CameraParams,
                       align: Optional[GlobalAlignment] = None) -> torch.Tensor:
    """Euclidean distance sort key (the cubemap sort-by-distance variant)."""
    c = camera_center(cam, align)
    return torch.linalg.norm(xyz - c[None, :], dim=-1)
