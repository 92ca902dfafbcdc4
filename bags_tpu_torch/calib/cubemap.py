"""Cubemap rendering for fields of view past 180 degrees (port of
`bags_tpu/calib/cubemap.py`).

The forward face and four sub-cameras turned by +-90 degrees (up, down,
left, right; `core/camera.rotate_camera_pose`) are rendered, each face
masked to the forward face's 90-degree square and warped through one
distortion field: the forward face's distorted rays, a tan warp of the
pixel grid plus the cubemap net's residual on a sparse control grid
upsampled bilinearly, reprojected onto each face by perspective division.
The side faces are half-masked, and the training loss compares each with
a circular-masked wide-field GT.

The banded warp of the JAX package (`warp_to_face`'s `warp_ky` and
`transposed`) is a TPU workaround and is not ported: every warp is the
gather `F.grid_sample`. A ray with x or y exactly 0 is parallel to a side
face's plane and has no finite position on it: it reads zero and passes
no gradient to the render, as the published code's `F.grid_sample` reads
a position at infinity, where the JAX package's gather returns NaN and
the step's loss and every gradient with it. The division's own
derivative there is not finite, so such a step hands the cubemap net a
non-finite gradient, which its NaN guard drops (`train/calibrated.py`).
At a 190-degree field the net's residual moves the rays' zero crossings
through the image, and a ray lands exactly on 0 every few hundred steps.
"""

from __future__ import annotations

import functools
from typing import Callable, List

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.image import resize_bilinear
from ..utils.spans import span
from .iresnet import IResNetParams, iresnet_forward


def generate_ray_grid(K: np.ndarray, width: int, height: int,
                      sample_rate: int = 1, device=None) -> torch.Tensor:
    """The pixel grid over [0, W] x [0, H], (H/s, W/s) points row-major,
    back-projected through K^-1 in float64 and returned as float32 (N, 2)
    ray directions in the z = 1 plane. Built on the host once per K, size
    and device (the JAX package folds it into its compiled step) and
    shared: callers do not write to it."""
    return _ray_grid(tuple(np.asarray(K, np.float64).ravel()), width, height,
                     sample_rate, torch.device(device or "cpu"))


@functools.lru_cache(maxsize=16)
def _ray_grid(k: tuple, width: int, height: int, sample_rate: int,
              device: torch.device) -> torch.Tensor:
    i, j = np.meshgrid(np.linspace(0, width, width // sample_rate),
                       np.linspace(0, height, height // sample_rate),
                       indexing="ij")
    pts = np.stack((i.T, j.T), axis=-1).reshape(-1, 2)
    hom = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    view = (np.linalg.inv(np.reshape(k, (3, 3))) @ hom.T).T
    return torch.as_tensor((view[:, :2] / view[:, 2:3]).astype(np.float32),
                           device=device)


def face_reproject(rays_hom: torch.Tensor, face: str) -> torch.Tensor:
    """Forward-face distorted homogeneous rays (N, 3) onto a cube face by
    perspective division: (N, 3) homogeneous coordinates."""
    if face == "forward":
        return rays_hom
    x, y, z = rays_hom[:, 0], rays_hom[:, 1], rays_hom[:, 2]
    if face == "left":
        p = torch.stack((-z / x, -y / x), dim=1)
    elif face == "right":
        p = torch.stack((-z / x, y / x), dim=1)
    elif face == "up":
        p = torch.stack((-x / y, -z / y), dim=1)
    elif face == "down":
        p = torch.stack((x / y, -z / y), dim=1)
    else:
        raise ValueError(face)
    return torch.cat([p, torch.ones_like(p[:, :1])], dim=1)


def face_grid(K, rays_hom: torch.Tensor, face: str, height: int, width: int,
              img_hw) -> torch.Tensor:
    """The (H, W, 2) sampling grid of `warp_to_face`: the reprojected rays
    through K, normalised to the face render's [-1, 1] frame. K is rounded
    to float32 first, as the JAX package's host constant is."""
    K = torch.as_tensor(np.asarray(K, np.float32), device=rays_hom.device
                        ).to(rays_hom.dtype)
    pix = face_reproject(rays_hom, face) @ K.T
    pix = (pix[:, :2] / pix[:, 2:3]).reshape(height, width, 2)
    gx = pix[..., 0] / (img_hw[1] - 1) * 2 - 1
    gy = pix[..., 1] / (img_hw[0] - 1) * 2 - 1
    return torch.stack((gx, gy), dim=-1)


def warp_to_face(K, rays_hom: torch.Tensor, img: torch.Tensor, face: str,
                 height: int, width: int) -> torch.Tensor:
    """Sample the face render img (C, h, w) bilinearly at the reprojected
    rays (align_corners, zeros outside): (C, height, width). A position
    that is not finite reads zero with no gradient (module doc)."""
    grid = face_grid(K, rays_hom, face, height, width, img.shape[-2:])
    off = ~torch.isfinite(grid.detach()).all(dim=-1, keepdim=True)
    return F.grid_sample(img[None], grid.masked_fill(off, -1e4)[None],
                         mode="bilinear", padding_mode="zeros",
                         align_corners=True)[0]


def mask_half(image: torch.Tensor, direction: str) -> torch.Tensor:
    """Zero one half of image (C, H, W): 'left' the right half, 'right' the
    left half, 'up' the lower half, 'down' the upper half."""
    _, h, w = image.shape
    mask = torch.ones((h, w), dtype=image.dtype, device=image.device)
    if direction == "right":
        mask[:, :w // 2] = 0
    elif direction == "left":
        mask[:, w // 2:] = 0
    elif direction == "down":
        mask[:h // 2] = 0
    elif direction == "up":
        mask[h // 2:] = 0
    return image * mask[None]


def circular_mask(height: int, width: int, radius: float,
                  device=None) -> torch.Tensor:
    """(3, H, W) float32 disc of `radius` about the image centre."""
    yc, xc = height // 2, width // 2
    y, x = torch.meshgrid(torch.arange(height, device=device),
                          torch.arange(width, device=device), indexing="ij")
    d = torch.sqrt((x - xc).float() ** 2.0 + (y - yc).float() ** 2.0)
    return (d <= radius).float().expand(3, height, width)


def fov90_square_mask(height: int, width: int, focal_x: float,
                      focal_y: float, device=None) -> torch.Tensor:
    """(1, H, W) float32: the central square of the forward face's +-45
    degree frustum (half-width = focal)."""
    y, x = torch.meshgrid(torch.arange(height, device=device),
                          torch.arange(width, device=device), indexing="ij")
    inside = (torch.abs(x - width / 2) <= focal_x) & \
        (torch.abs(y - height / 2) <= focal_y)
    return inside.float()[None]


def distorted_rays(cubemap_net: IResNetParams, K: np.ndarray, width: int,
                   height: int, control_point_sample_scale: int
                   ) -> torch.Tensor:
    """The full-resolution distorted homogeneous rays (H * W, 3): the tan
    warp of the pixel grid (unclipped, so that rays pass 90 degrees) plus
    the cubemap net's residual on the control grid (its tan warp clipped
    at 1.55; the net's sensor-to-frustum direction), upsampled. The grids
    and their tan warps are float32, the residual in the net's dtype, as
    in the JAX package."""
    leaf = cubemap_net.weights[0][0]
    scale = control_point_sample_scale
    rays_base = generate_ray_grid(K, width, height, 1, device=leaf.device)
    rays_ctrl = generate_ray_grid(K, width, height, scale, device=leaf.device)

    def tan_warp(rays, clip=None):
        r_d = torch.sqrt(torch.sum(rays ** 2, dim=-1, keepdim=True))
        inv = 1.0 / (r_d + 1e-7)
        r_c = torch.clamp(r_d, max=clip) if clip is not None else r_d
        return rays * (torch.tan(r_c) * inv)

    rays_dis_base = tan_warp(rays_base)
    rays_dis_ctrl = tan_warp(rays_ctrl, clip=1.55).to(leaf.dtype)
    residual = iresnet_forward(cubemap_net, rays_dis_ctrl,
                               sensor_to_frustum=True) - rays_dis_ctrl
    residual = residual.reshape(height // scale, width // scale, 2)
    up = resize_bilinear(residual.permute(2, 0, 1), (height, width))
    rays = rays_dis_base + up.permute(1, 2, 0).reshape(-1, 2)
    return torch.cat([rays, torch.ones_like(rays[:, :1])], dim=1)


FACES = ("forward", "up", "down", "left", "right")


def render_cubemap_faces(render_face: Callable[[int], torch.Tensor],
                         cubemap_net: IResNetParams, K, width: int,
                         height: int, control_point_sample_scale: int,
                         mask_fov90: torch.Tensor):
    """Warp the five faces, under the span "lens": the ray field under
    "cubemap_rays", each face's mask, reprojection and gather under
    "face_warp". render_face(i) returns the (3, H, W) render of face i in
    FACES order (0 the main camera, 1-4 the sub-cameras). Returns (faces,
    0): the warped images, the side faces half-masked, and the JAX
    package's banded-warp overflow, always 0 here."""
    with span("lens"):
        with span("cubemap_rays"):
            rays_hom = distorted_rays(cubemap_net, K, width, height,
                                      control_point_sample_scale)
        out: List[torch.Tensor] = []
        for i, face in enumerate(FACES):
            img = render_face(i)
            with span("face_warp"):
                warped = warp_to_face(K, rays_hom, img * mask_fov90, face,
                                      height, width)
                out.append(warped if face == "forward"
                           else mask_half(warped, face))
    return out, 0


SUB_CAMERA_ROTATIONS = (
    (90.0, 0.0, 0.0),    # up
    (-90.0, 0.0, 0.0),   # down
    (0.0, -90.0, 0.0),   # left
    (0.0, 90.0, 0.0),    # right
    (0.0, 180.0, 0.0),   # back (built, unused by the five-face loss)
)


def _bilinear_sample(img: torch.Tensor, u: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample img (C, H, W) at normalised u, v (P,) in [-1, 1]
    (align_corners=True, border padding): (C, P)."""
    c, h, w = img.shape
    x = (u + 1.0) * 0.5 * (w - 1)
    y = (v + 1.0) * 0.5 * (h - 1)
    x0 = torch.clamp(torch.floor(x).long(), 0, w - 1)
    y0 = torch.clamp(torch.floor(y).long(), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    flat = img.reshape(c, h * w)
    g00, g01 = flat[:, y0 * w + x0], flat[:, y0 * w + x1]
    g10, g11 = flat[:, y1 * w + x0], flat[:, y1 * w + x1]
    top = g00 * (1 - fx) + g01 * fx
    bot = g10 * (1 - fx) + g11 * fx
    return top * (1 - fy) + bot * fy


def cubemap_to_perspective(img_forward: torch.Tensor, img_left: torch.Tensor,
                           img_right: torch.Tensor, img_up: torch.Tensor,
                           img_down: torch.Tensor, fov_h_deg: float,
                           fov_v_deg: float, output_width: int,
                           output_height: int) -> torch.Tensor:
    """Resample five cubemap faces (C, H, W each) into one perspective view
    (C, output_height, output_width): per output pixel, its camera ray
    picks the dominant-axis face, which is sampled bilinearly (every face
    sampled, combined by masks, as the JAX package does)."""
    dev = img_forward.device
    fx = (output_width / 2.0) / np.tan(np.deg2rad(fov_h_deg) / 2.0)
    fy = (output_height / 2.0) / np.tan(np.deg2rad(fov_v_deg) / 2.0)
    jj, ii = torch.meshgrid(
        torch.arange(output_height, dtype=torch.float32, device=dev),
        torch.arange(output_width, dtype=torch.float32, device=dev),
        indexing="ij")
    xc = (ii - output_width / 2.0) / fx
    yc = (output_height / 2.0 - jj) / fy          # y up
    d = torch.stack([xc, yc, torch.ones_like(xc)], dim=-1)
    d = (d / torch.linalg.norm(d, dim=-1, keepdim=True)).reshape(-1, 3)
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    adx, ady, adz = dx.abs(), dy.abs(), dz.abs()

    # face id: 0 forward (+z), 1 right (+x), 2 left (-x), 3 up (+y), 4 down
    def pick(cond, k, rest):
        return torch.where(cond, torch.full_like(rest, k), rest)

    fid = torch.full_like(dx, 4, dtype=torch.long)
    fid = pick((ady > adx) & (ady > adz) & (dy > 0), 3, fid)
    fid = pick((adx >= ady) & (adx >= adz) & (dx < 0), 2, fid)
    fid = pick((adx >= ady) & (adx >= adz) & (dx > 0), 1, fid)
    fid = pick((adz >= adx) & (adz >= ady) & (dz > 0), 0, fid)

    eps = 1e-6
    specs = [(dz, dx, dy),            # forward
             (dx, -dz, dy),           # right
             (-dx, dz, dy),           # left
             (dy, dx, -dz),           # up
             (-dy, dx, dz)]           # down
    out = torch.zeros((img_forward.shape[0], d.shape[0]),
                      dtype=img_forward.dtype, device=dev)
    faces = (img_forward, img_right, img_left, img_up, img_down)
    for k, (den, nu, nv) in enumerate(specs):
        den = torch.where(den.abs() < eps, torch.full_like(den, eps), den)
        out = torch.where(fid == k, _bilinear_sample(faces[k], nu / den,
                                                     nv / den), out)
    return out.reshape(img_forward.shape[0], output_height, output_width)
