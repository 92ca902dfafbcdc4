"""Plain training steps of the cubemap mode: fields of view past 180
degrees, five renders a step (the reference's `--preset cubemap`,
denghilbert/Bundle-Adjusting-Gaussian-Splatting README.md:131;
utils/cubemap_utils.py:219-288, scene/cameras.py:177-201,
train.py:231-247,287-323; arXiv 2502.09563).

A step on camera c, in plain float32 `torch`:

- five face cameras (`face_poses`): c itself and c turned about its own
  axes (x right, y down, z forward) by +90 degrees about x (up), -90 about
  x (down), -90 about y (left) and +90 about y (right), each keeping c's
  centre; each face's pose is its base pose plus c's row offsets dq, dt,
  at c's FoVs, so that the row's gradient sums over the five;
- each face rendered at the full image size (`render_face`): the
  reference's EWA projection (`render.project`), its binning
  (`render.bin_tiles`) handed each Gaussian's Euclidean distance to the
  face camera's centre under the key it sorts by, so that every tile's
  instances are in distance order and not in depth order, and its
  compositing with the closed-form backward (`render._Composite`); the
  packets keep their depth;
- the ray field (`ray_field`): the pixel grid over [0, W] x [0, H] through
  K^-1 (float64, then float32), warped as if each ray's radius were its
  angle, r -> tan(r) (the equidistant model), plus the residual of the
  cubemap net run forward (sensor to frustum, blocks y = x + g(x) in
  order, `lens.py`'s spectrally normalised MLP) on the control grid
  (every `sample_scale` pixels; its tan warp clipped at r = 1.55),
  upsampled bilinearly with half-pixel centres;
- each face's render masked to the forward face's 90-degree square
  (|x - W/2| <= f, |y - H/2| <= f), sampled (bilinear, zeros outside,
  align_corners) at the rays reprojected onto the face by perspective
  division (`FACE_AXES`) and through K, the side faces half-masked
  (`half_mask`); a ray parallel to a face's plane (its x or y exactly 0 on
  a side face) has no finite position there and reads zero with no
  gradient, as `F.grid_sample` reads a position at infinity; the
  division's own derivative there is not finite, so on such a step the
  net's gradient is not finite and its guard drops it;
- the loss (1 - lambda) sum_f L1_f + lambda (5 - sum_f SSIM_f), face f
  compared as img_f * circ * half_f against gt * circ * half_f, circ the
  disc of `mask_radius` about (W // 2, H // 2);
- Adam (betas 0.9, 0.999, eps 1e-15) of the Gaussians (the positions on
  their schedule), of the camera row (its own step count; the learning
  rates 0 where the configuration trains no camera) and of the cubemap net
  on every step at `lens_lr` halved at `lens_milestones`, whose gradient
  is zeroed whole when any entry is not finite (the moments still step).

`gt_image` makes a camera's ground truth the same way from the clean
scene and a known lens's closed-form rays, the faces stitched by maximum
intensity.

Departures from the published description: the back face, which the
published sub-cameras include and the loss never reads, is not rendered;
a position at 0 / 0 (a ray with x and y both exactly 0) reads zero like
one at infinity, where `F.grid_sample` reads NaN; the Adam of the net is
the textbook update in place of `torch.optim.Adam`'s rounding; the GT is
the scene's five faces warped by the known lens, where the published
data are photographs.

`train_steps` takes the shape of `train.py`'s: `dtype` and `tf32` choose
the precision of the control; `fault` plants a fault for the benchmark's
own checks: "half" takes each face's L1 and SSIM over the top half of the
rows only, "side_faces_dropped" zeroes the four side faces' warped
images.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import lens as lens_lib
from . import render as R
from .loss import AdamState, expon_lr, multistep, ssim
from .train import CAM_LEAVES, GAUSS_LEAVES, Hyper

FACES = ("forward", "up", "down", "left", "right")
# A side face's turns about the camera's own x (right), y (down) and z
# (forward) axes, in degrees.
TURNS = {"up": (90.0, 0.0, 0.0), "down": (-90.0, 0.0, 0.0),
         "left": (0.0, -90.0, 0.0), "right": (0.0, 90.0, 0.0)}
TAN_CLIP = 1.55        # the control grid's tan warp is clipped here
NET_PREFIX = "cubemap"


def _turn(axis: int, degrees: float) -> np.ndarray:
    """The right-handed rotation by `degrees` about coordinate axis `axis`
    (Rodrigues, float64)."""
    a = math.radians(degrees)
    k = np.zeros((3, 3))
    i, j = (axis + 1) % 3, (axis + 2) % 3
    k[j, i], k[i, j] = 1.0, -1.0
    return np.eye(3) + math.sin(a) * k + (1 - math.cos(a)) * k @ k


def _face_axes():
    """Per side face, (perm, sign): the face camera's coordinates of a ray d
    of the main camera are sign * d[perm], the exact integer rotation
    turn^T d."""
    out = {}
    for face, (dx, dy, dz) in TURNS.items():
        m = np.rint((_turn(2, dz) @ _turn(0, dx) @ _turn(1, dy)).T).astype(int)
        perm = [int(np.nonzero(row)[0][0]) for row in m]
        sign = [int(row[p]) for row, p in zip(m, perm)]
        out[face] = (perm, sign)
    return out


FACE_AXES = _face_axes()


def _skew(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[0])
    return torch.stack([torch.stack([z, -w[2], w[1]]), torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def _turn_about(axis: torch.Tensor, degrees: float) -> torch.Tensor:
    """Rodrigues' rotation by `degrees` about the unit vector `axis`."""
    w = math.radians(degrees) * axis
    th2 = torch.sum(w * w)
    th = torch.sqrt(torch.clamp(th2, min=1e-16))
    k = _skew(w)
    return (torch.eye(3, dtype=w.dtype, device=w.device) + (torch.sin(th) / th) * k
            + ((1.0 - torch.cos(th)) / torch.clamp(th2, min=1e-16)) * (k @ k))


def _rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) of a rotation, w >= 0, from the candidate of the
    dominant component (Shepperd)."""
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    cands = torch.stack([
        torch.stack([1.0 + tr, m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]]),
        torch.stack([m[2, 1] - m[1, 2], 1.0 + m[0, 0] - m[1, 1] - m[2, 2],
                     m[0, 1] + m[1, 0], m[0, 2] + m[2, 0]]),
        torch.stack([m[0, 2] - m[2, 0], m[0, 1] + m[1, 0],
                     1.0 + m[1, 1] - m[0, 0] - m[2, 2], m[1, 2] + m[2, 1]]),
        torch.stack([m[1, 0] - m[0, 1], m[0, 2] + m[2, 0], m[1, 2] + m[2, 1],
                     1.0 + m[2, 2] - m[0, 0] - m[1, 1]])])
    scores = torch.stack([1.0 + tr, 1.0 + m[0, 0] - m[1, 1] - m[2, 2],
                          1.0 + m[1, 1] - m[0, 0] - m[2, 2],
                          1.0 + m[2, 2] - m[0, 0] - m[1, 1]])
    q = cands[torch.argmax(scores)]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-8)
    return q * torch.where(q[:1] < 0, -1.0, 1.0)


def face_poses(q_init: torch.Tensor, t_init: torch.Tensor):
    """The base poses (q (5, 4), t (5, 3)) of one camera's five faces in
    FACES order, from its base pose, in float32: the first is the camera's
    own; each side face's camera-to-world rotation is the camera's turned
    about its own y, x and z axes in turn (`TURNS`; one turn is not
    zero), its centre the camera's, its quaternion
    taken with w >= 0 (the sign decides the sign of the row offset dq's
    gradient through the face). Computed in the program's order of
    operations: a Gaussian's distance to a face's centre decides the
    binning's order, and nearly equal distances would swap on another
    rounding of the face's pose."""
    Rm = R.quat_to_rotmat(q_init)
    center = -Rm.T @ t_init
    c2w = Rm.T
    qs, ts = [q_init], [t_init]
    for face in FACES[1:]:
        dx, dy, dz = TURNS[face]
        Rf = (_turn_about(c2w[:, 2], dz) @ (_turn_about(c2w[:, 0], dx)
                                            @ (_turn_about(c2w[:, 1], dy) @ c2w))).T
        qs.append(_rotmat_to_quat(Rf))
        ts.append(-Rf @ center)
    return torch.stack(qs), torch.stack(ts)


def face_center(Rw: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """A face camera's centre -R^T t, summed as the program sums it."""
    return -torch.einsum("...ji,...j->...i", Rw, tw)


def render_face(xyz, scales, quats, opacity, sh, Rw, tw, fovx, fovy, width,
                height, bg, sh_degree: int, counts: bool = False):
    """One face (3, H, W), each tile's instances in order of distance to
    the camera's centre; with `counts`, (image, rows, start, count) for the
    work counts."""
    proj = R.project(xyz, scales, quats, opacity, sh, Rw, tw, fovx, fovy,
                     width, height, sh_degree)
    center = face_center(Rw.detach(), tw.detach())
    dist = torch.linalg.norm(xyz.detach() - center[None, :], dim=-1)
    gid, start, count = R.bin_tiles(dict(proj, depth=dist), width, height)
    table = torch.stack([proj[k] for k in ("mx", "my", "a", "b", "c",
                                           "opacity", "r", "g", "bl", "depth")])
    rows = table[:, gid]
    tiles_x, tiles_y = R.tile_grid(width, height)
    col, t_final = R._Composite.apply(rows, start, count, tiles_x, tiles_y)
    img = R.tiles_to_image(col[..., :3] + t_final[..., None] * bg, tiles_x,
                           tiles_y, width, height)
    if counts:
        return img, rows.detach(), start, count
    return img


def intrinsics(focal: float, width: int, height: int) -> np.ndarray:
    return np.array([[focal, 0.0, width / 2], [0.0, focal, height / 2],
                     [0.0, 0.0, 1.0]])


def pixel_rays(K: np.ndarray, width: int, height: int, step: int = 1):
    """The (H/step, W/step) grid of points over [0, W] x [0, H], row-major,
    through K^-1 onto z = 1: (N, 2) float64."""
    u = np.linspace(0.0, width, width // step)
    v = np.linspace(0.0, height, height // step)
    uu, vv = np.meshgrid(u, v)
    x = (uu - K[0, 2]) / K[0, 0]
    y = (vv - K[1, 2]) / K[1, 1]
    return np.stack([x, y], -1).reshape(-1, 2)


def _tan_warp(rays: torch.Tensor, clip: Optional[float] = None) -> torch.Tensor:
    r = torch.sqrt(torch.sum(rays ** 2, dim=-1, keepdim=True))
    r_c = r if clip is None else torch.clamp(r, max=clip)
    return rays * (torch.tan(r_c) * (1.0 / (r + 1e-7)))


def net_forward(ws, bs, us, x: torch.Tensor) -> torch.Tensor:
    """The net sensor to frustum: each block's x + g(x), in order."""
    for b in range(len(ws)):
        x = x + lens_lib._mlp(lens_lib._norm_ws(ws[b], us[b]), bs[b], x)
    return x


def ray_field(net, K: np.ndarray, width: int, height: int, sample_scale: int,
              device, dtype=torch.float32) -> torch.Tensor:
    """The distorted rays (H * W, 3), homogeneous with z = 1: the tan warp
    of every pixel's ray plus the net's residual on the control grid,
    upsampled."""
    ws, bs, us = net
    base = torch.as_tensor(pixel_rays(K, width, height).astype(np.float32),
                           device=device)
    ctrl = torch.as_tensor(pixel_rays(K, width, height, sample_scale)
                           .astype(np.float32), device=device)
    base = _tan_warp(base)
    ctrl = _tan_warp(ctrl, TAN_CLIP).to(dtype)
    res = (net_forward(ws, bs, us, ctrl) - ctrl).float()
    gh, gw = height // sample_scale, width // sample_scale
    up = F.interpolate(res.reshape(gh, gw, 2).permute(2, 0, 1)[None],
                       size=(height, width), mode="bilinear", align_corners=False)
    rays = base + up[0].permute(1, 2, 0).reshape(-1, 2)
    return torch.cat([rays, torch.ones_like(rays[:, :1])], dim=1)


def known_lens_rays(coeff: Sequence[float], K: np.ndarray, width: int,
                    height: int, device) -> torch.Tensor:
    """The rays (H * W, 3) of an OPENCV_FISHEYE lens `coeff`: each pixel's
    angle theta from its radius r = theta (1 + k1 theta^2 + ... + k4
    theta^8) by a dense table, the ray r's direction times tan(theta)
    (float64, then float32)."""
    p = pixel_rays(K, width, height)
    r_d = np.sqrt((p ** 2).sum(-1))
    th = np.linspace(1e-7, 3.1, 65536)
    poly = th * (1 + coeff[0] * th ** 2 + coeff[1] * th ** 4 + coeff[2] * th ** 6
                 + coeff[3] * th ** 8)
    if not np.all(np.diff(poly) > 0):
        raise ValueError(f"the lens {coeff} is not monotonic up to 3.1 rad")
    theta = np.interp(r_d, poly, th, right=th[-1])
    rays = p * (np.tan(theta) / np.maximum(r_d, 1e-12))[:, None]
    rays = torch.as_tensor(rays.astype(np.float32), device=device)
    return torch.cat([rays, torch.ones_like(rays[:, :1])], dim=1)


def face_grid(rays: torch.Tensor, face: str, focal: float, width: int,
              height: int) -> torch.Tensor:
    """The (H, W, 2) sample positions of face `face` in [-1, 1]: the rays
    in the face camera's coordinates, divided by their z, through K."""
    if face == "forward":
        px, py = rays[:, 0] / rays[:, 2], rays[:, 1] / rays[:, 2]
    else:
        perm, sign = FACE_AXES[face]
        d = [rays[:, p] if s > 0 else -rays[:, p] for p, s in zip(perm, sign)]
        px, py = d[0] / d[2], d[1] / d[2]
    f = float(np.float32(focal))
    cx, cy = float(np.float32(width / 2)), float(np.float32(height / 2))
    u = px * f + cx
    v = py * f + cy
    return torch.stack([u / (width - 1) * 2 - 1, v / (height - 1) * 2 - 1],
                       -1).reshape(height, width, 2)


def square_mask(focal: float, width: int, height: int, device, dtype):
    y, x = torch.meshgrid(torch.arange(height, device=device),
                          torch.arange(width, device=device), indexing="ij")
    return ((torch.abs(x - width / 2) <= focal)
            & (torch.abs(y - height / 2) <= focal)).to(dtype)


def half_mask(face: str, width: int, height: int, device, dtype):
    """Ones, the right half zeroed for "left", the left half for "right",
    the lower half for "up", the upper half for "down"."""
    m = torch.ones((height, width), device=device, dtype=dtype)
    if face == "left":
        m[:, width // 2:] = 0
    elif face == "right":
        m[:, :width // 2] = 0
    elif face == "up":
        m[height // 2:] = 0
    elif face == "down":
        m[:height // 2] = 0
    return m


def disc_mask(radius: float, width: int, height: int, device, dtype):
    y, x = torch.meshgrid(torch.arange(height, device=device),
                          torch.arange(width, device=device), indexing="ij")
    d = torch.sqrt((x - width // 2).float() ** 2 + (y - height // 2).float() ** 2)
    return (d <= radius).to(dtype)


def warp_faces(imgs: List[torch.Tensor], rays: torch.Tensor, focal: float,
               width: int, height: int) -> List[torch.Tensor]:
    """Each face's render square-masked and sampled at its reprojected rays,
    the side faces half-masked."""
    sq = square_mask(focal, width, height, imgs[0].device, imgs[0].dtype)
    out = []
    for img, face in zip(imgs, FACES):
        grid = face_grid(rays, face, focal, width, height).to(img.dtype)
        off = ~torch.isfinite(grid.detach()).all(-1, keepdim=True)
        w = F.grid_sample((img * sq)[None], grid.masked_fill(off, -1e4)[None],
                          mode="bilinear", padding_mode="zeros",
                          align_corners=True)[0]
        out.append(w * half_mask(face, width, height, img.device, img.dtype))
    return out


def stitch(faces: List[torch.Tensor]) -> torch.Tensor:
    """Each pixel from the face of largest channel sum (the first on a tie;
    0 where all are 0)."""
    out = torch.zeros_like(faces[0])
    best = out.sum(0)
    for f in faces:
        s = f.sum(0)
        take = s > best
        out = torch.where(take[None], f, out)
        best = torch.where(take, s, best)
    return out


@dataclasses.dataclass
class CubemapGeometry:
    """The cubemap mode's sizes: the image, its focal length (px), the
    disc's radius, the control grid's step and the net (weights, biases,
    power-iteration vectors, each [block][layer]); `net_seed` draws the
    5 x 512 net of `lens.init_lens` when `net` is None."""

    width: int
    height: int
    focal: float
    mask_radius: float
    sample_scale: int
    net_seed: int = 0
    net: Optional[tuple] = None


def face_renders(params: Dict[str, torch.Tensor], q: torch.Tensor,
                 t: torch.Tensor, fovx, fovy, geometry: CubemapGeometry, bg,
                 sh_degree: int) -> List[torch.Tensor]:
    """The five faces of the raw leaves `params` at face poses q, t."""
    scales = torch.exp(params["scales_log"])
    opac = torch.sigmoid(params["opacity_raw"])
    sh = torch.cat([params["sh_dc"], params["sh_rest"]], dim=1)
    out = []
    for f in range(len(FACES)):
        Rw = R.quat_to_rotmat(q[f])
        out.append(render_face(params["xyz"], scales, params["quats"], opac, sh,
                               Rw, t[f], fovx, fovy, geometry.width,
                               geometry.height, bg, sh_degree))
    return out


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 on or off for CUDA matrix products and convolutions inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@torch.no_grad()
@precision(False)
def gt_image(params: Dict[str, torch.Tensor], q_init, t_init, fovx, fovy,
             geometry: CubemapGeometry, coeff: Sequence[float],
             sh_degree: int) -> torch.Tensor:
    """A camera's GT (3, H, W): the clean scene's five faces warped through
    the known lens `coeff`, stitched by maximum intensity, disc-masked and
    rounded to 8 bits, TF32 off."""
    g = geometry
    dev = params["xyz"].device
    q, t = face_poses(q_init, t_init)
    imgs = face_renders(params, q, t, fovx, fovy, g, torch.zeros(3, device=dev),
                        sh_degree)
    K = intrinsics(g.focal, g.width, g.height)
    faces = warp_faces(imgs, known_lens_rays(coeff, K, g.width, g.height, dev),
                       g.focal, g.width, g.height)
    img = stitch(faces) * disc_mask(g.mask_radius, g.width, g.height, dev,
                                    torch.float32)
    return torch.round(torch.clamp(img, 0.0, 1.0) * 255.0) / 255.0


def five_face_loss(faces: List[torch.Tensor], gt: torch.Tensor, circ, lam: float,
                   half: bool = False) -> torch.Tensor:
    width, height = gt.shape[-1], gt.shape[-2]
    l1 = s = 0.0
    for img, face in zip(faces, FACES):
        hm = half_mask(face, width, height, gt.device, gt.dtype)
        a, b = img * circ * hm, gt * circ * hm
        if half:
            a, b = a[:, :height // 2], b[:, :height // 2]
        l1 = l1 + (a - b).abs().mean()
        s = s + ssim(a, b)
    return (1.0 - lam) * l1 + lam * (len(FACES) - s)


def net_leaves(net) -> Dict[str, torch.Tensor]:
    ws, bs, _ = net
    out = {f"{NET_PREFIX}.w[{b}][{l}]": t for b, blk in enumerate(ws)
           for l, t in enumerate(blk)}
    out.update({f"{NET_PREFIX}.b[{b}][{l}]": t for b, blk in enumerate(bs)
                for l, t in enumerate(blk)})
    return out


def initial_net(geometry: CubemapGeometry, device, dtype=torch.float32):
    """(weights, biases, u_vecs) of the geometry's net as `dtype` copies."""
    if geometry.net is not None:
        return tuple([[torch.as_tensor(t).detach().to(device=device, dtype=dtype)
                       .clone() for t in blk] for blk in part] for part in geometry.net)
    return lens_lib.init_lens(geometry.net_seed, device=device, dtype=dtype)


def train_steps(params: Dict[str, torch.Tensor], cams: Dict[str, torch.Tensor],
                gts: torch.Tensor, order: List[int], hp: Hyper, bg: torch.Tensor,
                geometry: CubemapGeometry, dtype=torch.float32, tf32: bool = False,
                fault: Optional[str] = None) -> dict:
    """`len(order)` cubemap steps on the cameras `order` from the live raw
    leaves `params` (GAUSS_LEAVES) and the camera table `cams` (q_init,
    t_init and the CAM_LEAVES, one row a camera) against `gts` (n, 3, H,
    W). The net trains at `hp.lens_lr` (halved at `hp.lens_milestones`)
    when `hp.opt_lens`. Returns dict(losses, grads (the first step's, by
    leaf; the net's as "cubemap.w[b][l]", "cubemap.b[b][l]"), after (every
    leaf after the last step)), float32 on the device of `params`."""
    with precision(tf32):
        return _run(params, cams, gts, order, hp, bg, geometry, dtype, fault)


def _run(params, cams, gts, order, hp, bg, geometry, dtype, fault):
    g_ = geometry
    dev = bg.device
    g = {k: params[k].detach().to(dtype).clone().requires_grad_(True)
         for k in GAUSS_LEAVES}
    cam = {k: v.detach().to(dtype).clone() for k, v in cams.items()}
    bg = bg.to(dtype)
    net = initial_net(g_, dev, dtype)
    named = dict(g)
    nets = net_leaves(net)
    for t in nets.values():
        t.requires_grad_(hp.opt_lens)
    named.update(nets)
    adam = {k: AdamState(t) for k, t in named.items()}
    cam_adam = {k: (torch.zeros_like(cam[k]), torch.zeros_like(cam[k]))
                for k in CAM_LEAVES}
    cam_count = [0] * cam["fovx"].shape[0]
    lrs = {"sh_dc": hp.feature_lr, "sh_rest": hp.feature_lr / 20.0,
           "opacity_raw": hp.opacity_lr, "scales_log": hp.scaling_lr,
           "quats": hp.rotation_lr}
    K = intrinsics(g_.focal, g_.width, g_.height)
    circ = disc_mask(g_.mask_radius, g_.width, g_.height, dev, dtype)
    poses = {}
    losses, first = [], None
    for step, ci in enumerate(order):
        if ci not in poses:
            poses[ci] = face_poses(cams["q_init"][ci], cams["t_init"][ci])
        q0, t0 = (x.to(dtype) for x in poses[ci])
        row = {k: cam[k][ci].clone().requires_grad_(True) for k in CAM_LEAVES}
        scales = torch.exp(g["scales_log"])
        opac = torch.sigmoid(g["opacity_raw"])
        sh = torch.cat([g["sh_dc"], g["sh_rest"]], dim=1)
        imgs = []
        for f in range(len(FACES)):
            Rw, tw = R.camera_pose(q0[f], t0[f], row["dq"], row["dt"])
            imgs.append(render_face(g["xyz"], scales, g["quats"], opac, sh, Rw, tw,
                                    row["fovx"], row["fovy"], g_.width, g_.height,
                                    bg, hp.sh_degree))
        rays = ray_field(net, K, g_.width, g_.height, g_.sample_scale, dev, dtype)
        faces = warp_faces(imgs, rays.to(dtype), g_.focal, g_.width, g_.height)
        if fault == "side_faces_dropped":
            faces = faces[:1] + [torch.zeros_like(f) for f in faces[1:]]
        loss = five_face_loss(faces, gts[ci].to(dtype), circ, hp.lambda_dssim,
                              half=fault == "half")
        trained = [k for k, t in named.items() if t.requires_grad]
        grads = torch.autograd.grad(loss, [named[k] for k in trained]
                                    + [row[k] for k in CAM_LEAVES], allow_unused=True)
        by_name = {}
        for k, gr in zip(trained + [f"cam.{c}" for c in CAM_LEAVES], grads):
            ref = named[k] if k in named else row[k[4:]]
            by_name[k] = gr if gr is not None else torch.zeros_like(ref)
        net_keys = [k for k in trained if k.startswith(NET_PREFIX + ".")]
        if not all(bool(torch.isfinite(by_name[k]).all()) for k in net_keys):
            for k in net_keys:
                by_name[k] = torch.zeros_like(by_name[k])
        losses.append(float(loss.detach()))
        if first is None:
            first = {}
            for k, v in by_name.items():
                if k.startswith("cam."):
                    full = torch.zeros_like(cam[k[4:]])
                    full[ci] = v
                    first[k] = full.float()
                else:
                    first[k] = v.float()
        with torch.no_grad():
            xyz_lr = expon_lr(step, *hp.xyz_lr)
            for k in GAUSS_LEAVES:
                adam[k].step(g[k], by_name[k], xyz_lr if k == "xyz" else lrs[k])
            lr = multistep(step, hp.lens_lr, hp.lens_milestones, 0.5)
            for k in net_keys:
                adam[k].step(named[k], by_name[k], lr)
            cam_count[ci] += 1
            n = cam_count[ci]
            cam_lr = {"dq": multistep(step, hp.rot_lr, hp.pose_milestones, hp.pose_gamma),
                      "dt": multistep(step, hp.trans_lr, hp.pose_milestones, hp.pose_gamma),
                      "fovx": hp.fov_lr, "fovy": hp.fov_lr}
            for k in CAM_LEAVES:
                m, v = cam_adam[k]
                gr = by_name[f"cam.{k}"]
                m[ci] = 0.9 * m[ci] + 0.1 * gr
                v[ci] = 0.999 * v[ci] + 0.001 * gr * gr
                cam[k][ci] -= cam_lr[k] * (m[ci] / (1 - 0.9 ** n)) / (
                    torch.sqrt(v[ci] / (1 - 0.999 ** n)) + 1e-15)
    after = {k: t.detach().float() for k, t in named.items()}
    after.update({f"cam.{k}": cam[k].float() for k in CAM_LEAVES})
    return dict(losses=losses, grads=first, after=after)
