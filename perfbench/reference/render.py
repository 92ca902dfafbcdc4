"""Plain PyTorch rendering of 3D Gaussians: the benchmark's own reference.

A frozen, self-contained copy of the standard 3DGS forward model as the
port computes it (EWA projection with the 0.3 dilation and the 1.3 tan
clamp, SH bands 0-3, 16x16 tile binning of the opacity-aware rectangle,
front-to-back compositing with alpha in [1/255, 0.99] and the 1e-4
transmittance stop), written with plain tensor operations only. It
imports nothing of the program, so a later change to the program cannot
change what it is held to.

Every function takes the activated parameters of the Gaussians it should
draw; callers pass the live rows only. The compositing's backward is the
closed form of the front-to-back sum (`_Composite`), chunked over each
tile's instances, so that the reference fits at 1600x1080 and one million
Gaussians.

The precision is the inputs': float32 is the reference; the same code on
bfloat16 inputs is the pose configuration's control.
"""

from __future__ import annotations

import math

import torch

TILE = 16
NPIX = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
FRUSTUM_NEAR = 0.2
DILATION = 0.3

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) (w, x, y, z), normalised here -> (..., 3, 3)."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-8)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def rotmat_to_quat(R) -> list:
    """A host rotation matrix (nested lists or array) -> (w, x, y, z) with
    w >= 0, by the dominant component."""
    m = [[float(R[i][j]) for j in range(3)] for i in range(3)]
    tr = m[0][0] + m[1][1] + m[2][2]
    cands = [
        [1.0 + tr, m[2][1] - m[1][2], m[0][2] - m[2][0], m[1][0] - m[0][1]],
        [m[2][1] - m[1][2], 1.0 + m[0][0] - m[1][1] - m[2][2],
         m[0][1] + m[1][0], m[0][2] + m[2][0]],
        [m[0][2] - m[2][0], m[0][1] + m[1][0],
         1.0 + m[1][1] - m[0][0] - m[2][2], m[1][2] + m[2][1]],
        [m[1][0] - m[0][1], m[0][2] + m[2][0], m[1][2] + m[2][1],
         1.0 + m[2][2] - m[0][0] - m[1][1]]]
    scores = [1.0 + tr, 1.0 + m[0][0] - m[1][1] - m[2][2],
              1.0 + m[1][1] - m[0][0] - m[2][2],
              1.0 + m[2][2] - m[0][0] - m[1][1]]
    q = cands[max(range(4), key=lambda i: scores[i])]
    n = math.sqrt(sum(v * v for v in q))
    q = [v / n for v in q]
    return [-v for v in q] if q[0] < 0 else q


def camera_pose(q_init, t_init, dq, dt):
    """Effective world-to-camera (R, t): R = rot(q_init + dq), t = t_init + dt."""
    return quat_to_rotmat(q_init + dq), t_init + dt


def sh_basis3(d: torch.Tensor) -> torch.Tensor:
    """(N, 3) unit directions -> (N, 16) real SH basis, bands 0-3."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack([
        SH_C0 * torch.ones_like(x),
        -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2.0 * zz - xx - yy),
        SH_C2[3] * xz, SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z,
        SH_C3[2] * y * (4 * zz - xx - yy),
        SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
        SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
        SH_C3[6] * x * (xx - 3 * yy)], dim=-1)


def _rot_entries(q):
    """Rotation-matrix entries of quaternions q (N, 4), as 3 x 3 (N,)."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-8)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return ((1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)),
            (2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)),
            (2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)))


def project(xyz, scales, quats, opacity, sh, R, t, fovx, fovy, width,
            height, sh_degree: int = 3):
    """EWA projection and SH colour of N Gaussians for one camera.

    xyz (N, 3), scales (N, 3) activated, quats (N, 4) raw, opacity (N,)
    activated, sh (N, 16, 3); R (3, 3), t (3,) world-to-camera; fovx, fovy
    0-d tensors. Returns a dict of (N,) screen quantities: mx, my, depth,
    conic a b c, r g b, opacity (0 where culled) and the integer radius and
    binning extents rx, ry (0 where culled).

    Written elementwise, each sum in one fixed order: depths of nearby
    Gaussians often lie within a rounding of each other, and a sum taken
    in another order would swap some of them in the depth sort."""
    r = [[R[i, j] for j in range(3)] for i in range(3)]
    wx, wy, wz = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    tx = r[0][0] * wx + r[0][1] * wy + r[0][2] * wz + t[0]
    ty = r[1][0] * wx + r[1][1] * wy + r[1][2] * wz + t[1]
    depth = r[2][0] * wx + r[2][1] * wy + r[2][2] * wz + t[2]
    tanx, tany = torch.tan(fovx * 0.5), torch.tan(fovy * 0.5)
    w_clip = depth + 1e-7
    mx = (((1.0 / tanx) * tx / w_clip + 1.0) * width - 1.0) * 0.5
    my = (((1.0 / tany) * ty / w_clip + 1.0) * height - 1.0) * 0.5

    Q = _rot_entries(quats)
    m = [[Q[i][0] * scales[:, 0], Q[i][1] * scales[:, 1], Q[i][2] * scales[:, 2]]
         for i in range(3)]

    def dot3(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    s00, s01, s02 = dot3(m[0], m[0]), dot3(m[0], m[1]), dot3(m[0], m[2])
    s11, s12, s22 = dot3(m[1], m[1]), dot3(m[1], m[2]), dot3(m[2], m[2])
    fx = width / (2.0 * tanx)
    fy = height / (2.0 * tany)
    tz = torch.clamp(depth, min=1e-6)
    txz = torch.minimum(torch.maximum(tx / tz, -1.3 * tanx), 1.3 * tanx)
    tyz = torch.minimum(torch.maximum(ty / tz, -1.3 * tany), 1.3 * tany)
    inv_z = 1.0 / tz
    j00, j02 = fx * inv_z, -fx * txz * inv_z
    j11, j12 = fy * inv_z, -fy * tyz * inv_z
    a = [j00 * r[0][k] + j02 * r[2][k] for k in range(3)]
    b = [j11 * r[1][k] + j12 * r[2][k] for k in range(3)]
    sa = [s00 * a[0] + s01 * a[1] + s02 * a[2], s01 * a[0] + s11 * a[1] + s12 * a[2],
          s02 * a[0] + s12 * a[1] + s22 * a[2]]
    sb = [s00 * b[0] + s01 * b[1] + s02 * b[2], s01 * b[0] + s11 * b[1] + s12 * b[2],
          s02 * b[0] + s12 * b[1] + s22 * b[2]]
    c00 = a[0] * sa[0] + a[1] * sa[1] + a[2] * sa[2] + DILATION
    c01 = b[0] * sa[0] + b[1] * sa[1] + b[2] * sa[2]
    c11 = b[0] * sb[0] + b[1] * sb[1] + b[2] * sb[2] + DILATION
    det = c00 * c11 - c01 * c01
    inv_det = 1.0 / torch.where(det > 0, det, torch.ones_like(det))
    mid = 0.5 * (c00 + c11)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam1, min=0.0)))
    valid = (depth > FRUSTUM_NEAR) & (det > 0) & (opacity > 0)
    cut = torch.sqrt(torch.clamp(2.0 * torch.log(255.0 * opacity), min=0.0))
    rx = torch.minimum(radius, torch.ceil(cut * torch.sqrt(torch.clamp(c00, min=0.0))))
    ry = torch.minimum(radius, torch.ceil(cut * torch.sqrt(torch.clamp(c11, min=0.0))))

    center = -torch.einsum("ji,j->i", R, t)
    dx, dy, dz = wx - center[0], wy - center[1], wz - center[2]
    inv_n = 1.0 / torch.sqrt(torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-16))
    basis = sh_basis3(torch.stack([dx * inv_n, dy * inv_n, dz * inv_n], dim=-1))
    k = (sh_degree + 1) ** 2
    cols = []
    for c in range(3):
        acc = sh[:, 0, c] * basis[:, 0]
        for i in range(1, k):
            acc = acc + sh[:, i, c] * basis[:, i]
        cols.append(torch.clamp(acc + 0.5, min=0.0))
    zero_i = torch.zeros_like(radius)
    return dict(mx=mx, my=my, depth=depth, a=c11 * inv_det, b=-c01 * inv_det,
                c=c00 * inv_det, r=cols[0], g=cols[1], bl=cols[2],
                opacity=torch.where(valid, opacity, torch.zeros_like(opacity)),
                radius=torch.where(valid, radius, zero_i).long(),
                rx=torch.where(valid, rx, zero_i).long(),
                ry=torch.where(valid, ry, zero_i).long())


def tile_grid(width: int, height: int):
    return -(-width // TILE), -(-height // TILE)


@torch.no_grad()
def bin_tiles(proj: dict, width: int, height: int):
    """Depth-sorted instance lists per 16x16 tile: one instance per tile
    that a Gaussian's opacity-aware rectangle covers, sorted by (tile,
    depth) with ties kept in Gaussian order. Returns (gauss_id (M,),
    tile_start (T,), tile_count (T,)), all int64."""
    tiles_x, tiles_y = tile_grid(width, height)
    mx, my = proj["mx"].float(), proj["my"].float()
    rx, ry = proj["rx"].float(), proj["ry"].float()
    x0 = torch.clamp(torch.floor((mx - rx) / TILE), 0, tiles_x).long()
    y0 = torch.clamp(torch.floor((my - ry) / TILE), 0, tiles_y).long()
    x1 = torch.clamp(torch.floor((mx + rx) / TILE) + 1, 0, tiles_x).long()
    y1 = torch.clamp(torch.floor((my + ry) / TILE) + 1, 0, tiles_y).long()
    live = (proj["rx"] > 0) & (proj["ry"] > 0)
    nx = torch.where(live, x1 - x0, 0).clamp(min=0)
    ny = torch.where(live, y1 - y0, 0).clamp(min=0)
    ntiles = nx * ny
    n = mx.shape[0]
    dkey = torch.where(ntiles > 0, proj["depth"].float(),
                       torch.full_like(mx, float("inf")))
    order = torch.sort(dkey, stable=True).indices                 # rank -> id
    cnt = ntiles[order]
    rank = torch.repeat_interleave(torch.arange(n, device=mx.device), cnt)
    off = torch.cumsum(cnt, 0) - cnt
    local = torch.arange(rank.shape[0], device=mx.device) - off[rank]
    gid = order[rank]
    w = nx[gid].clamp(min=1)
    tile = (y0[gid] + local // w) * tiles_x + x0[gid] + local % w
    key = torch.sort(tile * (n + 1) + rank, stable=True).values
    tile_sorted = key // (n + 1)
    gauss_id = order[key % (n + 1)]
    count = torch.bincount(tile_sorted, minlength=tiles_x * tiles_y)
    return gauss_id, torch.cumsum(count, 0) - count, count


def _pixel_coords(tiles_x, tiles_y, device, dtype):
    t = torch.arange(tiles_x * tiles_y, device=device)
    o = torch.arange(NPIX, device=device)
    px = ((t % tiles_x) * TILE)[:, None] + (o % TILE)[None, :]
    py = ((t // tiles_x) * TILE)[:, None] + (o // TILE)[None, :]
    return px.to(dtype), py.to(dtype)


def _chunk_terms(rows, start, count, act, k, chunk, px, py, t_act, done_act):
    """The per-pair quantities of one chunk of instances of the tiles
    `act`: features, offsets, power, alpha, which pairs are composited,
    their weights and the transmittance before each."""
    offs = torch.arange(chunk, device=rows.device)
    in_range = (k + offs)[None, :] < count[act, None]
    idx = torch.where(in_range, start[act, None] + k + offs[None, :], 0)
    f = rows[:, idx]
    f = torch.where(in_range[None], f, torch.zeros_like(f))
    mx, my, ca, cb, cc, op = (f[i][..., None] for i in range(6))
    dx = px[act][:, None, :] - mx
    dy = py[act][:, None, :] - my
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    gauss = torch.exp(power)
    o_g = op * gauss
    alpha = torch.clamp(o_g, max=ALPHA_MAX)
    a = torch.where((alpha >= ALPHA_MIN) & (power <= 0.0), alpha,
                    torch.zeros_like(alpha))
    one_minus = 1.0 - a
    cp = torch.cumprod(one_minus, dim=1)
    t_before = t_act[:, None, :] * torch.cat([torch.ones_like(cp[:, :1]),
                                              cp[:, :-1]], dim=1)
    kill = (a > 0) & (t_before * one_minus < T_EPS)
    stopped = (torch.cumsum(kill.int(), dim=1) > 0) | done_act[:, None, :]
    a_inc = torch.where((a > 0) & ~stopped, a, torch.zeros_like(a))
    cpi = torch.cumprod(1.0 - a_inc, dim=1)
    t_inc = t_act[:, None, :] * torch.cat([torch.ones_like(cpi[:, :1]),
                                           cpi[:, :-1]], dim=1)
    return dict(in_range=in_range, idx=idx, f=f, dx=dx, dy=dy, gauss=gauss,
                o_g=o_g, a_inc=a_inc, w=a_inc * t_inc, t_inc=t_inc,
                t_after=t_act * cpi[:, -1, :], killed=kill.any(dim=1))


def composite_forward(rows, start, count, tiles_x, tiles_y, chunk=32):
    """Front-to-back compositing of each tile's depth-sorted instances.
    rows (10, M): mx my a b c opacity r g b depth. Returns (colour and
    depth (T, NPIX, 4), final transmittance (T, NPIX))."""
    dev, dt = rows.device, rows.dtype
    nt = tiles_x * tiles_y
    px, py = _pixel_coords(tiles_x, tiles_y, dev, dt)
    acc = rows.new_zeros((nt, NPIX, 4))
    t_run = rows.new_ones((nt, NPIX))
    done = torch.zeros((nt, NPIX), dtype=torch.bool, device=dev)
    for k in range(0, int(count.max()) if nt else 0, chunk):
        act = torch.nonzero((count > k) & ~done.all(dim=1)).squeeze(1)
        if act.numel() == 0:
            break
        c = _chunk_terms(rows, start, count, act, k, chunk, px, py, t_run[act],
                         done[act])
        col = c["f"][6:10].permute(1, 2, 0)                       # (A, K, 4)
        acc[act] += torch.einsum("akp,akc->apc", c["w"], col)
        t_run[act] = c["t_after"]
        done[act] |= c["killed"]
    return acc, t_run


def composite_backward(rows, start, count, tiles_x, tiles_y, g_col, g_t,
                       col_total, t_final, chunk=32):
    """d rows (10, M) of `composite_forward` for the cotangents g_col
    (T, NPIX, 4) and g_t (T, NPIX), replaying the forward chunk by chunk:
      dL/dalpha_i = <g, c_i> T_i - (S_i + g_T T_final) / (1 - alpha_i),
    with S_i the part of <g, C> composited behind instance i."""
    dev, dt = rows.device, rows.dtype
    nt = tiles_x * tiles_y
    px, py = _pixel_coords(tiles_x, tiles_y, dev, dt)
    g_tot = (g_col * col_total).sum(-1)                          # (T, P)
    gtt = g_t * t_final
    d_rows = torch.zeros_like(rows)
    t_run = rows.new_ones((nt, NPIX))
    prefix = rows.new_zeros((nt, NPIX))
    done = torch.zeros((nt, NPIX), dtype=torch.bool, device=dev)
    for k in range(0, int(count.max()) if nt else 0, chunk):
        act = torch.nonzero((count > k) & ~done.all(dim=1)).squeeze(1)
        if act.numel() == 0:
            break
        c = _chunk_terms(rows, start, count, act, k, chunk, px, py, t_run[act],
                         done[act])
        f, dx, dy, w, a_inc = c["f"], c["dx"], c["dy"], c["w"], c["a_inc"]
        ca, cb, cc = (f[i][..., None] for i in (2, 3, 4))
        col = f[6:10].permute(1, 2, 0)
        g_act = g_col[act]                                        # (A, P, 4)
        g_dot_c = torch.einsum("apc,akc->akp", g_act, col)
        pre = prefix[act][:, None, :] + torch.cumsum(g_dot_c * w, dim=1)
        suffix = g_tot[act][:, None, :] - pre
        d_alpha = g_dot_c * c["t_inc"] - (suffix + gtt[act][:, None, :]) \
            / torch.clamp(1.0 - a_inc, min=1e-6)
        d_alpha = torch.where(a_inc > 0, d_alpha, torch.zeros_like(d_alpha))
        d_ag = torch.where(c["o_g"] < ALPHA_MAX, d_alpha, torch.zeros_like(d_alpha))
        d_pow = d_ag * c["o_g"]
        grads = torch.stack([
            ((ca * dx + cb * dy) * d_pow).sum(-1),
            ((cc * dy + cb * dx) * d_pow).sum(-1),
            (-0.5 * dx * dx * d_pow).sum(-1),
            (-dx * dy * d_pow).sum(-1),
            (-0.5 * dy * dy * d_pow).sum(-1),
            (d_ag * c["gauss"]).sum(-1)] + list(
                torch.einsum("akp,apc->cak", w, g_act)))
        ir = c["in_range"]
        d_rows[:, c["idx"][ir]] = grads[:, ir]
        prefix[act] = pre[:, -1, :]
        t_run[act] = c["t_after"]
        done[act] |= c["killed"]
    return d_rows


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, start, count, tiles_x, tiles_y):
        with torch.no_grad():
            col, t_final = composite_forward(rows, start, count, tiles_x, tiles_y)
        ctx.save_for_backward(rows, start, count, col, t_final)
        ctx.grid = (tiles_x, tiles_y)
        return col, t_final

    @staticmethod
    def backward(ctx, g_col, g_t):
        rows, start, count, col, t_final = ctx.saved_tensors
        with torch.no_grad():
            d = composite_backward(rows, start, count, *ctx.grid, g_col, g_t,
                                   col, t_final)
        return d, None, None, None, None


def tiles_to_image(v: torch.Tensor, tiles_x, tiles_y, width, height):
    """(T, NPIX, C) -> (C, H, W)."""
    c = v.shape[-1]
    img = v.reshape(tiles_y, tiles_x, TILE, TILE, c).permute(4, 0, 2, 1, 3)
    return img.reshape(c, tiles_y * TILE, tiles_x * TILE)[:, :height, :width]


def render(xyz, scales, quats, opacity, sh, R, t, fovx, fovy, width, height,
           bg=None, sh_degree: int = 3, counts: bool = False):
    """One view (3, H, W), the background blended; differentiable in every
    floating input through the closed-form compositing backward. With
    `counts`, returns (image, rows, start, count) for the work counts."""
    proj = project(xyz, scales, quats, opacity, sh, R, t, fovx, fovy, width,
                   height, sh_degree)
    gid, start, count = bin_tiles(proj, width, height)
    table = torch.stack([proj[k] for k in ("mx", "my", "a", "b", "c",
                                           "opacity", "r", "g", "bl", "depth")])
    rows = table[:, gid]
    tiles_x, tiles_y = tile_grid(width, height)
    col, t_final = _Composite.apply(rows, start, count, tiles_x, tiles_y)
    if bg is None:
        bg = xyz.new_zeros(3)
    img = tiles_to_image(col[..., :3] + t_final[..., None] * bg, tiles_x,
                         tiles_y, width, height)
    if counts:
        return img, rows.detach(), start, count
    return img
