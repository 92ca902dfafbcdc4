"""Plain lens model of the fisheye mode: the invertible residual network,
its flow field and the warp of a render into the fisheye frame.

The network maps sensor points to ideal-frustum points: 5 blocks
y = x + g(x), each g an MLP 2 -> 512 -> 512 -> 512 -> 512 -> 2 with ELU,
its weights spectrally normalised at call time (5 power iterations from
fixed vectors, Lipschitz 0.9 per block). The fisheye mode needs the inverse
at the control points: per block, 12 undamped 2x2 Newton steps from x = y,
with the implicit-function backward (I + J)^T u = v. The flow is that
inverse times the projection diagonal, upsampled bilinearly to the flow
size; the render is sampled at it (bilinear, zeros outside,
align_corners), centre-cropped to the fisheye size, and masked where both
of its first two channels are exactly zero.

`init_lens(seed)` draws the net as the port's seeded init does, draw for
draw from `np.random.default_rng(seed)`; the reference works the weights
out again from the seed.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

N_BLOCKS, HIDDEN, N_LAYERS = 5, 512, 4
LIPSCHITZ, NEWTON_ITERS, POWER_ITERS = 0.9, 12, 5


def init_lens(seed: int, device=None, dtype=torch.float32):
    """(weights, biases, u_vecs), each [block][layer]; weights (in, out)
    N(0, 1/in), biases zero, u_vecs N(0, 1)."""
    rng = np.random.default_rng(seed)
    ws, bs, us = [], [], []
    for _ in range(N_BLOCKS):
        dims = [2] + [HIDDEN] * N_LAYERS + [2]
        w_b, b_b, u_b = [], [], []
        for i in range(len(dims) - 1):
            w = rng.normal(0, 1.0 / np.sqrt(dims[i]),
                           (dims[i], dims[i + 1])).astype(np.float32)
            u = rng.normal(size=(dims[i],)).astype(np.float32)
            w_b.append(torch.as_tensor(w, device=device).to(dtype))
            b_b.append(torch.zeros(dims[i + 1], device=device, dtype=dtype))
            u_b.append(torch.as_tensor(u, device=device).to(dtype))
        ws.append(w_b)
        bs.append(b_b)
        us.append(u_b)
    return ws, bs, us


def _normalise(w, u, target):
    with torch.no_grad():
        wc, u = w.detach(), u.detach()
        v = None
        for _ in range(POWER_ITERS):
            v = wc.T @ u
            v = v / torch.clamp(torch.linalg.norm(v), min=1e-12)
            u = wc @ v
            u = u / torch.clamp(torch.linalg.norm(u), min=1e-12)
    sigma = u @ (w @ v)
    return w * torch.clamp(target / torch.clamp(sigma.abs(), min=1e-12), max=1.0)


def _norm_ws(ws, us):
    target = LIPSCHITZ ** (1.0 / len(ws))
    return [_normalise(w, u, target) for w, u in zip(ws, us)]


def _mlp(ws, bs, x):
    h = x
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = h @ w + b
        if i < len(ws) - 1:
            h = F.elu(h)
    return h


def _mlp_jac(ws, bs, x):
    """g(x) and dg/dx as four (P,) entries by a forward tangent sweep."""
    h, t0, t1 = x, None, None
    for i, (w, b) in enumerate(zip(ws, bs)):
        z = h @ w + b
        if i == 0:
            t0, t1 = w[0].expand_as(z), w[1].expand_as(z)
        else:
            t0, t1 = t0 @ w, t1 @ w
        if i < len(ws) - 1:
            dz = torch.exp(torch.clamp(z, max=0.0))
            h, t0, t1 = F.elu(z), t0 * dz, t1 * dz
        else:
            h = z
    return h, t0[..., 0], t1[..., 0], t0[..., 1], t1[..., 1]


class _Inverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, n, *tensors):
        ws, bs, us = tensors[:n], tensors[n:2 * n], tensors[2 * n:]
        with torch.no_grad():
            nw = _norm_ws(ws, us)
            x = y
            for _ in range(NEWTON_ITERS):
                g, j00, j01, j10, j11 = _mlp_jac(nw, bs, x)
                f = x + g - y
                a, d = j00 + 1.0, j11 + 1.0
                det = a * d - j01 * j10
                x = x - torch.stack([(d * f[..., 0] - j01 * f[..., 1]) / det,
                                     (a * f[..., 1] - j10 * f[..., 0]) / det], -1)
        ctx.n = n
        ctx.save_for_backward(x, *tensors)
        return x

    @staticmethod
    def backward(ctx, v):
        x, *tensors = ctx.saved_tensors
        n = ctx.n
        ws, bs, us = tensors[:n], tensors[n:2 * n], tensors[2 * n:]
        with torch.no_grad():
            _, j00, j01, j10, j11 = _mlp_jac(_norm_ws(ws, us), bs, x)
            a, d = j00 + 1.0, j11 + 1.0
            det = a * d - j01 * j10
            u = torch.stack([(d * v[..., 0] - j10 * v[..., 1]) / det,
                             (a * v[..., 1] - j01 * v[..., 0]) / det], -1)
        want = ctx.needs_input_grad[2:2 * n + 2]
        cot = [None] * (2 * n)
        if any(want):
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(True) for t in ws + bs]
                g = _mlp(_norm_ws(leaves[:n], us), leaves[n:], x)
                grads = torch.autograd.grad(g, leaves, u)
            cot = [-gr if w else None for gr, w in zip(grads, want)]
        return (u, None, *cot, *([None] * n))


def inverse(ws, bs, us, y):
    """Sensor points from frustum points y (P, 2): the blocks' inverses in
    reverse order."""
    for b in reversed(range(len(ws))):
        n = len(ws[b])
        y = _Inverse.apply(y, n, *ws[b], *bs[b], *us[b])
    return y


def control_points(fx, fy, fish_w, fish_h, flow_scale, grid_hw, device=None):
    """The (gh * gw, 2) control grid over the flow-scaled sensor, through K^-1."""
    sw, sh = int(fish_w * flow_scale[0]), int(fish_h * flow_scale[1])
    gh, gw = grid_hw
    i, j = np.meshgrid(np.linspace(0, sw, gw), np.linspace(0, sh, gh),
                       indexing="ij")
    p = np.stack((i.T, j.T), axis=-1).astype(np.float32).reshape(-1, 2)
    K = np.array([[fx, 0, sw / 2], [0, fy, sh / 2], [0, 0, 1.0]])
    hom = np.concatenate([p, np.ones((p.shape[0], 1), np.float32)], 1)
    view = (np.linalg.inv(K) @ hom.T).T
    return torch.as_tensor((view[:, :2] / view[:, 2:3]).astype(np.float32),
                           device=device)


def upsample(ctrl: torch.Tensor, grid_hw, scale: torch.Tensor, out_hw):
    """(gh * gw, 2) frustum points -> NDC flow (H, W, 2)."""
    flow = ctrl.reshape(grid_hw[0], grid_hw[1], 2) * scale.reshape(1, 1, 2)
    up = F.interpolate(flow.permute(2, 0, 1)[None], size=tuple(out_hw),
                       mode="bilinear", align_corners=False)
    return up[0].permute(1, 2, 0)


def warp(image: torch.Tensor, flow: torch.Tensor, final_hw):
    """The render (C, H, W) sampled at the flow, centre-cropped to final_hw.
    Returns (warped, mask (1, h, w))."""
    out = F.grid_sample(image[None], flow[None], mode="bilinear",
                        padding_mode="zeros", align_corners=True)[0]
    _, h, w = out.shape
    th, tw = final_hw
    if (th, tw) != (h, w):
        sy, sx = (h - th) // 2, (w - tw) // 2
        ys = torch.linspace(sy, sy + th - 1, th, device=out.device, dtype=out.dtype)
        xs = torch.linspace(sx, sx + tw - 1, tw, device=out.device, dtype=out.dtype)
        grid = torch.stack(torch.meshgrid(2.0 * xs / (w - 1) - 1.0,
                                          2.0 * ys / (h - 1) - 1.0,
                                          indexing="xy"), dim=-1)
        out = F.grid_sample(out[None], grid[None], mode="bilinear",
                            padding_mode="zeros", align_corners=True)[0]
    mask = ~((out[0] == 0.0) & (out[1] == 0.0))
    return out, mask[None].to(out.dtype)


def known_lens_flow(coeff, p_view: torch.Tensor, grid_hw, scale, out_hw):
    """The flow a converged net would give for the OPENCV_FISHEYE lens
    `coeff`: the theta polynomial inverted by a dense table (float64)."""
    p = p_view.detach().cpu().double().numpy()
    r_d = np.sqrt((p ** 2).sum(-1))
    th = np.linspace(1e-7, 1.5, 8192)
    poly = th + coeff[0] * th ** 3 + coeff[1] * th ** 5 + coeff[2] * th ** 7 \
        + coeff[3] * th ** 9
    theta = np.interp(r_d, poly, th, right=1.5)
    ctrl = p * (np.tan(theta) / np.maximum(r_d, 1e-9))[:, None]
    return upsample(torch.as_tensor(ctrl.astype(np.float32), device=p_view.device),
                    grid_hw, torch.as_tensor(np.asarray(scale, np.float32),
                                             device=p_view.device), out_hw)
