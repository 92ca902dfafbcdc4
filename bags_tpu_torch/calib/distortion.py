"""Lens distortion pipeline, the fisheye half (port of
`bags_tpu/calib/distortion.py`).

  * control-point grids on the extended sensor back-projected through
    K^-1 (`make_control_grid`);
  * analytic targets from COLMAP OPENCV_FISHEYE / radial coefficients
    (`distort_by_coeff`, `read_colmap_coeff`) and the iResNet pre-fit to
    them (`fit_iresnet_to_targets`, `init_iresnet_from_colmap`; on the
    card each Adam step of the pre-fit is one CUDA graph launch,
    `GraphedFit`);
  * `compute_flow`: the lens net on the sparse control grid, scaled by the
    projection diagonal into NDC, upsampled bilinearly to full resolution;
  * `apply_distortion`: the rendered perspective image warped into the
    fisheye frame (or the fisheye GT into perspective with apply2gt) by
    `grid_sample`, optionally centre-cropped, with its validity mask;
  * the closed-form inverse of the theta polynomial for known-lens
    datasets and the recovered-flow error (`analytic_inverse_flow`,
    `flow_error_px`).

The cubemap net's pre-fit (`init_cubemap_net`) fits the same way on
circular samples of the theta polynomial (`cubemap_fit_points`). The
banded warp (`apply_distortion_banded`) is a TPU workaround and is not
ported.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.image import center_crop_resample, grid_sample, resize_bilinear
from .iresnet import IResNetParams, iresnet_forward


def make_control_grid(K: np.ndarray, sensor_w: int, sensor_h: int,
                      sample_w: int, sample_h: int, device=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (sample_h, sample_w) grid spanning [0, sensor_w] x [0, sensor_h]
    with the principal point at the sensor centre, back-projected through
    K^-1 and dehomogenised. Returns (P_sensor (h, w, 2), P_view (h*w, 2)),
    float32."""
    K = np.array(K, np.float64)
    K[0, 2] = sensor_w / 2
    K[1, 2] = sensor_h / 2
    i, j = np.meshgrid(np.linspace(0, sensor_w, sample_w),
                       np.linspace(0, sensor_h, sample_h), indexing="ij")
    p_sensor = np.stack((i.T, j.T), axis=-1).astype(np.float32)
    flat = p_sensor.reshape(-1, 2)
    hom = np.concatenate([flat, np.ones((flat.shape[0], 1), np.float32)], 1)
    view = (np.linalg.inv(K) @ hom.T).T
    view = (view[:, :2] / view[:, 2:3]).astype(np.float32)
    return (torch.as_tensor(p_sensor, device=device),
            torch.as_tensor(view, device=device))


def distort_by_coeff(points: torch.Tensor, coeff) -> torch.Tensor:
    """Analytic distortion of normalised points: 4 coefficients -> the
    OPENCV_FISHEYE theta polynomial, 2 / 3 -> radial r^2, r^4 (, r^6), 8 ->
    the fisheye form of the first four."""
    coeff = [float(c) for c in coeff]
    r = torch.sqrt(torch.sum(points ** 2, dim=-1, keepdim=True))
    r = torch.clamp(r, min=1e-9)
    theta = torch.arctan(r)
    inv_r = 1.0 / r
    if len(coeff) in (4, 8):
        k = coeff[:4]
        poly = theta + k[0] * theta ** 3 + k[1] * theta ** 5 \
            + k[2] * theta ** 7 + (k[3] * theta ** 9 if len(coeff) == 4 else 0.0)
        return points * (inv_r * poly)
    if len(coeff) == 2:
        return points * (1 + coeff[0] * r ** 2 + coeff[1] * r ** 4)
    if len(coeff) == 3:
        return points * (1 + coeff[0] * r ** 2 + coeff[1] * r ** 4
                         + coeff[2] * r ** 6)
    return points


def invert_theta_poly(r_d: np.ndarray, coeff, theta_max: float = 1.5
                      ) -> np.ndarray:
    """theta with poly(theta) = r_d for the OPENCV_FISHEYE polynomial, by a
    dense monotone table and interpolation (host side)."""
    th = np.linspace(1e-7, theta_max, 8192)
    poly = th + coeff[0] * th ** 3 + coeff[1] * th ** 5 \
        + coeff[2] * th ** 7 + coeff[3] * th ** 9
    return np.interp(np.asarray(r_d), poly, th, right=theta_max)


def _np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _true_frustum_points(coeff, p_view) -> np.ndarray:
    """The closed-form undistortion of control points (float64)."""
    p = _np64(p_view)
    r_d = np.sqrt((p ** 2).sum(-1))
    theta = invert_theta_poly(r_d, coeff)
    return p * (np.tan(theta) / np.maximum(r_d, 1e-9))[:, None]


def analytic_inverse_flow(coeff, p_view: torch.Tensor, grid_hw, proj_scale,
                          out_hw) -> torch.Tensor:
    """The NDC flow field (out_h, out_w, 2) that a perfectly converged lens
    net would give for the analytic OPENCV_FISHEYE model: the counterpart
    of `compute_flow(..., sensor_to_frustum=False)` with the closed-form
    inverse. Used to make known-lens fisheye datasets."""
    ctrl = torch.as_tensor(_true_frustum_points(coeff, p_view).astype(np.float32),
                           device=p_view.device).reshape(grid_hw[0], grid_hw[1], 2)
    scale = torch.as_tensor(_np64(proj_scale).astype(np.float32),
                            device=p_view.device)
    flow = ctrl * scale.reshape(1, 1, 2)
    return resize_bilinear(flow.permute(2, 0, 1), out_hw).permute(1, 2, 0)


@torch.no_grad()
def flow_error_px(lens_params: IResNetParams, coeff, p_view: torch.Tensor,
                  proj_scale, render_w: int, max_ndc: float = 1.0,
                  fit_scale: bool = False) -> float:
    """Mean |learned - true| undistortion flow over the control points whose
    true NDC lies within max_ndc, in render pixels. With fit_scale the
    learned flow is first scaled by the best global factor (a global flow
    scale is not photometrically identifiable)."""
    p_n_true = _true_frustum_points(coeff, p_view)
    p_n_hat = iresnet_forward(lens_params, p_view, sensor_to_frustum=False)
    p_n_hat = p_n_hat.double().cpu().numpy()
    proj = _np64(proj_scale).reshape(1, 2)
    ndc_true = p_n_true * proj
    ndc_hat = p_n_hat * proj
    valid = np.all(np.abs(ndc_true) <= max_ndc, axis=-1)
    if not valid.any():
        return float("nan")
    h, t = ndc_hat[valid], ndc_true[valid]
    if fit_scale:
        alpha = float((h * t).sum() / np.maximum((h * h).sum(), 1e-12))
        h = alpha * h
    err_ndc = np.linalg.norm(h - t, axis=-1)
    return float(np.mean(err_ndc) * 0.5 * (render_w - 1))


def read_colmap_coeff(source_path: str) -> list:
    """Distortion coefficients of the paired fisheye COLMAP model
    (`fish/sparse/0/cameras.bin`), or of a VR-NeRF `cameras.json`; zeros
    when there is neither."""
    from ..data.colmap import read_cameras_binary

    candidates = [os.path.join(source_path, "fish", "sparse", "0", "cameras.bin"),
                  os.path.join(source_path, "sparse", "0", "cameras.bin")
                  if "fish" in source_path else None]
    for path in filter(None, candidates):
        if os.path.exists(path):
            for cam in read_cameras_binary(path).values():
                if "FISHEYE" in cam.model:
                    return np.asarray(cam.params)[-4:].tolist()
                if "RADIAL" in cam.model:
                    return np.asarray(cam.params)[-2:].tolist()
    krt = os.path.join(source_path, "cameras.json")
    if os.path.exists(krt):
        with open(krt) as f:
            return json.load(f)["KRT"][-1]["distortion"]
    return [0.0, 0.0, 0.0, 0.0]


def prefit_loss(params: IResNetParams, inputs: torch.Tensor,
                targets: torch.Tensor) -> torch.Tensor:
    """The pre-fit's objective: the mean squared error of forward(inputs)
    against targets, non-finite predictions counted as 0."""
    pred = iresnet_forward(params, inputs, sensor_to_frustum=True)
    pred = torch.where(torch.isfinite(pred), pred, torch.zeros_like(pred))
    return torch.mean((pred - targets) ** 2)


def _prefit_adam(leaves, lr: float, capturable: bool = False):
    # plain Adam at optax.adam's defaults
    return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=capturable)


def fit_eager(params: IResNetParams, inputs: torch.Tensor,
              targets: torch.Tensor, iters: int, lr: float) -> IResNetParams:
    """`iters` eager Adam steps of `prefit_loss`, in place: the pre-fit on
    the CPU, and on the card the reference the graphed fit is held
    against."""
    opt = _prefit_adam(params.parameters(), lr)
    for _ in range(iters):
        opt.zero_grad()
        prefit_loss(params, inputs, targets).backward()
        opt.step()
    return params


class GraphedFit:
    """The pre-fit's Adam step on the card as one CUDA graph.

    An eager step of the 5x512 lens net launches about a thousand small
    kernels (25 spectral normalisations of 5 power iterations, the MLP and
    its backward, Adam over 50 leaves), so the eager loop waits on the
    host. Here `warmup` eager steps (at least one: the capturable Adam's
    moments must exist before the capture) run on a side stream, then one
    step is captured; `replay(n)` takes n more steps, each one graph
    launch. The inputs, targets, gradients and Adam state are the graph's
    static tensors. A capture that fails raises. `close()` frees the graph
    and the gradients."""

    def __init__(self, params: IResNetParams, inputs: torch.Tensor,
                 targets: torch.Tensor, lr: float, warmup: int = 3):
        if inputs.device.type != "cuda" or warmup < 1:
            raise ValueError("the graphed pre-fit needs CUDA tensors and at "
                             f"least one warm-up step (got {inputs.device}, "
                             f"warmup={warmup})")
        self.leaves = params.parameters()
        self.opt = _prefit_adam(self.leaves, lr, capturable=True)
        side = torch.cuda.Stream(inputs.device)
        side.wait_stream(torch.cuda.current_stream(inputs.device))
        with torch.cuda.stream(side):
            for _ in range(warmup):
                self.opt.zero_grad()
                prefit_loss(params, inputs, targets).backward()
                self.opt.step()
        torch.cuda.current_stream(inputs.device).wait_stream(side)
        self.steps = warmup
        # gradients unset, so that the captured backward allocates them in
        # the graph's pool and every replay writes them anew
        self.opt.zero_grad(set_to_none=True)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            prefit_loss(params, inputs, targets).backward()
            self.opt.step()

    def replay(self, n: int) -> None:
        for _ in range(n):
            self.graph.replay()
        self.steps += n

    def close(self) -> None:
        for t in self.leaves:
            t.grad = None
        self.graph = None


def fit_iresnet_to_targets(params: IResNetParams, inputs: torch.Tensor,
                           targets: torch.Tensor, iters: int = 5000,
                           lr: float = 1e-4) -> IResNetParams:
    """Pre-fit the lens net in place so that forward(inputs) ~= targets:
    `iters` steps of plain Adam (lr, eps 1e-8: optax.adam's defaults) on
    `prefit_loss`. On the CPU the eager loop (`fit_eager`); on the card
    the step is captured once and replayed (`GraphedFit`)."""
    dtype = params.parameters()[0].dtype
    inputs, targets = inputs.to(dtype), targets.to(dtype)
    if inputs.device.type == "cpu":
        return fit_eager(params, inputs, targets, iters, lr)
    if iters < 1:
        return params
    fit = GraphedFit(params, inputs, targets, lr, warmup=min(iters, 3))
    fit.replay(iters - fit.steps)
    fit.close()
    return params


def colmap_fit_points(K: np.ndarray, fish_w: int, fish_h: int, coeff,
                      device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pre-fit's inputs and targets: two control grids (boundary scales
    5 and 1.5, 40x40 each, 3,200 points) and their analytic distortion by
    `coeff`, non-finite targets set to 0."""
    grids = []
    for boundary_scale in (5.0, 1.5):
        w = int(fish_w * boundary_scale)
        h = int(fish_h * boundary_scale)
        _, view = make_control_grid(K, w, h, 40, 40, device=device)
        grids.append(view)
    inputs = torch.cat(grids, dim=0)
    targets = distort_by_coeff(inputs, coeff)
    targets = torch.where(torch.isfinite(targets), targets,
                          torch.zeros_like(targets))
    return inputs, targets


def init_iresnet_from_colmap(params: IResNetParams, K: np.ndarray,
                             fish_w: int, fish_h: int, coeff,
                             iters: int = 5000, lr: float = 1e-4
                             ) -> IResNetParams:
    """Pre-fit the lens net to the analytic coefficient model on
    `colmap_fit_points`; in place, returns `params`."""
    inputs, targets = colmap_fit_points(K, fish_w, fish_h, coeff,
                                        params.weights[0][0].device)
    return fit_iresnet_to_targets(params, inputs, targets, iters, lr)


def cubemap_fit_points(coeff, device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cubemap pre-fit's inputs and targets: 1,600 radii (0.05 to 80)
    x 100 angles of ideal points, distorted by the theta polynomial of
    `coeff` and rescaled by r_n / r_d (the inputs), and the ideal points
    (the targets); 160,000 float32 points each, built in numpy as the JAX
    package builds them."""
    radii = np.arange(0.05, 80.0 + 1e-7, 0.05)
    angles = np.linspace(0, 2 * np.pi, 100)
    R, Th = np.meshgrid(radii, angles, indexing="ij")
    pts_n = np.stack([(R * np.cos(Th)).ravel(), (R * np.sin(Th)).ravel()],
                     axis=-1).astype(np.float32)
    r_n = np.sqrt((pts_n ** 2).sum(-1))
    at = np.arctan(r_n)
    r_d = at + coeff[0] * at ** 3 + coeff[1] * at ** 5 \
        + coeff[2] * at ** 7 + coeff[3] * at ** 9
    pts_d = pts_n * (r_d / (r_n + 1e-5))[:, None]
    scale = r_n / (r_d + 1e-5)
    return (torch.as_tensor(pts_d * scale[:, None], dtype=torch.float32,
                            device=device),
            torch.as_tensor(pts_n, device=device))


def init_cubemap_net(params: IResNetParams, coeff,
                     iters: int = 100) -> IResNetParams:
    """Pre-fit the cubemap residual net to `coeff` on `cubemap_fit_points`
    (forward(inputs) ~= targets, `iters` Adam steps at lr 1e-4); in place,
    returns `params`."""
    inputs, targets = cubemap_fit_points(coeff, params.weights[0][0].device)
    return fit_iresnet_to_targets(params, inputs, targets, iters, 1e-4)


def compute_flow(lens_params: IResNetParams, p_view: torch.Tensor, grid_hw,
                 proj_scale: torch.Tensor, out_hw, sensor_to_frustum: bool
                 ) -> torch.Tensor:
    """Control points -> NDC flow field (out_h, out_w, 2): the lens net (or
    its inverse), x / y scaled by the projection diagonal, upsampled."""
    out = iresnet_forward(lens_params, p_view,
                          sensor_to_frustum=sensor_to_frustum)
    flow = out.reshape(grid_hw[0], grid_hw[1], 2) * proj_scale.reshape(1, 1, 2)
    return resize_bilinear(flow.permute(2, 0, 1), out_hw).permute(1, 2, 0)


def apply_distortion(lens_params: IResNetParams, p_view: torch.Tensor,
                     grid_hw, image: torch.Tensor, proj_scale: torch.Tensor,
                     out_hw, final_hw: Optional[Tuple[int, int]] = None,
                     apply2gt: bool = False,
                     flow: Optional[torch.Tensor] = None):
    """Warp a rendered perspective image (C, H, W) into the distorted frame,
    or with apply2gt the fisheye GT into perspective. Returns (warped, mask
    (1, H', W'), flow). The mask is 0 where both of the first two channels
    are exactly 0 (apply2render: every tap outside the image) or below 1e-5
    (apply2gt)."""
    if flow is None:
        flow = compute_flow(lens_params, p_view, grid_hw, proj_scale, out_hw,
                            sensor_to_frustum=apply2gt)
    warped = grid_sample(image, flow)
    if not apply2gt and final_hw is not None and \
            tuple(final_hw) != tuple(warped.shape[-2:]):
        warped = center_crop_resample(warped, final_hw[0], final_hw[1])
    return warped, warp_mask(warped, apply2gt), flow


def warp_mask(warped: torch.Tensor, apply2gt: bool) -> torch.Tensor:
    """The validity mask (1, H, W) of a warped image (C, H, W): 0 where
    both of the first two channels are exactly 0 (apply2render) or below
    1e-5 (apply2gt)."""
    if apply2gt:
        empty = (warped[0] < 1e-5) & (warped[1] < 1e-5)
    else:
        empty = (warped[0] == 0.0) & (warped[1] == 0.0)
    return (~empty)[None].to(warped.dtype)
