"""The port's cubemap step (`train/calibrated.py::cubemap_train_step`)
against the benchmark's plain reference (`perfbench/reference/cubemap.py`,
which imports nothing of the port) on the CPU, at the toy size of
`utils/testing.cubemap_toy`: 48x40 faces of 700 SH-1 Gaussians, focal 24,
a 2-block cubemap net of width 32 trained at lr 1e-4, pose and FoVs
trained. Three steps on cameras 0, 1, 0 (camera 1 against camera 0's GT:
the comparison needs no true image): each step's loss, every leaf's first
gradient (the cubemap net's included) and every leaf after the three
steps. Besides: a face whose Gaussians overlap in depth order other than
their distance order renders as the reference's distance-keyed binning
has it and not as a depth sort would; a ray parallel to the side faces'
planes (x exactly 0) reads zero there in both, and the net's non-finite
gradient is dropped by both guards; and the comparison fails a step whose
left face is dropped from the loss.

Tolerances, all float32 rounding of one arithmetic computed twice: the
loss sums 5 x 3 x 48 x 40 terms in another order (each term rounds at
about 6e-8), so 1e-6 relative; a gradient passes back through the
compositing, the gather and the warps in another order of sums, so 1e-4
of the leaf's norm; a leaf's change after three Adam steps, whose
m / sqrt(v) magnifies an entry's relative rounding, 1e-3 of the change's
norm."""

import os
import sys

import numpy as np
import pytest
import torch

from bags_tpu_torch.calib import cubemap as cubemap_lib
from bags_tpu_torch.core.camera import CameraParams, CameraStatic
from bags_tpu_torch.raster.render import RenderConfig, render
from bags_tpu_torch.train import calibrated
from bags_tpu_torch.utils.testing import _narrow_net_np, cubemap_toy
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

sys.path.append(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "perfbench"))
from reference import cubemap as ref_cube  # noqa: E402
from reference import render as ref_render  # noqa: E402
from reference.train import Hyper  # noqa: E402

ORDER = (0, 1, 0)
LOSS_TOL, GRAD_TOL, CHANGE_TOL = 1e-6, 1e-4, 1e-3
CAMS = ("q_init", "t_init", "dq", "dt", "fovx", "fovy")


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _port_name(k: str) -> str:
    """A reference leaf's name in the port's gradients."""
    if k.startswith("cam."):
        return ".cam." + k[4:]
    if k.startswith(ref_cube.NET_PREFIX + "."):
        field = {"w": "weights", "b": "biases"}[k[len(ref_cube.NET_PREFIX) + 1]]
        return ".cubemap_net." + field + k[k.index("["):]
    return ".g." + k


def _hyper(cfg) -> Hyper:
    o, c = cfg.opt, cfg.calib
    return Hyper(lambda_dssim=o.lambda_dssim,
                 xyz_lr=(o.position_lr_init * 2.0, o.position_lr_final * 2.0,
                         o.position_lr_max_steps),
                 feature_lr=o.feature_lr, opacity_lr=o.opacity_lr,
                 scaling_lr=o.scaling_lr, rotation_lr=o.rotation_lr,
                 rot_lr=c.r_t_lr[0], trans_lr=c.r_t_lr[1], fov_lr=c.fov_lr,
                 pose_milestones=c.pose_lr_milestones, pose_gamma=c.pose_lr_gamma,
                 sh_degree=1, lens_lr=c.iresnet_lr, lens_milestones=(2000, 7000, 9000),
                 opt_lens=True)


def _geometry(toy) -> ref_cube.CubemapGeometry:
    net = _narrow_net_np()
    s = toy["setup"]
    return ref_cube.CubemapGeometry(
        width=s.static.width, height=s.static.height, focal=float(s.K[0, 0]),
        mask_radius=toy["cfg"].calib.mask_radius, sample_scale=s.scale,
        net=(net["weights"], net["biases"], net["u_vecs"]))


def _port_steps(toy):
    """Three port steps; (losses, first gradients, leaves after)."""
    st, cfg, gt = toy["state"], toy["cfg"], toy["gt"]
    losses, first = [], None
    for ci in ORDER:
        m = calibrated.cubemap_train_step(
            st, gt, ci, torch.zeros(3), toy["sub_q"][ci], toy["sub_t"][ci],
            toy["setup"], RenderConfig(sh_degree=1), cfg, toy["schedules"])
        losses.append(float(m.loss))
        if first is None:
            first = {k: v.clone() for k, v in m.grads.items() if v is not None}
    b = st.base
    after = {".g." + k: t.detach().clone() for k, t in b.g.fields().items()}
    after.update({".cam." + f: getattr(b.cams, f).clone() for f in CAMS[2:]})
    after.update({".cubemap_net" + k: t.detach().clone() for k, t in
                  st.cubemap_net.named_tensors(trained_only=True).items()})
    return losses, first, after


@pytest.fixture(scope="module")
def steps():
    toy = cubemap_toy("cpu")
    b = toy["state"].base
    init = {k: t.detach().clone() for k, t in b.g.fields().items()}
    cams = {f: getattr(b.cams, f).detach().clone() for f in CAMS}
    gts = torch.stack([toy["gt"], toy["gt"]])
    ref = ref_cube.train_steps(init, cams, gts, list(ORDER), _hyper(toy["cfg"]),
                               torch.zeros(3), _geometry(toy))
    init.update({"cam." + f: cams[f] for f in CAMS[2:]})
    init.update(ref_cube.net_leaves(ref_cube.initial_net(_geometry(toy), "cpu")))
    return dict(port=_port_steps(toy), ref=ref, init=init)


def test_losses_match(steps):
    losses, _, _ = steps["port"]
    for p, r in zip(losses, steps["ref"]["losses"]):
        assert abs(p - r) <= LOSS_TOL * abs(r), (losses, steps["ref"]["losses"])


def test_first_gradients_match(steps):
    _, grads, _ = steps["port"]
    ref = steps["ref"]["grads"]
    assert len(ref) == 6 + 4 + 2 * 2 * 3          # Gaussians, camera row, net
    for k, r in ref.items():
        p = grads[_port_name(k)]
        if k.startswith("cam."):                   # the port's is the row's
            r = r[ORDER[0]]
        assert float(r.norm()) > 0, k
        assert _rel(p, r) <= GRAD_TOL, (k, _rel(p, r))


def test_leaves_after_three_steps_match(steps):
    _, _, after = steps["port"]
    init = steps["init"]
    for k, r in steps["ref"]["after"].items():
        d_r = r - init[k]
        assert float(d_r.norm()) > 0, k
        assert _rel(after[_port_name(k)] - init[k], d_r) <= CHANGE_TOL, k


def test_distance_order_not_depth_order():
    """Two wide Gaussians off the axis of a 126-degree face: A (1.5, 0, 1)
    is the nearer in depth (1 < 1.3), B (0.9, 0, 1.3) in distance (1.58 <
    1.80), and their footprints overlap. The port's distance-sorted render
    is the reference's; sorted by depth it is not."""
    w, h, focal = 48, 40, 12.0
    xyz = torch.tensor([[1.5, 0.0, 1.0], [0.9, 0.0, 1.3]])
    scales = torch.full((2, 3), 0.3)
    quats = torch.tensor([[1.0, 0, 0, 0], [1.0, 0, 0, 0]])
    opac = torch.tensor([0.9, 0.9])
    sh = torch.zeros((2, 4, 3))
    sh[0, 0], sh[1, 0] = torch.tensor([2.0, -2.0, -2.0]), torch.tensor([-2.0, -2.0, 2.0])
    fovx, fovy = 2 * np.arctan(w / (2 * focal)), 2 * np.arctan(h / (2 * focal))
    cam = CameraParams.create(np.eye(3), np.zeros(3), fovx, fovy, device="cpu")
    ref = ref_cube.render_face(xyz, scales, quats, opac, sh, torch.eye(3), torch.zeros(3),
                               cam.fovx, cam.fovy, w, h, torch.zeros(3), 1)

    def port(by_distance):
        return render(xyz, scales, quats, opac, sh, cam, CameraStatic(w, h),
                      RenderConfig(sh_degree=1, sort_by_distance=by_distance)).render

    assert (port(True) - ref).abs().max() <= 1e-6
    assert (port(False) - ref).abs().max() > 0.1


def _zero_x(real, pixel):
    """`real`'s rays with the ray of `pixel` at x = 0 exactly, its gradient
    still passed to the ray field."""
    def rays(*a, **k):
        r = real(*a, **k)
        hit = torch.zeros_like(r[:, :1])
        hit[pixel] = 1.0
        return torch.cat([r[:, :1] - hit * r[:, :1].detach(), r[:, 1:]], dim=1)
    return rays


def test_ray_parallel_to_side_faces(monkeypatch):
    """A ray of the disc at x = 0 exactly (the net's residual puts one
    there every few hundred steps at a 190-degree field): the left and
    right faces read zero there, so the loss and the Gaussians' gradients
    stay finite and the reference's; the net's gradient is not finite (the
    division's derivative) and both guards drop it."""
    pixel = 20 * 48 + 30
    monkeypatch.setattr(cubemap_lib, "distorted_rays",
                        _zero_x(cubemap_lib.distorted_rays, pixel))
    monkeypatch.setattr(ref_cube, "ray_field", _zero_x(ref_cube.ray_field, pixel))
    toy = cubemap_toy("cpu")
    b = toy["state"].base
    init = {k: t.detach().clone() for k, t in b.g.fields().items()}
    cams = {f: getattr(b.cams, f).detach().clone() for f in CAMS}
    ref = ref_cube.train_steps(init, cams, toy["gt"][None], [0], _hyper(toy["cfg"]),
                               torch.zeros(3), _geometry(toy))
    m = calibrated.cubemap_train_step(
        toy["state"], toy["gt"], 0, torch.zeros(3), toy["sub_q"][0], toy["sub_t"][0],
        toy["setup"], RenderConfig(sh_degree=1), toy["cfg"], toy["schedules"])
    assert abs(float(m.loss) - ref["losses"][0]) <= LOSS_TOL * ref["losses"][0]
    for k in ("xyz", "sh_dc", "opacity_raw"):
        assert torch.isfinite(m.grads[".g." + k]).all()
        assert _rel(m.grads[".g." + k], ref["grads"][k]) <= GRAD_TOL, k
    assert not torch.isfinite(m.grads[".cubemap_net.weights[0][0]"]).all()
    for k, mu in toy["state"].cubemap_opt.mu.items():
        assert not mu.any(), k
    assert not any(v.any() for k, v in ref["grads"].items()
                   if k.startswith(ref_cube.NET_PREFIX))


def test_dropped_side_face_fails_the_comparison(steps, monkeypatch):
    """The port with its left face's warped image zeroed, as a step whose
    loss lost that face: its first loss leaves the reference's by far more
    than the tolerance."""
    real = cubemap_lib.render_cubemap_faces

    def dropped(*a, **k):
        faces, n = real(*a, **k)
        i = cubemap_lib.FACES.index("left")
        return faces[:i] + [torch.zeros_like(faces[i])] + faces[i + 1:], n

    monkeypatch.setattr(cubemap_lib, "render_cubemap_faces", dropped)
    toy = cubemap_toy("cpu")
    m = calibrated.cubemap_train_step(
        toy["state"], toy["gt"], 0, torch.zeros(3), toy["sub_q"][0], toy["sub_t"][0],
        toy["setup"], RenderConfig(sh_degree=1), toy["cfg"], toy["schedules"])
    r = steps["ref"]["losses"][0]
    assert abs(float(m.loss) - r) > 100 * LOSS_TOL * abs(r)


def test_reference_imports_nothing_of_the_port():
    src = open(ref_cube.__file__).read()
    for name in ("bags_tpu", "jax", "harness"):
        assert f"import {name}" not in src and f"from {name}" not in src
    assert ref_render.__file__.startswith(os.path.dirname(ref_cube.__file__))
