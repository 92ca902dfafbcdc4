"""The benchmark's plain reference held to the program at toy sizes on
the CPU: projection and SH, binning, compositing forward and backward,
the loss, the lens net's inverse, flow and warp, and their gradients.
The reference and the yardstick import nothing of the program."""

import ast
import os

import numpy as np
import pytest
import torch

import toy  # noqa: F401  (puts the harness and the repository on sys.path)
from reference import lens as ref_lens
from reference import loss as ref_loss
from reference import render as ref_render

from bags_tpu_torch.core.camera import CameraParams, CameraStatic
from bags_tpu_torch.raster import binning, tiles
from bags_tpu_torch.raster.render import RenderConfig, build_packet_table, render
from bags_tpu_torch.utils.testing import make_lookat_cameras, make_toy_scene

W, H = 64, 48


@pytest.fixture(scope="module")
def scene():
    sc = make_toy_scene(n=700, width=W, height=H, sh_degree=3, seed=0, device="cpu")
    cam = make_lookat_cameras(3, 0.8, 0.8, spread=0.15, device="cpu")[1]
    cam = CameraParams(q_init=cam.q_init, t_init=cam.t_init,
                       dq=torch.tensor([0.0, 0.01, -0.02, 0.005]),
                       dt=torch.tensor([0.03, -0.02, 0.01]), fovx=cam.fovx, fovy=cam.fovy)
    return sc, cam


def _port(sc, cam, **leaves):
    p = dict(xyz=sc["xyz"], scales=sc["scales"], quats=sc["quats"],
             opacity=sc["opacity"], sh=sc["sh_coeffs"])
    p.update(leaves)
    return render(p["xyz"], p["scales"], p["quats"], p["opacity"], p["sh"], cam,
                  CameraStatic(W, H), RenderConfig(sh_degree=3)).render


def _ref(sc, cam, **leaves):
    p = dict(xyz=sc["xyz"], scales=sc["scales"], quats=sc["quats"],
             opacity=sc["opacity"], sh=sc["sh_coeffs"])
    p.update(leaves)
    R, t = ref_render.camera_pose(cam.q_init, cam.t_init, cam.dq, cam.dt)
    return ref_render.render(p["xyz"], p["scales"], p["quats"], p["opacity"], p["sh"],
                             R, t, cam.fovx, cam.fovy, W, H)


def test_render_matches_program(scene):
    sc, cam = scene
    with torch.no_grad():
        a, b = _port(sc, cam), _ref(sc, cam)
    assert float((a - b).abs().max()) < 1e-5
    assert float(a.abs().max()) > 0.1


def test_binning_matches_program(scene):
    from bags_tpu_torch.core.projection import project_gaussians

    sc, cam = scene
    with torch.no_grad():
        proj = project_gaussians(sc["xyz"], sc["scales"], sc["quats"], sc["opacity"],
                                 sc["sh_coeffs"], cam, CameraStatic(W, H), 3)
        bins = binning.bin_gaussians(proj, *tiles.tile_grid(W, H))
        R, t = ref_render.camera_pose(cam.q_init, cam.t_init, cam.dq, cam.dt)
        rp = ref_render.project(sc["xyz"], sc["scales"], sc["quats"], sc["opacity"],
                                sc["sh_coeffs"], R, t, cam.fovx, cam.fovy, W, H)
        gid, start, count = ref_render.bin_tiles(rp, W, H)
    assert torch.equal(count.int(), bins.tile_count)
    assert torch.equal(gid, bins.gauss_id)
    assert torch.equal(rp["radius"].int(), proj.radius)


def test_composite_backward_matches_program(scene):
    from bags_tpu_torch.core.projection import project_gaussians

    sc, cam = scene
    tx, ty = tiles.tile_grid(W, H)
    with torch.no_grad():
        proj = project_gaussians(sc["xyz"], sc["scales"], sc["quats"], sc["opacity"],
                                 sc["sh_coeffs"], cam, CameraStatic(W, H), 3)
        bins = binning.bin_gaussians(proj, tx, ty)
        rows = build_packet_table(proj, proj.x2d, proj.y2d)[:, bins.gauss_id]
    g = torch.Generator().manual_seed(3)
    g_col = torch.randn((tx * ty, 4, tiles.NPIX), generator=g)
    g_t = torch.randn((tx * ty, tiles.NPIX), generator=g)
    col_p, t_p = tiles.composite_tiles_plain(rows, bins.tile_start, bins.tile_count, tx, ty)
    d_p = tiles.composite_bwd_plain(rows, bins.tile_start, bins.tile_count, tx, ty,
                                    g_col, g_t, col_p, t_p)
    start, count = bins.tile_start.long(), bins.tile_count.long()
    col_r, t_r = ref_render.composite_forward(rows, start, count, tx, ty)
    assert torch.allclose(col_r, col_p.transpose(1, 2), atol=1e-6)
    assert torch.allclose(t_r, t_p, atol=1e-6)
    d_r = ref_render.composite_backward(rows, start, count, tx, ty,
                                        g_col.transpose(1, 2), g_t, col_r, t_r)
    assert torch.allclose(d_r, d_p, rtol=1e-4, atol=1e-6)


def test_render_gradients_match_program(scene):
    sc, cam0 = scene
    w = torch.randn((3, H, W), generator=torch.Generator().manual_seed(1))
    grads = []
    for fn in (_port, _ref):
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in
                  dict(xyz=sc["xyz"], scales=sc["scales"], quats=sc["quats"],
                       opacity=sc["opacity"], sh=sc["sh_coeffs"]).items()}
        cam = CameraParams(q_init=cam0.q_init, t_init=cam0.t_init,
                           **{k: getattr(cam0, k).clone().requires_grad_(True)
                              for k in ("dq", "dt", "fovx", "fovy")})
        (fn(sc, cam, **leaves) * w).sum().backward()
        grads.append([t.grad for t in leaves.values()]
                     + [getattr(cam, k).grad for k in ("dq", "dt", "fovx", "fovy")])
    for a, b in zip(*grads):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-3 * scale + 1e-7


def test_loss_matches_program():
    from bags_tpu_torch.train.losses import photometric_loss

    g = torch.Generator().manual_seed(2)
    a, b = torch.rand((3, H, W), generator=g), torch.rand((3, H, W), generator=g)
    assert abs(float(ref_loss.photometric(a, b, 0.2))
               - float(photometric_loss(a, b, 0.2))) < 1e-6


def test_lens_matches_program():
    from bags_tpu_torch.calib import distortion
    from bags_tpu_torch.calib.iresnet import init_iresnet_params
    from bags_tpu_torch.train.calibrated import (fisheye_control_points,
                                                 make_fisheye_setup)

    fx = fy = W / (2 * np.tan(0.4))
    setup = make_fisheye_setup(fx, fy, (W, H), (W, H), flow_scale=(2.0, 2.0),
                               control_point_sample_scale=16)
    p_port = fisheye_control_points(setup, fx, fy, (2.0, 2.0))
    grid = (max(H // 16, 2), max(W // 16, 2))
    p_ref = ref_lens.control_points(fx, fy, W, H, (2.0, 2.0), grid)
    assert torch.allclose(p_port, p_ref, atol=1e-6)
    port = init_iresnet_params(seed=7)
    ws, bs, us = ref_lens.init_lens(7)
    for a, b in zip(port.parameters(), [w for blk in ws for w in blk]
                    + [b for blk in bs for b in blk]):
        assert torch.equal(a.detach(), b)
    for w in [w for blk in ws for w in blk] + [b for blk in bs for b in blk]:
        w.requires_grad_(True)
    scale = torch.tensor([1.2, 1.5], requires_grad=True)
    img = torch.rand((3, H, W), generator=torch.Generator().manual_seed(4))
    flow_p = distortion.compute_flow(port, p_port, setup.grid_hw, scale, setup.flow_hw,
                                     sensor_to_frustum=False)
    warped_p, mask_p, _ = distortion.apply_distortion(
        port, p_port, setup.grid_hw, img, None, setup.flow_hw, final_hw=setup.fish_hw,
        flow=flow_p)
    flow_r = ref_lens.upsample(ref_lens.inverse(ws, bs, us, p_ref), grid, scale,
                               setup.flow_hw)
    warped_r, mask_r = ref_lens.warp(img, flow_r, setup.fish_hw)
    assert torch.allclose(flow_p, flow_r, atol=1e-5)
    assert torch.allclose(warped_p, warped_r, atol=1e-5)
    assert torch.equal(mask_p, mask_r)
    wgt = torch.randn(warped_p.shape, generator=torch.Generator().manual_seed(5))
    gp = torch.autograd.grad((warped_p * wgt).sum(), port.parameters())
    gr = torch.autograd.grad((warped_r * wgt).sum(),
                             [w for blk in ws for w in blk] + [b for blk in bs for b in blk])
    for a, b in zip(gp, gr):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max()) + 1e-8


def test_known_lens_flow_matches_program():
    from bags_tpu_torch.calib.distortion import analytic_inverse_flow

    fx = W / (2 * np.tan(0.4))
    grid = (3, 4)
    p = ref_lens.control_points(fx, fx, W, H, (2.0, 2.0), grid)
    coeff = (-0.12, 0.02, 0.0, 0.0)
    a = analytic_inverse_flow(coeff, p, grid, [1.1, 1.3], (2 * H, 2 * W))
    b = ref_lens.known_lens_flow(coeff, p, grid, [1.1, 1.3], (2 * H, 2 * W))
    assert torch.allclose(a, b, atol=1e-6)


@pytest.mark.parametrize("path", ["reference/render.py", "reference/loss.py",
                                  "reference/lens.py", "reference/train.py",
                                  "counts.py"])
def test_yardstick_imports_nothing_of_the_program(path):
    tree = ast.parse(open(os.path.join(toy.BENCH, path)).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    assert not names & {"bags_tpu", "bags_tpu_torch", "jax", "jaxlib", "flax", "harness"}
