"""The projection's hand-derived backward (`project_backward_plain`, the
arithmetic of `csrc/projection.cu`'s backward kernel) against autograd of
the plain forward (`project_plain`), in float64 on the CPU: SH degrees 0-4,
with and without the global alignment, the pupil shift and extra colour,
on scenes with dead, culled, behind-camera and near-plane slots, a slot at
the camera centre and two on the x/z clamp's bounds; every camera-vector
gradient, and through `camera_vector` the gradients of the pose, the FoVs,
the alignment and the shift."""

import dataclasses

import numpy as np
import pytest
import torch

from bags_tpu_torch.core import projection as proj_lib
from bags_tpu_torch.core.camera import (CameraParams, CameraStatic, GlobalAlignment,
                                        focals, projection_matrix)
from bags_tpu_torch.utils.testing import make_toy_scene, projection_scene

STATIC = CameraStatic(width=64, height=48)
ARGS = ("xyz", "scales", "quats", "opacity", "sh_coeffs")


def _scene(seed, dtype=torch.float64, n=600):
    """`projection_scene` in float64 at K = 25 coefficients a row (lower
    degrees leave some inactive), half the slots dead, with its special
    slots 0-15 (behind the camera, inside the depth clamp, outside the
    frustum, at the camera centre) and unnormalised quaternions."""
    sc = projection_scene(n, 25, seed, STATIC.width, STATIC.height,
                          live_every=2, device="cpu")
    return {k: sc[k].to(dtype) for k in ARGS}


def _camera(dtype, seed, move=True):
    rng = np.random.default_rng(seed)
    cam = CameraParams.create(np.eye(3), np.zeros(3), 0.8, 0.7, device="cpu")
    cam = CameraParams(**{f.name: getattr(cam, f.name).to(dtype)
                          for f in dataclasses.fields(cam)})
    if move:
        cam.dq = torch.as_tensor(rng.normal(0, 0.03, 4), dtype=dtype)
        cam.dt = torch.as_tensor(rng.normal(0, 0.1, 3), dtype=dtype)
    return cam


def _align(dtype, seed):
    rng = np.random.default_rng(seed)
    q = np.array([1.0, *rng.normal(0, 0.05, 3)])
    return GlobalAlignment(quaternion=torch.as_tensor(q / np.linalg.norm(q), dtype=dtype),
                           log_scale=torch.as_tensor(0.1, dtype=dtype))


def _cotangents(n, seed, dtype, drop=()):
    gen = torch.Generator().manual_seed(seed)
    return [None if f in drop else torch.randn(n, generator=gen, dtype=dtype)
            for f in proj_lib.FLOAT_FIELDS]


def _autograd(t, camvec, deg, has_shift, grads):
    """Autograd of sum(g * out) through project_plain with the camera
    vector a leaf: the gradients of the 5 inputs and of the camera vector."""
    leaves = [t[k].detach().requires_grad_(True) for k in ARGS]
    cv = camvec.detach().requires_grad_(True)
    p = proj_lib.project_plain(*leaves, cv, STATIC, deg, has_shift)
    loss = sum((getattr(p, f) * g).sum()
               for f, g in zip(proj_lib.FLOAT_FIELDS, grads) if g is not None)
    got = torch.autograd.grad(loss, leaves + [cv], allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(leaves + [cv], got)]


def _assert_grads(got, want, names):
    for name, a, b in zip(names, got, want):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-11 * max(scale, 1.0),
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("variant", ["plain", "align_shift"])
def test_backward_plain_matches_autograd(deg, variant):
    dtype = torch.float64
    t = _scene(seed=deg)
    cam = _camera(dtype, seed=10 + deg)
    align = _align(dtype, 20 + deg) if variant == "align_shift" else None
    shift = (torch.tensor([0.03, -0.02, 0.05], dtype=dtype)
             if variant == "align_shift" else None)
    camvec = proj_lib.camera_vector(cam, STATIC, align, shift)
    n = t["xyz"].shape[0]
    drop = ("depth", "opacity") if deg % 2 else ()
    grads = _cotangents(n, seed=deg, dtype=dtype, drop=drop)
    got = proj_lib.project_backward_plain(*[t[k] for k in ARGS], camvec, STATIC,
                                          deg, shift is not None, grads)
    want = _autograd(t, camvec, deg, shift is not None, grads)
    _assert_grads(got, want, ARGS + ("camera vector",))
    # coefficients above the active degree get exactly zero
    k = (deg + 1) ** 2
    assert bool((got[4][:, k:] == 0).all())
    # the special slots take part: culled and dead ones have gradients too
    assert float(got[0][:16].abs().sum()) > 0
    # every camera-vector entry is exercised: the shift's with one, the
    # centre's where the colour depends on the view direction
    used = torch.ones(proj_lib.CAM_SIZE, dtype=torch.bool)
    used[proj_lib.CAM_SHIFT:] = shift is not None
    used[proj_lib.CAM_CENTER:proj_lib.CAM_CENTER + 3] = deg > 0
    assert torch.equal(got[5] != 0, used)


def test_backward_plain_at_clamp_tie():
    """A slot exactly on the x/z clamp's bound: minimum's tie halves the
    gradient between the slot and limx, as autograd does."""
    dtype = torch.float64
    t = _scene(seed=7)
    cam = _camera(dtype, seed=7, move=False)
    camvec = proj_lib.camera_vector(cam, STATIC)
    limx = camvec[proj_lib.CAM_LIMX]
    t["xyz"][50] = torch.stack([limx, torch.tensor(0.3, dtype=dtype),
                                torch.tensor(1.0, dtype=dtype)])
    t["xyz"][51] = torch.stack([-limx * 2.0, torch.tensor(0.1, dtype=dtype),
                                torch.tensor(2.0, dtype=dtype)])
    f = proj_lib._forward_terms(*[t[k] for k in ARGS], camvec, STATIC, 3, False)
    assert float(f["vx"][50]) == float(limx) and float(f["vx"][51]) == -float(limx)
    grads = _cotangents(t["xyz"].shape[0], seed=3, dtype=dtype)
    got = proj_lib.project_backward_plain(*[t[k] for k in ARGS], camvec, STATIC,
                                          3, False, grads)
    want = _autograd(t, camvec, 3, False, grads)
    _assert_grads(got, want, ARGS + ("camera vector",))


@pytest.mark.parametrize("variant", ["plain", "align_shift_extra"])
def test_camera_gradients_through_camera_vector(variant):
    """The camera vector's gradient from the hand backward, carried through
    `camera_vector` by autograd, gives autograd's gradients of dq, dt, fovx,
    fovy, the alignment and the shift through `project_gaussians`; extra
    colour is added after the colour's clamp and takes its gradient."""
    dtype = torch.float64
    full = variant != "plain"
    t = _scene(seed=11)
    n = t["xyz"].shape[0]
    cam = _camera(dtype, seed=12)
    leaves = {"dq": cam.dq, "dt": cam.dt, "fovx": cam.fovx, "fovy": cam.fovy}
    align = shift = extra = None
    if full:
        align = _align(dtype, 13)
        shift = torch.tensor([0.02, 0.01, -0.04], dtype=dtype)
        extra = torch.randn((n, 3), generator=torch.Generator().manual_seed(4),
                            dtype=dtype)
        leaves.update(align_q=align.quaternion, align_s=align.log_scale,
                      shift=shift, extra=extra)
    leaves = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
    cam = dataclasses.replace(cam, dq=leaves["dq"], dt=leaves["dt"],
                              fovx=leaves["fovx"], fovy=leaves["fovy"])
    if full:
        align = GlobalAlignment(leaves["align_q"], leaves["align_s"])
        shift, extra = leaves["shift"], leaves["extra"]
    grads = _cotangents(n, seed=5, dtype=dtype)
    p = proj_lib.project_gaussians(*[t[k] for k in ARGS], cam, STATIC, 3,
                                   align=align, extra_color=extra,
                                   shift_factors=shift)
    loss = sum((getattr(p, f) * g).sum()
               for f, g in zip(proj_lib.FLOAT_FIELDS, grads))
    want = torch.autograd.grad(loss, list(leaves.values()))

    camvec = proj_lib.camera_vector(cam, STATIC, align, shift)
    d_cam = proj_lib.project_backward_plain(
        *[t[k] for k in ARGS], camvec.detach(), STATIC, 3, shift is not None,
        grads)[5]
    cam_leaves = [v for k, v in leaves.items() if k != "extra"]
    got = list(torch.autograd.grad(camvec, cam_leaves, d_cam))
    if full:
        got.append(torch.stack(grads[6:9], dim=-1))   # extra colour's
    _assert_grads(got, want, list(leaves))


def test_camera_vector_holds_the_reference_values():
    """Each entry as the reference computes it, bit for bit in float32:
    the pose, P[0,0] and P[1,1], the focals, the clamps, the centre."""
    sc = make_toy_scene(n=10, device="cpu")
    cam = dataclasses.replace(sc["cam"], dq=torch.tensor([0.01, 0.02, -0.01, 0.03]),
                              dt=torch.tensor([0.1, -0.2, 0.05]))
    align = _align(torch.float32, 1)
    shift = torch.tensor([0.01, 0.02, 0.03])
    cv = proj_lib.camera_vector(cam, STATIC, align, shift)
    from bags_tpu_torch.core.camera import camera_center, pose_w2c

    R, t = pose_w2c(cam, align)
    P = projection_matrix(cam.fovx, cam.fovy, STATIC.znear, STATIC.zfar)
    fx, fy = focals(cam, STATIC)
    want = torch.cat([R.reshape(9), t, torch.stack([
        P[0, 0], P[1, 1], fx, fy, 1.3 * torch.tan(cam.fovx * 0.5),
        1.3 * torch.tan(cam.fovy * 0.5)]), camera_center(cam, align), shift])
    assert torch.equal(cv, want)
    assert torch.equal(proj_lib.camera_vector(cam, STATIC)[proj_lib.CAM_SHIFT:],
                       torch.zeros(3))


def test_kernel_wrapper_refuses_bad_inputs():
    """The kernels' input checks, which run before any launch: shapes, the
    SH degree and K, float32, one device, contiguity and the quaternions'
    16-byte rows."""
    sc = make_toy_scene(n=64, sh_degree=3, device="cpu")
    t = {k: sc[k] for k in ARGS}
    cv = proj_lib.camera_vector(sc["cam"], sc["static"])
    check = proj_lib._check_kernel_inputs
    check(*[t[k] for k in ARGS], cv, 3)
    bad = [
        (dict(xyz=t["xyz"][:, :2]), 3, "xyz must be"),
        (dict(), 5, "SH degree"),
        (dict(sh_coeffs=t["sh_coeffs"][:, :4]), 3, "sh_coeffs must be"),
        (dict(opacity=t["opacity"].double()), 3, "float32"),
        (dict(scales=t["scales"].t().contiguous().t()), 3, "contiguous"),
        (dict(sh_coeffs=t["sh_coeffs"].to("meta")), 3, "on meta"),
        (dict(quats=torch.empty(64 * 4 + 1)[1:].view(64, 4)), 3, "16-byte"),
    ]
    for change, deg, match in bad:
        args = {**t, **change}
        with pytest.raises(ValueError, match=match):
            check(*[args[k] for k in ARGS], cv, deg)
