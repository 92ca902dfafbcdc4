"""Port parity, core: lie, sh, camera and projection of `bags_tpu_torch`
against `bags_tpu` on the same numpy inputs (CPU), plus the port's
isolation from JAX."""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bags_tpu.core import camera as jcam
from bags_tpu.core import lie as jlie
from bags_tpu.core import projection as jproj
from bags_tpu.core import sh as jsh
from bags_tpu.utils.testing import make_toy_scene as jmake
from bags_tpu_torch import convert
from bags_tpu_torch.core import camera as tcam
from bags_tpu_torch.core import lie as tlie
from bags_tpu_torch.core import projection as tproj
from bags_tpu_torch.core import sh as tsh
from bags_tpu_torch.utils.testing import make_toy_scene as tmake
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax\b|bags_tpu(?!_torch)\b)", re.MULTILINE)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(_np(b), _np(a), atol=atol, rtol=rtol)


def _quats(rng, n, normalize=True):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True) if normalize else q


def _rotmats(rng, n):
    return np.asarray(jlie.quat_to_rotmat(jnp.asarray(_quats(rng, n))))


# (name, inputs from rng, function name) — the cases of tests/test_lie.py
LIE_CASES = {
    "quat_to_rotmat": lambda r: (_quats(r, 32),),
    "quat_to_rotmat_unnormalized": lambda r: (_quats(r, 16, False),),
    "rotmat_to_quat": lambda r: (_rotmats(r, 32),),
    "quat_multiply": lambda r: (_quats(r, 8), _quats(r, 8)),
    "quat_conjugate": lambda r: (_quats(r, 8),),
    "quat_normalize": lambda r: (_quats(r, 8, False),),
    "quat_rotate": lambda r: (_quats(r, 8), r.normal(size=(8, 3)).astype(np.float32)),
    "so3_exp": lambda r: (r.normal(size=(16, 3)).astype(np.float32) * 0.8,),
    "so3_exp_small": lambda r: (np.array([[1e-9, 0, 0], [0, 0, 0]], np.float32),),
    "so3_log": lambda r: (np.asarray(jlie.so3_exp(jnp.asarray(
        r.normal(size=(16, 3)).astype(np.float32) * 0.8))),),
    "se3_exp": lambda r: (np.array([[0.3, -0.2, 0.1, 1.0, 2.0, -0.5]], np.float32),),
    "skew": lambda r: (r.normal(size=(4, 3)).astype(np.float32),),
    "rotation_distance": lambda r: (_rotmats(r, 8), _rotmats(r, 8)),
}


@pytest.mark.parametrize("case", sorted(LIE_CASES))
def test_lie_matches_jax(case):
    args = LIE_CASES[case](np.random.default_rng(0))
    fn = case.replace("_unnormalized", "").replace("_small", "")
    want = getattr(jlie, fn)(*[jnp.asarray(a) for a in args])
    got = getattr(tlie, fn)(*[torch.tensor(a) for a in args])
    _close(want, got)


def test_so3_exp_small_angle_grad_finite():
    w = torch.zeros(3, requires_grad=True)
    tlie.so3_exp(w).sum().backward()
    assert torch.isfinite(w.grad).all()


@pytest.mark.parametrize("degree", range(5))
def test_sh_matches_jax(degree):
    rng = np.random.default_rng(degree)
    coeffs = rng.normal(size=(10, 3, 25)).astype(np.float32)
    dirs = rng.normal(size=(10, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    _close(jsh.sh_basis(degree, jnp.asarray(dirs)),
           tsh.sh_basis(degree, torch.as_tensor(dirs)))
    _close(jsh.sh_to_rgb(degree, jnp.asarray(coeffs), jnp.asarray(dirs)),
           tsh.sh_to_rgb(degree, torch.as_tensor(coeffs), torch.as_tensor(dirs)),
           atol=1e-5)
    rgb = rng.uniform(size=(5, 3)).astype(np.float32)
    _close(jsh.sh_dc_to_rgb(jsh.rgb_to_sh_dc(jnp.asarray(rgb))),
           tsh.sh_dc_to_rgb(tsh.rgb_to_sh_dc(torch.as_tensor(rgb))))


def _cam_pair(rng, rotate=True):
    """The same perturbed camera in both packages: rotated base pose, non-zero
    dq/dt, fovx != fovy."""
    R = np.asarray(jlie.so3_exp(jnp.asarray(
        rng.normal(size=3).astype(np.float32) * (0.15 if rotate else 0.0))))
    t = rng.normal(size=3).astype(np.float32) * 0.2
    jc = jcam.CameraParams.create(R, t, 0.8, 0.7)
    jc = dataclasses.replace(
        jc, dq=jnp.asarray(rng.normal(size=4).astype(np.float32) * 0.02),
        dt=jnp.asarray(rng.normal(size=3).astype(np.float32) * 0.05))
    tc = convert.camera_from_numpy(
        {f.name: np.asarray(getattr(jc, f.name))
         for f in dataclasses.fields(jc)}, device="cpu")
    return jc, tc


def _align_pair(rng):
    q = _quats(rng, 1)[0] + np.array([3.0, 0, 0, 0], np.float32)
    q /= np.linalg.norm(q)
    ls = np.float32(0.1)
    return (jcam.GlobalAlignment(jnp.asarray(q), jnp.asarray(ls)),
            tcam.GlobalAlignment(torch.as_tensor(q), torch.as_tensor(ls)))


def test_camera_create_matches_jax():
    rng = np.random.default_rng(3)
    R = _rotmats(rng, 1)[0]
    t = rng.normal(size=3).astype(np.float32)
    jc = jcam.CameraParams.create(R, t, 0.8, 0.6)
    tc = tcam.CameraParams.create(R, t, 0.8, 0.6, device="cpu")
    for f in dataclasses.fields(jc):
        _close(getattr(jc, f.name), getattr(tc, f.name))


@pytest.mark.parametrize("with_align", [False, True])
def test_camera_matches_jax(with_align):
    rng = np.random.default_rng(4)
    jc, tc = _cam_pair(rng)
    ja, ta = _align_pair(rng) if with_align else (None, None)
    static = jcam.CameraStatic(width=64, height=48)
    tstatic = tcam.CameraStatic(width=64, height=48)
    for a, b in zip(jcam.pose_w2c(jc, ja), tcam.pose_w2c(tc, ta)):
        _close(a, b)
    _close(jcam.camera_center(jc, ja), tcam.camera_center(tc, ta))
    _close(jcam.projection_matrix(jc.fovx, jc.fovy),
           tcam.projection_matrix(tc.fovx, tc.fovy))
    # focals are ~40 px: compare to float32 rounding, relatively
    for a, b in zip(jcam.focals(jc, static), tcam.focals(tc, tstatic)):
        _close(a, b, atol=0.0, rtol=1e-6)


@pytest.fixture(scope="module")
def toy_pair():
    j = jmake(n=400, width=64, height=48, sh_degree=3, seed=7)
    t = tmake(n=400, width=64, height=48, sh_degree=3, seed=7, device="cpu")
    return j, t


def test_toy_scene_matches_jax(toy_pair):
    j, t = toy_pair
    for k in ("xyz", "scales", "quats", "opacity", "sh_coeffs"):
        np.testing.assert_array_equal(np.asarray(j[k]), t[k].numpy())


@pytest.mark.parametrize("with_align", [False, True])
def test_projection_matches_jax(toy_pair, with_align):
    j, t = toy_pair
    rng = np.random.default_rng(5)
    jc, tc = _cam_pair(rng)
    ja, ta = _align_pair(rng) if with_align else (None, None)
    pj = jax.jit(lambda *a: jproj.project_gaussians(
        *a, j["static"], 3, align=ja))(
        j["xyz"], j["scales"], j["quats"], j["opacity"], j["sh_coeffs"], jc)
    pt = tproj.project_gaussians(
        t["xyz"], t["scales"], t["quats"], t["opacity"], t["sh_coeffs"], tc,
        tcam.CameraStatic(64, 48), 3, align=ta)
    assert int((np.asarray(pj.radius) > 0).sum()) > 100
    for f in dataclasses.fields(pj):
        a, b = np.asarray(getattr(pj, f.name)), getattr(pt, f.name).numpy()
        if f.name in ("radius", "rect_rx", "rect_ry"):
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5,
                                       err_msg=f.name)


def test_distance_to_camera_matches_jax(toy_pair):
    j, t = toy_pair
    jc, tc = _cam_pair(np.random.default_rng(6))
    _close(jproj.distance_to_camera(j["xyz"], jc),
           tproj.distance_to_camera(t["xyz"], tc), atol=1e-5)


def test_port_is_isolated_from_jax():
    """Importing every module of the port and `chip_smoke.py` loads neither
    jax nor bags_tpu, and no source names them."""
    pkg = os.path.join(REPO, "bags_tpu_torch")
    mods = ["chip_smoke"]
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        assert not FORBIDDEN_IMPORT.search(f.read()), "chip_smoke.py"
    for root, _, files in os.walk(pkg):
        for fn in files:
            if fn.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, fn[:-3]), REPO)
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
                with open(os.path.join(root, fn)) as f:
                    src = f.read()
                assert not FORBIDDEN_IMPORT.search(src), fn
    assert len(mods) >= 20
    code = ("import importlib, sys\n"
            f"for m in {sorted(mods)!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'bags_tpu' or m.startswith('bags_tpu.')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """Without a card and without an explicit device, entry points raise."""
    from bags_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        tmake(n=10)
    assert resolve_device("cpu") == torch.device("cpu")
