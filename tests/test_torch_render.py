"""Port parity, the slice as a whole: `render()` of `bags_tpu_torch` against
`bags_tpu` (jnp backend, the Pallas kernel in interpret mode, and the naive
reference), autograd through the plain compositor on the CPU, PLY and
pytree carry-over, and the dataset Scene."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bags_tpu.core import lie as jlie
from bags_tpu.core.camera import CameraParams as JCam
from bags_tpu.core.camera import GlobalAlignment as JAlign
from bags_tpu.data.scene import Scene as JScene
from bags_tpu.model import gaussians as jg
from bags_tpu.raster import RenderConfig as JCfg
from bags_tpu.raster import render as jrender
from bags_tpu.raster.reference import render_reference as j_reference
from bags_tpu.utils.testing import make_toy_scene as jmake
from bags_tpu_torch import convert
from bags_tpu_torch.core.camera import GlobalAlignment as TAlign
from bags_tpu_torch.data.scene import Scene as TScene
from bags_tpu_torch.model import gaussians as tg
from bags_tpu_torch.raster.render import RenderConfig as TCfg
from bags_tpu_torch.raster.render import render as trender
from bags_tpu_torch.utils.testing import make_toy_scene as _tmake
from test_data import _write_colmap_scene

ARGS = ("xyz", "scales", "quats", "opacity", "sh_coeffs")
FIELDS = ("render", "t_final", "depth_map", "radii", "mean2d")
BG = np.array([0.3, 0.6, 0.9], np.float32)
_jrender = jax.jit(jrender, static_argnames=("static", "cfg"))


def _pair(n, width, height, seed, sh_degree, rotate=True, align=False,
          scale_range=(0.02, 0.12)):
    """The same scene and perturbed camera in both packages."""
    kw = dict(n=n, width=width, height=height, seed=seed, sh_degree=sh_degree,
              scale_range=scale_range)
    j, t = jmake(**kw), _tmake(**kw, device="cpu")
    rng = np.random.default_rng(seed)
    if rotate:
        R = np.asarray(jlie.so3_exp(jnp.asarray(
            rng.normal(size=3).astype(np.float32) * 0.1)))
        jc = JCam.create(R, rng.normal(size=3).astype(np.float32) * 0.1, 0.8, 0.75)
        jc = dataclasses.replace(
            jc, dq=jnp.asarray(rng.normal(size=4).astype(np.float32) * 0.01),
            dt=jnp.asarray(rng.normal(size=3).astype(np.float32) * 0.02))
        j["cam"] = jc
        t["cam"] = convert.camera_from_numpy(
            {f.name: np.asarray(getattr(jc, f.name))
             for f in dataclasses.fields(jc)}, device="cpu")
    j["align"] = t["align"] = None
    if align:
        q = np.array([0.99, 0.05, -0.08, 0.03], np.float32)
        q /= np.linalg.norm(q)
        j["align"] = JAlign(jnp.asarray(q), jnp.asarray(np.float32(0.05)))
        t["align"] = TAlign(torch.as_tensor(q), torch.as_tensor(np.float32(0.05)))
    return j, t


def _render_both(j, t, jcfg, tcfg, bg=BG):
    oj = _jrender(*[j[k] for k in ARGS], j["cam"], static=j["static"], cfg=jcfg,
                  bg=jnp.asarray(bg), align=j["align"])
    ot = trender(*[t[k] for k in ARGS], t["cam"], t["static"], tcfg,
                 bg=torch.as_tensor(bg), align=t["align"])
    return oj, ot


def _assert_outputs(oj, ot, atol=2e-5, depth_rtol=0.0):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(ot, f).numpy(),
                                   np.asarray(getattr(oj, f)), atol=atol,
                                   rtol=depth_rtol if f == "depth_map" else 0.0,
                                   err_msg=f)
    np.testing.assert_array_equal(ot.visibility.numpy(), np.asarray(oj.visibility))


RENDER_CASES = {
    # name: (n, width, height, seed, sh_degree, align, budget)
    "sh3_rotated": (400, 64, 48, 3, 3, False, None),
    "sh3_aligned": (400, 64, 48, 3, 3, True, None),
    "sh0_nonmultiple_size": (300, 50, 35, 4, 0, False, None),
    "budget_drops": (400, 64, 48, 3, 3, False, 256),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_matches_jax_jnp(case):
    n, w, h, seed, deg, align, budget = RENDER_CASES[case]
    j, t = _pair(n, w, h, seed, deg, align=align)
    oj, ot = _render_both(
        j, t, JCfg(sh_degree=deg, backend="jnp",
                   max_instances=budget or 16384),
        TCfg(sh_degree=deg, max_instances=budget))
    _assert_outputs(oj, ot)
    assert ot.n_dropped == int(oj.n_dropped)
    assert (ot.n_dropped > 0) == (budget is not None)
    assert ot.gauss_id.shape[0] == int(np.sum(np.asarray(oj.gauss_id) < n))


def test_render_matches_jax_pallas():
    j, t = _pair(200, 48, 32, 11, 1)
    oj, ot = _render_both(j, t, JCfg(sh_degree=1, backend="pallas",
                                     max_instances=16384), TCfg(sh_degree=1))
    # The Pallas kernel's weights come from a log-space prefix scan (~2e-5
    # relative); the expected depth sums them times depths of 4-8 units, so
    # it is held relatively as well.
    _assert_outputs(oj, ot, depth_rtol=2e-5)


def test_render_matches_jax_reference():
    j, t = _pair(200, 48, 32, 12, 1, rotate=False)
    rj = jax.jit(j_reference, static_argnums=(6, 7))(
        *[j[k] for k in ARGS], j["cam"], j["static"], 1, bg=jnp.asarray(BG))
    ot = trender(*[t[k] for k in ARGS], t["cam"], t["static"], TCfg(sh_degree=1),
                 bg=torch.as_tensor(BG))
    np.testing.assert_allclose(ot.render.numpy(), np.asarray(rj["render"]), atol=2e-5)
    np.testing.assert_allclose(ot.t_final.numpy(), np.asarray(rj["T_final"]), atol=2e-5)


def test_render_grads_match_jax_on_cpu():
    """On the CPU autograd runs through the plain compositor: gradients to
    the Gaussians, the pose residuals and the screen-space probe match JAX
    (tolerances of tests/test_pallas_raster.py)."""
    j, t = _pair(120, 32, 32, 13, 0)
    target = np.full((3, 32, 32), 0.25, np.float32)
    jcfg = JCfg(sh_degree=0, backend="jnp", max_instances=8192)

    def jloss(xyz, opacity, dq, dt, probe):
        cam = dataclasses.replace(j["cam"], dq=dq, dt=dt)
        out = jrender(xyz, j["scales"], j["quats"], opacity, j["sh_coeffs"],
                      cam, j["static"], jcfg, probe2d=probe)
        return jnp.mean((out.render - target) ** 2)

    jargs = (j["xyz"], j["opacity"], j["cam"].dq, j["cam"].dt, jnp.zeros((120, 2)))
    gj = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(*jargs)

    leaves = [t["xyz"].clone(), t["opacity"].clone(), t["cam"].dq.clone(),
              t["cam"].dt.clone(), torch.zeros(120, 2)]
    for x in leaves:
        x.requires_grad_(True)
    cam = dataclasses.replace(t["cam"], dq=leaves[2], dt=leaves[3])
    out = trender(leaves[0], t["scales"], t["quats"], leaves[1], t["sh_coeffs"],
                  cam, t["static"], TCfg(sh_degree=0), probe2d=leaves[4])
    torch.mean((out.render - torch.as_tensor(target)) ** 2).backward()
    for name, a, b in zip(("xyz", "opacity", "dq", "dt", "probe2d"), gj, leaves):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a), atol=1e-5,
                                   rtol=1e-3, err_msg=name)
    assert float(leaves[4].grad.abs().sum()) > 0


@pytest.fixture(scope="module")
def jax_gaussians():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    g, alive = jg.create_from_points(pts, rng.random((300, 3)).astype(np.float32),
                                     512, sh_degree=2)
    g = dataclasses.replace(
        g, sh_rest=jnp.asarray(rng.normal(size=g.sh_rest.shape).astype(np.float32)),
        quats=jnp.asarray(rng.normal(size=g.quats.shape).astype(np.float32)))
    return g, alive


def test_ply_roundtrip_bit_exact_both_ways(tmp_path, jax_gaussians):
    g, alive = jax_gaussians
    n = int(np.asarray(alive).sum())
    names = [f.name for f in dataclasses.fields(g) if getattr(g, f.name) is not None]
    pj = str(tmp_path / "jax.ply")
    jg.save_ply(pj, g, alive)
    tg_, talive = tg.load_ply(pj, capacity=512, device="cpu")
    gj, jalive = jg.load_ply(pj, capacity=512)
    for name in names:       # every row, the padded dead ones included
        np.testing.assert_array_equal(getattr(tg_, name).numpy(),
                                      np.asarray(getattr(gj, name)), err_msg=name)
        np.testing.assert_array_equal(getattr(tg_, name).numpy()[:n],
                                      np.asarray(getattr(g, name))[:n], err_msg=name)
    np.testing.assert_array_equal(talive.numpy(), np.asarray(jalive))
    pt = str(tmp_path / "port.ply")
    tg.save_ply(pt, tg_, talive)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    g2, alive2 = jg.load_ply(pt, capacity=512)
    for name in names:
        np.testing.assert_array_equal(np.asarray(getattr(g2, name)),
                                      np.asarray(getattr(gj, name)), err_msg=name)
    np.testing.assert_array_equal(np.asarray(alive2), np.asarray(jalive))


def test_gaussians_from_numpy(jax_gaussians):
    g, alive = jax_gaussians
    d = {f.name: np.asarray(getattr(g, f.name)) for f in dataclasses.fields(g)
         if getattr(g, f.name) is not None}
    d["alive"] = np.asarray(alive)
    tgs, talive = convert.gaussians_from_numpy(d, device="cpu")
    np.testing.assert_array_equal(tgs.sh_coeffs().numpy(), np.asarray(g.sh_coeffs()))
    np.testing.assert_allclose(tgs.opacity(talive).numpy(),
                               np.asarray(g.opacity(alive)), atol=1e-7)
    np.testing.assert_allclose(tgs.scaling().numpy(), np.asarray(g.scaling()),
                               rtol=1e-6)
    assert tgs.max_sh_degree == g.max_sh_degree == 2
    with pytest.raises(KeyError, match="missing"):
        convert.gaussians_from_numpy({"xyz": d["xyz"], "alive": d["alive"]},
                                     device="cpu")
    with pytest.raises(KeyError, match="not ported"):   # --hybrid features
        convert.gaussians_from_numpy({**d, "asg": np.zeros((512, 24))},
                                     device="cpu")


def test_scene_matches_jax(tmp_path):
    root = str(tmp_path / "scene")
    os.makedirs(root)
    _write_colmap_scene(root, n_cams=8, rng=np.random.default_rng(1))
    kw = dict(eval_split=True, r_t_noise=(0.01, 0.02, 1.0), sh_degree=1)
    js, ts = JScene(root, **kw), TScene(root, **kw, device="cpu")
    assert (ts.static.width, ts.static.height) == (js.static.width, js.static.height)
    assert (ts.n_train, ts.n_test) == (js.n_train, js.n_test) == (7, 1)
    for split in ("train_cams", "train_cams_clean", "test_cams"):
        jc, tc = getattr(js, split), getattr(ts, split)
        for f in dataclasses.fields(jc):
            np.testing.assert_allclose(getattr(tc, f.name).numpy(),
                                       np.asarray(getattr(jc, f.name)),
                                       atol=1e-6, err_msg=f"{split}.{f.name}")
    np.testing.assert_array_equal(ts.train_image(2).numpy(),
                                  np.asarray(js.train_image(2)))
    np.testing.assert_array_equal(ts.test_image(0).numpy(),
                                  np.asarray(js.test_image(0)))
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    np.testing.assert_array_equal(ts.gaussians.xyz.numpy(),
                                  np.asarray(js.gaussians.xyz))
    np.testing.assert_allclose(ts.gaussians.scales_log.numpy(),
                               np.asarray(js.gaussians.scales_log), atol=1e-6)
    assert ts.cameras_extent == pytest.approx(js.cameras_extent)
