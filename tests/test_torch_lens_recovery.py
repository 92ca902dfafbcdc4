"""Port parity, known-lens recovery: the pieces of the port's
`bags_tpu_torch/tools/lens_recovery.py` against `bags_tpu` on the CPU.

The recovery dataset (the fisheye GT through the true lens) against the
JAX recovery test's own construction (tests/test_lens_recovery.py:47-80),
five recovery steps of a narrow lens net (the flow error against the true
lens after each, in both packages), and the port tool's JSON keys against
the JAX tool's. The recovery itself (hundreds of steps of the full lens
net) runs on the card, in `chip_smoke.py` step 13."""

import ast
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lens_nets import lens_np
from bags_tpu.calib import distortion as jdist
from bags_tpu.calib import iresnet as jres
from bags_tpu.model.gaussians import Gaussians as JGaussians
from bags_tpu.raster import RenderConfig as JCfg
from bags_tpu.train import calibrated as jcal
from bags_tpu.train.config import CalibConfig, OptimizationConfig, TrainConfig
from bags_tpu.train.loop import init_train_state as jinit
from bags_tpu_torch import convert
from bags_tpu_torch.calib import distortion as tdist
from bags_tpu_torch.core.camera import CameraParams
from bags_tpu_torch.raster.render import RenderConfig, render
from bags_tpu_torch.tools import lens_recovery
from bags_tpu_torch.train import calibrated as tcal
from bags_tpu_torch.train import config as tconfig
from bags_tpu_torch.train import loop as tloop
from bags_tpu_torch.utils.testing import make_toy_scene
from test_lens_recovery import INIT_COEFF, TRUE_COEFF, _make_dataset
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

N_CAMS, WH, N, FOCAL = 3, 48, 300, 18.0


@pytest.fixture(scope="module")
def jax_data():
    """The JAX recovery test's dataset, its render and warp jitted (the same
    functions; eagerly, each of their operations compiles on its own)."""
    import jax
    import test_lens_recovery

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(test_lens_recovery, "render", jax.jit(
            test_lens_recovery.render, static_argnames=("static", "cfg")))
        mp.setattr(test_lens_recovery, "apply_distortion", jax.jit(
            test_lens_recovery.apply_distortion,
            static_argnames=("grid_hw", "out_hw", "final_hw", "apply2gt")))
        return _make_dataset(n_cams=N_CAMS, wh=WH, n=N, focal=FOCAL)


@pytest.fixture(scope="module")
def port_data():
    """The JAX recovery test's dataset built with the port: the same scene,
    setup, control points, true flow, rotation rig and fisheye GTs."""
    sc = make_toy_scene(n=N, width=WH, height=WH, sh_degree=0, seed=11,
                        scale_range=(0.03, 0.1), device="cpu")
    setup = tcal.make_fisheye_setup(FOCAL, FOCAL, (WH, WH), (WH, WH),
                                    control_point_sample_scale=4)
    p_view = tcal.fisheye_control_points(setup, FOCAL, FOCAL, device="cpu")
    proj = np.asarray([1.0 / np.tan(setup.fovx / 2),
                       1.0 / np.tan(setup.fovy / 2)], np.float32)
    true_flow = tdist.analytic_inverse_flow(TRUE_COEFF, p_view, setup.grid_hw,
                                            proj, setup.flow_hw)
    gauss = [sc[k] for k in ("xyz", "scales", "quats", "opacity", "sh_coeffs")]
    cams, gts = [], []
    with torch.no_grad():
        for i in range(N_CAMS):
            a = 0.05 * (i - N_CAMS / 2)
            R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                          [-np.sin(a), 0, np.cos(a)]], np.float32)
            cam = CameraParams.create(R, np.zeros(3, np.float32), setup.fovx,
                                      setup.fovy, device="cpu")
            img = render(*gauss, cam, setup.render_static,
                         RenderConfig(sh_degree=0)).render
            gts.append(tdist.apply_distortion(
                None, p_view, setup.grid_hw, img, None, setup.flow_hw,
                final_hw=setup.fish_hw, flow=true_flow)[0])
            cams.append(cam)
    return sc, setup, p_view, proj, CameraParams.stack(cams), torch.stack(gts)


def test_recovery_dataset_matches_jax(jax_data, port_data):
    """Setup, control points and projection exactly; the fisheye GTs
    through the true lens at atol 2e-5."""
    _, jsetup, jp, jproj, jcams, jgts = jax_data
    _, setup, p_view, proj, cams, gts = port_data
    assert (setup.fish_hw, setup.grid_hw, setup.flow_hw) == (
        jsetup.fish_hw, jsetup.grid_hw, jsetup.flow_hw)
    np.testing.assert_array_equal(p_view.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(proj, np.asarray(jproj))
    np.testing.assert_allclose(cams.q_init.numpy(), np.asarray(jcams.q_init),
                               atol=1e-7)
    assert gts.shape == jgts.shape == (N_CAMS, 3, WH, WH)
    np.testing.assert_allclose(gts.numpy(), np.asarray(jgts), atol=2e-5)
    assert float(gts.max()) > 0.2


def test_five_recovery_steps_match_jax(jax_data):
    """The JAX recovery test's training, from its true scene with a narrow
    lens net (3 blocks of width 32) pre-fitted to the wrong coefficients in
    JAX, at lens lr 1e-3 so that five steps move the flow: after each step
    both packages' flow error against the true lens (render pixels) agree
    within 1e-3 px of the step's change from the pre-fit, floored at 1e-5
    px, and the losses within 2e-5."""
    sc, setup, p_view, proj, cams, fish_gts = jax_data
    g = JGaussians(
        xyz=sc["xyz"], sh_dc=sc["sh_coeffs"][:, :1, :],
        sh_rest=sc["sh_coeffs"][:, 1:, :],
        scales_log=jnp.log(sc["scales"]), quats=sc["quats"],
        opacity_raw=jnp.log(sc["opacity"] / (1 - sc["opacity"])))
    cfg = TrainConfig(
        opt=OptimizationConfig(),
        calib=CalibConfig(opt_cam=False, opt_distortion=True,
                          outside_rasterizer=True, iresnet_lr=1e-3,
                          banded_warp=False),
        max_instances=2 ** 14)
    base, g_tx, _, _ = jinit(g, jnp.ones((N,), bool), cams, cfg, 2.0)
    js, txs = jcal.init_calib_state(base, cfg)
    K = np.array([[FOCAL, 0, WH / 2], [0, FOCAL, WH / 2], [0, 0, 1.0]])
    lens = jdist.init_iresnet_from_colmap(
        jres.init_iresnet_params(hidden=32, n_blocks=3, n_layers=2, seed=1),
        K, WH, WH, INIT_COEFF, iters=200, lr=3e-3)
    js = dataclasses.replace(js, lens=lens, lens_opt=txs["lens"][0].init(lens))
    step = jcal.make_fisheye_train_step(
        # a tile holds at most one instance of each of the N Gaussians: the
        # jnp compositor's per-tile scan stops at 320 (its default 4,096
        # costs 13x the time for the same result)
        setup, JCfg(sh_degree=0, backend="jnp", precision="exact",
                    max_instances=2 ** 14, max_per_tile=320),
        cfg, g_tx, txs, sh_degree=0, opt_lens=True, use_vignetting=False)

    tg, alive = convert.gaussians_from_numpy(
        {f: np.asarray(getattr(js.base.g, f)) for f in
         ("xyz", "sh_dc", "sh_rest", "scales_log", "quats", "opacity_raw")}
        | {"alive": np.asarray(js.base.alive)}, device="cpu")
    tcfg = tconfig.TrainConfig.from_json(cfg.to_json())
    tcams = convert.camera_from_numpy(
        {f: np.asarray(getattr(js.base.cams, f)) for f in
         ("q_init", "t_init", "dq", "dt", "fovx", "fovy")}, device="cpu")
    cs, sched = convert.calib_state_from_numpy(
        tloop.init_train_state(tg, alive, tcams, tcfg, 2.0), tcfg,
        {"lens": lens_np(lens), "vig": {"a_k": np.asarray(js.vig.a_k),
                                        "beta_k": np.asarray(js.vig.beta_k)},
         "shift": np.asarray(js.shift)}, device="cpu")
    tsetup = tcal.make_fisheye_setup(FOCAL, FOCAL, (WH, WH), (WH, WH),
                                     control_point_sample_scale=4)
    tp = torch.as_tensor(np.array(p_view))

    def errs(jl, tl):
        return (jdist.flow_error_px(jl, TRUE_COEFF, p_view, np.asarray(proj), WH),
                tdist.flow_error_px(tl, TRUE_COEFF, tp, np.asarray(proj), WH))

    e0 = errs(js.lens, cs.lens)
    np.testing.assert_allclose(e0[1], e0[0], rtol=1e-6)
    for i in range(5):
        idx = i % N_CAMS
        js, (jloss, _, _, _) = step(js, fish_gts[idx], p_view, jnp.asarray(idx),
                                    jnp.zeros(3))
        m = tcal.fisheye_train_step(
            cs, torch.as_tensor(np.array(fish_gts[idx])), tp, idx,
            torch.zeros(3), tsetup, RenderConfig(sh_degree=0), tcfg, sched,
            True, False)
        np.testing.assert_allclose(float(m.loss), float(jloss), atol=2e-5)
        je, te = errs(js.lens, cs.lens)
        tol = max(1e-3 * abs(je - e0[0]), 1e-5)
        assert abs(te - je) <= tol, (i, te, je, e0[0])
    assert abs(je - e0[0]) > 1e-3, "five steps did not move the flow"


def _jax_tool_keys():
    """The keys of the JAX tool's JSON line and of its trace entries, read
    from its source (running it means 3,000 pre-fit steps)."""
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools",
                        "lens_recovery.py")
    keys = {}
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "dict":
            names = [k.arg for k in node.keywords]
            keys["out" if "metric" in names else "trace"] = names
    return keys


def test_tool_json_has_the_jax_keys(monkeypatch, capsys):
    """`main` at a tiny size on the CPU (PREFIT_ITERS 2) prints and returns
    one JSON line with the JAX tool's keys, in its order, finite numbers,
    and a trace entry per report with the JAX tool's keys."""
    monkeypatch.setattr(lens_recovery, "PREFIT_ITERS", 2)
    out = lens_recovery.main(["--iters", "4", "--report_every", "2", "--wh", "32",
                              "--n", "200", "--n_cams", "5", "--device", "cpu"])
    keys = _jax_tool_keys()
    assert list(out) == keys["out"]
    assert [list(t) for t in out["trace"]] == [keys["trace"]] * 2
    assert out["warp_ky"] == 0 and out["iters"] == 4
    assert all(np.isfinite(v) for k, v in out.items()
               if isinstance(v, float))
    import json
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(out))
