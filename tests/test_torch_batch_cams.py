"""Port parity, camera batches (`--batch_cams K`) on one device: the K = 2
pose step, the row Adam over K rows and the K-camera draw against the JAX
package (CPU; JAX renders with its jnp backend, the per-tile scan capped
at the toy's slot count), and the cubemap mode's refusal in both packages.
Tolerances: losses atol 1e-5, states atol 1e-5 and rtol 1e-3
(`tests/test_pallas_raster.py:20-107`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bags_tpu.core.camera import CameraParams as JCam
from bags_tpu.model.gaussians import create_from_points
from bags_tpu.raster import RenderConfig as JCfg
from bags_tpu.raster import render as jrender
from bags_tpu.train import calibrated as jcal
from bags_tpu.train import config as jconfig
from bags_tpu.train import loop as jloop
from bags_tpu.utils.testing import make_toy_scene as jmake
from bags_tpu_torch import convert
from bags_tpu_torch.core.camera import CameraStatic
from bags_tpu_torch.raster.render import RenderConfig as TCfg
from bags_tpu_torch.train import calibrated as tcal
from bags_tpu_torch.train import config as tconfig
from bags_tpu_torch.train import loop as tloop
from bags_tpu_torch.train import optim as toptim
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

G_FIELDS = ("xyz", "sh_dc", "sh_rest", "scales_log", "quats", "opacity_raw")
CAM_FIELDS = ("q_init", "t_init", "dq", "dt", "fovx", "fovy")
STAT_FIELDS = ("grad_accum", "grad_accum_abs", "denom", "max_radii2d")
IDX = (3, 1)   # the batch's two cameras


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tree_np(x, names):
    return {n: np.asarray(getattr(x, n)) for n in names}


@pytest.fixture(scope="module")
def toy():
    """`tests/test_torch_train.py`'s toy (4 cameras, 120 points, 48x48,
    capacity 256, SH 1, noised dq) with --batch_cams 2 and --opt_intrinsic,
    and JAX's jitted K = 2 step."""
    n_cams, n_pts, wh, cap = 4, 120, 48, 256
    rng = np.random.default_rng(3)
    scene = jmake(n=n_pts, width=wh, height=wh, sh_degree=0, seed=3)
    static = scene["static"]
    render_j = jax.jit(jrender, static_argnames=("static", "cfg"))
    cams, gt = [], []
    for i in range(n_cams):
        a = 0.06 * (i - n_cams / 2)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]], np.float32)
        cam = JCam.create(R, np.zeros(3, np.float32), 0.8, 0.8)
        gt.append(np.asarray(render_j(
            scene["xyz"], scene["scales"], scene["quats"], scene["opacity"],
            scene["sh_coeffs"], cam, static=static,
            cfg=JCfg(sh_degree=0, backend="jnp", max_per_tile=n_pts)).render))
        cams.append(cam)
    pts = np.asarray(scene["xyz"]) + rng.normal(0, 0.05, (n_pts, 3)).astype(np.float32)
    cols = rng.uniform(0.2, 0.8, (n_pts, 3)).astype(np.float32)
    g, alive = create_from_points(pts, cols, cap, sh_degree=1)
    g = dataclasses.replace(g, sh_rest=g.sh_rest.at[:n_pts].set(jnp.asarray(
        rng.normal(0, 0.1, (n_pts, 3, 3)).astype(np.float32))))
    batched = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cams)
    batched = dataclasses.replace(batched, dq=jnp.asarray(
        rng.normal(0, 0.01, (n_cams, 4)).astype(np.float32)))
    cfg = jconfig.TrainConfig(
        opt=jconfig.OptimizationConfig(densify_from_iter=10_000, batch_cams=2,
                                       position_lr_max_steps=200),
        calib=jconfig.CalibConfig(opt_cam=True, opt_intrinsic=True,
                                  r_t_lr=(0.003, 0.003)),
        max_instances=2 ** 14)
    cfg.model.sh_degree = 1
    rcfg = JCfg(sh_degree=1, backend="jnp", max_instances=2 ** 14,
                max_per_tile=cap)
    state, g_tx, align_tx, _ = jloop.init_train_state(g, alive, batched, cfg, 3.0)
    step = jloop.make_train_step(static, rcfg, cfg, g_tx, align_tx, 1)
    return dict(state=state, step=step, gt=np.stack(gt), cfg=cfg, static=static)


def _port_state(toy):
    s = toy["state"]
    d = _tree_np(s.g, G_FIELDS)
    d["alive"] = np.asarray(s.alive)
    g, alive = convert.gaussians_from_numpy(d, device="cpu")
    cams = convert.camera_from_numpy(_tree_np(s.cams, CAM_FIELDS), device="cpu")
    cfg = tconfig.TrainConfig.from_json(toy["cfg"].to_json())
    return tloop.init_train_state(g, alive, cams, cfg, 3.0), cfg


def test_batch_train_step_matches_jax(toy):
    """One K = 2 step from the same state, cameras and GT: the loss, the
    Gaussians, both camera rows and their Adam counts, and the statistics
    scaled back by K (every live Gaussian seen twice: denom 2)."""
    jstate, jm = toy["step"](toy["state"], jnp.asarray(toy["gt"][list(IDX)]),
                             jnp.asarray(IDX, jnp.int32), jnp.zeros(3))
    tstate, tcfg = _port_state(toy)
    st = toy["static"]
    tm = tloop.train_step(tstate, torch.as_tensor(toy["gt"][list(IDX)]),
                          list(IDX), torch.zeros(3),
                          CameraStatic(st.width, st.height), TCfg(sh_degree=1),
                          tcfg)
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), atol=1e-5)
    np.testing.assert_allclose(float(tm.l1), float(jm.l1), atol=1e-5)
    assert tm.image.shape == (2, 3, 48, 48) and tm.grads[".cam.dq"].shape == (2, 4)
    for n in G_FIELDS:
        np.testing.assert_allclose(_np(getattr(tstate.g, n)),
                                   np.asarray(getattr(jstate.g, n)), atol=1e-5,
                                   rtol=1e-3, err_msg=n)
    for f in CAM_FIELDS:
        np.testing.assert_allclose(_np(getattr(tstate.cams, f)),
                                   np.asarray(getattr(jstate.cams, f)),
                                   atol=1e-5, rtol=1e-3, err_msg=f)
    moved = np.abs(np.asarray(jstate.cams.dq - toy["state"].cams.dq)).max(-1)
    assert (moved[list(IDX)] > 1e-4).all() and not moved[[0, 2]].any()
    np.testing.assert_array_equal(_np(tstate.cam_opt.count),
                                  np.asarray(jstate.cam_opt.count))
    assert _np(tstate.cam_opt.count).tolist() == [0, 1, 0, 1]
    for f in STAT_FIELDS:
        np.testing.assert_allclose(_np(getattr(tstate.stats, f)),
                                   np.asarray(getattr(jstate.stats, f)),
                                   atol=1e-5, rtol=1e-3, err_msg=f)
    assert _np(tstate.stats.denom).max() == 2.0


def test_batch_step_is_the_mean_of_single_views(toy):
    """The K = 2 loss is the mean of the two single-view losses on the same
    state, and its Gaussian and camera gradients the mean of theirs."""
    st = toy["static"]
    static = CameraStatic(st.width, st.height)
    single = []
    for i in IDX:
        tstate, tcfg = _port_state(toy)
        tcfg.opt.batch_cams = 1
        single.append(tloop.train_step(tstate, torch.as_tensor(toy["gt"][i]), i,
                                       torch.zeros(3), static, TCfg(sh_degree=1),
                                       tcfg))
    tstate, tcfg = _port_state(toy)
    both = tloop.train_step(tstate, torch.as_tensor(toy["gt"][list(IDX)]),
                            list(IDX), torch.zeros(3), static, TCfg(sh_degree=1),
                            tcfg)
    np.testing.assert_allclose(float(both.loss),
                               np.mean([float(m.loss) for m in single]), rtol=1e-6)
    for name, grad in both.grads.items():
        if name.startswith(".cam."):      # each row: half its view's gradient
            want = torch.stack([m.grads[name] for m in single]) / 2
        else:
            want = (single[0].grads[name] + single[1].grads[name]) / 2
        np.testing.assert_allclose(_np(grad), _np(want), atol=1e-7, rtol=1e-5,
                                   err_msg=name)


def test_row_adam_steps_k_rows_as_jax():
    """Rows (2, 0) then (1, 2) in one call each, at global steps 3 and 7000:
    each row its own count and bias correction, the lrs of the global
    step; a repeated row is refused."""
    rng = np.random.default_rng(4)
    cams = [JCam.create(np.eye(3, dtype=np.float32),
                        rng.normal(size=3).astype(np.float32), 0.8, 0.7)
            for _ in range(3)]
    jc = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cams)
    tc = convert.camera_from_numpy(_tree_np(jc, CAM_FIELDS), device="cpu")
    calib = jconfig.CalibConfig(opt_cam=True, opt_intrinsic=True)
    tcalib = tconfig.CalibConfig(opt_cam=True, opt_intrinsic=True)
    jst, tst = jloop.row_adam_init(jc), toptim.row_adam_init(tc)
    for idx, step in (((2, 0), 3), ((1, 2), 7000)):
        grads = {"dq": rng.normal(size=(2, 4)), "dt": rng.normal(size=(2, 3)),
                 "fovx": rng.normal(size=2), "fovy": rng.normal(size=2)}
        grads = {k: np.asarray(v, np.float32) for k, v in grads.items()}
        jg = JCam(q_init=jnp.zeros((2, 4)), t_init=jnp.zeros((2, 3)),
                  **{k: jnp.asarray(v) for k, v in grads.items()})
        jc, jst = jloop.row_adam_update(jc, jst, jg, jnp.asarray(idx), calib,
                                        jnp.asarray(step))
        toptim.row_adam_update(tc, tst, {k: torch.as_tensor(v)
                                         for k, v in grads.items()},
                               list(idx), toptim.camera_lrs(tcalib, step))
    for f in CAM_FIELDS:
        np.testing.assert_allclose(_np(getattr(tc, f)), np.asarray(getattr(jc, f)),
                                   atol=1e-6, rtol=1e-5, err_msg=f)
    for f in toptim.CAMERA_FIELDS:
        np.testing.assert_allclose(_np(tst.mu[f]), np.asarray(getattr(jst.mu, f)),
                                   atol=1e-7, rtol=1e-6)
        np.testing.assert_allclose(_np(tst.nu[f]), np.asarray(getattr(jst.nu, f)),
                                   atol=1e-9, rtol=1e-6)
    assert _np(tst.count).tolist() == np.asarray(jst.count).tolist() == [1, 1, 2]
    with pytest.raises(ValueError, match="not distinct"):
        toptim.row_adam_update(tc, tst, {k: torch.as_tensor(v)
                                         for k, v in grads.items()},
                               [1, 1], toptim.camera_lrs(tcalib, 0))


def test_next_cameras_sequence_matches_jax(toy):
    """Both Trainers draw the same K distinct cameras from the same
    reshuffled stack, step after step, the port's looking ahead first (as
    its GT prefetch does) without changing the order; k past the camera
    count raises."""
    s = toy["state"]
    jt = jloop.Trainer(s.g, s.alive, s.cams, toy["static"], toy["cfg"], 3.0,
                       gt_images=toy["gt"], rcfg=JCfg(backend="jnp"), seed=7)
    tstate, tcfg = _port_state(toy)
    tt = tloop.Trainer(tstate.g, tstate.alive, tstate.cams, toy["static"], tcfg,
                       3.0, gt_images=torch.as_tensor(toy["gt"]), seed=7)
    for k in (2, 3, 2, 4, 3, 2, 2):
        ahead = tt._draw(k, pop=False)
        got = tt._next_cameras(k)
        assert ahead == got
        assert got == [int(i) for i in jt._next_cameras(k)]
        assert len(set(got)) == k
    with pytest.raises(ValueError, match="exceeds"):
        tt._next_cameras(5)


def test_batch_trainer_run_stacks_the_views(toy):
    """`Trainer.run` with --batch_cams 2: each step gets the GTs of the
    cameras it drew, stacked, and two forward renders; the IO thread
    loads each later step's GTs ahead (each camera of the 3 steps and of
    the next loaded once)."""
    tstate, tcfg = _port_state(toy)
    loads = []

    def load(i):
        loads.append(i)
        return torch.as_tensor(toy["gt"][i])

    tt = tloop.Trainer(tstate.g, tstate.alive, tstate.cams, toy["static"], tcfg,
                       3.0, gt_images=load, seed=1)
    seen = []
    step = tt.step
    tt.step = lambda idx, gt, it=None: (seen.append((idx, gt)), step(idx, gt, it))[1]
    hist = tt.run(iterations=3, log_every=1)
    assert len(hist) == 3 and all(np.isfinite(h[1]) for h in hist)
    for idx, gt in seen:
        assert len(idx) == 2 and gt.shape == (2, 3, 48, 48)
        np.testing.assert_array_equal(gt.numpy(), toy["gt"][idx])
    assert _np(tt.base.cam_opt.count).sum() == 6
    tt.close()
    assert loads == [i for idx, _ in seen for i in idx] + tt._step_cameras(pop=True)


def test_cubemap_batch_cams_refused_in_both_packages():
    """The cubemap mode's step is already five renders: both packages refuse
    --batch_cams > 1 there before any other work."""
    msg = "--batch_cams > 1 is not supported with --cubemap"
    jcfg = jconfig.TrainConfig(opt=jconfig.OptimizationConfig(batch_cams=2),
                               calib=jconfig.CalibConfig(cubemap=True))
    with pytest.raises(ValueError, match=msg):
        jcal.CalibTrainer(None, None, None, None, jcfg, 1.0, None, 100.0, 100.0,
                          (64, 64))
    tcfg = tconfig.TrainConfig.from_json(jcfg.to_json())
    with pytest.raises(ValueError, match=msg):
        tcal.CalibTrainer(None, None, None, None, tcfg, 1.0, None, 100.0, 100.0,
                          (64, 64))
