"""Port parity, training: losses, schedules and optimizers, densification,
one train step and a short run of `bags_tpu_torch` against `bags_tpu`
(CPU; JAX renders with its jnp backend), and pose recovery in torch."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bags_tpu.core.camera import CameraParams as JCam
from bags_tpu.eval import pose_eval as jpose
from bags_tpu.model import densify as jdens
from bags_tpu.model.gaussians import create_from_points
from bags_tpu.raster import RenderConfig as JCfg
from bags_tpu.raster import render as jrender
from bags_tpu.train import config as jconfig
from bags_tpu.train import loop as jloop
from bags_tpu.train import losses as jlosses
from bags_tpu.train import optim as joptim
from bags_tpu.utils.testing import make_toy_scene as jmake
from bags_tpu_torch import convert
from bags_tpu_torch.eval import pose_eval as tpose
from bags_tpu_torch.model import densify as tdens
from bags_tpu_torch.raster.render import RenderConfig as TCfg
from bags_tpu_torch.raster.render import render as trender
from bags_tpu_torch.train import config as tconfig
from bags_tpu_torch.train import loop as tloop
from bags_tpu_torch.train import losses as tlosses
from bags_tpu_torch.train import optim as toptim
from bags_tpu_torch.utils.logging import MetricsLogger
from bags_tpu_torch.utils.testing import make_toy_scene as tmake
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

G_FIELDS = ("xyz", "sh_dc", "sh_rest", "scales_log", "quats", "opacity_raw")
CAM_FIELDS = ("q_init", "t_init", "dq", "dt", "fovx", "fovy")
STAT_FIELDS = ("grad_accum", "grad_accum_abs", "denom", "max_radii2d")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.tensor(np.asarray(x))


def _tree_np(x, names):
    return {n: np.asarray(getattr(x, n)) for n in names}


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["ssim", "ssim_per_channel", "photometric",
                                "l1", "l2", "masked_photometric"])
def test_losses_match_jax(fn):
    """Values and gradients (to the prediction) against JAX, atol 1e-6."""
    rng = np.random.default_rng(1)
    pred = rng.uniform(size=(3, 40, 52)).astype(np.float32)
    gt = np.clip(pred + rng.normal(0, 0.1, pred.shape), 0, 1).astype(np.float32)
    mask = (rng.uniform(size=(1, 40, 52)) > 0.2).astype(np.float32)
    calls = {
        "ssim": lambda m, p, g: m.ssim(p, g),
        "ssim_per_channel": lambda m, p, g: m.ssim(p, g, size_average=False).sum(),
        "photometric": lambda m, p, g: m.photometric_loss(p, g, 0.2),
        "l1": lambda m, p, g: m.l1_loss(p, g),
        "l2": lambda m, p, g: m.l2_loss(p, g),
        "masked_photometric": lambda m, p, g: m.masked_photometric_loss(
            p, g, jnp.asarray(mask) if m is jlosses else torch.as_tensor(mask)),
    }
    f = calls[fn]
    jv, jg = jax.value_and_grad(lambda p: f(jlosses, p, jnp.asarray(gt)))(
        jnp.asarray(pred))
    tp = torch.tensor(pred, requires_grad=True)
    tv = f(tlosses, tp, torch.as_tensor(gt))
    tv.backward()
    np.testing.assert_allclose(_np(tv), np.asarray(jv), atol=1e-6)
    np.testing.assert_allclose(_np(tp.grad), np.asarray(jg), atol=1e-6)


# --------------------------------------------------------------------------
# schedules and optimizers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 500, 7000, 29999, 30000])
def test_schedules_match_jax(step):
    for args, kw in (((1.6e-4 * 3.0, 1.6e-6 * 3.0, 30_000), dict(lr_delay_mult=0.01)),
                     ((1e-3, 1e-5, 20_000), dict(lr_delay_steps=1000,
                                                 lr_delay_mult=0.1))):
        np.testing.assert_allclose(
            toptim.expon_lr_schedule(*args, **kw)(step),
            float(joptim.expon_lr_schedule(*args, **kw)(step)), rtol=1e-6)
    np.testing.assert_allclose(
        toptim.multistep_schedule(0.01, (7000, 30000), 0.5)(step),
        float(joptim.multistep_schedule(0.01, (7000, 30000), 0.5)(step)), rtol=1e-7)


def _gaussians(seed, n=48, cap=64, sh_degree=1):
    """JAX Gaussians with random non-trivial fields, and the port's copy."""
    rng = np.random.default_rng(seed)
    g, alive = create_from_points(rng.normal(size=(n, 3)).astype(np.float32),
                                  rng.random((n, 3)).astype(np.float32), cap,
                                  sh_degree)
    g = dataclasses.replace(
        g, sh_rest=jnp.asarray(rng.normal(0, 0.1, g.sh_rest.shape).astype(np.float32)),
        quats=jnp.asarray(rng.normal(size=g.quats.shape).astype(np.float32)),
        scales_log=g.scales_log + jnp.asarray(
            rng.normal(0, 0.5, g.scales_log.shape).astype(np.float32)))
    d = _tree_np(g, G_FIELDS)
    d["alive"] = np.asarray(alive)
    tg, talive = convert.gaussians_from_numpy(d, device="cpu")
    return g, alive, tg, talive


def test_gaussian_adam_matches_optax():
    """Two steps of the six-group Adam from the same gradients against
    `make_gaussian_optimizer` + optax: parameters and moments."""
    g, _, tg, _ = _gaussians(0)
    opt = jconfig.OptimizationConfig()
    g_tx = joptim.make_gaussian_optimizer(opt, 2.5)
    st = g_tx.init(g)
    adam, sched = toptim.make_gaussian_optimizer(
        tg, tconfig.OptimizationConfig(), 2.5)
    rng = np.random.default_rng(1)
    for step in range(2):
        grads = {n: rng.normal(size=np.asarray(getattr(g, n)).shape).astype(np.float32)
                 for n in G_FIELDS}
        upd, st = g_tx.update(dataclasses.replace(
            g, **{n: jnp.asarray(v) for n, v in grads.items()}), st, g)
        g = optax.apply_updates(g, upd)
        for n in G_FIELDS:
            getattr(tg, n).grad = torch.as_tensor(grads[n])
        adam.param_groups[0]["lr"] = sched(step)
        adam.step()
    for n in G_FIELDS:
        np.testing.assert_allclose(_np(getattr(tg, n)), np.asarray(getattr(g, n)),
                                   atol=1e-7, rtol=1e-6, err_msg=n)
    for label, field in toptim.GAUSSIAN_GROUPS:
        adam_st = st.inner_states[label].inner_state[0]
        for jname, tname in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            np.testing.assert_allclose(
                _np(adam.state[getattr(tg, field)][tname]),
                np.asarray(getattr(getattr(adam_st, jname), field)),
                atol=1e-8, rtol=1e-5, err_msg=f"{label} {jname}")


def _batched_cams(rng, n=3):
    cams = [JCam.create(np.eye(3, dtype=np.float32),
                        rng.normal(size=3).astype(np.float32), 0.8, 0.7)
            for _ in range(n)]
    b = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cams)
    b = dataclasses.replace(b, dq=jnp.asarray(rng.normal(0, 0.01, (n, 4)).astype(np.float32)))
    return b, convert.camera_from_numpy(_tree_np(b, CAM_FIELDS), device="cpu")


def test_row_adam_matches_jax():
    """Rows 1, 2, then 1 again step at global iterations 0, 1 and 7000 (past
    the first milestone): only the sampled row moves, with its own count."""
    rng = np.random.default_rng(2)
    jc, tc = _batched_cams(rng)
    calib = jconfig.CalibConfig(opt_cam=True, opt_intrinsic=True)
    tcalib = tconfig.CalibConfig(opt_cam=True, opt_intrinsic=True)
    jst, tst = jloop.row_adam_init(jc), toptim.row_adam_init(tc)
    for idx, step in ((1, 0), (2, 1), (1, 7000)):
        grads = {"dq": rng.normal(size=4), "dt": rng.normal(size=3),
                 "fovx": rng.normal(), "fovy": rng.normal()}
        grads = {k: np.asarray(v, np.float32) for k, v in grads.items()}
        jg = JCam(q_init=jnp.zeros(4), t_init=jnp.zeros(3),
                  **{k: jnp.asarray(v) for k, v in grads.items()})
        jc, jst = jloop.row_adam_update(jc, jst, jg, jnp.asarray(idx), calib,
                                        jnp.asarray(step))
        toptim.row_adam_update(tc, tst, {k: torch.as_tensor(v) for k, v in grads.items()},
                               idx, toptim.camera_lrs(tcalib, step))
    # a step is ~lr = 1e-2; JAX forms the bias corrections in float32
    for f in CAM_FIELDS:
        np.testing.assert_allclose(_np(getattr(tc, f)), np.asarray(getattr(jc, f)),
                                   atol=1e-6, rtol=1e-5, err_msg=f)
    for f in toptim.CAMERA_FIELDS:
        np.testing.assert_allclose(_np(tst.mu[f]), np.asarray(getattr(jst.mu, f)),
                                   atol=1e-7, rtol=1e-6)
        np.testing.assert_allclose(_np(tst.nu[f]), np.asarray(getattr(jst.nu, f)),
                                   atol=1e-9, rtol=1e-6)
    np.testing.assert_array_equal(_np(tst.count), np.asarray(jst.count))
    assert _np(tst.count).tolist() == [0, 2, 1]
    assert not _np(tst.mu["dq"])[0].any()


# --------------------------------------------------------------------------
# densification
# --------------------------------------------------------------------------

def _densify_inputs(seed, n=300, cap=512):
    g, alive, tg, talive = _gaussians(seed, n=n, cap=cap, sh_degree=1)
    rng = np.random.default_rng(seed + 100)
    grads = (rng.uniform(0, 4e-4, cap) * np.asarray(alive)).astype(np.float32)
    radii = (rng.uniform(0, 40, cap) * np.asarray(alive)).astype(np.float32)
    op = rng.uniform(-6.0, 2.0, cap).astype(np.float32)
    g = dataclasses.replace(g, opacity_raw=jnp.asarray(op))
    tg.opacity_raw.copy_(torch.as_tensor(op))
    return g, alive, tg, talive, grads, radii


def _assert_same_g(tg, g, fields=G_FIELDS, **kw):
    for n in fields:
        np.testing.assert_allclose(_np(getattr(tg, n)), np.asarray(getattr(g, n)),
                                   err_msg=n, **kw)


def test_densify_clone_matches_jax():
    g, alive, tg, talive, grads, _ = _densify_inputs(3)
    jg, jalive, jw, jn = jdens.densify_and_clone(g, alive, jnp.asarray(grads),
                                                  2e-4, 0.01, 60.0)
    talive2, tw, tn = tdens.densify_and_clone(tg, talive, torch.as_tensor(grads),
                                              2e-4, 0.01, 60.0)
    assert tn == int(jn) > 10
    np.testing.assert_array_equal(_np(talive2), np.asarray(jalive))
    np.testing.assert_array_equal(_np(tw), np.asarray(jw))
    _assert_same_g(tg, jg, atol=0, rtol=0)


def test_densify_split_matches_jax():
    """Split picks the same parents and writes the same slots with the same
    child scales; the positions are random (compared by moments below)."""
    g, alive, tg, talive, grads, _ = _densify_inputs(4)
    jg, jalive, jw, jn = jdens.densify_and_split(
        g, alive, jnp.asarray(grads), 2e-4, 0.01, 3.0, jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    talive2, tw, tn = tdens.densify_and_split(tg, talive, torch.as_tensor(grads),
                                              2e-4, 0.01, 3.0, gen)
    assert tn == int(jn) > 10
    np.testing.assert_array_equal(_np(talive2), np.asarray(jalive))
    np.testing.assert_array_equal(_np(tw), np.asarray(jw))
    _assert_same_g(tg, jg, fields=("sh_dc", "sh_rest", "quats", "opacity_raw",
                                   "scales_log"), atol=1e-6, rtol=0)


def test_densify_split_offsets_match_in_distribution():
    """Child offsets over 2,400 split parents (4,800 children): mean and
    covariance agree with JAX's within 3 standard errors."""
    n, cap = 2400, 8192
    rng = np.random.default_rng(5)
    q = np.array([0.9, 0.3, -0.2, 0.1], np.float32)
    q /= np.linalg.norm(q)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    g, alive = create_from_points(pts, rng.random((n, 3)).astype(np.float32), cap, 0)
    g = dataclasses.replace(
        g, quats=jnp.tile(jnp.asarray(q), (cap, 1)),
        scales_log=jnp.tile(jnp.log(jnp.asarray([0.3, 0.1, 0.05])), (cap, 1)))
    d = _tree_np(g, G_FIELDS)
    d["alive"] = np.asarray(alive)
    tg, talive = convert.gaussians_from_numpy(d, device="cpu")
    grads = np.where(np.asarray(alive), 1.0, 0.0).astype(np.float32)
    jg, jalive, jw, _ = jdens.densify_and_split(g, alive, jnp.asarray(grads), 2e-4,
                                                0.01, 1.0, jax.random.PRNGKey(1))
    talive2, tw, _ = tdens.densify_and_split(tg, talive, torch.as_tensor(grads), 2e-4,
                                             0.01, 1.0, torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(_np(tw), np.asarray(jw))

    def offsets(xyz):
        xyz = np.asarray(xyz, np.float64)
        return np.concatenate([xyz[:n] - pts, xyz[n:2 * n] - pts])

    oj, ot = offsets(jg.xyz), offsets(_np(tg.xyz))
    se = np.sqrt(oj.var(0) / len(oj) + ot.var(0) / len(ot))
    assert np.all(np.abs(oj.mean(0) - ot.mean(0)) < 3 * se)
    for a in range(3):
        for b in range(a, 3):
            pj, pt = oj[:, a] * oj[:, b], ot[:, a] * ot[:, b]
            se = np.sqrt(pj.var() / len(pj) + pt.var() / len(pt))
            assert abs(pj.mean() - pt.mean()) < 3 * se, (a, b)
    # the offsets follow the parent's covariance R diag(s / 1)^2 R^T
    assert np.abs(np.cov(ot.T) - np.cov(oj.T)).max() < 0.01


def test_densify_prune_reset_and_full_step_match_jax():
    g, alive, tg, talive, grads, radii = _densify_inputs(6)
    for max_screen in (0.0, 20.0):
        _, ja, jp, jn = jdens.prune(g, alive, 0.005, jnp.asarray(radii), max_screen, 3.0)
        ta, tp, tn = tdens.prune(tg, talive, 0.005, torch.as_tensor(radii),
                                 max_screen, 3.0)
        np.testing.assert_array_equal(_np(ta), np.asarray(ja))
        np.testing.assert_array_equal(_np(tp), np.asarray(jp))
        assert tn == int(jn) > 0

    stats = jdens.DensifyStats(jnp.asarray(grads * 3), jnp.asarray(grads * 5),
                               jnp.asarray(np.where(np.asarray(alive), 3.0, 0.0),
                                           jnp.float32), jnp.asarray(radii))
    tstats = convert.densify_stats_from_numpy(_tree_np(stats, STAT_FIELDS),
                                              device="cpu")
    for use_abs in (False, True):
        gg, aa, tg2, ta2, *_ = _densify_inputs(6)
        res = jdens.densify_and_prune(gg, aa, stats, jax.random.PRNGKey(2),
                                      2e-4, 0.005, 3.0, 20.0, use_abs_grad=use_abs)
        tres = tdens.densify_and_prune(tg2, ta2, tstats, torch.Generator().manual_seed(2),
                                       2e-4, 0.005, 3.0, 20.0, use_abs_grad=use_abs)
        np.testing.assert_array_equal(_np(tres.alive), np.asarray(res.alive))
        np.testing.assert_array_equal(_np(tres.reset_mask), np.asarray(res.reset_mask))
        assert (tres.n_cloned, tres.n_split, tres.n_pruned) == (
            int(res.n_cloned), int(res.n_split), int(res.n_pruned))
        assert tres.n_cloned + tres.n_split > 0 and tres.n_pruned > 0

    jg2, _ = jdens.reset_opacity(g)
    tdens.reset_opacity(tg)
    np.testing.assert_allclose(_np(tg.opacity_raw), np.asarray(jg2.opacity_raw),
                               atol=1e-6)


def test_update_stats_matches_jax():
    rng = np.random.default_rng(7)
    c = 64
    st = jdens.DensifyStats(*(jnp.asarray(rng.uniform(size=c).astype(np.float32))
                              for _ in STAT_FIELDS))
    tst = tdens.DensifyStats(*(_t(getattr(st, f)) for f in STAT_FIELDS))
    pg, pa = (rng.normal(size=(c, 2)).astype(np.float32) for _ in range(2))
    radii = rng.integers(0, 9, c).astype(np.int32)
    vis = radii > 0
    for absg in (pa, None):
        j = jdens.update_stats(st, jnp.asarray(pg), None if absg is None else jnp.asarray(absg),
                               jnp.asarray(radii), jnp.asarray(vis))
        t = tdens.update_stats(tst, _t(pg), None if absg is None else _t(absg),
                               _t(radii), _t(vis))
        for f in STAT_FIELDS:
            np.testing.assert_allclose(_np(getattr(t, f)), np.asarray(getattr(j, f)),
                                       atol=1e-6, err_msg=f)


def test_adam_row_surgery():
    """zero_moments_at zeroes exactly the masked rows of every moment in
    place; the opacity reset zeroes the opacity moments and leaves the
    others."""
    _, _, tg, talive = _gaussians(8)
    adam, _ = toptim.make_gaussian_optimizer(tg, tconfig.OptimizationConfig(), 1.0)
    for p in (getattr(tg, f) for f in G_FIELDS):
        p.grad = torch.randn_like(p)
    adam.step()
    before = {f: adam.state[getattr(tg, f)]["exp_avg"].clone() for f in G_FIELDS}
    mask = torch.zeros(talive.shape[0], dtype=torch.bool)
    mask[[1, 5, 40]] = True
    tdens.zero_moments_at(adam, mask)
    for f in G_FIELDS:
        st = adam.state[getattr(tg, f)]
        assert not st["exp_avg"][mask].any() and not st["exp_avg_sq"][mask].any()
        torch.testing.assert_close(st["exp_avg"][~mask], before[f][~mask])
        assert int(st["step"]) == 1
    state = tloop.TrainState(g=tg, alive=talive, g_opt=adam, xyz_sched=None,
                             cams=None, cam_opt=None, align=None, align_opt=None,
                             stats=None, step=1, gen=None)
    tloop.opacity_reset_step(state)
    assert float(torch.sigmoid(tg.opacity_raw).max()) <= 0.01 + 1e-7
    assert not adam.state[tg.opacity_raw]["exp_avg"].any()
    assert adam.state[tg.xyz]["exp_avg"][~mask].abs().sum() > 0


# --------------------------------------------------------------------------
# pose evaluation, config, metrics log
# --------------------------------------------------------------------------

def test_pose_error_matches_jax():
    rng = np.random.default_rng(9)
    gt, tgt = _batched_cams(rng, n=6)
    pred = dataclasses.replace(
        gt, dq=gt.dq + jnp.asarray(rng.normal(0, 0.02, (6, 4)).astype(np.float32)),
        dt=jnp.asarray(rng.normal(0, 0.05, (6, 3)).astype(np.float32)))
    tpred = convert.camera_from_numpy(_tree_np(pred, CAM_FIELDS), device="cpu")
    _, je = jpose.align_and_pose_error(pred, gt)
    _, te = tpose.align_and_pose_error(tpred, tgt)
    for k in ("rotation_deg", "translation"):
        np.testing.assert_allclose(te[k], np.asarray(je[k]), atol=1e-4, err_msg=k)
    assert te["rotation_deg_mean"] > 0.1


def test_config_json_from_jax_loads():
    cfg = jconfig.TrainConfig(
        opt=jconfig.OptimizationConfig(iterations=123, densify_from_iter=7),
        calib=jconfig.CalibConfig(opt_cam=True, r_t_lr=(0.01, 0.02)), seed=4)
    text = cfg.to_json()
    tcfg = tconfig.TrainConfig.from_json(text)
    assert tcfg.to_json() == text
    assert tcfg.calib.r_t_lr == (0.01, 0.02) and tcfg.opt.iterations == 123


def test_metrics_logger(tmp_path):
    log = MetricsLogger(str(tmp_path))
    log.log(10, loss=torch.tensor(0.5), n_alive=torch.tensor(3))
    log.log(20, loss=0.25)
    log.close()
    import json
    lines = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in lines] == [10, 20]
    assert lines[0]["loss"] == 0.5 and lines[0]["n_alive"] == 3.0


# --------------------------------------------------------------------------
# one train step, a short run, pose recovery
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def toy_training():
    """The toy setup of tests/test_train_toy.py:21-52 (4 cameras, 120 points,
    48x48, capacity 256) with SH-1 Gaussians and noised dq, in both
    packages, and JAX's jitted train step (compiled once)."""
    n_cams, n_pts, wh, cap = 4, 120, 48, 256
    rng = np.random.default_rng(3)
    scene = jmake(n=n_pts, width=wh, height=wh, sh_degree=0, seed=3)
    static = scene["static"]
    cfg_r = JCfg(sh_degree=0, backend="jnp", max_instances=2 ** 14)
    render_j = jax.jit(jrender, static_argnames=("static", "cfg"))
    cams, gt = [], []
    for i in range(n_cams):
        a = 0.06 * (i - n_cams / 2)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]], np.float32)
        cam = JCam.create(R, np.zeros(3, np.float32), 0.8, 0.8)
        gt.append(np.asarray(render_j(scene["xyz"], scene["scales"], scene["quats"],
                                      scene["opacity"], scene["sh_coeffs"], cam,
                                      static=static, cfg=cfg_r).render))
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
        opt=jconfig.OptimizationConfig(densify_from_iter=10_000,
                                       position_lr_max_steps=200),
        calib=jconfig.CalibConfig(opt_cam=True, opt_intrinsic=True,
                                  r_t_lr=(0.003, 0.003)),
        max_instances=2 ** 14)
    cfg.model.sh_degree = 1
    # a tile holds at most one instance of each of the 256 slots: the jnp
    # compositor's per-tile scan stops there (its default 4,096 costs 16x)
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


def _port_step(toy, tstate, tcfg, idx):
    from bags_tpu_torch.core.camera import CameraStatic
    st = toy["static"]
    return tloop.train_step(tstate, torch.as_tensor(toy["gt"][idx]), idx,
                            torch.zeros(3), CameraStatic(st.width, st.height),
                            TCfg(sh_degree=1), tcfg)


def test_train_step_matches_jax(toy_training):
    """One step with --opt_cam --opt_intrinsic from the same state, camera
    and GT: loss (atol 1e-5), Gaussians, the camera row and the densify
    statistics (atol 1e-5, rtol 1e-3)."""
    toy, idx = toy_training, 2
    jstate, jm = toy["step"](toy["state"], jnp.asarray(toy["gt"][idx]),
                             jnp.asarray(idx), jnp.zeros(3))
    tstate, tcfg = _port_state(toy)
    tm = _port_step(toy, tstate, tcfg, idx)
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), atol=1e-5)
    np.testing.assert_allclose(float(tm.l1), float(jm.l1), atol=1e-5)
    _assert_same_g(tstate.g, jstate.g, atol=1e-5, rtol=1e-3)
    for f in CAM_FIELDS:
        np.testing.assert_allclose(_np(getattr(tstate.cams, f)),
                                   np.asarray(getattr(jstate.cams, f)),
                                   atol=1e-5, rtol=1e-3, err_msg=f)
    assert np.abs(np.asarray(jstate.cams.dq - toy["state"].cams.dq))[idx].max() > 1e-4
    for f in STAT_FIELDS:
        np.testing.assert_allclose(_np(getattr(tstate.stats, f)),
                                   np.asarray(getattr(jstate.stats, f)),
                                   atol=1e-5, rtol=1e-3, err_msg=f)
    np.testing.assert_array_equal(_np(tstate.cam_opt.count),
                                  np.asarray(jstate.cam_opt.count))
    assert tstate.step == int(jstate.step) == 1


# Loss-curve tolerance of the 30-step run. Measured on this configuration:
# the two packages' losses differ by at most 7.7e-6 over the 30 steps (the
# first step by 0), growing as Adam with eps 1e-15 turns noise-level
# gradient differences into full-lr steps; the bound leaves a factor ~6.
SHORT_RUN_ATOL = 5e-5


def test_short_run_loss_curves_match_jax(toy_training):
    """30 iterations, the camera order of both trainers (a stack refilled
    from np.random.default_rng(0).permutation), densify outside the window."""
    toy = toy_training
    rng = np.random.default_rng(0)
    stack, order = [], []
    for _ in range(30):
        if not stack:
            stack = list(rng.permutation(4))
        order.append(int(stack.pop()))
    jstate, jl = toy["state"], []
    for idx in order:
        jstate, m = toy["step"](jstate, jnp.asarray(toy["gt"][idx]), jnp.asarray(idx),
                                jnp.zeros(3))
        jl.append(float(m.loss))
    tstate, tcfg = _port_state(toy)
    tl = [float(_port_step(toy, tstate, tcfg, idx).loss) for idx in order]
    np.testing.assert_allclose(tl, jl, atol=SHORT_RUN_ATOL)
    assert np.mean(tl[-5:]) < 0.8 * np.mean(tl[:5])


def test_trainer_camera_order_matches_jax(toy_training):
    """Both Trainers draw cameras from the same reshuffled stack."""
    toy = toy_training
    s = toy["state"]
    jt = jloop.Trainer(s.g, s.alive, s.cams, toy["static"], toy["cfg"], 3.0,
                       gt_images=toy["gt"], rcfg=JCfg(backend="jnp"), seed=5)
    tstate, tcfg = _port_state(toy)
    tt = tloop.Trainer(tstate.g, tstate.alive, tstate.cams, toy["static"], tcfg,
                       3.0, gt_images=torch.as_tensor(toy["gt"]), seed=5)
    assert [jt._next_camera() for _ in range(13)] == \
        [tt._next_camera() for _ in range(13)]


def test_pose_recovery_in_torch():
    """The verify recipe: with the true splats, 80 Adam steps (lr 3e-3) of
    dq / dt bring the L1 loss under 0.02."""
    sc = tmake(n=400, width=64, height=64, sh_degree=1, seed=7, device="cpu")
    cfg = TCfg(sh_degree=1)
    args = [sc[k] for k in ("xyz", "scales", "quats", "opacity", "sh_coeffs")]
    with torch.no_grad():
        gt = trender(*args, sc["cam"], sc["static"], cfg).render
    p = {"dq": torch.tensor([0.0, 0.02, -0.015, 0.01], requires_grad=True),
         "dt": torch.tensor([0.05, -0.04, 0.03], requires_grad=True)}
    opt = torch.optim.Adam(list(p.values()), lr=3e-3)

    def loss_fn():
        out = trender(*args, dataclasses.replace(sc["cam"], **p), sc["static"], cfg)
        return torch.mean(torch.abs(out.render - gt))

    first = loss_fn().item()
    for _ in range(80):
        opt.zero_grad()
        loss_fn().backward()
        opt.step()
    final = loss_fn().item()
    assert final < 0.02 < first, (first, final)
