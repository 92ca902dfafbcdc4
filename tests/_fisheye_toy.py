"""The toy fisheye setup shared by `test_torch_calibrated.py` (apply2render)
and `test_torch_calibrated_gt.py` (apply2gt), and in its hybrid variant
by `test_torch_hybrid_train.py`: a 48x48 scene of 150 Gaussians, 3
cameras, a 2-block lens net of width 24, in both packages, and JAX's
jitted fisheye step (compiled once per file, reused by its tests). JAX renders with `backend="jnp", precision="exact"` and warps with
the gather `grid_sample` (`banded_warp=False`).

One step of either package from zero Adam moments leaves each moment
mu = (1 - b1) g, so JAX's gradients are read from its new state's moments
(`jax_grads`) and compared with the port's step's own."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bags_tpu.calib.iresnet import init_iresnet_params as jinit_lens
from bags_tpu.core.camera import CameraParams as JCam
from bags_tpu.model.gaussians import create_from_points
from bags_tpu.raster import RenderConfig as JCfg
from bags_tpu.raster import render as jrender
from bags_tpu.train import calibrated as jcal
from bags_tpu.train import config as jconfig
from bags_tpu.train import loop as jloop
from bags_tpu.utils.testing import make_toy_scene as jmake
from bags_tpu_torch import convert
from bags_tpu_torch.raster.render import RenderConfig as TCfg
from bags_tpu_torch.train import calibrated as tcal
from bags_tpu_torch.train import config as tconfig
from bags_tpu_torch.train import loop as tloop
from bags_tpu_torch.utils.testing import toy_asg

G_FIELDS = ("xyz", "sh_dc", "sh_rest", "scales_log", "quats", "opacity_raw")
CAM_FIELDS = ("q_init", "t_init", "dq", "dt", "fovx", "fovy")
STAT_FIELDS = ("grad_accum", "grad_accum_abs", "denom", "max_radii2d")
LENS_FIELDS = ("weights", "biases", "u_vecs")
SPEC_NAMES = ("feat_w", "feat_b", "w1", "b1", "w2", "b2", "w3", "b3")
FOCAL, WH, N_CAMS = 40.0, 48, 3
B1 = 0.9


def _tree_np(x, names):
    return {n: np.asarray(getattr(x, n)) for n in names}


def lens_np(p):
    return {f: [[np.asarray(t) for t in blk] for blk in getattr(p, f)]
            for f in LENS_FIELDS}


def build(apply2gt: bool, vig_shift: bool, hybrid: bool = False,
          batch_cams: int = 1) -> dict:
    """The JAX side: config, setup, control points, fisheye GT, the
    CalibState before the first step and the jitted step (with the lens
    stepping and, with vig_shift, vignetting and the pupil shift; with
    hybrid, the specular colour of `toy_asg` features and the seed-0
    specular MLP; batch_cams views a step)."""
    cfg = jconfig.TrainConfig(
        opt=jconfig.OptimizationConfig(densify_from_iter=10_000,
                                       position_lr_max_steps=200,
                                       batch_cams=batch_cams),
        calib=jconfig.CalibConfig(
            opt_cam=True, opt_intrinsic=True, r_t_lr=(0.003, 0.003),
            opt_distortion=True, outside_rasterizer=True, apply2gt=apply2gt,
            flow_scale=(2.0, 2.0), control_point_sample_scale=8,
            iresnet_lr=1e-4, opt_shift=vig_shift,
            start_vignetting=0 if vig_shift else 10_000_000_000,
            banded_warp=False, hybrid=hybrid),
        max_instances=2 ** 14)
    cfg.model.sh_degree = 1
    setup = jcal.make_fisheye_setup(FOCAL, FOCAL, (WH, WH), (WH, WH),
                                    flow_scale=(2.0, 2.0),
                                    control_point_sample_scale=8,
                                    apply2gt=apply2gt)
    p_view = jcal.fisheye_control_points(setup, FOCAL, FOCAL, (2.0, 2.0))
    # A tile holds at most one instance of each of the 256 slots, so the
    # jnp compositor's per-tile scan stops at 256 (its default 4,096 costs
    # 16x the time for the same result).
    rcfg = JCfg(sh_degree=1, backend="jnp", precision="exact",
                max_instances=2 ** 14, max_per_tile=256)

    rng = np.random.default_rng(11)
    sc = jmake(n=150, width=WH, height=WH, sh_degree=1, seed=11)
    cams = []
    for i in range(N_CAMS):
        a = 0.05 * (i - 1)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]], np.float32)
        cams.append(JCam.create(R, np.zeros(3, np.float32), setup.fovx,
                                setup.fovy))
    # the fisheye GT: the true scene at the extended FoV (apply2render
    # compares it with the warped render, apply2gt warps it)
    render_j = jax.jit(jrender, static_argnames=("static", "cfg"))
    gts = np.stack([np.asarray(render_j(
        sc["xyz"], sc["scales"], sc["quats"], sc["opacity"], sc["sh_coeffs"],
        c, static=setup.render_static, cfg=rcfg).render) for c in cams])
    pts = np.asarray(sc["xyz"]) + rng.normal(0, 0.05, (150, 3)).astype(np.float32)
    cols = rng.uniform(0.2, 0.8, (150, 3)).astype(np.float32)
    g, alive = create_from_points(pts, cols, 256, sh_degree=1)
    # anisotropic and rotated, so that every field has a gradient
    g = dataclasses.replace(
        g, sh_rest=g.sh_rest.at[:150].set(jnp.asarray(
            rng.normal(0, 0.1, (150, 3, 3)).astype(np.float32))),
        scales_log=g.scales_log + jnp.asarray(
            rng.normal(0, 0.3, g.scales_log.shape).astype(np.float32)),
        quats=jnp.asarray(rng.normal(size=g.quats.shape).astype(np.float32)),
        asg=jnp.asarray(toy_asg(256, "cpu").numpy()) if hybrid else None)
    batched = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cams)
    batched = dataclasses.replace(batched, dq=jnp.asarray(
        rng.normal(0, 0.01, (N_CAMS, 4)).astype(np.float32)))
    base, g_tx, _, spec_tx = jloop.init_train_state(g, alive, batched, cfg, 3.0)
    state, txs = jcal.init_calib_state(base, cfg)
    lens = jinit_lens(hidden=24, n_blocks=2, n_layers=2, seed=3)
    lens = dataclasses.replace(
        lens, weights=[[w * 0.2 for w in blk] for blk in lens.weights],
        biases=[[jnp.asarray(rng.normal(0, 0.01, b.shape).astype(np.float32))
                 for b in blk] for blk in lens.biases])
    state = dataclasses.replace(state, lens=lens,
                                lens_opt=txs["lens"][0].init(lens))
    step = jcal.make_fisheye_train_step(setup, rcfg, cfg, g_tx, txs, 1,
                                        opt_lens=True,
                                        use_vignetting=vig_shift,
                                        spec_tx=spec_tx)
    return dict(cfg=cfg, setup=setup, p_view=np.asarray(p_view), gts=gts,
                state=state, step=step, txs=txs)


def jax_step(toy, state, idx):
    """One JAX step on camera idx; returns (state, loss, image)."""
    st, (loss, image, _, _) = toy["step"](
        state, jnp.asarray(toy["gts"][idx]), jnp.asarray(toy["p_view"]),
        jnp.asarray(idx), jnp.zeros(3))
    return st, float(loss), np.asarray(image)


def port_state(toy):
    """The port's CalibState and schedules from the JAX state before the
    first step, and its TrainConfig, setup and control points."""
    s = toy["state"]
    b = s.base
    d = _tree_np(b.g, G_FIELDS + (("asg",) if b.g.asg is not None else ()))
    d["alive"] = np.asarray(b.alive)
    g, alive = convert.gaussians_from_numpy(d, device="cpu")
    cams = convert.camera_from_numpy(_tree_np(b.cams, CAM_FIELDS), device="cpu")
    cfg = tconfig.TrainConfig.from_json(toy["cfg"].to_json())
    base = tloop.init_train_state(g, alive, cams, cfg, 3.0)
    cs, sched = convert.calib_state_from_numpy(base, cfg, {
        "lens": lens_np(s.lens), "cubemap_net": lens_np(s.cubemap_net),
        "vig": _tree_np(s.vig, ("a_k", "beta_k")),
        "shift": np.asarray(s.shift)}, device="cpu")
    c = toy["cfg"].calib
    setup = tcal.make_fisheye_setup(FOCAL, FOCAL, (WH, WH), (WH, WH),
                                    flow_scale=(2.0, 2.0),
                                    control_point_sample_scale=8,
                                    apply2gt=c.apply2gt)
    p_view = tcal.fisheye_control_points(setup, FOCAL, FOCAL, (2.0, 2.0),
                                         device="cpu")
    return cs, sched, cfg, setup, p_view


def port_step(toy, port, idx, opt_lens=True):
    cs, sched, cfg, setup, p_view = port
    return tcal.fisheye_train_step(
        cs, torch.as_tensor(toy["gts"][idx]), p_view, idx, torch.zeros(3),
        setup, TCfg(sh_degree=1), cfg, sched, opt_lens,
        toy["cfg"].calib.start_vignetting == 0)


def jax_grads(state, idx, vig_shift: bool) -> dict:
    """The gradients of a first step, mu / (1 - b1), by the port's names."""
    b = state.base
    out = {}
    for label, field in (("xyz", "xyz"), ("f_dc", "sh_dc"), ("f_rest", "sh_rest"),
                         ("opacity", "opacity_raw"), ("scaling", "scales_log"),
                         ("rotation", "quats")):
        mu = b.g_opt.inner_states[label].inner_state[0].mu
        out[f".g.{field}"] = np.asarray(getattr(mu, field)) / (1 - B1)
    if b.g.asg is not None:
        mu = b.g_opt.inner_states["asg"].inner_state[0].mu
        out[".g.asg"] = np.asarray(mu.asg) / (1 - B1)
        for k in SPEC_NAMES:
            out[f".spec.{k}"] = np.asarray(getattr(b.spec_opt[0].mu, k)) / (1 - B1)
    for f in ("dq", "dt", "fovx", "fovy"):
        out[f".cam.{f}"] = np.asarray(getattr(b.cam_opt.mu, f))[idx] / (1 - B1)
    for f in ("weights", "biases"):
        for bi, blk in enumerate(getattr(state.lens_opt.mu, f)):
            for li, t in enumerate(blk):
                out[f".lens.{f}[{bi}][{li}]"] = np.asarray(t) / (1 - B1)
    if vig_shift:
        out[".vig.a_k"] = np.asarray(state.vig_opt.mu.a_k) / (1 - B1)
        out[".vig.beta_k"] = np.asarray(state.vig_opt.mu.beta_k) / (1 - B1)
        out[".shift"] = np.asarray(state.shift_opt.mu) / (1 - B1)
    return out


# Each Gaussian group's Adam learning rate in the toy (xyz: 1.6e-4 x the
# spatial scale 3).
G_LR = {"xyz": 4.8e-4, "sh_dc": 2.5e-3, "sh_rest": 1.25e-4,
        "opacity_raw": 5e-2, "scales_log": 5e-3, "quats": 1e-3, "asg": 2.5e-3}
# The specular MLP's Adam learning rate (feature_lr, its schedule's start).
SPEC_LR = 2.5e-3


# The largest |gradient| of an entry whose sign may differ between the
# packages: ten times their largest difference in a Gaussian gradient of
# the cubemap toy's first step (1.5e-7).
GRAD_FLOOR = 1e-6


def assert_same_gaussians(g, jg, steps, atol=1e-5, rtol=1e-3, grads=None):
    """The Gaussians after `steps` steps. Adam with eps 1e-15 moves an entry
    whose gradient is at noise level by about its full learning rate in the
    direction of the noise's sign (ROADMAP.md Queue 3). After one step every
    entry must match, except, when the first step's gradients `grads` =
    (the port's, JAX's; by the port's names) are given, one whose gradient
    has another sign in each package: each such gradient must lie within
    GRAD_FLOOR of 0 in JAX, and as Adam's first update is lr x sign(g),
    the entry may be off by up to 2 x that group's learning rate. After
    more than one step up to 1 % of a field's entries may be off by more
    than the tolerance, each by at most 2 x steps x that group's learning
    rate. A hybrid model's `asg` is held so too."""
    fields = G_FIELDS + (("asg",) if jg.asg is not None else ())
    for f in fields:
        assert_same_adam_leaf(f".g.{f}", getattr(g, f), getattr(jg, f),
                              G_LR[f], steps, atol, rtol, grads)


def assert_same_adam_leaf(name, t, j, lr, steps, atol=1e-5, rtol=1e-3,
                          grads=None):
    """One Adam-trained leaf `name` of the port (`t`) against JAX's (`j`)
    after `steps` steps at learning rate `lr`, as `assert_same_gaussians`
    states it."""
    a, b = t.detach().numpy(), np.asarray(j)
    d = np.abs(a - b)
    if steps == 1:
        flip = np.zeros(a.shape, bool)
        if grads is not None:
            tg, jgrad = grads[0][name].detach().numpy(), grads[1][name]
            flip = np.sign(tg) != np.sign(jgrad)
            assert (np.abs(jgrad[flip]) <= GRAD_FLOOR).all(), name
        np.testing.assert_allclose(a[~flip], b[~flip], atol=atol, rtol=rtol,
                                   err_msg=name)
        assert d[flip].max(initial=0.0) <= 2 * lr + atol, name
        return
    off = d > atol + rtol * np.abs(b)
    assert off.sum() <= 0.01 * off.size, (name, int(off.sum()))
    assert d.max() <= 2 * steps * lr, (name, float(d.max()))


def assert_same_spec(spec, jspec, steps, atol=1e-5, rtol=1e-3, grads=None):
    """The specular MLP after `steps` steps, each weight as
    `assert_same_adam_leaf` holds it."""
    for k in SPEC_NAMES:
        assert_same_adam_leaf(f".spec.{k}", getattr(spec, k), getattr(jspec, k),
                              SPEC_LR, steps, atol, rtol, grads)


def assert_same_state(cs, js, steps=1, atol=1e-5, rtol=1e-3, grads=None):
    """Every parameter (`assert_same_gaussians`), camera, statistic and
    calibration leaf of the port's CalibState against JAX's."""
    b, jb = cs.base, js.base
    assert_same_gaussians(b.g, jb.g, steps, atol, rtol, grads)
    if jb.spec is not None:
        assert_same_spec(b.spec, jb.spec, steps, atol, rtol, grads)
        assert b.spec_opt.count == int(jb.spec_opt[0].count) == steps
    pairs = [(f".cams.{f}", getattr(b.cams, f), getattr(jb.cams, f))
              for f in CAM_FIELDS]
    pairs += [(f".stats.{f}", getattr(b.stats, f), getattr(jb.stats, f))
              for f in STAT_FIELDS]
    jl = lens_np(js.lens)
    pairs += [(f".lens.{f}[{bi}][{li}]", t, jl[f][bi][li])
              for f in LENS_FIELDS for bi, blk in enumerate(getattr(cs.lens, f))
              for li, t in enumerate(blk)]
    pairs += [(".vig.a_k", cs.vig.a_k, js.vig.a_k),
              (".vig.beta_k", cs.vig.beta_k, js.vig.beta_k),
              (".shift", cs.shift, js.shift)]
    for name, t, j in pairs:
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                                   rtol=rtol, err_msg=name)
    assert b.step == int(jb.step) == steps
    assert cs.lens_opt.count == int(js.lens_opt.count)
