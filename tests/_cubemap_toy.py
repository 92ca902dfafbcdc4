"""The toy cubemap setup shared by `test_torch_cubemap_train.py` and
`test_torch_cubemap_cli.py`: the configuration of
tests/test_calibrated_train.py:94-117 (mask radius 20, control points
every 8 pixels, lens lr 1e-7, the full-size cubemap net scaled by 1e-4),
with the camera pose trained, on a 48x48 scene of 150 Gaussians and 3
cameras of `utils/testing.cubemap_rig` inside their box, so that every
face sees content (focal 24: the forward face spans 90 degrees). JAX
renders with `backend="jnp", precision="exact"`; its jitted cubemap step
is compiled once per file."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _fisheye_toy as fish
from bags_tpu.core.camera import CameraParams as JCam
from bags_tpu.core.camera import CameraStatic as JStatic
from bags_tpu.model.gaussians import create_from_points
from bags_tpu.raster import RenderConfig as JCfg
from bags_tpu.train import calibrated as jcal
from bags_tpu.train import config as jconfig
from bags_tpu.train import loop as jloop
from bags_tpu.utils.testing import make_toy_scene as jmake
from bags_tpu_torch import convert
from bags_tpu_torch.core.camera import CameraStatic
from bags_tpu_torch.raster.render import RenderConfig as TCfg
from bags_tpu_torch.raster.render import render as trender
from bags_tpu_torch.train import calibrated as tcal
from bags_tpu_torch.train import config as tconfig
from bags_tpu_torch.train import loop as tloop
from bags_tpu_torch.utils.testing import cubemap_rig

WH, FOCAL, N_CAMS, N_PTS = 48, 24.0, 3, 150
FOV = 2 * np.arctan(WH / (2 * FOCAL))
B1 = fish.B1


def build() -> dict:
    """The JAX side: config, the GT of each camera (the port's render of
    the true scene, shared as numpy), the CalibState before the first step
    with its sub-camera poses, and the jitted step."""
    cfg = jconfig.TrainConfig(
        opt=jconfig.OptimizationConfig(densify_from_iter=10_000,
                                       position_lr_max_steps=200),
        calib=jconfig.CalibConfig(
            opt_cam=True, opt_intrinsic=True, r_t_lr=(0.003, 0.003),
            cubemap=True, mask_radius=20, control_point_sample_scale=8,
            iresnet_lr=1e-7, banded_warp=False),
        max_instances=2 ** 14)
    cfg.model.sh_degree = 1
    # A tile holds at most one instance of each of the 256 slots, so the
    # jnp compositor's per-tile scan stops at 256 (its default 4,096 costs
    # 16x the time for the same result).
    rcfg = JCfg(sh_degree=1, backend="jnp", precision="exact",
                max_instances=2 ** 14, max_per_tile=256)
    rng = np.random.default_rng(11)
    sc = jmake(n=N_PTS, width=WH, height=WH, sh_degree=1, seed=11)
    cams = [JCam.create(R, t, FOV, FOV) for R, t in cubemap_rig(N_CAMS)]
    tsc = {k: torch.as_tensor(np.array(sc[k]))
           for k in ("xyz", "scales", "quats", "opacity", "sh_coeffs")}
    gts = np.stack([trender(*tsc.values(), convert.camera_from_numpy(
        {f: np.asarray(getattr(c, f)) for f in fish.CAM_FIELDS}, "cpu"),
        CameraStatic(WH, WH), TCfg(sh_degree=1)).render.numpy() for c in cams])
    pts = np.asarray(sc["xyz"]) + rng.normal(0, 0.05, (N_PTS, 3)).astype(np.float32)
    cols = rng.uniform(0.2, 0.8, (N_PTS, 3)).astype(np.float32)
    g, alive = create_from_points(pts, cols, 256, sh_degree=1)
    g = dataclasses.replace(
        g, sh_rest=g.sh_rest.at[:N_PTS].set(jnp.asarray(
            rng.normal(0, 0.1, (N_PTS, 3, 3)).astype(np.float32))),
        scales_log=g.scales_log + jnp.asarray(
            rng.normal(0, 0.3, g.scales_log.shape).astype(np.float32)),
        quats=jnp.asarray(rng.normal(size=g.quats.shape).astype(np.float32)))
    batched = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cams)
    batched = dataclasses.replace(batched, dq=jnp.asarray(
        rng.normal(0, 0.01, (N_CAMS, 4)).astype(np.float32)))
    base, g_tx, _, _ = jloop.init_train_state(g, alive, batched, cfg, 3.0)
    state, txs = jcal.init_calib_state(base, cfg)
    cub = jax.tree_util.tree_map(lambda x: x * 1e-4, state.cubemap_net)
    state = dataclasses.replace(state, cubemap_net=cub,
                                cubemap_opt=txs["cubemap"][0].init(cub))
    subs = jcal.build_sub_cameras(state.base.cams)
    sub_q = np.asarray(jnp.stack([s.q_init for s in subs[:4]], axis=1))
    sub_t = np.asarray(jnp.stack([s.t_init for s in subs[:4]], axis=1))
    step = jcal.make_cubemap_train_step(JStatic(WH, WH), rcfg, cfg, g_tx, txs,
                                        1, FOCAL, FOCAL)
    return dict(cfg=cfg, rcfg=rcfg, gts=gts, state=state, step=step, txs=txs,
                sub_q=sub_q, sub_t=sub_t)


def jax_step(toy, state, idx):
    """One JAX step on camera idx; returns (state, loss, faces[0])."""
    st, (loss, face0, _, _) = toy["step"](
        state, jnp.asarray(toy["gts"][idx]), jnp.asarray(idx), jnp.zeros(3),
        jnp.asarray(toy["sub_q"][idx]), jnp.asarray(toy["sub_t"][idx]))
    return st, float(loss), np.asarray(face0)


def port_state(toy):
    """The port's CalibState, schedules, TrainConfig and CubemapSetup from
    the JAX state before the first step."""
    s = toy["state"]
    b = s.base
    d = fish._tree_np(b.g, fish.G_FIELDS)
    d["alive"] = np.asarray(b.alive)
    g, alive = convert.gaussians_from_numpy(d, device="cpu")
    cams = convert.camera_from_numpy(fish._tree_np(b.cams, fish.CAM_FIELDS),
                                     device="cpu")
    cfg = tconfig.TrainConfig.from_json(toy["cfg"].to_json())
    base = tloop.init_train_state(g, alive, cams, cfg, 3.0)
    cs, sched = convert.calib_state_from_numpy(base, cfg, {
        "lens": fish.lens_np(s.lens), "cubemap_net": fish.lens_np(s.cubemap_net),
        "vig": fish._tree_np(s.vig, ("a_k", "beta_k")),
        "shift": np.asarray(s.shift)}, device="cpu")
    setup = tcal.make_cubemap_setup(CameraStatic(WH, WH), FOCAL, FOCAL, cfg)
    return cs, sched, cfg, setup


def port_step(toy, port, idx):
    cs, sched, cfg, setup = port
    return tcal.cubemap_train_step(
        cs, torch.as_tensor(toy["gts"][idx]), idx, torch.zeros(3),
        torch.tensor(toy["sub_q"][idx]), torch.tensor(toy["sub_t"][idx]),
        setup, TCfg(sh_degree=1), cfg, sched)


def jax_grads(state, idx) -> dict:
    """The gradients of a first step, mu / (1 - b1), by the port's names:
    the Gaussians, the camera row and the cubemap net."""
    out = {k: v for k, v in fish.jax_grads(state, idx, vig_shift=False).items()
           if not k.startswith(".lens")}
    for f in ("weights", "biases"):
        for bi, blk in enumerate(getattr(state.cubemap_opt.mu, f)):
            for li, t in enumerate(blk):
                out[f".cubemap_net.{f}[{bi}][{li}]"] = np.asarray(t) / (1 - B1)
    return out


def assert_same_cubemap(cs, js, atol=1e-5, rtol=1e-3):
    """The cubemap net and its moments of the port's state against JAX's."""
    jn, jmu = fish.lens_np(js.cubemap_net), fish.lens_np(js.cubemap_opt.mu)
    for f in ("weights", "biases"):
        for b, blk in enumerate(getattr(cs.cubemap_net, f)):
            for l, t in enumerate(blk):
                k = f".{f}[{b}][{l}]"
                np.testing.assert_allclose(t.detach().numpy(), jn[f][b][l],
                                           atol=atol, rtol=rtol, err_msg=k)
                np.testing.assert_allclose(cs.cubemap_opt.mu[k].numpy(),
                                           jmu[f][b][l], atol=atol, rtol=rtol,
                                           err_msg=k)
    assert cs.cubemap_opt.count == int(js.cubemap_opt.count)
