"""Port parity, the hybrid and MCMC training steps against `bags_tpu` (CPU;
JAX with `backend="jnp", precision="exact"` and the gather warp):

  * three `--hybrid --mcmc` pose steps (the specular colour and the
    opacity and scale regularisers), with one MCMC relocation and one
    position-noise step between the second and the third under the same
    injected draws and normal draws in both packages;
  * one `--hybrid` fisheye step (`tests/_fisheye_toy.py`'s apply2render
    toy with ASG features);
  * the hybrid fisheye checkpoint: the port's leaf names are the JAX
    template's, but for the optimizer states the port keeps in its own
    layout, and a JAX checkpoint's ASG features, specular MLP and its Adam
    state load into the port.

JAX jit-compiles one pose step and one fisheye step (and the small
relocation, noise and render functions); each is used by every test here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _fisheye_toy as fish
from bags_tpu.core.camera import CameraParams as JCam
from bags_tpu.model import mcmc as jmcmc
from bags_tpu.model.gaussians import create_from_points
from bags_tpu.raster import RenderConfig as JCfg
from bags_tpu.raster import render as jrender
from bags_tpu.train import checkpoint as jckpt
from bags_tpu.train import config as jconfig
from bags_tpu.train import loop as jloop
from bags_tpu_torch import convert
from bags_tpu_torch.core.camera import CameraStatic
from bags_tpu_torch.model import mcmc as tmcmc
from bags_tpu_torch.raster.render import RenderConfig as TCfg
from bags_tpu_torch.raster.render import render as trender
from bags_tpu_torch.train import calibrated as tcal
from bags_tpu_torch.train import config as tconfig
from bags_tpu_torch.train import loop as tloop
from bags_tpu_torch.utils.testing import make_toy_scene as tmake
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CAP, N_PTS, WH, N_CAMS = 256, 200, 48, 3
N_DEAD = 6
B1 = fish.B1
G_FIELDS = fish.G_FIELDS + ("asg",)


@pytest.fixture(scope="module")
def pose():
    """The pose toy in JAX: 200 SH-1 Gaussians (6 of them under the 0.005
    opacity floor) with ASG features in a capacity of 256, 3 rotated
    cameras with noised dq, the GT the port's render of the true scene;
    the state before the first step, the jitted train step, relocation,
    noise and a render with the specular colour."""
    rng = np.random.default_rng(3)
    sc = tmake(n=N_PTS, width=WH, height=WH, sh_degree=0, seed=3, device="cpu")
    static = sc["static"]
    cams, gts = [], []
    for i in range(N_CAMS):
        a = 0.06 * (i - 1)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]], np.float32)
        cams.append(JCam.create(R, np.zeros(3, np.float32), 0.8, 0.8))
        tc = convert.camera_from_numpy(fish._tree_np(cams[-1], fish.CAM_FIELDS),
                                       device="cpu")
        with torch.no_grad():
            gts.append(trender(*[sc[k] for k in ("xyz", "scales", "quats",
                                                 "opacity", "sh_coeffs")],
                               tc, static, TCfg(sh_degree=0)).render.numpy())
    pts = sc["xyz"].numpy() + rng.normal(0, 0.05, (N_PTS, 3)).astype(np.float32)
    cols = rng.uniform(0.2, 0.8, (N_PTS, 3)).astype(np.float32)
    g, alive = create_from_points(pts, cols, CAP, sh_degree=1)
    dead = rng.choice(N_PTS, N_DEAD, replace=False)
    g = dataclasses.replace(
        g, sh_rest=g.sh_rest.at[:N_PTS].set(jnp.asarray(
            rng.normal(0, 0.1, (N_PTS, 3, 3)).astype(np.float32))),
        opacity_raw=g.opacity_raw.at[dead].set(-6.0),
        # anisotropic and rotated, so that every field has a gradient
        scales_log=g.scales_log + jnp.asarray(
            rng.normal(0, 0.3, g.scales_log.shape).astype(np.float32)),
        quats=jnp.asarray(rng.normal(size=g.quats.shape).astype(np.float32)),
        asg=jnp.asarray(fish.toy_asg(CAP, "cpu").numpy()))
    batched = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cams)
    batched = dataclasses.replace(batched, dq=jnp.asarray(
        rng.normal(0, 0.01, (N_CAMS, 4)).astype(np.float32)))
    cfg = jconfig.TrainConfig(
        opt=jconfig.OptimizationConfig(position_lr_max_steps=200),
        calib=jconfig.CalibConfig(opt_cam=True, opt_intrinsic=True,
                                  r_t_lr=(0.003, 0.003), hybrid=True),
        mcmc=True, max_instances=2 ** 14)
    cfg.model.sh_degree = 1
    rcfg = JCfg(sh_degree=1, backend="jnp", precision="exact",
                max_instances=2 ** 14, max_per_tile=CAP)   # a tile <= CAP
    state, g_tx, align_tx, spec_tx = jloop.init_train_state(g, alive, batched,
                                                            cfg, 3.0)
    step = jloop.make_train_step(static, rcfg, cfg, g_tx, align_tx, 1,
                                 spec_tx=spec_tx)

    @jax.jit
    def image(st, idx):
        from bags_tpu.calib.specular import specular_extra_color
        cam = jax.tree_util.tree_map(lambda x: x[idx], st.cams)
        gg = st.g
        extra = specular_extra_color(st.spec, gg.xyz, gg.asg, cam, st.align)
        return jrender(gg.xyz, gg.scaling(), gg.quats, gg.opacity(st.alive),
                       gg.sh_coeffs(), cam, static, rcfg, bg=jnp.zeros(3),
                       align=st.align, extra_color=extra).render

    return dict(state=state, step=step, image=image, gt=np.stack(gts), cfg=cfg,
                static=static, dead=np.sort(dead),
                mcmc=jloop.make_mcmc_step(cfg, None),
                noise=jloop.make_mcmc_noise_step(cfg, 3.0))


def _port_pose(toy):
    s = toy["state"]
    d = fish._tree_np(s.g, G_FIELDS)
    d["alive"] = np.asarray(s.alive)
    g, alive = convert.gaussians_from_numpy(d, device="cpu")
    cams = convert.camera_from_numpy(fish._tree_np(s.cams, fish.CAM_FIELDS),
                                     device="cpu")
    cfg = tconfig.TrainConfig.from_json(toy["cfg"].to_json())
    return tloop.init_train_state(g, alive, cams, cfg, 3.0), cfg


def _jax_pose_grads(js, prev, idx):
    """JAX's gradients of the step that took `prev` to `js`, by the port's
    names, from the Adam moments: g = (mu - b1 mu_prev) / (1 - b1)."""
    def mus(st):
        out = {}
        for label, field in (("xyz", "xyz"), ("f_dc", "sh_dc"),
                             ("f_rest", "sh_rest"), ("opacity", "opacity_raw"),
                             ("scaling", "scales_log"), ("rotation", "quats"),
                             ("asg", "asg")):
            mu = st.g_opt.inner_states[label].inner_state[0].mu
            out[f".g.{field}"] = np.asarray(getattr(mu, field))
        for k in fish.SPEC_NAMES:
            out[f".spec.{k}"] = np.asarray(getattr(st.spec_opt[0].mu, k))
        for f in ("dq", "dt", "fovx", "fovy"):
            out[f".cam.{f}"] = np.asarray(getattr(st.cam_opt.mu, f))[idx]
        return out
    now, before = mus(js), mus(prev)
    return {k: (v - B1 * before[k]) / (1 - B1) for k, v in now.items()}


def _check_pose_step(toy, js, prev, jm, tm, idx, steps, tstate):
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), atol=2e-5)
    jimg = np.asarray(toy["image"](prev, jnp.asarray(idx)))
    np.testing.assert_allclose(tm.image.numpy(), jimg, atol=2e-5)
    want = _jax_pose_grads(js, prev, idx)
    assert set(want) <= set(tm.grads), sorted(set(want) - set(tm.grads))
    for name, w in want.items():
        np.testing.assert_allclose(tm.grads[name].detach().numpy(), w,
                                   atol=1e-5, rtol=1e-3,
                                   err_msg=f"step {steps}: {name}")
        assert np.abs(w).max() > 0, f"{name}: zero gradient"
    grads = (tm.grads, want) if steps == 1 else None
    fish.assert_same_gaussians(tstate.g, js.g, steps, grads=grads)
    fish.assert_same_spec(tstate.spec, js.spec, steps, grads=grads)
    for f in fish.CAM_FIELDS:
        np.testing.assert_allclose(getattr(tstate.cams, f).numpy(),
                                   np.asarray(getattr(js.cams, f)),
                                   atol=1e-5, rtol=1e-3, err_msg=f)
    for f in fish.STAT_FIELDS:
        np.testing.assert_allclose(getattr(tstate.stats, f).numpy(),
                                   np.asarray(getattr(js.stats, f)),
                                   atol=1e-5, rtol=1e-3, err_msg=f)
    np.testing.assert_array_equal(tstate.alive.numpy(), np.asarray(js.alive))
    assert tstate.step == int(js.step) == steps
    assert tstate.spec_opt.count == int(js.spec_opt[0].count) == steps


def test_hybrid_mcmc_pose_steps_match_jax(pose, monkeypatch):
    """Steps on cameras 1 and 0, then `mcmc_step` (the 6 dead relocated onto
    injected sources drawn with repeats; the live count grows 200 -> 201,
    float32's target) and `mcmc_noise_step` (JAX's normal draws from its
    key), then a step on camera 2. After each step: loss and image (atol
    2e-5), every gradient, `asg` and the specular weights included (atol
    1e-5, rtol 1e-3), and the state as `tests/_fisheye_toy.py` holds it
    (the Gaussians after more than one step with its 1 % allowance);
    after the relocation the counts, the reset slots and alive exactly."""
    toy = pose
    bg = torch.zeros(3)
    static = CameraStatic(WH, WH)
    js, (tstate, tcfg) = toy["state"], _port_pose(toy)
    for steps, idx in ((1, 1), (2, 0)):
        prev = js
        js, jm = toy["step"](js, jnp.asarray(toy["gt"][idx]), jnp.asarray(idx),
                             jnp.zeros(3))
        tm = tloop.train_step(tstate, torch.as_tensor(toy["gt"][idx]), idx, bg,
                              static, TCfg(sh_degree=1), tcfg)
        _check_pose_step(toy, js, prev, jm, tm, idx, steps, tstate)

    rng = np.random.default_rng(9)
    live = np.setdiff1d(np.arange(N_PTS), toy["dead"])
    reloc = rng.choice(live[:3], N_DEAD)
    grow = rng.choice(np.arange(N_PTS), 1)
    jdraws, tdraws = [reloc, grow], [reloc, grow]
    monkeypatch.setattr(jmcmc, "_sample_by_opacity", lambda key, g, a, num: jnp.asarray(
        np.concatenate([jdraws.pop(0), np.zeros(CAP, int)])[:CAP]))
    monkeypatch.setattr(tmcmc, "_sample_by_opacity",
                        lambda gen, g, a, num: torch.as_tensor(tdraws.pop(0)))
    before = {f: getattr(tstate.g, f).detach().clone() for f in G_FIELDS}
    js, (jn_rel, jn_add) = toy["mcmc"](js)
    n_rel, n_add = tloop.mcmc_step(tstate, tcfg)
    assert not jdraws and not tdraws
    assert (n_rel, n_add) == (int(jn_rel), int(jn_add)) == (N_DEAD, 1)
    np.testing.assert_array_equal(tstate.alive.numpy(), np.asarray(js.alive))
    assert int(tstate.alive.sum()) == N_PTS + 1       # float32's 201
    for f in ("xyz", "sh_dc", "sh_rest", "quats", "asg"):   # rank i <- draw i
        assert torch.equal(getattr(tstate.g, f)[toy["dead"]], before[f][reloc]), f
        assert torch.equal(getattr(tstate.g, f)[N_PTS], before[f][grow[0]]), f
    reset = np.union1d(np.union1d(toy["dead"], reloc), [N_PTS, grow[0]])
    for p in tstate.g_opt.param_groups:
        mu = tstate.g_opt.state[p["params"][0]]["exp_avg"]
        assert not mu[reset].any() and mu.any(), p["name"]
    eps = jax.random.normal(jax.random.split(js.key)[1], (CAP, 3))
    js = toy["noise"](js)
    tloop.mcmc_noise_step(tstate, tcfg, torch.as_tensor(np.array(eps)))
    fish.assert_same_gaussians(tstate.g, js.g, 2)

    prev, idx = js, 2
    js, jm = toy["step"](js, jnp.asarray(toy["gt"][idx]), jnp.asarray(idx),
                         jnp.zeros(3))
    tm = tloop.train_step(tstate, torch.as_tensor(toy["gt"][idx]), idx, bg,
                          static, TCfg(sh_degree=1), tcfg)
    _check_pose_step(toy, js, prev, jm, tm, idx, 3, tstate)


@pytest.fixture(scope="module")
def fisheye():
    """JAX's hybrid fisheye toy, its first step on camera 1 (this compiles
    it) and the port's."""
    toy = fish.build(apply2gt=False, vig_shift=False, hybrid=True)
    js, jloss, jimg = fish.jax_step(toy, toy["state"], 1)
    port = fish.port_state(toy)
    m = fish.port_step(toy, port, 1)
    return toy, js, jloss, jimg, port, m


def test_hybrid_fisheye_step_matches_jax(fisheye):
    """Loss and warped image (atol 2e-5), every gradient, `asg` and the
    specular weights included (atol 1e-5, rtol 1e-3), and the state after
    the step, the specular MLP and its count included."""
    toy, js, jloss, jimg, port, m = fisheye
    np.testing.assert_allclose(float(m.loss), jloss, atol=2e-5)
    np.testing.assert_allclose(m.image.numpy(), jimg, atol=2e-5)
    want = fish.jax_grads(js, 1, vig_shift=False)
    assert {".g.asg", ".spec.feat_w", ".spec.b3"} <= set(want)
    assert set(want) <= set(m.grads), sorted(set(want) - set(m.grads))
    for name, w in want.items():
        np.testing.assert_allclose(m.grads[name].detach().numpy(), w, atol=1e-5,
                                   rtol=1e-3, err_msg=name)
        assert np.abs(w).max() > 0, f"{name}: zero gradient"
    fish.assert_same_state(port[0], js, grads=(m.grads, want))


# Leaves of the JAX state that the port keeps in its own layout (under
# "torch|" names) or does not have (the JAX PRNG key).
JAX_ONLY = (".base.g_opt", ".base.cam_opt", ".base.align_opt", ".base.key")


def test_hybrid_checkpoint_names_and_jax_load(fisheye, tmp_path):
    """The port's checkpoint of its hybrid fisheye state after the step
    names exactly the JAX template's leaves but JAX_ONLY, each in its
    shape, `.base.g.asg`, `.base.spec.*` and `.base.spec_opt...` among
    them; it restores in the port bit for bit; and JAX's checkpoint loads
    into a port template (`with_optimizer=False`): the state as
    `assert_same_state` holds it at 0 tolerance, the specular moments
    exactly."""
    toy, js, _, _, port, _ = fisheye
    tpath = str(tmp_path / "port.npz")
    tcal.save_calib_checkpoint(tpath, port[0])
    tdata = np.load(tpath)
    ported = {k[3:]: tdata[k].shape for k in tdata.files if k.startswith("v2|")}
    jnames = {n: np.shape(l) for n, l in jckpt._named_leaves(js)
              if not n.startswith(JAX_ONLY)}
    assert ported == jnames
    assert {".base.g.asg", ".base.spec.w2", ".base.spec_opt[0].mu.feat_w",
            ".base.spec_opt[0].nu.b3", ".base.spec_opt[1].count"} <= set(ported)

    back = fish.port_state(toy)[0]
    tcal.load_calib_checkpoint(tpath, back)
    for k, t in port[0].base.spec.named_tensors().items():
        assert torch.equal(back.base.spec.named_tensors()[k], t), k
        assert torch.equal(back.base.spec_opt.nu[k], port[0].base.spec_opt.nu[k]), k
    assert torch.equal(back.base.g.asg, port[0].base.g.asg)
    assert back.base.spec_opt.count == 1

    jpath = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(jpath, js)
    cs = fish.port_state(toy)[0]
    tcal.load_calib_checkpoint(jpath, cs, with_optimizer=False)
    fish.assert_same_state(cs, js, atol=0, rtol=0)
    for k in fish.SPEC_NAMES:
        np.testing.assert_array_equal(cs.base.spec_opt.mu[f".{k}"].numpy(),
                                      np.asarray(getattr(js.base.spec_opt[0].mu, k)))
