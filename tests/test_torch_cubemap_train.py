"""Port parity, the cubemap train step against `bags_tpu`'s (CPU): the
sub-cameras, one step (loss, the warped forward face, every gradient and
the state), three steps, the cubemap net's NaN guard, and the calibrated
checkpoint's cubemap leaves read across the packages. JAX's jitted step is
compiled once here (`_cubemap_toy.py`); the evaluation and the CLIs are
`test_torch_cubemap_cli.py`, so that the two compiles run on different
workers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _cubemap_toy as cube
import _fisheye_toy as fish
from bags_tpu.train import calibrated as jcal
from bags_tpu.train import checkpoint as jckpt
from bags_tpu_torch import convert
from bags_tpu_torch.train import calibrated as tcal
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

IDX = 1


@pytest.fixture(scope="module")
def toy():
    return cube.build()


@pytest.fixture(scope="module")
def one_step(toy):
    """JAX's first step on camera IDX (this compiles it) and the port's."""
    js, jloss, jface = cube.jax_step(toy, toy["state"], IDX)
    port = cube.port_state(toy)
    m = cube.port_step(toy, port, IDX)
    return js, jloss, jface, port, m


def test_build_sub_cameras_matches_jax(toy):
    """The five sub-camera batches of the noisy cameras (q_init + dq): base
    poses at atol 1e-6, the FoVs kept; `sub_camera_poses` stacks the first
    four as the JAX trainer does."""
    cams = convert.camera_from_numpy(
        fish._tree_np(toy["state"].base.cams, fish.CAM_FIELDS), device="cpu")
    jsubs = jcal.build_sub_cameras(toy["state"].base.cams)
    tsubs = tcal.build_sub_cameras(cams)
    assert len(tsubs) == len(jsubs) == 5
    for t, j in zip(tsubs, jsubs):
        for f in ("q_init", "t_init", "fovx", "fovy"):
            np.testing.assert_allclose(getattr(t, f).numpy(),
                                       np.asarray(getattr(j, f)), atol=1e-6)
        assert not t.dq.any() and not t.dt.any()
    q, t = tcal.sub_camera_poses(cams)
    np.testing.assert_allclose(q.numpy(), toy["sub_q"], atol=1e-6)
    np.testing.assert_allclose(t.numpy(), toy["sub_t"], atol=1e-6)


def test_cubemap_step_matches_jax(one_step):
    """Loss and the warped forward face (atol 2e-5), every gradient (the
    Gaussians, the camera row, the cubemap net; atol 1e-5, rtol 1e-3), and
    every leaf of the state after the step, the Gaussians as
    `assert_same_gaussians` allows after a first step given both
    packages' gradients: the five renders' sums leave some gradient
    entries so near 0 that their sign, and so their first Adam update,
    differs between the packages."""
    js, jloss, jface, port, m = one_step
    np.testing.assert_allclose(float(m.loss), jloss, atol=2e-5)
    assert m.image.shape == jface.shape == (3, cube.WH, cube.WH)
    np.testing.assert_allclose(m.image.numpy(), jface, atol=2e-5)
    want = cube.jax_grads(js, IDX)
    assert set(want) <= set(m.grads), sorted(set(want) - set(m.grads))
    for name, w in want.items():
        np.testing.assert_allclose(m.grads[name].detach().numpy(), w, atol=1e-5,
                                   rtol=1e-3, err_msg=name)
        assert np.abs(w).max() > 0, f"{name}: zero gradient"
    fish.assert_same_state(port[0], js, grads=(m.grads, want))
    cube.assert_same_cubemap(port[0], js)


def _step_grads(js, prev, idx):
    """JAX's gradients of the step that took `prev` to `js`, from the Adam
    moments: g = (mu - b1 mu_prev) / (1 - b1), the camera row's from that
    row's moments."""
    out = {}
    for name, mu in cube.jax_grads(js, idx).items():
        before = cube.jax_grads(prev, idx)[name]
        first = name.startswith(".cam.") and int(prev.base.cam_opt.count[idx]) == 0
        out[name] = mu - (0 if first else cube.B1 * before)
    return out


def test_three_steps_match_jax(toy):
    """Three steps on cameras 1, 0, 2: after each, the loss and the forward
    face (atol 2e-5) and every gradient (atol 1e-5, rtol 1e-3; JAX's from
    its moments); after the three, the state as `assert_same_state`
    allows and the cubemap net and its moments."""
    js, port = toy["state"], cube.port_state(toy)
    for idx in (1, 0, 2):
        prev = js
        js, jloss, jface = cube.jax_step(toy, js, idx)
        m = cube.port_step(toy, port, idx)
        np.testing.assert_allclose(float(m.loss), jloss, atol=2e-5)
        np.testing.assert_allclose(m.image.numpy(), jface, atol=2e-5)
        for name, w in _step_grads(js, prev, idx).items():
            np.testing.assert_allclose(m.grads[name].detach().numpy(), w,
                                       atol=1e-5, rtol=1e-3,
                                       err_msg=f"camera {idx}: {name}")
    fish.assert_same_state(port[0], js, steps=3)
    cube.assert_same_cubemap(port[0], js)
    cub0 = fish.lens_np(toy["state"].cubemap_net)["weights"][0][0]
    assert np.abs(np.asarray(js.cubemap_net.weights[0][0]) - cub0).max() > 0


def _jax_tree(template, named):
    """A JAX IResNetParams shaped as `template` holding copies of the
    port's tensors `named` by path (zeros where `named` has none: the
    u_vecs' moments)."""
    return type(template)(**{f: [[jnp.asarray(
        np.array(named[f".{f}[{b}][{l}]"].detach().numpy())
        if f".{f}[{b}][{l}]" in named
        else np.zeros(np.shape(t), np.float32)) for l, t in enumerate(blk)]
        for b, blk in enumerate(getattr(template, f))]
        for f in ("weights", "biases", "u_vecs")})


def test_nan_guard_zeroes_cubemap_gradients(toy, one_step):
    """A non-finite cubemap gradient (a hook turns one entry into NaN):
    every cubemap gradient counts as zero, the moments still step (count 2)
    and the net moves by the decayed first moment, exactly as optax's
    update of zero gradients does from the port's own net and moments after
    its first step; the Gaussians and the camera still step."""
    js1 = one_step[0]
    port = cube.port_state(toy)
    cube.port_step(toy, port, IDX)
    cs = port[0]
    jnet1 = _jax_tree(js1.cubemap_net, cs.cubemap_net.named_tensors())
    jopt1 = type(js1.cubemap_opt)(count=jnp.asarray(1, jnp.int32),
                                  mu=_jax_tree(js1.cubemap_net, cs.cubemap_opt.mu),
                                  nu=_jax_tree(js1.cubemap_net, cs.cubemap_opt.nu))

    def poison(g):
        g = g.clone()
        g.view(-1)[0] = float("nan")
        return g

    handle = cs.cubemap_net.weights[1][0].register_hook(poison)
    xyz_before = cs.base.g.xyz.detach().clone()
    dq_before = cs.base.cams.dq[0].clone()
    m = cube.port_step(toy, port, 0)
    handle.remove()
    assert torch.isnan(m.grads[".cubemap_net.weights[1][0]"]).any()
    assert torch.isfinite(m.loss)
    assert not torch.equal(cs.base.g.xyz, xyz_before)
    assert not torch.equal(cs.base.cams.dq[0], dq_before)
    tx, sched = toy["txs"]["cubemap"]
    upd, jopt = tx.update(jax.tree_util.tree_map(jnp.zeros_like, jnet1), jopt1)
    lr = sched(1)
    jnet = jax.tree_util.tree_map(lambda p, u: p - lr * u, jnet1, upd)
    assert cs.cubemap_opt.count == int(jopt.count) == 2
    jl, jmu = fish.lens_np(jnet), fish.lens_np(jopt.mu)
    before = fish.lens_np(jnet1)
    for f in ("weights", "biases"):
        for b, blk in enumerate(getattr(cs.cubemap_net, f)):
            for l, t in enumerate(blk):
                k = f".{f}[{b}][{l}]"
                np.testing.assert_allclose(cs.cubemap_opt.mu[k].numpy(),
                                           jmu[f][b][l], atol=0, rtol=1e-6,
                                           err_msg=k)
                np.testing.assert_allclose(t.detach().numpy(), jl[f][b][l],
                                           atol=1e-12, rtol=1e-6, err_msg=k)
                if f == "weights":
                    assert not np.array_equal(t.detach().numpy(),
                                              before[f][b][l]), k


def test_cubemap_checkpoint_across_packages(toy, one_step, tmp_path):
    """JAX's checkpoint of its state after the step restores into the port
    (model, cameras, the cubemap net and its moments and count, bit for
    bit; `with_optimizer=False`: the Gaussians' and cameras' optimizer
    states are each package's own); the port's checkpoint of its state restores in JAX: every leaf
    the port writes under a JAX name is one of the JAX state's, of the same
    shape, and JAX's `load_checkpoint` of the port's leaves (its optimizer
    leaves, which the port keeps in its own layout, from JAX's own
    checkpoint) gives the port's cubemap net, moments and Gaussians."""
    js, _, _, port, _ = one_step
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(jpath, js)
    cs = cube.port_state(toy)[0]
    tcal.load_calib_checkpoint(jpath, cs, with_optimizer=False)
    fish.assert_same_state(cs, js, atol=0, rtol=0)
    cube.assert_same_cubemap(cs, js, atol=0, rtol=0)
    jnu = fish.lens_np(js.cubemap_opt.nu)
    np.testing.assert_array_equal(cs.cubemap_opt.nu[".weights[2][1]"].numpy(),
                                  jnu["weights"][2][1])

    tpath = str(tmp_path / "port.npz")
    tcal.save_calib_checkpoint(tpath, port[0])
    tdata = dict(np.load(tpath))
    jnames = dict(jckpt._named_leaves(js))
    ported = {k[3:]: v for k, v in tdata.items() if k.startswith("v2|")}
    for name, arr in ported.items():
        assert name in jnames, name
        assert np.shape(jnames[name]) == arr.shape, name
    assert sum(k.startswith(".cubemap_net.") for k in ported) == 3 * 5 * 5
    merged = dict(np.load(jpath))
    merged.update({"v2|" + k: v for k, v in ported.items()})
    mpath = str(tmp_path / "merged.npz")
    np.savez(mpath, **merged)
    back = jckpt.load_checkpoint(mpath, js)
    cube.assert_same_cubemap(port[0], back, atol=0, rtol=0)
    np.testing.assert_array_equal(np.asarray(back.base.g.xyz),
                                  port[0].base.g.xyz.detach().numpy())
    np.testing.assert_array_equal(np.asarray(back.base.cams.dq),
                                  port[0].base.cams.dq.numpy())
