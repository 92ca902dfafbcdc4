"""Port parity, the fisheye train step in the apply2render direction, with
vignetting and the entrance-pupil shift on: one step (loss, warped image
and every gradient), three steps of state, and the CalibState checkpoint
(round trip, and a JAX checkpoint's calibration leaves loading into the
port). JAX's step is compiled once, here; the apply2gt direction is
`test_torch_calibrated_gt.py` (another file, so that the two compiles run
on different workers)."""

import numpy as np
import pytest
import torch

import _fisheye_toy as toy_lib
from bags_tpu.train.checkpoint import save_checkpoint as jsave
from bags_tpu_torch.train import calibrated as tcal
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

IDX = 1


@pytest.fixture(scope="module")
def toy():
    return toy_lib.build(apply2gt=False, vig_shift=True)


@pytest.fixture(scope="module")
def one_step(toy):
    """JAX's first step on camera IDX (this compiles it) and the port's."""
    js, jloss, jimg = toy_lib.jax_step(toy, toy["state"], IDX)
    port = toy_lib.port_state(toy)
    m = toy_lib.port_step(toy, port, IDX)
    return js, jloss, jimg, port, m


def test_fisheye_step_matches_jax(one_step):
    """Loss and warped image (atol 2e-5), and every gradient: the
    Gaussians, the camera row (pose and FoV), the lens, vignetting and the
    shift (atol 1e-5, rtol 1e-3)."""
    js, jloss, jimg, port, m = one_step
    np.testing.assert_allclose(float(m.loss), jloss, atol=2e-5)
    assert m.image.shape == jimg.shape == (3, 48, 48)
    np.testing.assert_allclose(m.image.numpy(), jimg, atol=2e-5)
    want = toy_lib.jax_grads(js, IDX, vig_shift=True)
    assert set(want) <= set(m.grads), sorted(set(want) - set(m.grads))
    for name, w in want.items():
        np.testing.assert_allclose(m.grads[name].detach().numpy(), w, atol=1e-5,
                                   rtol=1e-3, err_msg=name)
        assert np.abs(w).max() > 0, f"{name}: zero gradient"
    toy_lib.assert_same_state(port[0], js)


def test_three_steps_match_jax(toy):
    """The state after three steps on cameras 1, 0, 2: the losses (atol
    2e-5), the Gaussians as `assert_same_gaussians` allows, the cameras,
    statistics, lens, vignetting and shift (atol 1e-5, rtol 1e-3)."""
    js, port = toy["state"], toy_lib.port_state(toy)
    losses = []
    for idx in (1, 0, 2):
        js, jloss, _ = toy_lib.jax_step(toy, js, idx)
        m = toy_lib.port_step(toy, port, idx)
        losses.append((float(m.loss), jloss))
    np.testing.assert_allclose(*zip(*losses), atol=2e-5)
    toy_lib.assert_same_state(port[0], js, steps=3)
    lens0 = toy_lib.lens_np(toy["state"].lens)["weights"][0][0]
    assert np.abs(np.asarray(js.lens.weights[0][0]) - lens0).max() > 1e-5


def test_checkpoint_round_trip(toy, one_step, tmp_path):
    """save / load of the port's CalibState after a step: every leaf back,
    the lens moments and counts, the u_vecs' moments written as zeros."""
    _, _, _, port, _ = one_step
    cs = port[0]
    path = str(tmp_path / "chkpnt1.npz")
    tcal.save_calib_checkpoint(path, cs)
    data = np.load(path)
    assert not data["v2|.lens_opt.mu.u_vecs[0][0]"].any()
    assert int(data["v2|.lens_opt.count"]) == 1
    fresh = toy_lib.port_state(toy)[0]
    tcal.load_calib_checkpoint(path, fresh)
    for a, b in ((fresh.base.g.xyz, cs.base.g.xyz), (fresh.shift, cs.shift),
                 (fresh.vig.beta_k, cs.vig.beta_k), (fresh.base.cams.dq, cs.base.cams.dq)):
        assert torch.equal(a, b)
    for (ka, a), (kb, b) in zip(fresh.lens.named_tensors().items(),
                                cs.lens.named_tensors().items()):
        assert ka == kb and torch.equal(a, b), ka
    for k in cs.lens_opt.mu:
        assert torch.equal(fresh.lens_opt.mu[k], cs.lens_opt.mu[k])
        assert torch.equal(fresh.lens_opt.nu[k], cs.lens_opt.nu[k])
    assert (fresh.lens_opt.count, fresh.shift_opt.count, fresh.base.step) == (1, 1, 1)


def test_jax_checkpoint_calib_leaves_load(toy, one_step, tmp_path):
    """A checkpoint the JAX package wrote of its CalibState after the step:
    its base model, lens, vignetting, shift, their moments and counts load
    into the port (model leaves only, `with_optimizer=False`)."""
    js, _, _, _, _ = one_step
    path = str(tmp_path / "jax.npz")
    jsave(path, js)
    cs = toy_lib.port_state(toy)[0]
    tcal.load_calib_checkpoint(path, cs, with_optimizer=False)
    toy_lib.assert_same_state(cs, js, atol=0, rtol=0)
    jmu = toy_lib.lens_np(js.lens_opt.mu)
    for f in ("weights", "biases"):
        for b, blk in enumerate(jmu[f]):
            for l, a in enumerate(blk):
                np.testing.assert_array_equal(cs.lens_opt.mu[f".{f}[{b}][{l}]"].numpy(), a)
    np.testing.assert_array_equal(cs.shift_opt.nu[""].numpy(), np.asarray(js.shift_opt.nu))
    np.testing.assert_array_equal(cs.vig_opt.mu[".a_k"].numpy(), np.asarray(js.vig_opt.mu.a_k))
    assert cs.lens_opt.count == cs.vig_opt.count == int(js.lens_opt.count) == 1
    cub = toy_lib.lens_np(js.cubemap_net)["weights"][0][0]
    np.testing.assert_array_equal(cs.cubemap_net.weights[0][0].detach().numpy(), cub)
