"""Port parity, camera batches in the fisheye mode: one `--batch_cams 2`
fisheye step (apply2render, vignetting and the pupil shift on) against the
JAX package's, on `_fisheye_toy.py`'s toy (JAX's K = 2 step, two unrolled
view chains, compiled once here)."""

import numpy as np
import pytest

import _fisheye_toy as toy_lib
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

IDX = [2, 0]


@pytest.fixture(scope="module")
def one_step():
    toy = toy_lib.build(apply2gt=False, vig_shift=True, batch_cams=2)
    js, jloss, jimg = toy_lib.jax_step(toy, toy["state"], IDX)
    port = toy_lib.port_state(toy)
    return toy, js, jloss, jimg, port, toy_lib.port_step(toy, port, IDX)


def test_fisheye_batch_step_matches_jax(one_step):
    """Loss and both warped images (atol 2e-5); every gradient (the mean
    over the views for the Gaussians, the lens, vignetting and shift, each
    row's own for the cameras; atol 1e-5, rtol 1e-3)."""
    toy, js, jloss, jimg, port, m = one_step
    np.testing.assert_allclose(float(m.loss), jloss, atol=2e-5)
    assert m.image.shape == jimg.shape == (2, 3, 48, 48)
    np.testing.assert_allclose(m.image.numpy(), jimg, atol=2e-5)
    want = toy_lib.jax_grads(js, IDX, vig_shift=True)
    for name, w in want.items():
        np.testing.assert_allclose(m.grads[name].detach().numpy(), w, atol=1e-5,
                                   rtol=1e-3, err_msg=name)
        assert np.abs(w).max() > 0, f"{name}: zero gradient"
    assert m.grads[".cam.dq"].shape == (2, 4)


def test_fisheye_batch_state_matches_jax(one_step):
    """The state after the step (`assert_same_state`): both camera rows
    stepped once, the statistics scaled back by K (denom 2 where both views
    see a Gaussian)."""
    toy, js, jloss, jimg, port, m = one_step
    toy_lib.assert_same_state(port[0], js)
    assert port[0].base.cam_opt.count.tolist() == [1, 0, 1]
    assert port[0].base.stats.denom.max() == 2.0
