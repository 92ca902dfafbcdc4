"""Port parity, the lens net and the distortion model: the iResNet of
`bags_tpu_torch` against `bags_tpu`'s on the same numpy weights (CPU),
control grids, the COLMAP coefficients and the pre-fit, the known-lens flow
and its error. The warp itself is `test_torch_lens_warp.py`.

The iResNet is held in float64 (`jax.enable_x64` on the JAX side, never the
global flag) to 1e-9 relative: forward, Newton inverse and its implicit
backward against JAX's own custom VJP. The inverse's residual is also
asserted on the JAX side, on a compressive fitted net whose preimages lie
far from the Newton seed, so that a point that did not converge cannot
become the truth."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lens_nets as nets
from _lens_nets import FIELDS, close_rel, jax_lens, lens_np, rim_points, to_np
from bags_tpu.calib import distortion as jdist
from bags_tpu.calib import iresnet as jres
from bags_tpu_torch import convert
from bags_tpu_torch.calib import distortion as tdist
from bags_tpu_torch.calib import iresnet as tres
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

REL64 = 1e-9


@pytest.fixture(scope="module")
def random_net():
    return nets.random_net()


@pytest.fixture(scope="module")
def compressive_net():
    return nets.compressive_net()


# --------------------------------------------------------------------------
# iResNet
# --------------------------------------------------------------------------

def test_inverse_converges_on_compressive_net_f32(compressive_net):
    """float32, 12 Newton iterations: JAX's inverse has converged (residual
    < 1e-4, preimages beyond 3 units) and the port's agrees with it and has
    converged too."""
    y = rim_points().astype(np.float32)
    jnet = jax_lens(compressive_net, jnp.float32)
    jx = jres.iresnet_forward(jnet, jnp.asarray(y), sensor_to_frustum=False)
    j_res = float(jnp.abs(jres.iresnet_forward(jnet, jx) - y).max())
    assert j_res < 1e-4, f"reference inverse not converged: {j_res:.2e}"
    assert float(jnp.abs(jx).max()) > 3.0
    tnet = convert.iresnet_from_numpy(compressive_net, device="cpu")
    tx = tres.iresnet_forward(tnet, torch.as_tensor(y), sensor_to_frustum=False)
    assert tres.inverse_residual(tnet, torch.as_tensor(y)) < 1e-4
    np.testing.assert_allclose(to_np(tx), np.asarray(jx), atol=2e-4, rtol=0)


@jax.jit
def _inverse_vjp(p, y, w_out):
    """JAX's gradients of sum(sin(inverse(y)) * w_out) in p and y (one
    compile for both nets of the test below: same shapes)."""
    def f(p, yy):
        return jnp.sum(jnp.sin(jres.iresnet_forward(p, yy, sensor_to_frustum=False))
                       * w_out)
    return jax.grad(f, argnums=(0, 1))(p, y)


@pytest.mark.parametrize("which", ["random", "compressive"])
def test_iresnet_f64_forward_inverse_vjp(which, random_net, compressive_net):
    """float64: forward, inverse (16 Newton iterations; JAX's residual
    asserted) and the VJP of a scalar of the inverse into every weight,
    bias and y, to 1e-9 relative."""
    d = lens_np(random_net if which == "random" else compressive_net, np.float64)
    rng = np.random.default_rng(3)
    y = rim_points() + rng.normal(0, 0.01, (121, 2))
    w_out = rng.normal(size=(121, 2))
    with jax.enable_x64():
        jnet = jax_lens(d, jnp.float64)
        jy = jnp.asarray(y)
        j_fwd = jres.iresnet_forward(jnet, jy)
        j_inv = jres.iresnet_forward(jnet, jy, sensor_to_frustum=False)
        j_res = float(jnp.abs(jres.iresnet_forward(jnet, j_inv) - jy).max())
        assert j_res < 1e-10, f"reference f64 inverse residual {j_res:.2e}"

        jg_p, jg_y = _inverse_vjp(jnet, jy, jnp.asarray(w_out))
        jg_p = lens_np(jg_p)
        jg_y = np.asarray(jg_y)
    tnet = convert.iresnet_from_numpy(d, device="cpu")
    ty = torch.tensor(y, requires_grad=True)
    close_rel(tres.iresnet_forward(tnet, ty), j_fwd, REL64)
    t_inv = tres.iresnet_forward(tnet, ty, sensor_to_frustum=False)
    close_rel(t_inv, j_inv, REL64)
    torch.sum(torch.sin(t_inv) * torch.as_tensor(w_out)).backward()
    close_rel(ty.grad, jg_y, REL64)
    for f in ("weights", "biases"):
        for b, blk in enumerate(getattr(tnet, f)):
            for l, t in enumerate(blk):
                close_rel(t.grad, jg_p[f][b][l], REL64)
    assert all(t.grad is None for blk in tnet.u_vecs for t in blk)
    if which == "compressive":
        assert np.abs(np.asarray(j_inv)).max() > 3.0


def test_u_vecs_never_update(random_net):
    """A Adam step of the lens moves the weights and leaves every
    power-iteration vector exactly as it was, with no gradient."""
    from bags_tpu_torch.train.optim import adam_moments_init, adam_moments_step

    tnet = convert.iresnet_from_numpy(random_net, device="cpu")
    before = {k: v.clone() for k, v in tnet.named_tensors().items()}
    y = torch.as_tensor(rim_points().astype(np.float32))
    (tres.iresnet_forward(tnet, y, sensor_to_frustum=False) ** 2).sum().backward()
    named = tnet.named_tensors(trained_only=True)
    adam_moments_step(named, {k: v.grad for k, v in named.items()},
                      adam_moments_init(named), 1e-3)
    for k, v in tnet.named_tensors().items():
        if k.startswith(".u_vecs"):
            assert v.grad is None and torch.equal(v, before[k]), k
        elif k.startswith(".weights"):
            assert not torch.equal(v, before[k]), k


def test_iresnet_from_numpy_refuses_out_in_layout(random_net):
    """A lens whose 2 -> hidden weight arrives transposed, (hidden, 2),
    raises; the same for a hidden -> 2 weight."""
    for layer in (0, -1):
        d = {f: [list(blk) for blk in random_net[f]] for f in FIELDS}
        d["weights"][1][layer] = d["weights"][1][layer].T
        with pytest.raises(ValueError, match="in, out"):
            convert.iresnet_from_numpy(d, device="cpu")


def test_init_matches_jax():
    """init_iresnet_params draws the JAX package's weights."""
    j = lens_np(jres.init_iresnet_params(hidden=16, n_blocks=2, n_layers=2,
                                          seed=4))
    t = tres.init_iresnet_params(hidden=16, n_blocks=2, n_layers=2, seed=4)
    for f in FIELDS:
        for jb, tb in zip(j[f], getattr(t, f)):
            for ja, ta in zip(jb, tb):
                np.testing.assert_array_equal(to_np(ta), ja)


def test_init_from_colmap_f64_20_iterations(random_net):
    """The COLMAP-coefficient pre-fit, 20 Adam steps in float64 from the
    same net (JAX under enable_x64): the fitted weights agree."""
    d = lens_np(random_net, np.float64)
    K = np.array([[40.0, 0, 24], [0, 38.0, 20], [0, 0, 1]])
    coeff = [-0.04, 0.01, 0.0, 0.0]
    with jax.enable_x64():
        jfit = lens_np(jdist.init_iresnet_from_colmap(
            jax_lens(d, jnp.float64), K, 48, 40, coeff, iters=20))
    tnet = tdist.init_iresnet_from_colmap(convert.iresnet_from_numpy(d, "cpu"),
                                          K, 48, 40, coeff, iters=20)
    moved = 0.0
    for f in ("weights", "biases"):
        for b, blk in enumerate(getattr(tnet, f)):
            for l, t in enumerate(blk):
                np.testing.assert_allclose(to_np(t), jfit[f][b][l], atol=1e-8,
                                           rtol=0, err_msg=f"{f}[{b}][{l}]")
                moved = max(moved, float(np.abs(jfit[f][b][l] - d[f][b][l]).max()))
    assert moved > 1e-4


def _eager_fit_before_graphs(params, inputs, targets, iters, lr):
    """`fit_iresnet_to_targets` as it was before the card's pre-fit became
    a CUDA graph (its body verbatim): the CPU's pre-fit stays this."""
    leaves = params.parameters()
    dtype = leaves[0].dtype
    inputs, targets = inputs.to(dtype), targets.to(dtype)
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(iters):
        opt.zero_grad()
        pred = tres.iresnet_forward(params, inputs, sensor_to_frustum=True)
        pred = torch.where(torch.isfinite(pred), pred, torch.zeros_like(pred))
        torch.mean((pred - targets) ** 2).backward()
        opt.step()
    return params


def test_prefit_on_the_cpu_is_the_eager_loop():
    """On the CPU the pre-fit is the eager loop, unchanged: 20 Adam steps
    from one net give the same loss and weights, bit for bit, as the loop
    before the graphed fit; the graphed fit refuses CPU tensors."""
    K = np.array([[40.0, 0, 24], [0, 38.0, 20], [0, 0, 1]])
    inputs, targets = tdist.colmap_fit_points(K, 48, 40, [-0.04, 0.01, 0.0, 0.0],
                                              "cpu")
    fitted = [tres.init_iresnet_params(hidden=16, n_blocks=2, n_layers=2, seed=5)
              for _ in range(2)]
    tdist.fit_iresnet_to_targets(fitted[0], inputs, targets, iters=20, lr=1e-3)
    _eager_fit_before_graphs(fitted[1], inputs, targets, 20, 1e-3)
    with torch.no_grad():
        loss = [tdist.prefit_loss(n, inputs, targets) for n in fitted]
    assert torch.equal(loss[0], loss[1])
    for a, b in zip(fitted[0].parameters(), fitted[1].parameters()):
        assert torch.equal(a, b)
    start = tres.init_iresnet_params(hidden=16, n_blocks=2, n_layers=2, seed=5)
    assert not torch.equal(start.weights[0][0], fitted[0].weights[0][0])
    with pytest.raises(ValueError):
        tdist.GraphedFit(start, inputs, targets, 1e-3)


# --------------------------------------------------------------------------
# distortion pipeline, vignetting
# --------------------------------------------------------------------------

def test_control_grid_and_coefficients():
    K = np.array([[50.0, 0, 30], [0, 45.0, 20], [0, 0, 1]])
    js, jv = jdist.make_control_grid(K, 96, 80, 12, 10)
    ts, tv = tdist.make_control_grid(K, 96, 80, 12, 10)
    np.testing.assert_array_equal(to_np(ts), np.asarray(js))
    np.testing.assert_array_equal(to_np(tv), np.asarray(jv))
    pts = np.asarray(jv) * 3.0
    for coeff in ([-0.04, 0.01, 0.002, -0.001], [0.1, -0.02],
                  [0.1, -0.02, 0.003], [-0.1, 0.02, 0.0, 0.0, 1, 2, 3, 4], []):
        np.testing.assert_allclose(
            to_np(tdist.distort_by_coeff(torch.as_tensor(pts), coeff)),
            np.asarray(jdist.distort_by_coeff(jnp.asarray(pts), coeff)),
            atol=2e-6, rtol=1e-6, err_msg=str(coeff))


def test_analytic_flow_and_flow_error(random_net):
    K = np.array([[40.0, 0, 0], [0, 40.0, 0], [0, 0, 1]])
    _, view = jdist.make_control_grid(K, 96, 96, 6, 6)
    coeff = (-0.12, 0.02, 0.0, 0.0)
    proj = np.array([1.3, 1.1], np.float32)
    jf = jdist.analytic_inverse_flow(coeff, view, (6, 6), proj, (48, 48))
    tf = tdist.analytic_inverse_flow(coeff, torch.as_tensor(np.array(view)),
                                     (6, 6), torch.as_tensor(proj), (48, 48))
    # values up to tan(1.5) * 1.3 ~ 18: a float32 ulp there is ~2e-6
    np.testing.assert_allclose(to_np(tf), np.asarray(jf), atol=1e-6, rtol=1e-6)
    jnet = jax_lens(random_net, jnp.float32)
    tnet = convert.iresnet_from_numpy(random_net, device="cpu")
    for fit_scale in (False, True):
        je = jdist.flow_error_px(jnet, coeff, view, proj, 48, fit_scale=fit_scale)
        te = tdist.flow_error_px(tnet, coeff, torch.as_tensor(np.array(view)),
                                 proj, 48, fit_scale=fit_scale)
        np.testing.assert_allclose(te, je, rtol=1e-5)


def test_read_colmap_coeff(tmp_path):
    from bags_tpu_torch.data import colmap

    sparse = tmp_path / "fish" / "sparse" / "0"
    os.makedirs(sparse)
    colmap.write_cameras_binary(str(sparse / "cameras.bin"), {
        1: colmap.ColmapCamera(1, "OPENCV_FISHEYE", 64, 48, np.array(
            [40.0, 40.0, 32.0, 24.0, -0.04, 0.01, 0.0, 0.002]))})
    got = tdist.read_colmap_coeff(str(tmp_path))
    assert got == jdist.read_colmap_coeff(str(tmp_path)) == [-0.04, 0.01, 0.0, 0.002]
    assert tdist.read_colmap_coeff(str(tmp_path / "none")) == [0.0] * 4
