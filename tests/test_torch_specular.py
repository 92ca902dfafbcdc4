"""Port parity, the hybrid specular colour (`bags_tpu_torch/calib/specular.py`)
against `bags_tpu/calib/specular.py` (CPU, jitted JAX): the initial weights
from one seed, `specular_color` and `specular_extra_color` with their VJPs
(to the features, the directions or positions, every MLP weight, the
camera's dq / dt and the global alignment) in float64 to 1e-10 and in
float32 to atol 2e-5 (values) and atol 1e-5, rtol 1e-3 (gradients), with a
Gaussian on the camera centre."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bags_tpu.calib import specular as jspec
from bags_tpu.core import camera as jcam
from bags_tpu_torch import convert
from bags_tpu_torch.calib import specular as tspec
from bags_tpu_torch.core import camera as tcam
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

N = 64
NAMES = tspec.PARAM_NAMES


def _params(dtype):
    """The seed-0 weights as numpy arrays of `dtype`, b3 made non-zero so
    that it is not a trivial case."""
    p = jspec.init_specular_params(0)
    d = {k: np.asarray(getattr(p, k)).astype(dtype) for k in NAMES}
    d["b3"] = np.array([0.1, -0.2, 0.05], dtype)
    return d


def _jax_vjp(f, args, cot):
    """f(*args) and its VJP of `cot`, jitted (eagerly each operation of f
    compiles on its own)."""
    out, vjp = jax.vjp(f, *args)
    return out, vjp(cot)


_jax_vjp = jax.jit(_jax_vjp, static_argnums=0)


def _tol(dtype):
    if dtype == "float64":
        return dict(atol=1e-10, rtol=1e-10), dict(atol=1e-10, rtol=1e-10)
    return dict(atol=2e-5, rtol=0), dict(atol=1e-5, rtol=1e-3)


def _compare(jout, jgrads, tout, tgrads, dtype):
    vtol, gtol = _tol(dtype)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **vtol)
    for name, jg in jgrads.items():
        tg = tgrads[name]
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **gtol,
                                   err_msg=name)
        assert np.abs(np.asarray(jg)).max() > 0, name


@pytest.mark.parametrize("seed", [0, 3])
def test_init_specular_params_equal(seed):
    """The same seed gives equal weights in both packages (b3 zero)."""
    j = jspec.init_specular_params(seed)
    t = tspec.init_specular_params(seed, device="cpu")
    for k in NAMES:
        np.testing.assert_array_equal(getattr(t, k).detach().numpy(),
                                      np.asarray(getattr(j, k)), err_msg=k)
        assert getattr(t, k).requires_grad
    assert not t.b3.any()
    for a, b in zip(tspec.init_predefined_omega(), jspec.init_predefined_omega()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_specular_color_and_vjp(dtype):
    """specular_color of random features and unit directions, and its VJP of
    a random cotangent to the features, the directions and each weight."""
    rng = np.random.default_rng(1)
    p = _params(dtype)
    feats = rng.normal(0, 0.5, (N, 24)).astype(dtype)
    dirs = rng.normal(size=(N, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(dtype)
    cot = rng.normal(size=(N, 3)).astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        def jf(pp, f, v):
            return jspec.specular_color(jspec.SpecularParams(**pp), f, v)
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        jout, (gp, gf, gv) = _jax_vjp(
            jf, (jp, jnp.asarray(feats), jnp.asarray(dirs)), jnp.asarray(cot))
        jgrads = {**gp, "feats": gf, "dirs": gv}
        assert jout.dtype == dtype
    tp = convert.specular_from_numpy(p, "cpu")
    tf = torch.tensor(feats, requires_grad=True)
    tv = torch.tensor(dirs, requires_grad=True)
    tout = tspec.specular_color(tp, tf, tv)
    leaves = [getattr(tp, k) for k in NAMES] + [tf, tv]
    grads = torch.autograd.grad(tout, leaves, torch.as_tensor(cot))
    _compare(jout, jgrads, tout, dict(zip(list(NAMES) + ["feats", "dirs"], grads)),
             dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_specular_extra_color_and_vjp(dtype):
    """specular_extra_color from a posed camera with a global alignment,
    and its VJP to the positions, the features, each weight, dq, dt and the
    alignment; then from a camera at the origin with a Gaussian exactly on
    its centre (the squared norm clipped before the square root: finite
    values and gradients, equal in both)."""
    rng = np.random.default_rng(2)
    p = _params(dtype)
    xyz = rng.normal(0, 2, (N, 3)).astype(dtype)
    feats = rng.normal(0, 0.5, (N, 24)).astype(dtype)
    cot = rng.normal(size=(N, 3)).astype(dtype)
    a = 0.3
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    q = np.array([0.99, 0.05, -0.03, 0.1])
    q /= np.linalg.norm(q)
    cases = [(R, np.array([0.2, -0.1, 1.5]), True),
             (np.eye(3), np.zeros(3), False)]
    for R, t, with_align in cases:
        xyz_c = xyz.copy()
        if not with_align:
            xyz_c[5] = 0.0                     # on the camera's centre
        dq = np.array([0.0, 0.01, -0.02, 0.005]) if with_align else np.zeros(4)
        dt = np.array([0.03, 0.0, -0.04]) if with_align else np.zeros(3)
        with jax.enable_x64(dtype == "float64"):
            jc = jcam.CameraParams.create(R.astype(dtype), t.astype(dtype), 0.8, 0.7)
            jc = dataclasses.replace(jc, q_init=jc.q_init.astype(dtype),
                                     t_init=jc.t_init.astype(dtype))

            def jf(pp, x, f, dq_, dt_, aq, als):
                cam = dataclasses.replace(jc, dq=dq_, dt=dt_)
                al = jcam.GlobalAlignment(aq, als) if with_align else None
                return jspec.specular_extra_color(jspec.SpecularParams(**pp), x,
                                                  f, cam, al)
            jp = {k: jnp.asarray(v) for k, v in p.items()}
            args = (jp, jnp.asarray(xyz_c), jnp.asarray(feats),
                    jnp.asarray(dq.astype(dtype)), jnp.asarray(dt.astype(dtype)),
                    jnp.asarray(q.astype(dtype)), jnp.asarray(np.asarray(0.1, dtype)))
            jout, (gp, gx, gf, gdq, gdt, gaq, gals) = _jax_vjp(
                jf, args, jnp.asarray(cot))
            jgrads = {**gp, "xyz": gx, "feats": gf}
            if with_align:
                jgrads.update(dq=gdq, dt=gdt, quaternion=gaq, log_scale=gals)
            q_init, t_init = np.asarray(jc.q_init), np.asarray(jc.t_init)
        tp = convert.specular_from_numpy(p, "cpu")
        tx = torch.tensor(xyz_c, requires_grad=True)
        tf = torch.tensor(feats, requires_grad=True)
        cam_leaves = {k: torch.tensor(v.astype(dtype), requires_grad=True)
                      for k, v in (("dq", dq), ("dt", dt))}
        cam = tcam.CameraParams(q_init=torch.as_tensor(q_init),
                                t_init=torch.as_tensor(t_init),
                                fovx=torch.tensor(0.8, dtype=getattr(torch, dtype)),
                                fovy=torch.tensor(0.7, dtype=getattr(torch, dtype)),
                                **cam_leaves)
        al_leaves = {"quaternion": torch.tensor(q.astype(dtype), requires_grad=True),
                     "log_scale": torch.tensor(np.asarray(0.1, dtype),
                                               requires_grad=True)}
        al = tcam.GlobalAlignment(**al_leaves) if with_align else None
        tout = tspec.specular_extra_color(tp, tx, tf, cam, al)
        names = list(NAMES) + ["xyz", "feats"]
        leaves = [getattr(tp, k) for k in NAMES] + [tx, tf]
        if with_align:
            names += ["dq", "dt", "quaternion", "log_scale"]
            leaves += [*cam_leaves.values(), *al_leaves.values()]
        grads = torch.autograd.grad(tout, leaves, torch.as_tensor(cot))
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        _compare(jout, jgrads, tout, dict(zip(names, grads)), dtype)
