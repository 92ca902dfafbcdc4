"""Lens nets and helpers shared by `test_torch_calib.py` and
`test_torch_lens_warp.py`: JAX `IResNetParams` as numpy lists and back, a
random net and a compressive fitted one (the net of
tests/test_calib.py:68-80)."""

import jax.numpy as jnp
import numpy as np
import torch

from bags_tpu.calib import distortion as jdist
from bags_tpu.calib import iresnet as jres

FIELDS = ("weights", "biases", "u_vecs")


def to_np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def lens_np(p, dtype=None):
    """{weights, biases, u_vecs} numpy lists of a JAX IResNetParams (or of
    such a dict), cast to dtype."""
    get = p.__getitem__ if isinstance(p, dict) else lambda f: getattr(p, f)
    return {f: [[np.asarray(t, dtype) for t in blk] for blk in get(f)]
            for f in FIELDS}


def jax_lens(d, dtype):
    """A JAX IResNetParams from `lens_np` arrays (call inside enable_x64
    for float64)."""
    return jres.IResNetParams(**{f: [[jnp.asarray(a, dtype) for a in blk]
                                     for blk in d[f]] for f in FIELDS})


def close_rel(got, want, rel):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(to_np(got), want, atol=rel * scale, rtol=0)


def random_net():
    return lens_np(jres.init_iresnet_params(hidden=32, n_blocks=3, n_layers=2,
                                            seed=1))


def compressive_net():
    """Fitted to |target| ~ 0.15 |x| over |x| <= 8, as a pre-fit fisheye
    lens is; rim points' preimages lie far from the Newton seed."""
    net = jres.init_iresnet_params(hidden=32, n_blocks=3, n_layers=2, seed=1)
    lin = np.linspace(-8.0, 8.0, 24)
    gx, gy = np.meshgrid(lin, lin)
    inputs = jnp.asarray(np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32))
    return lens_np(jdist.fit_iresnet_to_targets(net, inputs, 0.15 * inputs,
                                                iters=400, lr=3e-3))


def rim_points():
    lin = np.linspace(-1.2, 1.2, 11)
    gx, gy = np.meshgrid(lin, lin)
    return np.stack([gx.ravel(), gy.ravel()], -1)
