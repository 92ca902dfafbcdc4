"""Port parity, the lens warp: `grid_sample`, `resize_bilinear`,
`center_crop_resample`, vignetting, and `compute_flow` / `apply_distortion`
(image, mask, flow and their VJP into the lens, the projection scale and
the image) of `bags_tpu_torch` against `bags_tpu` on the same numpy inputs
(CPU), through the compressive lens of `_lens_nets.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lens_nets as nets
from _lens_nets import close_rel, jax_lens, lens_np, to_np
from bags_tpu.calib import distortion as jdist
from bags_tpu.calib import vignetting as jvig
from bags_tpu.utils import image as jimage
from bags_tpu_torch import convert
from bags_tpu_torch.calib import distortion as tdist
from bags_tpu_torch.calib import vignetting as tvig
from bags_tpu_torch.utils import image as timage
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def compressive_net():
    return nets.compressive_net()


# --------------------------------------------------------------------------
# image resampling
# --------------------------------------------------------------------------

def test_grid_sample_values_and_gradients():
    """Out-of-range grids (taps beyond every edge, all four taps outside):
    values and the gradients into image and grid, to 1e-6."""
    rng = np.random.default_rng(5)
    img = rng.random((3, 9, 11)).astype(np.float32)
    grid = rng.uniform(-1.4, 1.4, (7, 8, 2)).astype(np.float32)
    grid[0, 0] = (5.0, 5.0)
    cot = rng.normal(size=(3, 7, 8)).astype(np.float32)
    jv, jvjp = jax.vjp(lambda i, g: jimage.grid_sample(i, g), jnp.asarray(img),
                       jnp.asarray(grid))
    jg_img, jg_grid = jvjp(jnp.asarray(cot))
    ti = torch.tensor(img, requires_grad=True)
    tg = torch.tensor(grid, requires_grad=True)
    tv = timage.grid_sample(ti, tg)
    tv.backward(torch.as_tensor(cot))
    np.testing.assert_allclose(to_np(tv), np.asarray(jv), atol=1e-6)
    np.testing.assert_allclose(to_np(ti.grad), np.asarray(jg_img), atol=1e-6)
    np.testing.assert_allclose(to_np(tg.grad), np.asarray(jg_grid), atol=1e-6)
    assert float(np.abs(np.asarray(jv)[:, 0, 0]).max()) == 0.0


def test_grid_sample_non_finite_matches_jax():
    """Sample positions at inf, -inf and NaN (both coordinates, or x
    alone), and a NaN cotangent at a finite sample whose taps lie outside
    the image: the values and both gradients hold JAX's NaN pattern and,
    elsewhere, its numbers to 1e-6, except as `grid_sample` states: the
    x of the sample whose x alone is not finite gets a grid cotangent of 0
    (JAX's is finite), and the finite sample's NaN cotangent does not reach
    its clipped pixel (0, 10) (JAX's does)."""
    rng = np.random.default_rng(8)
    img = rng.random((3, 9, 11)).astype(np.float32)
    grid = rng.uniform(-1.4, 1.4, (6, 7, 2)).astype(np.float32)
    for i, xy in enumerate(((np.inf, np.inf), (-np.inf, np.nan),
                            (np.nan, np.nan), (np.inf, 0.2))):
        grid[1, i] = xy
    grid[4, 5] = (1.3, -1.2)
    cot = rng.normal(size=(3, 6, 7)).astype(np.float32)
    cot[:, 4, 5] = np.nan
    jv, jvjp = jax.vjp(jimage.grid_sample, jnp.asarray(img), jnp.asarray(grid))
    jg_img, jg_grid = (np.array(x) for x in jvjp(jnp.asarray(cot)))
    ti = torch.tensor(img, requires_grad=True)
    tg = torch.tensor(grid, requires_grad=True)
    tv = timage.grid_sample(ti, tg)
    tv.backward(torch.as_tensor(cot))
    assert tg.grad[1, 3, 0] == 0.0 and np.isfinite(jg_grid[1, 3, 0])
    jg_grid[1, 3, 0] = 0.0
    assert np.isnan(jg_img[:, 0, -1]).all()
    assert torch.isfinite(ti.grad[:, 0, -1]).all()
    jg_img[:, 0, -1] = ti.grad[:, 0, -1].numpy()

    def same(got, want):
        got = to_np(got)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                                   atol=1e-6)
    same(tv.detach(), np.asarray(jv))
    same(ti.grad, jg_img)
    same(tg.grad, jg_grid)
    assert np.isnan(np.asarray(jv)[:, 1, :4]).all()
    assert np.isnan(jg_img[:, -1, -1]).all()   # the clipped taps of (1, 0)
    assert not np.isnan(jg_img[:, 4, 4]).any()


def test_resize_bilinear_upsamples_and_refuses_downsampling():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 7)).astype(np.float32)
    for out_hw in ((5, 7), (12, 9), (40, 61)):
        np.testing.assert_allclose(
            to_np(timage.resize_bilinear(torch.as_tensor(x), out_hw)),
            np.asarray(jimage.resize_bilinear(jnp.asarray(x), out_hw)), atol=1e-6)
    with pytest.raises(ValueError, match="upsamples only"):
        timage.resize_bilinear(torch.as_tensor(x), (4, 9))


def test_center_crop_resample_matches_jax():
    rng = np.random.default_rng(7)
    img = rng.random((3, 20, 26)).astype(np.float32)
    for th, tw in ((10, 13),):
        np.testing.assert_allclose(
            to_np(timage.center_crop_resample(torch.as_tensor(img), th, tw)),
            np.asarray(jimage.center_crop_resample(jnp.asarray(img), th, tw)),
            atol=1e-6)


# --------------------------------------------------------------------------
# vignetting, the warp
# --------------------------------------------------------------------------

def test_vignetting_masks_match_jax():
    rng = np.random.default_rng(8)
    a = rng.uniform(0.001, 0.02, 4).astype(np.float32)
    beta = np.linspace(2, 8, 4).astype(np.float32) + rng.uniform(0, 0.5, 4).astype(np.float32)
    cot = rng.normal(size=(17, 23)).astype(np.float32)
    jp = jvig.VignettingParams(a_k=jnp.asarray(a), beta_k=jnp.asarray(beta))
    jm, jvjp = jax.vjp(lambda p: jvig.vignetting_mask(p, 17, 23), jp)
    (jg,) = jvjp(jnp.asarray(cot))
    tp = tvig.VignettingParams(a_k=torch.tensor(a, requires_grad=True),
                               beta_k=torch.tensor(beta, requires_grad=True))
    tm = tvig.vignetting_mask(tp, 17, 23)
    tm.backward(torch.as_tensor(cot))
    np.testing.assert_allclose(to_np(tm), np.asarray(jm), atol=1e-6)
    np.testing.assert_allclose(to_np(tp.a_k.grad), np.asarray(jg.a_k), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(to_np(tp.beta_k.grad), np.asarray(jg.beta_k),
                               atol=1e-5, rtol=1e-4)
    assert float(np.asarray(jm).min()) < 1.0
    s = np.array([1.0, 0.9, 0.6, 0.3], np.float32)
    np.testing.assert_allclose(
        to_np(tvig.interpolated_radial_mask(torch.as_tensor(s), 13, 17)),
        np.asarray(jvig.interpolated_radial_mask(jnp.asarray(s), 13, 17)), atol=1e-6)


def assert_crop_mask_rounding(off, tw, jw, f64):
    """After the centre crop the exact-zero masks may differ, and only by
    rounding: a crop sample lands within an ulp of its pixel, on a side
    that the two packages' grids round differently, and beside a pixel that
    reads zero this makes the sample exactly 0 in one package and a
    neighbour's value times ~1e-7 (float32) or ~1e-15 (float64) in the
    other. Every differing pixel must be such a one (both packages' first
    two channels within that of 0); the count is printed."""
    # a position one or two ulps off a pixel at coordinates below 64, times
    # a neighbour of at most 1
    tiny = 1e-12 if f64 else 1e-5
    near0 = ((np.abs(tw[:2]) <= tiny) & (np.abs(jw[:2]) <= tiny)).all(0)
    print(f"crop mask: {int(off.sum())} of {off.size} pixels differ, all "
          f"within rounding of 0: {bool((near0 | ~off).all())}")
    assert (near0 | ~off).all(), "a mask pixel differs beyond rounding"


# Lens gradients in float32: each entry sums per-pixel warp terms of size
# up to ~20 and of both signs, so where they cancel float32 leaves an error
# relative to the tensor's largest entry, not to the entry. Measured on the
# apply2gt case: each package's float32 gradient is off its own float64
# value by up to 1.6e-5 of the largest entry (9.4e-4 JAX, 7.6e-4 the port,
# on a largest entry of 60), so the two differ by up to about 3e-5 of it.
# Hence atol 5e-5 of the largest entry, beside rtol 1e-3; the float64 cases
# hold the same gradients to 1e-8 of it.
LENS_GRAD_ATOL_OF_MAX = 5e-5


@pytest.mark.parametrize("apply2gt, dtype", [(False, "float32"), (True, "float32"),
                                             (False, "float64"), (True, "float64")])
def test_compute_flow_and_apply_distortion(apply2gt, dtype, compressive_net):
    """The warp of a 40x48 image through the compressive lens (its inverse
    for apply2render, with the centre crop to 20x24; the forward for
    apply2gt): image (atol 2e-5), mask (exactly equal), flow, and the VJP
    into the lens, the projection scale and the image (atol 1e-5, rtol
    1e-3; the lens as `LENS_GRAD_ATOL_OF_MAX` says); in float64 all to 1e-8
    of each tensor's largest entry."""
    f64 = dtype == "float64"
    rng = np.random.default_rng(9)
    K = np.array([[30.0, 0, 0], [0, 30.0, 0], [0, 0, 1]])
    _, view = jdist.make_control_grid(K, 48, 40, 6, 5)
    # apply2gt: the forward map compresses ~0.15x, so wider control points
    view = np.asarray(view) * (8.0 if apply2gt else 1.0)
    img = rng.random((3, 40, 48)).astype(np.float32)
    img[:, :, :3] = 0.0     # exact zeros the apply2gt mask reads
    proj = np.array([1.2, 1.4] if apply2gt else [0.7, 0.8], np.float32)
    final = None if apply2gt else (20, 24)
    out_hw = (40, 48)
    npd = np.float64 if f64 else np.float32
    view, img, proj = view.astype(npd), img.astype(npd), proj.astype(npd)
    net = lens_np(compressive_net, npd)

    def jfn(p, im, ps):
        w, m, fl = jdist.apply_distortion(p, jnp.asarray(view), (5, 6), im, ps,
                                          out_hw, final_hw=final, apply2gt=apply2gt)
        return w, (m, fl)

    def jvalue_and_vjp(p, im, ps, cot):
        w, vjp, aux = jax.vjp(jfn, p, im, ps, has_aux=True)
        return w, aux, vjp(cot)

    # float64 is jitted (one compile; its rounding is far below 1e-8). In
    # float32, XLA's fused rounding of the lens net moves the sample
    # positions by ~1e-5 pixel against the op-by-op rounding both packages
    # share eagerly, which alone moves image gradients by ~2e-5: the
    # float32 cases run eagerly.
    if f64:
        jvalue_and_vjp = jax.jit(jvalue_and_vjp)

    out_shape = (3,) + (out_hw if final is None else final)
    cot = rng.normal(size=out_shape).astype(npd)
    with jax.enable_x64(f64):
        jw, (jm, jf), (jg_p, jg_img, jg_proj) = jvalue_and_vjp(
            jax_lens(net, npd), jnp.asarray(img), jnp.asarray(proj),
            jnp.asarray(cot))
        jg_p = lens_np(jg_p)
        jw, jm, jf = np.asarray(jw), np.asarray(jm), np.asarray(jf)
        jg_img, jg_proj = np.asarray(jg_img), np.asarray(jg_proj)
    assert jw.dtype == npd

    tnet = convert.iresnet_from_numpy(net, device="cpu")
    ti = torch.tensor(img, requires_grad=True)
    tps = torch.tensor(proj, requires_grad=True)
    tw, tm, tf = tdist.apply_distortion(tnet, torch.as_tensor(view), (5, 6), ti,
                                        tps, out_hw, final_hw=final,
                                        apply2gt=apply2gt)
    tw.backward(torch.as_tensor(cot))
    assert 0 < float(jm.mean()) < 1, "the mask must cut something"
    off = to_np(tm)[0] != jm[0]
    if final is None:
        assert not off.any(), f"{int(off.sum())} mask pixels differ"
    else:
        assert_crop_mask_rounding(off, to_np(tw), jw, f64)
    lens = [(f"{f}[{b}][{l}]", t.grad, jg_p[f][b][l])
            for f in ("weights", "biases")
            for b, blk in enumerate(getattr(tnet, f)) for l, t in enumerate(blk)]
    if f64:
        for name, got, want in [("flow", tf, jf), ("image", tw, jw),
                                ("d image", ti.grad, jg_img),
                                ("d proj", tps.grad, jg_proj)] + lens:
            close_rel(got, want, 1e-8)
        return
    np.testing.assert_allclose(to_np(tf), jf, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(to_np(tw), jw, atol=2e-5)
    tol = dict(atol=1e-5, rtol=1e-3)
    np.testing.assert_allclose(to_np(ti.grad), jg_img, **tol)
    np.testing.assert_allclose(to_np(tps.grad), jg_proj, **tol)
    for name, got, want in lens:
        np.testing.assert_allclose(
            to_np(got), want, rtol=1e-3, err_msg=name,
            atol=LENS_GRAD_ATOL_OF_MAX * float(np.abs(want).max()))
