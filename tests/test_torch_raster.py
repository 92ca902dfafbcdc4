"""Port parity, raster: binning, the compositing kernel's module, tiles and
the naive reference of `bags_tpu_torch` against `bags_tpu` (CPU; the JAX
Pallas kernel runs in interpret mode). The CUDA kernel itself is held
against its plain version on the card (tests/test_torch_gpu.py and
chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bags_tpu.core import lie as jlie
from bags_tpu.core.camera import CameraParams as JCam
from bags_tpu.core.projection import distance_to_camera, project_gaussians
from bags_tpu.raster import binning as jbin
from bags_tpu.raster import pallas_raster, tiles as jtiles
from bags_tpu.raster.render import _take_rows, build_packet_table
from bags_tpu.raster.reference import render_reference as j_reference
from bags_tpu.utils.testing import make_toy_scene as jmake
from bags_tpu_torch import convert
from bags_tpu_torch.core import projection as tproj
from bags_tpu_torch.raster import binning as tbin
from bags_tpu_torch.raster import composite
from bags_tpu_torch.raster import tiles as ttiles
from bags_tpu_torch.raster.reference import render_reference as t_reference
from bags_tpu_torch.utils.testing import make_toy_scene as tmake
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


# jitted once per shape: the two kernel scenes share every shape
_pallas_fwd = jax.jit(pallas_raster._composite_fwd_call,
                      static_argnames=("tiles_x", "tiles_y"))
_jproject = jax.jit(project_gaussians, static_argnames=("static", "sh_degree"))
_jbin = jax.jit(jbin.bin_gaussians, static_argnums=(1, 2, 3),
                static_argnames=("force_wide_keys",))


def _t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _cams(rng):
    """A rotated camera with non-zero dq/dt, in both packages."""
    R = np.asarray(jlie.so3_exp(jnp.asarray(
        rng.normal(size=3).astype(np.float32) * 0.1)))
    jc = JCam.create(R, rng.normal(size=3).astype(np.float32) * 0.1, 0.8, 0.8)
    jc = dataclasses.replace(
        jc, dq=jnp.asarray(rng.normal(size=4).astype(np.float32) * 0.01),
        dt=jnp.asarray(rng.normal(size=3).astype(np.float32) * 0.02))
    tc = convert.camera_from_numpy(
        {f.name: np.asarray(getattr(jc, f.name))
         for f in dataclasses.fields(jc)}, device="cpu")
    return jc, tc


def _project_both(n, width, height, seed, sh_degree=0, scale_range=(0.02, 0.12)):
    kw = dict(n=n, width=width, height=height, seed=seed, sh_degree=sh_degree,
              scale_range=scale_range)
    j, t = jmake(**kw), tmake(**kw, device="cpu")
    jc, tc = _cams(np.random.default_rng(seed))
    args = ("xyz", "scales", "quats", "opacity", "sh_coeffs")
    pj = _jproject(*[j[k] for k in args], jc, static=j["static"],
                   sh_degree=sh_degree)
    pt = tproj.project_gaussians(*[t[k] for k in args], tc, t["static"], sh_degree)
    return (j, jc, pj), (t, tc, pt)


def _assert_same_bins(jb, tb):
    total = int(jnp.sum(jb.tile_count))
    assert int(jb.n_dropped) == tb.n_dropped
    assert tb.n_instances == total
    np.testing.assert_array_equal(tb.tile_count.numpy(), np.asarray(jb.tile_count))
    np.testing.assert_array_equal(tb.tile_start.numpy(), np.asarray(jb.tile_start))
    # slots are tile-major, depth order within a tile, in both packages
    np.testing.assert_array_equal(tb.gauss_id.numpy(),
                                  np.asarray(jb.gauss_id)[:total])


BIN_CASES = {
    # name: (n, width, height, seed, scale_range, JAX budget, kwargs)
    "toy": (700, 64, 48, 1, (0.02, 0.12), 16384, {}),
    "wide_keys": (600, 96, 80, 4, (0.02, 0.12), 4096, {"force_wide_keys": True}),
    "gt_4095_tiles": (800, 1088, 1088, 6, (0.01, 0.12), 32768, {}),
    "sort_by_distance": (500, 64, 48, 2, (0.02, 0.12), 16384, {"distance": True}),
    "budget_drops": (700, 64, 48, 3, (0.02, 0.12), 512, {"budget": True}),
}


@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_binning_matches_jax(case):
    n, w, h, seed, scale_range, m, kw = BIN_CASES[case]
    (j, jc, pj), (t, tc, pt) = _project_both(n, w, h, seed,
                                             scale_range=scale_range)
    tiles_x, tiles_y = jbin.tile_grid(w, h)
    if case == "gt_4095_tiles":
        assert tiles_x * tiles_y > 4095
    jkey = distance_to_camera(j["xyz"], jc) if kw.get("distance") else None
    tkey = tproj.distance_to_camera(t["xyz"], tc) if kw.get("distance") else None
    jb = _jbin(pj, tiles_x, tiles_y, m, sort_key_depth=jkey,
               force_wide_keys=kw.get("force_wide_keys", False))
    tb = tbin.bin_gaussians(pt, tiles_x, tiles_y,
                            max_instances=m if kw.get("budget") else None,
                            sort_key_depth=tkey)
    if kw.get("budget"):
        assert tb.n_dropped > 0
    else:
        assert int(jb.n_dropped) == 0
    _assert_same_bins(jb, tb)


@pytest.fixture(scope="module")
def jax_rows():
    """Instance rows, tile ranges and JAX compositor outputs for a toy scene
    (700 Gaussians, 64x48, SH 3) and the unaligned-spill scene of
    tests/test_pallas_raster.py."""
    out = {}
    for name, kw in {
        "toy": dict(n=700, width=64, height=48, sh_degree=3, seed=0),
        "unaligned_spill": dict(n=700, width=64, height=48, sh_degree=0,
                                seed=21, scale_range=(0.01, 0.05)),
    }.items():
        sc = jmake(**kw)
        tiles_x, tiles_y = jbin.tile_grid(kw["width"], kw["height"])
        proj = _jproject(sc["xyz"], sc["scales"], sc["quats"], sc["opacity"],
                         sc["sh_coeffs"], sc["cam"], static=sc["static"],
                         sh_degree=kw["sh_degree"])
        bins = _jbin(proj, tiles_x, tiles_y, 16384)
        rows = _take_rows(build_packet_table(proj, proj.x2d, proj.y2d), bins)
        color, t_final = _pallas_fwd(rows, bins.tile_start, bins.tile_count,
                                     tiles_x, tiles_y)
        out[name] = dict(rows=rows, start=bins.tile_start, count=bins.tile_count,
                         tiles=(tiles_x, tiles_y), color=color, t_final=t_final)
    return out


@pytest.mark.parametrize("scene", ["toy", "unaligned_spill"])
def test_composite_fwd_matches_pallas_kernel(jax_rows, scene):
    """composite_fwd (plain version on the CPU) against the TPU kernel
    `_fwd_kernel` in interpret mode: it sums log(1 - alpha) with a prefix
    scan where the port multiplies, hence 2e-5 (tests/test_pallas_raster.py)."""
    d = jax_rows[scene]
    before = composite.fwd_launches
    color, t_final = composite.composite_fwd(
        _t(d["rows"]), _t(d["start"]), _t(d["count"]), *d["tiles"])
    assert composite.fwd_launches == before          # no kernel on the CPU
    assert color.shape == d["color"].shape and t_final.shape == d["t_final"].shape
    np.testing.assert_allclose(color.numpy(), np.asarray(d["color"]), atol=2e-5)
    np.testing.assert_allclose(t_final.numpy(), np.asarray(d["t_final"]), atol=2e-5)
    assert float(t_final.min()) < 0.05            # some pixels saturate


@pytest.mark.parametrize("scene", ["toy", "unaligned_spill"])
def test_composite_plain_matches_jnp_tiles(jax_rows, scene):
    d = jax_rows[scene]
    rows, bg = d["rows"], jnp.array([0.2, 0.5, 0.8])
    want = jtiles.composite_tiles_jnp(
        rows[0:2].T, rows[2:5].T, rows[6:9].T, rows[5], rows[9],
        d["start"], d["count"], *d["tiles"], bg)
    color4, t_final = ttiles.composite_tiles_plain(
        _t(rows), _t(d["start"]), _t(d["count"]), *d["tiles"], chunk=64)
    color = color4.transpose(1, 2)
    rgb = color[..., :3] + t_final[..., None] * torch.tensor([0.2, 0.5, 0.8])
    np.testing.assert_allclose(rgb.numpy(), np.asarray(want.color), atol=1e-6)
    np.testing.assert_allclose(t_final.numpy(), np.asarray(want.t_final), atol=1e-6)
    np.testing.assert_allclose(color[..., 3].numpy(), np.asarray(want.depth),
                               atol=1e-6, rtol=1e-6)


def test_composite_fwd_rejects_bad_inputs(jax_rows):
    d = jax_rows["toy"]
    rows, start, count = _t(d["rows"]), _t(d["start"]), _t(d["count"])
    with pytest.raises(ValueError, match="float32"):
        composite.composite_fwd(rows.double(), start, count, *d["tiles"])
    with pytest.raises(ValueError, match="int32"):
        composite.composite_fwd(rows, start.long(), count, *d["tiles"])
    with pytest.raises(ValueError, match="contiguous"):
        composite.composite_fwd(rows.t().contiguous().t(), start, count,
                                *d["tiles"])
    with pytest.raises(ValueError, match="F >= 10"):
        composite.composite_fwd(rows[:9].contiguous(), start, count, *d["tiles"])


def test_tiles_layout_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.normal(size=(3, 35, 50)).astype(np.float32)
    tx, ty = ttiles.tile_grid(50, 35)
    jt = jtiles.image_to_tiles(jnp.asarray(img), tx, ty)
    tt = ttiles.image_to_tiles(torch.as_tensor(img), tx, ty)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(
        ttiles.tiles_to_image(tt, tx, ty, 50, 35).numpy(), img)
    for a, b in zip(jtiles.tile_pixel_coords(tx, ty),
                    ttiles.tile_pixel_coords(tx, ty)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_reference_matches_jax():
    kw = dict(n=200, width=48, height=32, sh_degree=1, seed=1)
    j, t = jmake(**kw), tmake(**kw, device="cpu")
    bg = np.array([0.9, 0.1, 0.4], np.float32)
    args = ("xyz", "scales", "quats", "opacity", "sh_coeffs", "cam", "static")
    rj = jax.jit(j_reference, static_argnums=(6, 7))(
        *[j[k] for k in args], 1, bg=jnp.asarray(bg))
    rt = t_reference(*[t[k] for k in args], 1, bg=torch.as_tensor(bg))
    for k, atol in (("render", 2e-5), ("T_final", 2e-5), ("radii", 0)):
        np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]), atol=atol)
