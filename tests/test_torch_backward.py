"""Port parity, the compositing backward: `composite_bwd` (its plain version
on the CPU) against the TPU kernel `_bwd_kernel` in interpret mode, the
plain version against autograd through the plain forward, and the
gradients of `render()` against JAX. The CUDA kernel itself is held against
its plain version on the card (tests/test_torch_gpu.py and chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bags_tpu.core import lie as jlie
from bags_tpu.core.camera import CameraParams as JCam
from bags_tpu.core.projection import project_gaussians
from bags_tpu.raster import RenderConfig as JCfg
from bags_tpu.raster import binning as jbin
from bags_tpu.raster import pallas_raster
from bags_tpu.raster import render as jrender
from bags_tpu.raster.render import _take_rows, build_packet_table
from bags_tpu.utils.testing import make_toy_scene as jmake
from bags_tpu_torch import convert
from bags_tpu_torch.raster import composite, tiles
from bags_tpu_torch.raster.render import RenderConfig as TCfg
from bags_tpu_torch.raster.render import gather_rows
from bags_tpu_torch.raster.render import render as trender
from bags_tpu_torch.utils.testing import make_toy_scene as tmake
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

_jproject = jax.jit(project_gaussians, static_argnames=("static", "sh_degree"))
_jbin = jax.jit(jbin.bin_gaussians, static_argnums=(1, 2, 3))
_pallas_fwd = jax.jit(pallas_raster._composite_fwd_call,
                      static_argnames=("tiles_x", "tiles_y"))
_pallas_bwd = jax.jit(pallas_raster._composite_core_bwd, static_argnums=(0, 1, 2))

# The scenes of tests/test_pallas_raster.py:37-107: the toy scene of its
# gradient test and the unaligned-spill scene.
SCENES = {
    "toy": dict(n=150, width=32, height=32, sh_degree=1, seed=13),
    "unaligned_spill": dict(n=700, width=64, height=48, sh_degree=0, seed=21,
                            scale_range=(0.01, 0.05)),
}


def _t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


@pytest.fixture(scope="module")
def jax_bwd():
    """Per scene: instance rows, tile ranges, Pallas forward outputs, seeded
    cotangents and the Pallas backward's un-padded d_rows."""
    out = {}
    for name, kw in SCENES.items():
        sc = jmake(**kw)
        tiles_x, tiles_y = jbin.tile_grid(kw["width"], kw["height"])
        proj = _jproject(sc["xyz"], sc["scales"], sc["quats"], sc["opacity"],
                         sc["sh_coeffs"], sc["cam"], static=sc["static"],
                         sh_degree=kw["sh_degree"])
        bins = _jbin(proj, tiles_x, tiles_y, 16384)
        rows = _take_rows(build_packet_table(proj, proj.x2d, proj.y2d), bins)
        color, t_final = _pallas_fwd(rows, bins.tile_start, bins.tile_count,
                                     tiles_x, tiles_y)
        rng = np.random.default_rng(kw["seed"])
        g_color = rng.normal(size=color.shape).astype(np.float32)
        g_t = rng.normal(size=t_final.shape).astype(np.float32)
        d_rows, _, _ = _pallas_bwd(
            tiles_x, tiles_y, 3,
            (rows, bins.tile_start, bins.tile_count, color, t_final),
            (jnp.asarray(g_color), jnp.asarray(g_t)))
        out[name] = dict(rows=rows, start=bins.tile_start, count=bins.tile_count,
                         tiles=(tiles_x, tiles_y), color=color, t_final=t_final,
                         g_color=g_color, g_t=g_t, d_rows=d_rows,
                         total=int(jnp.sum(bins.tile_count)))
    return out


def _port_args(d):
    return (_t(d["rows"]), _t(d["start"]), _t(d["count"]), *d["tiles"])


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_composite_bwd_matches_pallas_kernel(jax_bwd, scene):
    """composite_bwd (plain version on the CPU) against `_bwd_kernel` in
    interpret mode, un-padded as `_composite_core_bwd` returns it, at the
    tolerance tests/test_pallas_raster.py holds between Pallas and jnp."""
    d = jax_bwd[scene]
    before = composite.bwd_launches
    got = composite.composite_bwd(*_port_args(d), _t(d["g_color"]), _t(d["g_t"]),
                                  _t(d["color"]), _t(d["t_final"]))
    assert composite.bwd_launches == before              # no kernel on the CPU
    assert got.shape == (10, d["rows"].shape[1])
    want = np.asarray(d["d_rows"])[:10, :d["total"]]
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got[:, :d["total"]].numpy(), want, atol=1e-5,
                               rtol=1e-3)
    assert not got[:, d["total"]:].any()                 # no slot past the tiles


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_composite_bwd_plain_matches_autograd(jax_bwd, scene):
    """The written-out backward against autograd through the plain forward.
    The suffix formula and autograd's chain rule through the cumulative
    products round differently (up to 4e-5 relative on the largest entries
    of the toy scene), so besides atol 1e-6 the entries keep rtol 1e-4."""
    d = jax_bwd[scene]
    rows, start, count, tx, ty = _port_args(d)
    rows.requires_grad_(True)
    color, t_final = tiles.composite_tiles_plain(rows, start, count, tx, ty)
    g_color, g_t = _t(d["g_color"]), _t(d["g_t"])
    want, = torch.autograd.grad((color * g_color).sum() + (t_final * g_t).sum(),
                                rows)
    got = tiles.composite_bwd_plain(rows.detach(), start, count, tx, ty, g_color,
                                    g_t, color.detach(), t_final.detach(), chunk=16)
    np.testing.assert_allclose(got.numpy(), want[:10].numpy(), atol=1e-6,
                               rtol=1e-4)


def test_composite_bwd_rejects_bad_inputs(jax_bwd):
    d = jax_bwd["toy"]
    args = _port_args(d)
    px = dict(g_color=_t(d["g_color"]), g_t=_t(d["g_t"]), color=_t(d["color"]),
              t_final=_t(d["t_final"]))
    with pytest.raises(ValueError, match="g_color must be float32"):
        composite.composite_bwd(*args, **{**px, "g_color": px["g_color"][:, :3]})
    with pytest.raises(ValueError, match="t_final must be float32"):
        composite.composite_bwd(*args, **{**px, "t_final": px["t_final"].double()})
    with pytest.raises(ValueError, match="g_t must be contiguous"):
        composite.composite_bwd(*args, **{**px, "g_t": px["g_t"].t().contiguous().t()})


def test_gather_rows_abs_channel():
    """gather_rows: the forward is a column gather either way; with an abs
    probe the backward also returns the per-Gaussian sums of |d row[0:2]|."""
    rng = np.random.default_rng(0)
    table = torch.tensor(rng.normal(size=(10, 6)).astype(np.float32),
                         requires_grad=True)
    gid = torch.tensor([0, 2, 2, 5, 0, 1])
    d_rows = torch.tensor(rng.normal(size=(10, 6)).astype(np.float32))
    absp = torch.zeros((6, 2), requires_grad=True)
    rows = gather_rows(table, absp, gid)
    assert torch.equal(rows, gather_rows(table, None, gid))
    d_table, d_abs = torch.autograd.grad(rows, [table, absp], d_rows)
    want = torch.zeros(10, 6).index_add_(1, gid, d_rows)
    want_abs = torch.zeros(2, 6).index_add_(1, gid, d_rows[:2].abs())
    torch.testing.assert_close(d_table, want)
    torch.testing.assert_close(d_abs, want_abs.t())


RENDER_GRAD_CASES = {
    # name: (n, width, height, seed, sh_degree)
    "sh1_32x32": (150, 32, 32, 13, 1),
    "sh3_48x40": (200, 48, 40, 5, 3),
}
BG = np.array([0.3, 0.6, 0.9], np.float32)
GRAD_NAMES = ("xyz", "scales", "quats", "opacity", "sh_coeffs", "dq", "dt",
              "fovx", "fovy", "probe2d", "abs_probe")


@pytest.mark.parametrize("case", sorted(RENDER_GRAD_CASES))
def test_render_grads_match_jax(case):
    """Gradients of a loss on render, t_final and depth_map through
    `render()` (autograd through the plain compositor on the CPU; on the
    card through the backward kernel) against JAX render(backend="jnp"),
    with a non-black background: the Gaussians, the camera's dq, dt, fovx,
    fovy, and the probe2d and abs_probe channels."""
    n, w, h, seed, deg = RENDER_GRAD_CASES[case]
    kw = dict(n=n, width=w, height=h, seed=seed, sh_degree=deg)
    j, t = jmake(**kw), tmake(**kw, device="cpu")
    rng = np.random.default_rng(seed)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3).astype(np.float32) * 0.1)))
    jc = JCam.create(R, rng.normal(size=3).astype(np.float32) * 0.1, 0.8, 0.75)
    jc = dataclasses.replace(
        jc, dq=jnp.asarray(rng.normal(size=4).astype(np.float32) * 0.01),
        dt=jnp.asarray(rng.normal(size=3).astype(np.float32) * 0.02))
    target = rng.uniform(size=(3, h, w)).astype(np.float32)
    jcfg = JCfg(sh_degree=deg, backend="jnp", max_instances=16384)

    def jloss(xyz, scales, quats, opacity, sh, dq, dt, fovx, fovy, probe, absp):
        cam = dataclasses.replace(jc, dq=dq, dt=dt, fovx=fovx, fovy=fovy)
        out = jrender(xyz, scales, quats, opacity, sh, cam, j["static"], jcfg,
                      bg=jnp.asarray(BG), probe2d=probe, abs_probe=absp)
        return (jnp.mean(jnp.abs(out.render - target))
                + 0.3 * jnp.mean(out.t_final) + 0.05 * jnp.mean(out.depth_map))

    jargs = (j["xyz"], j["scales"], j["quats"], j["opacity"], j["sh_coeffs"],
             jc.dq, jc.dt, jc.fovx, jc.fovy, jnp.zeros((n, 2)), jnp.zeros((n, 2)))
    gj = jax.jit(jax.grad(jloss, argnums=tuple(range(11))))(*jargs)

    leaves = [torch.tensor(np.asarray(a), requires_grad=True) for a in jargs]
    tc = convert.camera_from_numpy(
        {f.name: np.asarray(getattr(jc, f.name)) for f in dataclasses.fields(jc)},
        device="cpu")
    cam = dataclasses.replace(tc, dq=leaves[5], dt=leaves[6], fovx=leaves[7],
                              fovy=leaves[8])
    out = trender(*leaves[:5], cam, t["static"], TCfg(sh_degree=deg),
                  bg=torch.as_tensor(BG), probe2d=leaves[9], abs_probe=leaves[10])
    loss = (torch.mean(torch.abs(out.render - torch.as_tensor(target)))
            + 0.3 * torch.mean(out.t_final) + 0.05 * torch.mean(out.depth_map))
    loss.backward()
    for name, a, b in zip(GRAD_NAMES, gj, leaves):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a), atol=1e-5,
                                   rtol=1e-3, err_msg=name)
    assert float(leaves[10].grad.abs().sum()) > float(leaves[9].grad.abs().sum()) > 0
