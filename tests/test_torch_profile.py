"""The port's profiling tools on the CPU: `python -m bags_tpu_torch.cli.profile`
(its timed step's loss and gradients against the JAX `profile.py` step at
the same inputs, its trace), `tools.stagebench`, and the measurement helpers
of `utils/profiling.py` against brute force and hand-worked numbers."""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bags_tpu.raster import RenderConfig as JCfg
from bags_tpu.raster import render as jrender
from bags_tpu.train.losses import photometric_loss as jloss
from bags_tpu.utils.testing import make_toy_scene as jmake
from bags_tpu_torch.cli import profile as profile_cli
from bags_tpu_torch.core.projection import project_gaussians
from bags_tpu_torch.raster import binning, tiles
from bags_tpu_torch.raster.render import build_packet_table
from bags_tpu_torch.tools import stagebench
from bags_tpu_torch.utils import profiling
from bags_tpu_torch.utils.testing import make_toy_scene as tmake
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

N, SIZE = 300, 64
SMALL = ["--device", "cpu", "--n", str(N), "--size", str(SIZE)]


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """The profile CLI's printout and summary, with a trace."""
    trace = tmp_path_factory.mktemp("trace")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = profile_cli.main(SMALL + ["--trace", str(trace)])
    return buf.getvalue(), summary


def test_profile_prints_every_line(profiled):
    out, summary = profiled
    for label in ("workload:", "projection", "binning", "forward render",
                  "fwd+bwd step", "Mpix/s", "instance-stream bytes",
                  "forward kernel bound", "backward kernel bound",
                  "profiler trace written"):
        assert label in out, label
    assert "tunnel" not in out
    assert summary["n_instances"] > 0 and summary["counts"][0] > 0


def test_profile_trace_names_the_stages(profiled):
    """The trace holds every span of the traced step ("bags.<stage>"), and
    the printed summary gives each a host time and no other label (a CPU
    trace has no kernels)."""
    out, summary = profiled
    with open(summary["trace"]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    stages = summary["trace_summary"]["stages"]
    assert set(stages) == {f"bags.{stage}" for stage in stagebench.STAGES}
    for stage in stagebench.STAGES:
        assert f"bags.{stage}" in names, stage
        assert stages[f"bags.{stage}"]["host_ms"] > 0 and f"bags.{stage}" in out
    assert summary["trace_summary"]["launches"] == 0
    assert profile_cli.kernel_name(
        "(anonymous namespace)::composite_bwd_kernel(float const*, long)") == \
        "(anonymous namespace)::composite_bwd_kernel"


def test_profile_step_matches_jax(profiled):
    """The timed step against JAX's profile.py step: render (jnp backend) +
    photometric loss against a zero GT, value_and_grad over the five
    Gaussian arrays and the camera. Loss atol 1e-6; gradients atol 1e-5,
    rtol 1e-3."""
    _, summary = profiled
    sc = jmake(n=N, width=SIZE, height=SIZE, sh_degree=3, seed=0,
               scale_range=(0.008, 0.035))
    cfg = JCfg(sh_degree=3, backend="jnp", max_instances=2 ** 20)
    gt = jnp.zeros((3, SIZE, SIZE), jnp.float32)

    def loss_fn(*x):
        return jloss(jrender(*x, sc["static"], cfg).render, gt)

    args = [sc[k] for k in stagebench.ARGS] + [sc["cam"]]
    loss, grads = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1, 2, 3, 4, 5)))(*args)
    np.testing.assert_allclose(float(summary["loss"]), float(loss), atol=1e-6, rtol=0)
    want = list(grads[:5]) + [getattr(grads[5], f) for f in stagebench.CAM_LEAVES]
    assert len(summary["grads"]) == len(want) == 9
    for name, got, ref in zip(stagebench.ARGS + stagebench.CAM_LEAVES,
                              summary["grads"], want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-3, err_msg=name)


def test_stagebench_prints_every_stage(capsys):
    times = stagebench.main(SMALL)
    out = capsys.readouterr().out
    for stage in ("binning", "render fwd (full)", "render+loss fwd", "gather fwd",
                  "gather bwd (index_add_)", "composite fwd", "composite bwd",
                  "projection fwd+bwd", "ssim loss fwd+bwd", "FULL fwd+bwd step",
                  "Mpix/s"):
        assert stage in out and stage in times, stage
    assert all(np.isfinite(v) and v > 0 for v in times.values())


def _brute_force_pairs(rows, start, count, tiles_x, tiles_y, terminate):
    """Pixel by pixel, instance by instance, as the kernels' loops walk."""
    counts = [0] * 6
    px, py = tiles.tile_pixel_coords(tiles_x, tiles_y)
    f = rows.numpy()
    p_min, ex, ey = (x.numpy() for x in profiling.footprint(rows))
    for t in range(tiles_x * tiles_y):
        for p in range(tiles.NPIX):
            T = np.float32(1.0)
            for i in range(int(start[t]), int(start[t]) + int(count[t])):
                mx, my, ca, cb, cc, o = f[:6, i]
                dx, dy = np.float32(px[t, p] - mx), np.float32(py[t, p] - my)
                power = np.float32(-0.5) * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
                counts[0] += 1
                counts[4] += bool(abs(dx) <= ex[i] and abs(dy) <= ey[i])
                counts[5] += bool(power <= 0 and not power < p_min[i])
                if power > 0:
                    continue
                counts[1] += 1
                alpha = min(np.float32(tiles.ALPHA_MAX), o * np.exp(power))
                if alpha < tiles.ALPHA_MIN:
                    continue
                counts[2] += 1
                test_t = T * (np.float32(1.0) - alpha)
                if terminate and test_t < tiles.T_EPS:
                    break
                counts[3] += 1
                T = test_t
    return tuple(counts)


@pytest.mark.parametrize("terminate", [True, False])
def test_pair_counts_match_brute_force(terminate):
    """On a 32x32 scene of large opaque splats where pixels terminate."""
    sc = tmake(n=80, width=32, height=32, seed=5, scale_range=(0.3, 0.8),
               device="cpu")
    sc["opacity"] = torch.full((80,), 0.9)
    proj = project_gaussians(*[sc[k] for k in stagebench.ARGS], sc["cam"],
                             sc["static"], 0)
    bins = binning.bin_gaussians(proj, 2, 2)
    rows = build_packet_table(proj, proj.x2d, proj.y2d).index_select(1, bins.gauss_id)
    args = (rows, bins.tile_start, bins.tile_count, 2, 2)
    got = profiling.pair_counts(*args, terminate=terminate)
    assert got == _brute_force_pairs(*args, terminate)
    # terminated pixels stop short of their tile's end
    assert got.alpha_pass > got.included if terminate else \
        got.alpha_pass == got.included
    # the footprint and the exp skip leave out pairs, never one that passes
    assert got.visited > got.in_footprint >= got.exp_needed >= got.alpha_pass


def _synthetic_rows(n, seed):
    """`n` instances in one 16x16 tile: centres in and around it, conics from
    radii of 0.3 to 40 pixels at any angle with correlation up to 0.9995,
    and opacities log-uniform from 1e-5 to 1, with a few at 0."""
    rng = np.random.default_rng(seed)
    r1, r2 = np.exp(rng.uniform(np.log(0.3), np.log(40.0), (2, n)))
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    # inverse covariance of radii r1, r2 rotated by th
    a = c * c / r1 ** 2 + s * s / r2 ** 2
    cc = s * s / r1 ** 2 + c * c / r2 ** 2
    b = c * s * (1 / r1 ** 2 - 1 / r2 ** 2)
    o = np.exp(rng.uniform(np.log(1e-5), 0.0, n))
    o[::97] = 0.0
    rows = np.zeros((10, n), np.float32)
    rows[tiles.R_MX], rows[tiles.R_MY] = rng.uniform(-30, 46, (2, n))
    rows[tiles.R_CA], rows[tiles.R_CB], rows[tiles.R_CC] = a, b, cc
    rows[tiles.R_O] = o
    return (torch.as_tensor(rows), torch.zeros(1, dtype=torch.int32),
            torch.tensor([n], dtype=torch.int32), 1, 1)


def _scene_rows(n, width, height, seed, scale_range, opacity=None, sh_degree=0):
    sc = tmake(n=n, width=width, height=height, seed=seed, sh_degree=sh_degree,
               scale_range=scale_range, device="cpu")
    if opacity is not None:
        sc["opacity"] = torch.as_tensor(np.random.default_rng(seed).uniform(
            *opacity, n).astype(np.float32))
    proj = project_gaussians(*[sc[k] for k in stagebench.ARGS], sc["cam"],
                             sc["static"], sh_degree)
    tx, ty = tiles.tile_grid(width, height)
    bins = binning.bin_gaussians(proj, tx, ty)
    rows = build_packet_table(proj, proj.x2d, proj.y2d).index_select(1, bins.gauss_id)
    return rows, bins.tile_start, bins.tile_count, tx, ty


SKIP_SCENES = {
    # chip_smoke.py's three test-size scenes and the profile tools' workload
    # at the CPU tests' size
    "toy_64x48_700": lambda: _scene_rows(700, 64, 48, 0, (0.02, 0.12), sh_degree=3),
    "unaligned_spill": lambda: _scene_rows(700, 64, 48, 21, (0.01, 0.05)),
    "dense_low_opacity": lambda: _scene_rows(4000, 32, 32, 5, (0.1, 0.4),
                                             opacity=(0.005, 0.02)),
    "tools_workload": lambda: _scene_rows(N, SIZE, SIZE, 0, (0.008, 0.035),
                                          sh_degree=3),
    "synthetic_anisotropic": lambda: _synthetic_rows(20000, 3),
}


def _every_pair(scene):
    """Every pair of every instance of `scene` with its tile's pixels, power
    formed in the compositors' operation order in float32: (rows of each
    instance (F, n), tile of each (n,), dx, dy and power (n, 256), passes
    the alpha test (n, 256), tiles_x)."""
    rows, start, count, tx, ty = SKIP_SCENES[scene]()
    n = int(count.sum())
    tile_of = torch.repeat_interleave(torch.arange(tx * ty), count.long())
    first = torch.cumsum(count.long(), 0) - count.long()
    slots = start.long()[tile_of] + torch.arange(n) - first[tile_of]
    px, py = tiles.tile_pixel_coords(tx, ty)
    f = rows[:, slots]
    dx = px[tile_of] - f[tiles.R_MX][:, None]
    dy = py[tile_of] - f[tiles.R_MY][:, None]
    power = -0.5 * (f[tiles.R_CA][:, None] * dx * dx
                    + f[tiles.R_CC][:, None] * dy * dy) \
        - f[tiles.R_CB][:, None] * dx * dy
    alpha = torch.clamp(f[tiles.R_O][:, None] * torch.exp(power), max=tiles.ALPHA_MAX)
    passes = (alpha >= tiles.ALPHA_MIN) & (power <= 0)
    assert int(passes.sum()) > 0
    return f, tile_of, dx, dy, power, passes, tx


@pytest.mark.parametrize("scene", sorted(SKIP_SCENES))
def test_exp_skip_and_footprint_change_no_decision(scene):
    """The compositing kernels' exp skip and footprint box (derived at the
    head of csrc/composite_common.cuh, mirrored by `profiling.footprint`),
    on every pair of every instance with its tile's pixels: a pair below
    p_min fails the alpha test, and a pair at or above p_min lies inside
    the footprint. The skip and the cull both leave out a share of the
    pairs."""
    f, _, dx, dy, power, passes, _ = _every_pair(scene)
    p_min, ex, ey = (x[:, None] for x in profiling.footprint(f))
    below = power < p_min
    in_box = (dx.abs() <= ex) & (dy.abs() <= ey)
    assert not bool((below & passes).any())
    assert not bool((~below & ~in_box).any())
    assert int(below.sum()) > 0.3 * below.numel()
    assert int((~in_box).sum()) > 0.1 * in_box.numel()


@pytest.mark.parametrize("scene", sorted(SKIP_SCENES))
def test_forward_warp_cull_changes_no_decision(scene):
    """The forward kernel's per-warp footprint mask at its warp shape
    (csrc/composite_fwd.cu, mirrored by `profiling.footprint_warps`): no
    pair that passes the alpha test lies in a culled (instance, warp), and
    the mask culls a share of the (instance, warp) steps."""
    f, tile_of, _, _, _, passes, tx = _every_pair(scene)
    x0 = (tile_of % tx * tiles.TILE_W).float()
    y0 = (tile_of // tx * tiles.TILE_H).float()
    keep = profiling.footprint_warps(f, x0, y0)
    assert keep.shape == (f.shape[1], tiles.NPIX // 32)
    assert not bool((passes & ~keep[:, profiling.pixel_warps()]).any())
    assert float((~keep).float().mean()) > 0.0


def test_ops_bytes_and_bound_by_hand():
    # visited, power <= 0, alpha >= 1/255, included, in footprint, exp needed
    counts = profiling.Pairs(10, 8, 5, 3, 7, 6)
    assert profiling.fwd_ops(counts) == 12 * 7 + 4 * 6 + 3 * 5 + 9 * 3 == 150
    assert profiling.bwd_ops(counts) == 12 * 7 + 4 * 6 + 3 * 5 + 73 * 3 == 342
    assert profiling.ablate_ops(counts, "dma_only") == 20 * 10
    assert profiling.ablate_ops(counts, "no_scan") == 12 * 10 + 4 * 8 + 12 * 5
    assert profiling.ablate_ops(counts, "full") == 12 * 10 + 4 * 8 + 13 * 5
    assert profiling.ablate_ops(counts, "no_transcendental", accepted=0) == \
        12 * 10 + 3 * 8
    assert profiling.fwd_bytes(100, 2) == 4000 + 16 + 2 * 256 * 20
    assert profiling.bwd_bytes(100, 2) == 8000 + 16 + 2 * 256 * 40
    assert profiling.bound(3.35e9, 0) == (pytest.approx(1.0), "bytes")
    assert profiling.bound(3.35e9, 134e9) == (pytest.approx(2.0), "operations")
    assert profiling.timed(lambda: None, "cpu", reps=3) >= 0.0
