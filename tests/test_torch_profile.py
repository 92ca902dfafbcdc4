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
    """The trace holds every stage label, and the printed summary gives
    each a host time (a CPU trace has no kernels)."""
    out, summary = profiled
    with open(summary["trace"]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    stages = summary["trace_summary"]["stages"]
    for stage in stagebench.STAGES:
        assert f"step/{stage}" in names, stage
        assert stages[f"step/{stage}"]["host_ms"] > 0 and f"step/{stage}" in out
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


def test_labelled_step_matches_render_step():
    """The trace's stage-by-stage step computes what `render()` + loss
    computes: the same loss and gradients, bit for bit."""
    sc = tmake(n=N, width=SIZE, height=SIZE, sh_degree=3, seed=0,
               scale_range=(0.008, 0.035), device="cpu")
    cfg = profile_cli.RenderConfig(sh_degree=3, max_instances=2 ** 20)
    gt = torch.full((3, SIZE, SIZE), 0.25)
    loss, grads = stagebench.render_step(sc, cfg, gt)
    loss_l, grads_l = stagebench.fwd_bwd_step(sc, cfg, gt)
    assert float(loss) > 0 and torch.equal(loss, loss_l)
    assert len(grads) == len(grads_l) == 9
    for name, a, b in zip(stagebench.ARGS + stagebench.CAM_LEAVES, grads, grads_l):
        assert torch.equal(a, b), name


def test_stagebench_prints_every_stage(capsys):
    times = stagebench.main(SMALL)
    out = capsys.readouterr().out
    for stage in ("binning", "render fwd (full)", "render+loss fwd", "gather fwd",
                  "gather bwd (index_add_)", "composite fwd", "composite bwd",
                  "projection fwd+bwd", "ssim loss fwd+bwd", "FULL fwd+bwd step",
                  "Mpix/s", "labelled step (traced)"):
        assert stage in out and stage in times, stage
    assert all(np.isfinite(v) and v > 0 for v in times.values())


def _brute_force_pairs(rows, start, count, tiles_x, tiles_y, terminate):
    """Pixel by pixel, instance by instance, as the kernels' loops walk."""
    counts = [0, 0, 0, 0]
    px, py = tiles.tile_pixel_coords(tiles_x, tiles_y)
    f = rows.numpy()
    for t in range(tiles_x * tiles_y):
        for p in range(tiles.NPIX):
            T = np.float32(1.0)
            for i in range(int(start[t]), int(start[t]) + int(count[t])):
                mx, my, ca, cb, cc, o = f[:6, i]
                dx, dy = np.float32(px[t, p] - mx), np.float32(py[t, p] - my)
                power = np.float32(-0.5) * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
                counts[0] += 1
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
    assert got[2] > got[3] if terminate else got[2] == got[3]


def test_ops_bytes_and_bound_by_hand():
    counts = (10, 8, 5, 3)   # visited, power <= 0, alpha >= 1/255, included
    assert profiling.fwd_ops(counts) == 12 * 10 + 4 * 8 + 3 * 5 + 9 * 3 == 194
    assert profiling.bwd_ops(counts) == 12 * 10 + 4 * 8 + 3 * 5 + 73 * 3 == 386
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
