"""Port parity, the scale run: `bags_tpu_torch/tools/scale_train.py`
against the JAX package's `tools/scale_train.py` on the CPU, at toy size.

The JAX tool runs once, in-process (jnp backend), through its 99-iteration
warm-up and one more iteration, holding out every second camera; its
Trainer is recorded on the way, and its static instance budget and
per-tile scan are cut to what the toy can fill (about 23 s). The port
builds the same GT scene (numpy draws, exact), cameras (1e-6), GT renders
(2e-5, the render tolerance of `tests/test_pallas_raster.py`), sparse init
(the points exact, the rest 1e-6) and split (exact), and calibrates its
threshold within 1e-2 of the JAX tool's (measured: 4.9e-7 relative,
8.889e-5 in both; the 99 warm-up steps of the two packages drift apart by
float32 rounding). `calibrate_threshold` on the JAX trainer's own
statistics gives the JAX tool's threshold exactly. The port alone: its
JSON line, and the early stop after four timed windows (the growth to a
target is the card's run, `chip_smoke.py` step 18). Densify at a full
capacity (fewer free rows than candidates) against `bags_tpu`'s: the same
live counts and rows, with the split draws set to ones in both packages.
"""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bags_tpu.model import densify as jdens
from bags_tpu.model.gaussians import Gaussians as JGaussians
from bags_tpu.raster import RenderConfig as JCfg
from bags_tpu.train import loop as jloop
from bags_tpu.utils import cache as jcache
from bags_tpu.utils.testing import make_toy_scene as jmake
from bags_tpu_torch import convert
from bags_tpu_torch.model import densify as tdens
from bags_tpu_torch.raster.render import RenderConfig, render
from bags_tpu_torch.tools import scale_train
from bags_tpu_torch.utils.testing import make_toy_scene
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, N_CAMS, GT_N, INIT_N, CAP, SH = 32, 24, 4, 1000, 100, 256, 1


def toy(target=150, capacity=CAP):
    return ["--width", str(W), "--height", str(H), "--init_n", str(INIT_N),
            "--target_alive", str(target), "--capacity", str(capacity),
            "--gt_n", str(GT_N), "--n_cams", str(N_CAMS), "--sh_degree", str(SH)]


G_FIELDS = ("xyz", "sh_dc", "sh_rest", "scales_log", "quats", "opacity_raw")
# the JAX tool's keys for the TPU's sort key and its re-jits
TPU_KEYS = ("sort_path", "capacity_ladder", "recompiles_from_growth")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _json_line(text):
    return json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])


@pytest.fixture(scope="module")
def jax_run():
    """The JAX tool's main() on the toy with `--holdout 2 --max_iters 1`:
    its JSON line, the arguments of the Trainer it built and that
    trainer's statistics and live mask after the warm-up. The
    persistent compilation cache (a TPU measure that writes beside the
    package) is left off, and the jnp render's static budgets are cut to
    what the toy can fill."""
    import contextlib
    import io
    import sys

    seen = {}

    class Recording(jloop.Trainer):
        def __init__(self, g, alive, cams, static, cfg, **kw):
            # the jnp per-tile scan capped at the slot count: a tile holds
            # at most one instance of each slot, so the result is the same
            kw["rcfg"] = JCfg(max_instances=cfg.max_instances, max_per_tile=CAP)
            super().__init__(g, alive, cams, static, cfg, **kw)
            seen.update(g=g, alive=alive, cams=cams, gt=kw["gt_images"])

        def run(self, *args, **kw):
            out = super().run(*args, **kw)
            # the first run is the warm-up the threshold is taken after
            seen.setdefault("warmup", (self.state.stats, self.state.alive))
            return out

    spec = importlib.util.spec_from_file_location(
        "jax_scale_train", os.path.join(ROOT, "tools", "scale_train.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcache, "enable_persistent_cache", lambda *a, **k: None)
        # the TPU's static instance budget: 4 tiles of 16x16 hold at most 4
        # instances a slot, so nothing is dropped (the JSON's count says 0)
        mp.setattr(jloop, "estimate_capacity", lambda *a, **k: 4 * CAP)
        mp.setattr(jloop, "Trainer", Recording)
        mp.setattr(sys, "argv", ["scale_train"] + toy() + ["--holdout", "2",
                                                         "--max_iters", "1"])
        with contextlib.redirect_stdout(out):
            tool.main()
    seen["json"] = _json_line(out.getvalue())
    return seen


def test_scale_tool_matches_jax_tool(jax_run, capsys):
    # GT scene (numpy draws) and cameras
    jsc = jmake(n=GT_N, width=W, height=H, sh_degree=SH, seed=1,
                scale_range=(0.002, 0.009))
    sc = make_toy_scene(n=GT_N, width=W, height=H, sh_degree=SH, seed=1,
                        scale_range=(0.002, 0.009), device="cpu")
    for k in ("xyz", "scales", "quats", "opacity", "sh_coeffs"):
        np.testing.assert_array_equal(_np(sc[k]), np.asarray(jsc[k]), err_msg=k)
    train_idx, test_idx = scale_train.holdout_split(N_CAMS, 2)
    assert (train_idx, test_idx) == ([1, 3], [0, 2])
    assert scale_train.holdout_split(N_CAMS, 0) == ([0, 1, 2, 3], [])
    cams = scale_train.yaw_cameras(N_CAMS, W, H, "cpu")
    jcams = jax_run["cams"]
    for f in dataclasses.fields(jcams):
        np.testing.assert_allclose(
            np.stack([_np(getattr(cams[i], f.name)) for i in train_idx]),
            np.asarray(getattr(jcams, f.name)), atol=1e-6, rtol=0, err_msg=f.name)
    gauss = [sc[k] for k in ("xyz", "scales", "quats", "opacity", "sh_coeffs")]
    with torch.no_grad():
        gts = [render(*gauss, cams[i], sc["static"], RenderConfig(sh_degree=SH)).render
               for i in train_idx]
    np.testing.assert_allclose(_np(torch.stack(gts)), np.asarray(jax_run["gt"]),
                               atol=2e-5, rtol=0)

    # the sparse init
    g, alive = scale_train.sparse_init(sc, INIT_N, CAP, SH, "cpu")
    np.testing.assert_array_equal(_np(alive), np.asarray(jax_run["alive"]))
    for f in G_FIELDS:
        np.testing.assert_allclose(_np(getattr(g, f)), np.asarray(
            getattr(jax_run["g"], f)), atol=0 if f == "xyz" else 1e-6, rtol=0,
            err_msg=f)

    # the calibrated threshold: the function on the statistics the JAX
    # tool calibrated from, then the port's warm-up against the JAX tool's
    jthr = jax_run["json"]["densify_grad_threshold"]
    jstats, jalive = jax_run["warmup"]
    stats = convert.densify_stats_from_numpy(
        {f.name: np.asarray(getattr(jstats, f.name))
         for f in dataclasses.fields(jstats)}, device="cpu")
    assert scale_train.calibrate_threshold(
        stats, torch.as_tensor(np.array(jalive)), 0.3) == jthr

    out = scale_train.main(toy() + ["--holdout", "2", "--max_iters", "1",
                                  "--device", "cpu"])
    assert _json_line(capsys.readouterr().out) == json.loads(json.dumps(out))
    assert out["densify_grad_threshold"] == pytest.approx(jthr, rel=1e-2)
    want = [k for k in jax_run["json"] if k not in TPU_KEYS]
    assert [k for k in out if k in want] == want
    for k in ("quality_mode", "n_train_cams", "n_test_cams", "iters",
              "resolution", "sh_degree", "capacity", "reached_target",
              "instances_dropped_total"):
        assert out[k] == jax_run["json"][k], k
    for split in ("train", "test"):
        assert np.isfinite(out[f"psnr_{split}"])


def _full_population(rng, cap, n_live):
    """A population of `cap` slots with `n_live` live ones scattered among
    them: small Gaussians (clone candidates) and large ones (split
    candidates), random rotations, some near-transparent (pruned)."""
    alive = np.zeros(cap, bool)
    alive[rng.choice(cap, n_live, replace=False)] = True
    q = rng.normal(size=(cap, 4)).astype(np.float32)
    small = rng.random(cap) < 0.2
    scales = np.where(small[:, None], rng.uniform(0.001, 0.02, (cap, 3)),
                      rng.uniform(0.05, 0.2, (cap, 3)))
    return dict(
        xyz=rng.normal(size=(cap, 3)).astype(np.float32),
        sh_dc=rng.normal(size=(cap, 1, 3)).astype(np.float32),
        sh_rest=rng.normal(size=(cap, 3, 3)).astype(np.float32),
        scales_log=np.log(scales).astype(np.float32),
        quats=q / np.linalg.norm(q, axis=-1, keepdims=True),
        opacity_raw=rng.uniform(-8.0, 3.0, cap).astype(np.float32),
        alive=alive)


def test_scale_run_stops_and_densify_at_full_capacity(capsys, monkeypatch):
    # without a card and without --device cpu the tool refuses to run
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            scale_train.main(toy())

    # the port's run, its target the init's count (a step costs about 35
    # ms here, so the growth to a target is left to the card's run): the
    # printed JSON line, and the stop four 50-iteration windows from 100
    # iterations past the first log, with two densify rounds on the way
    # that fill the 128 slots
    out = scale_train.main(toy(target=INIT_N, capacity=128)
                           + ["--max_iters", "2000", "--device", "cpu"])
    assert _json_line(capsys.readouterr().out) == json.loads(json.dumps(out))
    log = out["log"]
    assert [row[0] for row in log] == [50, 100, 150, 200, 250, 300]
    assert out["iters_run"] == 99 + 300 and out["reached_target"]
    assert out["median_step_s_at_target"] > 0 and out["psnr_test"] is None
    assert [d[0] for d in out["densify_log"]] == [200, 300]
    assert out["alive_final"] == 128 and log[-1][1] < log[0][1]

    # densify and prune with fewer free rows than candidates: with 12 free
    # the clones take some and the split children the rest, with 6 the
    # clones take all, with none nothing is placed; every split parent
    # becomes child 0 all the same
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, *a, **k: jnp.ones(shape))
    monkeypatch.setattr(torch, "randn", lambda shape, generator=None,
                        device=None, **k: torch.ones(shape, device=device))
    rng = np.random.default_rng(3)
    for n_live in (52, 58, 64):
        d = _full_population(rng, 64, n_live)
        jg = JGaussians(**{f: jnp.asarray(d[f]) for f in G_FIELDS})
        tg, talive = convert.gaussians_from_numpy(d, device="cpu")
        st = {"grad_accum": rng.uniform(0, 4e-4, 64).astype(np.float32),
              "grad_accum_abs": np.zeros(64, np.float32),
              "denom": np.where(d["alive"], 2.0, 0.0).astype(np.float32),
              "max_radii2d": rng.uniform(0, 40, 64).astype(np.float32)}
        jres = jdens.densify_and_prune(
            jg, jnp.asarray(d["alive"]), jdens.DensifyStats(
                **{k: jnp.asarray(v) for k, v in st.items()}),
            jax.random.PRNGKey(0), 5e-5, 0.005, 3.0, 20.0)
        tres = tdens.densify_and_prune(
            tg, talive, convert.densify_stats_from_numpy(st, device="cpu"),
            torch.Generator().manual_seed(0), 5e-5, 0.005, 3.0, 20.0)
        counts = (tres.n_cloned, tres.n_split, tres.n_pruned)
        assert counts == (int(jres.n_cloned), int(jres.n_split),
                          int(jres.n_pruned)), n_live
        free = 64 - n_live
        assert tres.n_cloned + tres.n_split == free, (n_live, counts)
        np.testing.assert_array_equal(_np(tres.alive), np.asarray(jres.alive))
        np.testing.assert_array_equal(_np(tres.reset_mask),
                                      np.asarray(jres.reset_mask))
        for f in G_FIELDS:
            np.testing.assert_allclose(_np(getattr(tg, f)), np.asarray(
                getattr(jres.gaussians, f)), atol=1e-6, rtol=0, err_msg=f)
