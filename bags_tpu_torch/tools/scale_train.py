"""Scale run (port of `tools/scale_train.py`): densify a sparse init of
200,000 Gaussians to at least 1,000,000 live ones at 1600x1080 and measure
the step there.

    python -m bags_tpu_torch.tools.scale_train [--width 1600 --height 1080
        --init_n 200000 --target_alive 1000000 --capacity 2097152
        --quality --holdout K --device cuda]

The GT is the render of a dense random scene (`--gt_n` Gaussians, seed 1,
scales 0.002-0.009) from `--n_cams` cameras that yaw by 0.05 rad about the
origin; the init is a random subsample of its points (`np.random.
default_rng(0)`), coloured from their SH DC. By default the run trains 99
iterations, then sets the clone / split threshold to the `1 - --clone_frac`
quantile of the screen-gradient means over the live Gaussians that were
seen (`calibrate_threshold`: pixel-unit statistics at this size are far
below the reference's 2e-4), and trains on, densifying every 100
iterations with the prune floor `--min_opacity`, until four 50-iteration
windows have been timed from 100 iterations after the live count reached
`--target_alive`. `--quality` uses the reference's schedule instead
(densify every 100 in (500, 15000) at 2e-4, prune below 0.005, opacity
reset every 3000), holds out every fourth camera and trains all
`--max_iters`; `--holdout K` holds out every K-th camera in either mode
and also trains all `--max_iters`. With held-out cameras it ends with the
PSNR of clamped renders of the final model over both splits.

Every 50 iterations it logs the loss, the live count, the instances
dropped and the ms an iteration (the only host-device syncs of the run),
and prints one JSON line with the JAX tool's keys, which `main(argv)` also
returns. `hbm_bytes_in_use` is the card's current allocation
(`torch.cuda.memory_stats`) and `hbm_bytes_peak` its peak over the run;
`log`, `densify_log` (it, cloned, split, pruned, live before, after),
`iters_run`, `seconds` and `device` are added. Left out, as TPU matters:
`sort_path` (the packed or wide sort key of the TPU's binning),
`capacity_ladder` and `recompiles_from_growth` (its static instance
budget and the re-jits that grow it; the port's instance count is
dynamic), the persistent compilation cache and the SSIM-gradient warm-up.
It runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Tuple

import numpy as np
import torch


class _StopRun(Exception):
    """Raised by the run's callback once the timed windows are in."""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--width", type=int, default=1600)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--init_n", type=int, default=200_000)
    p.add_argument("--target_alive", type=int, default=1_000_000)
    p.add_argument("--capacity", type=int, default=2 ** 21)
    p.add_argument("--gt_n", type=int, default=1_000_000)
    p.add_argument("--n_cams", type=int, default=8)
    p.add_argument("--max_iters", type=int, default=4000)
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--densify_threshold", type=float, default=0.0,
                   help="0 = auto: the --clone_frac quantile of the live, "
                        "seen screen-gradient means after the warm-up")
    p.add_argument("--clone_frac", type=float, default=0.3,
                   help="auto mode: the share of the seen live Gaussians "
                        "above the threshold")
    p.add_argument("--min_opacity", type=float, default=5e-4)
    p.add_argument("--quality", action="store_true",
                   help="the reference's densify schedule, --holdout 4 and "
                        "no early stop")
    p.add_argument("--holdout", type=int, default=0,
                   help="every k-th camera is test-only (llffhold), with the "
                        "train and test PSNR and no early stop")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def yaw_cameras(n_cams: int, width: int, height: int, device) -> list:
    """`n_cams` cameras at the origin, yawed by 0.05 (i - n_cams / 2) rad,
    FoV 0.9 across and 0.9 H / W down."""
    from ..core.camera import CameraParams

    cams = []
    for i in range(n_cams):
        ang = 0.05 * (i - n_cams / 2)
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]], np.float32)
        cams.append(CameraParams.create(R, np.zeros(3, np.float32), 0.9,
                                        0.9 * height / width, device=device))
    return cams


def holdout_split(n_cams: int, holdout: int) -> Tuple[List[int], List[int]]:
    """(train, test) camera indices: every `holdout`-th camera from 0 is a
    test camera (the reference's llffhold), none with 0."""
    test = list(range(0, n_cams, holdout)) if holdout else []
    return [i for i in range(n_cams) if i not in test], test


def sparse_init(gt_scene: dict, init_n: int, capacity: int, sh_degree: int,
                device):
    """`init_n` of the GT scene's points drawn without replacement by
    `np.random.default_rng(0)`, coloured from their SH DC (clipped to
    [0.05, 0.95]), as a population of `capacity` slots: (Gaussians,
    alive)."""
    from ..model.gaussians import create_from_points

    rng = np.random.default_rng(0)
    xyz = gt_scene["xyz"].cpu().numpy()
    sel = rng.choice(xyz.shape[0], size=init_n, replace=False)
    cols = np.clip(0.2821 * gt_scene["sh_coeffs"].cpu().numpy()[sel, 0] + 0.5,
                   0.05, 0.95)
    return create_from_points(xyz[sel], cols, capacity, sh_degree=sh_degree,
                              device=device)


def make_config(quality: bool, max_iters: int, sh_degree: int,
                densify_threshold: float, min_opacity: float):
    """The run's TrainConfig: the reference schedule with `quality`, else
    densify every 100 iterations from 100 to `max_iters` at
    `densify_threshold` (1e9, no densify, until the calibration sets it
    when 0) and no opacity reset; the cameras and intrinsics fixed."""
    from ..train.config import CalibConfig, OptimizationConfig, TrainConfig

    if quality:
        # the reference's schedule (arguments/__init__.py:87-94)
        opt = OptimizationConfig(
            densify_from_iter=500, densify_until_iter=15_000,
            densification_interval=100, densify_grad_threshold=2e-4,
            opacity_reset_interval=3000)
        min_opacity = 0.005
    else:
        opt = OptimizationConfig(
            densify_from_iter=100, densify_until_iter=max_iters,
            densification_interval=100,
            densify_grad_threshold=densify_threshold or 1e9,
            opacity_reset_interval=10 ** 9)
    cfg = TrainConfig(opt=opt, calib=CalibConfig(opt_cam=False,
                                                 opt_intrinsic=False))
    cfg.model.sh_degree = sh_degree
    cfg.opacity_threshold = min_opacity
    return cfg


def calibrate_threshold(stats, alive: torch.Tensor, clone_frac: float) -> float:
    """The `1 - clone_frac` quantile of grad_accum / max(denom, 1) over the
    live slots seen in the warm-up (denom > 0): off-screen Gaussians have a
    mean of exactly 0 and would pull the quantile down."""
    denom = stats.denom.cpu().numpy()
    grads = stats.grad_accum.cpu().numpy() / np.maximum(denom, 1.0)
    seen = alive.cpu().numpy() & (denom > 0)
    if not seen.any():
        raise ValueError("no live Gaussian was seen in the warm-up")
    return float(np.quantile(grads[seen], 1.0 - clone_frac))


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    from ..core.camera import CameraParams, CameraStatic
    from ..eval.metrics import psnr
    from ..raster.render import RenderConfig, render
    from ..train.loop import Trainer
    from ..utils.device import resolve_device
    from ..utils.testing import make_toy_scene

    device = resolve_device(args.device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    seconds = {}
    W, H = args.width, args.height
    static = CameraStatic(width=W, height=H)

    # GT: renders of a dense random scene, detail the sparse init lacks
    t0 = time.perf_counter()
    gt_scene = make_toy_scene(n=args.gt_n, width=W, height=H,
                              sh_degree=args.sh_degree, seed=1,
                              scale_range=(0.002, 0.009), device=device)
    cams = yaw_cameras(args.n_cams, W, H, device)
    gt_cfg = RenderConfig(sh_degree=args.sh_degree)
    gauss = [gt_scene[k] for k in ("xyz", "scales", "quats", "opacity",
                                   "sh_coeffs")]
    with torch.no_grad():
        gt_all = torch.stack([render(*gauss, c, static, gt_cfg).render
                              for c in cams])
    sync()
    seconds["gt"] = time.perf_counter() - t0
    print(f"GT rendered: {tuple(gt_all.shape)}", flush=True)

    if args.quality and not args.holdout:
        args.holdout = 4
    train_idx, test_idx = holdout_split(args.n_cams, args.holdout)

    t0 = time.perf_counter()
    g, alive = sparse_init(gt_scene, args.init_n, args.capacity,
                           args.sh_degree, device)
    del gt_scene, gauss
    cfg = make_config(args.quality, args.max_iters, args.sh_degree,
                      args.densify_threshold, args.min_opacity)
    trainer = Trainer(g, alive, CameraParams.stack([cams[i] for i in train_idx]),
                      static, cfg, scene_extent=3.0, gt_images=gt_all[train_idx])
    sync()
    seconds["init"] = time.perf_counter() - t0

    warmup = 0 if args.quality else 99
    n_seen = None
    if warmup:
        # densify first fires past iteration 100, so the warm-up only
        # accumulates the statistics the threshold is taken from
        t0 = time.perf_counter()
        trainer.run(iterations=warmup)
        sync()
        seconds["warmup"] = time.perf_counter() - t0
        if args.densify_threshold:
            thr = args.densify_threshold
        else:
            st = trainer.state
            thr = calibrate_threshold(st.stats, st.alive, args.clone_frac)
            n_seen = int((st.alive & (st.stats.denom > 0)).sum())
            print(f"calibrated densify threshold: {thr:.3e} "
                  f"(q{1 - args.clone_frac:.2f} of {n_seen} seen live grad "
                  f"stats)", flush=True)
        # densify reads the threshold from the configuration at each call
        cfg.opt.densify_grad_threshold = thr

    log, step_times = [], []
    run = dict(dropped=0, target_hit=None, last_it=0)
    early_stop = not args.quality and not args.holdout

    def cb(it, state, metrics):
        run["last_it"] = it
        if it % 50:
            return
        sync()
        t = time.perf_counter()
        ms = (t - cb.t0) * 1e3 / 50
        n_alive, nd = int(metrics.n_alive), int(metrics.n_dropped)
        loss = float(metrics.loss)
        run["dropped"] += nd
        log.append([it, loss, n_alive, nd, ms])
        print(f"it {it}: loss {loss:.4f} alive {n_alive} dropped {nd} "
              f"({ms:.1f} ms/it)", flush=True)
        if n_alive >= args.target_alive and run["target_hit"] is None:
            run["target_hit"] = it
        if run["target_hit"] is not None and it >= run["target_hit"] + 100:
            # a timed window at the target
            step_times.append((t - cb.t0) / 50)
            if len(step_times) >= 4 and early_stop:
                raise _StopRun
        cb.t0 = t

    sync()
    t0 = cb.t0 = time.perf_counter()
    try:
        trainer.run(iterations=args.max_iters, callback=cb)
    except _StopRun:
        pass
    finally:
        trainer.close()
    sync()
    seconds["run"] = time.perf_counter() - t0

    g, alive = trainer.population()
    n_alive = int(alive.sum())
    med_step = float(np.median(step_times)) if step_times else None

    psnrs = {}
    if args.holdout:
        # held-out PSNR of the final model: clamped renders, the
        # reference's in-loop evaluation (train.py:644-654)
        t0 = time.perf_counter()
        with torch.no_grad():
            model = (g.xyz, g.scaling(), g.quats, g.opacity(alive),
                     g.sh_coeffs())
            for split, idxs in (("train", train_idx), ("test", test_idx)):
                vals = [float(psnr(torch.clamp(
                    render(*model, cams[i], static, trainer.rcfg).render,
                    0.0, 1.0), gt_all[i])) for i in idxs]
                psnrs[split] = float(np.mean(vals))
        seconds["psnr"] = time.perf_counter() - t0
        print(f"PSNR train {psnrs['train']:.2f} test {psnrs['test']:.2f}",
              flush=True)

    mem = torch.cuda.memory_stats(device) if cuda else {}
    out = {
        "metric": ("scale_train_quality" if args.quality
                   else "scale_train_densify_to_1M"),
        "quality_mode": bool(args.quality),
        "densify_grad_threshold": cfg.opt.densify_grad_threshold,
        "psnr_train": psnrs.get("train"),
        "psnr_test": psnrs.get("test"),
        "n_train_cams": len(train_idx), "n_test_cams": len(test_idx),
        "iters": args.max_iters,
        "resolution": [W, H],
        "sh_degree": args.sh_degree,
        "capacity": trainer.state.capacity,
        "alive_final": n_alive,
        "reached_target": n_alive >= args.target_alive,
        "median_step_s_at_target": med_step,
        "pixels_per_s_at_target": W * H / med_step if med_step else None,
        "hbm_bytes_in_use": mem.get("allocated_bytes.all.current"),
        "hbm_bytes_peak": mem.get("allocated_bytes.all.peak"),
        "instances_dropped_total": run["dropped"],
        "calibrated_from": n_seen,
        "iters_run": warmup + run["last_it"],
        "log": log,
        "densify_log": [list(map(int, d)) for d in trainer.densify_log],
        "seconds": seconds,
        "device": torch.cuda.get_device_name(device) if cuda else str(device),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
