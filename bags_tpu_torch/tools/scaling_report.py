"""Weak-scaling and collective-traffic report of the tile-parallel trainer
(port of `tools/scaling_report.py`).

    python -m bags_tpu_torch.tools.scaling_report [--devices 1 2 4 8]
        [--fixed] [--md OUT.md] [--device cuda|cpu] [--toy]

Each point trains `dist/trainer.py::ShardedTrainer`'s pose step on D
ranks, one process a rank: NCCL ranks on D cards (at least max(--devices)
cards, or it raises), or with `--device cpu` gloo ranks on the CPU (one
torch thread each). The workload is the JAX tool's (`run_one`): per rank
4,096 Gaussian slots (half of them live, SH 2) and 4 tile rows of a
256-pixel wide image, two identity cameras at FoV 0.8, `--opt_cam`, a
constant GT of 0.5; the total grows with D (weak scaling), or with
`--fixed` stays at 8 ranks' worth. A point reports rank 0's median step
time of 12 steps after 3 warm-up steps (IQR beside it), pixels a step and
a second, and the collectives of one step as `dist/mesh.py` counts them on
rank 0 (calls and MB by kind: the bytes of the whole tensor each call
moves, the halo rows this rank sends), in place of the JAX tool's count
from the compiled HLO. `--toy` cuts the workload to 256 slots and one
64-pixel wide tile row a rank, 2 steps after 1 (the tests' size). It
prints a markdown table; on the cards it adds the scaling efficiency,
which a CPU run leaves out (its ranks share one host's cores).
`main(argv)` returns the points.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
POINT_TIMEOUT = 1800      # seconds for all ranks of one point
# Gaussian slots and tile rows a rank, image width, warm-up and timed steps
WORKLOAD = dict(slots=4096, rows=4, width=256, warmup=3, reps=12)
TOY = dict(slots=256, rows=1, width=64, warmup=1, reps=2)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--devices", nargs="+", type=int, default=[1, 2, 4, 8])
    p.add_argument("--md", default=None, help="also write the table here")
    p.add_argument("--fixed", action="store_true",
                   help="hold the total workload at 8 ranks' worth instead "
                        "of weak scaling")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="NCCL ranks on cards (needs max(--devices) cards), "
                        "or gloo ranks on the CPU")
    p.add_argument("--toy", action="store_true",
                   help="the cut workload of the tests")
    p.add_argument("--worker", nargs=4, default=None, help=argparse.SUPPRESS,
                   metavar=("RANK", "WORLD", "STORE", "OUT"))
    return p


def _workload_args(a) -> list:
    return ["--device", a.device] + (["--fixed"] if a.fixed else []) + \
        (["--toy"] if a.toy else [])


def _worker(rank: int, world: int, store: str, out: str, a) -> None:
    """One rank of a point: train the workload, write rank 0's numbers."""
    import torch.distributed as dist

    from ..core.camera import CameraParams, CameraStatic
    from ..dist import mesh
    from ..dist.trainer import ShardedTrainer
    from ..model.gaussians import create_from_points
    from ..raster.tiles import TILE_H
    from ..train.config import CalibConfig, TrainConfig

    cuda = a.device == "cuda"
    w = TOY if a.toy else WORKLOAD
    if cuda:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        scale = 8 if a.fixed else world
        width, height = w["width"], TILE_H * w["rows"] * scale
        capacity = w["slots"] * scale
        rng = np.random.default_rng(0)
        n_pts = capacity // 2
        pts = np.stack([rng.uniform(-1, 1, n_pts), rng.uniform(-1, 1, n_pts),
                        rng.uniform(4, 8, n_pts)], -1).astype(np.float32)
        cols = rng.uniform(0, 1, (n_pts, 3)).astype(np.float32)
        g, alive = create_from_points(pts, cols, capacity, sh_degree=2,
                                      device=device)
        cams = CameraParams.stack([CameraParams.create(
            np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 0.8, 0.8,
            device=device) for _ in range(2)])
        cfg = TrainConfig(calib=CalibConfig(opt_cam=True), mesh=world)
        cfg.model.sh_degree = 2
        gt = torch.full((2, 3, height, width), 0.5, device=device)
        tr = ShardedTrainer(g, alive, cams, CameraStatic(width, height), cfg,
                            scene_extent=10.0, gt_images=gt, seed=0)
        times, colls = [], None
        warmup = w["warmup"]
        for i in range(warmup + w["reps"]):
            if i == warmup:
                mesh.reset_counts()
            t0 = time.perf_counter()
            tr.run(iterations=1)
            if cuda:
                torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
            if i == warmup:
                colls = mesh.counts()
        ts = sorted(times[warmup:])
        step = statistics.median(ts)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(dict(
                    n=world, step_ms=1e3 * step,
                    iqr_ms=1e3 * (ts[int(len(ts) * 0.75)] - ts[int(len(ts) * 0.25)]),
                    pixels=width * height, pix_per_s=width * height / step,
                    collectives=colls), f)
    finally:
        dist.destroy_process_group()


def run_point(world: int, a) -> dict:
    """Start `world` rank processes of this module, wait for them and
    return rank 0's numbers."""
    tmp = tempfile.mkdtemp(prefix="scaling_report_")
    store, out = os.path.join(tmp, "store"), os.path.join(tmp, "point.json")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    if a.device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bags_tpu_torch.tools.scaling_report",
         "--worker", str(r), str(world), store, out] + _workload_args(a),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    deadline = time.monotonic() + POINT_TIMEOUT
    try:
        logs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))[0]
                for p in procs]
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode:
                raise RuntimeError(f"{world} ranks: rank {r} exited "
                                   f"{p.returncode}:\n{log[-4000:]}")
        with open(out) as f:
            return json.load(f)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def table(rows: list, fixed: bool, cuda: bool) -> str:
    """The markdown table of the points (`rows`)."""
    eff_name = (("strong-scaling eff." if fixed else "weak-scaling eff.")
                if cuda else None)
    head = "| ranks | pixels/step | step ms (median, IQR) | pix/s | "
    head += f"{eff_name} | " if eff_name else ""
    head += "collectives on rank 0 (kind: calls, MB/step) |"
    lines = [head, "|---|---|---|---|" + ("--|" if eff_name else "") + "--|"]
    base = rows[0]
    for r in rows:
        cols = "; ".join(f"{k}: {c}x, {b / 1e6:.4f}"
                         for k, (c, b) in sorted(r["collectives"].items()))
        cells = [f"{r['n']}", f"{r['pixels']}",
                 f"{r['step_ms']:.2f} ± {r['iqr_ms']:.2f}",
                 f"{r['pix_per_s'] / 1e6:.3f}M"]
        if eff_name:
            eff = (r["pix_per_s"] / (base["pix_per_s"] * r["n"]) if fixed
                   else (r["pix_per_s"] / r["n"]) / base["pix_per_s"])
            cells.append(f"{eff * 100:.0f}%")
        cells.append(cols)
        lines.append("| " + " | ".join(cells) + " |")
    out = "\n".join(lines)
    if not cuda:
        out += ("\n\nCPU ranks (gloo) share one host's cores: the total "
                "compute grows with the ranks on fixed cores, so no "
                "efficiency column; the step-time trend shows only "
                "serialisation. The collective calls and bytes are the "
                "ones a card run makes.")
    return out


def main(argv=None) -> list:
    a = _parser().parse_args(argv)
    if a.worker is not None:
        rank, world, store, out = a.worker
        _worker(int(rank), int(world), store, out, a)
        return []
    cuda = a.device == "cuda"
    if cuda and torch.cuda.device_count() < max(a.devices):
        raise RuntimeError(
            f"--devices {' '.join(map(str, a.devices))} needs {max(a.devices)} "
            f"cards; {torch.cuda.device_count()} visible (--device cpu runs "
            f"gloo ranks on the CPU)")
    rows = [run_point(n, a) for n in a.devices]
    text = table(rows, a.fixed, cuda)
    print(text)
    if a.md:
        with open(a.md, "w") as f:
            f.write(text + "\n")
    return rows


if __name__ == "__main__":
    main()
