#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from, beside the
program's own: the control (the plain reference computed in the precision
just below the configuration's, as its `control` names it) and the faults
a training cell can have, each read against the float32 reference at the
cell's own size. The benchmark's runs never run this.

    python3 perfbench/controls.py --workload pose-train --seeds 11 12 13

Prints one JSON line a seed and reading: for a training cell the
control's and the "half" fault's loss_gap, grad_gap and change_gap (and
cam_gap where camera rows train; a state left unchanged reads 1 on
change_gap by the measure, with no run); for the render cell the
control's view_max_abs and view_share_off over the seed's sampled views.

With `--program-fault NAME` it runs the benchmark itself instead, once a
seed, with the fault NAME of `PROGRAM_FAULTS` planted in the program,
and prints each run's `correct` and checks:

    python3 perfbench/controls.py --workload pose-train --seeds 11 12 13 \
        --program-fault cam_x2 --seconds 1
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import io
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.append(os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import core, scene as sc, spec  # noqa: E402
from reference import render as ref_render  # noqa: E402
from reference.train import train_steps  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _unchanged(real):
    """A step that computes its metrics and leaves the state as it was."""
    def step(state, *a, **k):
        base = getattr(state, "base", state)
        keep = {n: t.detach().clone() for n, t in base.g.fields().items()}
        cams = {f: getattr(base.cams, f).clone() for f in ("dq", "dt", "fovx", "fovy")}
        lens = ({n: t.detach().clone() for n, t in state.lens.named_tensors(True).items()}
                if hasattr(state, "lens") else {})
        out = real(state, *a, **k)
        with torch.no_grad():
            for n, t in base.g.fields().items():
                t.copy_(keep[n])
            for f, t in cams.items():
                getattr(base.cams, f).copy_(t)
            for n, t in (state.lens.named_tensors(True).items() if lens else ()):
                t.copy_(lens[n])
        return out
    return step


def _half(real):
    """The loss over the top half of the rows only."""
    def loss(pred, gt, *a, **k):
        h = pred.shape[-2] // 2
        return real(pred[..., :h, :], gt[..., :h, :], *a, **k)
    return loss


def _altered(real):
    """A view whose first pixel is off by 0.5."""
    def render(*a, **k):
        out = real(*a, **k)
        img = out.render.clone()
        img[:, 0, 0] += 0.5
        return dataclasses.replace(out, render=img)
    return render


def _cam_scaled(factor):
    """The camera row's pose gradient scaled by `factor` before its Adam
    step (and in the moments the comparison reads)."""
    def wrap(real):
        def update(cams, st, row_grads, idx, lrs):
            row_grads = {f: g * factor if f in ("dq", "dt") else g
                         for f, g in row_grads.items()}
            return real(cams, st, row_grads, idx, lrs)
        return update
    return wrap


# fault name -> [(program module, attribute)], the wrapper of the attribute
PROGRAM_FAULTS = {
    "unchanged": ([("bags_tpu_torch.train.loop", "train_step"),
                   ("bags_tpu_torch.train.calibrated", "fisheye_train_step")], _unchanged),
    "half": ([("bags_tpu_torch.train.loop", "photometric_loss"),
              ("bags_tpu_torch.train.calibrated", "photometric_loss")], _half),
    "altered": ([("bags_tpu_torch.raster.render", "render")], _altered),
    "cam_x2": ([("bags_tpu_torch.train.loop", "row_adam_update")], _cam_scaled(2.0)),
    "cam_x0": ([("bags_tpu_torch.train.loop", "row_adam_update")], _cam_scaled(0.0)),
}


def plant(fault: str, setattr_=setattr):
    """Plant the program fault `fault` with `setattr_(module, name, value)`
    (a test passes its monkeypatch's)."""
    targets, wrap = PROGRAM_FAULTS[fault]
    for mod_name, attr in targets:
        mod = importlib.import_module(mod_name)
        setattr_(mod, attr, wrap(getattr(mod, attr)))


def train_readings(cell, seed: int, device, faults=("half",)) -> list:
    from harness.drivers import train as drv

    cfg, traffic = cell.config, cell.traffic
    inputs = drv.make_inputs(cfg, seed, device, lambda: 0.0)
    live = inputs["live"]
    order, hp, geometry = drv.reference_setup(cfg, traffic, seed, inputs)
    args = (live, inputs["cams"], inputs["gts"], order, hp,
            torch.zeros(3, device=device), geometry)
    truth = train_steps(*args)
    init = drv.initial_leaves(live, inputs["cams"], geometry)
    ctl = cfg["control"]
    runs = {f"control_{ctl['dtype']}{'_tf32' if ctl['tf32'] else ''}":
            dict(dtype=DTYPES[ctl["dtype"]], tf32=ctl["tf32"])}
    runs.update({f"fault_{f}": dict(fault=f) for f in faults})
    out = []
    for name, kw in runs.items():
        r = train_steps(*args, **kw)
        nums = core.training_numbers(r["losses"], truth["losses"], r["grads"],
                                     truth["grads"], r["after"], truth["after"], init,
                                     drv.own_leaves(hp))
        out.append({"workload": cell.name, "seed": seed, "reading": name, **nums})
    out.append({"workload": cell.name, "seed": seed, "reading": "fault_unchanged",
                "change_gap": 1.0})
    return out


@torch.no_grad()
def render_readings(cell, seed: int, device) -> list:
    from harness.drivers.render import KEPT_VIEWS, OFF

    cfg, traffic = cell.config, cell.traffic
    s_scene, _, s_orbit, s_sample = sc.sub_seeds(seed)
    scene = sc.make_scene(cfg, s_scene, device)
    poses = sc.orbit_cameras(cfg, traffic, s_orbit)
    table = sc.camera_table(poses, cfg["fov"], cfg["fov"], device)
    sample = np.random.default_rng(s_sample).choice(
        len(poses), size=KEPT_VIEWS, replace=False).tolist()
    ctl = cfg["control"]
    dt = DTYPES[ctl["dtype"]]
    fov = torch.tensor(cfg["fov"], device=device)
    max_abs, share = 0.0, 0.0
    saved = torch.backends.cuda.matmul.allow_tf32
    for j in sample:
        R, t = ref_render.camera_pose(table["q_init"][j], table["t_init"][j],
                                      table["dq"][j], table["dt"][j])
        truth = ref_render.render(scene.xyz, scene.scales, scene.quats, scene.opacity,
                                  scene.sh, R, t, fov, fov, cfg["width"], cfg["height"])
        torch.backends.cuda.matmul.allow_tf32 = ctl["tf32"]
        try:
            low = ref_render.render(*(x.to(dt) for x in (
                scene.xyz, scene.scales, scene.quats, scene.opacity, scene.sh, R, t,
                fov, fov)), cfg["width"], cfg["height"])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        d = (low.float() - truth).abs()
        max_abs = max(max_abs, float(d.max()))
        share = max(share, float((d > OFF).float().mean()))
    return [{"workload": cell.name, "seed": seed, "reading": f"control_{ctl['dtype']}",
             "view_max_abs": max_abs, "view_share_off": share}]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", default=None)
    p.add_argument("--program-fault", choices=sorted(PROGRAM_FAULTS), default=None)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    if args.program_fault:
        return faulty_runs(args)
    cell = spec.load_cell(args.workload, args.root)
    device = torch.device(args.device)
    for seed in args.seeds:
        rows = (render_readings(cell, seed, device) if cell.driver == "render"
                else train_readings(cell, seed, device))
        for row in rows:
            print(json.dumps(row), flush=True)
    return 0


def faulty_runs(args) -> int:
    """The benchmark's own run of the cell, once a seed, with the program
    fault planted; one JSON line a run."""
    from harness import cli

    plant(args.program_fault)
    device = None if args.device == "cuda" else args.device
    for seed in args.seeds:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--workload", args.workload, "--seed", str(seed),
                           "--seconds", str(args.seconds), "--trace", "0"],
                          device=device, root=args.root)
        lines = buf.getvalue().strip().splitlines()
        res = json.loads(lines[-1]) if rc == 0 and lines else {}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "reading": f"program_{args.program_fault}", "rc": rc,
                          "correct": res.get("correct"),
                          **{k: v["value"] for k, v in res.get("checks", {}).items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
