#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from, beside the
program's own: the control (the plain reference computed in the precision
just below the configuration's, as its `control` names it) and the faults
a cell can have, each read against the float32 reference at the cell's
own size. The benchmark's runs never run this.

    python3 perfbench/controls.py --workload pose-train --seeds 11 12 13

Prints one JSON line a seed and reading: the rows of the cell's driver's
`control_readings` (for a training driver the control's and the "half"
fault's loss_gap, grad_gap and change_gap, and cam_gap where camera rows
train; for the render driver the control's view_max_abs and
view_share_off over the seed's sampled views).

With `--program-fault NAME` it runs the benchmark itself instead, once a
seed, with the fault NAME of the cell's driver's `PROGRAM_FAULTS` planted
in the program, and prints each run's `correct` and checks:

    python3 perfbench/controls.py --workload pose-train --seeds 11 12 13 \
        --program-fault cam_x2 --seconds 1
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.append(os.path.dirname(HERE))

import torch  # noqa: E402

from harness import faults, spec  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--root", default=None)
    p.add_argument("--program-fault", default=None)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload, args.root)
    driver = spec.driver_module(cell)
    if args.program_fault:
        return faulty_runs(args, driver)
    device = torch.device(args.device)
    for seed in args.seeds:
        for row in driver.control_readings(cell, seed, device):
            print(json.dumps(row), flush=True)
    return 0


def faulty_runs(args, driver) -> int:
    """The benchmark's own run of the cell, once a seed, with the program
    fault planted; one JSON line a run."""
    from harness import cli

    faults.plant(driver, args.program_fault)
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
