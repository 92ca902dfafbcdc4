"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and one result line.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

With `--trace 0` the line's metrics are the cell's end-to-end metrics,
with `--trace 1` its per-layer metrics, read from two profiled segments
run after the window: one of device events only (the idle share, kernel
times) and one with the host's operations (idle gaps by what the host
was doing, spans around calls into the program). The last lines on
standard error, and the result's last key `checks`, give each number
compared beside its limit; the lines before them the card and its power
limit, and the run's own notes. The run exits
with 2 and prints no result without enough CUDA cards, and with 3 if JAX
or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch

from . import core, spec


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def per_layer(cell: spec.Cell, run: core.Run) -> dict:
    out = {}
    for m in cell.per_layer:
        value = spec.metric_reader(cell, m.name)(run)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    return out


def main(argv=None, device: Optional[str] = None, root: Optional[str] = None,
         age=core.process_age) -> int:
    """Run one cell once. `device` None means the card, checked first;
    tests pass "cpu" to drive the rest of a run at a toy size."""
    args = parse(argv)
    cell = spec.load_cell(args.workload, root)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"perfbench: the cell needs {cell.chips} CUDA card(s), "
                  f"found {n}", file=sys.stderr)
            return 2
        device = "cuda"
    run = spec.driver_module(cell).run(cell, args.seed, args.seconds, bool(args.trace),
                                       torch.device(device), age)
    bad = core.forbidden_modules()
    if bad:
        print(f"perfbench: loaded after the window: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    if args.trace:
        metrics = per_layer(cell, run)
        breakdown = {"device_ops": run.trace.device_ops(),
                     "idle_gaps": run.host_trace.idle_gaps()}
        dev = core.device_info(cell.chips, run.peak_bytes)
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    else:
        metrics = {m.name: {"value": float(run.e2e[m.name]), "unit": m.unit}
                   for m in cell.end_to_end}
        breakdown = None
        dev = core.device_info(cell.chips, run.peak_bytes)
    correct = run.failed == 0 and all(v <= lim for v, lim in run.checks.values())
    if device == "cuda":
        print(f"perfbench: card {core.power_limit()}", file=sys.stderr)
    for note in run.notes:
        print(f"perfbench: {note}", file=sys.stderr)
    for k, (v, lim) in run.checks.items():
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}",
              file=sys.stderr)
    print(core.result_line(correct, run, metrics, dev, breakdown), flush=True)
    return 0
