"""What every driver shares: a run's record, the numbers that decide
`correct`, the device's description and the result line.

The comparison of a training run follows the benchmark's rule: each
step's loss against the reference's (relative gap), the first gradient
and the parameters' change after the checked steps by the worst leaf,
each leaf's gap between the program's norm and the reference's taken
against the larger of that leaf's reference norm and the median leaf's.
The trained camera rows' first gradients are held besides against their
own norms, since against the median leaf no fault of theirs would show.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "bags_tpu")


@dataclasses.dataclass
class Run:
    """What a driver hands back to the harness."""

    driver: str
    e2e: Dict[str, float]                 # by end-to-end metric name
    attempted: int
    failed: int
    checks: Dict[str, tuple]              # name -> (value, limit)
    peak_bytes: int
    trace: object = None                  # trace.Trace, device events only
    host_trace: object = None             # trace.Trace, host and device
    traced_steps: int = 0
    work: Dict[str, float] = dataclasses.field(default_factory=dict)
    lens_s: Optional[float] = None        # attributed lens seconds, traced
    notes: List[str] = dataclasses.field(default_factory=list)


def process_age() -> float:
    """Seconds since this process started (Linux: /proc/self/stat against
    the boot clock)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(chips: int, peak_bytes: int) -> dict:
    if torch.cuda.is_available():
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def rel_gap(p: float, r: float) -> float:
    return abs(p - r) / max(abs(r), 1e-30)


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             keys: List[str]) -> float:
    """max over the leaves `keys` of | |prog| - |ref| | / max(|ref|, the
    median leaf's |ref|)."""
    if not keys:
        return 0.0
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in keys}
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    med = statistics.median(rn.values())
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys)


def own_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
            keys: List[str]) -> float:
    """max over the leaves `keys` of | |prog| - |ref| | / |ref|: each leaf
    against its own norm."""
    gaps = [abs(float(torch.linalg.vector_norm(prog[k].double()))
                - float(torch.linalg.vector_norm(ref[k].double())))
            / max(float(torch.linalg.vector_norm(ref[k].double())), 1e-30) for k in keys]
    return max(gaps, default=0.0)


def training_numbers(losses_p: List[float], losses_r: List[float],
                     grads_p: Dict[str, torch.Tensor], grads_r: Dict[str, torch.Tensor],
                     after_p: Dict[str, torch.Tensor], after_r: Dict[str, torch.Tensor],
                     init: Dict[str, torch.Tensor],
                     own: List[str] = ()) -> Dict[str, float]:
    """loss_gap, grad_gap and change_gap of a training run (module doc),
    and with leaves `own` their cam_gap: the first gradient of each of
    those small leaves (the trained camera rows, orders of magnitude
    under the median leaf) against its own norm.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's move under Adam by rounding alone and are left out of the
    change; a leaf the reference leaves unmoved (a learning rate of 0)
    must stay unmoved in the program, or the change reads 1."""
    if len(losses_p) != len(losses_r) or not all(map(math.isfinite, losses_p)):
        loss_gap = math.inf
    else:
        loss_gap = max(rel_gap(p, r) for p, r in zip(losses_p, losses_r))
    keys = sorted(set(grads_p) & set(grads_r))
    grad_gap = leaf_gap(grads_p, grads_r, keys) if set(grads_p) == set(grads_r) \
        else math.inf
    gn = {k: float(torch.linalg.vector_norm(grads_r[k].double())) for k in keys}
    floor = 1e-3 * statistics.median(gn.values()) if gn else 0.0
    d_p = {k: after_p[k] - init[k] for k in after_r}
    d_r = {k: after_r[k] - init[k] for k in after_r}
    moved, change_gap = [], 0.0
    for k in after_r:
        if not bool((d_r[k] != 0).any()):
            if bool((d_p[k] != 0).any()):
                change_gap = max(change_gap, 1.0)
        elif gn.get(k, math.inf) >= floor:
            moved.append(k)
    change_gap = max(change_gap, leaf_gap(d_p, d_r, moved))
    out = {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
    if own:
        out["cam_gap"] = own_gap(grads_p, grads_r, list(own)) \
            if set(own) <= set(grads_p) else math.inf
    return out


def fmt(x) -> float:
    """A number for the JSON line (inf and NaN as a large number)."""
    x = float(x)
    return x if math.isfinite(x) else 1e300


def result_line(correct: bool, run: Run, metrics: Dict[str, dict], device: dict,
                breakdown: Optional[dict]) -> str:
    out = {"correct": bool(correct), "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": fmt(v), "limit": fmt(l)}
                     for k, (v, l) in run.checks.items()}
    return json.dumps(out)
