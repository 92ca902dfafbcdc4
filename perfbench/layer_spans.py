"""The program's own spans in a run's host-traced segment, as the
per-layer metrics read them.

The program opens a span "bags.<layer>" around each layer of its step and
view (`bags_tpu_torch/utils/spans.py`), on the profiler's clock. A
layer's device time is `Trace.attributed_seconds` of its span: the
launches made inside it and inside the backward nodes its operations
created. Every reader returns None where the trace holds none of the
spans it reads, as a program without them gives, and where it holds no
device event (a run on the CPU).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

PREFIX = "bags."
# the layer spans whose device time the *_ms metrics read; "lens" only in
# the fisheye cells
TRAIN_LAYERS = ("projection", "binning", "gather", "composite", "loss",
                "optimizers", "lens")
RENDER_LAYERS = ("projection", "binning", "gather", "composite")


def _traced(run, driver: str):
    tr = run.host_trace
    if run.driver != driver or tr is None or not tr.device or not run.traced_steps:
        return None
    return tr


def layer_ms(run, driver: str, *layers: str) -> Optional[float]:
    """Device ms a traced step (or view) under the spans `layers`, summed;
    None if the trace lacks one of them."""
    tr = _traced(run, driver)
    if tr is None:
        return None
    total = 0.0
    for layer in layers:
        s = tr.attributed_seconds(PREFIX + layer)
        if s is None:
            return None
        total += s
    return 1e3 * total / run.traced_steps


def other_ms(run, driver: str, layers: Tuple[str, ...]) -> Optional[float]:
    """The host-traced segment's device ms a step (or view), every kernel,
    copy and set summed, less the device ms under every layer span of
    `layers` the trace holds: the work no layer span covers. Summed
    durations on both sides, so that kernels overlapping in time count
    alike in each. None without the projection span."""
    tr = _traced(run, driver)
    if tr is None or tr.attributed_seconds(PREFIX + "projection") is None:
        return None
    total = sum(float(e["dur"]) for e in tr.device
                if tr.t0 <= float(e["ts"]) <= tr.t1) * 1e-6
    covered = sum(tr.attributed_seconds(PREFIX + layer) or 0.0 for layer in layers)
    return 1e3 * (total - covered) / run.traced_steps


def _windows(tr, names: Tuple[str, ...]) -> List[Tuple[float, float]]:
    """The intervals of the main thread's spans `names`, merged."""
    out: List[List[float]] = []
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in tr.host if e.get("name") in names
                       and e.get("tid") == tr.main_tid):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _inside(windows: List[Tuple[float, float]], t: float) -> bool:
    return any(a <= t <= b for a, b in windows)


def idle_ms_inside(run, driver: str, layer: str) -> Optional[float]:
    """Device idle ms a step in the host-traced segment whose gap's middle
    lies inside the main thread's span `layer`; None without the span."""
    tr = _traced(run, driver)
    if tr is None:
        return None
    windows = _windows(tr, (PREFIX + layer,))
    if not windows:
        return None
    idle, cur = 0.0, tr.t0
    for a, b in tr._busy_intervals() + [(tr.t1, tr.t1)]:
        if a > cur and _inside(windows, 0.5 * (cur + a)):
            idle += a - cur
        cur = max(cur, b)
    return 1e-3 * idle / run.traced_steps


def launches(run, driver: str, layers: Tuple[str, ...]) -> Optional[float]:
    """Kernel launches a step (or view) made on the main thread inside the
    spans `layers`; None without them."""
    tr = _traced(run, driver)
    if tr is None:
        return None
    windows = _windows(tr, tuple(PREFIX + layer for layer in layers))
    if not windows:
        return None
    corr = {(r.get("args") or {}).get("correlation") for r in tr.runtime
            if r.get("tid") == tr.main_tid and _inside(windows, float(r["ts"]))}
    corr.discard(None)
    n = sum(1 for e in tr.device if e.get("cat") == "kernel"
            and (e.get("args") or {}).get("correlation") in corr)
    return n / run.traced_steps
