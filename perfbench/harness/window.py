"""The measured window of a training driver, shared by every driver whose
program trains through a trainer's own `run`.

`train_window` takes a built trainer: an object with `step(idx, gt, it)`,
which `run` calls once a step with the step's camera (or list of
cameras), `run(iterations, callback=None)`, whose callback gets
`(it, state, metrics)` with `metrics.loss` after each step and which
counts its iterations from 1 in each call, and `close()`. It records the
camera of every step; drives `run` through the CHECK_STEPS steps the
reference follows, reading the driver's `grads(trainer)` after the first
and `leaves(trainer)` after the last, then WARMUP_STEPS more; then calls
`run` in chunks of CHUNK iterations until `seconds` have passed: no densify
step (after iteration 500) and no opacity reset falls in the window. The
window's time ends in a synchronise; the peak memory is read from its
start to its end.

With `trace`, two profiled segments of TRACED_STEPS steps each follow
the window: the first records the device alone, the second the host too,
inside `host_spans()`, a context manager in which the driver may wrap
program functions in spans of its own (`bench.lens`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import torch

from .trace import capture

CHECK_STEPS = 3      # the steps the reference follows; the limits are set at 3
WARMUP_STEPS = 2
CHUNK = 100          # under 500, where densify starts: no densify in the window
TRACED_STEPS = 6


class _WindowClosed(Exception):
    pass


def _cams(idx):
    """A step's camera as a number, or its list of cameras as a list."""
    return [int(i) for i in idx] if isinstance(idx, (list, tuple)) else int(idx)


def train_window(trainer, seconds: float, trace: bool, device, age,
                 grads: Optional[Callable] = None, leaves: Optional[Callable] = None,
                 host_spans: Callable = contextlib.nullcontext) -> dict:
    """Set-up's checked and warm-up steps, the window and the traced
    segments of `trainer` (module doc); closes the trainer. Returns
    `setup_s` (the process's age when warm), `built_s` and `checked_s`
    (its age before and after the checked steps), `ms` a step, `steps`,
    `failed` (non-finite losses), `peak` bytes, the cameras of the
    checked, window and first traced steps, `losses` of the checked
    steps, `grads` and `after` as the driver's readers gave them, and the
    two traces (None without `trace`)."""
    seq: List[object] = []
    step = trainer.step

    def recorded_step(idx, gt, it=None):
        seq.append(_cams(idx))
        return step(idx, gt, it)

    trainer.step = recorded_step
    rec: Dict[str, object] = {"losses": []}

    def check_cb(it, state, metrics):
        rec["losses"].append(float(metrics.loss))
        if it == 1 and grads is not None:
            rec["grads"] = grads(trainer)
        if it == CHECK_STEPS and leaves is not None:
            rec["after"] = leaves(trainer)

    built_s = age()
    trainer.run(CHECK_STEPS, callback=check_cb)
    checked_s = age()
    trainer.run(WARMUP_STEPS)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = age()

    losses_w: List[torch.Tensor] = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    deadline = t0 + seconds

    def window_cb(it, state, metrics):
        losses_w.append(metrics.loss)
        if time.perf_counter() >= deadline:
            raise _WindowClosed

    start = len(seq)
    while True:
        try:
            trainer.run(CHUNK, callback=window_cb)
        except _WindowClosed:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    window_cams = seq[start:]
    steps = len(losses_w)
    failed = int((~torch.isfinite(torch.stack(losses_w))).sum()) if steps else 0

    tr, host_tr, traced_cams = None, None, []
    if trace:
        t_start = len(seq)
        tr = capture(lambda: trainer.run(TRACED_STEPS), host=False)
        traced_cams = seq[t_start:]
        with host_spans():
            host_tr = capture(lambda: trainer.run(TRACED_STEPS), host=True)
    trainer.close()
    return dict(setup_s=setup_s, built_s=built_s, checked_s=checked_s,
                ms=1e3 * (t1 - t0) / max(steps, 1), steps=steps, failed=failed,
                peak=peak, check_cams=seq[:CHECK_STEPS], window_cams=window_cams,
                traced_cams=traced_cams, trace=tr, host_trace=host_tr, **rec)
