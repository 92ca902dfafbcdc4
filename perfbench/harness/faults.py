"""The faults a driver can have planted in the program, and the precisions
its controls compute in.

A driver's `PROGRAM_FAULTS` maps a fault's name to `(targets, wrap)`:
`targets` the `(program module, attribute)` pairs its step calls, and
`wrap(real)` the broken function put in each one's place. `plant` puts
them there; `perfbench/controls.py --program-fault NAME` and the fault
tests run the benchmark on the broken program.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def unchanged(real):
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


def half(real):
    """The loss over the top half of the rows only."""
    def loss(pred, gt, *a, **k):
        h = pred.shape[-2] // 2
        return real(pred[..., :h, :], gt[..., :h, :], *a, **k)
    return loss


def altered(real):
    """A view whose first pixel is off by 0.5."""
    def render(*a, **k):
        out = real(*a, **k)
        img = out.render.clone()
        img[:, 0, 0] += 0.5
        return dataclasses.replace(out, render=img)
    return render


def cam_scaled(factor):
    """The camera row's pose gradient scaled by `factor` before its Adam
    step (and in the moments the comparison reads)."""
    def wrap(real):
        def update(cams, st, row_grads, idx, lrs):
            row_grads = {f: g * factor if f in ("dq", "dt") else g
                         for f, g in row_grads.items()}
            return real(cams, st, row_grads, idx, lrs)
        return update
    return wrap


def plant(driver, fault: str, setattr_=setattr):
    """Plant the fault `fault` of the driver module `driver`'s
    `PROGRAM_FAULTS` with `setattr_(module, name, value)` (a test passes
    its monkeypatch's)."""
    if fault not in driver.PROGRAM_FAULTS:
        raise KeyError(f"driver {driver.__name__} has no fault {fault!r} "
                       f"({', '.join(sorted(driver.PROGRAM_FAULTS))})")
    targets, wrap = driver.PROGRAM_FAULTS[fault]
    for mod_name, attr in targets:
        mod = importlib.import_module(mod_name)
        setattr_(mod, attr, wrap(getattr(mod, attr)))
