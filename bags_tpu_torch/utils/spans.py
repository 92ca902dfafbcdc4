"""Named spans over the program's layers.

    with span("projection"):
        ...

With no `torch.profiler` recording and no listener installed, `span`
returns one shared no-op context: the check reads the profiler's own flag,
a fraction of a microsecond, where an ungated `record_function` costs
microseconds on every call. With the profiler on, the span is a
`record_function("bags.<name>")`: a host event in the same trace and on
the same clock as the device's events. With a listener installed
(`listening(fn)`), fn(name, "enter") and fn(name, "exit") are called at
its boundaries (the stage splits of `tools/stagebench.py`).

The layer spans (`LAYERS`) never nest: one opened while another layer's
span is open on the same thread is the no-op, so an activation called
inside the loss stays the loss's. "step" and "render" hold layer spans.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

LAYERS = frozenset(("projection", "binning", "gather", "composite", "loss",
                    "backward", "optimizers", "lens"))
PREFIX = "bags."

_NOOP = contextlib.nullcontext()
_listener: Optional[Callable[[str, str], None]] = None
_open = threading.local()


def span(name: str):
    """The context of span `name` (module doc)."""
    if _listener is None and not _profiler._is_profiler_enabled:
        return _NOOP
    layer = name in LAYERS
    if layer and getattr(_open, "layer", None) is not None:
        return _NOOP
    return _span(name, layer, _listener)


@contextlib.contextmanager
def _span(name: str, layer: bool, listener):
    if layer:
        _open.layer = name
    if listener is not None:
        listener(name, "enter")
    try:
        if _profiler._is_profiler_enabled:
            with record_function(PREFIX + name):
                yield
        else:
            yield
    finally:
        if layer:
            _open.layer = None
        if listener is not None:
            listener(name, "exit")


@contextlib.contextmanager
def listening(fn: Callable[[str, str], None]):
    """Call fn(name, "enter" | "exit") at every span boundary inside."""
    global _listener
    outer, _listener = _listener, fn
    try:
        yield
    finally:
        _listener = outer
