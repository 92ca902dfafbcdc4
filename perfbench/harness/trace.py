"""The traced segment of a run: `torch.profiler` over a few steps, read
back from its Chrome trace.

`capture(fn, host)` runs fn() under the profiler in a segment that ends
in a synchronise, and returns a `Trace`: the device's busy time in the
segment (the union of kernels, copies and sets), the segment's length,
device time by kernel name, idle gaps by what the host was doing in them,
and device time attributed to spans the benchmark opened around calls
into the program (`attributed_seconds`): a span's own launches and
those of the backward nodes that its operations created, matched by the
autograd sequence number the profiler records on both.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
WINDOW = "bench.traced"
BACKWARD = "autograd::engine::evaluate_function: "


def short_name(name: str) -> str:
    """A kernel's name without "void ", "(anonymous namespace)::" and its
    argument list, at most 96 characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:96]


class Trace:
    """A segment's events. With host events the segment is the
    "bench.traced" span; without them (`window_s` given) it is the host's
    clock around the segment, which ends in a synchronise, and every
    device event of the trace lies in it."""

    def __init__(self, events: List[dict], window_s: Optional[float] = None):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = sorted((e for e in xs if e.get("cat") in DEVICE_CATS),
                             key=lambda e: e["ts"])
        self.host = [e for e in xs if e.get("cat") in HOST_CATS]
        self.runtime = [e for e in xs if e.get("cat") in ("cuda_runtime", "cuda_driver")]
        win = [e for e in xs if e.get("name") == WINDOW]
        if window_s is not None:
            self._window_s = window_s
            self.t0 = min((float(e["ts"]) for e in self.device), default=0.0)
            self.t1 = max((float(e["ts"]) + float(e["dur"]) for e in self.device),
                          default=0.0)
            self.main_tid = None
        elif win:
            w = max(win, key=lambda e: e["dur"])
            self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
            self._window_s = (self.t1 - self.t0) * 1e-6
            self.main_tid = w.get("tid")
        else:
            raise RuntimeError("the trace has no traced window")

    @property
    def window_s(self) -> float:
        return self._window_s

    def _busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for e in self.device:
            a = max(float(e["ts"]), self.t0)
            b = min(float(e["ts"]) + float(e["dur"]), self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy_intervals()) * 1e-6

    def kernels(self, contains: str) -> List[float]:
        """Durations (s) of the kernels whose name contains `contains`."""
        return [float(e["dur"]) * 1e-6 for e in self.device
                if e.get("cat") == "kernel" and contains in e.get("name", "")
                and self.t0 <= float(e["ts"]) <= self.t1]

    def device_ops(self, top: int = 10) -> List[list]:
        tot: Dict[str, float] = collections.Counter()
        for e in self.device:
            if self.t0 <= float(e["ts"]) <= self.t1:
                tot[short_name(e.get("name", "?"))] += float(e["dur"]) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle time inside the window, summed by the innermost host
        operation of the main thread that covers each gap's middle."""
        gaps, cur = [], self.t0
        for a, b in self._busy_intervals():
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if cur < self.t1:
            gaps.append((cur, self.t1))
        main = sorted((e for e in self.host if e.get("tid") == self.main_tid
                       and e.get("name") != WINDOW),
                      key=lambda e: (float(e["ts"]), -float(e["dur"])))
        tot: Dict[str, float] = collections.Counter()
        stack: List[dict] = []
        i = 0
        for a, b in gaps:                       # gaps come in time order
            mid = 0.5 * (a + b)
            while i < len(main) and float(main[i]["ts"]) <= mid:
                stack.append(main[i])
                i += 1
            while stack and float(stack[-1]["ts"]) + float(stack[-1]["dur"]) < mid:
                stack.pop()
            name = stack[-1]["name"][:80] if stack else "python"
            tot["host: " + name] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def attributed_seconds(self, span: str) -> Optional[float]:
        """Device seconds of the launches made inside the host spans named
        `span`, and inside the backward nodes created by the operations in
        those spans. None when the trace holds no such span."""
        spans = [e for e in self.host if e.get("name") == span]
        if not spans:
            return None
        windows = collections.defaultdict(list)
        for s in spans:
            windows[s.get("tid")].append(
                (float(s["ts"]), float(s["ts"]) + float(s["dur"])))
        merged = {tid: _merge(w) for tid, w in windows.items()}
        seqs = set()
        for e in self.host:
            seq = (e.get("args") or {}).get("Sequence number")
            if seq is not None and not e.get("name", "").startswith(BACKWARD) \
                    and _inside(merged.get(e.get("tid")), float(e["ts"])):
                seqs.add(seq)
        for e in self.host:
            if e.get("name", "").startswith(BACKWARD) and \
                    (e.get("args") or {}).get("Sequence number") in seqs:
                windows[e.get("tid")].append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        merged = {tid: _merge(w) for tid, w in windows.items()}
        corr = set()
        for r in self.runtime:
            if _inside(merged.get(r.get("tid")), float(r["ts"])):
                c = (r.get("args") or {}).get("correlation")
                if c is not None:
                    corr.add(c)
        return sum(float(e["dur"]) * 1e-6 for e in self.device
                   if (e.get("args") or {}).get("correlation") in corr)


def _merge(ws):
    out: List[List[float]] = []
    for a, b in sorted(ws):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [o[0] for o in out], [o[1] for o in out]


def _inside(merged, t: float) -> bool:
    if not merged:
        return False
    starts, ends = merged
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ends[i]


def capture(fn, host: bool) -> Trace:
    """Run fn() under the profiler and read the trace back (the file lives
    in a temporary directory under TMPDIR and is removed). With `host` the
    profiler records the host's operations too, inside the "bench.traced"
    span, which costs host time on every operation; without it only the
    device's, and the segment's length is the host's clock around it."""
    import time

    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    acts = ([ProfilerActivity.CPU] if host or not cuda else []) + \
        ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            fn()
            if cuda:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="perfbench-trace-") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return Trace(events, None if host or not cuda else window_s)
