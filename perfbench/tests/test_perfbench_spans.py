"""The readers of the program's spans (`layer_spans.py` and the metrics
that call it) against a hand-built Chrome trace whose every number is
worked out by hand, and silent where the program opens no span."""

import pytest

import toy
from harness import core, spec
from harness.trace import Trace

MAIN, AUTOGRAD = 1, 2
STEPS = 2       # the traced steps the numbers are divided by


def _x(name, ts, dur, tid=MAIN, cat="user_annotation", **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _launch(ts, corr, k_ts, k_dur, tid=MAIN):
    """A launch on thread `tid` at `ts` and its kernel on the device."""
    return [_x("cudaLaunchKernel", ts, 2, tid, "cuda_runtime", correlation=corr),
            _x(f"kernel_{corr}", k_ts, k_dur, 7, "kernel", correlation=corr)]


def _events(spans=True):
    """One traced segment (0-1000 us) of a step: each layer span's
    launches, the backward nodes of a projection and a compositing
    operation on the autograd thread, a gradient copy (AccumulateGrad, no
    sequence number) and a launch outside every span. Device time 330 us:
    projection 50 + 30 (its backward), binning 20, gather 10, composite
    40 + 100, loss 20, lens 10, optimizers 30, the copy 10, outside 10."""
    ev = [_x("bench.traced", 0, 1000)]
    if spans:
        ev += [_x("bags.step", 10, 900), _x("bags.projection", 20, 80),
               _x("bags.render", 110, 200), _x("bags.binning", 120, 30),
               _x("bags.gather", 160, 20), _x("bags.composite", 190, 60),
               _x("bags.loss", 320, 30), _x("bags.lens", 355, 30),
               _x("bags.backward", 400, 300), _x("bags.optimizers", 720, 50)]
    ev += [_x("aten::mul", 30, 10, cat="cpu_op", **{"Sequence number": 7}),
           _x("CompositeFwd", 195, 3, cat="cpu_op", **{"Sequence number": 9})]
    ev += _launch(35, 1, 100, 50) + _launch(125, 2, 160, 20) + \
        _launch(165, 3, 185, 10) + _launch(200, 4, 200, 40) + \
        _launch(330, 5, 330, 20) + _launch(362, 11, 365, 10)
    bwd = "autograd::engine::evaluate_function: "
    ev += [_x(bwd + "MulBackward0", 410, 20, AUTOGRAD, "cpu_op",
              **{"Sequence number": 7}),
           _x(bwd + "CompositeFwdBackward", 460, 20, AUTOGRAD, "cpu_op",
              **{"Sequence number": 9}),
           _x(bwd + "torch::autograd::AccumulateGrad", 600, 10, AUTOGRAD, "cpu_op")]
    ev += _launch(415, 6, 420, 30, AUTOGRAD) + _launch(465, 7, 470, 100, AUTOGRAD) + \
        _launch(605, 8, 610, 10, AUTOGRAD) + _launch(730, 9, 730, 30) + \
        _launch(950, 10, 950, 10)
    return ev


def _run(driver, events):
    return core.Run(driver=driver, e2e={}, attempted=STEPS, failed=0, checks={},
                    peak_bytes=0, host_trace=Trace(events), traced_steps=STEPS)


def _read(name, run):
    cell = spec.load_cell("pose-train", toy.REPO)
    return spec.metric_reader(cell, name)(run)


# us a step, by hand from `_events` (1 us = 1e-3 ms)
TRAIN = {"projection_ms.train": 80 / STEPS, "binning_ms.train": 30 / STEPS,
         "composite_ms.train": 140 / STEPS, "loss_ms.train": 20 / STEPS,
         "optim_ms.train": 30 / STEPS, "lens_ms.train": 10 / STEPS,
         # 330 in all less 310 under the layer spans
         "other_ms.train": 20 / STEPS,
         # gaps 450-470, 570-610 and 620-730 lie in the backward
         "backward_idle_ms.train": (20 + 40 + 110) / STEPS}
RENDER = {"projection_ms.render": 80 / STEPS, "binning_ms.render": 30 / STEPS,
          "composite_ms.render": 140 / STEPS,
          # 330 in all less the projection, binning, gather and composite
          "other_ms.render": (330 - 250) / STEPS}


@pytest.mark.parametrize("name", sorted(TRAIN) + sorted(RENDER))
def test_reader_by_hand(name):
    want = {**TRAIN, **RENDER}[name] * 1e-3
    got = _read(name, _run(name.rsplit(".", 1)[1], _events()))
    assert got == pytest.approx(want, rel=1e-9)


def test_other_counts_overlapping_kernels_whole():
    """A kernel outside every span that runs while a projection kernel
    runs still counts its whole time in `other_ms`: device time is summed,
    not merged, on both sides of the difference."""
    events = _events()
    (late,) = [e for e in events if e["name"] == "kernel_10"]
    late["ts"] = 120                     # inside kernel_1's 100-150
    assert _read("other_ms.train", _run("train", events)) == \
        pytest.approx(TRAIN["other_ms.train"] * 1e-3, rel=1e-9)


def test_launches_by_hand():
    """Four launches of the main thread lie in the render and projection
    spans: two a view."""
    assert _read("launches.render", _run("render", _events())) == 4 / STEPS


@pytest.mark.parametrize("name", sorted(TRAIN) + sorted(RENDER) + ["launches.render"])
def test_reader_silent_without_spans(name):
    """The parent program opens no span, and a run on the CPU records no
    device event: no number either way, and no error."""
    driver = name.rsplit(".", 1)[1]
    assert _read(name, _run(driver, _events(spans=False))) is None
    no_device = [e for e in _events() if e["cat"] != "kernel"]
    assert _read(name, _run(driver, no_device)) is None
    assert _read(name, core.Run(driver=driver, e2e={}, attempted=1, failed=0,
                                checks={}, peak_bytes=0)) is None
