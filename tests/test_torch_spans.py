"""The program's spans (`bags_tpu_torch/utils/spans.py`) on the CPU: off
they are one shared no-op; under `torch.profiler` a training step opens
every layer's span inside "bags.step", no two layer spans overlapping; a
listener sees a view's spans in order, and the stage split times a step by
them; and the profiler changes no number of a step. A cubemap step opens
its ray field's and each face's warp span inside "lens" and counts each
face's binned instances."""

import contextlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bags_tpu_torch.core.camera import CameraStatic
from bags_tpu_torch.raster import binning
from bags_tpu_torch.raster.render import RenderConfig, render
from bags_tpu_torch.tools import stagebench
from bags_tpu_torch.train import calibrated, loop
from bags_tpu_torch.utils import spans
from bags_tpu_torch.utils.testing import cubemap_toy, make_toy_scene, pose_toy
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

RENDER_SPANS = ("projection", "binning", "gather", "composite")


def test_span_is_the_shared_noop_when_off():
    assert not torch.autograd.profiler._is_profiler_enabled
    for name in ("step", "render", "projection", "loss"):
        assert spans.span(name) is spans.span("lens")
    with spans.listening(lambda name, event: None):
        assert spans.span("loss") is not spans.span("lens")
    assert spans.span("loss") is spans.span("lens")


def _pose_trainer():
    toy = pose_toy("cpu")
    s = toy["state"]
    return loop.Trainer(s.g, s.alive, s.cams, toy["static"], toy["cfg"], 2.0,
                        torch.stack([toy["gt"]] * 2),
                        rcfg=RenderConfig(sh_degree=3), seed=1)


def _fisheye_trainer():
    toy = pose_toy("cpu")
    s, cfg = toy["state"], toy["cfg"]
    c = cfg.calib
    c.opt_distortion = c.outside_rasterizer = c.no_init_iresnet = True
    c.flow_scale, c.control_point_sample_scale = (2.0, 2.0), 8
    w, h = toy["static"].width, toy["static"].height
    return calibrated.CalibTrainer(s.g, s.alive, s.cams, CameraStatic(w, h), cfg,
                                   2.0, torch.stack([toy["gt"]] * 2),
                                   focal_x=40.0, focal_y=40.0, persp_wh=(w, h),
                                   rcfg=RenderConfig(sh_degree=3), seed=1)


@pytest.mark.parametrize("mode", ["pose", "fisheye"])
def test_step_opens_every_layer_span(mode, tmp_path):
    """One `run(1)` under the profiler: every layer span, "bags.lens" only
    in the fisheye mode, each inside "bags.step", and no two layer spans
    overlapping on a thread."""
    trainer = _pose_trainer() if mode == "pose" else _fisheye_trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.run(1)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith(spans.PREFIX)]
    names = {e["name"][len(spans.PREFIX):] for e in events}
    want = set(spans.LAYERS) | {"step", "render"}
    assert names == (want if mode == "fisheye" else want - {"lens"})
    (step,) = [e for e in events if e["name"] == "bags.step"]
    layers = sorted((e for e in events
                     if e["name"][len(spans.PREFIX):] in spans.LAYERS),
                    key=lambda e: e["ts"])
    for e in layers:
        assert step["ts"] <= e["ts"] and \
            e["ts"] + e["dur"] <= step["ts"] + step["dur"], e["name"]
        assert e["tid"] == step["tid"]
    for a, b in zip(layers, layers[1:]):
        assert a["ts"] + a["dur"] <= b["ts"], (a["name"], b["name"])


def test_listener_sees_a_view_in_order():
    """`listening` sees `render()`'s spans in order; a layer span opened
    inside another layer's (an activation inside the loss) stays silent."""
    sc = make_toy_scene(n=60, width=32, height=32, sh_degree=0, device="cpu")
    seen = []
    with spans.listening(lambda name, event: seen.append((name, event))):
        render(sc["xyz"], sc["scales"], sc["quats"], sc["opacity"],
               sc["sh_coeffs"], sc["cam"], sc["static"], RenderConfig(sh_degree=0))
        with spans.span("loss"), spans.span("projection"):
            pass
    want = [("render", "enter")]
    for name in RENDER_SPANS:
        want += [(name, "enter"), (name, "exit")]
    assert seen == want + [("render", "exit"), ("loss", "enter"), ("loss", "exit")]
    assert spans.span("loss") is spans.span("lens")


def test_profiler_changes_no_number_of_a_step():
    """A pose step's loss and every gradient, bit for bit, with the
    profiler on and off."""
    out = []
    for on in (False, True):
        toy = pose_toy("cpu")
        with profile(activities=[ProfilerActivity.CPU]) if on else \
                contextlib.nullcontext():
            out.append(loop.train_step(toy["state"], toy["gt"], 0, torch.zeros(3),
                                       toy["static"], RenderConfig(sh_degree=3),
                                       toy["cfg"]))
    off, on = out
    assert torch.equal(off.loss, on.loss) and torch.equal(off.image, on.image)
    assert off.grads.keys() == on.grads.keys()
    for k in off.grads:
        assert torch.equal(off.grads[k], on.grads[k]), k


def test_stage_split_times_the_real_step():
    """`stagebench.stage_split` of `train_step` charges a time to every
    layer span of the step, and to nothing but its spans and "other"."""
    toy = pose_toy("cpu")
    stages = stagebench.stage_split(lambda: loop.train_step(
        toy["state"], toy["gt"], 0, torch.zeros(3), toy["static"],
        RenderConfig(sh_degree=3), toy["cfg"]), reps=1)
    assert set(stagebench.STEP_STAGES) <= set(stages) <= \
        set(stagebench.STEP_STAGES) | {"render", "other"}
    assert all(v >= 0 for v in stages.values())


def test_cubemap_step_spans_and_face_counts(monkeypatch):
    """Under a listener a toy cubemap step opens "cubemap_rays" once and
    "face_warp" five times, each inside "lens" and nowhere else; off, both
    are the shared no-op. The step's metrics carry the five faces' binned
    instance counts, binning's own `n_instances` in FACES order."""
    assert spans.span("cubemap_rays") is spans.span("face_warp") is spans.span("lens")
    toy = cubemap_toy("cpu")
    binned = []
    real = binning.bin_gaussians

    def counted(*a, **k):
        bins = real(*a, **k)
        binned.append(bins.n_instances)
        return bins

    monkeypatch.setattr(binning, "bin_gaussians", counted)
    seen = []
    with spans.listening(lambda name, event: seen.append((name, event))):
        m = calibrated.cubemap_train_step(
            toy["state"], toy["gt"], 0, torch.zeros(3), toy["sub_q"][0],
            toy["sub_t"][0], toy["setup"], RenderConfig(sh_degree=1), toy["cfg"],
            toy["schedules"])
    lens = [i for i, (name, _) in enumerate(seen) if name == "lens"]
    assert len(lens) == 2
    inside = seen[lens[0] + 1:lens[1]]
    assert inside == [("cubemap_rays", "enter"), ("cubemap_rays", "exit")] + \
        [("face_warp", "enter"), ("face_warp", "exit")] * 5
    assert sum(name in ("cubemap_rays", "face_warp") for name, _ in seen) == 12
    assert len(binned) == 5 and min(binned) > 0
    assert m.face_instances == binned
