"""Drivers as plug-ins: a cell whose traffic names a driver that only this
test registers (`harness.drivers.toy_two`: the program's `Trainer` with two
cameras a step, so two renders a step, on the shared training window)
resolves, runs to a `correct` result line, prints its control rows
through `controls.py` and comes out not correct with a fault of its own
`PROGRAM_FAULTS` planted. Besides: the training roofline readers with one
and two launches a step, the toy cut's scaling of sizes given in pixels,
and the existing cells' toy result lines against the values the harness
gave before its drivers declared their contracts."""

import json
import os
import sys
import time
import types

import pytest
import torch

import toy  # first: puts the benchmark on the path
import controls
from harness import core, faults, spec

SEED = 2147483911
# Each existing cell's toy run on SEED under a clock that advances 1 s a
# reading, `--seconds 12` (so 12 steps or 6 views in the window), on
# THREADS CPU threads: the checks, `attempted` and the metric names at
# --trace 0 and 1, as the harness before the shared window and the driver
# contracts printed them (PyTorch 2.13 on an x86-64 CPU; the lens net's
# products round by the thread count, so the fisheye gaps change with it).
THREADS = 4
TRAIN_E2E = ["peak_mem_gib", "setup_s", "train_ms_per_iter"]
TRAIN_LAYER = ["idle_share.train", "step_mfu.train"]
BEFORE = {
    "pose-train": (12, {"loss_gap": 0.0, "grad_gap": 8.63933124664686e-07,
                        "change_gap": 2.415585690302075e-07,
                        "cam_gap": 3.959722979283398e-07, "camera_order": 0.0,
                        "config_departures": 0.0}, TRAIN_E2E, TRAIN_LAYER),
    "fisheye-train": (12, {"loss_gap": 0.0, "grad_gap": 1.6309906922250254e-06,
                           "change_gap": 4.656222141727334e-06, "camera_order": 0.0,
                           "config_departures": 0.0}, TRAIN_E2E, TRAIN_LAYER),
    "fisheye-train-late": (12, {"loss_gap": 6.631484431264e-08,
                                "grad_gap": 2.3515413177567237e-06,
                                "change_gap": 5.6861978363286345e-06,
                                "camera_order": 0.0, "config_departures": 0.0},
                           TRAIN_E2E, TRAIN_LAYER),
    "pose-render": (6, {"views_compared": 0.0, "view_max_abs": 1.7881393432617188e-07,
                        "view_share_off": 0.0},
                    ["peak_mem_gib", "render_ms_p95", "render_ms_per_view", "setup_s"],
                    ["idle_share.render", "view_mfu.render"]),
}


class _Clock:
    """A clock that reads 1 s later at every reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", sorted(BEFORE))
def test_result_lines_as_before(tmp_path, capsys, monkeypatch, workload, trace):
    root = toy.make_root(str(tmp_path))
    monkeypatch.setattr(time, "perf_counter", _Clock())
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        out = toy.run_cell(root, workload, seed=SEED, seconds=12, trace=trace,
                           capsys=capsys)
    finally:
        torch.set_num_threads(threads)
    attempted, checks, e2e, layer = BEFORE[workload]
    assert out["correct"] is True
    assert out["attempted"] == attempted
    assert {k: v["value"] for k, v in out["checks"].items()} == checks
    assert sorted(out["metrics"]) == (layer if trace else e2e)


# --- the toy driver: two cameras a step through the program's Trainer ---

def _toy_two():
    """The module `harness.drivers.toy_two`: `--batch_cams 2` on the pose
    configuration through `window.train_window`, its first step's loss
    held against the mean of the reference's first losses of the step's
    two cameras."""
    from bags_tpu_torch.core.camera import CameraParams, CameraStatic
    from bags_tpu_torch.raster.render import RenderConfig
    from bags_tpu_torch.train.loop import Trainer
    from harness import window
    from harness.drivers import train as drv
    from reference.train import train_steps

    mod = types.ModuleType("harness.drivers.toy_two")
    mod.FAMILY = "train"
    mod.CHECKS = ("first_loss_gap", "two_cameras")
    mod.PROGRAM_FAULTS = {"half": drv.PROGRAM_FAULTS["half"]}

    def ref_loss(cell, seed, device, inputs, live, pair, dtype=torch.float32):
        _, hp, _ = drv.reference_setup(cell.config, cell.traffic, seed, inputs)
        bg = torch.zeros(3, device=device)
        return sum(train_steps(live, inputs["cams"], inputs["gts"], [c], hp, bg,
                               dtype=dtype)["losses"][0] for c in pair) / len(pair)

    def run(cell, seed, seconds, trace, device, age):
        cfg, k = cell.config, cell.traffic["batch_cams"]
        inputs = drv.make_inputs(cfg, seed, device, age)
        tc = drv.program_config(dict(cfg, train_args=cfg["train_args"] + [
            "--batch_cams", str(k)]), cell.traffic, seed)
        g, alive = drv._padded(inputs.pop("live"), cfg["capacity"])
        trainer = Trainer(g, alive, CameraParams(**{n: v.clone() for n, v in
                                                    inputs["cams"].items()}),
                          CameraStatic(cfg["width"], cfg["height"]), tc,
                          scene_extent=inputs["extent"], gt_images=inputs["gts"],
                          rcfg=RenderConfig(sh_degree=cfg["scene"]["sh_degree"]),
                          seed=seed)
        trainer.active_sh_degree = cell.traffic["active_sh_degree"]
        prog = window.train_window(trainer, seconds, trace, device, age)
        live = drv.population(cfg, seed, device)[1]
        pair = prog["check_cams"][0]
        nums = {"first_loss_gap": core.rel_gap(
                    prog["losses"][0], ref_loss(cell, seed, device, inputs, live, pair)),
                "two_cameras": 0.0 if all(len(set(c)) == k for c in prog["check_cams"])
                else 1.0}
        return core.Run(driver=mod.FAMILY,
                        e2e={"train_ms_per_iter": prog["ms"], "setup_s": prog["setup_s"],
                             "peak_mem_gib": prog["peak"] / 2 ** 30},
                        attempted=prog["steps"], failed=prog["failed"],
                        checks={n: (v, cell.limits[n]) for n, v in nums.items()},
                        peak_bytes=prog["peak"], trace=prog["trace"],
                        host_trace=prog["host_trace"],
                        traced_steps=len(prog["traced_cams"]),
                        work={"renders_per_step": k})

    def control_readings(cell, seed, device):
        inputs = drv.make_inputs(cell.config, seed, device, lambda: 0.0)
        live, pair = inputs["live"], [0, 1]
        truth = ref_loss(cell, seed, device, inputs, live, pair)
        low = ref_loss(cell, seed, device, inputs, live, pair, dtype=torch.bfloat16)
        return [{"workload": cell.name, "seed": seed, "reading": "control_bfloat16",
                 "first_loss_gap": core.rel_gap(low, truth)}]

    mod.run, mod.control_readings = run, control_readings
    return mod


def _toy_two_root(tmp_path, monkeypatch):
    """A toy root with the cell `pose-train-k2` (traffic `train-k2`, driver
    `toy_two`) added as files and entries, and the driver registered."""
    monkeypatch.setitem(sys.modules, "harness.drivers.toy_two", _toy_two())
    root = toy.make_root(str(tmp_path))
    bench = os.path.join(root, "perfbench")
    with open(os.path.join(bench, "traffic", "train-k2.json"), "w") as f:
        json.dump({"driver": "toy_two", "active_sh_degree": 3, "batch_cams": 2}, f)
    with open(os.path.join(bench, "limits", "pose-train-k2.json"), "w") as f:
        json.dump({"first_loss_gap": 3e-5, "two_cameras": 0.0}, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        s = json.load(f)
    s["workloads"].append({"name": "pose-train-k2", "config": "pose-synthetic-1m",
                           "traffic": "train-k2", "chips": 1, "why": "a test cell"})
    for m in s["end_to_end"] + s["per_layer"]:
        if "pose-train" in m.get("workloads", []):
            m["workloads"].append("pose-train-k2")
    with open(path, "w") as f:
        json.dump(s, f)
    return root


def test_toy_driver_resolves_runs_and_reads_its_controls(tmp_path, capsys, monkeypatch):
    root = _toy_two_root(tmp_path, monkeypatch)
    cell = spec.load_cell("pose-train-k2", root)
    assert not os.path.exists(os.path.join(toy.BENCH, "harness", "drivers", "toy_two.py"))
    toy.assert_resolves(cell)
    out = toy.run_cell(root, "pose-train-k2", capsys=capsys)
    assert out["correct"] is True and out["attempted"] > 0, out["checks"]
    assert out["checks"]["two_cameras"]["value"] == 0.0
    assert controls.main(["--workload", "pose-train-k2", "--seeds", "3",
                          "--device", "cpu", "--root", root]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["reading"] for r in rows] == ["control_bfloat16"]
    assert rows[0]["first_loss_gap"] > cell.limits["first_loss_gap"]


def test_toy_driver_fault_comes_out_incorrect(tmp_path, capsys, monkeypatch):
    root = _toy_two_root(tmp_path, monkeypatch)
    driver = spec.driver_module(spec.load_cell("pose-train-k2", root))
    faults.plant(driver, "half", monkeypatch.setattr)
    out = toy.run_cell(root, "pose-train-k2", capsys=capsys)
    assert out["correct"] is False, out["checks"]
    with pytest.raises(KeyError):
        faults.plant(driver, "altered", monkeypatch.setattr)


def test_no_dispatch_by_driver_name():
    needle = "cell.driver" + " =="
    for dirpath, _, files in os.walk(toy.BENCH):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    assert needle not in f.read(), name


# --- the training roofline readers ---

def _run(launches, traced_steps=3, renders=None):
    work = {"fwd_least_s_traced": 6e-4, "bwd_least_s_traced": 6e-4}
    if renders is not None:
        work["renders_per_step"] = renders
    trace = types.SimpleNamespace(kernels=lambda name: [1e-4] * launches)
    return core.Run(driver="train", e2e={}, attempted=1, failed=0, checks={},
                    peak_bytes=0, trace=trace, traced_steps=traced_steps, work=work)


@pytest.mark.parametrize("name", ["fwd_roofline.train", "bwd_roofline.train"])
def test_roofline_readers_take_several_renders_a_step(name):
    cell = spec.load_cell("pose-train", toy.REPO)
    read = spec.metric_reader(cell, name)
    assert read(_run(3)) == pytest.approx(200.0)             # one launch a step
    assert read(_run(3, renders=1)) == pytest.approx(200.0)
    assert read(_run(6, renders=2)) == pytest.approx(100.0)  # two a step
    assert read(_run(6)) is None                              # a mismatch
    assert read(_run(3, renders=2)) is None
    assert read(_run(0)) is None


# --- the toy cut ---

def test_toy_cut_scales_pixel_sizes():
    cfg = {"width": 1600, "height": 1080, "focal": [309.0, 309.0],
           "cubemap": {"mask_radius": 512, "faces": 5},
           "scene": {"n_gaussians": 10, "scale_range": [0, 0]}, "capacity": 16,
           "cameras": {"n": 8}, "pixel_keys": ["focal", "cubemap.mask_radius"]}
    cut = toy.toy_config(cfg, width=64, height=48)
    assert cut["focal"] == pytest.approx([309.0 * 64 / 1600] * 2)
    assert cut["cubemap"] == {"mask_radius": pytest.approx(512 * 64 / 1600), "faces": 5}
    assert (cut["width"], cut["height"]) == (64, 48)
    plain = toy.toy_config({k: v for k, v in cfg.items() if k != "pixel_keys"})
    assert plain["focal"] == [309.0, 309.0] and plain["cubemap"]["mask_radius"] == 512
