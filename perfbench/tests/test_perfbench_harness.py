"""The harness: every cell of BENCHMARK.json resolves to its files by
name, a cell added as files and entries alone is found and runs, a run
prints one result line with the keys the contract names, loads neither
JAX nor the JAX package, and exits without a result where there is no card
or no program."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

import toy
from harness import spec

SPEC = json.load(open(os.path.join(toy.REPO, "BENCHMARK.json")))
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_resolves(workload):
    cell = spec.load_cell(workload, toy.REPO)
    assert os.path.exists(os.path.join(toy.BENCH, "harness", "drivers",
                                       cell.driver + ".py"))
    toy.assert_resolves(cell)


def test_contract_shapes():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.load(open(os.path.join(toy.REPO, c["file"])))
        assert cfg["reduced"] == c["reduced"] and cfg["name"] == c["name"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    assert json.dumps(SPEC).isascii() and len(json.dumps(SPEC)) < 64 * 1024


def _add_cell(root):
    """A cell of files and entries alone: new traffic on the training
    driver, its limits and a new per-layer metric with its reader."""
    bench = os.path.join(root, "perfbench")
    tr = json.load(open(os.path.join(bench, "traffic", "train-sh3.json")))
    tr.update(active_sh_degree=1)
    json.dump(tr, open(os.path.join(bench, "traffic", "train-sh1.json"), "w"))
    shutil.copy(os.path.join(bench, "limits", "pose-train.json"),
                os.path.join(bench, "limits", "pose-train-sh1.json"))
    with open(os.path.join(bench, "metrics", "steps.train.py"), "w") as f:
        f.write(textwrap.dedent('''
            def read(run):
                return float(run.attempted) if run.driver == "train" else None
        '''))
    spec_path = os.path.join(root, "BENCHMARK.json")
    s = json.load(open(spec_path))
    s["workloads"].append({"name": "pose-train-sh1", "config": "pose-synthetic-1m",
                           "traffic": "train-sh1", "chips": 1, "why": "a test cell"})
    for m in s["end_to_end"]:
        if "train-sh1" not in m.get("workloads", ["pose-train-sh1"]):
            if "pose-train" in m.get("workloads", []):
                m["workloads"].append("pose-train-sh1")
    s["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher",
                           "source": "program_counter", "layer": "whole step",
                           "moves": "train_ms_per_iter",
                           "workloads": ["pose-train-sh1"]})
    json.dump(s, open(spec_path, "w"))


def test_cell_added_as_files_alone_is_found_and_runs(tmp_path, capsys):
    root = toy.make_root(str(tmp_path))
    _add_cell(root)
    cell = spec.load_cell("pose-train-sh1", root)
    assert cell.traffic["active_sh_degree"] == 1
    assert "steps.train" in [m.name for m in cell.per_layer]
    out = toy.run_cell(root, "pose-train-sh1", trace=1, capsys=capsys)
    assert out["correct"] is True
    assert out["metrics"]["steps.train"]["value"] == out["attempted"] > 0


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(tmp_path, capsys, trace):
    root = toy.make_root(str(tmp_path))
    out = toy.run_cell(root, "pose-train", trace=trace, capsys=capsys)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(out["metrics"]) <= {"idle_share.train", "step_mfu.train",
                                       "fwd_roofline.train", "bwd_roofline.train"}
        assert "step_mfu.train" in out["metrics"]
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert out["device"]["window_s"] > 0
    else:
        assert set(out["metrics"]) == {"train_ms_per_iter", "setup_s", "peak_mem_gib"}
    for v in out["checks"].values():
        assert set(v) == {"value", "limit"}


def test_no_jax_after_a_run(tmp_path):
    root = toy.make_root(str(tmp_path))
    code = textwrap.dedent(f'''
        import sys, time
        sys.path.insert(0, {toy.BENCH!r}); sys.path.append({toy.REPO!r})
        from harness import cli, core
        t = time.time()
        rc = cli.main(["--workload", "pose-render", "--seed", "5", "--seconds", "0.5",
                       "--trace", "0"], device="cpu", root={root!r},
                      age=lambda: time.time() - t)
        print("RC", rc, "LOADED", sorted({{m.split(".")[0] for m in sys.modules}}
                                          & {{"jax", "jaxlib", "flax", "bags_tpu"}}))
    ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path))
    assert "RC 0 LOADED []" in out.stdout, out.stdout + out.stderr


def test_forbidden_modules_compare_whole_names(monkeypatch):
    from harness import core
    monkeypatch.setitem(sys.modules, "bags_tpu_torch_fake", sys)
    assert "bags_tpu" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "bags_tpu.fake", sys)
    assert "bags_tpu" in core.forbidden_modules()


def test_no_result_without_a_card_or_the_program(tmp_path):
    bare = tmp_path / "bare"
    bare.mkdir()
    shutil.copy(os.path.join(toy.REPO, "BENCHMARK.json"), bare)
    shutil.copytree(toy.BENCH, bare / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (toy.REPO, str(bare)):
        out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                              "pose-train", "--seed", "1", "--seconds", "1",
                              "--trace", "0"], capture_output=True, text=True,
                             timeout=300, cwd=cwd,
                             env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0 and out.stdout.strip() == "", out.stdout

