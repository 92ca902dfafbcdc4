"""A toy copy of the benchmark for CPU tests: the repository's
`BENCHMARK.json` and data files under a temporary root, each
configuration cut to 64x48 views of 2,000 Gaussians in 4,096 slots and 4
cameras, the orbit to 8 views. A configuration that gives sizes in pixels
lists their key paths under `pixel_keys` ("focal", "cubemap.mask_radius"),
and the cut scales each with the width. The harness's code is the
repository's.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)
if REPO not in sys.path:
    sys.path.append(REPO)


def _scaled(value, factor):
    if isinstance(value, list):
        return [_scaled(v, factor) for v in value]
    return value * factor


def toy_config(cfg: dict, width: int = 64, height: int = 48, n: int = 2000) -> dict:
    cfg = json.loads(json.dumps(cfg))
    for path in cfg.get("pixel_keys", []):
        *groups, key = path.split(".")
        node = cfg
        for g in groups:
            node = node[g]
        node[key] = _scaled(node[key], width / cfg["width"])
    cfg["width"], cfg["height"] = width, height
    cfg["scene"]["n_gaussians"] = n
    cfg["scene"]["scale_range"] = [0.03 * 64 / width, 0.12 * 64 / width]
    cfg["capacity"] = 2 * n
    cfg["cameras"]["n"] = 4
    return cfg


def make_root(root: str, **size) -> str:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for sub in ("traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(root, "perfbench", sub),
                        dirs_exist_ok=True)
    os.makedirs(os.path.join(root, "perfbench", "configs"), exist_ok=True)
    for c in spec["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = toy_config(json.load(f), **size)
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(cfg, f)
    path = os.path.join(root, "perfbench", "traffic", "orbit-closed-loop.json")
    with open(path) as f:
        tr = json.load(f)
    tr["orbit"]["period"] = 8
    with open(path, "w") as f:
        json.dump(tr, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


def assert_resolves(cell) -> None:
    """A cell's driver declares its contract (`harness/spec.py`), its
    limits cover every number in the module's `CHECKS`, and each of its
    metrics has a reader."""
    from harness import spec

    drv = spec.driver_module(cell)
    assert drv.FAMILY in ("train", "render")
    assert callable(drv.run) and callable(drv.control_readings)
    assert set(drv.CHECKS) <= set(cell.limits)
    for targets, wrap in drv.PROGRAM_FAULTS.values():
        assert targets and callable(wrap)
    assert {m.name for m in cell.end_to_end} >= {"setup_s", "peak_mem_gib"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.metric_reader(cell, m.name))
    assert cell.chips == 1


def run_cell(root: str, workload: str, seed: int = 2147483905, seconds: float = 1.0,
             trace: int = 0, capsys=None) -> dict:
    """One CPU run of a toy cell through the harness's `main`; returns the
    parsed result line (its stdout's last line)."""
    from harness import cli

    t0 = time.time()
    rc = cli.main(["--workload", workload, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], device="cpu", root=root,
                  age=lambda: time.time() - t0)
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
