"""A toy copy of the benchmark for CPU tests: the repository's
`BENCHMARK.json` and data files under a temporary root, each
configuration cut to 64x48 views of 2,000 Gaussians in 4,096 slots and 4
cameras, the orbit to 8 views. The harness's code is the repository's.
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


def toy_config(cfg: dict, width: int = 64, height: int = 48, n: int = 2000) -> dict:
    cfg = json.loads(json.dumps(cfg))
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
