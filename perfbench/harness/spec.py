"""Finding a cell's files by the names `BENCHMARK.json` gives.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
The configuration's file is the `file` of its `configs` entry; the traffic
mix is `<bench>/traffic/<traffic>.json`, which names the driver that runs
it (`harness/drivers/<driver>.py`); the cell's limits of correctness are
`<bench>/limits/<workload>.json`; a per-layer metric's reader is
`<bench>/metrics/<name>.py`. So a later change adds a configuration, a
cell, a metric or a driver with new files and entries, and edits none.

A driver module (`driver_module`) declares its contract; the harness,
`controls.py` and the tests take everything about a driver from it:

- `FAMILY`: "train" or "render", which the driver's `core.Run.driver`
  carries, so that the per-layer readers of a family read a new driver
  of it;
- `CHECKS`: the names of the numbers behind `correct` that every limits
  file of its cells holds;
- `run(cell, seed, seconds, trace, device, age) -> core.Run`: one run;
  a training driver builds its trainer and hands it to
  `window.train_window`;
- `control_readings(cell, seed, device) -> list`: the rows
  `controls.py` prints for a cell, a dict a seed and reading (the
  control; the faults the reference can plant in itself);
- `PROGRAM_FAULTS`: fault name -> ([(program module, attribute)], wrap),
  the program functions its step calls, for `faults.plant`.

A training driver that makes several renders a step reports
`renders_per_step` in its `Run.work`, and counts the kernels' least
seconds over all of them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Metric:
    name: str
    unit: str


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[Metric]
    per_layer: List[Metric]
    root: str

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(entry: dict, cell: str, e2e_names: List[str]) -> bool:
    """A per-layer metric is read in the cells it lists, or without a
    list in every cell that reports the end-to-end metric it moves."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry["moves"] in e2e_names


def load_cell(workload: str, root: Optional[str] = None) -> Cell:
    """The cell `workload` of `<root>/BENCHMARK.json` with its files read.
    Raises KeyError for an unknown cell and OSError for a missing file."""
    root = root or os.path.dirname(HERE)
    spec = _load_json(os.path.join(root, "BENCHMARK.json"))
    bench = os.path.join(root, spec["paths"][0])
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"({', '.join(cells)})")
    w = cells[workload]
    confs = {c["name"]: c for c in spec["configs"]}
    config = _load_json(os.path.join(root, confs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(bench, "traffic", w["traffic"] + ".json"))
    limits = _load_json(os.path.join(bench, "limits", workload + ".json"))
    e2e = [Metric(m["name"], m["unit"]) for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = [m.name for m in e2e]
    layer = [Metric(m["name"], m["unit"]) for m in spec["per_layer"]
             if _applies(m, workload, names)]
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=layer, root=root)


def metric_reader(cell: Cell, name: str):
    """The `read(run)` function of `<bench>/metrics/<name>.py`."""
    spec = _load_json(os.path.join(cell.root, "BENCHMARK.json"))
    path = os.path.join(cell.root, spec["paths"][0], "metrics", name + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def driver_module(cell: Cell):
    """The module `harness.drivers.<driver>` of the cell's traffic."""
    return importlib.import_module(f"harness.drivers.{cell.driver}")
