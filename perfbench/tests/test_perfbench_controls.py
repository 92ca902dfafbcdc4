"""The controls at a toy size: the plain reference computed in the
precision just below each configuration's (its file's `control`) fails
at least one of the cell's numbers against its limit, and so does the
"half" fault. TF32 exists only on the card, so the fisheye control runs
there (`gpu`, at 320x216 and 40,000 Gaussians); on the card every
control runs at the cell's own size through `perfbench/controls.py`."""

import json
import os

import pytest
import torch

import toy
import controls
from harness import spec


def _fails(row: dict, limits: dict) -> bool:
    return any(row[k] > limits[k] for k in limits if k in row)


def _readings(root, workload, device):
    cell = spec.load_cell(workload, root)
    rows = spec.driver_module(cell).control_readings(cell, 2147483907, device)
    return cell, rows


@pytest.mark.parametrize("workload", ["pose-train", "pose-render"])
def test_bfloat16_control_fails(tmp_path, workload):
    root = toy.make_root(str(tmp_path))
    cell, rows = _readings(root, workload, torch.device("cpu"))
    assert rows and all(_fails(r, cell.limits) for r in rows), rows


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["fisheye-train", "fisheye-train-late"])
def test_tf32_control_fails_on_the_card(tmp_path, workload):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on a CUDA card")
    root = toy.make_root(str(tmp_path), width=320, height=216, n=40000)
    cell, rows = _readings(root, workload, torch.device("cuda"))
    assert rows and all(_fails(r, cell.limits) for r in rows), rows


def test_controls_prints_one_line_a_reading(tmp_path, capsys):
    root = toy.make_root(str(tmp_path))
    assert controls.main(["--workload", "pose-train", "--seeds", "3",
                          "--device", "cpu", "--root", root]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert {r["reading"] for r in lines} == {"control_bfloat16", "fault_half",
                                              "fault_unchanged"}
    assert os.path.basename(controls.__file__) == "controls.py"
