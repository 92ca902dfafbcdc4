"""A whole run of each toy cell on the CPU (the harness's look for a card
skipped), sound and with the timed path broken underneath: `correct`
comes out true for the sound program and false for each fault the cell
can have (its driver's `PROGRAM_FAULTS`). The training cells' faults: a step
that returns its state unchanged, and half of the batch (the image's
rows) left out with the mean taken over the rest; the pose cell's also
its camera rows' gradient doubled or dropped. The render cell's: an
answer altered where it is produced. One chip holds every cell, so no
exchange between chips can be left out."""

import pytest

import toy
from harness import faults, spec

CASES = [("pose-train", None), ("pose-train", "unchanged"), ("pose-train", "half"),
         ("pose-train", "cam_x2"), ("pose-train", "cam_x0"),
         ("fisheye-train", None), ("fisheye-train", "unchanged"),
         ("fisheye-train", "half"), ("fisheye-train-late", None),
         ("fisheye-train-late", "unchanged"), ("fisheye-train-late", "half"),
         ("pose-render", None), ("pose-render", "altered")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_faults_come_out_incorrect(tmp_path, capsys, monkeypatch, workload, fault):
    root = toy.make_root(str(tmp_path))
    if fault:
        driver = spec.driver_module(spec.load_cell(workload, root))
        faults.plant(driver, fault, monkeypatch.setattr)
    out = toy.run_cell(root, workload, seconds=0.5, capsys=capsys)
    assert out["correct"] is (fault is None), out["checks"]
