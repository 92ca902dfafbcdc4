"""The port's scaling report (`bags_tpu_torch/tools/scaling_report.py`) on
gloo CPU ranks at a cut workload: its table, and the collectives it counts
against the formulas of PERF.md §3 (the packet all-gather moves 15 floats
a slot a view; each neighbour's halo is 2 x 5 rows x W x 6 floats, sent
forward and its gradient back)."""

import pytest
import torch

from bags_tpu_torch.tools import scaling_report
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU_TOY = ["--device", "cpu", "--toy"]


def test_scaling_report_counts_collectives(capsys):
    """--devices 1 2 on gloo CPU ranks at the toy workload (256 slots and
    16 x 64 pixels a rank): a row a point in the printed table, and rank
    0's collectives of one step match the packet and halo formulas (no halo
    at one rank)."""
    rows = scaling_report.main(["--devices", "1", "2"] + CPU_TOY)
    table = capsys.readouterr().out
    assert [r["n"] for r in rows] == [1, 2]
    assert table.count("\n| 1 |") == table.count("\n| 2 |") == 1
    assert "eff." not in table
    for r in rows:
        slots = scaling_report.TOY["slots"] * r["n"]
        c = r["collectives"]
        assert r["pixels"] == 64 * 16 * r["n"] and r["step_ms"] > 0
        assert c["packet_all_gather"] == [1, 15 * 4 * slots]
        assert c["packet_reduce_scatter"] == [1, 15 * 4 * slots]
        halo = [c.get(k, [0, 0])[1] for k in ("halo_send", "halo_grad_send")]
        assert sum(halo) == (r["n"] - 1) * 2 * 5 * 64 * 6 * 4
        assert "image_all_gather" not in c


def test_scaling_report_cuda_needs_the_cards(monkeypatch):
    """The tool runs on the cards unless asked for the CPU: with fewer cards
    than the largest point it raises, by default and with `--device cuda`;
    it does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for device in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="needs 2 cards; 1 visible"):
            scaling_report.main(["--devices", "1", "2"] + device)
