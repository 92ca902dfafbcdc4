"""The yardstick's counts: the frozen kernel arithmetic equals the
program's `utils/profiling.py` on the tools' toy workload, and a
population's dead slots add no work."""

import pytest
import torch

import toy  # noqa: F401
import counts
from harness import work
from reference import render as ref_render

from bags_tpu_torch.utils import profiling


@pytest.fixture(scope="module")
def toy_rows():
    return profiling.toy_workload(3000, 96, None, "cpu")


def test_frozen_counts_equal_the_program(toy_rows):
    _, _, bins, rows, tx, ty = toy_rows
    a = profiling.pair_counts(rows, bins.tile_start, bins.tile_count, tx, ty)
    b = counts.pair_counts(rows, bins.tile_start, bins.tile_count, tx, ty)
    assert tuple(a) == tuple(b) and a.included > 0
    m, nt = bins.n_instances, tx * ty
    assert counts.fwd_ops(b) == profiling.fwd_ops(a)
    assert counts.bwd_ops(b) == profiling.bwd_ops(a)
    assert counts.fwd_bytes(m, nt) == profiling.fwd_bytes(m, nt)
    assert counts.bwd_bytes(m, nt) == profiling.bwd_bytes(m, nt)
    assert counts.bound(1e9, 1e12) == profiling.bound(1e9, 1e12)
    assert (counts.PEAK_BYTES_PER_S, counts.PEAK_FP32_PER_S) == \
        (profiling.PEAK_BYTES_PER_S, profiling.PEAK_FP32_PER_S)


def _population(n=1500, dead=2500, seed=1):
    g = torch.Generator().manual_seed(seed)
    live = {"xyz": torch.stack([torch.rand(n, generator=g) * 3 - 1.5,
                                torch.rand(n, generator=g) * 3 - 1.5,
                                4 + 4 * torch.rand(n, generator=g)], -1),
            "sh_dc": torch.randn((n, 1, 3), generator=g),
            "sh_rest": 0.1 * torch.randn((n, 15, 3), generator=g),
            "scales_log": torch.log(0.03 + 0.09 * torch.rand((n, 3), generator=g)),
            "quats": torch.randn((n, 4), generator=g),
            "opacity_raw": torch.randn(n, generator=g)}
    fill = {"scales_log": -10.0, "opacity_raw": -10.0}
    full = {k: torch.cat([v, torch.full((dead,) + v.shape[1:], fill.get(k, 0.0))])
            for k, v in live.items()}
    perm = torch.randperm(n + dead, generator=g)
    full = {k: v[perm] for k, v in full.items()}
    alive = (torch.arange(n + dead) < n)[perm]
    return live, full, alive


@pytest.mark.parametrize("lens_points", [0, 48])
def test_dead_slots_add_no_work(lens_points):
    live, full, alive = _population()
    R = torch.eye(3)
    t = torch.zeros(3)
    fov = torch.tensor(0.8)
    a = work.step_work(full, alive, R, t, fov, fov, 64, 48, 3, lens_points, True)
    b = work.step_work(live, None, R, t, fov, fov, 64, 48, 3, lens_points, True)
    assert a["terms"] == b["terms"] and a["step"] == b["step"] and a["instances"] > 0
    c = work.view_work(full, alive, R, t, fov, fov, 64, 48, 3)
    d = work.view_work(live, None, R, t, fov, fov, 64, 48, 3)
    assert c["terms"] == d["terms"]
    # a population counted with its dead slots as if live would count more
    e = work.step_work(full, None, R, t, fov, fov, 64, 48, 3, lens_points, True)
    assert e["step"] > b["step"]


def test_step_terms_count_the_lens():
    p = counts.Pairs(100, 90, 80, 70, 60, 50)
    plain = counts.step_terms(1000, p, 500, 12, 64, 48)
    fish = counts.step_terms(1000, p, 500, 12, 64, 48, lens_points=6700, lens_trained=True)
    late = counts.step_terms(1000, p, 500, 12, 64, 48, lens_points=6700)
    assert set(fish) - set(plain) == {"lens_inverse", "lens_backward", "warp"}
    assert "lens_backward" not in late
    # 12 Newton iterations of 5 blocks over 6,700 points: about 1.9 TFLOP
    assert 1.8e12 < fish["lens_inverse"][0] < 2.0e12
    assert counts.least_seconds(fish) > counts.least_seconds(late) > \
        counts.least_seconds(plain)
    assert ref_render.TILE == counts.TILE_W
