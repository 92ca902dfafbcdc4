"""The cubemap cell (`cubemap-train`, `harness/drivers/cubemap.py`) on the
CPU: it resolves through `spec.load_cell`; its toy cut (focal and disc
radius scaled with the width through `pixel_keys`) runs `correct` at
`--trace 0` and `1`; `controls.py` prints its rows, and the reference's
own faults fail the limits; each of the driver's program faults fails a
check; the net's, rays' and warps' counts match a count by hand; a face's
distance-keyed count of instances is the program's, and the reference's
face poses are the program's sub-cameras bit for bit (nearly equal
distances to a face's centre would otherwise bin in another order); the
new readers stay silent where the program gives nothing to read."""

import json
import os

import pytest
import torch

import toy
import controls
import counts
import cubemap_counts
from harness import core, faults, spec
from harness.drivers import cubemap as drv

CELL = "cubemap-train"
NEW = ("cubemap_rays_ms.train", "face_warp_ms.train", "face_instances.cubemap")


def test_cell_resolves():
    cell = spec.load_cell(CELL, toy.REPO)
    toy.assert_resolves(cell)
    assert spec.driver_module(cell) is drv
    assert set(NEW) <= {m.name for m in cell.per_layer}
    assert cell.config["reduced"] == [] and cell.chips == 1


def test_toy_cut_scales_focal_and_radius(tmp_path):
    cfg = spec.load_cell(CELL, toy.make_root(str(tmp_path))).config
    assert cfg["focal"] == pytest.approx([309.0 * 64 / 1600] * 2)
    assert cfg["cubemap"]["mask_radius"] == pytest.approx(512 * 64 / 1600)


@pytest.mark.parametrize("trace", [0, 1])
def test_toy_cut_runs_correct(tmp_path, capsys, trace):
    root = toy.make_root(str(tmp_path))
    out = toy.run_cell(root, CELL, trace=trace, capsys=capsys)
    assert out["correct"] is True and out["attempted"] > 0, out["checks"]
    assert set(out["checks"]) == set(drv.CHECKS)
    if trace:
        # on the CPU no device event: the span readers stay silent, the
        # program's counter is read
        assert out["metrics"]["face_instances.cubemap"]["value"] > 0
        assert "cubemap_rays_ms.train" not in out["metrics"]


def test_controls_prints_its_rows(tmp_path, capsys):
    """The reference's own faults fail the limits at the toy size; TF32
    exists only on a CUDA card, so the control's row is printed and not
    held to them here."""
    root = toy.make_root(str(tmp_path))
    limits = spec.load_cell(CELL, root).limits
    assert controls.main(["--workload", CELL, "--seeds", "3", "--device", "cpu",
                          "--root", root]) == 0
    rows = {r["reading"]: r for r in map(json.loads, capsys.readouterr().out.splitlines())}
    assert set(rows) == {"control_float32_tf32", "fault_half",
                         "fault_side_faces_dropped", "fault_unchanged"}
    for name in ("fault_half", "fault_side_faces_dropped", "fault_unchanged"):
        assert any(rows[name][k] > limits[k] for k in limits if k in rows[name]), name
    assert rows["fault_side_faces_dropped"]["loss_gap"] > limits["loss_gap"]


@pytest.mark.parametrize("fault", sorted(drv.PROGRAM_FAULTS))
def test_program_fault_fails_a_check(tmp_path, capsys, monkeypatch, fault):
    root = toy.make_root(str(tmp_path))
    faults.plant(drv, fault, monkeypatch.setattr)
    out = toy.run_cell(root, CELL, seconds=0.5, capsys=capsys)
    assert out["correct"] is False, out["checks"]
    if fault == "side_faces_dropped":
        c = out["checks"]["loss_gap"]
        assert c["value"] > c["limit"]


def test_net_rays_and_warp_counts_by_hand():
    # a block: 2 -> 512 (1,024 products, 512 biases), 3 x 512 -> 512
    # (262,144 and 512 each), 512 -> 2 (1,024 and 2): 790,530 parameters
    assert cubemap_counts.net_params() == 5 * 790_530
    # products 2 x (1,024 + 3 x 262,144 + 1,024) = 1,576,960 a point and
    # block, ELU 6 x 4 x 512 = 12,288; 27,000 points, 5 blocks
    t = cubemap_counts.net_terms(27_000)
    assert t["net_fwd"] == (135_000 * 1_589_248, 4 * 3_952_650 + 432_000)
    assert t["net_bwd"] == (135_000 * 3_166_208, 8 * 3_952_650 + 432_000)
    assert t["net_fwd"][0] + t["net_bwd"][0] == 641_986_560_000
    px = 1600 * 1080
    assert cubemap_counts.ray_terms(1600, 1080) == {"rays": (72 * px, 20 * px)}
    # gather 2 x 3 x 16 and reprojection 2 x 10 a pixel; 48 + 24 bytes
    assert cubemap_counts.warp_terms(1600, 1080) == (116 * px, 72 * px)


def test_step_terms_count_five_faces():
    pairs = counts.Pairs(100, 90, 80, 70, 95, 85)
    faces = [(pairs, 10 + i, 12) for i in range(5)]
    t = cubemap_counts.step_terms(1000, faces, 32, 24, 12)
    for piece in ("projection", "binning", "composite_fwd", "composite_bwd", "loss",
                  "warp"):
        assert sorted(k for k in t if k.startswith(piece + ".")) == \
            [f"{piece}.{i}" for i in range(5)]
    assert sorted(k for k in t if k.startswith("projection_bwd.")) == \
        [f"projection_bwd.{i}" for i in range(1, 5)]
    assert t["binning.3"] == (0, 12 * 13 + 8 * 12)
    assert {"projection_bwd_adam", "net_fwd", "net_bwd", "rays"} <= set(t)


def test_face_counts_are_the_programs_binning(tmp_path):
    """One toy face: the reference's distance-keyed instance count equals
    the program's distance-sorted binning's."""
    from bags_tpu_torch.core.camera import CameraParams, CameraStatic
    from bags_tpu_torch.raster.render import RenderConfig, render

    cfg = spec.load_cell(CELL, toy.make_root(str(tmp_path))).config
    dev = torch.device("cpu")
    inputs = drv.make_inputs(cfg, 5, dev, lambda: 0.0)
    live, cams = inputs["live"], inputs["cams"]
    faces = cubemap_counts.camera_faces(live, cams, 2, cfg["width"], cfg["height"], 3)
    q, t = drv.ref_cube.face_poses(cams["q_init"][2], cams["t_init"][2])
    for f in range(5):
        cam = CameraParams(q_init=q[f], t_init=t[f], dq=cams["dq"][2], dt=cams["dt"][2],
                           fovx=cams["fovx"][2], fovy=cams["fovy"][2])
        out = render(live["xyz"], torch.exp(live["scales_log"]), live["quats"],
                     torch.sigmoid(live["opacity_raw"]),
                     torch.cat([live["sh_dc"], live["sh_rest"]], 1), cam,
                     CameraStatic(cfg["width"], cfg["height"]),
                     RenderConfig(sh_degree=3, sort_by_distance=True))
        assert faces[f][1] == out.gauss_id.shape[0] > 0


def test_face_poses_are_the_programs_sub_cameras():
    from bags_tpu_torch.core.camera import CameraParams
    from bags_tpu_torch.train.calibrated import sub_camera_poses

    cfg = spec.load_cell(CELL, toy.REPO).config
    fovx, fovy = drv.fovs(cfg)
    cams = drv.sc.camera_table(drv.rig_cameras(cfg), fovx, fovy, torch.device("cpu"))
    sub_q, sub_t = sub_camera_poses(CameraParams(**{k: v.clone() for k, v in cams.items()}))
    for i in range(cfg["cameras"]["n"]):
        q, t = drv.ref_cube.face_poses(cams["q_init"][i], cams["t_init"][i])
        assert torch.equal(q[1:], sub_q[i]) and torch.equal(t[1:], sub_t[i]), i
        assert torch.equal(q[0], cams["q_init"][i])


@pytest.mark.parametrize("name", NEW)
def test_new_readers_silent_without_their_source(name):
    cell = spec.load_cell(CELL, toy.REPO)
    read = spec.metric_reader(cell, name)
    run = core.Run(driver="train", e2e={}, attempted=1, failed=0, checks={},
                   peak_bytes=0, traced_steps=6)
    assert read(run) is None
    if name == "face_instances.cubemap":
        run.work = {"face_instances": 123.0}
        assert read(run) == 123.0
        assert read(core.Run(driver="render", e2e={}, attempted=1, failed=0,
                             checks={}, peak_bytes=0, traced_steps=6,
                             work=run.work)) is None


@pytest.mark.parametrize("path", ["reference/cubemap.py", "cubemap_counts.py"])
def test_yardstick_imports_nothing_of_the_program(path):
    import ast

    tree = ast.parse(open(os.path.join(toy.BENCH, path)).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    assert not names & {"bags_tpu", "bags_tpu_torch", "jax", "jaxlib", "flax", "harness"}
