"""Port parity, the render CLI: `python -m bags_tpu_torch.cli.render
--device cpu` against the JAX `render.py --ply_only --backend jnp` on the
same dataset and JAX-written PLY model."""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from bags_tpu.model import gaussians as jg
from bags_tpu_torch.cli import render as port_cli
from test_data import _write_colmap_scene


def _model(tmp_path, scene_root, centre):
    """A JAX-written PLY at iteration 7, Gaussians around `centre`."""
    rng = np.random.default_rng(2)
    pts = (rng.normal(size=(300, 3)) * 0.8 + centre).astype(np.float32)
    g, alive = jg.create_from_points(pts, rng.random((300, 3)).astype(np.float32),
                                     300, sh_degree=1)
    g = dataclasses.replace(
        g, opacity_raw=g.opacity_raw + 2.0,
        sh_rest=g.sh_rest + rng.normal(size=g.sh_rest.shape).astype(np.float32) * 0.2)
    out = str(tmp_path / "model")
    ply_dir = os.path.join(out, "point_cloud", "iteration_7")
    os.makedirs(ply_dir)
    jg.save_ply(os.path.join(ply_dir, "point_cloud.ply"), g, alive)
    return out


def _lookat_scene(root):
    from bags_tpu_torch.utils.testing import make_lookat_cameras, write_colmap_scene

    rng = np.random.default_rng(4)
    cams = make_lookat_cameras(4, 0.9, 0.7, device="cpu")
    fx, fy = 64 / (2 * np.tan(0.45)), 48 / (2 * np.tan(0.35))
    pts = rng.normal(size=(50, 3)) + [0, 0, 6]
    write_colmap_scene(root, cams, 64, 48, fx, fy, pts, rng.random((50, 3)),
                       images=[(rng.random((48, 64, 3)) * 255).astype(np.uint8)
                               for _ in cams])


def _psnrs(text):
    return [float(x) for x in re.findall(r"\(PSNR ([0-9.]+)\)", text)]


@pytest.mark.parametrize("dataset", ["random_cams", "lookat_cams"])
def test_cli_matches_jax_render_cli(tmp_path, capsys, dataset):
    import render as jax_cli

    root = str(tmp_path / "scene")
    os.makedirs(root)
    if dataset == "random_cams":
        _write_colmap_scene(root, n_cams=4, rng=np.random.default_rng(9))
        centre = (0.0, 0.0, 0.0)
    else:
        _lookat_scene(root)
        centre = (0.0, 0.0, 6.0)
    model = _model(tmp_path, root, centre)
    common = ["-m", model, "-s", root, "--ply_only", "--sh_degree", "1",
              "--white_background"]

    jax_cli.main(common + ["--backend", "jnp", "--max_instances", "16384"])
    jax_out = capsys.readouterr().out
    jax_tree = {}
    for dirpath, _, files in os.walk(model):
        for f in files:
            if f.endswith(".png"):
                p = os.path.join(dirpath, f)
                jax_tree[os.path.relpath(p, model)] = np.asarray(Image.open(p), np.int16)
                os.remove(p)

    summary = port_cli.main(common + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    port_tree = {}
    for dirpath, _, files in os.walk(model):
        for f in files:
            if f.endswith(".png"):
                p = os.path.join(dirpath, f)
                port_tree[os.path.relpath(p, model)] = np.asarray(Image.open(p), np.int16)

    assert sorted(port_tree) == sorted(jax_tree) and len(port_tree) == 16
    for k in jax_tree:
        assert np.abs(port_tree[k] - jax_tree[k]).max() <= 1, k
    renders = [v for k, v in port_tree.items() if "renders" in k]
    assert any((r < 250).mean() > 0.01 for r in renders), "nothing in view"
    pj, pp = _psnrs(jax_out), _psnrs(port_out)
    assert len(pj) == len(pp) == 2
    np.testing.assert_allclose(pp, pj, atol=0.01)
    assert [len(s["psnr"]) for s in summary.values()] == [4, 4]


def test_cli_max_instances_reports_drops(tmp_path, capsys):
    root = str(tmp_path / "scene")
    os.makedirs(root)
    _lookat_scene(root)
    model = _model(tmp_path, root, (0.0, 0.0, 6.0))
    port_cli.main(["-m", model, "-s", root, "--ply_only", "--sh_degree", "1",
                   "--skip_train", "--max_instances", "64", "--device", "cpu"])
    assert "past --max_instances" in capsys.readouterr().out


def test_cli_unported_paths_raise(tmp_path):
    root = str(tmp_path / "scene")
    os.makedirs(root)
    _lookat_scene(root)
    model = _model(tmp_path, root, (0.0, 0.0, 6.0))
    with pytest.raises(NotImplementedError, match="slice 2"):
        port_cli.main(["-m", model, "-s", root, "--device", "cpu",
                       "--optim_test_pose_iter", "5"])
    only_ckpt = str(tmp_path / "ckpt_model")
    os.makedirs(only_ckpt)
    open(os.path.join(only_ckpt, "chkpnt100.npz"), "wb").close()
    with pytest.raises(NotImplementedError, match="checkpoint restore"):
        port_cli.main(["-m", only_ckpt, "-s", root, "--device", "cpu"])


def test_cli_without_device_needs_a_card(tmp_path, monkeypatch):
    """No --device and no usable card: the CLI raises instead of running on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_cli.main(["-m", str(tmp_path), "-s", str(tmp_path), "--ply_only"])
