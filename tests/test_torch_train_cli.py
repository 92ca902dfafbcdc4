"""Port parity, checkpoints and the CLIs of training: save / load round
trips, resuming, a checkpoint written by the JAX package restored in the
port's render CLI, and `python -m bags_tpu_torch.cli.train` followed by the
render CLI's restore and test-time pose optimisation (CPU)."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from bags_tpu.data.scene import Scene as JScene
from bags_tpu.train import checkpoint as jckpt
from bags_tpu.train import config as jconfig
from bags_tpu.train import loop as jloop
from bags_tpu_torch.cli import render as render_cli
from bags_tpu_torch.cli import train as train_cli
from bags_tpu_torch.core.camera import CameraParams
from bags_tpu_torch.model.gaussians import create_from_points, load_ply
from bags_tpu_torch.raster.render import RenderConfig, render
from bags_tpu_torch.train import checkpoint as tckpt
from bags_tpu_torch.train import loop as tloop
from bags_tpu_torch.train.config import TrainConfig
from bags_tpu_torch.utils.testing import make_toy_scene
from test_data import _write_colmap_scene
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

G_FIELDS = ("xyz", "sh_dc", "sh_rest", "scales_log", "quats", "opacity_raw")
CAM_FIELDS = ("q_init", "t_init", "dq", "dt", "fovx", "fovy")


def _state(cfg):
    """A small port TrainState: 80 Gaussians (capacity 128, SH 1) in front of
    two cameras."""
    sc = make_toy_scene(n=80, width=32, height=32, sh_degree=1, seed=4, device="cpu")
    g, alive = create_from_points(sc["xyz"].numpy(), np.full((80, 3), 0.5, np.float32),
                                  128, 1, device="cpu")
    cams = CameraParams.stack([sc["cam"], dataclasses.replace(
        sc["cam"], t_init=torch.tensor([0.05, 0.0, 0.0]))])
    return tloop.init_train_state(g, alive, cams, cfg, 2.0, seed=3), sc["static"]


def _steps(state, static, cfg, idxs):
    gt = torch.as_tensor(np.random.default_rng(0).uniform(size=(3, 32, 32))
                         .astype(np.float32))
    for i in idxs:
        tloop.train_step(state, gt, i, torch.zeros(3), static, RenderConfig(sh_degree=1),
                         cfg)


def _all_leaves(state):
    out = {k: v.detach().clone() for k, v in tckpt._model_leaves(state).items()}
    out.update({k: v.detach().clone() for k, v in tckpt._optimizer_leaves(state).items()})
    out["step"] = torch.tensor(state.step)
    return out


def _cfg():
    cfg = TrainConfig()
    cfg.calib.opt_cam = cfg.calib.opt_intrinsic = True
    cfg.model.sh_degree = 1
    return cfg


def test_checkpoint_round_trip_and_resume(tmp_path):
    """save -> load restores every leaf bit for bit, the optimizer states
    included; the resumed state's next step equals the uninterrupted one."""
    cfg = _cfg()
    state, static = _state(cfg)
    _steps(state, static, cfg, [0, 1, 1])
    torch.randn(3, generator=state.gen)          # move the split-noise state
    path = str(tmp_path / "chkpnt3.npz")
    tckpt.save_checkpoint(path, state)
    fresh, _ = _state(cfg)
    tckpt.load_checkpoint(path, fresh)
    a, b = _all_leaves(state), _all_leaves(fresh)
    assert sorted(a) == sorted(b) and len(a) > 30
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(torch.randn(3, generator=fresh.gen),
                       torch.randn(3, generator=state.gen))
    _steps(state, static, cfg, [0])
    _steps(fresh, static, cfg, [0])
    a, b = _all_leaves(state), _all_leaves(fresh)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert tckpt.find_max_iteration(str(tmp_path), r"chkpnt(\d+)\.npz") == 3


def test_checkpoint_names_match_jax(tmp_path):
    """The model, camera, alignment and statistics leaves carry the JAX
    package's v2 names."""
    cfg = _cfg()
    state, _ = _state(cfg)
    path = str(tmp_path / "c.npz")
    tckpt.save_checkpoint(path, state)
    names = {k for k in np.load(path).files if k.startswith("v2|")}
    assert names == {"v2|" + n for n in tckpt._model_leaves(state)} | {"v2|.step"}
    assert {"v2|.g.xyz", "v2|.alive", "v2|.cams.dq", "v2|.align.log_scale",
            "v2|.stats.denom"} <= names


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data") / "scene")
    os.makedirs(root)
    _write_colmap_scene(root, n_cams=4)
    return root


def test_jax_checkpoint_restores_in_port_render_cli(tmp_path, dataset, capsys):
    """A checkpoint written by the JAX package's save_checkpoint from
    init_train_state (nothing compiled) restores its Gaussians, alive mask
    and cameras in the port's render CLI, which renders both splits."""
    model = str(tmp_path / "jax_model")
    cfg = jconfig.TrainConfig(
        model=jconfig.ModelConfig(sh_degree=1, source_path=dataset, model_path=model),
        calib=jconfig.CalibConfig(opt_cam=True, r_t_noise=(0.05, 0.05, 1.0)))
    js = JScene(dataset, r_t_noise=(0.05, 0.05, 1.0), sh_degree=1)
    state, *_ = jloop.init_train_state(js.gaussians, js.alive, js.train_cams, cfg,
                                       js.cameras_extent)
    rng = np.random.default_rng(1)
    state = dataclasses.replace(
        state, g=dataclasses.replace(state.g, xyz=state.g.xyz + 0.01),
        alive=state.alive.at[3].set(False),
        cams=dataclasses.replace(state.cams, dq=jnp.asarray(
            rng.normal(0, 0.01, state.cams.dq.shape).astype(np.float32))))
    os.makedirs(model)
    jckpt.save_checkpoint(os.path.join(model, "chkpnt7.npz"), state)
    with open(os.path.join(model, "cfg.json"), "w") as f:
        f.write(cfg.to_json())

    _, _, tstate, it, _ = render_cli.restore_trained(model, dataset, -1, "cpu")
    assert it == 7
    for f in G_FIELDS:
        np.testing.assert_array_equal(getattr(tstate.g, f).detach().numpy(),
                                      np.asarray(getattr(state.g, f)), err_msg=f)
    np.testing.assert_array_equal(tstate.alive.numpy(), np.asarray(state.alive))
    for f in CAM_FIELDS:
        np.testing.assert_array_equal(getattr(tstate.cams, f).numpy(),
                                      np.asarray(getattr(state.cams, f)), err_msg=f)
    capsys.readouterr()
    summary = render_cli.main(["-m", model, "-s", dataset, "--device", "cpu"])
    assert "restored the training state" in capsys.readouterr().out
    assert [len(v["psnr"]) for v in summary.values()] == [4, 4]


TRAIN_ARGS = ["--iterations", "12", "--densify_from_iter", "4",
              "--densification_interval", "4", "--densify_until_iter", "10",
              "--opacity_reset_interval", "8", "--test_iterations", "12",
              "--save_iterations", "12", "--checkpoint_iterations", "12",
              "--opt_cam", "--r_t_noise", "0.05", "0.05", "--sh_degree", "1",
              "--device", "cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory, dataset):
    model = str(tmp_path_factory.mktemp("train") / "model")
    summary = train_cli.main(["-s", dataset, "-m", model] + TRAIN_ARGS)
    return model, summary


def test_train_cli_writes_its_outputs(trained):
    """The train CLI writes cfg.json (readable by the JAX package), the
    PLY, the checkpoint, metrics.jsonl and evaluation_results.txt with the
    test, train and pose-error lines; the densify and opacity-reset cadences
    fire."""
    model, summary = trained
    with open(os.path.join(model, "cfg.json")) as f:
        jcfg = jconfig.TrainConfig.from_json(f.read())
    assert jcfg.calib.opt_cam and jcfg.opt.iterations == 12
    ply = os.path.join(model, "point_cloud", "iteration_12", "point_cloud.ply")
    assert os.path.exists(os.path.join(model, "chkpnt12.npz"))
    with open(os.path.join(model, "metrics.jsonl")) as f:
        assert [json.loads(x)["step"] for x in f] == [10]
    with open(os.path.join(model, "evaluation_results.txt")) as f:
        text = f.read()
    for what in ("[ITER 12] Evaluating test: L1", "[ITER 12] Evaluating train: L1",
                 "LPIPS n/a", "[ITER 12] pose error: rot"):
        assert what in text, what
    assert [d[0] for d in summary["densify"]] == [8]
    assert summary["eval_renders"] == 8 and len(summary["losses"]) == 12
    assert all(np.isfinite(summary["losses"]))
    # the reset at iteration 8 clamped every opacity to 0.01; four Adam
    # steps at lr 0.05 cannot lift one past 0.02
    g, alive = load_ply(ply, device="cpu")
    assert int(alive.sum()) == 100
    assert float(torch.sigmoid(g.opacity_raw).max()) < 0.02


def test_train_cli_resumes_from_checkpoint(trained, tmp_path, dataset, capsys):
    model, _ = trained
    out = str(tmp_path / "resumed")
    args = [a if a != "12" else "2" for a in TRAIN_ARGS]
    train_cli.main(["-s", dataset, "-m", out, "--start_checkpoint",
                    os.path.join(model, "chkpnt12.npz")] + args)
    assert "resumed from" in capsys.readouterr().out
    assert os.path.exists(os.path.join(out, "chkpnt2.npz"))


def _png(path):
    return np.asarray(Image.open(path), np.int16)


def test_render_cli_restores_the_trained_cameras(trained, dataset):
    """Without --ply_only the render CLI restores chkpnt12.npz: its train
    renders come from the optimised cameras, not the dataset's."""
    model, _ = trained
    summary = render_cli.main(["-m", model, "-s", dataset, "--device", "cpu"])
    assert [len(v["psnr"]) for v in summary.values()] == [4, 4]
    _, scene, state, _, _ = render_cli.restore_trained(model, dataset, -1, "cpu")
    assert float((state.cams.dq - scene.train_cams.dq).abs().max()) > 1e-4
    saved = _png(os.path.join(summary["train"]["dir"], "renders", "00001.png"))
    g = state.g
    args = (g.xyz.detach(), g.scaling().detach(), g.quats.detach(),
            g.opacity(state.alive).detach(), g.sh_coeffs().detach())
    with torch.no_grad():
        for cams, same in ((state.cams, True), (scene.train_cams, False)):
            img = render(*args, cams[1], scene.static, RenderConfig(sh_degree=1),
                         align=state.align).render
            arr = (np.clip(img.numpy(), 0, 1) * 255).astype("uint8").transpose(1, 2, 0)
            assert (np.abs(arr.astype(np.int16) - saved).max() <= 1) == same


def test_render_cli_optimises_test_poses(trained, dataset, capsys):
    model, _ = trained
    render_cli.main(["-m", model, "-s", dataset, "--device", "cpu", "--skip_train",
                     "--optim_test_pose_iter", "3"])
    assert "saved optimized test poses" in capsys.readouterr().out
    saved = np.load(os.path.join(model, "opt_test_cams.npz"))
    assert saved["dq"].shape == (4, 4) and saved["dt"].shape == (4, 3)
    render_cli.main(["-m", model, "-s", dataset, "--device", "cpu", "--skip_train",
                     "--optim_test_pose_iter", "3"])
    assert "loaded optimized test poses" in capsys.readouterr().out


@pytest.mark.parametrize("flag, slice_", [
    (["--mesh", "1"], "slice 5"), (["--batch_cams", "2"], "slice 5")])
def test_train_cli_refuses_unported_paths(tmp_path, dataset, flag, slice_):
    with pytest.raises(NotImplementedError, match=slice_):
        train_cli.main(["-s", dataset, "-m", str(tmp_path / "m"), "--device", "cpu"]
                       + flag)


def test_train_cli_without_device_needs_a_card(tmp_path, dataset, monkeypatch):
    """No --device and no usable card: the CLI raises instead of training on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train_cli.main(["-s", dataset, "-m", str(tmp_path / "m")])
