"""Port parity, trajectories: the path generators of `eval/trajectory.py`
against the JAX package's, and `python -m bags_tpu_torch.cli.render_trajectory
--device cpu` against the JAX `render_trajectory.py --backend jnp` on one
JAX-written PLY model, in every mode and with `--panorama_fov`; then the
CLI on checkpoints the port's train CLI wrote (a pose-optimised model and a
fisheye model)."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from bags_tpu.core.camera import CameraParams as JCameraParams
from bags_tpu.eval import trajectory as jtraj
from bags_tpu.model import gaussians as jg
from bags_tpu_torch.cli import render_trajectory as traj_cli
from bags_tpu_torch.core.camera import CameraParams
from bags_tpu_torch.eval import trajectory as ptraj
from test_torch_cli import _lookat_scene
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL_POSE = 1e-6     # interpolated poses and batched cameras, float32


def _poses(n=5, seed=3):
    """n look-at poses (R_w2c, t_w2c) in float32 around the origin."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    R = Rotation.from_rotvec(rng.normal(0, 0.3, (n, 3))).as_matrix().astype(np.float32)
    t = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    return R, t


def _c2ws(R, t):
    c2w = np.zeros((len(R), 4, 4))
    c2w[:, :3, :3] = np.transpose(R, (0, 2, 1))
    c2w[:, :3, 3] = -np.einsum("nji,nj->ni", R, t)
    c2w[:, 3, 3] = 1.0
    return c2w


def _same_path(a, b):
    assert len(a) == len(b)
    for (ra, ta), (rb, tb) in zip(a, b):
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(ta, tb)


def test_numpy_paths_equal_jax():
    R, t = _poses()
    c2ws = _c2ws(R, t)
    np.testing.assert_array_equal(ptraj.average_pose(c2ws), jtraj.average_pose(c2ws))
    np.testing.assert_array_equal(
        ptraj.look_at_c2w(c2ws[0, :3, 2], c2ws[0, :3, 1], c2ws[0, :3, 3]),
        jtraj.look_at_c2w(c2ws[0, :3, 2], c2ws[0, :3, 1], c2ws[0, :3, 3]))
    _same_path(ptraj.spiral_path(c2ws, n_frames=7), jtraj.spiral_path(c2ws, n_frames=7))
    center = c2ws[:, :3, 3].mean(axis=0)
    _same_path(ptraj.orbit_path(center, 2.5, 0.3, 6), jtraj.orbit_path(center, 2.5, 0.3, 6))
    _same_path(ptraj.wander_path(R[0], t[0], 0.7, 48, 5),
               jtraj.wander_path(R[0], t[0], 0.7, 48, 5))


def test_interpolate_and_cameras_match_jax():
    R, t = _poses()
    pcams = CameraParams.stack([CameraParams.create(R[i], t[i], 0.9, 0.7, device="cpu")
                                for i in range(len(R))])
    jcams = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[
        JCameraParams.create(R[i], t[i], 0.9, 0.7) for i in range(len(R))])
    got, want = ptraj.interpolate_path(pcams, 4), jtraj.interpolate_path(jcams, 4)
    assert len(got) == len(want) == 4 * (len(R) - 1) + 1
    for (rg, tg), (rw, tw) in zip(got, want):
        np.testing.assert_allclose(rg, rw, atol=TOL_POSE)
        np.testing.assert_allclose(tg, tw, atol=TOL_POSE)
    pc, jc = ptraj.path_to_cameras(want, 0.9, 0.7, "cpu"), jtraj.path_to_cameras(want, 0.9, 0.7)
    for f in dataclasses.fields(pc):
        np.testing.assert_allclose(getattr(pc, f.name).numpy(),
                                   np.asarray(getattr(jc, f.name)), atol=TOL_POSE)


@pytest.fixture(scope="module")
def ply_model(tmp_path_factory):
    """The look-at dataset of the render CLI's tests, and a JAX-written PLY
    of 300 SH-1 Gaussians on a shell of radius 8-160 around it, so that
    every mode's frames (the spiral's look backwards, the wander moves tens
    of units) see content."""
    tmp = tmp_path_factory.mktemp("traj")
    root = str(tmp / "scene")
    os.makedirs(root)
    _lookat_scene(root)
    rng = np.random.default_rng(2)
    d = rng.normal(size=(300, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (d * rng.uniform(8, 160, (300, 1))).astype(np.float32)
    g, alive = jg.create_from_points(pts, rng.random((300, 3)).astype(np.float32),
                                     300, sh_degree=1)
    g = dataclasses.replace(g, opacity_raw=g.opacity_raw + 2.0)
    model = str(tmp / "model")
    ply_dir = os.path.join(model, "point_cloud", "iteration_7")
    os.makedirs(ply_dir)
    jg.save_ply(os.path.join(ply_dir, "point_cloud.ply"), g, alive)
    return model, root


def _frames(d):
    return [np.asarray(Image.open(os.path.join(d, f)), np.int16)
            for f in sorted(os.listdir(d)) if f.endswith(".png")]


@pytest.mark.parametrize("mode, extra", [
    ("spiral", []), ("orbit", []), ("wander", []), ("sequential", []),
    ("orbit", ["--panorama_fov", "120"])])
def test_cli_matches_jax(ply_model, tmp_path, mode, extra):
    """Frames within 1 level of JAX's (uint8), each with content."""
    import bags_tpu.raster
    import render_trajectory as jax_cli

    model, root = ply_model
    common = ["-m", model, "-s", root, "--ply_only", "--sh_degree", "1", "--mode",
              mode, "--n_frames", "3", "--max_instances", "16384"] + extra
    with pytest.MonkeyPatch.context() as mp:
        # a tile holds at most one instance of each of the 300 Gaussians, so
        # the jnp per-tile scan capped at 300 gives the same frames
        mp.setattr(bags_tpu.raster, "RenderConfig", functools.partial(
            bags_tpu.raster.RenderConfig, max_per_tile=300))
        jax_cli.main(common + ["--backend", "jnp", "--out", str(tmp_path / "jax")])
    summary = traj_cli.main(common + ["--device", "cpu", "--out", str(tmp_path / "port")])
    want, got = _frames(str(tmp_path / "jax")), _frames(str(tmp_path / "port"))
    assert len(got) == len(want) == summary["frames"] == (4 if mode == "sequential" else 3)
    assert summary["finite"]
    for a, b in zip(got, want):
        assert a.shape == b.shape == (48, 64, 3)
        assert np.abs(a - b).max() <= 1
        assert a.mean() > 20, "nothing in view"


@pytest.fixture(scope="module")
def trained_models(tmp_path_factory):
    """Two checkpoints of the port's train CLI on the CPU: a pose-optimised
    model of the look-at dataset, and a fisheye model (`--preset fisheye`,
    no lens pre-fit) that renders at 80x60 (`--render_resolution 1.25`)
    and warps to its 64x48 fisheye sensor."""
    from bags_tpu_torch.cli import train as train_cli
    from bags_tpu_torch.utils import testing

    tmp = tmp_path_factory.mktemp("trained")
    root = str(tmp / "scene")
    os.makedirs(root)
    _lookat_scene(root)
    rng = np.random.default_rng(6)
    testing.write_fisheye_pair(
        root, sorted(os.path.join(root, "images", f)
                     for f in os.listdir(os.path.join(root, "images"))),
        [(rng.random((48, 64, 3)) * 255).astype(np.uint8) for _ in range(4)],
        64, 48, 50.0, 50.0, (-0.04, 0.0, 0.0, 0.0))
    common = ["-s", root, "--init_type", "sfm", "--sh_degree", "1", "--iterations",
              "2", "--test_iterations", "9", "--save_iterations", "2",
              "--checkpoint_iterations", "2", "--device", "cpu", "--quiet"]
    pose, fish = str(tmp / "pose"), str(tmp / "fish")
    train_cli.main(["-m", pose, "--opt_cam", "--r_t_noise", "0.05", "0.05"] + common)
    train_cli.main(["-m", fish, "--preset", "fisheye", "--no_init_iresnet",
                    "--render_resolution", "1.25"] + common)
    return root, pose, fish


def test_sequential_frame0_is_the_optimised_camera(trained_models, tmp_path):
    from bags_tpu_torch.cli.render import restore_trained
    from bags_tpu_torch.raster.render import RenderConfig, render

    root, pose, _ = trained_models
    summary = traj_cli.main(["-m", pose, "-s", root, "--mode", "sequential",
                             "--n_frames", "3", "--device", "cpu",
                             "--out", str(tmp_path / "seq")])
    frames = _frames(summary["dir"])
    assert len(frames) == 4 and summary["finite"]
    cfg, scene, state, _, _ = restore_trained(pose, root, -1, "cpu")
    g = state.g
    assert not torch.equal(state.cams.dq, torch.zeros_like(state.cams.dq))
    with torch.no_grad():
        img = render(g.xyz, g.scaling(), g.quats, g.opacity(state.alive), g.sh_coeffs(),
                     state.cams[0], scene.static, RenderConfig(sh_degree=1),
                     bg=torch.zeros(3), align=state.align).render
    want = (np.clip(img.numpy(), 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
    assert np.abs(frames[0] - want).max() <= 1
    assert want.mean() > 5, "nothing in view"


def test_fisheye_frames_at_the_sensor_size(trained_models, tmp_path):
    root, _, fish = trained_models
    summary = traj_cli.main(["-m", fish, "-s", root, "--mode", "orbit", "--n_frames",
                             "2", "--device", "cpu", "--out", str(tmp_path / "fish")])
    frames = _frames(summary["dir"])
    assert summary["finite"] and len(frames) == 2
    assert all(f.shape == (48, 64, 3) for f in frames)
