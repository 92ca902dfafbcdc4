"""Port parity, the cubemap mode's evaluation against `bags_tpu`'s (five
faces at the full SH degree, warped, stitched by maximum intensity and
circular-masked; JAX's compiled once here), then the port's CLIs in the
cubemap mode on a tiny COLMAP scene on the CPU: `cli.train --preset
cubemap` and `cli.render` restoring the model."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _cubemap_toy as cube
from bags_tpu.core.camera import CameraStatic as JStatic
from bags_tpu.train import calibrated as jcal
from bags_tpu_torch.raster.render import RenderConfig as TCfg
from bags_tpu_torch.train import calibrated as tcal
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def toy():
    return cube.build()


def test_cubemap_eval_matches_jax(toy):
    """Each camera's stitched, circular-masked image against JAX's
    `make_cubemap_eval_fn` (atol 2e-5; the side faces' content reaches
    the stitch), and the masked GT."""
    js = toy["state"]
    jtrainer = types.SimpleNamespace(
        static=JStatic(cube.WH, cube.WH), cfg=toy["cfg"], rcfg=toy["rcfg"],
        max_sh_degree=1, focal=(cube.FOCAL, cube.FOCAL))
    jeval = jcal.make_cubemap_eval_fn(jtrainer)
    cs, _, cfg, setup = cube.port_state(toy)
    teval = tcal.make_cubemap_eval_fn(types.SimpleNamespace(
        setup=setup, rcfg=TCfg(sh_degree=1), max_sh_degree=1))
    for i in range(cube.N_CAMS):
        jcam = jax.tree_util.tree_map(lambda x: x[i], js.base.cams)
        jimg, jgt = jeval(js, jcam, jnp.asarray(toy["gts"][i]),
                          jnp.asarray(toy["sub_q"][i]),
                          jnp.asarray(toy["sub_t"][i]))
        img, gt, dropped = teval(cs, cs.base.cams[i], torch.as_tensor(toy["gts"][i]),
                                 torch.tensor(toy["sub_q"][i]),
                                 torch.tensor(toy["sub_t"][i]))
        assert dropped == 0
        np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=2e-5)
        np.testing.assert_allclose(gt.numpy(), np.asarray(jgt), atol=1e-7)
        # the side faces reach the stitch: past 45 degrees (a radius of
        # focal x pi / 4 after the tan warp) the forward face is masked
        y, x = np.mgrid[:cube.WH, :cube.WH] - cube.WH // 2
        ring = (np.hypot(x, y) > cube.FOCAL * np.pi / 4 + 0.5) & (
            np.hypot(x, y) <= 20)
        assert np.asarray(jimg)[:, ring].max() > 0


# --------------------------------------------------------------------------
# the CLIs in the cubemap mode (port only, CPU)
# --------------------------------------------------------------------------

W, H, FOCAL = 48, 40, 24.0


@pytest.fixture(scope="module")
def cube_dataset(tmp_path_factory):
    """4 cameras inside the box of 300 Gaussians at 48x40 (focal 24): in
    `images/` each camera's five faces through a narrow known net,
    stitched and circular-masked (`utils/testing.write_cubemap_dataset`)."""
    from bags_tpu_torch import convert
    from bags_tpu_torch.calib import iresnet
    from bags_tpu_torch.core.sh import sh_dc_to_rgb
    from bags_tpu_torch.raster.render import render
    from bags_tpu_torch.utils import testing

    root = str(tmp_path_factory.mktemp("cube_scene"))
    fovx, fovy = 2 * np.arctan(W / (2 * FOCAL)), 2 * np.arctan(H / (2 * FOCAL))
    sc = testing.make_toy_scene(n=300, width=W, height=H, seed=2,
                                scale_range=(0.05, 0.2), device="cpu")
    cams = testing.cubemap_cameras(4, fovx, fovy, device="cpu")
    net = iresnet.init_iresnet_params(hidden=16, n_blocks=2, n_layers=2, seed=5)
    net = convert.iresnet_from_numpy({f: [[t.detach().numpy() * (
        0.2 if f == "weights" else 1.0) for t in blk] for blk in getattr(net, f)]
        for f in ("weights", "biases", "u_vecs")}, "cpu")
    args = [sc[k] for k in ("xyz", "scales", "quats", "opacity", "sh_coeffs")]
    rcfg = TCfg(sh_degree=0, sort_by_distance=True)

    def render_faces(cam):
        q, t = tcal.sub_camera_poses(tcal.CameraParams.stack([cam]))
        outs = [render(*args, c, sc["static"], rcfg)
                for c in tcal.face_cameras(cam, q[0], t[0])]
        return [o.render for o in outs], [o.gauss_id.numel() for o in outs]

    with torch.no_grad():
        counts = testing.write_cubemap_dataset(
            root, cams, W, H, FOCAL, sc["xyz"].numpy(),
            sh_dc_to_rgb(sc["sh_coeffs"][:, 0]).numpy(), render_faces, net,
            mask_radius=512, control_point_sample_scale=8)
    assert all(min(c) > 0 for c in counts), counts
    return root


@pytest.fixture(scope="module", params=["cubemap", "cubemap_hybrid"])
def cube_model(request, cube_dataset, tmp_path_factory):
    from bags_tpu_torch.cli import train as train_cli

    model = str(tmp_path_factory.mktemp("cube_model"))
    hybrid = ["--hybrid"] if request.param == "cubemap_hybrid" else []
    summary = train_cli.main([
        "-s", cube_dataset, "-m", model, "--preset", "cubemap", *hybrid,
        "--init_type", "sfm", "--sh_degree", "0", "--iterations", "6",
        "--test_iterations", "6", "--save_iterations", "6",
        "--checkpoint_iterations", "6", "--device", "cpu", "--quiet"])
    return model, summary, bool(hybrid)


def test_train_cli_cubemap_preset(cube_model):
    """`--preset cubemap` trains: finite losses, an evaluation of both
    splits, no pre-fit (the preset's `--no_init_iresnet`), and a checkpoint
    holding the cubemap net and its moments, stepped every iteration and
    moved from its initialisation; with `--hybrid`, the ASG features and
    the specular MLP too, its Adam state stepped every iteration."""
    from bags_tpu_torch.calib.iresnet import init_iresnet_params

    model, summary, hybrid = cube_model
    assert summary["lens_prefit_s"] is None
    assert len(summary["losses"]) == 6 and np.isfinite(summary["losses"]).all()
    assert any("Evaluating test" in line for line in summary["eval"])
    assert any("Evaluating train" in line for line in summary["eval"])
    data = np.load(os.path.join(model, "chkpnt6.npz"))
    for k in (".cubemap_net.weights[0][0]", ".cubemap_net.u_vecs[4][4]",
              ".cubemap_opt.mu.weights[4][4]", ".base.g.xyz", ".lens.weights[0][0]"):
        assert "v2|" + k in data.files, k
    assert int(data["v2|.cubemap_opt.count"]) == 6
    init = init_iresnet_params(seed=1)        # the trainer's seed + 1
    assert np.abs(data["v2|.cubemap_net.biases[0][0]"]
                  - init.biases[0][0].detach().numpy()).max() > 0
    np.testing.assert_array_equal(data["v2|.cubemap_net.u_vecs[2][1]"],
                                  init.u_vecs[2][1].numpy())
    spec_keys = ("v2|.base.g.asg", "v2|.base.spec.w1", "v2|.base.spec_opt[0].count")
    assert all((k in data.files) == hybrid for k in spec_keys)
    if hybrid:
        assert int(data["v2|.base.spec_opt[0].count"]) == 6


def test_render_cli_restores_cubemap_model(cube_model, cube_dataset):
    """The render CLI restores the cubemap checkpoint and renders plain
    perspective views of its Gaussians (as the JAX render CLI does): each
    written render is `render()` of the restored model at the view's
    camera, with a hybrid model's specular colour, PNG-quantised."""
    from PIL import Image

    from bags_tpu_torch.cli import render as render_cli
    from bags_tpu_torch.raster.render import render
    from bags_tpu_torch.train.loop import extra_color

    model, _, hybrid = cube_model
    summary = render_cli.main(["-m", model, "-s", cube_dataset, "--device", "cpu"])
    assert sorted(summary) == ["test", "train"]
    for split in summary.values():
        assert np.isfinite(split["psnr"]).all() and len(split["psnr"]) > 0
    cfg, scene, state, it, trainer = render_cli.restore_trained(
        model, cube_dataset, -1, torch.device("cpu"))
    assert trainer.mode == "cubemap" and it == 6
    assert (state.spec is not None) == hybrid
    g = state.g
    with torch.no_grad():
        extra = extra_color(state, state.cams[0])
        img = render(g.xyz, g.scaling(), g.quats, g.opacity(state.alive),
                     g.sh_coeffs(), state.cams[0], scene.static,
                     TCfg(sh_degree=0), bg=torch.zeros(3),
                     align=state.align, extra_color=extra).render
        if hybrid:
            plain = render(g.xyz, g.scaling(), g.quats, g.opacity(state.alive),
                           g.sh_coeffs(), state.cams[0], scene.static,
                           TCfg(sh_degree=0), bg=torch.zeros(3),
                           align=state.align).render
            assert (img - plain).abs().max() > 1e-3
    png = np.asarray(Image.open(os.path.join(summary["train"]["dir"], "renders",
                                             "00000.png")), float)
    want = np.clip(img.permute(1, 2, 0).numpy(), 0, 1) * 255
    assert png.shape == (H, W, 3)
    assert np.abs(png - want).max() <= 1.0
