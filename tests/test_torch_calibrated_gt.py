"""Port parity, the fisheye train step in the apply2gt direction (the
fisheye GT warped into perspective; no vignetting, no shift): one step
(loss, masked render and every gradient), three steps of state and the NaN
guard of the lens against JAX's step, compiled once here. Then the port's
CLIs in the fisheye mode on a tiny COLMAP scene with a `fish/` pair, on the
CPU: `cli.train --preset fisheye`, and `--preset fisheye_mcmc --hybrid`
(the lens pre-fit cut to a few steps), and `cli.render` restoring each
model and writing lens-warped pairs against the fisheye GT."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _fisheye_toy as toy_lib
from bags_tpu_torch.train import calibrated as tcal
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

IDX = 2


@pytest.fixture(scope="module")
def toy():
    return toy_lib.build(apply2gt=True, vig_shift=False)


@pytest.fixture(scope="module")
def one_step(toy):
    """JAX's first step on camera IDX (this compiles it) and the port's."""
    js, jloss, jimg = toy_lib.jax_step(toy, toy["state"], IDX)
    port = toy_lib.port_state(toy)
    m = toy_lib.port_step(toy, port, IDX)
    return js, jloss, jimg, port, m


def test_fisheye_apply2gt_step_matches_jax(one_step):
    """Loss and masked render (atol 2e-5), every gradient (Gaussians,
    camera row, lens; atol 1e-5, rtol 1e-3) and the state after the step."""
    js, jloss, jimg, port, m = one_step
    np.testing.assert_allclose(float(m.loss), jloss, atol=2e-5)
    np.testing.assert_allclose(m.image.numpy(), jimg, atol=2e-5)
    assert 0 < float((jimg == 0).all(0).mean()) < 1, "the mask must cut something"
    want = toy_lib.jax_grads(js, IDX, vig_shift=False)
    for name, w in want.items():
        np.testing.assert_allclose(m.grads[name].detach().numpy(), w, atol=1e-5,
                                   rtol=1e-3, err_msg=name)
        assert np.abs(w).max() > 0, f"{name}: zero gradient"
    assert ".vig.a_k" not in m.grads and ".shift" not in m.grads
    toy_lib.assert_same_state(port[0], js)


def test_fisheye_apply2gt_three_steps_match_jax(toy):
    js, port = toy["state"], toy_lib.port_state(toy)
    for idx in (0, 2, 1):
        js, jloss, _ = toy_lib.jax_step(toy, js, idx)
        np.testing.assert_allclose(float(toy_lib.port_step(toy, port, idx).loss),
                                   jloss, atol=2e-5)
    toy_lib.assert_same_state(port[0], js, steps=3)


def _jax_tree(template, named):
    """A JAX IResNetParams shaped as `template` holding copies of the
    port's tensors `named` by path (zeros where `named` has none: the
    u_vecs' moments). Copies: JAX may alias a numpy buffer, and the port
    updates its tensors in place."""
    return type(template)(**{f: [[jnp.asarray(
        np.array(named[f".{f}[{b}][{l}]"].detach().numpy())
        if f".{f}[{b}][{l}]" in named
        else np.zeros(np.shape(t), np.float32)) for l, t in enumerate(blk)]
        for b, blk in enumerate(getattr(template, f))]
        for f in ("weights", "biases", "u_vecs")})


def test_nan_guard_zeroes_lens_gradients_and_steps_adam(toy, one_step):
    """A non-finite lens gradient (a hook turns one entry into NaN): every
    lens gradient counts as zero, the lens moments still step (count 2,
    decayed) and the lens moves by the decayed first moment, exactly as
    optax's update of zero gradients does from the port's own lens and
    moments after its first step; the Gaussians still step."""
    js1 = one_step[0]
    port = toy_lib.port_state(toy)
    toy_lib.port_step(toy, port, IDX)
    cs = port[0]
    jlens1 = _jax_tree(js1.lens, cs.lens.named_tensors())
    jopt1 = type(js1.lens_opt)(count=jnp.asarray(1, jnp.int32),
                               mu=_jax_tree(js1.lens, cs.lens_opt.mu),
                               nu=_jax_tree(js1.lens, cs.lens_opt.nu))
    w = cs.lens.weights[1][0]

    def poison(g):
        g = g.clone()
        g.view(-1)[0] = float("nan")
        return g

    handle = w.register_hook(poison)
    xyz_before = cs.base.g.xyz.detach().clone()
    m = toy_lib.port_step(toy, port, 0)
    handle.remove()
    assert torch.isnan(m.grads[".lens.weights[1][0]"]).any()
    assert torch.isfinite(m.loss)
    assert not torch.equal(cs.base.g.xyz, xyz_before)
    tx, sched = toy["txs"]["lens"]
    upd, jopt = tx.update(jax.tree_util.tree_map(jnp.zeros_like, jlens1), jopt1)
    lr = sched(1)
    jlens = jax.tree_util.tree_map(lambda p, u: p - lr * u, jlens1, upd)
    assert cs.lens_opt.count == int(jopt.count) == 2
    jl, jmu = toy_lib.lens_np(jlens), toy_lib.lens_np(jopt.mu)
    for f in ("weights", "biases"):
        for b, blk in enumerate(getattr(cs.lens, f)):
            for l, t in enumerate(blk):
                k = f".{f}[{b}][{l}]"
                np.testing.assert_allclose(cs.lens_opt.mu[k].numpy(), jmu[f][b][l],
                                           atol=0, rtol=1e-6, err_msg=k)
                np.testing.assert_allclose(t.detach().numpy(), jl[f][b][l],
                                           atol=1e-8, rtol=1e-6, err_msg=k)
                assert not np.array_equal(t.detach().numpy(),
                                          toy_lib.lens_np(jlens1)[f][b][l]), k


# --------------------------------------------------------------------------
# the CLIs in the fisheye mode (port only, CPU)
# --------------------------------------------------------------------------

FOV, W, H = 0.8, 48, 40
TRUE_COEFF, INIT_COEFF = (-0.12, 0.02, 0.0, 0.0), (-0.04, 0.0, 0.0, 0.0)


@pytest.fixture(scope="module")
def fish_dataset(tmp_path_factory):
    """4 look-at cameras at 48x40 over 300 Gaussians: perspective GT in
    `images/`, and in `fish/images/` each view rendered at the extended FoV
    of `--preset fisheye` and warped through the analytic lens TRUE_COEFF;
    `fish/sparse/0` names INIT_COEFF for the lens pre-fit."""
    import dataclasses

    from bags_tpu_torch.core.sh import sh_dc_to_rgb
    from bags_tpu_torch.raster.render import RenderConfig, render
    from bags_tpu_torch.utils import testing

    root = str(tmp_path_factory.mktemp("fish_scene"))
    fx, fy = W / (2 * np.tan(FOV / 2)), H / (2 * np.tan(FOV / 2))
    sc = testing.make_toy_scene(n=300, width=W, height=H, seed=2,
                                scale_range=(0.1, 0.3), device="cpu")
    sc["xyz"][:, 2] += 2.0
    cams = testing.make_lookat_cameras(4, FOV, FOV, spread=0.15, device="cpu")
    paths = testing.write_colmap_scene(
        root, cams, W, H, fx, fy, sc["xyz"].numpy(),
        sh_dc_to_rgb(sc["sh_coeffs"][:, 0]).numpy())
    setup = tcal.make_fisheye_setup(fx, fy, (W, H), (W, H), flow_scale=(2.0, 2.0),
                                    control_point_sample_scale=16)
    p_view = tcal.fisheye_control_points(setup, fx, fy, (2.0, 2.0), device="cpu")
    args = [sc[k] for k in ("xyz", "scales", "quats", "opacity", "sh_coeffs")]
    fish = []
    with torch.no_grad():
        for cam, path in zip(cams, paths):
            for c, static, out in ((cam, sc["static"], None), (dataclasses.replace(
                    cam, fovx=torch.tensor(setup.fovx), fovy=torch.tensor(setup.fovy)),
                    setup.render_static, fish)):
                img = render(*args, c, static, RenderConfig(sh_degree=0)).render
                if out is not None:
                    img = testing.known_lens_fisheye(img, setup, p_view, TRUE_COEFF)
                arr = np.round(np.clip(img.permute(1, 2, 0).numpy(), 0, 1) * 255
                               ).astype(np.uint8)
                if out is None:
                    testing.write_image(path, arr)
                else:
                    out.append(arr)
    testing.write_fisheye_pair(root, paths, fish, W, H, fx, fy, INIT_COEFF)
    return root


# The CLI variants: `--preset fisheye`, and `--preset fisheye_mcmc --hybrid`
# with the MCMC window moved so that one relocation (iteration 3) runs.
VARIANTS = {
    "fisheye": ["--preset", "fisheye"],
    "fisheye_mcmc_hybrid": ["--preset", "fisheye_mcmc", "--hybrid",
                            "--densify_from_iter", "1", "--densification_interval",
                            "3", "--densify_until_iter", "6"],
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def fisheye_model(request, fish_dataset, tmp_path_factory):
    from bags_tpu_torch.cli import train as train_cli

    model = str(tmp_path_factory.mktemp("fish_model"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcal, "LENS_PREFIT_ITERS", 2)   # 5,000 steps of the 5x512 net: long on a CPU
        summary = train_cli.main([
            "-s", fish_dataset, "-m", model, *VARIANTS[request.param],
            "--init_type", "sfm", "--sh_degree", "0", "--iterations", "6",
            "--test_iterations", "6", "--save_iterations", "6",
            "--checkpoint_iterations", "6", "--device", "cpu", "--quiet"])
    return model, summary, request.param


def test_train_cli_fisheye_preset(fisheye_model, capsys):
    """`--preset fisheye` trains: the lens pre-fit ran (and its time was
    printed), finite losses, an evaluation against the fisheye GT, and a
    checkpoint holding the lens, vignetting and shift leaves, the lens
    moved by training from its pre-fit. `--preset fisheye_mcmc --hybrid`
    does too, with one relocation in its MCMC log that grows the live
    count to float32's 1.005 x, no densify step, and the ASG features,
    the specular MLP and its Adam state in the checkpoint, trained."""
    from bags_tpu_torch.calib.iresnet import init_iresnet_params
    from bags_tpu_torch.calib.specular import init_specular_params

    model, summary, variant = fisheye_model
    if variant == "fisheye_mcmc_hybrid":
        data = np.load(os.path.join(model, "chkpnt6.npz"))
        assert summary["densify"] == []
        [(it, _, added, before, after)] = summary["mcmc"]
        assert it == 3 and after == before + added
        assert after == int(np.float32(1.005) * np.float32(before)) > before
        assert int(data["v2|.base.alive"].sum()) == after
        assert int(data["v2|.base.spec_opt[0].count"]) == 6
        init = init_specular_params(0)
        for k in ("feat_w", "w1", "b3"):
            assert np.abs(data[f"v2|.base.spec.{k}"]
                          - getattr(init, k).detach().numpy()).max() > 0, k
        assert data["v2|.base.g.asg"].shape[1] == 24
        assert np.abs(data["v2|.base.g.asg"]).max() > 0
        assert "v2|.base.spec_opt[1].count" in data.files
    else:
        assert summary["mcmc"] == []
    assert summary["lens_prefit_s"] is not None
    assert len(summary["losses"]) == 6 and np.isfinite(summary["losses"]).all()
    assert any("Evaluating test" in line for line in summary["eval"])
    data = np.load(os.path.join(model, "chkpnt6.npz"))
    for k in (".lens.weights[0][0]", ".lens.u_vecs[4][4]", ".lens_opt.count",
              ".vig.a_k", ".shift", ".base.g.xyz", ".cubemap_net.weights[0][0]"):
        assert "v2|" + k in data.files, k
    assert int(data["v2|.lens_opt.count"]) == 6
    init = init_iresnet_params(seed=0)
    assert np.abs(data["v2|.lens.weights[4][4]"]
                  - init.weights[4][4].detach().numpy()).max() > 0
    assert os.path.exists(os.path.join(model, "point_cloud", "iteration_6",
                                       "point_cloud.ply"))


def test_render_cli_restores_fisheye_model(fisheye_model, fish_dataset):
    """The render CLI restores the fisheye checkpoint (no pre-fit) and writes
    lens-warped renders at the fisheye size beside the fisheye GT."""
    from PIL import Image

    from bags_tpu_torch.cli import render as render_cli

    model, _, variant = fisheye_model
    summary = render_cli.main(["-m", model, "-s", fish_dataset, "--device", "cpu"])
    trained = render_cli.restore_trained(model, fish_dataset, -1,
                                         torch.device("cpu"))
    assert (trained[2].spec is not None) == (variant == "fisheye_mcmc_hybrid")
    assert sorted(summary) == ["test", "train"]
    for split in summary.values():
        assert np.isfinite(split["psnr"]).all()
        names = sorted(os.listdir(os.path.join(split["dir"], "renders")))
        assert len(names) == len(split["psnr"]) > 0
    test_dir = summary["test"]["dir"]
    render_png = np.asarray(Image.open(os.path.join(test_dir, "renders", "00000.png")))
    gt_png = np.asarray(Image.open(os.path.join(test_dir, "gt", "00000.png")), float)
    assert render_png.shape == gt_png.shape == (H, W, 3)
    fish_dir = os.path.join(fish_dataset, "fish", "images")
    persp_dir = os.path.join(fish_dataset, "images")
    name = sorted(os.listdir(fish_dir))[0]          # the test view (llffhold 8)
    fish = np.asarray(Image.open(os.path.join(fish_dir, name)), float)
    persp = np.asarray(Image.open(os.path.join(persp_dir, name)), float)
    assert np.abs(gt_png - fish).mean() < 0.25 * np.abs(gt_png - persp).mean()
