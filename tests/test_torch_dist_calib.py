"""Port parity, the calibrated modes tile-parallel (`bags_tpu_torch/dist/
calib.py`, `ShardedCalibTrainer`) on 2 gloo ranks on the CPU: one spawn of
two processes (`_torch_dist_calib_worker.py`, a JAX-free module) runs every
scenario and writes an npz per rank, while this process compiles the JAX
references; each test asserts its part.

The JAX references are `make_sharded_fisheye_step` (flow scale 1.0, the
no-crop branch; 1.5, the crop branch, with vignetting and the pupil
shift; `--apply2gt`) and `make_sharded_cubemap_step` on a 2-device virtual
mesh at `backend="jnp"` (its Pallas call is broken, ROADMAP.md Queue 3),
at JAX's own tolerances (`tests/test_sharded.py:346-356`, `:545-557`):
loss rtol 1e-4, atol 1e-6; positions and camera rows rtol 1e-3, atol
2e-5; the lens or cubemap net rtol 1e-3, atol 1e-7. The one-process port
(`fisheye_train_step`, `cubemap_train_step`, `CalibTrainer`) is the
reference of the multi-step runs with densify, `--hybrid` and the
checkpoints, at the pose path's tolerances (`tests/test_torch_dist.py`).
The toys have 39 fisheye rows (20 a rank) and 40 or 39 render rows (two
slabs of 32), so that neither row partition divides evenly. They render
on a grey background, so that no pixel is an exact zero; the fs15 step is
also run on black (`worker.BLACK`), where the exact-zero crop mask decides
and the packages' `linspace` rounding flips some of its pixels."""

import concurrent.futures
import dataclasses
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_calib_worker as worker
from bags_tpu.calib.iresnet import IResNetParams as JNet
from bags_tpu.core.camera import CameraParams as JCam
from bags_tpu.core.camera import CameraStatic as JStatic
from bags_tpu.dist import calib as jdcal
from bags_tpu.dist import mesh as jmesh
from bags_tpu.model.gaussians import Gaussians as JGaussians
from bags_tpu.raster import RenderConfig as JCfg
from bags_tpu.train import calibrated as jcal
from bags_tpu.train import config as jconfig
from bags_tpu.train import loop as jloop
from bags_tpu_torch.dist import mesh as tmesh
from bags_tpu_torch.train.calibrated import CalibTrainer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

WORLD = 2
SPAWN_TIMEOUT = 180   # seconds for both ranks; the run takes about 15
# set in the thread that traces JAX's fs15 step: its `_halo_slab_loss`
# hands each device's warped rows to `capture.slabs`
_capture = threading.local()


def _capturing(halo_slab_loss):
    """JAX's `_halo_slab_loss`, which in a thread whose `_capture.slabs` is
    set at trace time also hands each device's `pred` rows to that dict
    (by device) whenever the step runs."""
    def loss(pred, gt, axis, y0_px, true_height, lambda_dssim):
        slabs = getattr(_capture, "slabs", None)
        if slabs is not None:
            jax.debug.callback(
                lambda dev, rows: slabs.__setitem__(int(dev), np.asarray(rows)),
                jax.lax.axis_index(axis), pred)
        return halo_slab_loss(pred, gt, axis, y0_px, true_height, lambda_dssim)
    return loss


def _jax_step(name: str, black: dict) -> dict:
    """JAX's sharded step of `worker.step_toy(name)` on a 2-device virtual
    mesh: {name: the loss, positions, camera rows and the trained net}, and
    for fs15 also `worker.BLACK`'s (`_jax_black_step`; `black` takes its
    masks and GT)."""
    t = worker.step_toy(name)
    _capture.slabs = {} if name == "fs15" else None
    cfg = jconfig.TrainConfig.from_json(t["cfg"].to_json())
    g = JGaussians(**{f: jnp.asarray(t["g"][f]) for f in worker.G_FIELDS})
    cams = JCam(**{f: jnp.asarray(v) for f, v in t["cams"].items()})
    base, g_tx, _, _ = jloop.init_train_state(g, jnp.asarray(t["g"]["alive"]),
                                              cams, cfg, 2.0)
    state, txs = jcal.init_calib_state(base, cfg)
    net = JNet(**{f: [[jnp.asarray(a) for a in blk] for blk in v]
                  for f, v in t["nets"]["lens"].items()})
    cube = name == "cube"
    key = "cubemap" if cube else "lens"
    state = dataclasses.replace(state, **{
        "cubemap_net" if cube else "lens": net, key + "_opt": txs[key][0].init(net)})
    rcfg = JCfg(sh_degree=0, backend="jnp", precision="exact",
                max_instances=2 ** 14, max_per_tile=worker.CAP)
    mesh = jmesh.make_mesh(WORLD)
    if cube:
        w, h = worker.PERSP
        step = jdcal.make_sharded_cubemap_step(
            mesh, JStatic(width=w, height=h), rcfg, cfg, g_tx, txs, 0,
            worker.CUBE_FOCAL, worker.CUBE_FOCAL)
        gt = np.pad(t["gt"], ((0, 0), (0, jmesh.padded_height(h, WORLD) - h),
                              (0, 0)))
        new, (loss, *_) = step(state, jnp.asarray(gt), jnp.asarray(0),
                               jnp.asarray(worker.BG), jnp.asarray(t["sub_q"]),
                               jnp.asarray(t["sub_t"]))
    else:
        c = cfg.calib
        setup = jcal.make_fisheye_setup(
            worker.FOCAL, worker.FOCAL, worker.PERSP, worker.FISH,
            flow_scale=c.flow_scale, control_point_sample_scale=8,
            apply2gt=c.apply2gt)
        p_view = jcal.fisheye_control_points(setup, worker.FOCAL, worker.FOCAL,
                                             c.flow_scale)
        step = jdcal.make_sharded_fisheye_step(
            mesh, setup, rcfg, cfg, g_tx, txs, 0, opt_lens=True,
            use_vignetting=c.start_vignetting == 0)

        def pad(gt):
            if c.apply2gt:
                return jnp.asarray(gt)
            fh = gt.shape[1]
            return jnp.asarray(np.pad(gt, ((0, 0), (0, -(-fh // WORLD) * WORLD - fh),
                                           (0, 0))))

        new, (loss, *_) = step(state, pad(t["gt"]), p_view, jnp.asarray(0),
                               jnp.asarray(worker.BG))
        if name == "fs15":
            return {name: _jax_out(new, loss, cube), worker.BLACK: _jax_black_step(
                lambda gt: step(state, pad(gt), p_view, jnp.asarray(0),
                                jnp.zeros(3)), t["gt"], black)}
    return {name: _jax_out(new, loss, cube)}


def _jax_black_step(step, gt: np.ndarray, black: dict) -> dict:
    """`worker.BLACK` in JAX: `step(gt)` runs the fs15 step on black. Its
    mask, read off the warped rows it hands `_capture.slabs`, differs from
    the port's (`black["port_mask"]`) at some pixels, where the jitted
    step's crop positions round an ulp off the port's (and off JAX's own
    unjitted warp). The fs15 GT with those pixels zeroed goes to
    `black["gt_path"]`, for the ranks, and this step's result against it
    is returned; `black` takes JAX's warped rows, mask, the pixels and the
    GT."""
    step(gt)
    jax.effects_barrier()
    fh = gt.shape[1]
    jw = np.concatenate([_capture.slabs[r] for r in range(WORLD)], 1)[:, :fh]
    jm = (jw[0] != 0) | (jw[1] != 0)
    off = jm != black["port_mask"]
    gt = gt.copy()
    gt[:, off] = 0.0
    _publish(black["gt_path"], gt)
    black.update(jax_warped=jw, jax_mask=jm, off=off, gt=gt)
    new, (loss, *_) = step(gt)
    return _jax_out(new, loss, False)


def _publish(path: str, a: np.ndarray):
    """Write `a` to the .npy `path` whole, for the ranks that wait on it."""
    with open(path + ".part", "wb") as f:
        np.save(f, a)
    os.replace(path + ".part", path)


def _jax_out(new, loss, cube: bool) -> dict:
    jn = new.cubemap_net if cube else new.lens
    return dict(loss=float(loss), xyz=np.asarray(new.base.g.xyz),
                dq=np.asarray(new.base.cams.dq), dt=np.asarray(new.base.cams.dt),
                net=np.concatenate([np.asarray(a).ravel() for f in ("weights", "biases")
                                    for blk in getattr(jn, f) for a in blk]))


def _black_fisheye(name: str) -> dict:
    """The fisheye one-step toy `name`'s camera-0 render on a black
    background (mostly exact zeros), with what both packages' warps of it
    take: the toy, setup, control points, projection scale and lens net."""
    from bags_tpu_torch import convert
    from bags_tpu_torch.core.camera import CameraParams
    from bags_tpu_torch.model.gaussians import Gaussians
    from bags_tpu_torch.raster.render import RenderConfig, render

    t = worker.step_toy(name)
    setup, p_view = worker.fisheye_setup(t["cfg"])
    g = Gaussians(**{f: torch.tensor(t["g"][f]) for f in worker.G_FIELDS})
    cam = CameraParams(**{f: torch.tensor(v) for f, v in t["cams"].items()})[0]
    with torch.no_grad():
        img = render(g.xyz, g.scaling(), g.quats, g.opacity(torch.tensor(
            t["g"]["alive"])), g.sh_coeffs(), cam, setup.render_static,
            RenderConfig(sh_degree=0), bg=torch.zeros(3)).render.numpy()
    nets = worker.nets_np()["lens"]
    return dict(t=t, setup=setup, p_view=p_view, img=img,
                ps=np.array([1 / np.tan(setup.fovx / 2), 1 / np.tan(setup.fovy / 2)],
                            np.float32),
                tnet=convert.iresnet_from_numpy(nets, "cpu"),
                jnet=JNet(**{f: [[jnp.asarray(a) for a in blk] for blk in v]
                             for f, v in nets.items()}))


def _jax_warp_rows(flow_scale: float) -> dict:
    """`_black_fisheye` of the fs10 or fs15 toy and JAX's
    `_fisheye_warp_rows` of its render for each rank: "rows", [(warped,
    mask)] by rank."""
    k = _black_fisheye("fs10" if flow_scale == 1.0 else "fs15")
    s = k["setup"]
    n = -(-s.fish_hw[0] // WORLD)
    k["rows"] = [tuple(np.asarray(a) for a in jdcal._fisheye_warp_rows(
        k["jnet"], jnp.asarray(k["p_view"].numpy()), s.grid_hw, jnp.asarray(k["img"]),
        jnp.asarray(k["ps"]), s.flow_hw, s.fish_hw, n * WORLD, rank * n, n)[:2])
        for rank in range(WORLD)]
    return k


def _port_black_warp() -> dict:
    """`worker.BLACK`'s camera-0 render warped whole by the port
    (`apply_distortion`): the warp and its mask (fh, fw)."""
    from bags_tpu_torch.calib.distortion import apply_distortion

    b = _black_fisheye("fs15")
    s = b["setup"]
    with torch.no_grad():
        tw, tm, _ = apply_distortion(b["tnet"], b["p_view"], s.grid_hw,
                                     torch.tensor(b["img"]), torch.tensor(b["ps"]),
                                     s.flow_hw, final_hw=s.fish_hw)
    return dict(port_warped=tw.numpy(), port_mask=tm.numpy()[0] > 0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' results and the JAX references, compiled while the ranks
    run; the one-process checkpoint the ranks resume from is written
    first, after 2 steps of the single-process fisheye toy. The ranks take
    `worker.BLACK`'s GT last, once JAX's step has given it (the toy's GT
    as it is without 2 virtual devices)."""
    tmp = tmp_path_factory.mktemp("dist_calib")
    ck_in, ck_out = str(tmp / "one_proc.npz"), str(tmp / "two_proc.npz")
    tr = worker.train_toy(CalibTrainer, "fisheye")
    tr.run(iterations=2)
    tr.save_checkpoint(ck_in)
    black = _port_black_warp()
    black_gt = black["gt_path"] = str(tmp / "black_gt.npy")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, str(r), str(WORLD), str(tmp / "store"),
         str(tmp), ck_in, ck_out, black_gt], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for r in range(WORLD)]
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        ref = None
        # XLA compiles outside the GIL: the four steps in threads take
        # about 45 s where one after another take about 60, and the warp
        # rows' unjitted ops compile beside them
        with concurrent.futures.ThreadPoolExecutor(len(worker.STEP_TOYS) + 2) as ex:
            warp_rows = {fs: ex.submit(_jax_warp_rows, fs) for fs in (1.0, 1.5)}
            if len(jax.devices()) >= WORLD:
                halo_slab_loss = jdcal._halo_slab_loss
                jdcal._halo_slab_loss = _capturing(halo_slab_loss)
                try:
                    ref = {}
                    for out in ex.map(lambda n: _jax_step(n, black),
                                      worker.STEP_TOYS):
                        ref.update(out)
                finally:
                    jdcal._halo_slab_loss = halo_slab_loss
            else:
                black["gt"] = worker.step_toy("fs15")["gt"]
                _publish(black_gt, black["gt"])
            warp_rows = {fs: f.result() for fs, f in warp_rows.items()}
        logs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))[0]
                for p in procs]
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return dict(out=[dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)],
                jax=ref, ck_in=ck_in, ck_out=ck_out, black=black,
                warp_rows=warp_rows)


def _same_on_ranks(runs, key, **tol):
    a, b = (o[key] for o in runs["out"])
    np.testing.assert_allclose(a, b, **tol)
    return a


def _both(runs, key):
    return np.concatenate([o[key] for o in runs["out"]])


def _replicated_alike(runs, name):
    _same_on_ranks(runs, f"{name}_checksum", rtol=0, atol=0)


def _assert_black_mask(runs):
    """`worker.BLACK`'s step mask, read off the step's warped rows of both
    ranks, is the port's whole-warp mask, and differs from JAX's sharded
    step's at some pixels, each of them by the crop's rounding
    (`assert_crop_mask_rounding`: a position an ulp off its pixel beside a
    zero, so that one package reads exactly 0 and the other a neighbour
    times ~1e-7; ROADMAP Queue 3)."""
    from test_torch_lens_warp import assert_crop_mask_rounding

    b = runs["black"]
    fh = b["port_mask"].shape[0]
    img = np.concatenate([o[f"{worker.BLACK}_image"] for o in runs["out"]], 1)[:, :fh]
    mask = (img[0] != 0) | (img[1] != 0)
    np.testing.assert_array_equal(mask, b["port_mask"])
    np.testing.assert_allclose(img, b["port_warped"], atol=1e-6)
    assert 0 < mask.mean() < 1 and b["off"].any()
    np.testing.assert_array_equal(mask != b["jax_mask"], b["off"])
    assert_crop_mask_rounding(b["off"], img, b["jax_warped"], False)


@pytest.mark.parametrize("name", ["fs10", "fs15", "gt", "cube", worker.BLACK])
def test_sharded_step_matches_jax_sharded_step(runs, name):
    """One step on 2 ranks against JAX's sharded step on 2 virtual devices:
    the fisheye step at flow scale 1.0 (no crop) and 1.5 (crop, vignetting,
    shift), the `--apply2gt` step, the cubemap step. The replicated state
    is alike on both ranks. On black (`worker.BLACK`) the crop's exact-zero
    mask flips some pixels between the packages (`_assert_black_mask`
    asserts that each flip is of the rounding kind); against the fs15 GT a
    flipped pixel adds or drops its GT value in the loss (3.3 % of it at
    20 of 1,872 pixels), so both steps run with the GT zeroed there
    (`_jax_black_step`), and every loss and gradient difference left must
    be within the tolerances: none comes from anywhere else."""
    if runs["jax"] is None:
        pytest.skip("needs 2 virtual devices")
    if name == worker.BLACK:
        _assert_black_mask(runs)
    want = runs["jax"][name]
    _replicated_alike(runs, name)
    np.testing.assert_allclose(_same_on_ranks(runs, f"{name}_loss", rtol=0),
                               want["loss"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_both(runs, f"{name}_xyz"), want["xyz"],
                               rtol=1e-3, atol=2e-5, err_msg="xyz")
    for f in ("dq", "dt"):
        np.testing.assert_allclose(runs["out"][0][f"{name}_{f}"], want[f],
                                   rtol=1e-3, atol=2e-5, err_msg=f)
    np.testing.assert_allclose(runs["out"][0][f"{name}_net"], want["net"],
                               rtol=1e-3, atol=1e-7, err_msg="net")


@pytest.mark.parametrize("flow_scale", [1.0, 1.5])
def test_fisheye_warp_rows_match_jax_and_the_whole_warp(runs, flow_scale):
    """Each of 2 ranks' rows of the apply-to-render warp
    (`fisheye_warp_rows`; flow scale 1.0 without the crop, 1.5 with it) of
    the one-step toy's render on a black background, mostly exact zeros,
    where the exact-zero mask decides: against
    JAX's `_fisheye_warp_rows` the values within 2e-5 and the masks equal
    but for the crop's rounding (`assert_crop_mask_rounding`: a position an
    ulp off its pixel beside a zero, `jnp.linspace` against
    `torch.linspace`; ROADMAP Queue 3), and against the rows of the port's
    whole warp (`apply_distortion`) the masks equal and the values within
    1e-6. JAX's rows come from the `runs` fixture (`_jax_warp_rows`)."""
    from bags_tpu_torch.calib.distortion import apply_distortion
    from bags_tpu_torch.dist.calib import fisheye_warp_rows
    from test_torch_lens_warp import assert_crop_mask_rounding

    k = runs["warp_rows"][flow_scale]
    setup, p_view, img, ps, tnet = k["setup"], k["p_view"], k["img"], k["ps"], k["tnet"]
    fh = setup.fish_hw[0]
    n = -(-fh // WORLD)
    with torch.no_grad():
        whole, whole_mask, _ = apply_distortion(
            tnet, p_view, setup.grid_hw, torch.tensor(img), torch.tensor(ps),
            setup.flow_hw, final_hw=setup.fish_hw)
    for rank in range(WORLD):
        with torch.no_grad():
            tw, tm = fisheye_warp_rows(tnet, p_view, setup.grid_hw, torch.tensor(img),
                                       torch.tensor(ps), setup.flow_hw, setup.fish_hw,
                                       n * WORLD, rank * n, n)
        jw, jm = k["rows"][rank]
        tw, tm = tw.numpy(), tm.numpy()
        real = min(n, fh - rank * n)                    # rows past fh are padding
        off = (tm != jm)[0, :real]
        np.testing.assert_allclose(tw[:, :real], jw[:, :real], atol=2e-5)
        if flow_scale == 1.0:
            assert not off.any()
        else:
            assert_crop_mask_rounding(off, tw[:, :real], jw[:, :real], False)
        rows = slice(rank * n, rank * n + real)
        np.testing.assert_array_equal(tm[:, :real], whole_mask[:, rows].numpy())
        np.testing.assert_allclose(tw[:, :real], whole[:, rows].numpy(), atol=1e-6)
    assert 0 < float(whole_mask.mean()) < 1


@pytest.mark.parametrize("name", ["fs10", "fs15", "gt", "cube", worker.BLACK])
def test_sharded_step_matches_one_device(runs, name):
    """The same step against the port's single-device step on the whole
    population: the loss (rtol 1e-5), positions, camera rows (atol 1e-5),
    the net and its first moments (atol 1e-7). A gradient counted D times
    or 1 / D times would fail here."""
    cs, m = worker.run_step(name, slice(None), sharded=False,
                            black_gt=runs["black"]["gt"])
    cube = name == "cube"
    np.testing.assert_allclose(runs["out"][0][f"{name}_loss"], float(m.loss),
                               rtol=1e-5)
    np.testing.assert_allclose(_both(runs, f"{name}_xyz"),
                               cs.base.g.xyz.detach().numpy(), atol=1e-5)
    for f in ("dq", "dt"):
        np.testing.assert_allclose(runs["out"][0][f"{name}_{f}"],
                                   getattr(cs.base.cams, f).detach().numpy(),
                                   atol=1e-5, err_msg=f)
    np.testing.assert_allclose(runs["out"][0][f"{name}_net"],
                               worker.net_flat(worker.net_of(cs, cube)), atol=1e-7)
    mu = worker.moments_flat(cs, cube)
    np.testing.assert_allclose(runs["out"][0][f"{name}_mu"], mu,
                               atol=1e-7 + 1e-4 * np.abs(mu).max())
    assert np.abs(mu).max() > 0


def test_step_collectives(runs):
    """Each step's collectives by kind on rank 0: apply-to-render gathers
    the (3, 64, 48) frame once and scatters its gradient back, `--apply2gt`
    has no image collective, the cubemap step one of each a face; every
    step gathers the 15-float packet of each render (CAP slots) and sends
    2 x 5 rows x W x 6 floats of halo to its one neighbour a render; one
    all-reduce of the replicated gradients and one of the scalars."""
    kinds = {k: i for i, k in enumerate(tmesh.KINDS)}
    w, frame = worker.PERSP[0], 3 * 64 * worker.PERSP[0] * 4
    for name, renders, images in (("fs10", 1, 1), ("fs15", 1, 1), ("gt", 1, 0),
                                  ("cube", 5, 5)):
        c = runs["out"][0][f"{name}_counts"]
        np.testing.assert_array_equal(c[kinds["image_all_gather"]],
                                      [images, images * frame], err_msg=name)
        np.testing.assert_array_equal(c[kinds["image_reduce_scatter"]],
                                      [images, images * frame], err_msg=name)
        np.testing.assert_array_equal(
            c[kinds["packet_all_gather"]],
            # the main render carries the two densify-probe rows
            [renders, 4 * worker.CAP * (15 + 13 * (renders - 1))], err_msg=name)
        assert (c[kinds["halo_send"], 1] + c[kinds["halo_grad_send"], 1]
                == renders * 2 * 5 * w * 6 * 4), name
        assert c[kinds["all_reduce"], 0] == 2, name


@pytest.mark.parametrize("mode", ["fisheye", "apply2gt", "cubemap"])
def test_sharded_calib_trainer_matches_one_process(runs, mode):
    """3 `ShardedCalibTrainer` steps with densify at iteration 2 against
    `CalibTrainer` in one process: the losses (rtol 1e-5), live counts and
    mask (exact; densify doubles the live count), positions (atol 1e-5)
    and the trained net (atol 1e-7), the replicated state alike on both
    ranks."""
    tr = worker.train_toy(CalibTrainer, mode)
    hist = tr.run(iterations=worker.STEPS, log_every=1)
    out = runs["out"][0]
    _replicated_alike(runs, mode)
    np.testing.assert_allclose(_same_on_ranks(runs, f"{mode}_losses", rtol=0),
                               [h[1] for h in hist], rtol=1e-5)
    np.testing.assert_array_equal(out[f"{mode}_alive"], [h[2] for h in hist])
    assert out[f"{mode}_alive"][-1] > out[f"{mode}_alive"][0]
    np.testing.assert_array_equal(out[f"{mode}_alive_mask"], tr.base.alive.numpy())
    np.testing.assert_allclose(out[f"{mode}_xyz"], tr.base.g.xyz.detach().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(out[f"{mode}_dq"], tr.base.cams.dq.detach().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(out[f"{mode}_net"], worker.net_flat(
        worker.net_of(tr.state, mode == "cubemap")), atol=1e-7)


def test_sharded_hybrid_fisheye_matches_one_process(runs):
    """--hybrid in the fisheye mode under the mesh trains as one process
    does (the JAX package's sharded fisheye step leaves the specular colour
    out): the losses, and the specular MLP alike on both ranks, moved, and
    equal to the one-process run's."""
    tr = worker.train_toy(CalibTrainer, "hybrid")
    hist = tr.run(iterations=worker.STEPS, log_every=1)
    _replicated_alike(runs, "hybrid")
    np.testing.assert_allclose(_same_on_ranks(runs, "hybrid_losses", rtol=0),
                               [h[1] for h in hist], rtol=1e-5)
    w1 = _same_on_ranks(runs, "hybrid_spec_w1", rtol=0, atol=0)
    np.testing.assert_allclose(w1, tr.base.spec.w1.detach().numpy(), atol=1e-6)
    from bags_tpu_torch.calib.specular import init_specular_params
    assert np.abs(w1 - init_specular_params(3, "cpu").w1.detach().numpy()).max() > 1e-5


def test_calib_checkpoint_from_two_processes_resumes_in_one(runs):
    """The 2-process save writes `CalibTrainer`'s file (same leaves and
    shapes as a one-process save); one process restores it and its next
    step's loss equals the 2-process restore's."""
    out = runs["out"][0]
    ref = worker.train_toy(CalibTrainer, "fisheye")
    np.testing.assert_allclose(out["ckpt_save_losses"],
                               [h[1] for h in ref.run(2, log_every=1)], rtol=1e-5)
    ref_path = os.path.join(os.path.dirname(runs["ck_out"]), "ref.npz")
    ref.save_checkpoint(ref_path)
    got, want = np.load(runs["ck_out"]), np.load(ref_path)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].shape == want[k].shape, k
    np.testing.assert_allclose(got["v2|.lens.weights[0][0]"],
                               want["v2|.lens.weights[0][0]"], atol=1e-7)
    tr = worker.train_toy(CalibTrainer, "fisheye")
    tr.load_checkpoint(runs["ck_out"])
    assert tr.base.step == int(out["ckpt_save_step"]) == 2
    _replicated_alike(runs, "ckpt_save")
    np.testing.assert_allclose(out["ckpt_save_resumed"],
                               [h[1] for h in tr.run(1, log_every=1)], rtol=1e-5)


def test_calib_checkpoint_from_one_process_resumes_in_two(runs):
    """A one-process `CalibTrainer` checkpoint restores into both ranks'
    blocks: the next step's loss equals one process's restore of it."""
    tr = worker.train_toy(CalibTrainer, "fisheye")
    tr.load_checkpoint(runs["ck_in"])
    _replicated_alike(runs, "ckpt_resume")
    out = _same_on_ranks(runs, "ckpt_resume_resumed", rtol=0)
    assert int(runs["out"][1]["ckpt_resume_step"]) == 2
    np.testing.assert_allclose(out, [h[1] for h in tr.run(1, log_every=1)],
                               rtol=1e-5)


def test_batch_cams_refused_under_a_calibrated_mesh():
    """--batch_cams > 1 with a calibrated mode under a mesh raises, as in
    JAX (`bags_tpu/dist/trainer.py:205-207`), before anything is built."""
    from bags_tpu_torch.dist.trainer import ShardedCalibTrainer

    for mode in ("fisheye", "cubemap"):
        cfg = worker.config(mode)
        cfg.mesh, cfg.opt.batch_cams = 2, 2
        with pytest.raises(ValueError, match="batch_cams"):
            ShardedCalibTrainer(None, None, None, None, cfg, 2.0, None,
                                worker.FOCAL, worker.FOCAL, worker.PERSP)
