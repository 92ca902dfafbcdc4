"""Port parity, tile-parallel training (`bags_tpu_torch/dist/`) on 2 gloo
ranks on the CPU: one spawn of two processes (`_torch_dist_worker.py`, a
JAX-free module) runs every scenario and writes an npz per rank; each test
asserts its part. The references are the single-process port (the same
toys, `Trainer`) and, for the halo loss, the sharded loss and 4 steps
with densify, the JAX package (`photometric_loss`; `sharded_render_loss`
and `ShardedTrainer` on a 2-device virtual mesh at `backend="jnp"`, its
Pallas call being broken, ROADMAP.md Queue 3).
Tolerances: losses rtol 1e-5, images atol 2e-5, gradients atol 1e-5 and
rtol 1e-3 (`tests/test_pallas_raster.py:20-107`)."""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from bags_tpu.core.camera import CameraParams as JCam
from bags_tpu.core.camera import CameraStatic as JStatic
from bags_tpu.core.camera import GlobalAlignment as JAlign
from bags_tpu.dist import mesh as jmesh
from bags_tpu.dist import sharded as jsharded
from bags_tpu.model.gaussians import Gaussians as JGaussians
from bags_tpu.raster import RenderConfig as JCfg
from bags_tpu.train.losses import photometric_loss as jphotometric
from bags_tpu_torch.core.camera import CameraParams, CameraStatic
from bags_tpu_torch.dist import mesh as tmesh
from bags_tpu_torch.model.gaussians import Gaussians
from bags_tpu_torch.raster.render import RenderConfig, render
from bags_tpu_torch.train.loop import Trainer
from bags_tpu_torch.train.losses import photometric_loss
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

WORLD = 2
SPAWN_TIMEOUT = 180   # seconds for both ranks; the run takes about 10


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results; the one-process checkpoint they resume from is
    written here first, after 2 steps of the single-process toy."""
    tmp = tmp_path_factory.mktemp("dist")
    ck_in, ck_out = str(tmp / "one_proc.npz"), str(tmp / "two_proc.npz")
    tr = worker.train_toy(Trainer, "plain")
    tr.run(iterations=2)
    tr.save_checkpoint(ck_in)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, str(r), str(WORLD), str(tmp / "store"),
         str(tmp), ck_in, ck_out], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for r in range(WORLD)]
    deadline = time.monotonic() + SPAWN_TIMEOUT
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail(f"2-rank run did not finish in {SPAWN_TIMEOUT} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return dict(out=[dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)],
                ck_in=ck_in, ck_out=ck_out)


def _is_block(key):
    """Whether a gradient is per rank block (the Gaussians' and the densify
    probes') rather than replicated (the camera's)."""
    return key.startswith("g_") or key in ("probe", "absp")


def _both(ranks, key):
    return np.concatenate([o[key] for o in ranks["out"]])


def _same_on_ranks(ranks, key, **tol):
    a, b = (o[key] for o in ranks["out"])
    np.testing.assert_allclose(a, b, **tol)
    return a


@pytest.mark.parametrize("height, world", [(40, 2), (48, 2), (1080, 4), (56, 4),
                                           (16, 3)])
def test_padded_height_and_slab_rows_match_jax(height, world):
    """The padded height, each slab's tile rows, and each rank's instance
    budget (JAX's `ceil(max_instances / D / CHUNK) CHUNK`, sharded.py:107)."""
    from bags_tpu.raster.binning import CHUNK

    assert tmesh.padded_height(height, world) == jmesh.padded_height(height, world)
    assert tmesh.tiles_y_local(CameraStatic(64, height), world) == \
        jsharded._tiles_y_local(JStatic(width=64, height=height), world)
    budget = 1000 * height + 1
    assert tmesh.local_budget(budget, world) == \
        -(-(budget // world) // CHUNK) * CHUNK
    assert tmesh.local_budget(None, world) is None


def test_halo_loss_matches_jax_photometric_loss(ranks):
    """The halo loss of two slabs equals `photometric_loss` of the whole
    image (float32 summation order alone differs), and the slabs' gradients
    its gradient; the padded rows get none."""
    rng = np.random.default_rng(5)
    pred = rng.uniform(size=(3, worker.H, worker.W)).astype(np.float32)
    gt = rng.uniform(size=(3, worker.H, worker.W)).astype(np.float32)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, q: jphotometric(p, q, 0.2)))(
        jnp.asarray(pred), jnp.asarray(gt))
    loss = _same_on_ranks(ranks, "halo_loss", rtol=0)
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    grad = np.concatenate([o["halo_grad"] for o in ranks["out"]], axis=1)
    np.testing.assert_allclose(grad[:, :worker.H], np.asarray(jg), atol=1e-7,
                               rtol=1e-4)
    assert not grad[:, worker.H:].any()


def _port_single(t):
    """The plain port's loss and gradients on `loss_toy` (one device)."""
    g = Gaussians(**{f: torch.tensor(t[f], requires_grad=True)
                     for f in worker.G_FIELDS})
    cam = CameraParams(**{f: torch.tensor(t[f], requires_grad=f in
                                          ("dq", "dt", "fovx", "fovy"))
                          for f in worker.CAM_FIELDS})
    probe = torch.zeros((worker.CAP, 2), requires_grad=True)
    absp = torch.zeros((worker.CAP, 2), requires_grad=True)
    out = render(g.xyz, g.scaling(), g.quats,
                 g.opacity(torch.ones(worker.CAP, dtype=torch.bool)),
                 g.sh_coeffs(), cam, CameraStatic(*worker.LOSS_WH),
                 RenderConfig(sh_degree=1), probe2d=probe, abs_probe=absp)
    loss = photometric_loss(out.render, torch.tensor(t["gt"]))
    loss.backward()
    grads = {f"g_{f}": getattr(g, f).grad.numpy() for f in worker.G_FIELDS}
    grads.update({f"cam_{f}": getattr(cam, f).grad.numpy()
                  for f in ("dq", "dt", "fovx", "fovy")})
    grads.update(probe=probe.grad.numpy(), absp=absp.grad.numpy())
    return float(loss.detach()), out.render.detach().numpy(), out.radii.numpy(), grads


def test_sharded_loss_and_grads_match_one_device(ranks):
    """D = 2 against the port on one device: the loss, the image (both
    slabs, cut to the true height), the radii, the Gaussian and probe
    gradients (each rank's block, brought to it by the gather's
    reduce-scatter), and the camera gradients (all-reduced, alike on both
    ranks). A factor of D in any gradient would fail here."""
    t = worker.loss_toy()
    loss, image, radii, grads = _port_single(t)
    np.testing.assert_allclose(_same_on_ranks(ranks, "loss_loss", rtol=0), loss,
                               rtol=1e-5)
    slabs = np.concatenate([o["loss_slab"] for o in ranks["out"]], axis=1)
    np.testing.assert_allclose(slabs[:, :worker.LOSS_WH[1]], image, atol=2e-5)
    np.testing.assert_array_equal(_same_on_ranks(ranks, "loss_radii", rtol=0), radii)
    for key, want in grads.items():
        got = (_both(ranks, f"loss_{key}") if _is_block(key)
               else _same_on_ranks(ranks, f"loss_{key}", rtol=0))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-3, err_msg=key)
        assert np.abs(want).max() > 0, key


def test_sharded_loss_matches_jax_sharded_jnp(ranks):
    """D = 2 against JAX's `sharded_render_loss` on a 2-device virtual mesh
    at backend="jnp" (the per-tile scan capped at the toy's slot count):
    the loss and the Gaussian, camera and probe gradients."""
    if len(jax.devices()) < WORLD:
        pytest.skip("needs 2 virtual devices")
    t = worker.loss_toy()
    g = JGaussians(**{f: jnp.asarray(t[f]) for f in worker.G_FIELDS})
    cam = JCam(**{f: jnp.asarray(t[f]) for f in worker.CAM_FIELDS})
    w, h = worker.LOSS_WH
    static = JStatic(width=w, height=h)
    hp = jmesh.padded_height(h, WORLD)
    gt = jnp.asarray(np.concatenate([t["gt"], np.zeros((3, hp - h, w), np.float32)], 1))
    loss_fn = jsharded.sharded_render_loss(
        jmesh.make_mesh(WORLD), static,
        JCfg(sh_degree=1, backend="jnp", max_instances=2 ** 14,
             max_per_tile=worker.CAP), return_image=False)
    alive = jnp.ones((worker.CAP,), bool)
    zeros = jnp.zeros((worker.CAP, 2))

    def f(g, cam, probe, absp):
        return loss_fn(g, alive, cam, JAlign.identity(), probe, absp, gt,
                       jnp.zeros(3))[0]

    jl, (gg, gc, gp, ga) = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3)))(
        g, cam, zeros, zeros)
    np.testing.assert_allclose(ranks["out"][0]["loss_loss"], float(jl), rtol=1e-5)
    want = {f"g_{f}": getattr(gg, f) for f in worker.G_FIELDS}
    want.update({f"cam_{f}": getattr(gc, f) for f in ("dq", "dt", "fovx", "fovy")})
    want.update(probe=gp, absp=ga)
    for key, w_ in want.items():
        got = (_both(ranks, f"loss_{key}") if _is_block(key)
               else ranks["out"][0][f"loss_{key}"])
        np.testing.assert_allclose(got, np.asarray(w_), atol=1e-5, rtol=1e-3,
                                   err_msg=key)


def test_sharded_render_sorted_by_distance_matches_one_device(ranks):
    """`RenderConfig(sort_by_distance=True)` under the mesh: the gathered
    camera distances order the slabs' instances as the single-device
    render's (which differs from the depth order here by 0.06)."""
    t = worker.loss_toy()
    g = Gaussians(**{f: torch.tensor(t[f]) for f in worker.G_FIELDS})
    cam = CameraParams(**{f: torch.tensor(t[f]) for f in worker.CAM_FIELDS})
    alive = torch.ones(worker.CAP, dtype=torch.bool)
    img = {s: render(g.xyz, g.scaling(), g.quats, g.opacity(alive),
                     g.sh_coeffs(), cam, CameraStatic(*worker.LOSS_WH),
                     RenderConfig(sh_degree=1, sort_by_distance=s)).render.numpy()
           for s in (False, True)}
    slabs = np.concatenate([o["sorted_slab"] for o in ranks["out"]], axis=1)
    np.testing.assert_allclose(slabs[:, :worker.LOSS_WH[1]], img[True], atol=2e-5)
    assert np.abs(img[True] - img[False]).max() > 1e-2


def _single(mode):
    tr = worker.train_toy(Trainer, mode)
    hist = tr.run(iterations=worker.STEPS[mode], log_every=1)
    return tr, [h[1] for h in hist], [h[2] for h in hist]


def _train_matches(ranks, mode):
    """The mesh run's losses, live counts and population against the
    single-process port's; the replicated state alike on both ranks."""
    tr, losses, alive = _single(mode)
    _same_on_ranks(ranks, f"{mode}_checksum", rtol=0, atol=0)
    np.testing.assert_allclose(_same_on_ranks(ranks, f"{mode}_losses", rtol=0),
                               losses, rtol=1e-5)
    np.testing.assert_array_equal(ranks["out"][0][f"{mode}_alive"], alive)
    np.testing.assert_array_equal(ranks["out"][0][f"{mode}_alive_mask"],
                                  tr.base.alive.numpy())
    return tr


def test_sharded_trainer_densify_matches_one_process(ranks):
    """4 steps with densify at iterations 2 and 4 under the mesh: the live
    count doubles as in one process, the losses agree, the positions agree
    (Adam at eps 1e-15 lets float noise move an entry by about its lr)."""
    tr = _train_matches(ranks, "densify")
    assert ranks["out"][0]["densify_alive"][-1] > 64
    np.testing.assert_allclose(ranks["out"][0]["densify_xyz"],
                               tr.base.g.xyz.detach().numpy(), atol=1e-4)


def _jax_sharded_clone_run():
    """JAX's `ShardedTrainer` on a 2-device virtual mesh at backend="jnp"
    on `train_toy("clone")`'s scene, cameras, GT and cadence: the losses,
    live counts, and the final state."""
    from bags_tpu.dist.trainer import ShardedTrainer as JShardedTrainer
    from bags_tpu.model.gaussians import create_from_points
    from bags_tpu.train.config import CalibConfig, TrainConfig

    rng = np.random.default_rng(0)
    n = worker.CAP // 2
    pts = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                    rng.uniform(4, 8, n)], -1).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    g, alive = create_from_points(pts, cols, worker.CAP, sh_degree=1)
    cams = []
    for i in range(3):
        a = 0.04 * (i - 1)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]], np.float32)
        cams.append(JCam.create(R, np.zeros(3, np.float32), 0.8, 0.8))
    cfg = TrainConfig(calib=CalibConfig(opt_cam=True), mesh=WORLD)
    cfg.model.sh_degree = 1
    cfg.opt.densify_from_iter = 1
    cfg.opt.percent_dense = 1.0
    cfg.opt.densification_interval = 2
    cfg.opt.densify_grad_threshold = 1e-8
    cfg.opt.opacity_reset_interval = 10 ** 9
    gt = jnp.stack([jnp.full((3, worker.H, worker.W), 0.2 * (i + 1))
                    for i in range(3)])
    tr = JShardedTrainer(
        g, alive, jax.tree_util.tree_map(lambda *x: jnp.stack(x), *cams),
        JStatic(width=worker.W, height=worker.H), cfg, scene_extent=10.0,
        gt_images=gt, rcfg=JCfg(sh_degree=1, backend="jnp",
                                max_instances=2 ** 14, max_per_tile=worker.CAP),
        seed=3, n_devices=WORLD)
    hist = tr.run(iterations=worker.STEPS["clone"], log_every=1)
    return hist, tr.state


def test_sharded_trainer_densify_matches_jax_sharded_trainer(ranks):
    """4 steps with densify at iterations 2 and 4 on 2 ranks against JAX's
    `ShardedTrainer` on 2 virtual devices (backend="jnp", MCMC off: JAX's
    sharded step has no regularisers), every densified Gaussian cloned
    (split draws differ between the packages' generators): the losses
    (rtol 1e-5), live counts and mask (exact), positions and camera rows
    (atol 1e-5). Measured against one process of the port: losses within
    1.5e-7, positions 2.4e-6, camera rows 3.3e-7."""
    if len(jax.devices()) < WORLD:
        pytest.skip("needs 2 virtual devices")
    hist, state = _jax_sharded_clone_run()
    out = ranks["out"][0]
    np.testing.assert_allclose(_same_on_ranks(ranks, "clone_losses", rtol=0),
                               [h[1] for h in hist], rtol=1e-5)
    np.testing.assert_array_equal(out["clone_alive"], [h[2] for h in hist])
    assert out["clone_alive"][-1] == 2 * out["clone_alive"][0]
    np.testing.assert_array_equal(out["clone_alive_mask"], np.asarray(state.alive))
    np.testing.assert_allclose(out["clone_xyz"], np.asarray(state.g.xyz), atol=1e-5)
    for f in ("dq", "dt"):
        np.testing.assert_allclose(_same_on_ranks(ranks, f"clone_{f}", rtol=0),
                                   np.asarray(getattr(state.cams, f)), atol=1e-5,
                                   err_msg=f)


def test_sharded_batch_cams_matches_one_process(ranks):
    """--batch_cams 2 under the mesh: two slab renders a step, one backward."""
    tr = _train_matches(ranks, "batch")
    np.testing.assert_allclose(ranks["out"][0]["batch_xyz"],
                               tr.base.g.xyz.detach().numpy(), atol=1e-5)


def test_sharded_hybrid_moves_specular_alike(ranks):
    """--hybrid under the mesh: the specular colour on each rank's own rows,
    the MLP's gradients all-reduced: the same MLP on both ranks, moved from
    its initialisation and equal to the one-process run's."""
    tr = _train_matches(ranks, "hybrid")
    w1 = _same_on_ranks(ranks, "hybrid_spec_w1", rtol=0, atol=0)
    np.testing.assert_allclose(w1, tr.base.spec.w1.detach().numpy(), atol=1e-6)
    from bags_tpu_torch.calib.specular import init_specular_params
    assert np.abs(w1 - init_specular_params(3, "cpu").w1.detach().numpy()).max() > 1e-4


def test_sharded_mcmc_relocation_ranks_agree(ranks):
    """--mcmc under the mesh: the relocations at iterations 2 and 4 move the
    8 opacity-dead Gaussians onto drawn sources identically on both ranks
    (same generator, same gathered population) and as in one process; the
    noise moves the positions alike."""
    tr = _train_matches(ranks, "mcmc")
    log = ranks["out"][0]["mcmc_log"]
    np.testing.assert_array_equal(log, np.array(tr.mcmc_log))
    assert log[0][1] == 8
    np.testing.assert_allclose(ranks["out"][0]["mcmc_xyz"],
                               tr.base.g.xyz.detach().numpy(), atol=1e-5)


def test_checkpoint_from_two_processes_resumes_in_one(ranks):
    """The 2-process save writes the single-device file (same leaves and
    shapes); one process restores it and its next step's loss equals the
    2-process restore's."""
    out = ranks["out"][0]
    ref = worker.train_toy(Trainer, "plain")
    np.testing.assert_allclose(out["ckpt_save_losses"],
                               [h[1] for h in ref.run(2, log_every=1)], rtol=1e-5)
    ref_path = os.path.join(os.path.dirname(ranks["ck_out"]), "ref.npz")
    ref.save_checkpoint(ref_path)
    got, want = np.load(ranks["ck_out"]), np.load(ref_path)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].shape == want[k].shape, k
    tr = worker.train_toy(Trainer, "plain")
    tr.load_checkpoint(ranks["ck_out"])
    assert tr.base.step == int(out["ckpt_save_step"]) == 2
    np.testing.assert_allclose(out["ckpt_save_resumed"],
                               [h[1] for h in tr.run(1, log_every=1)], rtol=1e-5)


def test_checkpoint_from_one_process_resumes_in_two(ranks):
    """A one-process checkpoint restores into both ranks' blocks: the next
    step's loss equals one process's restore of it."""
    tr = worker.train_toy(Trainer, "plain")
    tr.load_checkpoint(ranks["ck_in"])
    out = _same_on_ranks(ranks, "ckpt_resume_resumed", rtol=0)
    assert int(ranks["out"][1]["ckpt_resume_step"]) == 2
    np.testing.assert_allclose(out, [h[1] for h in tr.run(1, log_every=1)],
                               rtol=1e-5)
