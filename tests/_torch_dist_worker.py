"""One rank of the 2-process gloo runs of `tests/test_torch_dist.py`
(JAX-free: the test spawns it with `subprocess`, and the toys here are
imported by the test for its single-process references).

    python tests/_torch_dist_worker.py RANK WORLD STORE OUT CKPT_IN CKPT_OUT

Joins the process group on the FileStore STORE (one torch thread), runs
every scenario in order and writes this rank's results to
OUT/rank{RANK}.npz, a key per scenario and value:
  halo      the halo loss of a random image split into slabs, and the
            gradient of this rank's slab;
  loss      the sharded loss of `loss_toy`, its Gaussian and probe
            gradients (this rank's block), camera gradients, and the slab;
  sorted    the slab of `loss_toy` sorted by camera distance;
  densify, clone, batch, hybrid, mcmc   `train_toy(mode)` under the
            mesh: the losses, live counts, population, cameras, and
            checksums of the replicated state;
  ckpt_save     2 steps and a checkpoint to CKPT_OUT (rank 0 writes), then
                a fresh trainer restores it and takes 1 step;
  ckpt_resume   a fresh trainer restores CKPT_IN (written by one process)
                and takes 1 step.
"""

import datetime
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

H, W, CAP = 40, 64, 128          # 3 tile rows: padded to 4 at 2 ranks
LOSS_WH = (48, 40)


def loss_toy():
    """The sharded-loss scene, as numpy: `make_toy_scene(n=128, 48x40,
    SH 1, seed 8)`'s Gaussians, a camera moved off the identity and a
    seeded GT."""
    from bags_tpu_torch.utils.testing import make_toy_scene

    sc = make_toy_scene(n=CAP, width=LOSS_WH[0], height=LOSS_WH[1],
                        sh_degree=1, seed=8, device="cpu")
    rng = np.random.default_rng(21)
    op = sc["opacity"].numpy()
    return dict(
        xyz=sc["xyz"].numpy(), sh_dc=sc["sh_coeffs"][:, :1].numpy(),
        sh_rest=sc["sh_coeffs"][:, 1:].numpy(),
        scales_log=np.log(sc["scales"].numpy()), quats=sc["quats"].numpy(),
        opacity_raw=np.log(op / (1 - op)),
        q_init=sc["cam"].q_init.numpy(), t_init=sc["cam"].t_init.numpy(),
        dq=np.array([1.0, 0.01, -0.02, 0.005], np.float32),
        dt=np.array([0.03, -0.02, 0.05], np.float32),
        fovx=sc["cam"].fovx.numpy(), fovy=sc["cam"].fovy.numpy(),
        gt=rng.uniform(0.1, 0.6, (3, LOSS_WH[1], LOSS_WH[0])).astype(np.float32))


G_FIELDS = ("xyz", "sh_dc", "sh_rest", "scales_log", "quats", "opacity_raw")
CAM_FIELDS = ("q_init", "t_init", "dq", "dt", "fovx", "fovy")


def train_toy(cls, mode: str, **kw):
    """A trainer of class `cls` (Trainer or ShardedTrainer) on the toy of
    tests/_mp_worker.py: 64 of 128 slots live (SH 1), 3 cameras turned a
    little about y, 64x40 GT of 0.2, 0.4 and 0.6, --opt_cam. mode:
    "densify" (from iteration 1 every 2, threshold 1e-8), "batch"
    (--batch_cams 2), "hybrid", "mcmc" (relocation every 2 from iteration
    1, 8 live slots at opacity ~ 0), "clone" (as "densify" with every
    Gaussian small enough to clone: no random draw, so the JAX package's
    trainer takes the same steps), "plain" (nothing else)."""
    from bags_tpu_torch.core.camera import CameraParams, CameraStatic
    from bags_tpu_torch.model.gaussians import create_from_points
    from bags_tpu_torch.train.config import CalibConfig, TrainConfig

    rng = np.random.default_rng(0)
    n = CAP // 2
    pts = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                    rng.uniform(4, 8, n)], -1).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    g, alive = create_from_points(pts, cols, CAP, sh_degree=1, device="cpu")
    if mode == "mcmc":
        with torch.no_grad():
            g.opacity_raw[:8] = -12.0
    cams = []
    for i in range(3):
        a = 0.04 * (i - 1)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]], np.float32)
        cams.append(CameraParams.create(R, np.zeros(3, np.float32), 0.8, 0.8,
                                        device="cpu"))
    cfg = TrainConfig(calib=CalibConfig(opt_cam=True, hybrid=mode == "hybrid"),
                      mcmc=mode == "mcmc")
    cfg.model.sh_degree = 1
    cfg.opt.densify_from_iter = (1 if mode in ("densify", "clone", "mcmc")
                                 else 10 ** 9)
    if mode == "clone":
        cfg.opt.percent_dense = 1.0
    cfg.opt.densification_interval = 2
    cfg.opt.densify_grad_threshold = 1e-8
    cfg.opt.opacity_reset_interval = 10 ** 9
    cfg.opt.batch_cams = 2 if mode == "batch" else 1
    if cls.__name__ == "ShardedTrainer":
        cfg.mesh = torch.distributed.get_world_size()
    gt = torch.stack([torch.full((3, H, W), 0.2 * (i + 1)) for i in range(3)])
    return cls(g, alive, CameraParams.stack(cams), CameraStatic(W, H), cfg,
               scene_extent=10.0, gt_images=gt, seed=3, **kw)


STEPS = {"densify": 4, "clone": 4, "batch": 3, "hybrid": 3, "mcmc": 5}


def replicated_checksum(tr) -> np.ndarray:
    """Sums of the state every rank must hold alike: the cameras and their
    Adam moments, the specular MLP, and the generator."""
    st = tr.base
    parts = [getattr(st.cams, f).sum() for f in CAM_FIELDS]
    parts += [m.sum() for m in list(st.cam_opt.mu.values())
              + list(st.cam_opt.nu.values())]
    if st.spec is not None:
        parts += [t.sum() for t in st.spec.named_tensors().values()]
    parts.append(st.gen.get_state().to(torch.float64).sum())
    return torch.stack([torch.as_tensor(p, dtype=torch.float64)
                        for p in parts]).detach().numpy()


def _halo(rank, world, out):
    from bags_tpu_torch.dist.mesh import padded_height
    from bags_tpu_torch.dist.sharded import halo_slab_loss, total_loss
    from bags_tpu_torch.core.camera import CameraStatic
    from bags_tpu_torch.dist.mesh import all_reduce_sum

    rng = np.random.default_rng(5)
    pred = rng.uniform(size=(3, H, W)).astype(np.float32)
    gt = rng.uniform(size=(3, H, W)).astype(np.float32)
    hp = padded_height(H, world)
    hl = hp // world
    pad = np.zeros((3, hp - H, W), np.float32)
    p = torch.tensor(np.concatenate([pred, pad], 1)[:, rank * hl:(rank + 1) * hl],
                     requires_grad=True)
    g = torch.tensor(np.concatenate([gt, pad], 1)[:, rank * hl:(rank + 1) * hl])
    partial, l1, s = halo_slab_loss(p, g, rank * hl, H, 0.2)
    partial.backward()
    sums = torch.stack([l1, s])
    all_reduce_sum([sums])
    out["halo_loss"] = total_loss(sums[0], sums[1], CameraStatic(W, H), 0.2).numpy()
    out["halo_grad"] = p.grad.numpy()


def _loss(rank, world, out):
    from bags_tpu_torch.core.camera import CameraParams, CameraStatic
    from bags_tpu_torch.dist.mesh import all_reduce_sum, padded_height, row_block
    from bags_tpu_torch.dist.sharded import (halo_slab_loss, render_slab,
                                             total_loss)
    from bags_tpu_torch.model.gaussians import Gaussians
    from bags_tpu_torch.raster.render import RenderConfig

    t = loss_toy()
    rows = row_block(CAP, rank, world)
    g = Gaussians(**{f: torch.tensor(t[f][rows], requires_grad=True)
                     for f in G_FIELDS})
    cam = CameraParams(**{f: torch.tensor(t[f], requires_grad=f in
                                          ("dq", "dt", "fovx", "fovy"))
                          for f in CAM_FIELDS})
    static = CameraStatic(*LOSS_WH)
    probe = torch.zeros((CAP // world, 2), requires_grad=True)
    absp = torch.zeros((CAP // world, 2), requires_grad=True)
    r = render_slab(g, torch.ones(CAP // world, dtype=torch.bool), cam, static,
                    RenderConfig(sh_degree=1), torch.zeros(3), probe2d=probe,
                    abs_probe=absp)
    hp = padded_height(LOSS_WH[1], world)
    hl = hp // world
    gt = np.concatenate([t["gt"], np.zeros((3, hp - LOSS_WH[1], LOSS_WH[0]),
                                           np.float32)], 1)
    partial, l1, s = halo_slab_loss(r.slab, torch.tensor(
        gt[:, rank * hl:(rank + 1) * hl]), r.y0, LOSS_WH[1], 0.2)
    partial.backward()
    rep = [getattr(cam, f).grad for f in ("dq", "dt", "fovx", "fovy")]
    sums = torch.stack([l1, s])
    all_reduce_sum(rep + [sums])
    out["loss_loss"] = total_loss(sums[0], sums[1], static, 0.2).numpy()
    for f in G_FIELDS:
        out[f"loss_g_{f}"] = getattr(g, f).grad.numpy()
    for f in ("dq", "dt", "fovx", "fovy"):
        out[f"loss_cam_{f}"] = getattr(cam, f).grad.numpy()
    out["loss_probe"] = probe.grad.numpy()
    out["loss_absp"] = absp.grad.numpy()
    out["loss_slab"] = r.slab.detach().numpy()
    out["loss_radii"] = r.radii.numpy()
    with torch.no_grad():
        out["sorted_slab"] = render_slab(
            g, torch.ones(CAP // world, dtype=torch.bool), cam, static,
            RenderConfig(sh_degree=1, sort_by_distance=True),
            torch.zeros(3)).slab.numpy()


def _train(rank, world, out, mode):
    from bags_tpu_torch.dist.trainer import ShardedTrainer

    tr = train_toy(ShardedTrainer, mode)
    hist = tr.run(iterations=STEPS[mode], log_every=1)
    out[f"{mode}_losses"] = np.array([h[1] for h in hist])
    out[f"{mode}_alive"] = np.array([h[2] for h in hist])
    out[f"{mode}_checksum"] = replicated_checksum(tr)
    out[f"{mode}_log"] = np.array(tr.mcmc_log if mode == "mcmc"
                                  else tr.densify_log or [[0]])
    g, alive = tr.population()
    out[f"{mode}_xyz"] = g.xyz.numpy()
    out[f"{mode}_alive_mask"] = alive.numpy()
    out[f"{mode}_dq"] = tr.base.cams.dq.detach().numpy()
    out[f"{mode}_dt"] = tr.base.cams.dt.detach().numpy()
    if mode == "hybrid":
        out["hybrid_spec_w1"] = tr.base.spec.w1.detach().numpy()


def _ckpt(rank, world, out, ckpt_in, ckpt_out):
    from bags_tpu_torch.dist.trainer import ShardedTrainer

    tr = train_toy(ShardedTrainer, "plain")
    hist = tr.run(iterations=2, log_every=1)
    tr.save_checkpoint(ckpt_out)
    out["ckpt_save_losses"] = np.array([h[1] for h in hist])
    for name, path in (("ckpt_save", ckpt_out), ("ckpt_resume", ckpt_in)):
        tr = train_toy(ShardedTrainer, "plain")
        tr.load_checkpoint(path)
        out[f"{name}_step"] = np.array(tr.base.step)
        out[f"{name}_resumed"] = np.array(
            [h[1] for h in tr.run(iterations=1, log_every=1)])


def main(rank, world, store, out_dir, ckpt_in, ckpt_out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    # a rank whose peer died fails within a minute instead of gloo's 30
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    out = {}
    try:
        _halo(rank, world, out)
        _loss(rank, world, out)
        for mode in STEPS:
            _train(rank, world, out, mode)
        _ckpt(rank, world, out, ckpt_in, ckpt_out)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:7])
