"""One rank of the 2-process gloo run of `tests/test_torch_dist_calib.py`
(JAX-free: the test spawns it with `subprocess` and imports the toys here
for its references, the JAX package's and the single-process port's).

    python tests/_torch_dist_calib_worker.py RANK WORLD STORE OUT CKPT_IN CKPT_OUT BLACK_GT

Joins the process group on the FileStore STORE (one torch thread), runs
every scenario in order and writes this rank's results to
OUT/rank{RANK}.npz, a key per scenario and value:
  fs10, fs15, gt, cube   one sharded step (`dist/calib.py`) from
            `step_toy(name)`'s state: the loss, this rank's block of the
            positions, the camera rows, the lens or cubemap net and its
            first moments, the replicated checksum, and the step's
            collectives (calls, bytes) by `mesh.KINDS`;
  fs15_black    last: the fs15 step on a black background against the GT
            in BLACK_GT (.npy; the test writes it once JAX's step has
            shown which pixels to zero, and the ranks wait for it), as
            fs15, and this rank's rows of the warped render;
  fisheye, apply2gt, cubemap, hybrid   `train_toy(ShardedCalibTrainer,
            mode)`: the losses, live counts, population, camera rows,
            lens or cubemap net, checksum;
  ckpt_save     2 steps of the fisheye toy and a checkpoint to CKPT_OUT
                (rank 0 writes), then a fresh trainer restores it and
                takes 1 step;
  ckpt_resume   a fresh trainer restores CKPT_IN (written by one process)
                and takes 1 step.
"""

import datetime
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

CAP, N_LIVE = 256, 100
PERSP = (48, 40)        # W, H: 3 tile rows, padded to 4 at 2 ranks
FISH = (48, 39)         # W, H: 39 fisheye rows, 20 a rank at 2 ranks
FOCAL, CUBE_FOCAL = 40.0, 24.0
# the one-step scenarios' background: grey, so that no rendered pixel is an
# exact zero (where the exact-zero validity mask could take either side)
BG = (0.25, 0.25, 0.25)
G_FIELDS = ("xyz", "sh_dc", "sh_rest", "scales_log", "quats", "opacity_raw")
CAM_FIELDS = ("q_init", "t_init", "dq", "dt", "fovx", "fovy")
# one-step scenarios: (flow scale, --apply2gt, vignetting and shift on)
STEP_TOYS = {"fs10": (1.0, False, False), "fs15": (1.5, False, True),
             "gt": (1.0, True, False), "cube": None}
# the fs15 step on black, where the exact-zero crop mask decides; its GT
# comes from the test
BLACK = "fs15_black"
STEPS = 3
BLACK_GT_WAIT = 150   # seconds
TRAIN_MODES = ("fisheye", "apply2gt", "cubemap", "hybrid")


def gaussians_np(cube: bool) -> dict:
    """N_LIVE Gaussians of `make_toy_scene` (SH 0) in CAP slots, the rest
    dead, as numpy: the fields and `alive`. The cubemap toy's (seed 11)
    surround its cameras (`utils/testing.cubemap_rig`)."""
    from bags_tpu_torch.utils.testing import make_toy_scene

    sc = make_toy_scene(n=N_LIVE, width=PERSP[0], height=PERSP[1], sh_degree=0,
                        seed=11 if cube else 5, device="cpu")
    op = sc["opacity"].numpy()
    live = dict(xyz=sc["xyz"].numpy(), sh_dc=sc["sh_coeffs"][:, :1].numpy(),
                sh_rest=sc["sh_coeffs"][:, 1:].numpy(),
                scales_log=np.log(sc["scales"].numpy()), quats=sc["quats"].numpy(),
                opacity_raw=np.log(op / (1 - op)))
    out = {}
    for k, v in live.items():
        full = np.zeros((CAP,) + v.shape[1:], np.float32)
        full[:N_LIVE] = v
        out[k] = full
    out["quats"][N_LIVE:, 0] = 1.0
    out["scales_log"][N_LIVE:] = -5.0
    out["opacity_raw"][N_LIVE:] = -5.0
    out["alive"] = np.arange(CAP) < N_LIVE
    return out


def cameras_np(cube: bool, n: int, fov) -> dict:
    """n camera rows as numpy fields: the cubemap rig, or the toy camera
    moved along x by 0.1 a camera; each at FoVs `fov` (x, y)."""
    from bags_tpu_torch.core.camera import CameraParams
    from bags_tpu_torch.utils.testing import cubemap_rig

    poses = (cubemap_rig(n) if cube else
             [(np.eye(3, dtype=np.float32), np.array([0.1 * i, 0, 0], np.float32))
              for i in range(n)])
    cams = CameraParams.stack([CameraParams.create(R, t, fov[0], fov[1],
                                                   device="cpu")
                               for R, t in poses])
    return {f: getattr(cams, f).numpy() for f in CAM_FIELDS}


def config(mode: str, flow_scale=1.0, vig_shift=False):
    """The port's TrainConfig of a toy: SH 0, pose and FoVs trained; "fisheye"
    / "apply2gt" / "hybrid" the fisheye mode (flow scale, control points
    every 8 pixels, the lens trained at lr 1e-6; with vig_shift the
    vignetting from the first step and the pupil shift), "cubemap" (mask
    radius 20, control points every 8 pixels, net lr 1e-6)."""
    from bags_tpu_torch.train.config import CalibConfig, TrainConfig

    cube = mode == "cubemap"
    cfg = TrainConfig(calib=CalibConfig(
        opt_cam=True, opt_intrinsic=True, iresnet_lr=1e-6,
        opt_distortion=not cube, outside_rasterizer=not cube, cubemap=cube,
        apply2gt=mode == "apply2gt", flow_scale=(flow_scale, flow_scale),
        control_point_sample_scale=8, mask_radius=20, banded_warp=False,
        no_init_iresnet=True, hybrid=mode == "hybrid", opt_shift=vig_shift,
        start_vignetting=0 if vig_shift else 10 ** 10))
    cfg.model.sh_degree = 0
    cfg.opt.opacity_reset_interval = 10 ** 9
    cfg.opt.densify_from_iter = 10 ** 9
    return cfg


def fisheye_setup(cfg):
    """(FisheyeSetup, control points) of a fisheye config at the toy sizes."""
    from bags_tpu_torch.train import calibrated as tcal

    c = cfg.calib
    setup = tcal.make_fisheye_setup(FOCAL, FOCAL, PERSP, FISH,
                                    flow_scale=c.flow_scale,
                                    control_point_sample_scale=8,
                                    apply2gt=c.apply2gt)
    return setup, tcal.fisheye_control_points(setup, FOCAL, FOCAL, c.flow_scale,
                                              device="cpu")


def cube_fov():
    w, h = PERSP
    return (2 * np.arctan(w / (2 * CUBE_FOCAL)), 2 * np.arctan(h / (2 * CUBE_FOCAL)))


def nets_np() -> dict:
    """The lens and cubemap nets (`utils/testing`'s narrow net), the
    vignetting at its init and a zero shift, as numpy."""
    from bags_tpu_torch.utils.testing import _narrow_net_np

    net = _narrow_net_np()
    return {"lens": net, "cubemap_net": net,
            "vig": {"a_k": np.full(4, 0.01, np.float32),
                    "beta_k": np.linspace(2, 8, 4).astype(np.float32)},
            "shift": np.zeros(3, np.float32)}


def step_toy(name: str) -> dict:
    """A one-step scenario as numpy: its config, Gaussians, two camera rows
    (the fisheye ones at the setup's extended FoVs), nets and a seeded GT
    (the fisheye GT, or the cubemap's perspective one), and for the
    cubemap the sub-camera poses of camera 0."""
    from bags_tpu_torch.core.camera import CameraParams
    from bags_tpu_torch.train.calibrated import sub_camera_poses

    cube = name == "cube"
    if cube:
        cfg = config("cubemap")
        fov = cube_fov()
    else:
        fs, a2g, vs = STEP_TOYS[name]
        cfg = config("apply2gt" if a2g else "fisheye", fs, vs)
        setup, _ = fisheye_setup(cfg)
        fov = (setup.fovx, setup.fovy)
    cams = cameras_np(cube, 2, fov)
    rng = np.random.default_rng(7)
    hw = (PERSP[1], PERSP[0]) if cube else (FISH[1], FISH[0])
    out = dict(cfg=cfg, g=gaussians_np(cube), cams=cams, nets=nets_np(),
               gt=rng.uniform(0, 1, (3,) + hw).astype(np.float32))
    if cube:
        q, t = sub_camera_poses(CameraParams(**{f: torch.tensor(v)
                                                for f, v in cams.items()}))
        out.update(sub_q=q[0].numpy(), sub_t=t[0].numpy())
    return out


def block_state(t: dict, rows: slice):
    """The port's CalibState of `t`'s Gaussian rows `rows` (spatial lr
    scale 2) and the schedules."""
    from bags_tpu_torch import convert
    from bags_tpu_torch.core.camera import CameraParams
    from bags_tpu_torch.model.gaussians import Gaussians
    from bags_tpu_torch.train.loop import init_train_state

    g = Gaussians(**{f: torch.tensor(t["g"][f][rows]) for f in G_FIELDS})
    cams = CameraParams(**{f: torch.tensor(v) for f, v in t["cams"].items()})
    base = init_train_state(g, torch.tensor(t["g"]["alive"][rows]), cams,
                            t["cfg"], 2.0)
    return convert.calib_state_from_numpy(base, t["cfg"], t["nets"], device="cpu")


def run_step(name: str, rows: slice, sharded: bool, black_gt=None):
    """One step of scenario `name` (STEP_TOYS or BLACK, whose fisheye GT is
    `black_gt`) on camera 0 from `block_state(rows)`: `dist/calib.py`'s
    step with `sharded`, else the single-device one. Returns (CalibState,
    StepMetrics)."""
    from bags_tpu_torch.dist import calib as dcal
    from bags_tpu_torch.raster.render import RenderConfig
    from bags_tpu_torch.train import calibrated as tcal

    black = name == BLACK
    t = step_toy("fs15" if black else name)
    cs, sched = block_state(t, rows)
    cfg, rcfg = t["cfg"], RenderConfig(sh_degree=0)
    bg = torch.zeros(3) if black else torch.tensor(BG)
    gt = torch.tensor(black_gt if black else t["gt"])
    if name == "cube":
        from bags_tpu_torch.core.camera import CameraStatic
        setup = tcal.make_cubemap_setup(CameraStatic(*PERSP), CUBE_FOCAL,
                                        CUBE_FOCAL, cfg)
        sub = (torch.tensor(t["sub_q"]), torch.tensor(t["sub_t"]))
        if sharded:
            from bags_tpu_torch.dist.mesh import padded_height, rank_world
            rank, d = rank_world()
            hl = padded_height(PERSP[1], d) // d
            gt = torch.nn.functional.pad(gt, (0, 0, 0, hl * d - PERSP[1]))[
                :, rank * hl:(rank + 1) * hl]
            m = dcal.sharded_cubemap_step(cs, gt, 0, bg, *sub, setup, rcfg,
                                          cfg, sched)
        else:
            m = tcal.cubemap_train_step(cs, gt, 0, bg, *sub, setup, rcfg, cfg,
                                        sched)
        return cs, m
    setup, p_view = fisheye_setup(cfg)
    vig = cfg.calib.start_vignetting == 0
    if sharded:
        m = dcal.sharded_fisheye_step(
            cs, dcal.fisheye_gt_rows(gt, cfg.calib.apply2gt), p_view, 0, bg,
            setup, rcfg, cfg, sched, True, vig)
    else:
        m = tcal.fisheye_train_step(cs, gt, p_view, 0, bg, setup, rcfg, cfg,
                                    sched, True, vig)
    return cs, m


def net_of(cs, cube: bool):
    return cs.cubemap_net if cube else cs.lens


def net_flat(net) -> np.ndarray:
    """The trained tensors of a lens or cubemap net, flattened in order."""
    return torch.cat([t.detach().reshape(-1) for t in
                      net.named_tensors(trained_only=True).values()]).numpy()


def moments_flat(cs, cube: bool) -> np.ndarray:
    mu = (cs.cubemap_opt if cube else cs.lens_opt).mu
    named = net_of(cs, cube).named_tensors(trained_only=True)
    return torch.cat([mu[k].reshape(-1) for k in named]).numpy()


def calib_checksum(cs) -> np.ndarray:
    """Sums of the state every rank must hold alike: the cameras and their
    Adam moments, every calibration tensor and moment, the specular MLP,
    the generator."""
    st = cs.base
    parts = [getattr(st.cams, f).sum() for f in CAM_FIELDS]
    parts += [m.sum() for m in list(st.cam_opt.mu.values())
              + list(st.cam_opt.nu.values())]
    for _, (named, opt) in cs.groups().items():
        parts += [t.sum() for t in named.values()]
        parts += [m.sum() for m in list(opt.mu.values()) + list(opt.nu.values())]
    if st.spec is not None:
        parts += [t.sum() for t in st.spec.named_tensors().values()]
    parts.append(st.gen.get_state().to(torch.float64).sum())
    return torch.stack([torch.as_tensor(p, dtype=torch.float64)
                        for p in parts]).detach().numpy()


def train_toy(cls, mode: str):
    """A calibrated trainer of class `cls` (CalibTrainer or
    ShardedCalibTrainer) on a 3-camera toy of `mode` (TRAIN_MODES: the
    fisheye toy at flow scale 1.5 with vignetting and shift, its
    `--apply2gt` at flow scale 1, the cubemap toy, the fisheye toy with
    `--hybrid`), densify at iteration 2 (threshold 1e-8), seeded GTs, seed
    3, the nets of `nets_np`."""
    from bags_tpu_torch import convert
    from bags_tpu_torch.core.camera import CameraParams, CameraStatic
    from bags_tpu_torch.model.gaussians import Gaussians
    from bags_tpu_torch.train.optim import adam_moments_init

    cube = mode == "cubemap"
    cfg = config(mode, 1.0 if mode == "apply2gt" else 1.5,
                 vig_shift=mode == "fisheye")
    cfg.opt.densify_from_iter, cfg.opt.densification_interval = 1, 2
    cfg.opt.densify_grad_threshold = 1e-8
    if cls.__name__.startswith("Sharded"):
        cfg.mesh = torch.distributed.get_world_size()
    fov = cube_fov() if cube else (0.8, 0.8)
    cams = CameraParams(**{f: torch.tensor(v) for f, v in
                           cameras_np(cube, 3, fov).items()})
    d = gaussians_np(cube)
    g = Gaussians(**{f: torch.tensor(d[f]) for f in G_FIELDS})
    rng = np.random.default_rng(9)
    gt = torch.tensor(rng.uniform(0, 1, (3, 3, PERSP[1], PERSP[0])).astype(np.float32))
    fish = torch.tensor(rng.uniform(0, 1, (3, 3, FISH[1], FISH[0])).astype(np.float32))
    focal = CUBE_FOCAL if cube else FOCAL
    tr = cls(g, torch.tensor(d["alive"]), cams, CameraStatic(*PERSP), cfg,
             scene_extent=2.0, gt_images=gt, focal_x=focal, focal_y=focal,
             persp_wh=PERSP, fish_wh=None if cube else FISH, seed=3,
             fish_images=None if cube else fish)
    name = "cubemap_net" if cube else "lens"
    net = convert.iresnet_from_numpy(nets_np()[name], "cpu")
    setattr(tr.state, name, net)
    setattr(tr.state, "cubemap_opt" if cube else "lens_opt",
            adam_moments_init(net.named_tensors(True)))
    return tr


def _step(rank, world, out, name, black_gt=None):
    from bags_tpu_torch.dist import mesh

    mesh.reset_counts()
    cs, m = run_step(name, mesh.row_block(CAP, rank, world), sharded=True,
                     black_gt=black_gt)
    out[f"{name}_counts"] = np.array([mesh.COUNTS[k] for k in mesh.KINDS])
    cube = name == "cube"
    out[f"{name}_loss"] = m.loss.numpy()
    out[f"{name}_xyz"] = cs.base.g.xyz.detach().numpy()
    for f in ("dq", "dt"):
        out[f"{name}_{f}"] = getattr(cs.base.cams, f).detach().numpy()
    out[f"{name}_net"] = net_flat(net_of(cs, cube))
    out[f"{name}_mu"] = moments_flat(cs, cube)
    out[f"{name}_checksum"] = calib_checksum(cs)
    if name == BLACK:
        out[f"{name}_image"] = m.image.numpy()


def _train(rank, world, out, mode):
    from bags_tpu_torch.dist.trainer import ShardedCalibTrainer

    tr = train_toy(ShardedCalibTrainer, mode)
    hist = tr.run(iterations=STEPS, log_every=1)
    out[f"{mode}_losses"] = np.array([h[1] for h in hist])
    out[f"{mode}_alive"] = np.array([h[2] for h in hist])
    out[f"{mode}_checksum"] = calib_checksum(tr.state)
    g, alive = tr.population()
    out[f"{mode}_xyz"] = g.xyz.numpy()
    out[f"{mode}_alive_mask"] = alive.numpy()
    out[f"{mode}_dq"] = tr.base.cams.dq.detach().numpy()
    out[f"{mode}_net"] = net_flat(net_of(tr.state, mode == "cubemap"))
    if mode == "hybrid":
        out["hybrid_spec_w1"] = tr.base.spec.w1.detach().numpy()


def _ckpt(rank, world, out, ckpt_in, ckpt_out):
    from bags_tpu_torch.dist.trainer import ShardedCalibTrainer

    tr = train_toy(ShardedCalibTrainer, "fisheye")
    hist = tr.run(iterations=2, log_every=1)
    tr.save_checkpoint(ckpt_out)
    out["ckpt_save_losses"] = np.array([h[1] for h in hist])
    for name, path in (("ckpt_save", ckpt_out), ("ckpt_resume", ckpt_in)):
        tr = train_toy(ShardedCalibTrainer, "fisheye")
        tr.load_checkpoint(path)
        out[f"{name}_step"] = np.array(tr.base.step)
        out[f"{name}_resumed"] = np.array(
            [h[1] for h in tr.run(iterations=1, log_every=1)])
        out[f"{name}_checksum"] = calib_checksum(tr.state)


def _wait_for(path: str) -> np.ndarray:
    """The array the test writes whole to `path`, once it is there."""
    deadline = time.monotonic() + BLACK_GT_WAIT
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {BLACK_GT_WAIT} s")
        time.sleep(0.05)
    return np.load(path)


def main(rank, world, store, out_dir, ckpt_in, ckpt_out, black_gt):
    import torch.distributed as dist

    torch.set_num_threads(1)
    # a rank whose peer died fails within a minute instead of gloo's 30
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    out = {}
    try:
        for name in STEP_TOYS:
            _step(rank, world, out, name)
        for mode in TRAIN_MODES:
            _train(rank, world, out, mode)
        _ckpt(rank, world, out, ckpt_in, ckpt_out)
        _step(rank, world, out, BLACK, _wait_for(black_gt))
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:8])
