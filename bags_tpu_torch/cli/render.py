"""Rendering CLI of the port: render the train/test views of a dataset from a
trained model, write `renders/` and `gt/` PNG trees and print each split's
PSNR. Port of the root `render.py`.

    python -m bags_tpu_torch.cli.render -m MODEL -s DATASET [--eval]

Loads the trained state: the full `chkpnt{it}.npz` checkpoint with its
`cfg.json` when present (the optimized train cameras and the global
alignment), else, or with `--ply_only`, the saved PLY with the dataset's
cameras. `--optim_test_pose_iter N` first optimizes each test camera's pose
(photometric, pose-only Adam) and saves / resumes `opt_test_cams.npz`. Runs
on `--device cuda` (the default) or `--device cpu`. A fisheye model
(`--outside_rasterizer`) is restored with its lens net, vignetting and
shift, and each view is rendered at the extended FoV and warped through
the lens against the fisheye GT (`fish/images`), as training evaluates.
A cubemap model (`--cubemap`) is restored with its cubemap net and renders
plain perspective views of its Gaussians, as the JAX render CLI does. A
hybrid model (`--hybrid`) is restored with its ASG features and specular
MLP, and its specular colour joins every view, plain, fisheye or cubemap.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

# Test-camera learning rates of the reference (scene/__init__.py:166-170).
TEST_POSE_LR = {"dq": 5e-4, "dt": 2.5e-3}


def save_png(path: str, img: torch.Tensor) -> None:
    """(3, H, W) float in [0, 1] -> 8-bit PNG (truncating, as the JAX CLI)."""
    from PIL import Image

    arr = (np.clip(img.detach().cpu().numpy(), 0, 1) * 255).astype("uint8")
    Image.fromarray(arr.transpose(1, 2, 0)).save(path)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--skip_test", action="store_true")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--resolution", "-r", type=int, default=-1)
    p.add_argument("--white_background", "-w", action="store_true")
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--max_instances", type=int, default=None,
                   help="instance budget per view; past it the farthest "
                        "whole Gaussians are dropped (default: no cap)")
    p.add_argument("--ply_only", action="store_true",
                   help="ignore checkpoints; render the saved PLY with the "
                        "dataset's cameras")
    p.add_argument("--optim_test_pose_iter", type=int, default=0,
                   help="test-time pose optimization iterations "
                        "(reference: 7000)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p.parse_args(argv)


def restore_trained(model_path: str, source_path: str, iteration: int,
                    device):
    """Rebuild the training-time Scene and trainer from `cfg.json` and
    restore `chkpnt{iteration}.npz` (the latest for -1) into its state (a
    fisheye model's lens or a cubemap model's net is not pre-fitted first:
    the checkpoint holds it).
    Returns (cfg, scene, state, it, trainer), `state` the TrainState, or
    None without a checkpoint."""
    from ..train.checkpoint import find_max_iteration
    from ..train.config import TrainConfig
    from .train import build_scene_and_trainer

    cfg_path = os.path.join(model_path, "cfg.json")
    it = iteration
    if it == -1:
        it = find_max_iteration(model_path, r"chkpnt(\d+)\.npz")
    ck = os.path.join(model_path, f"chkpnt{it}.npz")
    if not (os.path.exists(cfg_path) and os.path.exists(ck)):
        return None
    with open(cfg_path) as f:
        cfg = TrainConfig.from_json(f.read())
    cfg.model.source_path = source_path  # the data may have moved
    cfg.mesh = 0                         # a mesh checkpoint renders on one card
    cfg.calib.no_init_iresnet = True     # the checkpoint holds the lens
    scene, trainer = build_scene_and_trainer(cfg, device)
    trainer.close()
    trainer.load_checkpoint(ck, with_optimizer=False)
    print(f"restored the training state from {ck}")
    return cfg, scene, trainer.base, it, trainer


def optimize_test_poses(render_cam, cams, scene, iters: int):
    """Pose-only Adam on each test camera against its image; returns the
    cameras with the optimized dq / dt."""
    from ..train.losses import photometric_loss

    new = {"dq": [], "dt": []}
    for i in range(scene.n_test):
        cam = cams[i]
        leaves = {f: getattr(cam, f).detach().clone().requires_grad_(True)
                  for f in TEST_POSE_LR}
        opt = torch.optim.Adam(
            [{"params": [leaves[f]], "lr": lr} for f, lr in TEST_POSE_LR.items()],
            eps=1e-15)
        gt = scene.test_image(i)
        for _ in range(iters):
            opt.zero_grad()
            loss = photometric_loss(
                render_cam(dataclasses.replace(cam, **leaves)), gt)
            loss.backward()
            opt.step()
        for f in TEST_POSE_LR:
            new[f].append(leaves[f].detach())
    return dataclasses.replace(cams, dq=torch.stack(new["dq"]),
                               dt=torch.stack(new["dt"]))


def main(argv=None) -> dict:
    """Run the CLI; returns {split: {"psnr": [...], "dir": out_dir}}."""
    args = parse_args(argv)

    from ..data.scene import Scene
    from ..eval.metrics import psnr
    from ..model.gaussians import load_ply
    from ..raster.render import RenderConfig, render
    from ..train.checkpoint import find_max_iteration
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    trained = None if args.ply_only else restore_trained(
        args.model_path, args.source_path, args.iteration, device)
    fisheye_eval = spec = None
    if trained is not None:
        cfg_t, scene, state, it, trainer = trained
        g, alive, align = state.g, state.alive, state.align
        if state.spec is not None:       # detached: only the camera trains
            from ..calib.specular import SpecularParams
            spec = SpecularParams(*(t.detach() for t in
                                    state.spec.named_tensors().values()))
        if cfg_t.calib.outside_rasterizer and not cfg_t.calib.cubemap:
            from ..train.calibrated import (fisheye_eval_view,
                                            make_fisheye_eval_fn)
            fisheye_eval = make_fisheye_eval_fn(trainer, args.max_instances)
        train_cams = state.cams                 # the OPTIMIZED train cameras
        cfg = RenderConfig(sh_degree=cfg_t.model.sh_degree,
                           max_instances=args.max_instances)
        bg_value = 1.0 if cfg_t.model.white_background else 0.0
    else:
        it = args.iteration
        if it == -1:
            it = find_max_iteration(os.path.join(args.model_path, "point_cloud"))
        ply = os.path.join(args.model_path, "point_cloud", f"iteration_{it}",
                           "point_cloud.ply")
        g, alive = load_ply(ply, device=device)
        print(f"loaded {int(alive.sum())} Gaussians from {ply}")
        scene = Scene(args.source_path, eval_split=args.eval,
                      resolution=args.resolution,
                      white_background=args.white_background,
                      sh_degree=args.sh_degree, device=device)
        train_cams, align = scene.train_cams, None
        cfg = RenderConfig(sh_degree=args.sh_degree,
                           max_instances=args.max_instances)
        bg_value = 1.0 if args.white_background else 0.0
    bg = torch.full((3,), bg_value, device=device)
    with torch.no_grad():
        scaling, quats = g.scaling(), g.quats.detach()
        xyz, opacity, sh = g.xyz.detach(), g.opacity(alive), g.sh_coeffs()

    def render_cam(cam):
        extra = None
        if spec is not None:
            from ..calib.specular import specular_extra_color
            extra = specular_extra_color(spec, xyz, g.asg.detach(), cam, align)
        return render(xyz, scaling, quats, opacity, sh, cam, scene.static,
                      cfg, bg=bg, align=align, extra_color=extra)

    test_cams = scene.test_cams
    opt_cam_path = os.path.join(args.model_path, "opt_test_cams.npz")
    if args.optim_test_pose_iter > 0 and os.path.exists(opt_cam_path):
        saved = np.load(opt_cam_path)
        test_cams = dataclasses.replace(
            test_cams, dq=torch.as_tensor(saved["dq"], device=device),
            dt=torch.as_tensor(saved["dt"], device=device))
        print(f"loaded optimized test poses from {opt_cam_path}")
    elif args.optim_test_pose_iter > 0:
        print(f"test-time pose optimization ({args.optim_test_pose_iter} iters)")
        test_cams = optimize_test_poses(lambda c: render_cam(c).render,
                                        test_cams, scene,
                                        args.optim_test_pose_iter)
        np.savez(opt_cam_path, dq=test_cams.dq.cpu().numpy(),
                 dt=test_cams.dt.cpu().numpy())
        print(f"saved optimized test poses to {opt_cam_path}")

    jobs = []
    if not args.skip_test:
        jobs.append(("test", test_cams, scene.n_test, scene.test_image))
    if not args.skip_train:
        jobs.append(("train", train_cams, scene.n_train, scene.train_image))
    summary = {}
    with torch.no_grad():
        for split, cams, n, gt_fn in jobs:
            out_dir = os.path.join(args.model_path, split, f"ours_{it}")
            os.makedirs(os.path.join(out_dir, "renders"), exist_ok=True)
            os.makedirs(os.path.join(out_dir, "gt"), exist_ok=True)
            vals = []
            for i in range(n):
                if fisheye_eval is not None:
                    img, gt_img, n_dropped = fisheye_eval_view(
                        trainer, fisheye_eval, scene, split, cams, i)
                else:
                    out = render_cam(cams[i])
                    img = torch.clamp(out.render, 0.0, 1.0)
                    gt_img, n_dropped = gt_fn(i), out.n_dropped
                if n_dropped:
                    print(f"{split} view {i}: dropped {n_dropped} "
                          f"instances past --max_instances")
                vals.append(float(psnr(img, gt_img)))
                save_png(os.path.join(out_dir, "renders", f"{i:05d}.png"), img)
                save_png(os.path.join(out_dir, "gt", f"{i:05d}.png"), gt_img)
            print(f"wrote {n} {split} renders to {out_dir} "
                  f"(PSNR {float(np.mean(vals)):.3f})")
            summary[split] = {"psnr": vals, "dir": out_dir}
    return summary


if __name__ == "__main__":
    main()
