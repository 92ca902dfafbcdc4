"""Rendering CLI of the port: render the train/test views of a dataset from a
saved PLY model, write `renders/` and `gt/` PNG trees and print each
split's PSNR. Port of the root `render.py`, its `--ply_only` path.

    python -m bags_tpu_torch.cli.render -m MODEL -s DATASET --ply_only [--eval]

Runs on `--device cuda` (the default) or `--device cpu`. Not ported yet
(slice 2 of the port): restoring a `chkpnt*.npz` training checkpoint with
its optimized cameras, the fisheye eval path, and test-time pose
optimization (`--optim_test_pose_iter > 0`).
"""

from __future__ import annotations

import argparse
import glob
import os
import re

import numpy as np
import torch


def save_png(path: str, img: torch.Tensor) -> None:
    """(3, H, W) float in [0, 1] -> 8-bit PNG (truncating, as the JAX CLI)."""
    from PIL import Image

    arr = (np.clip(img.detach().cpu().numpy(), 0, 1) * 255).astype("uint8")
    Image.fromarray(arr.transpose(1, 2, 0)).save(path)


def find_max_iteration(folder: str, pattern: str = r"iteration_(\d+)") -> int:
    its = [int(m.group(1)) for p in glob.glob(os.path.join(folder, "*"))
           if (m := re.search(pattern, os.path.basename(p)))]
    return max(its) if its else -1


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
                   help="render the saved PLY with the dataset's cameras")
    p.add_argument("--optim_test_pose_iter", type=int, default=0,
                   help="test-time pose optimization iterations (slice 2)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; returns {split: {"psnr": [...], "dir": out_dir}}."""
    args = parse_args(argv)

    from ..data.scene import Scene
    from ..eval.metrics import psnr
    from ..model.gaussians import load_ply
    from ..raster.render import RenderConfig, render
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    if args.optim_test_pose_iter > 0:
        raise NotImplementedError(
            "test-time pose optimization needs the compositing backward "
            "kernel: slice 2 of the port")

    it = args.iteration
    if it == -1:
        it = find_max_iteration(os.path.join(args.model_path, "point_cloud"))
    ply = os.path.join(args.model_path, "point_cloud", f"iteration_{it}",
                       "point_cloud.ply")
    if not args.ply_only and find_max_iteration(
            args.model_path, r"chkpnt(\d+)\.npz") >= 0:
        if not os.path.exists(ply):
            raise NotImplementedError(
                f"only a training checkpoint in {args.model_path}: checkpoint "
                "restore is not ported yet (slice 2); pass a PLY model")
        print("checkpoint restore is not ported yet (slice 2): rendering the "
              "saved PLY with the dataset's cameras, as --ply_only")
    g, alive = load_ply(ply, device=device)
    print(f"loaded {int(alive.sum())} Gaussians from {ply}")
    scene = Scene(args.source_path, eval_split=args.eval,
                  resolution=args.resolution,
                  white_background=args.white_background,
                  sh_degree=args.sh_degree, device=device)
    static = scene.static
    cfg = RenderConfig(sh_degree=args.sh_degree,
                       max_instances=args.max_instances)
    bg = torch.full((3,), 1.0 if args.white_background else 0.0, device=device)
    scaling, quats = g.scaling(), g.quats
    opacity, sh = g.opacity(alive), g.sh_coeffs()

    jobs = []
    if not args.skip_test:
        jobs.append(("test", scene.test_cams, scene.n_test, scene.test_image))
    if not args.skip_train:
        jobs.append(("train", scene.train_cams, scene.n_train,
                     scene.train_image))
    summary = {}
    with torch.no_grad():
        for split, cams, n, gt_fn in jobs:
            out_dir = os.path.join(args.model_path, split, f"ours_{it}")
            os.makedirs(os.path.join(out_dir, "renders"), exist_ok=True)
            os.makedirs(os.path.join(out_dir, "gt"), exist_ok=True)
            vals = []
            for i in range(n):
                out = render(g.xyz, scaling, quats, opacity, sh, cams[i],
                             static, cfg, bg=bg)
                if out.n_dropped:
                    print(f"{split} view {i}: dropped {out.n_dropped} "
                          f"instances past --max_instances")
                img = torch.clamp(out.render, 0.0, 1.0)
                gt_img = gt_fn(i)
                vals.append(float(psnr(img, gt_img)))
                save_png(os.path.join(out_dir, "renders", f"{i:05d}.png"), img)
                save_png(os.path.join(out_dir, "gt", f"{i:05d}.png"), gt_img)
            print(f"wrote {n} {split} renders to {out_dir} "
                  f"(PSNR {float(np.mean(vals)):.3f})")
            summary[split] = {"psnr": vals, "dir": out_dir}
    return summary


if __name__ == "__main__":
    main()
