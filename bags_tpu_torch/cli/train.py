"""Training CLI of the port: single-device 3DGS training that also optimises
the camera poses. Port of the root `train.py`, with its flags and presets.

    python -m bags_tpu_torch.cli.train -s DATASET -m MODEL --preset pose_noise

Writes `cfg.json`, `point_cloud/iteration_{it}/point_cloud.ply` at
`--save_iterations`, `chkpnt{it}.npz` at `--checkpoint_iterations`,
`metrics.jsonl` every 10 iterations and `evaluation_results.txt` at
`--test_iterations` (the test split and the first 5 train views: L1, PSNR,
SSIM and LPIPS (alex backbone, from local weights: `BAGS_TPU_LPIPS_WEIGHTS`;
"n/a" without them), and with `--opt_cam` the pose error and the
`poses_{it}.png` frusta plot). `--start_checkpoint` resumes. Runs on
`--device cuda` (the default) or `--device cpu`.

`--outside_rasterizer` (`--preset fisheye`) trains the fisheye mode
(`train/calibrated.py::CalibTrainer`): the render at the extended FoV
warped through the iResNet lens net against the `fish/images` GT, the lens
pre-fitted to the COLMAP coefficients of `fish/sparse/0` first (5,000
Adam steps, as in the JAX package; its time is printed), and its
evaluation warps through the lens. `--cubemap` (`--preset cubemap`) trains
the cubemap mode for fields of view past 180 degrees: five renders a step
(the camera and its +-90 degree sub-cameras, sorted by distance) warped
through the cubemap net against the circular-masked `images/` GT, the net
pre-fitted first unless `--no_init_iresnet` (the preset sets it); its
evaluation stitches the five faces. `--mcmc` (`--preset fisheye_mcmc`)
replaces densification by MCMC relocation and growth at the densification
interval and position noise every step; `--hybrid` adds the ASG specular
colour to every mode's render (the plain evaluation leaves it out, as the
JAX CLI does; the fisheye and cubemap evaluations include it). `--gui`
serves the SIBR network viewer on `--ip`:`--port` (polled every
iteration, frames rendered from the current state at the viewer's
camera); `--vis_pose` pushes the pose frusta to a visdom server every
`VIS_POSE_EVERY` iterations. `--batch_cams K` trains on K distinct
views a step (the pose and fisheye modes; the cubemap mode refuses it, as
in the JAX package).

`--mesh N` trains tile-parallel over N ranks of `torch.distributed`
(`dist/trainer.py`: `ShardedTrainer` in the pose mode, `ShardedCalibTrainer`
in the fisheye and cubemap modes, with or without `--hybrid` and
`--mcmc`): one process per rank,

    torchrun --nproc_per_node N -m bags_tpu_torch.cli.train ... --mesh N

on N cards (NCCL), or a world of one started by the CLI itself without
torchrun for `--mesh 1`; with `--device cpu` the ranks use gloo. Only rank
0 writes the logs, PNGs, PLYs and checkpoints (one file, as a single
device writes it; `--start_checkpoint` takes one from any process count).
"""

from __future__ import annotations

import argparse
import builtins
import json
import os
import sys
import time

import numpy as np
import torch

# iterations between two pose plots pushed to the visdom server (the
# reference's cadence, train.py:344-346)
VIS_POSE_EVERY = 500


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # ModelParams
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--model_path", "-m", default="output/run")
    p.add_argument("--images", "-i", default="images")
    p.add_argument("--resolution", "-r", type=int, default=-1)
    p.add_argument("--white_background", "-w", action="store_true")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--cap_max", type=int, default=-1)
    p.add_argument("--init_type", default="sfm")
    p.add_argument("--num_init_points", type=int, default=100_000)
    # OptimizationParams
    p.add_argument("--iterations", type=int, default=30_000)
    p.add_argument("--position_lr_init", type=float, default=0.00016)
    p.add_argument("--position_lr_final", type=float, default=0.0000016)
    p.add_argument("--feature_lr", type=float, default=0.0025)
    p.add_argument("--opacity_lr", type=float, default=0.05)
    p.add_argument("--scaling_lr", type=float, default=0.005)
    p.add_argument("--rotation_lr", type=float, default=0.001)
    p.add_argument("--percent_dense", type=float, default=0.01)
    p.add_argument("--lambda_dssim", type=float, default=0.2)
    p.add_argument("--densification_interval", type=int, default=100)
    p.add_argument("--opacity_reset_interval", type=int, default=3000)
    p.add_argument("--densify_from_iter", type=int, default=500)
    p.add_argument("--densify_until_iter", type=int, default=15_000)
    p.add_argument("--densify_grad_threshold", type=float, default=0.0002)
    p.add_argument("--abs_densify_grad_threshold", type=float, default=0.0004)
    p.add_argument("--batch_cams", type=int, default=1,
                   help="training views per iteration (distinct cameras)")
    # calibration / pose flags
    p.add_argument("--opt_cam", action="store_true")
    p.add_argument("--opt_intrinsic", action="store_true")
    p.add_argument("--r_t_lr", nargs="+", type=float, default=[0.01, 0.01])
    p.add_argument("--r_t_noise", nargs="+", type=float, default=[0.0, 0.0, 1.0])
    p.add_argument("--global_alignment_lr", type=float, default=0.01)
    p.add_argument("--opt_global_alignment", action="store_true")
    p.add_argument("--opt_distortion", action="store_true")
    p.add_argument("--outside_rasterizer", action="store_true")
    p.add_argument("--apply2gt", action="store_true")
    p.add_argument("--flow_scale", nargs="+", type=float, default=[1.0, 1.0])
    p.add_argument("--render_resolution", type=float, default=1.0)
    p.add_argument("--control_point_sample_scale", type=float, default=8.0)
    p.add_argument("--iresnet_lr", type=float, default=1e-7)
    p.add_argument("--iresnet_opt_duration", nargs="+", type=int,
                   default=[0, 30000])
    p.add_argument("--no_init_iresnet", action="store_true")
    p.add_argument("--no_distortion_mask", action="store_true")
    p.add_argument("--start_vignetting", type=int, default=10_000_000_000)
    p.add_argument("--opt_shift", action="store_true")
    p.add_argument("--cubemap", action="store_true")
    p.add_argument("--mask_radius", type=int, default=512)
    p.add_argument("--abs_grad", action="store_true")
    p.add_argument("--opacity_threshold", type=float, default=0.005)
    p.add_argument("--mcmc", action="store_true")
    p.add_argument("--hybrid", action="store_true")
    p.add_argument("--random_init_pc", action="store_true")
    # cadence
    p.add_argument("--test_iterations", nargs="+", type=int,
                   default=[7000, 30000])
    p.add_argument("--save_iterations", nargs="+", type=int,
                   default=[7000, 30000])
    p.add_argument("--checkpoint_iterations", nargs="+", type=int,
                   default=[7000, 15000, 30000])
    p.add_argument("--start_checkpoint", default=None)
    p.add_argument("--seed", type=int, default=0)
    port_note = ("accepted so that JAX command lines run unchanged: the port "
                 "always composites in float32 with no instance budget")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "pallas", "jnp"], help=port_note)
    p.add_argument("--precision", default="fast",
                   choices=["fast", "exact"], help=port_note)
    p.add_argument("--max_instances", type=int, default=0, help=port_note)
    p.add_argument("--mesh", type=int, default=0,
                   help="train tile-parallel over N torch.distributed ranks "
                        "(dist/trainer.py); 0 = single-device")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--preset", default=None,
                   help="named hyperparameter preset (train/presets.py)")
    p.add_argument("--gui", action="store_true")
    p.add_argument("--ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=6009)
    p.add_argument("--vis_pose", action="store_true")
    p.add_argument("--visdom_server", default="localhost")
    p.add_argument("--visdom_port", type=int, default=8600)
    p.add_argument("--wandb_project_name", default=None,
                   help="the wandb mirror is not ported; metrics.jsonl is "
                        "always written")
    p.add_argument("--wandb_group_name", default=None)
    p.add_argument("--wandb_mode", default="online")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def args_to_config(args):
    from ..train.config import (CalibConfig, ModelConfig, OptimizationConfig,
                                TrainConfig)

    return TrainConfig(
        model=ModelConfig(
            sh_degree=args.sh_degree, source_path=args.source_path,
            model_path=args.model_path, images=args.images,
            resolution=args.resolution,
            white_background=args.white_background, eval=args.eval,
            cap_max=args.cap_max, init_type=args.init_type,
            num_init_points=args.num_init_points),
        opt=OptimizationConfig(
            iterations=args.iterations,
            position_lr_init=args.position_lr_init,
            position_lr_final=args.position_lr_final,
            feature_lr=args.feature_lr, opacity_lr=args.opacity_lr,
            scaling_lr=args.scaling_lr, rotation_lr=args.rotation_lr,
            percent_dense=args.percent_dense,
            lambda_dssim=args.lambda_dssim,
            densification_interval=args.densification_interval,
            opacity_reset_interval=args.opacity_reset_interval,
            densify_from_iter=args.densify_from_iter,
            densify_until_iter=args.densify_until_iter,
            densify_grad_threshold=args.densify_grad_threshold,
            abs_densify_grad_threshold=args.abs_densify_grad_threshold,
            batch_cams=args.batch_cams),
        calib=CalibConfig(
            opt_cam=args.opt_cam, opt_intrinsic=args.opt_intrinsic,
            r_t_lr=tuple(args.r_t_lr[:2]),
            r_t_noise=tuple(args.r_t_noise),
            global_alignment_lr=args.global_alignment_lr,
            opt_global_alignment=args.opt_global_alignment,
            opt_distortion=args.opt_distortion,
            outside_rasterizer=args.outside_rasterizer,
            apply2gt=args.apply2gt, flow_scale=tuple(args.flow_scale),
            render_resolution=args.render_resolution,
            control_point_sample_scale=args.control_point_sample_scale,
            iresnet_lr=args.iresnet_lr,
            iresnet_opt_duration=tuple(args.iresnet_opt_duration),
            no_init_iresnet=args.no_init_iresnet,
            no_distortion_mask=args.no_distortion_mask,
            start_vignetting=args.start_vignetting,
            opt_shift=args.opt_shift, cubemap=args.cubemap,
            mask_radius=args.mask_radius, hybrid=args.hybrid),
        abs_grad=args.abs_grad, opacity_threshold=args.opacity_threshold,
        mcmc=args.mcmc, random_init_pc=args.random_init_pc,
        test_iterations=tuple(args.test_iterations),
        save_iterations=tuple(args.save_iterations),
        checkpoint_iterations=tuple(args.checkpoint_iterations),
        max_instances=args.max_instances, seed=args.seed,
        mesh=args.mesh, precision=args.precision,
    )


def build_scene_and_trainer(cfg, device):
    """The Scene and Trainer exactly as training builds them from a
    (possibly cfg.json-restored) TrainConfig; the render CLI rebuilds its
    checkpoint template with it. `--outside_rasterizer` or `--cubemap`
    gives a CalibTrainer, a fisheye one's fisheye size read from the first
    training view's `fish/images` pair; `--mesh N` a ShardedTrainer or
    ShardedCalibTrainer over the process group
    (`dist/trainer.init_distributed` first)."""
    from ..data.scene import Scene
    from ..dist.trainer import ShardedCalibTrainer, ShardedTrainer
    from ..raster.render import RenderConfig
    from ..train.calibrated import CalibTrainer
    from ..train.loop import Trainer

    scene = Scene(cfg.model.source_path, eval_split=cfg.model.eval,
                  resolution=cfg.model.resolution,
                  r_t_noise=tuple(cfg.calib.r_t_noise),
                  white_background=cfg.model.white_background,
                  capacity=cfg.model.cap_max if cfg.model.cap_max > 0 else None,
                  sh_degree=cfg.model.sh_degree, images_dir=cfg.model.images,
                  init_type=("random" if cfg.random_init_pc
                             else cfg.model.init_type),
                  num_pts=cfg.model.num_init_points, device=device)
    rcfg = RenderConfig(sh_degree=cfg.model.sh_degree)
    if not (cfg.calib.outside_rasterizer or cfg.calib.cubemap):
        return scene, (ShardedTrainer if cfg.mesh > 0 else Trainer)(
            scene.gaussians, scene.alive, scene.train_cams, scene.static, cfg,
            scene_extent=scene.cameras_extent, gt_images=scene.train_image,
            rcfg=rcfg, seed=cfg.seed)
    info0 = scene.train_infos[0]
    fish_wh = (scene.static.width, scene.static.height)
    if info0.fish_image_path:
        from PIL import Image
        with Image.open(info0.fish_image_path) as im:
            fish_wh = im.size
    return scene, (ShardedCalibTrainer if cfg.mesh > 0 else CalibTrainer)(
        scene.gaussians, scene.alive, scene.train_cams, scene.static, cfg,
        scene_extent=scene.cameras_extent, gt_images=scene.train_image,
        focal_x=info0.focal_x, focal_y=info0.focal_y,
        persp_wh=(scene.static.width, scene.static.height), fish_wh=fish_wh,
        source_path=cfg.model.source_path, rcfg=rcfg, seed=cfg.seed,
        fish_images=scene.fish_image if info0.fish_image_path else None)


@torch.no_grad()
def viewer_render(trainer, req: dict, population=None) -> torch.Tensor:
    """The network viewer's frame (3, H, W): the trainer's current state
    rendered at the request's camera and size, at the active SH degree,
    with the trainer's background and the global alignment. population:
    (Gaussians, alive), by default `trainer.population()`."""
    from ..eval.network_gui import request_to_camera
    from ..raster.render import RenderConfig, render

    st = trainer.base
    g, alive = population or trainer.population()
    cam, static = request_to_camera(req, g.xyz.device)
    return render(g.xyz, g.scaling(), g.quats, g.opacity(alive),
                  g.sh_coeffs(), cam, static,
                  RenderConfig(sh_degree=trainer.active_sh_degree),
                  bg=trainer.bg, align=st.align).render


def main(argv=None) -> dict:
    """Run the CLI. Returns {"losses": [...] and "step_s": [...] (host
    seconds of the iteration, its evaluation and saving left out) per
    iteration, "densify": [(it, cloned, split, pruned, alive_before,
    alive_after)], "mcmc": [(it, relocated, added, alive_before,
    alive_after)], "eval": the evaluation lines, "eval_renders": the views
    evaluation rendered, "model_path": ..., "lens_prefit_s": the fisheye
    lens pre-fit's or the cubemap net's pre-fit's seconds, or None}."""
    from ..train.presets import apply_preset

    argv = apply_preset(list(argv if argv is not None else sys.argv[1:]))
    args = build_parser().parse_args(argv)
    if args.wandb_project_name is not None:
        print("the wandb mirror is not ported: metrics go to metrics.jsonl")
    cfg = args_to_config(args)

    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    if cfg.mesh == 0:
        return _train(args, cfg, device, lead=True)
    import torch.distributed as dist

    from ..dist.trainer import init_distributed

    device, started = init_distributed(device, cfg.mesh)
    try:
        return _train(args, cfg, device, lead=dist.get_rank() == 0)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, cfg, device, lead: bool) -> dict:
    """The CLI's training on `device`; only the `lead` rank prints and
    writes files (every rank takes part in the gathers and checkpoints)."""
    from ..eval.metrics import Lpips, psnr
    from ..eval.pose_eval import align_and_pose_error
    from ..model.gaussians import save_ply
    from ..raster.render import RenderConfig, render
    from ..train.losses import ssim
    from ..utils.logging import MetricsLogger
    from .render import save_png

    print = builtins.print if lead else (lambda *a, **k: None)
    if lead:
        os.makedirs(args.model_path, exist_ok=True)
        with open(os.path.join(args.model_path, "cfg.json"), "w") as f:
            f.write(cfg.to_json())

    scene, trainer = build_scene_and_trainer(cfg, device)
    mesh = f", {cfg.mesh} ranks" if cfg.mesh else ""
    print(f"scene: {scene.n_train} train / {scene.n_test} test cameras, "
          f"extent {scene.cameras_extent:.3f}, capacity "
          f"{scene.gaussians.xyz.shape[0]}, alive {trainer.n_alive()}, "
          f"size {scene.static.width}x{scene.static.height}, device "
          f"{device}{mesh}")
    fisheye_eval = cubemap_eval = None
    if cfg.calib.cubemap:
        from ..train.calibrated import cubemap_eval_view, make_cubemap_eval_fn
        cubemap_eval = make_cubemap_eval_fn(trainer)
        print(f"cubemap: five faces at {scene.static.width}x"
              f"{scene.static.height}, focal {trainer.focal}, mask radius "
              f"{cfg.calib.mask_radius}, control grid every "
              f"{trainer.setup.scale} pixels")
    elif cfg.calib.outside_rasterizer:
        from ..train.calibrated import fisheye_eval_view, make_fisheye_eval_fn
        fisheye_eval = make_fisheye_eval_fn(trainer)
        st = trainer.setup
        print(f"fisheye: render {st.render_static.width}x"
              f"{st.render_static.height} at FoV {st.fovx:.4f} x "
              f"{st.fovy:.4f}, control grid {st.grid_hw}, flow {st.flow_hw}, "
              f"fisheye GT {st.fish_hw}")
    if args.start_checkpoint:
        trainer.load_checkpoint(args.start_checkpoint)
        print(f"resumed from {args.start_checkpoint} at step "
              f"{trainer.base.step}")

    # in-loop LPIPS on the alex backbone, as the reference's
    # (lpipsPyTorch/__init__.py:8); the metrics CLI takes vgg
    lpips_fn = Lpips(net="alex").to(device)
    logger = MetricsLogger(args.model_path) if lead else None
    eval_file = os.path.join(args.model_path, "evaluation_results.txt")
    summary = {"losses": [], "step_s": [], "densify": trainer.densify_log,
               "mcmc": trainer.mcmc_log, "eval": [], "eval_renders": 0, "model_path": args.model_path,
               "lens_prefit_s": getattr(trainer, "prefit_s", None)}

    def eval_view(split, cams, i, population):
        """(image, gt) of view i of a split, clipped / masked for metrics."""
        if fisheye_eval is not None:
            img, gt, _ = fisheye_eval_view(trainer, fisheye_eval, scene,
                                           split, cams, i, population)
            return img, gt
        if cubemap_eval is not None:
            img, gt, _ = cubemap_eval_view(trainer, cubemap_eval, scene,
                                           split, cams, i, population)
            return img, gt
        g, alive = population
        # no specular colour here, as in the JAX train CLI (train.py:361-366)
        out = render(g.xyz, g.scaling(), g.quats, g.opacity(alive),
                     g.sh_coeffs(), cams[i], scene.static,
                     RenderConfig(sh_degree=trainer.active_sh_degree),
                     bg=trainer.bg, align=trainer.base.align)
        gt_fn = scene.test_image if split == "test" else scene.train_image
        return torch.clamp(out.render, 0.0, 1.0), gt_fn(i)

    @torch.no_grad()
    def evaluate(it):
        st = trainer.base
        population = trainer.population()        # a gather under a mesh
        if not lead:
            return
        lines, img = [], None
        for split, cams, n in (("test", scene.test_cams, scene.n_test),
                               ("train", st.cams, min(5, scene.n_train))):
            l1s, psnrs, ssims, lpipss = [], [], [], []
            for i in range(n):
                img, gt_img = eval_view(split, cams, i, population)
                summary["eval_renders"] += 1
                l1s.append(float(torch.mean(torch.abs(img - gt_img))))
                psnrs.append(float(psnr(img, gt_img)))
                ssims.append(float(ssim(img, gt_img)))
                if lpips_fn.available:
                    lpipss.append(float(lpips_fn(img, gt_img)))
            if l1s:
                lp = f"{np.mean(lpipss):.5f}" if lpipss else "n/a"
                lines.append(f"[ITER {it}] Evaluating {split}: "
                             f"L1 {np.mean(l1s):.5f} PSNR {np.mean(psnrs):.3f} "
                             f"SSIM {np.mean(ssims):.5f} LPIPS {lp}")
        if img is not None:
            save_png(os.path.join(args.model_path, f"render_{it}.png"), img)
        if args.opt_cam:
            _, err = align_and_pose_error(st.cams, scene.train_cams_clean)
            lines.append(f"[ITER {it}] pose error: "
                         f"rot {err['rotation_deg_mean']:.4f} deg, "
                         f"trans {err['translation_mean']:.5f}")
            # the pose frusta, the reference's in-training pose plots
            try:
                from ..eval.vis import plot_poses
                plot_poses(st.cams, scene.train_cams_clean,
                           path=os.path.join(args.model_path,
                                             f"poses_{it}.png"))
            except ImportError as e:
                print(f"poses_{it}.png not written: {e}")
        for line in lines:
            print(line)
        with open(eval_file, "a") as f:
            f.write("\n".join(lines) + "\n")
        summary["eval"].extend(lines)

    gui = vis_client = None
    if args.gui and lead:
        from ..eval.network_gui import NetworkGUI
        try:
            gui = NetworkGUI(args.ip, args.port)
            print(f"network GUI listening on {args.ip}:{args.port}")
        except OSError as e:          # the address is taken, as in JAX's CLI
            print(f"network GUI unavailable ({e}); continuing without")

    if args.vis_pose and lead:
        from ..eval.vis import VisdomClient
        vis_client = VisdomClient(args.visdom_server, args.visdom_port)

    last = [time.perf_counter()]

    def callback(it, state, metrics):
        summary["losses"].append(float(metrics.loss))   # waits for the step
        now = time.perf_counter()
        summary["step_s"].append(now - last[0])
        if args.gui:
            # under a mesh every rank gathers the population, rank 0 serves
            population = trainer.population()
            if gui is not None:
                gui.poll(lambda req: viewer_render(trainer, req, population),
                         args.source_path, training_done=it >= args.iterations)
        if vis_client is not None and it % VIS_POSE_EVERY == 0:
            # live pose frusta to the visdom server (train.py:344-346)
            if not vis_client.plot_cameras(it, trainer.base.cams,
                                           scene.train_cams_clean) \
                    and it == VIS_POSE_EVERY:
                print(f"visdom server {vis_client.url} unreachable; live "
                      "pose plots disabled for this run")
        if logger is not None and it % 10 == 0:
            logger.log(it, loss=metrics.loss, l1=metrics.l1,
                       n_alive=metrics.n_alive, n_dropped=metrics.n_dropped)
        if not args.quiet and it % 200 == 0:
            print(f"iter {it}: loss {summary['losses'][-1]:.5f}, "
                  f"alive {int(metrics.n_alive)}", flush=True)
        if it in cfg.test_iterations:
            evaluate(it)
        if it in cfg.save_iterations:
            g, alive = trainer.population()
            if lead:
                ply_dir = os.path.join(args.model_path, "point_cloud",
                                       f"iteration_{it}")
                os.makedirs(ply_dir, exist_ok=True)
                save_ply(os.path.join(ply_dir, "point_cloud.ply"), g, alive)
        if it in cfg.checkpoint_iterations:
            trainer.save_checkpoint(
                os.path.join(args.model_path, f"chkpnt{it}.npz"))
        last[0] = time.perf_counter()

    try:
        trainer.run(iterations=args.iterations, callback=callback)
    finally:
        trainer.close()
        if logger is not None:
            logger.close()
        if gui is not None:
            gui.close()
    for it, cloned, split, pruned, before, after in trainer.densify_log:
        print(f"[ITER {it}] densify: cloned {cloned}, split {split}, pruned "
              f"{pruned}, alive {before} -> {after}")
    for it, relocated, added, before, after in trainer.mcmc_log:
        print(f"[ITER {it}] mcmc: relocated {relocated}, added {added}, "
              f"alive {before} -> {after}")
    print("\nTraining complete.")
    return summary


if __name__ == "__main__":
    main()
