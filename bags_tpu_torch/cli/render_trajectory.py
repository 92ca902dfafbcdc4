"""Trajectory-rendering CLI of the port: novel-view video frames from a
trained model. Port of the root `render_trajectory.py`.

    python -m bags_tpu_torch.cli.render_trajectory -m MODEL -s DATASET \
        [--mode spiral|orbit|wander|sequential] [--n_frames N] [--gif]

Writes numbered PNG frames (and `trajectory.gif` with `--gif`) to `--out`,
by default `MODEL/trajectory_{mode}_{it}`. Like the render CLI it restores
the full `chkpnt{it}.npz` when there is one (`cli/render.restore_trained`):
the paths anchor on the optimised training cameras, and the specular colour
and the global alignment apply. A fisheye model renders each frame at the
extended FoV and warps it through the trained lens to the fisheye sensor
size. `--ply_only` renders the saved PLY around the dataset's cameras.
`--panorama_fov F` renders five 90-degree cubemap faces per pose and
resamples them into a perspective view of F degrees. Runs on `--device
cuda` (the default) or `--device cpu`; `--backend` is accepted and ignored,
as in the render CLI.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--mode", choices=["spiral", "orbit", "sequential", "wander"],
                   default="spiral")
    p.add_argument("--n_frames", type=int, default=120)
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--backend", default="auto",
                   help="accepted so that JAX command lines run unchanged")
    p.add_argument("--max_instances", type=int, default=None,
                   help="instance budget per view; past it the farthest "
                        "whole Gaussians are dropped (default: no cap)")
    p.add_argument("--white_background", "-w", action="store_true")
    p.add_argument("--gif", action="store_true")
    p.add_argument("--ply_only", action="store_true",
                   help="ignore checkpoints; render the saved PLY around the "
                        "dataset's cameras")
    p.add_argument("--panorama_fov", type=float, default=0.0,
                   help="render 5 cubemap faces per pose and resample them "
                        "into a perspective view of this FoV (degrees)")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None, trained=None) -> dict:
    """Run the CLI. `trained`, if given, is `cli/render.restore_trained`'s
    result for this model and dataset, rendered from without restoring it
    again (several runs on one model). Returns {"dir": out_dir, "frames":
    n, "finite": whether every frame was finite before its clip,
    "lens_warp", "specular": whether the frames went through the lens warp
    and had the specular colour, "render_s": [...], "png_s": [...]}: per
    frame, the seconds of its render with the copy to the host, and of its
    PNG write."""
    args = parse_args(argv)

    from PIL import Image

    from ..core.camera import pose_w2c
    from ..data.scene import Scene
    from ..eval import trajectory
    from ..model.gaussians import load_ply
    from ..raster.render import RenderConfig, render
    from ..train.checkpoint import find_max_iteration
    from ..utils.device import resolve_device
    from .render import restore_trained

    device = resolve_device(args.device)
    if args.ply_only:
        trained = None
    elif trained is None:
        trained = restore_trained(args.model_path, args.source_path,
                                  args.iteration, device)
    align = spec = warp_frame = None
    if trained is not None:
        cfg_t, scene, state, it, trainer = trained
        g, alive, align = state.g, state.alive, state.align
        spec = state.spec
        anchor_cams = state.cams                # the OPTIMIZED cameras
        static = scene.static
        sh_degree = cfg_t.model.sh_degree
        white = cfg_t.model.white_background
        path_fovx = float(torch.mean(anchor_cams.fovx))
        path_fovy = float(torch.mean(anchor_cams.fovy))
        calib = cfg_t.calib
        if calib.outside_rasterizer and not calib.cubemap and not calib.apply2gt:
            # a fisheye model: render at the extended FoV, then warp each
            # frame through the trained lens into the fisheye sensor
            from ..calib.distortion import apply_distortion
            from ..train.calibrated import _proj_scale

            setup = trainer.setup
            static = setup.render_static
            path_fovx, path_fovy = setup.fovx, setup.fovy

            def warp_frame(img, cam):
                return apply_distortion(
                    trainer.state.lens, trainer.p_view, setup.grid_hw, img,
                    _proj_scale(cam), setup.flow_hw, final_hw=setup.fish_hw,
                    apply2gt=False)[0]
    else:
        it = args.iteration
        if it == -1:
            it = find_max_iteration(os.path.join(args.model_path, "point_cloud"))
        g, alive = load_ply(os.path.join(args.model_path, "point_cloud",
                                         f"iteration_{it}", "point_cloud.ply"),
                            device=device)
        scene = Scene(args.source_path, white_background=args.white_background,
                      sh_degree=args.sh_degree, device=device)
        anchor_cams = scene.train_cams
        static = scene.static
        sh_degree = args.sh_degree
        white = args.white_background
        path_fovx = float(anchor_cams.fovx[0])
        path_fovy = float(anchor_cams.fovy[0])
    cfg = RenderConfig(sh_degree=sh_degree, max_instances=args.max_instances)
    bg = torch.full((3,), 1.0 if white else 0.0, device=device)

    R, t = (x.detach().cpu().numpy() for x in pose_w2c(anchor_cams))
    c2ws = np.zeros((len(R), 4, 4))
    c2ws[:, :3, :3] = np.transpose(R, (0, 2, 1))
    c2ws[:, :3, 3] = -np.einsum("nji,nj->ni", R, t)
    c2ws[:, 3, 3] = 1.0
    if args.mode == "spiral":
        path = trajectory.spiral_path(c2ws, n_frames=args.n_frames)
    elif args.mode == "orbit":
        center = c2ws[:, :3, 3].mean(axis=0)
        rad = np.linalg.norm(c2ws[:, :3, 3] - center, axis=1).mean()
        path = trajectory.orbit_path(center, rad, 0.0, args.n_frames)
    elif args.mode == "wander":
        # in place around the first (optimised) view
        path = trajectory.wander_path(R[0], t[0], path_fovy, static.height,
                                      args.n_frames)
    else:
        path = trajectory.interpolate_path(
            anchor_cams, max(args.n_frames // max(len(R) - 1, 1), 1))
    cams = trajectory.path_to_cameras(path, path_fovx, path_fovy, device)

    out_dir = args.out or os.path.join(args.model_path,
                                       f"trajectory_{args.mode}_{it}")
    os.makedirs(out_dir, exist_ok=True)
    with torch.no_grad():
        gauss = (g.xyz, g.scaling(), g.quats, g.opacity(alive), g.sh_coeffs())

    def render_core(cam):
        extra = None
        if spec is not None and g.asg is not None:
            from ..calib.specular import specular_extra_color
            extra = specular_extra_color(spec, g.xyz, g.asg, cam, align)
        return render(*gauss, cam, static, cfg, bg=bg, align=align,
                      extra_color=extra).render

    def render_plain(cam):
        img = render_core(cam)
        # the lens warps whole frames only (panorama faces resample their
        # own tan-space geometry)
        return img if warp_frame is None else warp_frame(img, cam)

    def render_panorama(cam):
        from ..calib.cubemap import SUB_CAMERA_ROTATIONS, cubemap_to_perspective
        from ..core.camera import rotate_camera_pose
        from ..core.lie import quat_to_rotmat, rotmat_to_quat

        # faces at 90 degrees in both axes: the resampler maps u, v in
        # [-1, 1] to tan(+-45 degrees) at each face's edges
        fov90 = torch.full_like(cam.fovx, np.float32(np.pi / 2))
        cam = dataclasses.replace(cam, fovx=fov90, fovy=fov90)
        faces = [render_core(cam)]                       # forward
        R0 = quat_to_rotmat(cam.q_init)
        for degs in SUB_CAMERA_ROTATIONS[:4]:            # up down left right
            Rn, tn = rotate_camera_pose(R0, cam.t_init, *degs)
            faces.append(render_core(dataclasses.replace(
                cam, q_init=rotmat_to_quat(Rn), t_init=tn)))
        fwd, up, down, left, right = faces
        return cubemap_to_perspective(fwd, left, right, up, down,
                                      args.panorama_fov, args.panorama_fov,
                                      static.width, static.height)

    render_one = render_panorama if args.panorama_fov > 0 else render_plain
    frames, render_s, png_s, finite = [], [], [], True
    n = int(cams.fovx.shape[0])
    for i in range(n):
        t0 = time.perf_counter()
        with torch.no_grad():
            img = render_one(cams[i]).cpu().numpy()
        finite = finite and bool(np.isfinite(img).all())
        arr = (np.clip(img, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
        t1 = time.perf_counter()
        Image.fromarray(arr).save(os.path.join(out_dir, f"{i:05d}.png"))
        render_s.append(t1 - t0)
        png_s.append(time.perf_counter() - t1)
        if args.gif:
            frames.append(Image.fromarray(arr))
    if args.gif and frames:
        frames[0].save(os.path.join(out_dir, "trajectory.gif"), save_all=True,
                       append_images=frames[1:], duration=50, loop=0)
    print(f"wrote {n} frames to {out_dir}")
    return {"dir": out_dir, "frames": n, "finite": finite,
            "lens_warp": warp_frame is not None,
            "specular": spec is not None and g.asg is not None,
            "render_s": render_s, "png_s": png_s}


if __name__ == "__main__":
    main()
