"""Known-lens recovery (port of `tools/lens_recovery.py`): does photometric
training pull a wrong lens towards the true one?

    python -m bags_tpu_torch.tools.lens_recovery [--iters 3000 --wh 400
        --n 20000 --device cuda]

The fisheye GT of a look-at rig is the toy scene rendered at the fisheye
setup's extended FoV and warped through the closed-form inverse of a KNOWN
OPENCV_FISHEYE polynomial (`--true_coeff`). Training starts from jittered
points, noisy poses and a lens net pre-fitted (`PREFIT_ITERS` Adam steps,
lr 3e-4) to a perturbed polynomial (`--init_coeff`), and runs the fisheye
step (`train/calibrated.py::fisheye_train_step`). Every `--report_every`
iterations, and at the end, it measures the recovered flow's error against
the generator (all control points, the centre's, and up to a global scale),
the pose error and, at the end, PSNR through the learned lens on the
training views and on the held-out views (every fourth, clean poses).
Prints one JSON line with the JAX tool's keys and returns it as a dict
(`main(argv)`). `warp_ky` is the JAX tool's banded-warp window, a TPU
workaround: always 0 here.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

# Adam steps of the lens pre-fit to the perturbed coefficients (the JAX
# tool's count).
PREFIT_ITERS = 3000


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=3000)
    p.add_argument("--wh", type=int, default=400)
    p.add_argument("--n", type=int, default=20000)
    p.add_argument("--n_cams", type=int, default=12)
    p.add_argument("--focal_frac", type=float, default=0.375,
                   help="focal = focal_frac * wh (0.375 -> r_d up to "
                        "~1.33 at the sensor edge, a strong fisheye)")
    p.add_argument("--iresnet_lr", type=float, default=1e-6)
    p.add_argument("--pose_noise", type=float, default=0.01)
    p.add_argument("--true_coeff", type=float, nargs=4,
                   default=[-0.12, 0.02, 0.0, 0.0])
    p.add_argument("--init_coeff", type=float, nargs=4,
                   default=[-0.04, 0.0, 0.0, 0.0])
    p.add_argument("--report_every", type=int, default=200)
    p.add_argument("--sh_degree", type=int, default=0,
                   help="0 keeps colours view-independent: with few views, "
                        "view-dependent colour lets the scene absorb lens "
                        "error instead of correcting it")
    p.add_argument("--spread", type=float, default=1.0)
    p.add_argument("--true_colors", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--lens_opt_until", type=int, default=0,
                   help="freeze the lens after this iteration (0 = never)")
    p.add_argument("--opt_cam", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--scale_range", type=float, nargs=2,
                   default=[0.02, 0.09],
                   help="Gaussian scale range: big enough that the render "
                        "covers the frame")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    from ..calib.distortion import (analytic_inverse_flow, apply_distortion,
                                    flow_error_px, init_iresnet_from_colmap)
    from ..core.camera import CameraParams
    from ..eval.metrics import psnr
    from ..eval.pose_eval import align_and_pose_error
    from ..model.gaussians import create_from_points
    from ..raster.render import RenderConfig, render
    from ..train import calibrated
    from ..train.config import CalibConfig, OptimizationConfig, TrainConfig
    from ..train.loop import init_train_state
    from ..utils.device import resolve_device
    from ..utils.testing import make_lookat_cameras, make_toy_scene

    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    wh, focal = args.wh, args.focal_frac * args.wh
    sc = make_toy_scene(n=args.n, width=wh, height=wh,
                        sh_degree=args.sh_degree, seed=11,
                        scale_range=tuple(args.scale_range), device=device)
    setup = calibrated.make_fisheye_setup(
        focal_x=focal, focal_y=focal, persp_wh=(wh, wh), fish_wh=(wh, wh),
        control_point_sample_scale=8)
    p_view = calibrated.fisheye_control_points(setup, focal, focal,
                                               device=device)
    proj = np.asarray([1.0 / np.tan(setup.fovx / 2),
                       1.0 / np.tan(setup.fovy / 2)], np.float32)
    true_flow = analytic_inverse_flow(args.true_coeff, p_view, setup.grid_hw,
                                      proj, setup.flow_hw)
    rcfg = RenderConfig(sh_degree=args.sh_degree)
    static = setup.render_static
    gauss = [sc[k] for k in ("xyz", "scales", "quats", "opacity", "sh_coeffs")]

    # fisheye GT through the TRUE lens from clean poses, a look-at rig with
    # parallax (a shared-centre pure-rotation rig cannot tell the lens)
    rng = np.random.default_rng(0)
    cams = make_lookat_cameras(args.n_cams, setup.fovx, setup.fovy,
                               center=(0.0, 0.0, 6.0), radius=6.0,
                               spread=args.spread, device=device)
    with torch.no_grad():
        fish_gts = torch.stack([apply_distortion(
            None, p_view, setup.grid_hw, render(*gauss, cam, static, rcfg).render,
            None, setup.flow_hw, final_hw=setup.fish_hw, flow=true_flow)[0]
            for cam in cams])
    clean_cams = CameraParams.stack(cams)
    test_idx = list(range(0, args.n_cams, 4))
    train_idx = [i for i in range(args.n_cams) if i not in test_idx]

    # training init: jittered points, noisy poses, perturbed lens
    pts = sc["xyz"].cpu().numpy() + rng.normal(
        0, 0.02, (args.n, 3)).astype(np.float32)
    if args.true_colors:
        C0 = 0.28209479177387814
        cols = np.clip(0.5 + C0 * sc["sh_coeffs"][:, 0, :].cpu().numpy(),
                       0.05, 0.95).astype(np.float32)
    else:
        cols = rng.uniform(0.2, 0.8, (args.n, 3)).astype(np.float32)
    cap = 1 << int(np.ceil(np.log2(args.n * 2)))
    g, alive = create_from_points(pts, cols, cap, sh_degree=args.sh_degree,
                                  device=device)
    noisy = dataclasses.replace(
        clean_cams,
        dq=torch.as_tensor(rng.normal(0, args.pose_noise, (args.n_cams, 4))
                           .astype(np.float32), device=device),
        dt=torch.as_tensor(rng.normal(0, args.pose_noise, (args.n_cams, 3))
                           .astype(np.float32), device=device))
    cfg = TrainConfig(
        opt=OptimizationConfig(densify_from_iter=10 ** 9),
        calib=CalibConfig(opt_cam=args.opt_cam, opt_distortion=True,
                          outside_rasterizer=True, iresnet_lr=args.iresnet_lr,
                          r_t_lr=(0.002, 0.002)))
    base = init_train_state(g, alive, noisy, cfg, 2.0)
    st, schedules = calibrated.init_calib_state(base, cfg)
    print(f"pre-fitting the lens to the perturbed coefficients "
          f"({PREFIT_ITERS} Adam steps) ...", flush=True)
    K = np.array([[focal, 0, wh / 2], [0, focal, wh / 2], [0, 0, 1.0]])
    t0 = time.perf_counter()
    init_iresnet_from_colmap(st.lens, K, wh, wh, args.init_coeff,
                             iters=PREFIT_ITERS, lr=3e-4)
    sync()
    prefit_s = time.perf_counter() - t0

    def ferr(max_ndc=1.0, fit_scale=False):
        return flow_error_px(st.lens, args.true_coeff, p_view, proj,
                             static.width, max_ndc=max_ndc, fit_scale=fit_scale)

    err0, err0_c, err0_g = ferr(), ferr(max_ndc=0.7), ferr(fit_scale=True)
    _, perr0 = align_and_pose_error(noisy, clean_cams)
    print(f"init: flow err {err0:.3f}px, pose rot "
          f"{perr0['rotation_deg_mean']:.4f}deg (pre-fit {prefit_s:.1f} s)",
          flush=True)

    bg = torch.zeros(3, device=device)
    order = rng.permutation(np.asarray(train_idx * (
        args.iters // len(train_idx) + 1)))[:args.iters]
    trace = []
    sync()
    t0 = time.perf_counter()
    for i, idx in enumerate(order):
        opt_lens = not args.lens_opt_until or i < args.lens_opt_until
        m = calibrated.fisheye_train_step(
            st, fish_gts[idx], p_view, int(idx), bg, setup, rcfg, cfg,
            schedules, opt_lens, use_vignetting=False)
        if (i + 1) % args.report_every == 0:
            e, ec, eg = ferr(), ferr(max_ndc=0.7), ferr(fit_scale=True)
            _, pe = align_and_pose_error(st.base.cams, clean_cams)
            trace.append(dict(it=i + 1, loss=float(m.loss), flow_err_px=e,
                              flow_err_center_px=ec, flow_err_gauge_px=eg,
                              rot_deg=pe["rotation_deg_mean"], wover=0))
            print(f"it {i+1}: loss {float(m.loss):.4f} flow {e:.3f}px "
                  f"(center {ec:.3f}, gauge-fixed {eg:.3f}) "
                  f"rot {pe['rotation_deg_mean']:.4f}deg", flush=True)
    sync()
    dt = time.perf_counter() - t0

    # PSNR through the LEARNED lens: the training views at their optimised
    # poses, the held-out views at their clean ones
    gl = st.base.g
    psnrs = {}
    with torch.no_grad():
        learned = [gl.xyz, gl.scaling(), gl.quats, gl.opacity(st.base.alive),
                   gl.sh_coeffs()]
        for split, idxs in (("train", train_idx), ("test", test_idx)):
            vals = []
            for i in idxs:
                cam = (st.base.cams if split == "train" else clean_cams)[i]
                img = apply_distortion(
                    st.lens, p_view, setup.grid_hw,
                    render(*learned, cam, static, rcfg).render,
                    torch.as_tensor(proj, device=device), setup.flow_hw,
                    final_hw=setup.fish_hw)[0]
                vals.append(float(psnr(torch.clamp(img, 0, 1), fish_gts[i])))
            psnrs[split] = float(np.mean(vals))

    _, perr1 = align_and_pose_error(st.base.cams, clean_cams)
    out = dict(metric="lens_recovery",
               flow_err_init_px=round(err0, 4),
               flow_err_final_px=round(ferr(), 4),
               flow_err_center_init_px=round(err0_c, 4),
               flow_err_center_final_px=round(ferr(max_ndc=0.7), 4),
               flow_err_gauge_init_px=round(err0_g, 4),
               flow_err_gauge_final_px=round(ferr(fit_scale=True), 4),
               pose_rot_init_deg=round(perr0["rotation_deg_mean"], 5),
               pose_rot_final_deg=round(perr1["rotation_deg_mean"], 5),
               pose_trans_final=round(perr1["translation_mean"], 6),
               psnr_train=round(psnrs["train"], 3),
               psnr_test=round(psnrs["test"], 3),
               iters=args.iters, s_per_iter=round(dt / max(args.iters, 1), 4),
               true_coeff=args.true_coeff, init_coeff=args.init_coeff,
               warp_ky=0, trace=trace)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
