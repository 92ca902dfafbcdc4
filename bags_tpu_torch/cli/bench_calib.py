"""Calibrated-pipeline benchmark of the port: fisheye and cubemap training
step throughput. Port of the root `bench_calib.py`.

    python -m bags_tpu_torch.cli.bench_calib [--mode fisheye|cubemap|both]

Times the two calibrated steps end to end (`train/calibrated.py`'s
`fisheye_train_step` and `cubemap_train_step`: render, lens warp or five
renders and their warps, loss, full backward, optimiser updates) on the
bench's toy scene and prints one JSON line per mode:

    {"metric": "fisheye_pixels_per_s_fwd_bwd", ...}
    {"metric": "cubemap_pixels_per_s_fwd_bwd", ...}

pixels/s counts the loss-side pixels of a step (the fisheye sensor's; five
faces' for the cubemap, each a full rasterisation); one warm-up step, then
`--iters` steps on the host clock ending in `torch.cuda.synchronize()`.
vs_baseline is against the bench's vanilla 1.6e7 pixels/s bar
(`cli/bench.py`). The JAX tool's `--precision fast` and `--warp_ky` are TPU
workarounds (the bf16 ladder and the banded warp; ROADMAP "Not ported"):
the port composites and warps in float32 alone and prints "exact".
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .bench import BASELINE_PIXELS_PER_S, sync


def _state(cfg, sc):
    """The toy scene's Gaussians and two identity cameras in a CalibState
    (lens and cubemap net at their seeds), and its schedules."""
    from ..core.camera import CameraParams
    from ..model.gaussians import Gaussians
    from ..train.calibrated import init_calib_state
    from ..train.loop import init_train_state

    n = sc["xyz"].shape[0]
    op = sc["opacity"]
    g = Gaussians(xyz=sc["xyz"], sh_dc=sc["sh_coeffs"][:, :1].contiguous(),
                  sh_rest=sc["sh_coeffs"][:, 1:].contiguous(),
                  scales_log=torch.log(sc["scales"]), quats=sc["quats"],
                  opacity_raw=torch.log(op / (1 - op)))
    alive = torch.ones(n, dtype=torch.bool, device=sc["xyz"].device)
    cams = CameraParams.stack([sc["cam"], sc["cam"]])
    return init_calib_state(init_train_state(g, alive, cams, cfg, 2.0), cfg)


def _near_identity(net) -> None:
    """Scale every tensor of a lens net by 1e-4 (the JAX bench's lens)."""
    with torch.no_grad():
        for t in net.named_tensors().values():
            t.mul_(1e-4)


def _time_steps(run_step, iters: int, device) -> float:
    """Seconds a step: one warm-up, then `iters` steps."""
    run_step(0)
    sync(device)
    t0 = time.perf_counter()
    for i in range(iters):
        run_step(i % 2)
    sync(device)
    return (time.perf_counter() - t0) / iters


def bench_fisheye(n: int, wh: int, iters: int, device) -> float:
    """Fisheye step pixels/s: the lens steps, vignetting off."""
    from ..raster.render import RenderConfig
    from ..train import calibrated
    from ..train.config import CalibConfig, TrainConfig
    from ..utils.testing import make_toy_scene

    sc = make_toy_scene(n=n, width=wh, height=wh, sh_degree=3, seed=0,
                        scale_range=(0.008, 0.035), device=device)
    cfg = TrainConfig(calib=CalibConfig(opt_cam=True, opt_distortion=True,
                                        outside_rasterizer=True,
                                        iresnet_lr=1e-7))
    state, schedules = _state(cfg, sc)
    _near_identity(state.lens)
    setup = calibrated.make_fisheye_setup(
        focal_x=wh / 2.0, focal_y=wh / 2.0, persp_wh=(wh, wh),
        fish_wh=(wh, wh))
    p_view = calibrated.fisheye_control_points(setup, wh / 2.0, wh / 2.0,
                                               device=device)
    cams = state.base.cams
    cams.fovx.fill_(setup.fovx)
    cams.fovy.fill_(setup.fovy)
    fh, fw = setup.fish_hw
    fish_gt = torch.full((3, fh, fw), 0.4, device=device)
    bg = torch.zeros(3, device=device)
    rcfg = RenderConfig(sh_degree=3)

    def run_step(i):
        calibrated.fisheye_train_step(state, fish_gt, p_view, i, bg, setup,
                                      rcfg, cfg, schedules, opt_lens=True,
                                      use_vignetting=False)

    return fh * fw / _time_steps(run_step, iters, device)


def bench_cubemap(n: int, wh: int, iters: int, device) -> float:
    """Cubemap step pixels/s (five face renders a step)."""
    from ..raster.render import RenderConfig
    from ..train import calibrated
    from ..train.config import CalibConfig, TrainConfig
    from ..utils.testing import make_toy_scene

    sc = make_toy_scene(n=n, width=wh, height=wh, sh_degree=3, seed=0,
                        scale_range=(0.008, 0.035), device=device)
    cfg = TrainConfig(calib=CalibConfig(opt_cam=True, cubemap=True,
                                        iresnet_lr=1e-7))
    state, schedules = _state(cfg, sc)
    _near_identity(state.cubemap_net)
    setup = calibrated.make_cubemap_setup(sc["static"], wh / 2.0, wh / 2.0,
                                          cfg, device)
    sub_q, sub_t = calibrated.sub_camera_poses(state.base.cams)
    gt = torch.full((3, wh, wh), 0.4, device=device)
    bg = torch.zeros(3, device=device)
    rcfg = RenderConfig(sh_degree=3)

    def run_step(i):
        calibrated.cubemap_train_step(state, gt, i, bg, sub_q[i], sub_t[i],
                                      setup, rcfg, cfg, schedules)

    return 5 * wh * wh / _time_steps(run_step, iters, device)


def main(argv=None) -> list:
    """Run the benchmark; prints and returns the JSON lines' dicts."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mode", choices=["fisheye", "cubemap", "both"],
                   default="both")
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--wh", type=int, default=800)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    lines = []
    for mode, fn in (("fisheye", bench_fisheye), ("cubemap", bench_cubemap)):
        if args.mode in (mode, "both"):
            pps = fn(args.n, args.wh, args.iters, device)
            lines.append({
                "metric": f"{mode}_pixels_per_s_fwd_bwd",
                "value": round(pps, 1), "unit": "pixels/s/chip",
                "precision": "exact",
                "vs_baseline": round(pps / BASELINE_PIXELS_PER_S, 4)})
            print(json.dumps(lines[-1]))
    return lines


if __name__ == "__main__":
    main()
