"""The render driver: the program's `raster/render.py::render` of a scene's
whole population, as the render CLI and the viewer call it, over a
closed-loop stream of novel views.

Set-up makes the scene on the device from the seed (all its Gaussians
live, as the render CLI loads a PLY), the traffic's orbit of views (a
fixed shape, the seed choosing where it starts) and warms up with the
orbit's first views. In the window one client requests views one after
another along the orbit: a request ends when the view's image is in host
memory as a float (3, H, W) copy, in the client's own page-locked buffer
that every request reuses, and the next is made then.
`render_ms_per_view` is the window's wall time over the views completed
in it, `render_ms_p95` the 95th percentile of their request-to-image
times.

The comparison renders a sample of the window's views, drawn from the
seed, with the plain reference and reads the largest pixel difference
and the share of pixel values off by more than `OFF` from each kept image.
With `--trace 1` two profiled segments render the sampled views again,
the first recording the device alone, the second the host too, and
their work is counted on the reference's binning.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from reference import render as ref_render

from .. import core, faults, scene as sc
from ..trace import capture
from ..work import view_work

FAMILY = "render"
CHECKS = ("views_compared", "view_max_abs", "view_share_off")
PROGRAM_FAULTS = {"altered": ([("bags_tpu_torch.raster.render", "render")], faults.altered)}
OFF = 2e-5          # a pixel value off by more than this counts in view_share_off
WARMUP_VIEWS = 3
KEPT_VIEWS = 6      # views of the window the reference renders again
TRACED_VIEWS = 6


def _p95(xs: List[float]) -> float:
    return float(np.percentile(np.asarray(xs), 95))


def run(cell, seed: int, seconds: float, trace: bool, device, age) -> core.Run:
    from bags_tpu_torch.core.camera import CameraParams, CameraStatic
    from bags_tpu_torch.model.gaussians import Gaussians
    from bags_tpu_torch.raster.render import RenderConfig, render

    cfg, traffic = cell.config, cell.traffic
    s_scene, _, s_orbit, s_sample = sc.sub_seeds(seed)
    scene = sc.make_scene(cfg, s_scene, device)
    poses = sc.orbit_cameras(cfg, traffic, s_orbit)
    period = len(poses)
    table = sc.camera_table(poses, cfg["fov"], cfg["fov"], device)
    n = scene.xyz.shape[0]
    g = Gaussians(**{k: v.clone() for k, v in scene.raw().items()})
    alive = torch.ones(n, dtype=torch.bool, device=device)
    del scene
    cams = CameraParams(**table)
    static = CameraStatic(cfg["width"], cfg["height"])
    rcfg = RenderConfig(sh_degree=cfg["scene"]["sh_degree"])
    bg = torch.zeros(3, device=device)
    sample = sorted(np.random.default_rng(s_sample).choice(
        period, size=KEPT_VIEWS, replace=False).tolist())

    # the client's page-locked image buffer, reused by every request
    host = torch.empty((3, cfg["height"], cfg["width"]),
                       pin_memory=device.type == "cuda")

    def view(i: int) -> torch.Tensor:
        out = render(g.xyz, g.scaling(), g.quats, g.opacity(alive), g.sh_coeffs(),
                     cams[i % period], static, rcfg, bg=bg)
        return host.copy_(out.render)

    for i in range(WARMUP_VIEWS):
        view(i)
    setup_s = age()

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    lat: List[float] = []
    kept: Dict[int, torch.Tensor] = {}
    keep = set(sample)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while True:
        t_req = time.perf_counter()
        img = view(i)
        now = time.perf_counter()
        lat.append(now - t_req)
        if i in keep:
            kept[i] = img.clone()
        i += 1
        if now >= deadline:
            break
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    tr = host_tr = None
    traced = sample[:TRACED_VIEWS]
    if trace:
        tr = capture(lambda: [view(j) for j in traced], host=False)
        host_tr = capture(lambda: [view(j) for j in traced], host=True)
    del g, alive
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference renders the kept views of a scene made again from the seed
    scene = sc.make_scene(cfg, s_scene, device)
    max_abs, share, failed = 0.0, 0.0, 0
    with torch.no_grad():
        for j, img in kept.items():
            R, t = _pose(table, j % period)
            ref = ref_render.render(
                scene.xyz, scene.scales, scene.quats, scene.opacity, scene.sh, R, t,
                table["fovx"][0], table["fovy"][0], cfg["width"], cfg["height"], bg)
            d = (img.to(device) - ref).abs()
            if not bool(torch.isfinite(img).all()):
                failed += 1
            max_abs = max(max_abs, float(d.max()))
            share = max(share, float((d > OFF).float().mean()))
    checks = {"views_compared": (0.0 if kept else 1.0, 0.0),
              "view_max_abs": (max_abs, cell.limits["view_max_abs"]),
              "view_share_off": (share, cell.limits["view_share_off"])}
    out = core.Run(driver=FAMILY,
                   e2e={"render_ms_per_view": 1e3 * (t1 - t0) / i,
                        "render_ms_p95": 1e3 * _p95(lat), "setup_s": setup_s,
                        "peak_mem_gib": peak / 2 ** 30},
                   attempted=i, failed=failed, checks=checks, peak_bytes=peak,
                   trace=tr, host_trace=host_tr, traced_steps=len(traced),
                   notes=[f"{i} views in the window, {len(kept)} compared: "
                          f"{sorted(kept)}; request ms min "
                          f"{1e3 * min(lat):.3f}, median {1e3 * statistics.median(lat):.3f}, "
                          f"max {1e3 * max(lat):.3f}"])
    if trace:
        out.work = work(cfg, scene, traced, table)
    return out


def _pose(table, j: int):
    """View j's world-to-camera (R, t) from the camera table the program is
    given, as the program forms it."""
    return ref_render.camera_pose(table["q_init"][j], table["t_init"][j],
                                  table["dq"][j], table["dt"][j])


def work(cfg, scene, views, table) -> Dict[str, float]:
    """The least seconds of a view (the mean over `views`) and the forward
    kernel's least seconds over them, on the reference's binning."""
    per = [view_work(scene.raw(), None, *_pose(table, j), table["fovx"][0],
                     table["fovy"][0], cfg["width"], cfg["height"],
                     cfg["scene"]["sh_degree"]) for j in views]
    return {"view_least_s": statistics.mean(p["view"] for p in per),
            "fwd_least_s_traced": sum(p["fwd"] for p in per)}


@torch.no_grad()
def control_readings(cell, seed: int, device) -> list:
    """The control's view_max_abs and view_share_off over the seed's
    sampled views: the reference rendered in the configuration's control
    precision against the reference in float32."""
    cfg, traffic = cell.config, cell.traffic
    s_scene, _, s_orbit, s_sample = sc.sub_seeds(seed)
    scene = sc.make_scene(cfg, s_scene, device)
    poses = sc.orbit_cameras(cfg, traffic, s_orbit)
    table = sc.camera_table(poses, cfg["fov"], cfg["fov"], device)
    sample = np.random.default_rng(s_sample).choice(
        len(poses), size=KEPT_VIEWS, replace=False).tolist()
    ctl = cfg["control"]
    dt = faults.DTYPES[ctl["dtype"]]
    fov = torch.tensor(cfg["fov"], device=device)
    max_abs, share = 0.0, 0.0
    saved = torch.backends.cuda.matmul.allow_tf32
    for j in sample:
        R, t = _pose(table, j)
        truth = ref_render.render(scene.xyz, scene.scales, scene.quats, scene.opacity,
                                  scene.sh, R, t, fov, fov, cfg["width"], cfg["height"])
        torch.backends.cuda.matmul.allow_tf32 = ctl["tf32"]
        try:
            low = ref_render.render(*(x.to(dt) for x in (
                scene.xyz, scene.scales, scene.quats, scene.opacity, scene.sh, R, t,
                fov, fov)), cfg["width"], cfg["height"])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        d = (low.float() - truth).abs()
        max_abs = max(max_abs, float(d.max()))
        share = max(share, float((d > OFF).float().mean()))
    return [{"workload": cell.name, "seed": seed, "reading": f"control_{ctl['dtype']}",
             "view_max_abs": max_abs, "view_share_off": share}]
