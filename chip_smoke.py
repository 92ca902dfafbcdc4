#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (`bags_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card (H100, sm_90a) and nvcc; imports nothing of JAX or of
`bags_tpu`. In order:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the forward compositing kernel from `bags_tpu_torch/csrc`;
  3. holds the kernel against its plain PyTorch version at test sizes
     (toy scene, unaligned-spill scene, a tile with > 4096 instances):
     max abs difference <= 2e-5;
  4. drives the main path at full width: a 1M-Gaussian SH-3 scene (the
     `bench.py --large` recipe) saved as a PLY model, a COLMAP dataset of 8
     cameras at 1600x1080 whose GT images are the plain version's renders,
     and the port's render CLI (`bags_tpu_torch.cli.render`) on the card.
     Checks: one kernel launch per view the CLI renders, PSNR >= 45 dB per
     view, and on one view in float: max abs difference <= 1e-3 and at
     most 1e-4 of the pixels off by more than 2e-5. Then times each view,
     the kernel, the plain version and the stages of one view;
  5. prints the kernels line (JSON) and, last, the device line (JSON).
Any failed check raises, and the run exits non-zero with no device line.
Work files go to `build/chip_smoke/` and are removed at the end.
"""

import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and FP32 (non-tensor) FLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# FP32 operations per pixel-instance pair the kernel's loop visits: every
# visited pair computes dx, dy and power and tests power (12); with
# power <= 0 it takes exp, multiplies, clamps and tests alpha (4 more);
# with alpha >= 1/255 it forms and tests T (1 - alpha) (3 more); and a pair
# that is composited forms w and four fused multiply-adds (9 more).
OPS_VISITED, OPS_EXP, OPS_ALPHA, OPS_COMPOSITED = 12, 4, 3, 9
TOL_TEST = 2e-5
N_GAUSS, WIDTH, HEIGHT, N_CAMS = 1_000_000, 1600, 1080, 8


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def sync_ms(fn, iters):
    """Mean ms of fn() over iters calls, CUDA events, after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def frame(g, alive, cam, static, sh_degree, timer=None):
    """Projection, binning and gather of one view, as `render()` runs them.
    timer(name) is called after each stage."""
    from bags_tpu_torch.core.projection import project_gaussians
    from bags_tpu_torch.raster import binning, tiles
    from bags_tpu_torch.raster.render import build_packet_table

    tick = timer or (lambda name: None)
    proj = project_gaussians(g.xyz, g.scaling(), g.quats, g.opacity(alive),
                             g.sh_coeffs(), cam, static, sh_degree)
    tick("projection")
    tiles_x, tiles_y = tiles.tile_grid(static.width, static.height)
    bins = binning.bin_gaussians(proj, tiles_x, tiles_y)
    tick("binning")
    rows = build_packet_table(proj, proj.x2d, proj.y2d).index_select(
        1, bins.gauss_id)
    tick("gather")
    return rows, bins, tiles_x, tiles_y


def to_image(color4, tiles_x, tiles_y, static):
    """(3, H, W) colour of the kernel's (T, 4, 256) output, no background."""
    from bags_tpu_torch.raster import tiles

    return tiles.tiles_to_image(color4.transpose(1, 2)[..., :3], tiles_x,
                                tiles_y, static.width, static.height)


def compare(a, b):
    """(max abs diff, per-pixel max abs diff) of kernel vs plain outputs."""
    import torch

    ca, ta = a
    cb, tb = b
    pix = torch.maximum((ca - cb).abs().amax(dim=1), (ta - tb).abs())
    return float(pix.max()), pix


def pair_ops(rows, tile_start, tile_count, tiles_x, tiles_y, chunk=32):
    """(visited pairs, FP32 operations) the kernel's loop needs on these
    inputs: each pixel walks its tile's instances up to and including the
    one that ends it (T (1 - alpha) < 1e-4), or to the tile's end."""
    import torch
    from bags_tpu_torch.raster import tiles as tl

    px, py = tl.tile_pixel_coords(tiles_x, tiles_y, rows.device)
    start, count = tile_start.long(), tile_count.long()
    t_run = torch.ones_like(px)
    done = torch.zeros_like(px, dtype=torch.bool)
    offs = torch.arange(chunk, device=rows.device)
    visits = ops = 0
    for k in range(0, int(count.max()), chunk):
        act = torch.nonzero((count > k) & ~done.all(dim=1)).squeeze(1)
        if act.numel() == 0:
            break
        in_range = (k + offs)[None, :] < count[act, None]
        f = rows[:, torch.where(in_range, start[act, None] + k + offs, 0)]
        dx = px[act][:, None, :] - f[0][..., None]
        dy = py[act][:, None, :] - f[1][..., None]
        power = -0.5 * (f[2][..., None] * dx * dx + f[4][..., None] * dy * dy) \
            - f[3][..., None] * dx * dy
        alpha = torch.clamp(f[5][..., None] * torch.exp(power), max=tl.ALPHA_MAX)
        ok = (alpha >= tl.ALPHA_MIN) & (power <= 0) & in_range[..., None]
        a = torch.where(ok, alpha, 0.0)
        cp = torch.cumprod(1.0 - a, dim=1)
        t_before = t_run[act][:, None, :] * torch.cat(
            [torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        kill = ok & (t_before * (1.0 - a) < tl.T_EPS)
        killed_before = (torch.cumsum(kill.int(), dim=1) - kill.int()) > 0
        visited = in_range[..., None] & ~killed_before & ~done[act][:, None, :]
        inc = visited & ok & ~kill
        n_vis = int(visited.sum())
        visits += n_vis
        ops += (OPS_VISITED * n_vis + OPS_EXP * int((visited & (power <= 0)).sum())
                + OPS_ALPHA * int((visited & ok).sum())
                + OPS_COMPOSITED * int(inc.sum()))
        t_run[act] = t_run[act] * torch.where(inc, 1.0 - a, 1.0).prod(dim=1)
        done[act] |= (kill & visited).any(dim=1)
    return visits, ops


def test_size_checks(device):
    """Kernel against plain version on three small scenes (step 3)."""
    import numpy as np
    import torch
    from bags_tpu_torch.model.gaussians import Gaussians
    from bags_tpu_torch.raster.composite import composite_fwd
    from bags_tpu_torch.raster.tiles import composite_tiles_plain
    from bags_tpu_torch.utils.testing import make_toy_scene

    def as_gaussians(sc):
        n = sc["xyz"].shape[0]
        return Gaussians(
            xyz=sc["xyz"], sh_dc=sc["sh_coeffs"][:, :1], sh_rest=sc["sh_coeffs"][:, 1:],
            scales_log=torch.log(sc["scales"]), quats=sc["quats"],
            opacity_raw=torch.log(sc["opacity"] / (1 - sc["opacity"]))), \
            torch.ones(n, dtype=torch.bool, device=device)

    dense = make_toy_scene(n=20000, width=32, height=32, seed=5,
                           scale_range=(0.1, 0.4), device=device)
    # Low opacities keep the pixels compositing through > 4096 instances.
    dense["opacity"] = torch.as_tensor(np.random.default_rng(5).uniform(
        0.005, 0.02, 20000).astype(np.float32), device=device)
    scenes = {
        "toy_64x48_700": make_toy_scene(n=700, width=64, height=48,
                                        sh_degree=3, seed=0, device=device),
        "unaligned_spill": make_toy_scene(n=700, width=64, height=48, seed=21,
                                          scale_range=(0.01, 0.05), device=device),
        "dense_tile_gt_4096": dense,
    }
    for name, sc in scenes.items():
        g, alive = as_gaussians(sc)
        rows, bins, tx, ty = frame(g, alive, sc["cam"], sc["static"],
                                   sc["sh_degree"])
        kern = composite_fwd(rows, bins.tile_start, bins.tile_count, tx, ty)
        plain = composite_tiles_plain(rows, bins.tile_start, bins.tile_count, tx, ty)
        torch.cuda.synchronize()
        err, _ = compare(kern, plain)
        max_tile = int(bins.tile_count.max())
        print(f"test size {name}: instances={bins.n_instances} "
              f"max_tile={max_tile} max_abs_diff={err:.3e}")
        check(err <= TOL_TEST, f"{name}: kernel vs plain {err} > {TOL_TEST}")
        if name == "dense_tile_gt_4096":
            check(max_tile > 4096, f"dense scene max tile {max_tile} <= 4096")


def write_dataset(device):
    """Full-width PLY model + COLMAP dataset with plain-version GT (step 4)."""
    import numpy as np
    import torch
    from bags_tpu_torch.data.scene import Scene
    from bags_tpu_torch.model.gaussians import Gaussians, save_ply
    from bags_tpu_torch.raster.tiles import composite_tiles_plain
    from bags_tpu_torch.utils.testing import (make_lookat_cameras, make_toy_scene,
                                              write_colmap_scene, write_image)

    sc = make_toy_scene(n=N_GAUSS, width=WIDTH, height=HEIGHT, sh_degree=3,
                        seed=0, scale_range=(0.0025, 0.011), device=device)
    op = sc["opacity"]
    g = Gaussians(xyz=sc["xyz"], sh_dc=sc["sh_coeffs"][:, :1].contiguous(),
                  sh_rest=sc["sh_coeffs"][:, 1:].contiguous(),
                  scales_log=torch.log(sc["scales"]), quats=sc["quats"],
                  opacity_raw=torch.log(op / (1 - op)))
    model = os.path.join(WORK, "model")
    ply_dir = os.path.join(model, "point_cloud", "iteration_30000")
    os.makedirs(ply_dir)
    save_ply(os.path.join(ply_dir, "point_cloud.ply"), g,
             torch.ones(N_GAUSS, dtype=torch.bool))

    fov = 0.8
    cams = make_lookat_cameras(N_CAMS, fov, fov, spread=0.15, device=device)
    fx = WIDTH / (2 * np.tan(fov / 2))
    fy = HEIGHT / (2 * np.tan(fov / 2))
    data = os.path.join(WORK, "data")
    pts = sc["xyz"][:2000].cpu().numpy()
    write_colmap_scene(data, cams, WIDTH, HEIGHT, fx, fy, pts,
                       np.full_like(pts, 0.5))
    # GT: the plain version's renders of the cameras the CLI will read back.
    scene = Scene(data, eval_split=True, sh_degree=3, device=device)
    alive = torch.ones(N_GAUSS, dtype=torch.bool, device=device)
    for infos, cams_b in ((scene.test_infos, scene.test_cams),
                          (scene.train_infos, scene.train_cams)):
        for i, info in enumerate(infos):
            rows, bins, tx, ty = frame(g, alive, cams_b[i], scene.static, 3)
            c4, _ = composite_tiles_plain(rows, bins.tile_start,
                                          bins.tile_count, tx, ty)
            img = torch.clamp(to_image(c4, tx, ty, scene.static), 0, 1)
            write_image(info.image_path, np.round(
                img.permute(1, 2, 0).cpu().numpy() * 255).astype(np.uint8))
    return model, data, scene


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False: needs a card")
    if not os.path.isdir(os.path.join(REPO, "bags_tpu_torch")):
        sys.exit("chip_smoke: bags_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, REPO)
    from bags_tpu_torch.cli import render as render_cli
    from bags_tpu_torch.model.gaussians import load_ply
    from bags_tpu_torch.raster import composite
    from bags_tpu_torch.raster.render import RenderConfig, render
    from bags_tpu_torch.raster.tiles import composite_tiles_plain

    device = torch.device("cuda")
    t_all = time.perf_counter()
    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    so = composite.build()
    print(f"built {os.path.relpath(so, REPO)} in {time.perf_counter() - t0:.2f} s")

    # 3. kernel against plain at test sizes
    test_size_checks(device)

    # 4. main path at full width
    shutil.rmtree(WORK, ignore_errors=True)
    t0 = time.perf_counter()
    model, data, scene = write_dataset(device)
    print(f"wrote {N_GAUSS}-Gaussian PLY and {N_CAMS}-camera dataset at "
          f"{WIDTH}x{HEIGHT} in {time.perf_counter() - t0:.1f} s")
    argv = ["-m", model, "-s", data, "--ply_only", "--eval", "--sh_degree", "3",
            "--device", "cuda"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    composite.launches = 0
    t0 = time.perf_counter()
    summary = render_cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_launches = composite.launches
    psnrs = [v for s in summary.values() for v in s["psnr"]]
    print(f"CLI: {len(psnrs)} views in {cli_s:.2f} s, kernel launches "
          f"{cli_launches}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, PSNR "
          + " ".join(f"{p:.2f}" for p in psnrs))
    check(len(psnrs) >= 8, f"CLI rendered {len(psnrs)} views < 8")
    check(cli_launches == len(psnrs),
          f"{cli_launches} kernel launches for {len(psnrs)} views")
    check(min(psnrs) >= 45.0, f"PSNR {min(psnrs):.2f} < 45 dB")
    for split in summary.values():
        n_png = len(os.listdir(os.path.join(split["dir"], "renders")))
        check(n_png == len(split["psnr"]), f"{n_png} PNGs in {split['dir']}")

    # per-view timing and the float comparison, after the main path
    g, alive = load_ply(os.path.join(model, "point_cloud", "iteration_30000",
                                     "point_cloud.ply"), device=device)
    cfg = RenderConfig(sh_degree=3)
    cams = [scene.test_cams[i] for i in range(scene.n_test)] + \
        [scene.train_cams[i] for i in range(scene.n_train)]
    args = (g.xyz, g.scaling(), g.quats, g.opacity(alive), g.sh_coeffs())
    with torch.no_grad():
        render(*args, cams[0], scene.static, cfg)       # warm-up
        per_view = []
        for i, cam in enumerate(cams):
            before = composite.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render(*args, cam, scene.static, cfg)
            torch.cuda.synchronize()
            view_ms = (time.perf_counter() - t0) * 1e3
            launched = composite.launches - before
            rows, bins, tx, ty = frame(g, alive, cam, scene.static, 3)
            k_ms = sync_ms(lambda: composite.composite_fwd(
                rows, bins.tile_start, bins.tile_count, tx, ty), 10)
            per_view.append(dict(instances=bins.n_instances,
                                 max_tile=int(bins.tile_count.max()),
                                 view_ms=view_ms, kernel_ms=k_ms))
            print(f"view {i}: instances={bins.n_instances} max_tile="
                  f"{per_view[-1]['max_tile']} render_ms={view_ms:.3f} "
                  f"kernel_ms={k_ms:.4f} launches={launched}")
            check(launched == 1, f"view {i}: {launched} launches")
            del out

        # float comparison and plain / bound on view 0
        rows, bins, tx, ty = frame(g, alive, cams[0], scene.static, 3)
        kern = composite.composite_fwd(rows, bins.tile_start, bins.tile_count, tx, ty)
        plain = composite_tiles_plain(rows, bins.tile_start, bins.tile_count, tx, ty)
        torch.cuda.synchronize()
        err, pix = compare(kern, plain)
        frac = float((pix > 2e-5).float().mean())
        print(f"view 0 kernel vs plain: max_abs_diff={err:.3e}, "
              f"share of pixels off by > 2e-5: {frac:.3e}")
        check(err <= 1e-3, f"full width: max abs diff {err} > 1e-3")
        check(frac <= 1e-4, f"full width: {frac} of pixels off by > 2e-5")
        kernel_ms = sync_ms(lambda: composite.composite_fwd(
            rows, bins.tile_start, bins.tile_count, tx, ty), 20)
        plain_ms = sync_ms(lambda: composite_tiles_plain(
            rows, bins.tile_start, bins.tile_count, tx, ty), 2)
        visits, n_ops = pair_ops(rows, bins.tile_start, bins.tile_count, tx, ty)
        num_tiles = tx * ty
        n_bytes = 10 * 4 * bins.n_instances + 2 * 4 * num_tiles \
            + 5 * 4 * 256 * num_tiles
        bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = n_ops / PEAK_FP32_PER_S * 1e3
        print(f"view 0 bound: {n_bytes} bytes -> {bytes_ms:.4f} ms, "
              f"{visits} pair visits, {n_ops} FP32 ops -> {ops_ms:.4f} ms; "
              f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.3f} ms")

        # where the time of one view goes (view 0, after warm-up)
        stages = {}
        for rep in range(2):
            torch.cuda.synchronize()
            last = [time.perf_counter()]

            def tick(name):
                torch.cuda.synchronize()
                now = time.perf_counter()
                stages[name] = (now - last[0]) * 1e3
                last[0] = now

            rows, bins, tx, ty = frame(g, alive, cams[0], scene.static, 3, tick)
            c4, _ = composite.composite_fwd(rows, bins.tile_start,
                                            bins.tile_count, tx, ty)
            tick("kernel")
            img = torch.clamp(to_image(c4, tx, ty, scene.static), 0, 1)
            tick("assemble")
            render_cli.save_png(os.path.join(WORK, "timing.png"), img)
            tick("png_write")
        print("stages_ms " + json.dumps({k: round(v, 3) for k, v in stages.items()}))

    print(f"total {time.perf_counter() - t_all:.1f} s")
    shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"kernels": [{
        "name": "composite_fwd",
        "route": "cuda",
        "source": "bags_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "bags_tpu/raster/pallas_raster.py:227",
        "launches": cli_launches,
        "max_abs_err": err,
        "max_abs_diff": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
