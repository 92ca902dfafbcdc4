#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (`bags_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card (H100, sm_90a) and nvcc; imports nothing of JAX or of
`bags_tpu`. In order:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds both compositing kernels from `bags_tpu_torch/csrc` (one nvcc
     per source, in parallel) and prints each build's time and ptxas report;
  3. holds the forward kernel against its plain PyTorch version at test
     sizes (toy scene, unaligned-spill scene, a tile with > 4096 instances):
     max abs difference <= 2e-5; and the backward kernel against
     `composite_bwd_plain` on the same scenes with seeded random cotangents:
     |kernel - plain| <= 1e-5 + 1e-3 |plain| element-wise, and on the dense
     tile, where float32 rounding alone exceeds that, the full-width
     criterion of step 7;
  4. camera gradients on the card: dq, dt, fovx, fovy of a toy render with
     both kernels against the same computation on the CPU (plain versions),
     atol 1e-5, rtol 1e-3; then pose recovery on the card (80 Adam steps of
     dq / dt, loss < 0.02, 80 backward launches);
  5. the render path at full width: a 1M-Gaussian SH-3 scene (the
     `bench.py --large` recipe) saved as a PLY model, a COLMAP dataset of 8
     cameras at 1600x1080 whose points3D holds the 1M centres and whose GT
     images are the plain version's renders, and the port's render CLI
     (`bags_tpu_torch.cli.render --ply_only`) on the card. Checks: one
     forward launch per view, PSNR >= 45 dB per view, and on one view in
     float: max abs difference <= 1e-3 and at most 1e-4 of the pixels off
     by more than 2e-5. Then times each view, the kernel, the plain version
     and the stages of one view;
  6. the training path at full width: `bags_tpu_torch.cli.train --preset
     pose_noise --init_type sfm` for 30 iterations on that dataset (1M live
     Gaussians at SH 3), densify grad threshold lowered to 5e-8. Checks: one forward and one backward launch per
     step (evaluation renders counted apart), a finite loss that falls
     (mean of the last 5 steps below the first 5), a densify step that
     changes the live count, the PLY and the checkpoint;
  7. the backward kernel at full width on a training view of the trained
     model against `composite_bwd_plain`: relative L2 error of each of the
     10 rows <= 1e-4 and at most 1e-4 of the entries off by more than
     1e-5 + 1e-3 |plain|; its time, the plain version's and the bound;
  8. the render CLI restores `chkpnt30.npz` (optimised cameras, no
     `--ply_only`) and renders both splits with `--optim_test_pose_iter 5`;
  9. where a full-width training step's time goes, by stage, the whole
     step's time and the peak device memory;
 10. prints the kernels line (JSON) and, last, the device line (JSON).
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
# The backward kernel replays the same visits (12, 4 and 3 as above); an
# included pair then forms w (1), per channel the prefix, the suffix term,
# <g, c> and the colour gradient g w (9 x 4), dL/dalpha (6), the clamp test
# (1), d_power (1), the six geometric gradients (4 + 4 + 3 + 3 + 3 + 1) and
# the sum of all ten over the tile's pixels (10).
OPS_BWD_INCLUDED = 1 + 36 + 6 + 1 + 1 + 18 + 10
TOL_TEST = 2e-5
N_GAUSS, WIDTH, HEIGHT, N_CAMS = 1_000_000, 1600, 1080, 8
TRAIN_ITERS = 30


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


def pair_counts(rows, tile_start, tile_count, tiles_x, tiles_y, chunk=32):
    """Pixel-instance pairs the kernels' loops visit on these inputs: each
    pixel walks its tile's instances up to and including the one that ends
    it (T (1 - alpha) < 1e-4), or to the tile's end. Returns (visited, with
    power <= 0, with alpha >= 1/255, included)."""
    import torch
    from bags_tpu_torch.raster import tiles as tl

    px, py = tl.tile_pixel_coords(tiles_x, tiles_y, rows.device)
    start, count = tile_start.long(), tile_count.long()
    t_run = torch.ones_like(px)
    done = torch.zeros_like(px, dtype=torch.bool)
    offs = torch.arange(chunk, device=rows.device)
    counts = [0, 0, 0, 0]
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
        for i, m in enumerate((visited, visited & (power <= 0), visited & ok, inc)):
            counts[i] += int(m.sum())
        t_run[act] = t_run[act] * torch.where(inc, 1.0 - a, 1.0).prod(dim=1)
        done[act] |= (kill & visited).any(dim=1)
    return tuple(counts)


def fwd_ops(counts):
    visited, exp, alpha, inc = counts
    return (OPS_VISITED * visited + OPS_EXP * exp + OPS_ALPHA * alpha
            + OPS_COMPOSITED * inc)


def bwd_ops(counts):
    visited, exp, alpha, inc = counts
    return (OPS_VISITED * visited + OPS_EXP * exp + OPS_ALPHA * alpha
            + OPS_BWD_INCLUDED * inc)


def bound(n_bytes, n_ops):
    """(bound ms, what bounds it) on the H100's published peaks."""
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_FP32_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def as_gaussians(sc):
    """A toy scene's activated parameters as Gaussians, all alive."""
    import torch
    from bags_tpu_torch.model.gaussians import Gaussians

    n = sc["xyz"].shape[0]
    op = sc["opacity"]
    return Gaussians(
        xyz=sc["xyz"], sh_dc=sc["sh_coeffs"][:, :1], sh_rest=sc["sh_coeffs"][:, 1:],
        scales_log=torch.log(sc["scales"]), quats=sc["quats"],
        opacity_raw=torch.log(op / (1 - op))), \
        torch.ones(n, dtype=torch.bool, device=op.device)


def test_scenes(device):
    """The three test-size scenes of the kernel checks."""
    import numpy as np
    import torch
    from bags_tpu_torch.utils.testing import make_toy_scene

    dense = make_toy_scene(n=20000, width=32, height=32, seed=5,
                           scale_range=(0.1, 0.4), device=device)
    # Low opacities keep the pixels compositing through > 4096 instances.
    dense["opacity"] = torch.as_tensor(np.random.default_rng(5).uniform(
        0.005, 0.02, 20000).astype(np.float32), device=device)
    return {
        "toy_64x48_700": make_toy_scene(n=700, width=64, height=48,
                                        sh_degree=3, seed=0, device=device),
        "unaligned_spill": make_toy_scene(n=700, width=64, height=48, seed=21,
                                          scale_range=(0.01, 0.05), device=device),
        "dense_tile_gt_4096": dense,
    }


def test_size_checks(device):
    """Both kernels against their plain versions on three small scenes
    (step 3)."""
    import torch
    from bags_tpu_torch.raster import composite
    from bags_tpu_torch.raster.tiles import composite_bwd_plain, composite_tiles_plain

    gen = torch.Generator().manual_seed(0)
    for name, sc in test_scenes(device).items():
        g, alive = as_gaussians(sc)
        rows, bins, tx, ty = frame(g, alive, sc["cam"], sc["static"],
                                   sc["sh_degree"])
        args = (rows, bins.tile_start, bins.tile_count, tx, ty)
        kern = composite.composite_fwd(*args)
        plain = composite_tiles_plain(*args)
        torch.cuda.synchronize()
        err, _ = compare(kern, plain)
        max_tile = int(bins.tile_count.max())
        print(f"test size {name}: instances={bins.n_instances} "
              f"max_tile={max_tile} max_abs_diff={err:.3e}")
        check(err <= TOL_TEST, f"{name}: kernel vs plain {err} > {TOL_TEST}")
        if name == "dense_tile_gt_4096":
            check(max_tile > 4096, f"dense scene max tile {max_tile} <= 4096")

        color, t_final = kern
        g_color = torch.randn(color.shape, generator=gen).to(device)
        g_t = torch.randn(t_final.shape, generator=gen).to(device)
        before = composite.bwd_launches
        d_kern = composite.composite_bwd(*args, g_color, g_t, color, t_final)
        check(composite.bwd_launches == before + 1, f"{name}: no backward launch")
        d_plain = composite_bwd_plain(*args, g_color, g_t, color, t_final)
        # The plain version's own float32 error, against its float64 replay.
        d_f64 = composite_bwd_plain(rows.double(), *args[1:], g_color.double(),
                                    g_t.double(), color.double(), t_final.double())
        err, off, rel_l2 = bwd_agreement(d_kern, d_plain)
        own = float((d_plain.double() - d_f64).abs().max())
        print(f"test size {name} backward: max_abs_diff={err:.3e} max |plain|="
              f"{float(d_plain.abs().max()):.3e}, entries off by > 1e-5 + "
              f"1e-3|plain|: {off}, relative L2 per row <= {max(rel_l2):.2e}; "
              f"plain vs its float64 replay {own:.3e}")
        if name == "dense_tile_gt_4096":
            # ~1,000 low-opacity instances per pixel: the opacity row sums 256
            # pixel terms of size ~1 that cancel to ~1e-3, and float32 moves
            # single entries past 1e-5 (the plain version's own error, just
            # printed), so the full-width criterion holds here.
            check(max(rel_l2) <= 1e-4 and off <= 1e-4 * d_plain.numel(),
                  f"{name}: backward kernel vs plain: relative L2 {rel_l2}, "
                  f"{off} entries off")
        else:
            check(off == 0, f"{name}: {off} backward entries off by more than "
                            f"1e-5 + 1e-3 |plain|")


def bwd_agreement(kern, plain):
    """(max abs diff, entries off by more than 1e-5 + 1e-3 |plain|, relative
    L2 error of each of the 10 rows) of the backward kernel's output against
    the plain version's."""
    import torch

    torch.cuda.synchronize()
    diff = (kern - plain).abs()
    rel_l2 = (torch.linalg.norm(kern - plain, dim=1)
              / torch.linalg.norm(plain, dim=1).clamp_min(1e-30))
    return (float(diff.max()), int((diff > 1e-5 + 1e-3 * plain.abs()).sum()),
            rel_l2.tolist())


def camera_grad_check(device):
    """dq, dt, fovx, fovy gradients of a toy render through both kernels
    against the same computation on the CPU (step 4)."""
    import dataclasses

    import torch
    from bags_tpu_torch.raster.render import RenderConfig, render
    from bags_tpu_torch.utils.testing import make_toy_scene

    grads = {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        sc = make_toy_scene(n=700, width=64, height=48, sh_degree=3, seed=0,
                            device=dev)
        cam = sc["cam"]
        leaves = {"dq": torch.tensor([0.0, 0.01, -0.02, 0.005]),
                  "dt": torch.tensor([0.02, -0.01, 0.03]),
                  "fovx": cam.fovx.cpu(), "fovy": cam.fovy.cpu()}
        leaves = {k: v.to(dev).requires_grad_(True) for k, v in leaves.items()}
        out = render(sc["xyz"], sc["scales"], sc["quats"], sc["opacity"],
                     sc["sh_coeffs"], dataclasses.replace(cam, **leaves),
                     sc["static"], RenderConfig(sh_degree=3),
                     bg=torch.tensor([0.3, 0.6, 0.9], device=dev))
        loss = (torch.mean((out.render - 0.25) ** 2) + 0.1 * out.t_final.mean()
                + 0.01 * out.depth_map.mean())
        grads[where] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    for k, v in grads["cpu"].items():
        got = grads["card"][k].cpu()
        print(f"camera grad {k}: card {got.tolist()} cpu {v.tolist()}")
        check(torch.allclose(got, v, atol=1e-5, rtol=1e-3),
              f"camera gradient {k}: card {got} vs cpu {v}")


def pose_recovery(device):
    """The verify recipe on the card: 80 Adam steps (lr 3e-3) of dq / dt
    recover the pose, loss < 0.02 (step 4). Returns the backward launches."""
    import dataclasses

    import torch
    from bags_tpu_torch.raster import composite
    from bags_tpu_torch.raster.render import RenderConfig, render
    from bags_tpu_torch.utils.testing import make_toy_scene

    sc = make_toy_scene(n=400, width=64, height=64, sh_degree=1, seed=7,
                        device=device)
    cfg = RenderConfig(sh_degree=1)
    args = [sc[k] for k in ("xyz", "scales", "quats", "opacity", "sh_coeffs")]
    with torch.no_grad():
        gt = render(*args, sc["cam"], sc["static"], cfg).render
    p = {"dq": torch.tensor([0.0, 0.02, -0.015, 0.01], device=device),
         "dt": torch.tensor([0.05, -0.04, 0.03], device=device)}
    for v in p.values():
        v.requires_grad_(True)
    opt = torch.optim.Adam(list(p.values()), lr=3e-3)

    def loss_fn():
        out = render(*args, dataclasses.replace(sc["cam"], **p), sc["static"], cfg)
        return torch.mean(torch.abs(out.render - gt))

    before = composite.bwd_launches
    first = None
    for _ in range(80):
        opt.zero_grad()
        loss = loss_fn()
        first = loss.item() if first is None else first
        loss.backward()
        opt.step()
    launched = composite.bwd_launches - before
    with torch.no_grad():
        final = float(loss_fn())
    print(f"pose recovery: loss {first:.5f} -> {final:.5f}, backward launches "
          f"{launched}")
    check(final < 0.02, f"pose recovery: loss {final} >= 0.02")
    check(launched == 80, f"pose recovery: {launched} backward launches != 80")


def write_dataset(device):
    """Full-width PLY model + COLMAP dataset with plain-version GT (step 5).
    points3D holds the model's 1M centres with their DC colours, so that the
    SfM initialisation of training starts from 1M live Gaussians."""
    import numpy as np
    import torch
    from bags_tpu_torch.core.sh import sh_dc_to_rgb
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
    write_colmap_scene(data, cams, WIDTH, HEIGHT, fx, fy, sc["xyz"].cpu().numpy(),
                       sh_dc_to_rgb(sc["sh_coeffs"][:, 0]).cpu().numpy())
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


def render_path(model, data, scene, device):
    """Slice 1's main path, the render CLI on the PLY model, and its checks
    and timings (step 5). Returns the forward kernel's entry of the kernels
    line."""
    import torch
    from bags_tpu_torch.cli import render as render_cli
    from bags_tpu_torch.model.gaussians import load_ply
    from bags_tpu_torch.raster import composite
    from bags_tpu_torch.raster.render import RenderConfig, render
    from bags_tpu_torch.raster.tiles import composite_tiles_plain

    argv = ["-m", model, "-s", data, "--ply_only", "--eval", "--sh_degree", "3",
            "--device", "cuda"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    composite.fwd_launches = composite.bwd_launches = 0
    t0 = time.perf_counter()
    summary = render_cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cli_launches, cli_bwd = composite.fwd_launches, composite.bwd_launches
    psnrs = [v for s in summary.values() for v in s["psnr"]]
    print(f"render CLI: {len(psnrs)} views in {cli_s:.2f} s, kernel launches "
          f"{cli_launches} (backward {cli_bwd}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, PSNR "
          + " ".join(f"{p:.2f}" for p in psnrs))
    check(len(psnrs) >= 8, f"CLI rendered {len(psnrs)} views < 8")
    check(cli_launches == len(psnrs),
          f"{cli_launches} kernel launches for {len(psnrs)} views")
    check(cli_bwd == 0, f"{cli_bwd} backward launches while rendering")
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
        for i, cam in enumerate(cams):
            before = composite.fwd_launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render(*args, cam, scene.static, cfg)
            torch.cuda.synchronize()
            view_ms = (time.perf_counter() - t0) * 1e3
            launched = composite.fwd_launches - before
            rows, bins, tx, ty = frame(g, alive, cam, scene.static, 3)
            k_ms = sync_ms(lambda: composite.composite_fwd(
                rows, bins.tile_start, bins.tile_count, tx, ty), 10)
            print(f"view {i}: instances={bins.n_instances} max_tile="
                  f"{int(bins.tile_count.max())} render_ms={view_ms:.3f} "
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
        counts = pair_counts(rows, bins.tile_start, bins.tile_count, tx, ty)
        num_tiles = tx * ty
        n_bytes = 10 * 4 * bins.n_instances + 2 * 4 * num_tiles \
            + 5 * 4 * 256 * num_tiles
        bound_ms, bound_by = bound(n_bytes, fwd_ops(counts))
        print(f"view 0 forward bound: {n_bytes} bytes, {counts[0]} pair visits, "
              f"{fwd_ops(counts)} FP32 ops -> {bound_ms:.4f} ms ({bound_by}); "
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
        print("render stages_ms " + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    return {"name": "composite_fwd", "route": "cuda",
            "source": "bags_tpu_torch/csrc/composite_fwd.cu",
            "replaces": "bags_tpu/raster/pallas_raster.py:227",
            "launches": None, "launches_by_path": {"render_cli": cli_launches},
            "max_abs_err": err, "max_abs_diff": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def train_path(data):
    """This slice's main path: the train CLI at full width (step 6).
    Returns (model path, forward launches, backward launches)."""
    import math

    import torch
    from bags_tpu_torch.cli import train as train_cli
    from bags_tpu_torch.raster import composite

    model = os.path.join(WORK, "train_model")
    argv = ["-s", data, "-m", model, "--preset", "pose_noise", "--init_type", "sfm",
            "--iterations", str(TRAIN_ITERS), "--densify_from_iter", "10",
            "--densification_interval", "10", "--densify_until_iter", "25",
            "--opacity_reset_interval", "20", "--test_iterations", str(TRAIN_ITERS),
            "--save_iterations", str(TRAIN_ITERS),
            "--checkpoint_iterations", str(TRAIN_ITERS), "--device", "cuda",
            # The densify statistics are screen-space gradients in pixel
            # units, as in the JAX package; at 1600x1080 and this loss the
            # largest mean over a Gaussian's visible steps stays near 2e-7
            # (an H100 run of this script), far under the preset's 2e-4, so
            # the threshold is lowered for the densify step to clone and
            # split at full width within 30 steps.
            "--densify_grad_threshold", "5e-8"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    composite.fwd_launches = composite.bwd_launches = 0
    t0 = time.perf_counter()
    summary = train_cli.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    fwd, bwd = composite.fwd_launches, composite.bwd_launches
    losses, steps = summary["losses"], summary["step_s"]
    print(f"train CLI: {len(losses)} steps in {train_s:.1f} s, forward launches "
          f"{fwd} ({summary['eval_renders']} of them evaluation renders), "
          f"backward launches {bwd}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print("train losses " + " ".join(f"{x:.5f}" for x in losses))
    print("train step_ms " + " ".join(f"{1e3 * x:.1f}" for x in steps))
    print(f"train densify (it, cloned, split, pruned, alive before, after): "
          f"{summary['densify']}")
    check(len(losses) == TRAIN_ITERS, f"{len(losses)} training steps")
    check(bwd == TRAIN_ITERS, f"{bwd} backward launches for {TRAIN_ITERS} steps")
    check(fwd == TRAIN_ITERS + summary["eval_renders"],
          f"{fwd} forward launches for {TRAIN_ITERS} steps and "
          f"{summary['eval_renders']} evaluation renders")
    check(all(math.isfinite(x) for x in losses), "non-finite training loss")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    check(last < first, f"loss did not fall: first 5 {first:.5f}, last 5 {last:.5f}")
    check(summary["densify"], "no densify step ran")
    check(any(d[4] != d[5] for d in summary["densify"]),
          f"densify left the live count as it was: {summary['densify']}")
    check(os.path.exists(os.path.join(model, "point_cloud", f"iteration_{TRAIN_ITERS}",
                                      "point_cloud.ply")), "no PLY written")
    check(os.path.exists(os.path.join(model, f"chkpnt{TRAIN_ITERS}.npz")),
          "no checkpoint written")
    check(summary["eval"], "no evaluation lines")
    return model, fwd, bwd


def restore_path(model, data):
    """The render CLI restores the checkpoint, optimises the test poses and
    renders both splits (step 8)."""
    import math

    import torch
    from bags_tpu_torch.cli import render as render_cli
    from bags_tpu_torch.raster import composite

    composite.fwd_launches = composite.bwd_launches = 0
    t0 = time.perf_counter()
    summary = render_cli.main(["-m", model, "-s", data, "--device", "cuda",
                               "--optim_test_pose_iter", "5"])
    torch.cuda.synchronize()
    psnrs = {k: v["psnr"] for k, v in summary.items()}
    n_views = sum(len(v) for v in psnrs.values())
    print(f"restore: {n_views} views in {time.perf_counter() - t0:.1f} s, PSNR "
          f"{psnrs}, forward launches {composite.fwd_launches}, backward "
          f"launches {composite.bwd_launches}")
    check(sorted(psnrs) == ["test", "train"], f"restore rendered {sorted(psnrs)}")
    check(all(math.isfinite(p) for v in psnrs.values() for p in v),
          "non-finite PSNR after restore")
    n_test = len(psnrs["test"])
    check(composite.bwd_launches == 5 * n_test,
          f"{composite.bwd_launches} backward launches for 5 pose steps of "
          f"{n_test} test views")
    check(os.path.exists(os.path.join(model, "opt_test_cams.npz")),
          "no opt_test_cams.npz")


def backward_full_width(state, scene, device):
    """The backward kernel on a training view of the trained model against
    the plain version; times and bound (step 7). Returns its entry of the
    kernels line."""
    import torch
    from bags_tpu_torch.raster import composite, tiles
    from bags_tpu_torch.raster.tiles import composite_bwd_plain
    from bags_tpu_torch.train.losses import photometric_loss

    g, alive = state.g, state.alive
    bg = torch.zeros(3, device=device)
    with torch.no_grad():
        rows, bins, tx, ty = frame(g, alive, state.cams[0], scene.static, 0)
        args = (rows, bins.tile_start, bins.tile_count, tx, ty)
        color, t_final = composite.composite_fwd(*args)
    c4, tf = color.requires_grad_(True), t_final.requires_grad_(True)
    out = c4.transpose(1, 2)
    img = tiles.tiles_to_image(out[..., :3] + tf[..., None] * bg, tx, ty,
                               scene.static.width, scene.static.height)
    loss = photometric_loss(img, scene.train_image(0))
    g_color, g_t = (x.contiguous() for x in torch.autograd.grad(loss, [c4, tf]))
    color, t_final = color.detach(), t_final.detach()
    bwd_args = (*args, g_color, g_t, color, t_final)
    with torch.no_grad():
        kern = composite.composite_bwd(*bwd_args)
        plain = composite_bwd_plain(*bwd_args)
        err, off, rel_l2 = bwd_agreement(kern, plain)
        print(f"full-width backward: instances={bins.n_instances} "
              f"max_abs_diff={err:.3e} max |plain|={float(plain.abs().max()):.3e} "
              f"entries off by > 1e-5 + 1e-3|plain|: {off} of {plain.numel()}; "
              f"relative L2 per row " + " ".join(f"{x:.2e}" for x in rel_l2))
        check(max(rel_l2) <= 1e-4, f"full width backward: relative L2 {rel_l2} > 1e-4")
        check(off <= 1e-4 * plain.numel(), f"full width backward: {off} entries off")
        kernel_ms = sync_ms(lambda: composite.composite_bwd(*bwd_args), 20)
        plain_ms = sync_ms(lambda: composite_bwd_plain(*bwd_args), 2)
        counts = pair_counts(*args)
        num_tiles = tx * ty
        # rows read and d_rows written (10 floats each per instance), tile
        # ranges, and per pixel g (4), C_total (4), T_final and g_T
        n_bytes = 2 * 10 * 4 * bins.n_instances + 2 * 4 * num_tiles \
            + 10 * 4 * 256 * num_tiles
        bound_ms, bound_by = bound(n_bytes, bwd_ops(counts))
        print(f"full-width backward bound: {n_bytes} bytes, pairs (visited, "
              f"power <= 0, alpha >= 1/255, included) {counts}, "
              f"{bwd_ops(counts)} FP32 ops -> {bound_ms:.4f} ms ({bound_by}); "
              f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.3f} ms")
    return {"name": "composite_bwd", "route": "cuda",
            "source": "bags_tpu_torch/csrc/composite_bwd.cu",
            "replaces": "bags_tpu/raster/pallas_raster.py:334",
            "launches": None, "max_abs_err": err, "max_abs_diff": err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def train_step_stages(state, scene, cfg, device):
    """Where a full-width training step's time goes (step 9): the stages of
    `train_step` run one by one with a synchronise after each, the backward
    kernel timed apart, then `train_step` itself and the peak memory."""
    import dataclasses

    import torch
    from bags_tpu_torch.core.camera import CameraParams
    from bags_tpu_torch.core.projection import project_gaussians
    from bags_tpu_torch.raster import binning, composite, tiles
    from bags_tpu_torch.raster.render import (RenderConfig, build_packet_table,
                                              gather_rows)
    from bags_tpu_torch.train.loop import train_step
    from bags_tpu_torch.train.losses import photometric_loss
    from bags_tpu_torch.train.optim import CAMERA_FIELDS, camera_lrs, row_adam_update

    g, alive, cams = state.g, state.alive, state.cams
    static, idx = scene.static, 0
    gt = scene.train_image(idx)
    bg = torch.zeros(3, device=device)
    rcfg = RenderConfig(sh_degree=0)
    stages = {}
    for rep in range(3):
        torch.cuda.synchronize()
        last = [time.perf_counter()]

        def tick(name):
            torch.cuda.synchronize()
            now = time.perf_counter()
            stages[name] = (now - last[0]) * 1e3
            last[0] = now

        row = {f: getattr(cams, f)[idx].detach().clone().requires_grad_(True)
               for f in CAMERA_FIELDS}
        cam = CameraParams(q_init=cams.q_init[idx], t_init=cams.t_init[idx], **row)
        probe = torch.zeros((state.capacity, 2), device=device, requires_grad=True)
        absp = torch.zeros_like(probe, requires_grad=True)
        proj = project_gaussians(g.xyz, g.scaling(), g.quats, g.opacity(alive),
                                 g.sh_coeffs(), cam, static, 0, align=state.align)
        x2d, y2d = proj.x2d + probe[:, 0], proj.y2d + probe[:, 1]
        tick("projection_sh")
        tx, ty = tiles.tile_grid(static.width, static.height)
        bins = binning.bin_gaussians(
            dataclasses.replace(proj, x2d=x2d, y2d=y2d).detach(), tx, ty)
        tick("binning")
        rows = gather_rows(build_packet_table(proj, x2d, y2d), absp, bins.gauss_id)
        tick("gather")
        color4, t_final = composite.composite_fwd(rows, bins.tile_start,
                                                  bins.tile_count, tx, ty)
        tick("forward_kernel")
        out = color4.transpose(1, 2)
        img = tiles.tiles_to_image(out[..., :3] + t_final[..., None] * bg, tx, ty,
                                   static.width, static.height)
        loss = photometric_loss(img, gt, cfg.opt.lambda_dssim)
        tick("loss")
        state.g_opt.zero_grad()
        loss.backward()
        tick("backward_all")
        state.g_opt.param_groups[0]["lr"] = state.xyz_sched(state.step)
        state.g_opt.step()
        row_adam_update(cams, state.cam_opt, {f: row[f].grad for f in row}, idx,
                        camera_lrs(cfg.calib, state.step))
        tick("optimizer")
    with torch.no_grad():
        g_c = torch.randn_like(color4)
        g_tf = torch.randn_like(t_final)
        bwd_ms = sync_ms(lambda: composite.composite_bwd(
            rows.detach(), bins.tile_start, bins.tile_count, tx, ty, g_c, g_tf,
            color4.detach(), t_final.detach()), 10)
    stages["backward_kernel"] = bwd_ms
    stages["backward_rest"] = stages["backward_all"] - bwd_ms

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        train_step(state, gt, idx, bg, static, rcfg, cfg)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print("train step stages_ms " + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    print(f"train step: {bins.n_instances} instances, {int(alive.sum())} live of "
          f"{state.capacity}; step_ms " + " ".join(f"{x:.2f}" for x in step_ms)
          + f"; peak memory {peak:.2f} GiB")


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False: needs a card")
    if not os.path.isdir(os.path.join(REPO, "bags_tpu_torch")):
        sys.exit("chip_smoke: bags_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, REPO)
    from bags_tpu_torch.cli import render as render_cli
    from bags_tpu_torch.raster import composite

    device = torch.device("cuda")
    t_all = time.perf_counter()
    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. build both kernels, in parallel
    t0 = time.perf_counter()
    sos = composite.build()
    for name, so in sos.items():
        secs, report = composite.build_log.get(name, (0.0, "(built before)"))
        print(f"built {os.path.relpath(so, REPO)} in {secs:.2f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print(f"build wall time {time.perf_counter() - t0:.2f} s")

    # 3. both kernels against their plain versions at test sizes
    test_size_checks(device)
    # 4. camera gradients on the card, pose recovery
    camera_grad_check(device)
    pose_recovery(device)

    # 5. the render path at full width (slice 1)
    shutil.rmtree(WORK, ignore_errors=True)
    t0 = time.perf_counter()
    model, data, scene = write_dataset(device)
    print(f"wrote {N_GAUSS}-Gaussian PLY and {N_CAMS}-camera dataset at "
          f"{WIDTH}x{HEIGHT} in {time.perf_counter() - t0:.1f} s")
    fwd_entry = render_path(model, data, scene, device)
    del scene

    # 6. the training path at full width
    train_model, train_fwd, train_bwd = train_path(data)
    fwd_entry["launches"] = train_fwd
    fwd_entry["launches_by_path"]["train_cli"] = train_fwd

    # 7. the backward kernel at full width on the trained model
    cfg, scene, state, _ = render_cli.restore_trained(train_model, data, -1, device)
    bwd_entry = backward_full_width(state, scene, device)
    bwd_entry["launches"] = train_bwd
    # 8. restore in the render CLI, test-time pose optimisation
    restore_path(train_model, data)
    # 9. where a training step's time goes
    train_step_stages(state, scene, cfg, device)
    del state, scene

    print(f"total {time.perf_counter() - t_all:.1f} s")
    shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"kernels": [fwd_entry, bwd_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
