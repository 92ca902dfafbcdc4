#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (`bags_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card (H100, sm_90a) and nvcc; imports nothing of JAX or of
`bags_tpu`. In order:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the three kernel sources of `bags_tpu_torch/csrc` (the
     compositing forward with its no-exit twin fori, the backward, and the
     profiling tool's ablation kernels; one nvcc per source, in parallel,
     each including `composite_common.cuh`) and prints each build's time and
     ptxas report, and the resident blocks per SM, registers, shared and
     local memory of both compositing kernels, of each ablation mode and of
     each variant of the forward;
  3. holds the forward kernel against its plain PyTorch version at test
     sizes (toy scene, unaligned-spill scene, a tile with > 4096 instances):
     max abs difference <= 2e-5; and the backward kernel against
     `composite_bwd_plain` on the same scenes with seeded random cotangents:
     |kernel - plain| <= 1e-5 + 1e-3 |plain| element-wise, and on the dense
     tile, where float32 rounding alone exceeds that, the full-width
     criterion of step 7 and, beside it, no more entries off the float64
     replay than the plain version's own plus 1e-4 of the entries; two
     backward launches bit-identical; the
     forward and backward kernels on each scene's alpha-edge variant (one
     pair of every instance within 1e-6 relative of 1/255,
     `alpha_boundary_rows`): the forward within 2e-5 of its plain version
     and two launches bit-identical, the backward with the same nonzero
     entries as the plain version and the element-wise criterion; then the
     four ablation kernels against
     `composite_ablate_plain` (`ablation_agreement` states the tolerances)
     on the three scenes and on inputs whose tile ranges cross 128-slot
     chunks and 256-instance batches mid-chunk (`chunk_crossing_rows`),
     the fori kernel and every variant of the forward
     (`kernablate.VARIANTS`) bit-identical to the forward kernel there, and
     fori within 2e-5 of `composite_tiles_plain`;
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
     and the stages of one view; and on view 0 the four ablation kernels
     against their plain versions, their times, bounds and resources, the
     fori kernel and every variant of the forward bit-identical to the
     forward kernel and timed in turns with it, and `tile_order` alone;
  6. the training path at full width: `bags_tpu_torch.cli.train --preset
     pose_noise --init_type sfm` for 30 iterations on that dataset (1M live
     Gaussians at SH 3), densify grad threshold lowered to 5e-8. Checks: one forward and one backward launch per
     step (evaluation renders counted apart), a finite loss that falls
     (mean of the last 5 steps below the first 5), a densify step that
     changes the live count, the PLY and the checkpoint;
  7. the backward kernel at full width on a training view of the trained
     model against `composite_bwd_plain`: relative L2 error of each of the
     10 rows <= 1e-4 and at most 1e-4 of the entries off by more than
     1e-5 + 1e-3 |plain|, two launches bit-identical; its time, the plain
     version's, the bound and its resources; the forward kernel's time and
     bound on the same view, and every variant of the forward bit-identical
     to it and timed in turns with it;
  8. the render CLI restores `chkpnt30.npz` (optimised cameras, no
     `--ply_only`) and renders both splits with `--optim_test_pose_iter 5`;
  9. where a full-width training step's time goes, by stage, the whole
     step's time and the peak device memory;
 10. the profiling tools at their defaults, in-process through their
     `main(argv)` so that the launch counts are read: the profile CLI with
     `--trace` (the trace must name both compositing kernels and every
     stage), `tools.stagebench`, `tools.kernablate` and `tools.kernablate
     real` (fori and every variant identical to the forward kernel); each
     tool must launch its kernels. Then, at the tools' workload (100,000
     Gaussians, 800x800, about 540k instances), every kernel they launch
     against its plain version: the forward and fori kernels at step 5's
     full-width criterion, fori and every variant bit-identical to the
     forward kernel (the variants timed in turns with it), each ablation
     mode as on view 0, and the backward kernel at step 7's criterion,
     bit-identical across two launches;
 11. the fisheye path (slice 4) at full width. First a toy fisheye step
     (lens inverse, warp and crop, vignetting, pupil shift) through both
     kernels on the card against the same step on the CPU: loss and image
     within 2e-5, every gradient within atol 1e-5, rtol 1e-3. Then
     `fish/images` for the 8 views (the plain version's render at the
     extended FoV of `--preset fisheye`, warped through the known lens
     (-0.12, 0.02, 0, 0)) and `fish/sparse/0` (OPENCV_FISHEYE, -0.04),
     and `bags_tpu_torch.cli.train --preset fisheye --init_type sfm` for
     30 iterations (the lens pre-fit's 5,000 steps first; densify threshold
     5e-8 as in step 6). Checks: one forward and one backward launch per
     step, a finite falling loss, the lens parameters changed between the
     checkpoints after steps 1 and 30, the checkpoint's lens leaves, the
     render CLI restoring the model and writing lens-warped pairs against
     the fisheye GT (one launch a view), the Newton inverse's residual on
     the trained lens's control points <= 1e-4, and both kernels on the
     extended-FoV render against their plain versions (step 5's and step
     7's full-width criteria). Prints the pre-fit's seconds, the flow error
     against the known lens after steps 1 and 30, the render's instances
     and the kernels' times and bounds on it, one step split by stage
     (`tools/stagebench.fisheye_step_stages`, with a profiler trace), the
     step's ms, the peak memory, and a trace of ten pre-fit steps;
 12. the cubemap path (slice 4) at full width. First a toy cubemap step
     (five renders sorted by distance, the cubemap net's ray field, five
     warps) through both kernels on the card against the same step on the
     CPU: loss and forward face within 2e-5, every gradient within atol
     1e-5, rtol 1e-3, 5 forward and 5 backward launches. Then a dataset
     `cube/` at 1600x1080 (the step-5 model's 1M centres, 8 cameras inside
     the Gaussian box near (0, 0, 6), focal 800): each camera's five faces
     rendered by the plain version, warped through a full-size cubemap net
     that `init_cubemap_net` fits on the card to the known lens, stitched by
     maximum intensity and masked to the disc of radius 512 (each face's
     instances printed; a side face that renders nothing fails), and
     `bags_tpu_torch.cli.train --preset cubemap --init_type sfm` for 30
     iterations (densify threshold 5e-8 as in step 6). Checks: 5 forward
     and 5 backward launches per step (evaluation renders counted apart), a
     finite falling loss, the cubemap net changed between the checkpoints
     after steps 1 and 30, the checkpoint's cubemap leaves, the render CLI
     restoring the model (plain views, one launch a view), and both kernels
     on train view 0's forward and left faces against their plain versions
     (step 5's and step 7's full-width criteria), with their times, bounds
     and instances; then the step split by stage
     (`tools/stagebench.cubemap_step_stages`, with a profiler trace), the
     step's ms over 5 steps and the peak memory;
 13. known-lens recovery: the port's `tools/lens_recovery.py` in-process
     (600 pre-fit steps, 500 iterations at lens lr 3e-5, 400x400, 20,000
     Gaussians, 12 cameras). Checks the JAX tool's JSON keys, finite
     values, one backward launch an iteration and a flow error that falls;
     prints its JSON line;
 14. slice 5, MCMC and the hybrid specular colour: (a) the toy pose
     step with `--hybrid` and the MCMC regularisers and the toy fisheye
     step with `--hybrid` through both kernels against the CPU (step 11's
     criteria, the ASG features and the specular weights among the
     gradients), and `relocate_dead`, `add_new_gaussians` and
     `position_noise` with the same injected draws on the card and the CPU
     (counts, alive and reset masks identical, every relocated float
     within 1e-6 of itself, each noised position, from the CPU's
     population on both, within 1e-6 of its rounding scale);
     (b) the main path, `bags_tpu_torch.cli.train --preset fisheye_mcmc
     --hybrid --init_type sfm` for 30 iterations on step 11's dataset
     (the lens pre-fit's 5,000 steps first; relocations at iterations 10
     and 20): one forward and one backward launch a step, a finite falling
     loss, two relocations each growing the live count N to exactly
     int(float32(1.005) float32(N)), the checkpoint's ASG, specular and
     specular-Adam leaves, the specular weights and ASG features changed
     between the checkpoints after steps 1 and 30, the render CLI's
     restore writing lens-warped pairs (one launch a view); (c) on the
     trained state, a seeded 1 % of the live slots set to raw opacity -10
     and `mcmc_step`: that many relocated, each moved row its source's,
     the merged opacities and scales `compute_relocation`'s, the Adam
     moments zero on the reset rows, the step's ms; (e) that state's
     fisheye step split by stage (`stagebench.fisheye_step_stages`, with
     a trace: the specular colour's forward and backward, `mcmc_step`,
     `mcmc_noise_step`, the step over 5 steps, the peak memory, the
     device-busy share and the launches); (d) `cli.train --preset
     pose_noise --init_type sfm --mcmc --hybrid` for 30 iterations on step
     5's dataset (the only mode with the MCMC regularisers) with (b)'s
     checks but the falling loss, and the render CLI's restore, one launch
     a view, finite PSNR; then that model's pose step split by stage
     (`stagebench.train_step_stages`: the specular colour, the
     regularisers, the specular colour's forward and backward alone,
     `mcmc_step`, `mcmc_noise_step`, the step over 5 steps, the peak
     memory), beside step 9's split of the plain pose step;
 15. slice 5's evaluation tools, on the models steps 6, 8 and 14b left:
     (a) the trajectory CLI on step 6's model, restored once: sequential
     (one frame per optimised train camera), spiral (4 frames) and a
     150-degree panorama (2 poses): one forward launch a frame (five a
     panorama frame), no backward launch, frames 1600x1080 and finite,
     and the sequential frame 0 against `render` at the optimised camera
     0 (at most 1e-4 of its 8-bit values more than one level off); (b) 4
     orbit frames of step 14b's `fisheye_mcmc --hybrid` model through the
     lens warp with the specular colour, at the fisheye sensor's size;
     (c) the network viewer on a free local port: a client's two SIBR
     requests at 1600x1080, one forward launch each, each frame's bytes
     equal to the train CLI's `viewer_render` at its camera; (d) the
     metrics CLI over step 8's renders with seeded full-width LPIPS
     weights (torchvision vgg16 and LPIPS layouts): the JAX CLI's keys,
     finite values, one view's LPIPS on the card against the CPU on a
     256x256 crop (rtol 1e-4), its time at 1600x1080, and `plot_poses`
     run or skipped where matplotlib is absent; (e) `cli.bench` (default
     and `--large`) and `cli.bench_calib` (both modes): one JSON line
     each, one forward and one backward launch a step, pixels/s beside
     the card's name and power limit; then every step's seconds;
 16. prints the kernels line (JSON: the forward, the backward, the
     ablation kernel with every mode's numbers and resources, fori with
     every variant's under "variants"; the forward's and the backward's
     launches by path, fisheye, cubemap, recovery and slice 5's paths
     included, and their numbers on the extended-FoV render and the
     cubemap faces) and, last, the device line (JSON).
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

TOL_TEST = 2e-5
N_GAUSS, WIDTH, HEIGHT, N_CAMS = 1_000_000, 1600, 1080, 8
TRAIN_ITERS = 30


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def frame(g, alive, cam, static, sh_degree, timer=None, sort_by_distance=False):
    """Projection, binning and gather of one view, as `render()` runs them
    (with sort_by_distance, each tile's instances in order of distance to
    the camera, as the cubemap mode's renders sort them). timer(name) is
    called after each stage."""
    from bags_tpu_torch.core.projection import distance_to_camera, project_gaussians
    from bags_tpu_torch.raster import binning, tiles
    from bags_tpu_torch.raster.render import build_packet_table

    tick = timer or (lambda name: None)
    proj = project_gaussians(g.xyz, g.scaling(), g.quats, g.opacity(alive),
                             g.sh_coeffs(), cam, static, sh_degree)
    tick("projection")
    tiles_x, tiles_y = tiles.tile_grid(static.width, static.height)
    bins = binning.bin_gaussians(proj, tiles_x, tiles_y, sort_key_depth=(
        distance_to_camera(g.xyz, cam) if sort_by_distance else None))
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


def fwd_agreement(label, kern, plain):
    """The full-width criterion of a forward-like kernel against
    `composite_tiles_plain`: max abs difference <= 1e-3 and at most 1e-4 of
    the pixels off by more than 2e-5. Returns the max abs difference."""
    import torch

    torch.cuda.synchronize()
    err, pix = compare(kern, plain)
    frac = float((pix > 2e-5).float().mean())
    print(f"{label} kernel vs plain: max_abs_diff={err:.3e}, "
          f"share of pixels off by > 2e-5: {frac:.3e}")
    check(err <= 1e-3, f"{label}: max abs diff {err} > 1e-3")
    check(frac <= 1e-4, f"{label}: {frac} of pixels off by > 2e-5")
    return err


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
        same = torch.equal(d_kern, composite.composite_bwd(*args, g_color, g_t,
                                                           color, t_final))
        own, own_off, own_l2 = bwd_agreement(d_plain.double(), d_f64)
        _, kern_off, kern_l2 = bwd_agreement(d_kern.double(), d_f64)
        print(f"test size {name} backward: max_abs_diff={err:.3e} max |plain|="
              f"{float(d_plain.abs().max()):.3e}, entries off by > 1e-5 + "
              f"1e-3|plain|: {off} of {d_plain.numel()}, relative L2 per row <= "
              f"{max(rel_l2):.2e}; against the plain version's float64 replay "
              f"(same criterion): plain max_abs_diff={own:.3e}, {own_off} off, "
              f"relative L2 <= {max(own_l2):.2e}; kernel {kern_off} off, "
              f"relative L2 <= {max(kern_l2):.2e}; two launches bit-identical: "
              f"{same}")
        check(same, f"{name}: two backward launches differ")
        if name == "dense_tile_gt_4096":
            # ~1,000 low-opacity instances per pixel: the opacity row sums 256
            # pixel terms of size ~1 that cancel to ~1e-3, and float32 moves
            # single entries past 1e-5 (the plain version's own error against
            # its float64 replay, just printed), so the full-width criterion
            # holds here: at most 1e-4 of the entries off.
            check(max(rel_l2) <= 1e-4 and off <= 1e-4 * d_plain.numel(),
                  f"{name}: backward kernel vs plain: relative L2 {rel_l2}, "
                  f"{off} entries off")
            # Beside it, a gate that separates rounding from a fault: against
            # the float64 replay the kernel may be off in no more entries
            # than the plain version's own float32 computation is, plus a
            # margin of 1e-4 of the entries (31.8 here, the count the check
            # above allows): over 18 cotangent draws the plain version was
            # 0-40 entries off the replay, and a fault in the kernel moves
            # whole rows, far past that.
            margin = 1e-4 * d_plain.numel()
            print(f"test size {name} backward against the float64 replay: "
                  f"kernel {kern_off} entries off, plain {own_off}, margin "
                  f"{margin:.1f}")
            check(kern_off <= own_off + margin,
                  f"{name}: backward kernel {kern_off} entries off the float64 "
                  f"replay, plain {own_off} + margin {margin:.1f}")
        else:
            check(off == 0, f"{name}: {off} backward entries off by more than "
                            f"1e-5 + 1e-3 |plain|")
        alpha_edge_check(name, args, device)


def alpha_edge_check(name, args, device):
    """Both kernels on `args` with opacities that put one pair of every
    instance within 1e-6 relative of 1/255 (`alpha_boundary_rows`; step 3):
    the forward within 2e-5 of `composite_tiles_plain` (a pair its exp skip
    or footprint cull dropped wrongly would move the pixel by about 1/255)
    and two launches bit-identical; the backward's nonzero entries exactly
    the plain version's (a wrongly dropped pair would leave a zero where the
    plain version has a value), every entry within 1e-5 + 1e-3 |plain|."""
    import torch
    from bags_tpu_torch.raster import composite
    from bags_tpu_torch.raster.tiles import (ALPHA_MIN, composite_bwd_plain,
                                             composite_tiles_plain)
    from bags_tpu_torch.utils.testing import alpha_boundary_rows

    gen = torch.Generator().manual_seed(1)
    rows, alpha = alpha_boundary_rows(*args)
    above = int(((alpha >= ALPHA_MIN) & (alpha <= ALPHA_MIN * (1 + 1e-6))).sum())
    below = int(((alpha < ALPHA_MIN) & (alpha >= ALPHA_MIN * (1 - 1e-6))).sum())
    edge = (rows, *args[1:])
    color, t_final = composite.composite_fwd(*edge)
    fwd_err, _ = compare((color, t_final), composite_tiles_plain(*edge))
    again = composite.composite_fwd(*edge)
    fwd_same = torch.equal(color, again[0]) and torch.equal(t_final, again[1])
    print(f"test size {name} alpha edge forward: max_abs_diff={fwd_err:.3e}, "
          f"two launches bit-identical: {fwd_same}")
    check(fwd_err <= TOL_TEST, f"{name} alpha edge: forward vs plain {fwd_err} "
                               f"> {TOL_TEST}")
    check(fwd_same, f"{name} alpha edge: two forward launches differ")
    g_color = torch.randn(color.shape, generator=gen).to(device)
    g_t = torch.randn(t_final.shape, generator=gen).to(device)
    kern = composite.composite_bwd(*edge, g_color, g_t, color, t_final)
    plain = composite_bwd_plain(*edge, g_color, g_t, color, t_final)
    err, off, _ = bwd_agreement(kern, plain)
    same_zeros = torch.equal(kern != 0, plain != 0)
    print(f"test size {name} alpha edge: edge pairs within 1e-6 of 1/255: "
          f"{above} above, {below} below; nonzero entries kernel "
          f"{int((kern != 0).sum())} plain {int((plain != 0).sum())}, same set: "
          f"{same_zeros}; max_abs_diff={err:.3e}, entries off: {off}")
    check(min(above, below) >= 0.2 * rows.shape[1],
          f"{name} alpha edge: {above} / {below} edge pairs")
    check(same_zeros, f"{name} alpha edge: nonzero sets differ")
    check(off == 0, f"{name} alpha edge: {off} entries off")


def ablation_agreement(label, mode, kern, plain, full_width):
    """Check an ablation kernel's output against its plain version and
    return the max abs difference. t is exactly 1 in both, and
    no_transcendental's colour exactly 0 in both. At test sizes: dma_only
    within 1e-6 of max |plain| (its weight, power, is unbounded), no_scan
    and full within 2e-5. At full width, where a pixel may sum dozens of
    128-slot chunks into values past the range those were set for:
    element-wise within 2e-5 + 1e-5 |plain|. Every term of a pixel's sum
    has one sign, so the kernel's sequential order and the plain version's
    batched one differ by a few float32 ulps of the sum."""
    import torch

    (kc, kt), (pc, pt) = kern, plain
    torch.cuda.synchronize()
    diff = (kc - pc).abs()
    err, top = float(diff.max()), float(pc.abs().max())
    off = int((diff > 2e-5 + 1e-5 * pc.abs()).sum())
    t_one = bool((kt == 1).all()) and bool((pt == 1).all())
    print(f"{label} {mode}: max_abs_diff={err:.3e} max|plain|={top:.4e} "
          f"entries off by > 2e-5 + 1e-5|plain|: {off}; t == 1 everywhere: {t_one}")
    check(t_one, f"{label} {mode}: t is not exactly 1")
    if mode == "no_transcendental":
        check(top == 0.0 and float(kc.abs().max()) == 0.0,
              f"{label} {mode}: colour is not exactly 0")
    elif full_width:
        check(off == 0, f"{label} {mode}: {off} entries off")
    elif mode == "dma_only":
        check(err <= 1e-6 * top, f"{label} {mode}: {err} > 1e-6 x {top}")
    else:
        check(err <= TOL_TEST, f"{label} {mode}: {err} > {TOL_TEST}")
    return err


def variant_checks(label, args, turns=False):
    """Each variant of the forward (`kernablate.VARIANTS`) against the
    forward kernel on `args`: `torch.equal` on colour and t. With `turns`,
    each variant and the forward timed in turns (variant, forward, forward,
    variant; 20 reps each) and `tile_order` alone. Returns {variant:
    {"identical": {label: bool}[, "ms", "composite_fwd_ms",
    "tile_order_ms"]}}."""
    import torch
    from bags_tpu_torch.raster import composite
    from bags_tpu_torch.tools import kernablate as ka
    from bags_tpu_torch.utils.profiling import timed

    out = {}
    with torch.no_grad():
        want = composite.composite_fwd(*args)
        for name in ka.VARIANTS:
            before = ka.launches[name]
            got = ka.composite_fwd_variant(*args, name)
            check(ka.launches[name] == before + 1, f"{label} {name}: no launch")
            same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            print(f"{label} variant {name}: bit-identical to composite_fwd: {same}")
            check(same, f"{label}: variant {name} differs from the forward kernel")
            out[name] = {"identical": {label: same}}
            if not turns:
                continue
            times = {name: [], "fwd": []}
            for which in (name, "fwd", "fwd", name):
                fn = (composite.composite_fwd if which == "fwd" else
                      lambda *a: ka.composite_fwd_variant(*a, name))
                times[which].append(timed(lambda: fn(*args), "cuda", 20))
            out[name].update(ms=sum(times[name]) / 2,
                             composite_fwd_ms=sum(times["fwd"]) / 2)
            print(f"{label} variant {name}: ms {times[name]} vs composite_fwd ms "
                  f"{times['fwd']} (in turns)")
        if turns:
            order_ms = timed(lambda: composite.tile_order(args[2]), "cuda", 20)
            out["index_order"]["tile_order_ms"] = order_ms
            print(f"{label} tile_order alone: {order_ms:.4f} ms")
    return out


def merge_variants(into, part, suffix=""):
    """Merge `variant_checks`' result `part` into `into`, its timings under
    keys with `suffix`."""
    for name, res in part.items():
        entry = into.setdefault(name, {"identical": {}})
        entry["identical"].update(res["identical"])
        entry.update({k + suffix: v for k, v in res.items() if k != "identical"})


def ablation_test_size(device):
    """The four ablation kernels and fori against their plain versions on
    the three test scenes and the chunk-crossing inputs
    (`chunk_crossing_rows`), fori and every variant of the forward
    bit-identical to the forward kernel (step 3). Returns the variants'
    `variant_checks`."""
    import torch
    from bags_tpu_torch.raster import composite
    from bags_tpu_torch.raster.tiles import composite_tiles_plain
    from bags_tpu_torch.tools import kernablate as ka
    from bags_tpu_torch.utils.testing import chunk_crossing_rows

    inputs = {}
    for name, sc in test_scenes(device).items():
        g, alive = as_gaussians(sc)
        rows, bins, tx, ty = frame(g, alive, sc["cam"], sc["static"],
                                   sc["sh_degree"])
        inputs[name] = (rows, bins.tile_start, bins.tile_count, tx, ty)
    inputs["chunk_crossing"] = chunk_crossing_rows(device)
    variants = {}
    for name, args in inputs.items():
        for mode in ka.MODES:
            before = ka.launches[mode]
            kern = ka.composite_ablate(*args, mode)
            check(ka.launches[mode] == before + 1, f"{name} {mode}: no launch")
            # chunk_crossing: a pixel sums up to nine chunks (the
            # full-width criterion)
            ablation_agreement(f"test size {name}", mode, kern,
                               ka.composite_ablate_plain(*args, mode),
                               full_width=name == "chunk_crossing")
        merge_variants(variants, variant_checks(f"test size {name}", args))
        fori = ka.composite_fwd_fori(*args)
        fwd = composite.composite_fwd(*args)
        err, _ = compare(fori, composite_tiles_plain(*args))
        same = torch.equal(fori[0], fwd[0]) and torch.equal(fori[1], fwd[1])
        print(f"test size {name} fori: max_abs_diff vs plain={err:.3e}, "
              f"bit-identical to composite_fwd: {same}")
        check(same, f"{name}: fori differs from the forward kernel")
        check(err <= TOL_TEST, f"{name}: fori vs plain {err} > {TOL_TEST}")
    return variants


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


def loss_cotangents(args, static, gt):
    """The backward kernel's inputs for `args`: the forward kernel's output
    and the photometric loss's cotangents of it against `gt`, as a
    training step (no background) gives them."""
    import torch
    from bags_tpu_torch.raster import composite, tiles
    from bags_tpu_torch.train.losses import photometric_loss

    with torch.no_grad():
        color, t_final = composite.composite_fwd(*args)
    c4 = color.requires_grad_(True)
    img = tiles.tiles_to_image(c4.transpose(1, 2)[..., :3], args[3], args[4],
                               static.width, static.height)
    g_color = torch.autograd.grad(photometric_loss(img, gt), c4)[0].contiguous()
    return (*args, g_color, torch.zeros_like(t_final), color.detach(), t_final)


def bwd_full_width_check(label, bwd_args):
    """The backward kernel against `composite_bwd_plain` at the full-width
    criterion: relative L2 error of each of the 10 rows <= 1e-4 and at most
    1e-4 of the entries off by more than 1e-5 + 1e-3 |plain|; and two
    launches bit-identical. Returns the max abs difference."""
    import torch
    from bags_tpu_torch.raster import composite
    from bags_tpu_torch.raster.tiles import composite_bwd_plain

    kern = composite.composite_bwd(*bwd_args)
    plain = composite_bwd_plain(*bwd_args)
    err, off, rel_l2 = bwd_agreement(kern, plain)
    same = torch.equal(kern, composite.composite_bwd(*bwd_args))
    print(f"{label}: instances={bwd_args[0].shape[1]} max_abs_diff={err:.3e} "
          f"max |plain|={float(plain.abs().max()):.3e} entries off by > "
          f"1e-5 + 1e-3|plain|: {off} of {plain.numel()}; relative L2 per row "
          + " ".join(f"{x:.2e}" for x in rel_l2)
          + f"; two launches bit-identical: {same}")
    check(max(rel_l2) <= 1e-4, f"{label}: relative L2 {rel_l2} > 1e-4")
    check(off <= 1e-4 * plain.numel(), f"{label}: {off} entries off")
    check(same, f"{label}: two launches differ")
    return err


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
    line and view 0's compositing inputs."""
    import torch
    from bags_tpu_torch.cli import render as render_cli
    from bags_tpu_torch.model.gaussians import load_ply
    from bags_tpu_torch.raster import composite
    from bags_tpu_torch.raster.render import RenderConfig, render
    from bags_tpu_torch.raster.tiles import composite_tiles_plain
    from bags_tpu_torch.utils.profiling import (bound, fwd_bytes, fwd_ops,
                                                pair_counts, timed)

    argv =["-m", model, "-s", data, "--ply_only", "--eval", "--sh_degree", "3",
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
            k_ms = timed(lambda: composite.composite_fwd(
                rows, bins.tile_start, bins.tile_count, tx, ty), device, 10)
            print(f"view {i}: instances={bins.n_instances} max_tile="
                  f"{int(bins.tile_count.max())} render_ms={view_ms:.3f} "
                  f"kernel_ms={k_ms:.4f} launches={launched}")
            check(launched == 1, f"view {i}: {launched} launches")
            del out

        # float comparison and plain / bound on view 0
        rows, bins, tx, ty = frame(g, alive, cams[0], scene.static, 3)
        kern = composite.composite_fwd(rows, bins.tile_start, bins.tile_count, tx, ty)
        plain = composite_tiles_plain(rows, bins.tile_start, bins.tile_count, tx, ty)
        err = fwd_agreement("view 0", kern, plain)
        del kern, plain
        kernel_ms = timed(lambda: composite.composite_fwd(
            rows, bins.tile_start, bins.tile_count, tx, ty), device, 20)
        plain_ms = timed(lambda: composite_tiles_plain(
            rows, bins.tile_start, bins.tile_count, tx, ty), device, 3)
        counts = pair_counts(rows, bins.tile_start, bins.tile_count, tx, ty)
        n_bytes = fwd_bytes(bins.n_instances, tx * ty)
        bound_ms, bound_by = bound(n_bytes, fwd_ops(counts))
        print(f"view 0 forward bound: {n_bytes} bytes, pairs {counts}, "
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
    view0 = (rows, bins.tile_start, bins.tile_count, tx, ty)
    return view0, {"name": "composite_fwd", "route": "cuda",
            "design": "footprint-culled ballot-word walk, 8x4 warps",
            "source": "bags_tpu_torch/csrc/composite_fwd.cu",
            "replaces": "bags_tpu/raster/pallas_raster.py:227",
            "launches": None, "launches_by_path": {"render_cli": cli_launches},
            "max_abs_err": err, "max_abs_diff": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def ablation_full_width(view0, fwd_entry):
    """The four ablation kernels and fori on view 0 of the render path:
    each against its plain version, its time, the plain version's, its
    bound and its resources; fori and every variant of the forward
    bit-identical to the forward kernel and timed beside it, in turns, and
    `tile_order` alone (step 5). Returns the kernels line's entries of the
    ablation kernel (mode "full" in the headline numbers, every mode under
    "modes") and of fori (the variants under "variants")."""
    import torch
    from bags_tpu_torch.raster import composite
    from bags_tpu_torch.raster.tiles import composite_tiles_plain
    from bags_tpu_torch.tools import kernablate as ka
    from bags_tpu_torch.utils.profiling import (ablate_ops, bound, fwd_bytes,
                                                pair_counts, timed)

    rows, _, _, tx, ty = view0
    n_bytes = fwd_bytes(rows.shape[1], tx * ty)
    counts = pair_counts(*view0, terminate=False)
    # o >= 0 and power <= 0 make no_transcendental's alpha, o power, < 1/255
    # on every pair: it accepts none.
    check(float(rows[5].min()) >= 0.0, "negative opacity in view 0")
    print(f"view 0 ablation pairs (visited, power <= 0, alpha >= 1/255): {counts}")
    modes = {}
    with torch.no_grad():
        for mode in ka.MODES:
            err = ablation_agreement("view 0", mode, ka.composite_ablate(*view0, mode),
                                     ka.composite_ablate_plain(*view0, mode),
                                     full_width=True)
            ms = timed(lambda: ka.composite_ablate(*view0, mode), "cuda", 20)
            plain_ms = timed(lambda: ka.composite_ablate_plain(*view0, mode),
                             "cuda", 3)
            ops = ablate_ops(counts, mode,
                             accepted=0 if mode == "no_transcendental" else None)
            bound_ms, bound_by = bound(n_bytes, ops)
            info = ka.kernel_info(mode)
            modes[mode] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bound_by": bound_by, **info}
            print(f"view 0 {mode}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by}; {n_bytes} bytes, {ops} "
                  f"ops); {info}")
        fori = ka.composite_fwd_fori(*view0)
        fwd = composite.composite_fwd(*view0)
        same = torch.equal(fori[0], fwd[0]) and torch.equal(fori[1], fwd[1])
        check(same, "view 0: fori differs from the forward kernel")
        fori_err = fwd_agreement("view 0 fori", fori, composite_tiles_plain(*view0))
        del fori, fwd
        plain_ms = timed(lambda: composite_tiles_plain(*view0), "cuda", 3)
        times = {"fwd": [], "fori": []}
        for which in ("fwd", "fori", "fori", "fwd"):
            fn = composite.composite_fwd if which == "fwd" else ka.composite_fwd_fori
            times[which].append(timed(lambda: fn(*view0), "cuda", 20))
    variants = {}
    merge_variants(variants, variant_checks("view 0", view0, turns=True))
    for name, res in variants.items():
        res.update(bound_ms=fwd_entry["bound_ms"], bound_by=fwd_entry["bound_by"],
                   **ka.kernel_info(name))
    fori_ms = sum(times["fori"]) / 2
    print(f"view 0 fori: bit-identical to composite_fwd: {same}; fori ms "
          f"{times['fori']} vs composite_fwd ms {times['fwd']} (in turns); "
          f"plain {plain_ms:.3f} ms")
    ablate = {"name": "composite_ablate", "route": "cuda",
              "source": "bags_tpu_torch/csrc/composite_ablate.cu",
              "replaces": "tools/kernablate.py:46", "launches": None,
              "headline_mode": "full", **modes["full"], "library_ms": None,
              "modes": modes}
    # fori computes the forward's function bit for bit (checked above), so
    # its bound is the forward's on the same inputs.
    fori_entry = {"name": "composite_fwd_fori", "route": "cuda",
                  "source": "bags_tpu_torch/csrc/composite_fwd.cu",
                  "replaces": "tools/kernablate.py:181", "launches": None,
                  "max_abs_err": fori_err,
                  "identical_to_composite_fwd": same, "ms": fori_ms,
                  "composite_fwd_ms": sum(times["fwd"]) / 2,
                  "plain_ms": plain_ms, "bound_ms": fwd_entry["bound_ms"],
                  "bound_by": fwd_entry["bound_by"],
                  "bound_from": "composite_fwd (the same function and inputs)",
                  "library_ms": None, "variants": variants}
    return ablate, fori_entry


def tools_workload_checks(device):
    """Every kernel the tools launch, held against its plain version at the
    tools' own workload (their default flags; step 10): the forward and
    fori kernels against `composite_tiles_plain` and the backward kernel
    against `composite_bwd_plain` (with the cotangents of the profiled
    step's loss against its zero GT) at the full-width criteria, fori and
    every variant of the forward bit for bit against the forward kernel
    (the variants also timed in turns with it), and each ablation mode
    against `composite_ablate_plain` as at full width. Returns {kernel entry
    name: max abs difference}, the ablation modes under
    "composite_ablate:<mode>", and the variants' `variant_checks` under
    "variants"."""
    import torch
    from bags_tpu_torch.cli import profile as profile_cli
    from bags_tpu_torch.raster import composite
    from bags_tpu_torch.raster.tiles import composite_tiles_plain
    from bags_tpu_torch.tools import kernablate as ka
    from bags_tpu_torch.utils.profiling import toy_workload

    flags = profile_cli.parse_args([])
    sc, _, bins, rows, tx, ty = toy_workload(flags.n, flags.size,
                                             flags.max_instances, device)
    args = (rows, bins.tile_start, bins.tile_count, tx, ty)
    label = f"tools' workload ({bins.n_instances} instances, {tx * ty} tiles)"
    errs = {}
    with torch.no_grad():
        plain = composite_tiles_plain(*args)
        fwd = composite.composite_fwd(*args)
        errs["composite_fwd"] = fwd_agreement(f"{label} composite_fwd", fwd, plain)
        fori = ka.composite_fwd_fori(*args)
        errs["composite_fwd_fori"] = fwd_agreement(f"{label} fori", fori, plain)
        check(torch.equal(fori[0], fwd[0]) and torch.equal(fori[1], fwd[1]),
              f"{label}: fori differs from the forward kernel")
        del plain, fwd, fori
        errs["variants"] = variant_checks("tools' workload", args, turns=True)
        for mode in ka.MODES:
            errs[f"composite_ablate:{mode}"] = ablation_agreement(
                label, mode, ka.composite_ablate(*args, mode),
                ka.composite_ablate_plain(*args, mode), full_width=True)
    gt = torch.zeros((3, flags.size, flags.size), device=device)
    bwd_args = loss_cotangents(args, sc["static"], gt)
    with torch.no_grad():
        errs["composite_bwd"] = bwd_full_width_check(f"{label} backward", bwd_args)
    return errs


def tools_path(device):
    """This slice's main path: the profiling tools at their defaults, each
    with every launch count set to 0 just before it and read just after
    (step 10): the profile CLI with a trace, stagebench, kernablate and
    kernablate real. Checks that each tool launched its kernels, that the
    profiled step is finite and that the trace names both compositing
    kernels and every stage. Returns {tool: launch counts}."""
    import math

    import torch
    from bags_tpu_torch.cli import profile as profile_cli
    from bags_tpu_torch.raster import composite
    from bags_tpu_torch.tools import kernablate as ka
    from bags_tpu_torch.tools import stagebench

    runs = {"profile": (profile_cli.main, ["--trace", os.path.join(WORK, "trace")]),
            "stagebench": (stagebench.main, []),
            "kernablate": (ka.main, []),
            "kernablate_real": (ka.main, ["real"])}
    launches, results = {}, {}
    for tool, (fn, argv) in runs.items():
        composite.fwd_launches = composite.bwd_launches = 0
        ka.launches.update({k: 0 for k in ka.launches})
        print(f"--- {tool} {' '.join(argv)}")
        t0 = time.perf_counter()
        results[tool] = fn(argv)
        torch.cuda.synchronize()
        launches[tool] = {"composite_fwd": composite.fwd_launches,
                          "composite_bwd": composite.bwd_launches,
                          **{("composite_fwd_fori" if k == "fori" else
                              f"composite_fwd_variant:{k}" if k in ka.VARIANTS
                              else f"composite_ablate:{k}"): v
                             for k, v in ka.launches.items()}}
        print(f"{tool}: {time.perf_counter() - t0:.1f} s, launches {launches[tool]}")
    for tool in ("profile", "stagebench"):
        check(launches[tool]["composite_fwd"] > 0 and launches[tool]["composite_bwd"] > 0,
              f"{tool}: launches {launches[tool]}")
    for mode in ka.MODES:
        check(launches["kernablate"][f"composite_ablate:{mode}"] > 0,
              f"kernablate: {mode} not launched")
    real_launches = launches["kernablate_real"]
    check(real_launches["composite_fwd_fori"] > 0 and real_launches["composite_fwd"] > 0
          and all(real_launches[f"composite_fwd_variant:{v}"] > 0 for v in ka.VARIANTS),
          f"kernablate real: launches {real_launches}")
    real = results["kernablate_real"]
    check(real["dcolor"] == 0.0 and real["dt"] == 0.0,
          f"kernablate real: fori or a variant differs from the forward kernel: {real}")
    prof = results["profile"]
    check(math.isfinite(float(prof["loss"]))
          and all(bool(torch.isfinite(g).all()) for g in prof["grads"]),
          "profile: non-finite loss or gradient")
    check(all(math.isfinite(v) for k, v in results["stagebench"].items()),
          "stagebench: non-finite time")

    trace = prof["trace_summary"]
    for k in ("composite_fwd_kernel", "composite_bwd_kernel"):
        check(any(k in n for n in trace["kernel_ms"]),
              f"trace: no {k} among {len(trace['kernel_ms'])} kernels")
    for stage in stagebench.STAGES:
        check(f"step/{stage}" in trace["stages"], f"trace: no step/{stage} label")
    return launches


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
    the plain version, twice bit for bit; its time, the plain version's, the
    bound and the kernel's resources; and the forward kernel's time and
    bound on the same view (step 7). Returns the backward's entry of the
    kernels line and the forward's numbers on this view."""
    import torch
    from bags_tpu_torch.raster import composite
    from bags_tpu_torch.raster.tiles import composite_bwd_plain
    from bags_tpu_torch.utils.profiling import (bound, bwd_bytes, bwd_ops, fwd_bytes,
                                                fwd_ops, pair_counts, timed)

    with torch.no_grad():
        rows, bins, tx, ty = frame(state.g, state.alive, state.cams[0],
                                   scene.static, 0)
    args = (rows, bins.tile_start, bins.tile_count, tx, ty)
    bwd_args = loss_cotangents(args, scene.static, scene.train_image(0))
    info = composite.kernel_info("composite_bwd")
    with torch.no_grad():
        err = bwd_full_width_check("full-width backward", bwd_args)
        kernel_ms = timed(lambda: composite.composite_bwd(*bwd_args), device, 20)
        plain_ms = timed(lambda: composite_bwd_plain(*bwd_args), device, 3)
        counts = pair_counts(*args)
        n_bytes = bwd_bytes(bins.n_instances, tx * ty)
        bound_ms, bound_by = bound(n_bytes, bwd_ops(counts))
        print(f"full-width backward bound: {n_bytes} bytes, pairs {counts}, "
              f"{bwd_ops(counts)} FP32 ops -> {bound_ms:.4f} ms ({bound_by}); "
              f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.3f} ms; {info}")
        fwd_ms = timed(lambda: composite.composite_fwd(*args), device, 20)
        fwd_bound, fwd_by = bound(fwd_bytes(bins.n_instances, tx * ty),
                                  fwd_ops(counts))
        print(f"full-width forward on the same view: kernel {fwd_ms:.4f} ms, "
              f"bound {fwd_bound:.4f} ms ({fwd_by}; {fwd_ops(counts)} FP32 ops)")
    fwd_train = {"train_view0_ms": fwd_ms, "train_view0_bound_ms": fwd_bound,
                 "train_view0_bound_by": fwd_by}
    return fwd_train, {"name": "composite_bwd", "route": "cuda",
                       "design": "32-instance flushes, reduce-scatter, footprint cull",
            "source": "bags_tpu_torch/csrc/composite_bwd.cu",
            "replaces": "bags_tpu/raster/pallas_raster.py:334",
            "launches": None, "max_abs_err": err, "max_abs_diff": err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, **info}


def train_view_variants(state, scene):
    """Every variant of the forward against the forward kernel on train
    view 0 of the trained model, bit for bit and timed in turns, with the
    forward's bound there (step 7). Returns `variant_checks`' result with
    the bound."""
    import torch
    from bags_tpu_torch.utils.profiling import bound, fwd_bytes, fwd_ops, pair_counts

    with torch.no_grad():
        rows, bins, tx, ty = frame(state.g, state.alive, state.cams[0],
                                   scene.static, 0)
    args = (rows, bins.tile_start, bins.tile_count, tx, ty)
    out = variant_checks("train view 0", args, turns=True)
    bound_ms, bound_by = bound(fwd_bytes(bins.n_instances, tx * ty),
                               fwd_ops(pair_counts(*args)))
    for res in out.values():
        res.update(bound_ms=bound_ms, bound_by=bound_by)
    return out


# The known lens of the fisheye phase: tools/lens_recovery.py's true
# OPENCV_FISHEYE coefficients make the GT (`utils/testing.KNOWN_LENS`), its
# initial ones go into fish/sparse/0 for the lens pre-fit (near the truth,
# not at it).
FISH_INIT_COEFF = (-0.04, 0.0, 0.0, 0.0)
FISH_FLOW_SCALE = (2.0, 2.0)         # --preset fisheye
FISH_SAMPLE_SCALE = 16               # --preset fisheye


def fisheye_geometry(scene, device):
    """--preset fisheye's extended-FoV setup and control points for the
    dataset's focal lengths (full width: 1600x1080, 100x67 points)."""
    from bags_tpu_torch.train import calibrated

    info = scene.train_infos[0]
    setup = calibrated.make_fisheye_setup(
        info.focal_x, info.focal_y, (WIDTH, HEIGHT), (WIDTH, HEIGHT),
        flow_scale=FISH_FLOW_SCALE, control_point_sample_scale=FISH_SAMPLE_SCALE)
    p_view = calibrated.fisheye_control_points(
        setup, info.focal_x, info.focal_y, FISH_FLOW_SCALE, device=device)
    return setup, p_view


def extended(cam, setup):
    """A camera with the fisheye setup's extended FoVs."""
    import dataclasses

    import torch

    return dataclasses.replace(cam, fovx=torch.full_like(cam.fovx, setup.fovx),
                               fovy=torch.full_like(cam.fovy, setup.fovy))


def write_fisheye_gt(model, data, device):
    """The fisheye half of the dataset (step 11): for each of the 8 views,
    the plain version's render of the 1M-Gaussian model at the extended FoV
    warped through the analytic lens KNOWN_LENS into `fish/images`, and
    `fish/sparse/0/cameras.bin` (OPENCV_FISHEYE, FISH_INIT_COEFF)."""
    import numpy as np
    import torch
    from bags_tpu_torch.data.scene import Scene
    from bags_tpu_torch.model.gaussians import load_ply
    from bags_tpu_torch.raster.tiles import composite_tiles_plain
    from bags_tpu_torch.utils.testing import (KNOWN_LENS, known_lens_fisheye,
                                              write_fisheye_pair)

    scene = Scene(data, eval_split=True, sh_degree=3, device=device)
    g, alive = load_ply(os.path.join(model, "point_cloud", "iteration_30000",
                                     "point_cloud.ply"), device=device)
    setup, p_view = fisheye_geometry(scene, device)
    paths, images = [], []
    with torch.no_grad():
        for infos, cams in ((scene.test_infos, scene.test_cams),
                            (scene.train_infos, scene.train_cams)):
            for i, info in enumerate(infos):
                rows, bins, tx, ty = frame(g, alive, extended(cams[i], setup),
                                           setup.render_static, 3)
                c4, _ = composite_tiles_plain(rows, bins.tile_start,
                                              bins.tile_count, tx, ty)
                img = torch.clamp(to_image(c4, tx, ty, setup.render_static), 0, 1)
                fish = known_lens_fisheye(img, setup, p_view, KNOWN_LENS)
                paths.append(info.image_path)
                images.append(np.round(fish.permute(1, 2, 0).cpu().numpy() * 255)
                              .astype(np.uint8))
    info = scene.train_infos[0]
    write_fisheye_pair(data, paths, images, WIDTH, HEIGHT, info.focal_x,
                       info.focal_y, FISH_INIT_COEFF)
    print(f"fisheye GT: {len(images)} views at {setup.fish_hw}, rendered at "
          f"FoV {setup.fovx:.4f} x {setup.fovy:.4f} "
          f"({setup.render_static.width}x{setup.render_static.height}), flow "
          f"{setup.flow_hw}, control grid {setup.grid_hw}")


def toy_step_check(label, make_toy, run_step, renders, device):
    """A toy training step (`make_toy(device, gt)` builds it,
    `run_step(toy, device)` takes it) on the card through both kernels
    against the same step on the CPU through the plain versions, from the
    same state and GT: loss and image within 2e-5, every gradient within
    atol 1e-5, rtol 1e-3, and `renders` forward and backward launches on
    the card."""
    import torch
    from bags_tpu_torch.raster import composite

    out, gt = {}, None
    for where, dev in (("cpu", torch.device("cpu")), ("card", device)):
        t = make_toy(dev, gt)
        gt = t["gt"].cpu()
        before = composite.fwd_launches, composite.bwd_launches
        out[where] = run_step(t, dev)
    torch.cuda.synchronize()
    check((composite.fwd_launches, composite.bwd_launches)
          == (before[0] + renders, before[1] + renders),
          f"{label}: the card's step did not launch each kernel {renders} "
          "time(s)")
    cpu, card = out["cpu"], out["card"]
    loss_d = abs(float(card.loss) - float(cpu.loss))
    img_d = float((card.image.cpu() - cpu.image).abs().max())
    print(f"{label} card vs cpu: loss {float(card.loss):.6f} vs "
          f"{float(cpu.loss):.6f}, image max_abs_diff {img_d:.3e}")
    check(loss_d <= 2e-5 and img_d <= 2e-5,
          f"{label}: loss diff {loss_d}, image diff {img_d}")
    check(set(card.grads) == set(cpu.grads), f"{label}: gradient names")
    worst = {}
    for k, v in cpu.grads.items():
        got = card.grads[k].detach().cpu()
        worst[k] = float((got - v).abs().max())
        check(bool(torch.isfinite(got).all()) and torch.allclose(
            got, v, atol=1e-5, rtol=1e-3), f"{label} gradient {k}: max diff "
                                            f"{worst[k]}")
    print(f"{label} gradients card vs cpu, largest max abs diffs: " + json.dumps(
        {k: f"{v:.2e}" for k, v in sorted(worst.items(), key=lambda kv: -kv[1])[:8]}))


def fisheye_toy_check(device):
    """The toy fisheye step (`utils/testing.fisheye_toy`: apply2render,
    lens, vignetting and shift trained), card against CPU (step 11)."""
    import torch
    from bags_tpu_torch.raster.render import RenderConfig
    from bags_tpu_torch.train.calibrated import fisheye_train_step
    from bags_tpu_torch.utils.testing import fisheye_toy

    toy_step_check("toy fisheye step", fisheye_toy, lambda t, dev: fisheye_train_step(
        t["state"], t["gt"], t["p_view"], 0, torch.zeros(3, device=dev),
        t["setup"], RenderConfig(sh_degree=3), t["cfg"], t["schedules"], True,
        True), 1, device)


def fisheye_train_path(data):
    """Slice 4's main path: `cli.train --preset fisheye` at full width
    (step 11), checkpoints after steps 1 and 30. Returns (model path,
    forward launches, backward launches, summary)."""
    import math

    import numpy as np
    import torch
    from bags_tpu_torch.cli import train as train_cli
    from bags_tpu_torch.raster import composite

    model = os.path.join(WORK, "fish_model")
    argv = ["-s", data, "-m", model, "--preset", "fisheye", "--init_type", "sfm",
            "--iterations", str(TRAIN_ITERS), "--densify_from_iter", "10",
            "--densification_interval", "10", "--densify_until_iter", "25",
            "--test_iterations", str(TRAIN_ITERS),
            "--save_iterations", str(TRAIN_ITERS),
            "--checkpoint_iterations", "1", str(TRAIN_ITERS), "--device", "cuda",
            "--densify_grad_threshold", "5e-8"]     # as in step 6
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    composite.fwd_launches = composite.bwd_launches = 0
    t0 = time.perf_counter()
    summary = train_cli.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    fwd, bwd = composite.fwd_launches, composite.bwd_launches
    losses, steps = summary["losses"], summary["step_s"]
    print(f"fisheye train CLI: {len(losses)} steps in {train_s:.1f} s (lens "
          f"pre-fit {summary['lens_prefit_s']:.2f} s of it), forward launches "
          f"{fwd} ({summary['eval_renders']} of them evaluation renders), "
          f"backward launches {bwd}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print("fisheye train losses " + " ".join(f"{x:.5f}" for x in losses))
    print("fisheye train step_ms " + " ".join(f"{1e3 * x:.1f}" for x in steps))
    print(f"fisheye train densify: {summary['densify']}")
    print("\n".join(summary["eval"]))
    check(len(losses) == TRAIN_ITERS, f"{len(losses)} fisheye training steps")
    check(bwd == TRAIN_ITERS, f"{bwd} backward launches for {TRAIN_ITERS} steps")
    check(fwd == TRAIN_ITERS + summary["eval_renders"],
          f"{fwd} forward launches for {TRAIN_ITERS} steps and "
          f"{summary['eval_renders']} evaluation renders")
    check(all(math.isfinite(x) for x in losses), "non-finite fisheye loss")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    check(last < first, f"fisheye loss did not fall: first 5 {first:.5f}, "
                        f"last 5 {last:.5f}")
    check(summary["eval"], "no fisheye evaluation lines")
    ck = {it: np.load(os.path.join(model, f"chkpnt{it}.npz"))
          for it in (1, TRAIN_ITERS)}
    lens_keys = [k for k in ck[TRAIN_ITERS].files if k.startswith("v2|.lens.")]
    check(len(lens_keys) == 3 * 5 * 5 and all(
        k in ck[TRAIN_ITERS].files for k in ("v2|.vig.a_k", "v2|.shift",
                                             "v2|.lens_opt.count")),
          f"the checkpoint's lens leaves: {len(lens_keys)}")
    check(int(ck[TRAIN_ITERS]["v2|.lens_opt.count"]) == TRAIN_ITERS,
          "the lens did not step every iteration")
    moved = max(float(np.abs(ck[TRAIN_ITERS][k] - ck[1][k]).max())
                for k in lens_keys)
    print(f"fisheye lens: largest change of a lens parameter from step 1 to "
          f"step {TRAIN_ITERS}: {moved:.3e}")
    check(moved > 0, "the lens parameters did not change")
    return model, fwd, bwd, summary


def fisheye_restore_path(model, data):
    """The render CLI restores the fisheye model and writes lens-warped
    pairs against the fisheye GT (step 11). Returns the forward launches."""
    import math

    import numpy as np
    import torch
    from PIL import Image
    from bags_tpu_torch.cli import render as render_cli
    from bags_tpu_torch.raster import composite

    composite.fwd_launches = composite.bwd_launches = 0
    t0 = time.perf_counter()
    summary = render_cli.main(["-m", model, "-s", data, "--device", "cuda"])
    torch.cuda.synchronize()
    fwd = composite.fwd_launches
    psnrs = {k: v["psnr"] for k, v in summary.items()}
    n_views = sum(len(v) for v in psnrs.values())
    print(f"fisheye restore: {n_views} views in {time.perf_counter() - t0:.1f} "
          f"s, PSNR {psnrs}, forward launches {fwd}")
    check(sorted(psnrs) == ["test", "train"] and n_views == N_CAMS,
          f"fisheye restore rendered {psnrs}")
    check(fwd == n_views, f"{fwd} forward launches for {n_views} views")
    check(all(math.isfinite(p) for v in psnrs.values() for p in v),
          "non-finite fisheye PSNR after restore")
    test_dir = summary["test"]["dir"]
    for sub in ("renders", "gt"):
        names = os.listdir(os.path.join(test_dir, sub))
        check(len(names) == len(psnrs["test"]), f"{sub}: {names}")
    gt = np.asarray(Image.open(os.path.join(test_dir, "gt", "00000.png")), float)
    ren = np.asarray(Image.open(os.path.join(test_dir, "renders", "00000.png")))
    name = os.path.basename(sorted(os.listdir(os.path.join(data, "fish", "images")))[0])
    fish = np.asarray(Image.open(os.path.join(data, "fish", "images", name)), float)
    persp = np.asarray(Image.open(os.path.join(data, "images", name)), float)
    d_fish, d_persp = np.abs(gt - fish).mean(), np.abs(gt - persp).mean()
    print(f"fisheye restore: test pair {ren.shape}, its GT off the fisheye "
          f"image by {d_fish:.3f}, off the perspective image by {d_persp:.3f}")
    check(ren.shape == (HEIGHT, WIDTH, 3), f"fisheye render shape {ren.shape}")
    check(d_fish < 0.25 * d_persp, "the restored pairs' GT is not the fisheye GT")
    return fwd


def prefit_trace(trainer, device):
    """Ten steps of the lens pre-fit (a full-width lens net on the 3,200
    points of the dataset's COLMAP coefficients) under the profiler: the
    device's busy share and the kernels by time (step 11)."""
    import numpy as np
    from bags_tpu_torch.calib import distortion
    from bags_tpu_torch.calib.iresnet import init_iresnet_params
    from bags_tpu_torch.tools.stagebench import print_busy, trace_calls

    fx, fy = trainer.focal
    fh, fw = trainer.setup.fish_hw
    K = np.array([[fx, 0, fw / 2], [0, fy, fh / 2], [0, 0, 1.0]])
    inputs, targets = distortion.colmap_fit_points(K, fw, fh, FISH_INIT_COEFF,
                                                   device)
    lens = init_iresnet_params(device=device)
    summary = trace_calls(lambda: distortion.fit_iresnet_to_targets(
        lens, inputs, targets, iters=10), os.path.join(WORK, "prefit_trace"))
    print_busy("lens pre-fit, 10 Adam steps", summary)


def fisheye_checks(model, data, device):
    """On the trained fisheye model (step 11): the Newton inverse's residual
    on the control points (<= 1e-4), the recovered flow's error against the
    analytic lens after steps 1 and 30, both kernels on the extended-FoV
    render of train view 0 against their plain versions (with the fisheye
    loss's cotangents) with their times and bounds, and the fisheye step
    split by stage. Returns the forward's and the backward's numbers on
    that view."""
    import numpy as np
    import torch
    from bags_tpu_torch import convert
    from bags_tpu_torch.calib import distortion
    from bags_tpu_torch.calib.iresnet import inverse_residual
    from bags_tpu_torch.cli import render as render_cli
    from bags_tpu_torch.raster import composite, tiles
    from bags_tpu_torch.raster.tiles import composite_bwd_plain, composite_tiles_plain
    from bags_tpu_torch.tools import stagebench
    from bags_tpu_torch.train.losses import photometric_loss
    from bags_tpu_torch.utils.profiling import (bound, bwd_bytes, bwd_ops, fwd_bytes,
                                                fwd_ops, pair_counts, timed)
    from bags_tpu_torch.utils.testing import KNOWN_LENS

    _, scene, _, _, trainer = render_cli.restore_trained(model, data, -1, device)
    setup, p_view, lens = trainer.setup, trainer.p_view, trainer.state.lens
    res = inverse_residual(lens, p_view)
    proj = [1 / np.tan(setup.fovx / 2), 1 / np.tan(setup.fovy / 2)]
    errs = {}
    for it in (1, TRAIN_ITERS):
        ck = np.load(os.path.join(model, f"chkpnt{it}.npz"))
        net = convert.iresnet_from_numpy({f: [[ck[f"v2|.lens.{f}[{b}][{l}]"]
                                               for l in range(5)] for b in range(5)]
                                          for f in ("weights", "biases", "u_vecs")},
                                         device)
        errs[it] = distortion.flow_error_px(net, KNOWN_LENS, p_view, proj,
                                            setup.render_static.width)
    print(f"fisheye lens: Newton inverse residual on the {p_view.shape[0]} "
          f"control points {res:.3e}; flow error against the true lens "
          f"{errs[1]:.3f} px after step 1, {errs[TRAIN_ITERS]:.3f} px after "
          f"step {TRAIN_ITERS} (render pixels)")
    check(res <= 1e-4, f"fisheye lens inverse residual {res} > 1e-4")

    base = trainer.base
    cam = base.cams[0]
    fish_gt = scene.fish_image(0)
    with torch.no_grad():
        rows, bins, tx, ty = frame(base.g, base.alive, cam, setup.render_static, 3)
    args = (rows, bins.tile_start, bins.tile_count, tx, ty)
    with torch.no_grad():
        fwd_err = fwd_agreement("fisheye view 0", composite.composite_fwd(*args),
                                composite_tiles_plain(*args))
        fwd_ms = timed(lambda: composite.composite_fwd(*args), device, 20)
        fwd_plain = timed(lambda: composite_tiles_plain(*args), device, 3)
        color, t_final = composite.composite_fwd(*args)
    c4 = color.clone().requires_grad_(True)
    img = tiles.tiles_to_image(c4.transpose(1, 2)[..., :3], tx, ty,
                               setup.render_static.width, setup.render_static.height)
    ps = torch.stack([1 / torch.tan(cam.fovx * 0.5), 1 / torch.tan(cam.fovy * 0.5)])
    warped, mask, _ = distortion.apply_distortion(
        lens, p_view, setup.grid_hw, img, ps, setup.flow_hw, final_hw=setup.fish_hw)
    g_color = torch.autograd.grad(photometric_loss(warped, fish_gt * mask), c4)[0]
    bwd_args = (*args, g_color.contiguous(), torch.zeros_like(t_final), color, t_final)
    counts = pair_counts(*args)
    with torch.no_grad():
        bwd_err = bwd_full_width_check("fisheye view 0 backward", bwd_args)
        bwd_ms = timed(lambda: composite.composite_bwd(*bwd_args), device, 20)
        bwd_plain = timed(lambda: composite_bwd_plain(*bwd_args), device, 3)
    fb = bound(fwd_bytes(bins.n_instances, tx * ty), fwd_ops(counts))
    bb = bound(bwd_bytes(bins.n_instances, tx * ty), bwd_ops(counts))
    print(f"fisheye view 0 ({setup.render_static.width}x"
          f"{setup.render_static.height} at the extended FoV): "
          f"{bins.n_instances} instances, max tile {int(bins.tile_count.max())}; "
          f"forward {fwd_ms:.4f} ms (plain {fwd_plain:.3f}, bound {fb[0]:.4f} "
          f"{fb[1]}), backward {bwd_ms:.4f} ms (plain {bwd_plain:.3f}, bound "
          f"{bb[0]:.4f} {bb[1]})")
    stagebench.fisheye_step_stages(trainer, fish_gt, device,
                                   os.path.join(WORK, "fish_trace"))
    prefit_trace(trainer, device)

    def numbers(ms, plain_ms, bnd, err):
        return {"fisheye_view0_ms": ms, "fisheye_view0_plain_ms": plain_ms,
                "fisheye_view0_bound_ms": bnd[0], "fisheye_view0_bound_by": bnd[1],
                "fisheye_view0_max_abs_err": err,
                "fisheye_view0_instances": bins.n_instances}
    return numbers(fwd_ms, fwd_plain, fb, fwd_err), numbers(bwd_ms, bwd_plain, bb,
                                                           bwd_err)


# The cubemap phase (step 12): 8 cameras inside the Gaussian box of
# `make_toy_scene`, near (0, 0, 6), so that all five faces of each see
# content; focal 800 px, so that the forward face spans 90 degrees across
# the 1600-pixel width. --preset cubemap samples the control grid every 8
# pixels and masks a disc of radius 512.
CUBE_FOCAL, CUBE_SCALE, CUBE_RADIUS = 800.0, 8, 512


def cubemap_toy_check(device):
    """The toy cubemap step (`utils/testing.cubemap_toy`: five renders sorted
    by distance, the cubemap net's ray field, five warps; pose, FoVs and
    the net trained), card against CPU, 5 launches of each kernel (step
    12)."""
    import torch
    from bags_tpu_torch.raster.render import RenderConfig
    from bags_tpu_torch.train.calibrated import cubemap_train_step
    from bags_tpu_torch.utils.testing import cubemap_toy

    toy_step_check("toy cubemap step", cubemap_toy, lambda t, dev: cubemap_train_step(
        t["state"], t["gt"], 0, torch.zeros(3, device=dev), t["sub_q"][0],
        t["sub_t"][0], t["setup"], RenderConfig(sh_degree=1), t["cfg"],
        t["schedules"]), 5, device)


def write_cubemap_data(model, device):
    """The cubemap dataset `cube/` (step 12): the step-5 model's 1M centres
    in points3D, 8 cameras of `utils/testing.cubemap_cameras` at 1600x1080,
    focal CUBE_FOCAL, and in `images/` each camera's five faces (the plain
    version's renders, sorted by distance) warped through a full-size
    cubemap net fitted by `init_cubemap_net` on the card to the known lens
    KNOWN_LENS, stitched by maximum intensity and masked to the disc of
    radius CUBE_RADIUS. Returns (data path, pre-fit seconds, instances per
    face and camera)."""
    import numpy as np
    import torch
    from bags_tpu_torch.calib.distortion import init_cubemap_net
    from bags_tpu_torch.calib.iresnet import init_iresnet_params
    from bags_tpu_torch.core.camera import CameraParams, CameraStatic
    from bags_tpu_torch.core.sh import sh_dc_to_rgb
    from bags_tpu_torch.model.gaussians import load_ply
    from bags_tpu_torch.raster.tiles import composite_tiles_plain
    from bags_tpu_torch.train.calibrated import face_cameras, sub_camera_poses
    from bags_tpu_torch.utils.testing import (KNOWN_LENS, cubemap_cameras,
                                              write_cubemap_dataset)

    g, alive = load_ply(os.path.join(model, "point_cloud", "iteration_30000",
                                     "point_cloud.ply"), device=device)
    net = init_iresnet_params(seed=7, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    init_cubemap_net(net, KNOWN_LENS)
    torch.cuda.synchronize()
    prefit_s = time.perf_counter() - t0
    print(f"init_cubemap_net (160,000 samples, 100 Adam steps, the 5x512 net) "
          f"to {KNOWN_LENS}: {prefit_s:.2f} s")
    static = CameraStatic(WIDTH, HEIGHT)
    cams = cubemap_cameras(N_CAMS, 2 * np.arctan(WIDTH / (2 * CUBE_FOCAL)),
                           2 * np.arctan(HEIGHT / (2 * CUBE_FOCAL)), device=device)

    def render_faces(cam):
        q, t = sub_camera_poses(CameraParams.stack([cam]))
        faces, counts = [], []
        for c in face_cameras(cam, q[0], t[0]):
            rows, bins, tx, ty = frame(g, alive, c, static, 3, sort_by_distance=True)
            c4, _ = composite_tiles_plain(rows, bins.tile_start, bins.tile_count,
                                          tx, ty)
            faces.append(to_image(c4, tx, ty, static))
            counts.append(bins.n_instances)
        return faces, counts

    data = os.path.join(WORK, "cube")
    with torch.no_grad():
        counts = write_cubemap_dataset(
            data, cams, WIDTH, HEIGHT, CUBE_FOCAL, g.xyz.cpu().numpy(),
            sh_dc_to_rgb(g.sh_dc[:, 0]).cpu().numpy(), render_faces, net,
            CUBE_RADIUS, CUBE_SCALE)
    for i, c in enumerate(counts):
        print(f"cubemap GT camera {i}: instances per face (forward, up, down, "
              f"left, right) {c}")
    check(all(min(c[1:]) > 0 for c in counts),
          f"a side face renders nothing: {counts}")
    return data, prefit_s, counts


def cubemap_train_path(data):
    """Slice 4's cubemap path: `cli.train --preset cubemap` at full width
    (step 12), checkpoints after steps 1 and 30. Returns (model path,
    forward launches, backward launches, summary)."""
    import math

    import numpy as np
    import torch
    from bags_tpu_torch.cli import train as train_cli
    from bags_tpu_torch.raster import composite

    model = os.path.join(WORK, "cube_model")
    argv = ["-s", data, "-m", model, "--preset", "cubemap", "--init_type", "sfm",
            "--iterations", str(TRAIN_ITERS), "--densify_from_iter", "10",
            "--densification_interval", "10", "--densify_until_iter", "25",
            "--test_iterations", str(TRAIN_ITERS),
            "--save_iterations", str(TRAIN_ITERS),
            "--checkpoint_iterations", "1", str(TRAIN_ITERS), "--device", "cuda",
            "--densify_grad_threshold", "5e-8"]     # as in step 6
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    composite.fwd_launches = composite.bwd_launches = 0
    t0 = time.perf_counter()
    summary = train_cli.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    fwd, bwd = composite.fwd_launches, composite.bwd_launches
    losses, steps = summary["losses"], summary["step_s"]
    print(f"cubemap train CLI: {len(losses)} steps in {train_s:.1f} s, forward "
          f"launches {fwd} (5 for each of {summary['eval_renders']} evaluation "
          f"views among them), backward launches {bwd}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print("cubemap train losses " + " ".join(f"{x:.5f}" for x in losses))
    print("cubemap train step_ms " + " ".join(f"{1e3 * x:.1f}" for x in steps))
    print(f"cubemap train densify: {summary['densify']}")
    print("\n".join(summary["eval"]))
    check(len(losses) == TRAIN_ITERS, f"{len(losses)} cubemap training steps")
    check(bwd == 5 * TRAIN_ITERS,
          f"{bwd} backward launches for {TRAIN_ITERS} cubemap steps")
    check(fwd == 5 * (TRAIN_ITERS + summary["eval_renders"]),
          f"{fwd} forward launches for {TRAIN_ITERS} cubemap steps and "
          f"{summary['eval_renders']} evaluation views")
    check(all(math.isfinite(x) for x in losses), "non-finite cubemap loss")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    check(last < first, f"cubemap loss did not fall: first 5 {first:.5f}, "
                        f"last 5 {last:.5f}")
    check(summary["eval"], "no cubemap evaluation lines")
    ck = {it: np.load(os.path.join(model, f"chkpnt{it}.npz"))
          for it in (1, TRAIN_ITERS)}
    keys = [k for k in ck[TRAIN_ITERS].files if k.startswith("v2|.cubemap_net.")]
    check(len(keys) == 3 * 5 * 5, f"the checkpoint's cubemap leaves: {len(keys)}")
    check(int(ck[TRAIN_ITERS]["v2|.cubemap_opt.count"]) == TRAIN_ITERS,
          "the cubemap net did not step every iteration")
    moved = max(float(np.abs(ck[TRAIN_ITERS][k] - ck[1][k]).max()) for k in keys)
    print(f"cubemap net: largest change of a parameter from step 1 to step "
          f"{TRAIN_ITERS}: {moved:.3e}")
    check(moved > 0, "the cubemap net's parameters did not change")
    return model, fwd, bwd, summary


def cubemap_restore_path(model, data):
    """The render CLI restores the cubemap model and renders plain
    perspective views of it, one forward launch a view (step 12). Returns
    the forward launches."""
    import math

    import numpy as np
    import torch
    from PIL import Image
    from bags_tpu_torch.cli import render as render_cli
    from bags_tpu_torch.raster import composite

    composite.fwd_launches = composite.bwd_launches = 0
    t0 = time.perf_counter()
    summary = render_cli.main(["-m", model, "-s", data, "--device", "cuda"])
    torch.cuda.synchronize()
    fwd = composite.fwd_launches
    psnrs = {k: v["psnr"] for k, v in summary.items()}
    n_views = sum(len(v) for v in psnrs.values())
    print(f"cubemap restore: {n_views} views in {time.perf_counter() - t0:.1f} "
          f"s, PSNR {psnrs}, forward launches {fwd}")
    check(sorted(psnrs) == ["test", "train"] and n_views == N_CAMS,
          f"cubemap restore rendered {psnrs}")
    check(fwd == n_views, f"{fwd} forward launches for {n_views} views")
    check(all(math.isfinite(p) for v in psnrs.values() for p in v),
          "non-finite cubemap PSNR after restore")
    ren = np.asarray(Image.open(os.path.join(summary["test"]["dir"], "renders",
                                             "00000.png")))
    check(ren.shape == (HEIGHT, WIDTH, 3), f"cubemap render shape {ren.shape}")
    return fwd


def cubemap_checks(model, data, device):
    """On the trained cubemap model (step 12): both kernels on train view
    0's forward face and left face (sorted by distance) against their plain
    versions at step 5's and step 7's full-width criteria, with their
    times, bounds and instances, then the cubemap step split by stage.
    Returns the forward's and the backward's numbers on those faces."""
    import torch
    from bags_tpu_torch.cli import render as render_cli
    from bags_tpu_torch.raster import composite
    from bags_tpu_torch.raster.tiles import composite_bwd_plain, composite_tiles_plain
    from bags_tpu_torch.tools import stagebench
    from bags_tpu_torch.train.calibrated import face_cameras
    from bags_tpu_torch.utils.profiling import (bound, bwd_bytes, bwd_ops, fwd_bytes,
                                                fwd_ops, pair_counts, timed)

    _, scene, _, _, trainer = render_cli.restore_trained(model, data, -1, device)
    base, static = trainer.base, trainer.setup.static
    gt = scene.train_image(0)
    cams = face_cameras(base.cams[0], trainer.sub_q[0], trainer.sub_t[0])
    fwd_numbers, bwd_numbers = {}, {}
    for name, cam in (("forward_face", cams[0]), ("left_face", cams[3])):
        with torch.no_grad():
            rows, bins, tx, ty = frame(base.g, base.alive, cam, static, 3,
                                       sort_by_distance=True)
        args = (rows, bins.tile_start, bins.tile_count, tx, ty)
        label = f"cubemap train view 0 {name}"
        with torch.no_grad():
            fwd_err = fwd_agreement(label, composite.composite_fwd(*args),
                                    composite_tiles_plain(*args))
            fwd_ms = timed(lambda: composite.composite_fwd(*args), device, 20)
            fwd_plain = timed(lambda: composite_tiles_plain(*args), device, 3)
        bwd_args = loss_cotangents(args, static, gt)
        counts = pair_counts(*args)
        with torch.no_grad():
            bwd_err = bwd_full_width_check(f"{label} backward", bwd_args)
            bwd_ms = timed(lambda: composite.composite_bwd(*bwd_args), device, 20)
            bwd_plain = timed(lambda: composite_bwd_plain(*bwd_args), device, 3)
        fb = bound(fwd_bytes(bins.n_instances, tx * ty), fwd_ops(counts))
        bb = bound(bwd_bytes(bins.n_instances, tx * ty), bwd_ops(counts))
        print(f"{label} ({static.width}x{static.height}, sorted by distance): "
              f"{bins.n_instances} "
              f"instances, max tile {int(bins.tile_count.max())}; forward "
              f"{fwd_ms:.4f} ms (plain {fwd_plain:.3f}, bound {fb[0]:.4f} "
              f"{fb[1]}), backward {bwd_ms:.4f} ms (plain {bwd_plain:.3f}, "
              f"bound {bb[0]:.4f} {bb[1]})")
        for numbers, ms, plain_ms, bnd, err in (
                (fwd_numbers, fwd_ms, fwd_plain, fb, fwd_err),
                (bwd_numbers, bwd_ms, bwd_plain, bb, bwd_err)):
            numbers.update({f"cubemap_{name}_ms": ms,
                            f"cubemap_{name}_plain_ms": plain_ms,
                            f"cubemap_{name}_bound_ms": bnd[0],
                            f"cubemap_{name}_bound_by": bnd[1],
                            f"cubemap_{name}_max_abs_err": err,
                            f"cubemap_{name}_instances": bins.n_instances})
    stagebench.cubemap_step_stages(trainer, gt, device,
                                   os.path.join(WORK, "cube_trace"))
    return fwd_numbers, bwd_numbers


# The MCMC window of step 14: relocations at iterations 10 and 20 of 30.
MCMC_WINDOW = ["--densify_from_iter", "5", "--densification_interval", "10",
               "--densify_until_iter", "25"]
SPEC_NAMES = ("feat_w", "feat_b", "w1", "b1", "w2", "b2", "w3", "b3")


def hybrid_toy_checks(device):
    """Slice 5's toys card against CPU (step 14a): the pose step with the
    specular colour and the MCMC regularisers, the fisheye step with the
    specular colour (`toy_step_check`'s criteria, the ASG features and the
    specular weights among the gradients), and `relocate_dead`,
    `add_new_gaussians` and `position_noise` with the same injected draws
    (`utils/testing.run_mcmc_toy`): counts, alive and reset masks
    identical, every float of the relocated fields within 1e-6 of itself
    (rtol 1e-6, atol 0); `position_noise` on the CPU's relocated
    population on both, each noised position within 1e-6 of the scale of
    its rounding (`noise_terms`: the terms it adds up can cancel, and the
    opacity gate's argument does)."""
    import torch
    from bags_tpu_torch.raster.render import RenderConfig
    from bags_tpu_torch.train.calibrated import fisheye_train_step
    from bags_tpu_torch.train.loop import train_step
    from bags_tpu_torch.utils.testing import (fisheye_toy, mcmc_toy, pose_toy,
                                              run_mcmc_toy)

    toy_step_check("toy hybrid mcmc pose step",
                   lambda dev, gt: pose_toy(dev, gt, hybrid=True, mcmc=True),
                   lambda t, dev: train_step(t["state"], t["gt"], 1,
                                             torch.zeros(3, device=dev), t["static"],
                                             RenderConfig(sh_degree=3), t["cfg"]),
                   1, device)
    toy_step_check("toy hybrid fisheye step",
                   lambda dev, gt: fisheye_toy(dev, gt, hybrid=True),
                   lambda t, dev: fisheye_train_step(
                       t["state"], t["gt"], t["p_view"], 0, torch.zeros(3, device=dev),
                       t["setup"], RenderConfig(sh_degree=3), t["cfg"], t["schedules"],
                       True, True), 1, device)
    cpu = run_mcmc_toy(mcmc_toy(torch.device("cpu")))
    card = run_mcmc_toy(mcmc_toy(device), noise_input=cpu)
    check(card["counts"] == cpu["counts"] == (40, 8),
          f"toy relocation counts card {card['counts']} cpu {cpu['counts']}")
    for k in ("alive", "reset1", "reset2"):
        check(torch.equal(card[k], cpu[k]), f"toy relocation {k} differs")
    worst = {}
    for k in ("xyz", "sh_dc", "sh_rest", "scales_log", "quats", "opacity_raw",
              "asg", "noised_xyz"):
        diff = (card[k] - cpu[k]).abs()
        worst[k] = float((diff / cpu[k].abs()).nan_to_num(0.0).max())
        scale = cpu["noise_terms"] if k == "noised_xyz" else cpu[k].abs()
        over = int((diff > 1e-6 * scale).sum())
        check(over == 0, f"toy relocation {k}: {over} entries differ by more than "
              f"1e-6 of their scale (largest relative difference {worst[k]})")
    diff = (card["noised_xyz"] - cpu["noised_xyz"]).abs().double()
    terms = float((diff / cpu["noise_terms"]).max())
    over = int((diff > 1e-6 * cpu["noised_xyz"].abs()).sum())
    print("toy relocation card vs cpu: counts " f"{card['counts']}, masks identical, "
          "largest relative differences " + json.dumps(
              {k: f"{v:.1e}" for k, v in worst.items()})
          + f"; noised positions: {over} over 1e-6 of themselves, the largest "
          f"difference {terms:.1e} of their rounding scale")


def check_growth(label, log):
    """Each relocation step of an MCMC log (it, relocated, added, before,
    after) grew the live count to exactly int(float32(1.005) * float32(N))."""
    import numpy as np

    print(f"{label} mcmc log (it, relocated, added, alive before, after): {log}")
    check([e[0] for e in log] == [10, 20], f"{label}: relocations at {log}")
    for it, _, added, before, after in log:
        want = int(np.float32(1.005) * np.float32(before))
        check(after == want == before + added,
              f"{label} iteration {it}: live {before} -> {after}, float32 target {want}")


def train_cli_run(label, argv):
    """`cli.train` with `argv`, timed, the launch counts from 0 and the peak
    memory reset. Returns (summary, forward launches, backward launches)."""
    import math

    import torch
    from bags_tpu_torch.cli import train as train_cli
    from bags_tpu_torch.raster import composite

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    composite.fwd_launches = composite.bwd_launches = 0
    t0 = time.perf_counter()
    summary = train_cli.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    fwd, bwd = composite.fwd_launches, composite.bwd_launches
    losses, steps = summary["losses"], summary["step_s"]
    prefit = summary["lens_prefit_s"]
    print(f"{label} train CLI: {len(losses)} steps in {train_s:.1f} s"
          + (f" (lens pre-fit {prefit:.2f} s of it)" if prefit else "")
          + f", forward launches {fwd} ({summary['eval_renders']} of them "
          f"evaluation renders), backward launches {bwd}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"{label} train losses " + " ".join(f"{x:.5f}" for x in losses))
    print(f"{label} train step_ms " + " ".join(f"{1e3 * x:.1f}" for x in steps))
    print("\n".join(summary["eval"]))
    check(len(losses) == TRAIN_ITERS, f"{label}: {len(losses)} training steps")
    check(bwd == TRAIN_ITERS, f"{label}: {bwd} backward launches for {TRAIN_ITERS} steps")
    check(fwd == TRAIN_ITERS + summary["eval_renders"],
          f"{label}: {fwd} forward launches for {TRAIN_ITERS} steps and "
          f"{summary['eval_renders']} evaluation renders")
    check(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss")
    check(summary["eval"], f"{label}: no evaluation lines")
    check(summary["densify"] == [], f"{label}: densify ran under --mcmc")
    check_growth(label, summary["mcmc"])
    return summary, fwd, bwd


def fisheye_mcmc_train_path(data):
    """Slice 5's main path (step 14b): `cli.train --preset fisheye_mcmc
    --hybrid` at full width on step 11's dataset, the lens pre-fit first,
    checkpoints after steps 1 and 30. Checks `train_cli_run`'s, a falling
    loss, the checkpoint's ASG, specular and specular-Adam leaves, and the
    specular weights and the ASG features changed from step 1 to 30.
    Returns (model path, forward launches, backward launches)."""
    import numpy as np

    model = os.path.join(WORK, "fish_mcmc_model")
    summary, fwd, bwd = train_cli_run("fisheye_mcmc hybrid", [
        "-s", data, "-m", model, "--preset", "fisheye_mcmc", "--hybrid",
        "--init_type", "sfm", "--iterations", str(TRAIN_ITERS), *MCMC_WINDOW,
        "--test_iterations", str(TRAIN_ITERS), "--save_iterations", str(TRAIN_ITERS),
        "--checkpoint_iterations", "1", str(TRAIN_ITERS), "--device", "cuda"])
    losses = summary["losses"]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    check(last < first, f"fisheye_mcmc loss did not fall: first 5 {first:.5f}, "
                        f"last 5 {last:.5f}")
    ck = {it: np.load(os.path.join(model, f"chkpnt{it}.npz")) for it in (1, TRAIN_ITERS)}
    keys = (["v2|.base.g.asg", "v2|.base.spec_opt[1].count"]
            + [f"v2|.base.spec.{k}" for k in SPEC_NAMES]
            + [f"v2|.base.spec_opt[0].{m}.{k}" for m in ("mu", "nu") for k in SPEC_NAMES])
    missing = [k for k in keys if k not in ck[TRAIN_ITERS].files]
    check(not missing, f"the checkpoint lacks {missing}")
    check(int(ck[TRAIN_ITERS]["v2|.base.spec_opt[0].count"]) == TRAIN_ITERS,
          "the specular MLP did not step every iteration")
    moved = {k: float(np.abs(ck[TRAIN_ITERS][k] - ck[1][k]).max())
             for k in [f"v2|.base.spec.{k}" for k in SPEC_NAMES] + ["v2|.base.g.asg"]}
    print("fisheye_mcmc hybrid: largest change from step 1 to step "
          f"{TRAIN_ITERS}: " + json.dumps({k[8:]: f"{v:.3e}" for k, v in moved.items()}))
    check(all(v > 0 for v in moved.values()), f"unchanged leaves: {moved}")
    return model, fwd, bwd


def relocation_full_width(model, data, device):
    """Relocation at full width (step 14c): the trained hybrid fisheye model
    and its Adam moments restored, the raw opacity of a seeded 1 % of the
    live slots set to -10, then `mcmc_step`, its draws recorded. Checks:
    n_relocated is that count (plus any slot already under the floor); each
    moved row (the dead slots in index order) holds its source's xyz, SH,
    quaternion and ASG features; the rows relocation merged (and growth did
    not touch again) hold `compute_relocation`'s opacity and scale at their
    source's n_merge (rtol 1e-5); the Adam moments are zero on every reset
    row. Returns (the trainer, its scene)."""
    import torch
    from bags_tpu_torch.cli import render as render_cli
    from bags_tpu_torch.model import mcmc
    from bags_tpu_torch.train.loop import mcmc_step

    cfg, scene, _, it, trainer = render_cli.restore_trained(model, data, -1, device)
    trainer.load_checkpoint(os.path.join(model, f"chkpnt{it}.npz"))
    base = trainer.base
    g = base.g
    with torch.no_grad():
        live = torch.nonzero(base.alive & (torch.sigmoid(g.opacity_raw) > 0.005)
                             ).squeeze(1)
        gen = torch.Generator(device=device).manual_seed(14)
        pick = live[torch.randperm(live.numel(), generator=gen, device=device)
                    [:live.numel() // 100]]
        g.opacity_raw[pick] = -10.0
        dead = base.alive & (torch.sigmoid(g.opacity_raw) <= cfg.opacity_threshold)
        dead_idx = torch.nonzero(dead).squeeze(1)
        before = {k: t.detach().clone() for k, t in g.fields().items()}
        alive_before = base.alive.clone()
    draws, sample = [], mcmc._sample_by_opacity

    def recording(*args):
        draws.append(sample(*args))
        return draws[-1]

    mcmc._sample_by_opacity = recording
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_rel, n_add = mcmc_step(base, cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        mcmc._sample_by_opacity = sample
    src, grow_src = draws
    print(f"full-width relocation: {pick.numel()} of {live.numel()} live slots set "
          f"to raw opacity -10 ({dead_idx.numel()} under the floor), relocated "
          f"{n_rel}, added {n_add}, mcmc_step {ms:.2f} ms")
    check(n_rel == dead_idx.numel() >= pick.numel(),
          f"relocated {n_rel}, {dead_idx.numel()} under the floor, {pick.numel()} set")
    with torch.no_grad():
        for k in ("xyz", "sh_dc", "sh_rest", "quats", "asg"):
            check(torch.equal(getattr(g, k)[dead_idx], before[k][src]),
                  f"a moved row's {k} is not its source's")
        sources, inv, counts = torch.unique(src, return_inverse=True,
                                            return_counts=True)
        new_o, new_s = mcmc.compute_relocation(
            torch.sigmoid(before["opacity_raw"][sources]),
            torch.exp(before["scales_log"][sources]), counts + 1)
        new_o = torch.clamp(new_o, cfg.opacity_threshold, 1.0 - 1e-7)
        rows = torch.cat([sources, dead_idx])
        want_o, want_s = torch.cat([new_o, new_o[inv]]), torch.cat([new_s, new_s[inv]])
        regrown = torch.zeros_like(base.alive)
        regrown[grow_src] = True
        keep = ~regrown[rows]
        err_o = ((torch.sigmoid(g.opacity_raw[rows]) - want_o).abs() / want_o)[keep].max()
        err_s = ((torch.exp(g.scales_log[rows]) - want_s).abs() / want_s)[keep].max()
        print(f"full-width relocation: {sources.numel()} sources, n_merge up to "
              f"{int(counts.max()) + 1}; merged opacity and scale off "
              f"compute_relocation by {float(err_o):.2e} and {float(err_s):.2e} "
              f"(relative) on {int(keep.sum())} rows")
        check(float(err_o) <= 1e-5 and float(err_s) <= 1e-5,
              "merged opacity or scale off compute_relocation")
        reset = torch.zeros_like(base.alive)
        reset[dead_idx] = True
        reset[sources] = True
        reset[grow_src] = True
        reset |= base.alive & ~alive_before
        for group in base.g_opt.param_groups:
            st = base.g_opt.state[group["params"][0]]
            check(not st["exp_avg"][reset].any() and not st["exp_avg_sq"][reset].any(),
                  f"Adam moments of group {group['name']} not zeroed")
    return trainer, scene


def pose_mcmc_hybrid_path(data):
    """Pose mode with `--mcmc --hybrid` (step 14d): `cli.train --preset
    pose_noise --init_type sfm --mcmc --hybrid` on step 5's dataset for 30
    iterations (`train_cli_run`'s checks: the MCMC regularisers are in its
    loss), then the render CLI restores it: one forward launch a view,
    finite PSNR; then the restored model's step split by stage
    (`stagebench.train_step_stages`, with the hybrid and MCMC stages).
    Returns (forward launches of training, backward launches, forward
    launches of the restore)."""
    import math

    import torch
    from bags_tpu_torch.cli import render as render_cli
    from bags_tpu_torch.raster import composite
    from bags_tpu_torch.tools import stagebench

    model = os.path.join(WORK, "pose_mcmc_model")
    _, fwd, bwd = train_cli_run("pose mcmc hybrid", [
        "-s", data, "-m", model, "--preset", "pose_noise", "--init_type", "sfm",
        "--mcmc", "--hybrid", "--iterations", str(TRAIN_ITERS), *MCMC_WINDOW,
        "--test_iterations", str(TRAIN_ITERS), "--save_iterations", str(TRAIN_ITERS),
        "--checkpoint_iterations", str(TRAIN_ITERS), "--device", "cuda"])
    composite.fwd_launches = 0
    t0 = time.perf_counter()
    summary = render_cli.main(["-m", model, "-s", data, "--device", "cuda"])
    torch.cuda.synchronize()
    psnrs = {k: v["psnr"] for k, v in summary.items()}
    n_views = sum(len(v) for v in psnrs.values())
    print(f"pose mcmc hybrid restore: {n_views} views in "
          f"{time.perf_counter() - t0:.1f} s, PSNR {psnrs}, forward launches "
          f"{composite.fwd_launches}")
    check(n_views == N_CAMS and composite.fwd_launches == n_views,
          f"{composite.fwd_launches} forward launches for {n_views} views")
    check(all(math.isfinite(p) for v in psnrs.values() for p in v),
          "non-finite PSNR after the hybrid restore")
    n_restore = composite.fwd_launches
    cfg, scene, state = render_cli.restore_trained(model, data, -1,
                                                   torch.device("cuda"))[:3]
    st = stagebench.train_step_stages(state, scene, cfg, torch.device("cuda"))
    keys = ("specular", "mcmc_regularisers", "specular_fwd_alone",
            "specular_bwd_alone", "mcmc_step", "mcmc_noise_step")
    missing = [k for k in keys if k not in st["stages_ms"]]
    check(not missing, f"the hybrid pose stage split lacks {missing}")
    return fwd, bwd, n_restore


def hybrid_stage_split(trainer, scene, device):
    """The hybrid MCMC fisheye step split by stage (step 14e):
    `stagebench.fisheye_step_stages` on the trainer of step 14c, with a
    profiler trace: the specular colour's forward and backward, one
    `mcmc_step`, `mcmc_noise_step`, the step over 5 steps, the peak memory,
    the device-busy share and the launches."""
    from bags_tpu_torch.tools import stagebench

    out = stagebench.fisheye_step_stages(trainer, scene.fish_image(0), device,
                                         os.path.join(WORK, "fish_mcmc_trace"))
    st, tr = out["stages_ms"], out["trace"]
    keys = ("specular", "specular_fwd_alone", "specular_bwd_alone",
            "specular_fwd_bwd_alone", "mcmc_step", "mcmc_noise_step")
    missing = [k for k in keys if k not in st]
    check(not missing, f"the hybrid stage split lacks {missing}")
    print("hybrid fisheye step: " + json.dumps(
        {**{k: round(st[k], 3) for k in keys},
         "step_ms": [round(x, 2) for x in out["step_ms"]],
         "peak_gib": round(out["peak_gib"], 2),
         "busy_share": round(tr["busy_ms"] / max(tr["span_ms"], 1e-9), 4),
         "launches": tr["launches"]}))


def jax_recovery_keys():
    """The keys of the JAX package's `tools/lens_recovery.py` JSON line, read
    from its source without importing it."""
    import ast

    with open(os.path.join(REPO, "tools", "lens_recovery.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "dict" \
                and any(k.arg == "metric" for k in node.keywords):
            return [k.arg for k in node.keywords]
    raise RuntimeError("tools/lens_recovery.py: no JSON dict found")


def recovery_path():
    """Known-lens recovery on the card (step 13): the port's
    `tools/lens_recovery.py` in-process with the JAX CPU test's pre-fit
    length (600) and lens lr (3e-5), 500 iterations, the tool's defaults
    otherwise (400x400, 20,000 Gaussians, 12 cameras). Checks the JAX tool's
    keys, finite numbers and a flow error that falls. Returns the forward
    and backward launches."""
    import math

    import torch
    from bags_tpu_torch.raster import composite
    from bags_tpu_torch.tools import lens_recovery

    lens_recovery.PREFIT_ITERS = 600
    composite.fwd_launches = composite.bwd_launches = 0
    t0 = time.perf_counter()
    out = lens_recovery.main(["--iters", "500", "--report_every", "100",
                              "--iresnet_lr", "3e-5", "--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    fwd, bwd = composite.fwd_launches, composite.bwd_launches
    print(f"lens recovery: {secs:.1f} s ({out['s_per_iter']} s an iteration), "
          f"flow error {out['flow_err_init_px']} -> {out['flow_err_final_px']} px, "
          f"forward launches {fwd}, backward launches {bwd}")
    check(list(out) == jax_recovery_keys(), f"recovery keys {list(out)}")
    numbers = [v for v in out.values() if isinstance(v, (int, float))]
    check(all(math.isfinite(v) for v in numbers), f"non-finite recovery: {out}")
    check(bwd == 500, f"{bwd} backward launches for 500 recovery steps")
    check(out["flow_err_final_px"] < out["flow_err_init_px"],
          f"the flow error did not fall: {out['flow_err_init_px']} -> "
          f"{out['flow_err_final_px']} px")
    return fwd, bwd


# Step 15: slice 5's second part, the evaluation tools, on the models that
# steps 6, 8 and 14b left under WORK. The sequential path runs one frame
# per optimised train camera (7 of the 8 with --eval).
SEQ_FRAMES = 7
VGG16_WIDTHS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)


def trajectory_runs(model, data, runs, device, trained=None):
    """The trajectory CLI on `model`, once per (name, argv, forward launches
    a frame) of `runs` (the model restored once, or `trained` given).
    Checks each run's launches, no backward launch, finite frames of the
    expected size. Returns ({name: summary}, {name: forward launches})."""
    import numpy as np
    import torch
    from PIL import Image
    from bags_tpu_torch.cli import render as render_cli
    from bags_tpu_torch.cli import render_trajectory as traj_cli
    from bags_tpu_torch.raster import composite

    t0 = time.perf_counter()
    if trained is None:
        trained = render_cli.restore_trained(model, data, -1, device)
    print(f"trajectory: restored {model} in {time.perf_counter() - t0:.1f} s")
    outs, launches = {}, {}
    for name, argv, per_frame, size in runs:
        composite.fwd_launches = composite.bwd_launches = 0
        out = traj_cli.main(["-m", model, "-s", data, "--device", "cuda", "--out",
                             os.path.join(WORK, f"trajectory_{name}")] + argv,
                            trained=trained)
        fwd, bwd = composite.fwd_launches, composite.bwd_launches
        frames = sorted(f for f in os.listdir(out["dir"]) if f.endswith(".png"))
        shapes = {np.asarray(Image.open(os.path.join(out["dir"], f))).shape
                  for f in (frames[0], frames[-1])}
        print(f"trajectory {name}: {out['frames']} frames {shapes}, forward "
              f"launches {fwd}, lens warp {out['lens_warp']}, specular "
              f"{out['specular']}, ms a frame: render "
              + " ".join(f"{1e3 * s:.1f}" for s in out["render_s"]) + ", PNG "
              + " ".join(f"{1e3 * s:.1f}" for s in out["png_s"]))
        check(len(frames) == out["frames"] > 0, f"{name}: {len(frames)} PNGs")
        check(fwd == per_frame * out["frames"],
              f"{name}: {fwd} forward launches for {out['frames']} frames")
        check(bwd == 0, f"{name}: {bwd} backward launches")
        check(out["finite"], f"{name}: a non-finite frame")
        check(shapes == {size + (3,)}, f"{name}: frames {shapes}, not {size}")
        outs[name], launches[name] = out, fwd
    torch.cuda.synchronize()
    return trained, outs, launches


def trajectory_path(model, data, device):
    """Step 15a: trajectories on step 6's model: sequential (one frame per
    optimised train camera), spiral (4 frames) and a 150-degree panorama (2
    poses, five face renders each), frames 1600x1080, no lens warp and no
    specular colour; the sequential frame 0 against `render` at the
    optimised camera 0, as 8-bit values: at most 1e-4 of them more than one
    level off (the path camera is the optimised one through a rotation
    matrix and back). Returns (the restored model, {run: forward
    launches}, {run: summary})."""
    import numpy as np
    import torch
    from PIL import Image
    from bags_tpu_torch.raster.render import RenderConfig, render

    size = (HEIGHT, WIDTH)
    trained, outs, launches = trajectory_runs(model, data, [
        ("sequential", ["--mode", "sequential", "--n_frames", str(SEQ_FRAMES)], 1, size),
        ("spiral", ["--mode", "spiral", "--n_frames", "4"], 1, size),
        ("panorama", ["--panorama_fov", "150", "--n_frames", "2"], 5, size)], device)
    check(outs["sequential"]["frames"] == SEQ_FRAMES,
          f"{outs['sequential']['frames']} sequential frames")
    check(not any(o["lens_warp"] or o["specular"] for o in outs.values()),
          "a lens warp or specular colour on the pose model")
    cfg, scene, state, _, _ = trained
    g = state.g
    with torch.no_grad():
        img = render(g.xyz, g.scaling(), g.quats, g.opacity(state.alive),
                     g.sh_coeffs(), state.cams[0], scene.static,
                     RenderConfig(sh_degree=cfg.model.sh_degree),
                     bg=torch.full((3,), float(cfg.model.white_background),
                                   device=device), align=state.align).render
    want = (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
    got = np.asarray(Image.open(os.path.join(outs["sequential"]["dir"], "00000.png")))
    diff = np.abs(got.astype(np.int16) - want)
    off = float((diff > 1).mean())
    print(f"trajectory sequential frame 0 against the optimised camera 0: max "
          f"{int(diff.max())} levels, {off:.2e} of the values more than one off")
    check(off <= 1e-4, f"sequential frame 0: {off:.2e} of the values off")
    return trained, launches, outs


def fisheye_trajectory_path(model, data, device):
    """Step 15b: 4 orbit frames on step 14b's `fisheye_mcmc --hybrid` model:
    through the lens warp, with the specular colour, at the fisheye
    sensor's size (`fish/images`). Returns the forward launches."""
    import numpy as np
    from PIL import Image

    name = sorted(os.listdir(os.path.join(data, "fish", "images")))[0]
    size = np.asarray(Image.open(os.path.join(data, "fish", "images", name))).shape[:2]
    trained, outs, launches = trajectory_runs(
        model, data, [("fisheye_orbit", ["--mode", "orbit", "--n_frames", "4"], 1,
                       size)], device)
    out = outs["fisheye_orbit"]
    check(out["lens_warp"] and out["specular"],
          "the fisheye frames skipped the lens warp or the specular colour")
    del trained
    return launches["fisheye_orbit"]


def viewer_request(cam, width, height):
    """A SIBR request for camera `cam` as the viewer sends it: the w2c
    matrix transposed, its y / z columns flipped."""
    import numpy as np
    from bags_tpu_torch.core.camera import pose_w2c

    R, t = (x.detach().cpu().numpy().astype(np.float64) for x in pose_w2c(cam))
    w2c = np.eye(4)
    w2c[:3, :3], w2c[:3, 3] = R, t
    view = w2c.T.copy()
    view[:, 1] *= -1
    view[:, 2] *= -1
    return dict(resolution_x=width, resolution_y=height,
                      fov_x=float(cam.fovx), fov_y=float(cam.fovy), z_near=0.01,
                      z_far=100.0, shs_python=False, rot_scale_python=False,
                      scaling_modifier=1.0, keep_alive=False,
                      view_matrix=view.reshape(-1).tolist(),
                      view_projection_matrix=np.eye(4).reshape(-1).tolist())


def viewer_path(trained, device):
    """Step 15c: the network viewer (`eval/network_gui.NetworkGUI` on a free
    local port) against step 6's model: a client thread sends two SIBR
    requests at 1600x1080 (train cameras 0 and 1; the second asks training
    to go on), one poll serves both through the train CLI's
    `viewer_render`: one forward launch a frame, and each frame's bytes
    equal to `viewer_render` at that request's camera. Returns the
    forward launches."""
    import socket
    import threading

    import numpy as np
    import torch
    from bags_tpu_torch.cli.train import viewer_render
    from bags_tpu_torch.eval.network_gui import NetworkGUI
    from bags_tpu_torch.raster import composite

    _, _, state, _, trainer = trained
    msgs = []
    for i, train in ((0, False), (1, True)):
        msgs.append(dict(viewer_request(state.cams[i], WIDTH, HEIGHT), train=train))
    frames, connected = [], threading.Event()
    n_bytes = WIDTH * HEIGHT * 3

    def client(port):
        with socket.create_connection(("127.0.0.1", port), timeout=120) as c:
            connected.set()
            for msg in msgs:
                data = json.dumps(msg).encode()
                c.sendall(len(data).to_bytes(4, "little") + data)
                buf = b""
                while len(buf) < n_bytes + 4 + len("chip_smoke"):
                    chunk = c.recv(1 << 20)
                    check(chunk, "the viewer connection closed early")
                    buf += chunk
                frames.append(buf[:n_bytes])

    gui = NetworkGUI("127.0.0.1", 0)
    thread = threading.Thread(target=client, args=(gui.listener.getsockname()[1],))
    thread.start()
    check(connected.wait(60), "the viewer client did not connect")
    reqs = []

    def render_fn(req):
        reqs.append(req)
        return viewer_render(trainer, req)

    composite.fwd_launches = composite.bwd_launches = 0
    t0 = time.perf_counter()
    gui.poll(render_fn, "chip_smoke", training_done=False)
    thread.join(timeout=120)
    secs = time.perf_counter() - t0
    fwd = composite.fwd_launches
    gui.close()
    check(not thread.is_alive() and len(frames) == 2, f"{len(frames)} frames served")
    check(fwd == 2, f"{fwd} forward launches for 2 viewer frames")
    for req, frame in zip(reqs, frames):
        img = torch.clamp(viewer_render(trainer, req), 0, 1).cpu().numpy()
        want = (img * 255).astype(np.uint8).transpose(1, 2, 0).tobytes()
        check(frame == want, "a served frame is not the render at its camera")
    print(f"viewer: 2 frames at {WIDTH}x{HEIGHT} served in {secs:.2f} s, forward "
          f"launches {fwd}, bytes equal to the render at each request's camera")
    return fwd


def write_lpips_dir(root):
    """Seeded random LPIPS weights at full widths in the upstream layouts:
    a torchvision vgg16 backbone (He-scaled normal convs, zero biases) and
    an LPIPS v0.1 `vgg.pth` (non-negative linear weights)."""
    import numpy as np
    import torch
    from bags_tpu_torch.eval.lpips_weights import VGG16_CONV_IDX

    rng = np.random.default_rng(15)
    sd, c_in = {}, 3
    for idx, c in zip(VGG16_CONV_IDX, VGG16_WIDTHS):
        sd[f"features.{idx}.weight"] = torch.as_tensor(rng.normal(
            0, np.sqrt(2.0 / (9 * c_in)), (c, c_in, 3, 3)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.zeros(c)
        c_in = c
    lin = {f"lin{k}.model.1.weight": torch.as_tensor(np.abs(rng.normal(
        0, 0.1, (1, c, 1, 1))).astype(np.float32))
        for k, c in enumerate(VGG16_WIDTHS[i] for i in (1, 3, 6, 9, 12))}
    os.makedirs(root, exist_ok=True)
    torch.save(sd, os.path.join(root, "vgg16-397923af.pth"))
    torch.save(lin, os.path.join(root, "vgg.pth"))
    return root


def metrics_path(trained, model, device):
    """Step 15d: the metrics CLI over step 8's render output of step 6's
    model, LPIPS from `write_lpips_dir`'s weights: both splits' PSNR, SSIM
    and LPIPS finite under the JAX CLI's keys; one view's LPIPS on the card
    against the CPU on a 256x256 crop (rtol 1e-4); the LPIPS time of a
    1600x1080 pair; then `plot_poses` on the model's cameras, run or
    skipped where matplotlib is absent. Returns (card ms, CPU-crop
    relative error)."""
    import math

    import torch
    from bags_tpu_torch.cli import metrics as metrics_cli
    from bags_tpu_torch.eval.metrics import Lpips
    from bags_tpu_torch.eval.vis import plot_poses
    from bags_tpu_torch.utils.profiling import timed

    weights = write_lpips_dir(os.path.join(WORK, "lpips"))
    os.environ["BAGS_TPU_LPIPS_WEIGHTS"] = weights
    try:
        t0 = time.perf_counter()
        results = metrics_cli.main(["-m", model, "--device", "cuda"])[model]
        secs = time.perf_counter() - t0
    finally:
        del os.environ["BAGS_TPU_LPIPS_WEIGHTS"]
    with open(os.path.join(model, "per_view.json")) as f:
        per_view = json.load(f)
    print(f"metrics CLI: {secs:.1f} s, " + json.dumps(results))
    check(sorted(results) == sorted(per_view) == ["test/ours_30", "train/ours_30"],
          f"metrics keys {sorted(results)}")
    for key, vals in results.items():
        check(list(vals) == ["PSNR", "SSIM", "LPIPS"], f"{key}: {list(vals)}")
        check(all(isinstance(v, float) and math.isfinite(v) for v in vals.values()),
              f"{key}: {vals}")
        check(all(math.isfinite(v) for m in per_view[key].values() for v in m.values()),
              f"{key}: a non-finite per-view value")

    view = os.path.join(model, "test", "ours_30")
    r, g = (metrics_cli.load_image(os.path.join(view, sub, "00000.png"), device)
            for sub in ("renders", "gt"))
    lp_card = Lpips(weights, net="vgg").to(device)
    with torch.no_grad():
        ms = timed(lambda: lp_card(r, g), device, 5)
        h, w = r.shape[1:]                 # the centred 256x256 crop
        crop = (slice(None), slice(max(h // 2 - 128, 0), h // 2 + 128),
                slice(max(w // 2 - 128, 0), w // 2 + 128))
        card = float(lp_card(r[crop], g[crop]))
        cpu = float(Lpips(weights, net="vgg")(r[crop].cpu(), g[crop].cpu()))
    rel = abs(card - cpu) / abs(cpu)
    print(f"LPIPS vgg at {WIDTH}x{HEIGHT}: {ms:.2f} ms on the card; 256x256 crop "
          f"card {card:.7f} CPU {cpu:.7f}, relative difference {rel:.2e}")
    check(rel <= 1e-4, f"LPIPS card against CPU: {rel:.2e}")

    _, scene, state, _, _ = trained
    path = os.path.join(WORK, "poses.png")
    try:
        plot_poses(state.cams, scene.train_cams_clean, path=path)
        print(f"plot_poses: wrote {os.path.getsize(path)} bytes")
    except ImportError as e:
        print(f"plot_poses: skipped, matplotlib is absent ({e})")
    return ms, rel


def bench_path(smi):
    """Step 15e: `cli.bench` (default and `--large`) and `cli.bench_calib`
    (fisheye and cubemap at their defaults) in-process. Checks one JSON
    line each with the keys and a positive rate, and the launches: one
    forward and one backward a step (21 for the bench, 11 for each
    bench_calib mode, five of each a cubemap step). Returns ({line's
    metric: line}, {path: (forward, backward) launches})."""
    from bags_tpu_torch.cli import bench as bench_cli
    from bags_tpu_torch.cli import bench_calib as bench_calib_cli
    from bags_tpu_torch.raster import composite

    lines, launches = {}, {}
    runs = [("bench", lambda: [bench_cli.main()], bench_cli.ITERS + 1),
            ("bench_large", lambda: [bench_cli.main(large=True)], bench_cli.ITERS + 1),
            ("bench_calib_fisheye", lambda: bench_calib_cli.main(
                ["--mode", "fisheye", "--device", "cuda"]), 11),
            ("bench_calib_cubemap", lambda: bench_calib_cli.main(
                ["--mode", "cubemap", "--device", "cuda"]), 5 * 11)]
    for name, run, steps in runs:
        composite.fwd_launches = composite.bwd_launches = 0
        t0 = time.perf_counter()
        [line] = run()
        secs = time.perf_counter() - t0
        fwd, bwd = composite.fwd_launches, composite.bwd_launches
        print(f"{name}: {line['value']} pixels/s ({smi}), {secs:.1f} s, "
              f"forward launches {fwd}, backward launches {bwd}")
        check(sorted(line) == ["metric", "precision", "unit", "value", "vs_baseline"]
              and line["value"] > 0 and line["precision"] == "exact", f"{name}: {line}")
        check(fwd == bwd == steps, f"{name}: {fwd} forward and {bwd} backward "
                                   f"launches for {steps}")
        lines[line["metric"]] = line
        launches[name] = (fwd, bwd)
    return lines, launches

def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False: needs a card")
    if not os.path.isdir(os.path.join(REPO, "bags_tpu_torch")):
        sys.exit("chip_smoke: bags_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, REPO)
    from bags_tpu_torch.cli import render as render_cli
    from bags_tpu_torch.raster import composite
    from bags_tpu_torch.tools import kernablate as ka
    from bags_tpu_torch.tools import stagebench

    device = torch.device("cuda")
    t_all = time.perf_counter()
    step_s, last = {}, [t_all]

    def lap(step):
        """Seconds since the previous lap, as step `step`'s."""
        now = time.perf_counter()
        step_s[step] = round(now - last[0], 1)
        last[0] = now

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    lap(1)

    # 2. build the three kernel sources, in parallel
    t0 = time.perf_counter()
    sos = composite.build()
    for name, so in sos.items():
        secs, report = composite.build_log.get(name, (0.0, "(built before)"))
        print(f"built {os.path.relpath(so, REPO)} in {secs:.2f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print(f"build wall time {time.perf_counter() - t0:.2f} s")
    for name in ("composite_fwd", "composite_bwd"):
        print(f"{name} resources: {composite.kernel_info(name)}")
    for name in ka.MODES + ka.VARIANTS:
        print(f"kernablate {name} resources: {ka.kernel_info(name)}")
    lap(2)

    # 3. the kernels against their plain versions at test sizes
    test_size_checks(device)
    variants_test = ablation_test_size(device)
    lap(3)
    # 4. camera gradients on the card, pose recovery
    camera_grad_check(device)
    pose_recovery(device)
    lap(4)

    # 5. the render path at full width (slice 1)
    shutil.rmtree(WORK, ignore_errors=True)
    t0 = time.perf_counter()
    model, data, scene = write_dataset(device)
    print(f"wrote {N_GAUSS}-Gaussian PLY and {N_CAMS}-camera dataset at "
          f"{WIDTH}x{HEIGHT} in {time.perf_counter() - t0:.1f} s")
    view0, fwd_entry = render_path(model, data, scene, device)
    del scene
    ablate_entry, fori_entry = ablation_full_width(view0, fwd_entry)
    del view0
    lap(5)

    # 6. the training path at full width
    train_model, train_fwd, train_bwd = train_path(data)
    fwd_entry["launches"] = train_fwd
    fwd_entry["launches_by_path"]["train_cli"] = train_fwd
    lap(6)

    # 7. the backward kernel at full width on the trained model
    # the trainer (the fifth value) is not kept: `del state` below frees the model
    cfg, scene, state = render_cli.restore_trained(train_model, data, -1, device)[:3]
    fwd_train, bwd_entry = backward_full_width(state, scene, device)
    fwd_entry.update(fwd_train, **composite.kernel_info("composite_fwd"))
    bwd_entry["launches"] = train_bwd
    variants = fori_entry["variants"]
    merge_variants(variants, variants_test)
    merge_variants(variants, train_view_variants(state, scene), "_train_view0")
    lap(7)
    # 8. restore in the render CLI, test-time pose optimisation
    restore_path(train_model, data)
    lap(8)
    # 9. where a training step's time goes
    stagebench.train_step_stages(state, scene, cfg, device)
    del state, scene
    lap(9)
    # 10. this slice's main path: the profiling tools
    launches = tools_path(device)
    errs = tools_workload_checks(device)
    for entry in (fwd_entry, bwd_entry, fori_entry):
        entry["max_abs_err_tools_workload"] = errs[entry["name"]]
    ablate_entry["max_abs_err_tools_workload"] = {
        m: errs[f"composite_ablate:{m}"] for m in ka.MODES}
    merge_variants(variants, errs["variants"], "_tools_workload")

    for name, res in variants.items():
        res["launches"] = launches["kernablate_real"][f"composite_fwd_variant:{name}"]
        check(all(res["identical"].values()), f"variant {name}: {res['identical']}")
    for entry in (fwd_entry, bwd_entry):
        entry.setdefault("launches_by_path", {"train_cli": entry["launches"]})
        for tool in ("profile", "stagebench", "kernablate_real"):
            entry["launches_by_path"][tool] = launches[tool][entry["name"]]
    ablate_entry["launches_by_mode"] = {
        m: launches["kernablate"][f"composite_ablate:{m}"] for m in ka.MODES}
    ablate_entry["launches"] = sum(ablate_entry["launches_by_mode"].values())
    fori_entry["launches"] = launches["kernablate_real"]["composite_fwd_fori"]
    lap(10)

    # 11. slice 4's main path: fisheye lens calibration at full width
    print(f"step 10 done at {time.perf_counter() - t_all:.1f} s")
    fisheye_toy_check(device)
    t0 = time.perf_counter()
    write_fisheye_gt(model, data, device)
    print(f"wrote the fisheye GT in {time.perf_counter() - t0:.1f} s")
    fish_model, fish_fwd, fish_bwd, _ = fisheye_train_path(data)
    fwd_entry["launches_by_path"]["train_cli_fisheye"] = fish_fwd
    bwd_entry["launches_by_path"]["train_cli_fisheye"] = fish_bwd
    fwd_entry["launches_by_path"]["render_cli_fisheye"] = fisheye_restore_path(
        fish_model, data)
    fish_fwd_view, fish_bwd_view = fisheye_checks(fish_model, data, device)
    fwd_entry.update(fish_fwd_view)
    bwd_entry.update(fish_bwd_view)
    print(f"step 11 done at {time.perf_counter() - t_all:.1f} s")
    lap(11)

    # 12. slice 4's cubemap path at full width
    t0 = time.perf_counter()
    cubemap_toy_check(device)
    cube_data, _, _ = write_cubemap_data(model, device)
    print(f"wrote the cubemap dataset in {time.perf_counter() - t0:.1f} s")
    cube_model, cube_fwd, cube_bwd, _ = cubemap_train_path(cube_data)
    fwd_entry["launches_by_path"]["train_cli_cubemap"] = cube_fwd
    bwd_entry["launches_by_path"]["train_cli_cubemap"] = cube_bwd
    fwd_entry["launches_by_path"]["render_cli_cubemap"] = cubemap_restore_path(
        cube_model, cube_data)
    cube_fwd_faces, cube_bwd_faces = cubemap_checks(cube_model, cube_data, device)
    fwd_entry.update(cube_fwd_faces)
    bwd_entry.update(cube_bwd_faces)
    print(f"step 12 took {time.perf_counter() - t0:.1f} s")
    lap(12)

    # 13. known-lens recovery
    t0 = time.perf_counter()
    rec_fwd, rec_bwd = recovery_path()
    fwd_entry["launches_by_path"]["lens_recovery"] = rec_fwd
    bwd_entry["launches_by_path"]["lens_recovery"] = rec_bwd
    print(f"step 13 took {time.perf_counter() - t0:.1f} s")
    lap(13)

    # 14. slice 5's main path: MCMC and the hybrid specular colour
    t0 = time.perf_counter()
    hybrid_toy_checks(device)
    t1 = time.perf_counter()
    mcmc_model, mcmc_fwd, mcmc_bwd = fisheye_mcmc_train_path(data)
    fwd_entry["launches_by_path"]["train_cli_fisheye_mcmc_hybrid"] = mcmc_fwd
    bwd_entry["launches_by_path"]["train_cli_fisheye_mcmc_hybrid"] = mcmc_bwd
    fwd_entry["launches_by_path"]["render_cli_fisheye_mcmc_hybrid"] = (
        fisheye_restore_path(mcmc_model, data))
    print(f"step 14b took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    mcmc_trainer, mcmc_scene = relocation_full_width(mcmc_model, data, device)
    hybrid_stage_split(mcmc_trainer, mcmc_scene, device)
    del mcmc_trainer, mcmc_scene
    print(f"steps 14c and 14e took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    pose_fwd, pose_bwd, pose_render = pose_mcmc_hybrid_path(data)
    fwd_entry["launches_by_path"]["train_cli_pose_mcmc_hybrid"] = pose_fwd
    bwd_entry["launches_by_path"]["train_cli_pose_mcmc_hybrid"] = pose_bwd
    fwd_entry["launches_by_path"]["render_cli_pose_mcmc_hybrid"] = pose_render
    print(f"step 14d took {time.perf_counter() - t1:.1f} s; step 14 took "
          f"{time.perf_counter() - t0:.1f} s")
    lap(14)

    # 15. slice 5's second part: the evaluation tools on the trained models
    t1 = time.perf_counter()
    trained, traj_fwd, _ = trajectory_path(train_model, data, device)
    print(f"step 15a took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    traj_fwd["fisheye_mcmc_hybrid"] = fisheye_trajectory_path(mcmc_model, data, device)
    print(f"step 15b took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    fwd_entry["launches_by_path"]["viewer"] = viewer_path(trained, device)
    for name, n in traj_fwd.items():
        fwd_entry["launches_by_path"][f"trajectory_{name}"] = n
    print(f"step 15c took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    metrics_path(trained, train_model, device)
    del trained
    print(f"step 15d took {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    _, bench_launches = bench_path(smi)
    for name, (fwd, bwd) in bench_launches.items():
        fwd_entry["launches_by_path"][name] = fwd
        bwd_entry["launches_by_path"][name] = bwd
    print(f"step 15e took {time.perf_counter() - t1:.1f} s")
    lap(15)

    # 16. the kernels line, then the device line
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print("step seconds " + json.dumps(step_s))
    shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"kernels": [fwd_entry, bwd_entry, ablate_entry, fori_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
