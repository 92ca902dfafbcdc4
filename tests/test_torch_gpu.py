"""On-card tests of the port's CUDA kernels (`gpu` marker). They skip without
a card. The file imports neither JAX nor `bags_tpu`, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from bags_tpu_torch.core.projection import project_gaussians
from bags_tpu_torch.raster import binning, composite, tiles
from bags_tpu_torch.raster.render import RenderConfig, build_packet_table, render
from bags_tpu_torch.tools import kernablate
from bags_tpu_torch.utils.testing import (alpha_boundary_rows, chunk_crossing_rows,
                                          make_toy_scene)

pytestmark = pytest.mark.gpu
ARGS = ("xyz", "scales", "quats", "opacity", "sh_coeffs")

SCENES = {
    "toy_sh3": (dict(n=700, width=64, height=48, sh_degree=3, seed=0), None),
    "unaligned_spill": (dict(n=700, width=64, height=48, seed=21,
                             scale_range=(0.01, 0.05)), None),
    # low opacities keep pixels compositing through > 4096 instances a tile
    "dense_tile": (dict(n=20000, width=32, height=32, seed=5,
                        scale_range=(0.1, 0.4)), (0.005, 0.02)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _scene(name, device):
    kw, opacity = SCENES[name]
    sc = make_toy_scene(**kw, device=device)
    if opacity is not None:
        sc["opacity"] = torch.as_tensor(np.random.default_rng(kw["seed"]).uniform(
            *opacity, kw["n"]).astype(np.float32), device=device)
    return sc


def _rows(sc):
    proj = project_gaussians(*[sc[k] for k in ARGS], sc["cam"], sc["static"],
                             sc["sh_degree"])
    tx, ty = tiles.tile_grid(sc["static"].width, sc["static"].height)
    bins = binning.bin_gaussians(proj, tx, ty)
    rows = build_packet_table(proj, proj.x2d, proj.y2d).index_select(
        1, bins.gauss_id)
    return rows, bins, tx, ty


@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernel_matches_plain(cuda, name):
    rows, bins, tx, ty = _rows(_scene(name, cuda))
    before = composite.fwd_launches
    kc, kt = composite.composite_fwd(rows, bins.tile_start, bins.tile_count, tx, ty)
    assert composite.fwd_launches == before + 1
    pc, pt = tiles.composite_tiles_plain(rows, bins.tile_start, bins.tile_count,
                                         tx, ty)
    torch.testing.assert_close(kc, pc, atol=2e-5, rtol=0)
    torch.testing.assert_close(kt, pt, atol=2e-5, rtol=0)
    if name == "dense_tile":
        assert int(bins.tile_count.max()) > 4096


def test_render_on_card_matches_cpu(cuda):
    cfg, bg = RenderConfig(sh_degree=3), [0.3, 0.6, 0.9]
    outs = []
    for dev in (cuda, torch.device("cpu")):
        sc = _scene("toy_sh3", dev)
        outs.append(render(*[sc[k] for k in ARGS], sc["cam"], sc["static"], cfg,
                           bg=torch.tensor(bg, device=dev)))
    for f in ("render", "t_final", "depth_map", "mean2d"):
        torch.testing.assert_close(getattr(outs[0], f).cpu(), getattr(outs[1], f),
                                   atol=2e-5, rtol=2e-5)
    assert torch.equal(outs[0].radii.cpu(), outs[1].radii)
    assert torch.equal(outs[0].gauss_id.cpu(), outs[1].gauss_id)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_backward_kernel_matches_plain(cuda, name):
    """The backward kernel against `composite_bwd_plain` with seeded random
    cotangents: within 1e-5 + 1e-3 |plain| element-wise. The dense tile's
    pixels composite ~1,000 low-opacity instances, and float32 rounding alone
    moves single entries of its opacity row past that (the plain version
    against its own float64 replay too), so there the criterion is
    chip_smoke.py's full-width one: relative L2 error of each row <= 1e-4
    and at most 1e-4 of the entries off."""
    rows, bins, tx, ty = _rows(_scene(name, cuda))
    args = (rows, bins.tile_start, bins.tile_count, tx, ty)
    color, t_final = composite.composite_fwd(*args)
    gen = torch.Generator().manual_seed(1)
    g_color = torch.randn(color.shape, generator=gen).to(cuda)
    g_t = torch.randn(t_final.shape, generator=gen).to(cuda)
    before = composite.bwd_launches
    got = composite.composite_bwd(*args, g_color, g_t, color, t_final)
    assert composite.bwd_launches == before + 1
    plain = tiles.composite_bwd_plain(*args, g_color, g_t, color, t_final)
    assert float(plain.abs().max()) > 1.0
    off = (got - plain).abs() > 1e-5 + 1e-3 * plain.abs()
    if name == "dense_tile":
        rel_l2 = torch.linalg.norm(got - plain, dim=1) / torch.linalg.norm(plain, dim=1)
        assert float(rel_l2.max()) <= 1e-4
        assert float(off.float().mean()) <= 1e-4
    else:
        assert not bool(off.any())


def _bwd_inputs(rows, bins, tx, ty, device, seed=1):
    args = (rows, bins.tile_start, bins.tile_count, tx, ty)
    color, t_final = composite.composite_fwd(*args)
    gen = torch.Generator().manual_seed(seed)
    g_color = torch.randn(color.shape, generator=gen).to(device)
    g_t = torch.randn(t_final.shape, generator=gen).to(device)
    return (*args, g_color, g_t, color, t_final)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_backward_kernel_is_deterministic(cuda, name):
    """Two launches of the backward kernel on the same inputs are bit for
    bit equal: its sums over a tile's pixels run in a fixed order and use
    no atomics."""
    bwd_args = _bwd_inputs(*_rows(_scene(name, cuda)), cuda)
    first = composite.composite_bwd(*bwd_args)
    second = composite.composite_bwd(*bwd_args)
    assert torch.equal(first, second)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_backward_kernel_alpha_edge(cuda, name):
    """Opacities that put one pair of every instance within 1e-6 relative
    of the alpha test's 1/255, on both sides (`alpha_boundary_rows`): the
    kernel's nonzero entries are exactly the plain version's, and every
    entry is within 1e-5 + 1e-3 |plain|. A pair that the kernel's exp skip
    dropped wrongly would leave its instance's gradient 0."""
    rows, bins, tx, ty = _rows(_scene(name, cuda))
    rows, alpha = alpha_boundary_rows(rows, bins.tile_start, bins.tile_count,
                                      tx, ty)
    a_min = tiles.ALPHA_MIN
    above = int(((alpha >= a_min) & (alpha <= a_min * (1 + 1e-6))).sum())
    below = int(((alpha < a_min) & (alpha >= a_min * (1 - 1e-6))).sum())
    assert min(above, below) >= 0.2 * rows.shape[1]
    bwd_args = _bwd_inputs(rows, bins, tx, ty, cuda)
    got = composite.composite_bwd(*bwd_args)
    plain = tiles.composite_bwd_plain(*bwd_args)
    assert torch.equal(got != 0, plain != 0)
    assert torch.equal((plain != 0).any(dim=0), alpha >= a_min)
    assert not bool(((got - plain).abs() > 1e-5 + 1e-3 * plain.abs()).any())


@pytest.mark.parametrize("name", sorted(SCENES))
def test_forward_kernel_alpha_edge(cuda, name):
    """The same edge opacities (`alpha_boundary_rows`) through the forward
    kernel: within 2e-5 of `composite_tiles_plain`, where a pair that its
    exp skip or footprint cull dropped wrongly would move the pixel by about
    1/255 of its colour and T; and two launches bit-identical."""
    rows, bins, tx, ty = _rows(_scene(name, cuda))
    rows, _ = alpha_boundary_rows(rows, bins.tile_start, bins.tile_count, tx, ty)
    args = (rows, bins.tile_start, bins.tile_count, tx, ty)
    kc, kt = composite.composite_fwd(*args)
    pc, pt = tiles.composite_tiles_plain(*args)
    torch.testing.assert_close(kc, pc, atol=2e-5, rtol=0)
    torch.testing.assert_close(kt, pt, atol=2e-5, rtol=0)
    kc2, kt2 = composite.composite_fwd(*args)
    assert torch.equal(kc, kc2) and torch.equal(kt, kt2)


def test_render_grads_on_card_match_cpu(cuda):
    """A render's gradients through both kernels against autograd through the
    plain compositor on the CPU: the Gaussians, the camera and the probes."""
    grads = []
    for dev in (cuda, torch.device("cpu")):
        sc = _scene("toy_sh3", dev)
        leaves = [sc[k].clone().requires_grad_(True) for k in ARGS]
        cam = sc["cam"]
        cam_leaves = {"dq": torch.tensor([0.0, 0.01, -0.02, 0.005], device=dev),
                      "dt": torch.tensor([0.02, -0.01, 0.03], device=dev),
                      "fovx": cam.fovx.clone(), "fovy": cam.fovy.clone()}
        for v in cam_leaves.values():
            v.requires_grad_(True)
        probes = [torch.zeros((700, 2), device=dev, requires_grad=True)
                  for _ in range(2)]
        before = composite.bwd_launches
        out = render(*leaves, dataclasses.replace(cam, **cam_leaves), sc["static"],
                     RenderConfig(sh_degree=3), bg=torch.tensor([0.3, 0.6, 0.9], device=dev),
                     probe2d=probes[0], abs_probe=probes[1])
        loss = (torch.mean((out.render - 0.25) ** 2) + 0.1 * out.t_final.mean()
                + 0.01 * out.depth_map.mean())
        loss.backward()
        assert composite.bwd_launches == before + (dev.type == "cuda")
        grads.append([x.grad.cpu() for x in leaves + list(cam_leaves.values()) + probes])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-3)


def test_wrapper_rejects_mixed_devices(cuda):
    rows, bins, tx, ty = _rows(_scene("toy_sh3", cuda))
    with pytest.raises(ValueError, match="tile_start"):
        composite.composite_fwd(rows, bins.tile_start.cpu(), bins.tile_count, tx, ty)


@pytest.mark.parametrize("mode", kernablate.MODES)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_ablation_kernel_matches_plain(cuda, name, mode):
    """Each ablation mode's kernel against `composite_ablate_plain`: t
    exactly 1 and no_transcendental's colour exactly 0 in both; dma_only
    within 1e-6 of max |plain| (its weight, power, is unbounded), no_scan
    and full within 2e-5."""
    rows, bins, tx, ty = _rows(_scene(name, cuda))
    args = (rows, bins.tile_start, bins.tile_count, tx, ty)
    before = kernablate.launches[mode]
    kc, kt = kernablate.composite_ablate(*args, mode)
    assert kernablate.launches[mode] == before + 1
    pc, pt = kernablate.composite_ablate_plain(*args, mode)
    assert bool((kt == 1).all()) and bool((pt == 1).all())
    if mode == "no_transcendental":
        assert float(kc.abs().max()) == 0.0 and float(pc.abs().max()) == 0.0
    elif mode == "dma_only":
        assert float((kc - pc).abs().max()) <= 1e-6 * float(pc.abs().max())
    else:
        torch.testing.assert_close(kc, pc, atol=2e-5, rtol=0)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_fori_kernel_is_the_forward(cuda, name):
    """The fori kernel is bit-identical to the forward kernel and within the
    forward's 2e-5 of `composite_tiles_plain`."""
    rows, bins, tx, ty = _rows(_scene(name, cuda))
    args = (rows, bins.tile_start, bins.tile_count, tx, ty)
    before = kernablate.launches["fori"]
    fc, ft = kernablate.composite_fwd_fori(*args)
    assert kernablate.launches["fori"] == before + 1
    kc, kt = composite.composite_fwd(*args)
    assert torch.equal(fc, kc) and torch.equal(ft, kt)
    pc, pt = tiles.composite_tiles_plain(*args)
    torch.testing.assert_close(fc, pc, atol=2e-5, rtol=0)
    torch.testing.assert_close(ft, pt, atol=2e-5, rtol=0)


@pytest.mark.parametrize("mode", kernablate.MODES)
def test_ablation_kernel_across_chunks(cuda, mode):
    """Each ablation mode's kernel against `composite_ablate_plain` where a
    tile starts mid-chunk, spans nine chunks and its 256-instance batches
    end mid-chunk (`chunk_crossing_rows`): the running sums must reset at
    each 128-slot boundary. t exactly 1, no_transcendental's colour exactly
    0, dma_only within 1e-6 of max |plain|; no_scan and full element-wise
    within 2e-5 + 1e-5 |plain| (chip_smoke.py's full-width criterion: a
    pixel sums up to nine chunks, past the values 2e-5 was set for)."""
    args = chunk_crossing_rows(cuda)
    kc, kt = kernablate.composite_ablate(*args, mode)
    pc, pt = kernablate.composite_ablate_plain(*args, mode)
    assert bool((kt == 1).all()) and bool((pt == 1).all())
    if mode == "no_transcendental":
        assert float(kc.abs().max()) == 0.0 and float(pc.abs().max()) == 0.0
    elif mode == "dma_only":
        assert float((kc - pc).abs().max()) <= 1e-6 * float(pc.abs().max())
    else:
        assert float(pc.abs().max()) > 1.0
        assert not bool(((kc - pc).abs() > 2e-5 + 1e-5 * pc.abs()).any())


@pytest.mark.parametrize("edge", [False, True], ids=["plain", "alpha_edge"])
@pytest.mark.parametrize("name", sorted(SCENES) + ["chunk_crossing"])
@pytest.mark.parametrize("variant", kernablate.VARIANTS)
def test_fwd_variant_is_the_forward(cuda, variant, name, edge):
    """Each variant of the forward (`kernablate.composite_fwd_variant`) is
    bit-identical to `composite_fwd`, also where every instance has a pair
    on the alpha test's edge (`alpha_boundary_rows`), where a wrong skip
    would change a pixel."""
    if name == "chunk_crossing":
        rows, start, count, tx, ty = chunk_crossing_rows(cuda)
    else:
        rows, bins, tx, ty = _rows(_scene(name, cuda))
        start, count = bins.tile_start, bins.tile_count
    if edge:
        rows, _ = alpha_boundary_rows(rows, start, count, tx, ty)
    args = (rows, start, count, tx, ty)
    before = kernablate.launches[variant]
    vc, vt = kernablate.composite_fwd_variant(*args, variant)
    assert kernablate.launches[variant] == before + 1
    kc, kt = composite.composite_fwd(*args)
    assert torch.equal(vc, kc) and torch.equal(vt, kt)


def test_fisheye_step_on_card_matches_cpu(cuda):
    """The toy fisheye step (`utils/testing.fisheye_toy`: the lens inverse,
    the warp and crop, vignetting and the pupil shift) through both kernels
    against the plain versions on the CPU from the same state and GT: loss
    and warped image within 2e-5, every gradient within atol 1e-5, rtol
    1e-3."""
    from bags_tpu_torch.train.calibrated import fisheye_train_step
    from bags_tpu_torch.utils.testing import fisheye_toy

    out, gt = {}, None
    for dev in (torch.device("cpu"), cuda):
        t = fisheye_toy(dev, gt)
        gt = t["gt"].cpu()
        out[dev.type] = fisheye_train_step(
            t["state"], t["gt"], t["p_view"], 0, torch.zeros(3, device=dev),
            t["setup"], RenderConfig(sh_degree=3), t["cfg"], t["schedules"],
            True, True)
    cpu, card = out["cpu"], out["cuda"]
    assert abs(float(card.loss) - float(cpu.loss)) <= 2e-5
    torch.testing.assert_close(card.image.cpu(), cpu.image, atol=2e-5, rtol=0)
    assert set(card.grads) == set(cpu.grads)
    for k, v in cpu.grads.items():
        torch.testing.assert_close(card.grads[k].detach().cpu(), v, atol=1e-5,
                                   rtol=1e-3, msg=k)


def test_cubemap_step_on_card_matches_cpu(cuda):
    """The toy cubemap step (`utils/testing.cubemap_toy`: five renders
    sorted by distance, the cubemap net's ray field, five warps) through
    both kernels against the plain versions on the CPU from the same state
    and GT: loss and forward face within 2e-5, every gradient within atol
    1e-5, rtol 1e-3; 5 forward and 5 backward launches."""
    from bags_tpu_torch.train.calibrated import cubemap_train_step
    from bags_tpu_torch.utils.testing import cubemap_toy

    out, gt = {}, None
    for dev in (torch.device("cpu"), cuda):
        t = cubemap_toy(dev, gt)
        gt = t["gt"].cpu()
        before = composite.fwd_launches, composite.bwd_launches
        out[dev.type] = cubemap_train_step(
            t["state"], t["gt"], 0, torch.zeros(3, device=dev), t["sub_q"][0],
            t["sub_t"][0], t["setup"], RenderConfig(sh_degree=1), t["cfg"],
            t["schedules"])
    assert (composite.fwd_launches, composite.bwd_launches) == (
        before[0] + 5, before[1] + 5)
    cpu, card = out["cpu"], out["cuda"]
    assert abs(float(card.loss) - float(cpu.loss)) <= 2e-5
    torch.testing.assert_close(card.image.cpu(), cpu.image, atol=2e-5, rtol=0)
    assert set(card.grads) == set(cpu.grads)
    for k, v in cpu.grads.items():
        torch.testing.assert_close(card.grads[k].detach().cpu(), v, atol=1e-5,
                                   rtol=1e-3, msg=k)


def _step_card_vs_cpu(make_toy, run_step, cuda, renders=1):
    """A toy step built by make_toy(device, gt) and taken by run_step(toy,
    device) on the CPU (plain versions) and on the card (both kernels,
    `renders` launches each) from the same state and GT: loss and image
    within 2e-5, every gradient within atol 1e-5, rtol 1e-3."""
    out, gt = {}, None
    for dev in (torch.device("cpu"), cuda):
        t = make_toy(dev, gt)
        gt = t["gt"].cpu()
        before = composite.fwd_launches, composite.bwd_launches
        out[dev.type] = run_step(t, dev)
    assert (composite.fwd_launches, composite.bwd_launches) == (
        before[0] + renders, before[1] + renders)
    cpu, card = out["cpu"], out["cuda"]
    assert abs(float(card.loss) - float(cpu.loss)) <= 2e-5
    torch.testing.assert_close(card.image.cpu(), cpu.image, atol=2e-5, rtol=0)
    assert set(card.grads) == set(cpu.grads)
    for k, v in cpu.grads.items():
        torch.testing.assert_close(card.grads[k].detach().cpu(), v, atol=1e-5,
                                   rtol=1e-3, msg=k)
    return cpu.grads


def test_hybrid_mcmc_pose_step_on_card_matches_cpu(cuda):
    """The toy pose step with the specular colour and the MCMC regularisers
    (`utils/testing.pose_toy`), card against CPU; the ASG features and the
    specular weights have gradients."""
    from bags_tpu_torch.train.loop import train_step
    from bags_tpu_torch.utils.testing import pose_toy

    grads = _step_card_vs_cpu(
        lambda dev, gt: pose_toy(dev, gt, hybrid=True, mcmc=True),
        lambda t, dev: train_step(t["state"], t["gt"], 1, torch.zeros(3, device=dev),
                                  t["static"], RenderConfig(sh_degree=3), t["cfg"]),
        cuda)
    assert {".g.asg", ".spec.feat_w", ".spec.w3"} <= set(grads)


def test_hybrid_fisheye_step_on_card_matches_cpu(cuda):
    """The toy fisheye step with the specular colour
    (`utils/testing.fisheye_toy(hybrid=True)`), card against CPU."""
    from bags_tpu_torch.train.calibrated import fisheye_train_step
    from bags_tpu_torch.utils.testing import fisheye_toy

    grads = _step_card_vs_cpu(
        lambda dev, gt: fisheye_toy(dev, gt, hybrid=True),
        lambda t, dev: fisheye_train_step(
            t["state"], t["gt"], t["p_view"], 0, torch.zeros(3, device=dev),
            t["setup"], RenderConfig(sh_degree=3), t["cfg"], t["schedules"],
            True, True), cuda)
    assert {".g.asg", ".spec.b3"} <= set(grads)


def test_batch_cams_pose_step_on_card(cuda):
    """A `--batch_cams 2` toy pose step (`pose_toy`'s cameras 1 and 0, its
    GT for both) on the card: two launches of each kernel; the loss and
    the stacked images within 2e-5 of the same step on the CPU; the loss
    the mean of the two single-view steps' on the card and every gradient
    the mean of theirs (atol 1e-5, rtol 1e-3). Card against CPU every
    gradient within atol 1e-5, rtol 1e-3 but for at most 0.1 % of a
    field's entries, each of those within 1e-4: on this toy's camera 1 a
    single-view step already moves one Gaussian's xyz gradient by 4.7e-5
    between the kernel and the plain version (an alpha decision at a
    threshold; ROADMAP.md Queue 3)."""
    from bags_tpu_torch.train.loop import train_step
    from bags_tpu_torch.utils.testing import pose_toy

    def step(dev, idx, gt=None):
        t = pose_toy(dev, gt)
        gts = torch.stack([t["gt"]] * len(idx)) if isinstance(idx, list) else t["gt"]
        return train_step(t["state"], gts, idx, torch.zeros(3, device=dev),
                          t["static"], RenderConfig(sh_degree=3), t["cfg"]), t["gt"]

    cpu, gt = step(torch.device("cpu"), [1, 0])
    before = composite.fwd_launches, composite.bwd_launches
    card, _ = step(cuda, [1, 0], gt)
    assert (composite.fwd_launches, composite.bwd_launches) == (
        before[0] + 2, before[1] + 2)
    assert abs(float(card.loss) - float(cpu.loss)) <= 2e-5
    torch.testing.assert_close(card.image.cpu(), cpu.image, atol=2e-5, rtol=0)
    for k, v in cpu.grads.items():
        d = (card.grads[k].detach().cpu() - v).abs()
        off = d > 1e-5 + 1e-3 * v.abs()
        assert off.sum() <= 1e-3 * off.numel() and (d * off).max() <= 1e-4, (
            k, int(off.sum()), float((d * off).max()))
    single = [step(cuda, i, gt)[0] for i in (1, 0)]
    assert abs(float(card.loss) - sum(float(m.loss) for m in single) / 2) <= 1e-6
    assert card.grads[".cam.dq"].shape == (2, 4)
    for k, v in card.grads.items():
        parts = [m.grads[k] for m in single]
        want = torch.stack(parts) / 2 if k.startswith(".cam.") else sum(parts) / 2
        torch.testing.assert_close(v, want, atol=1e-5, rtol=1e-3, msg=k)


def test_mesh1_nccl_matches_plain_trainer(cuda):
    """`tools/mesh1_parity.py` on the card: the sharded trainer in an NCCL
    world of one against the plain trainer, 4 steps each (losses within
    5e-4); both kernels launched once a step by each."""
    import torch.distributed as dist

    from bags_tpu_torch.tools import mesh1_parity

    before = composite.fwd_launches, composite.bwd_launches
    out = mesh1_parity.main(["--device", "cuda", "--steps", "4"])
    assert (composite.fwd_launches, composite.bwd_launches) == (
        before[0] + 8, before[1] + 8)
    assert out["max_loss_diff"] <= mesh1_parity.TOL
    assert not dist.is_initialized()


def test_mesh1_fisheye_step_on_card_matches_plain(cuda):
    """The toy fisheye step (`utils/testing.fisheye_toy`) tile-parallel in
    an NCCL world of one (`dist/calib.sharded_fisheye_step`: the slab
    render, the image all-gather, the warp and crop rows, the halo loss,
    the all-reduces) against `fisheye_train_step` on the card from the same
    state and GT: one launch of each kernel, the loss within 1e-5
    relative, every gradient within atol 1e-5, rtol 1e-3."""
    import torch.distributed as dist

    from bags_tpu_torch.dist.calib import fisheye_gt_rows, sharded_fisheye_step
    from bags_tpu_torch.dist.trainer import init_distributed
    from bags_tpu_torch.train.calibrated import fisheye_train_step
    from bags_tpu_torch.utils.testing import fisheye_toy

    bg, rcfg = torch.zeros(3, device=cuda), RenderConfig(sh_degree=3)
    t = fisheye_toy(cuda)
    plain = fisheye_train_step(t["state"], t["gt"], t["p_view"], 0, bg, t["setup"],
                               rcfg, t["cfg"], t["schedules"], True, True)
    _, started = init_distributed(cuda, 1)
    try:
        t = fisheye_toy(cuda, t["gt"])
        before = composite.fwd_launches, composite.bwd_launches
        mesh = sharded_fisheye_step(t["state"], fisheye_gt_rows(t["gt"], False),
                                    t["p_view"], 0, bg, t["setup"], rcfg, t["cfg"],
                                    t["schedules"], True, True)
        after = composite.fwd_launches, composite.bwd_launches
    finally:
        if started:
            dist.destroy_process_group()
    assert after == (before[0] + 1, before[1] + 1)
    assert abs(float(mesh.loss) - float(plain.loss)) <= 1e-5 * float(plain.loss)
    assert set(mesh.grads) == set(plain.grads)
    for k, v in plain.grads.items():
        torch.testing.assert_close(mesh.grads[k].detach(), v.detach(), atol=1e-5,
                                   rtol=1e-3, msg=k)


def test_relocation_on_card_matches_cpu(cuda):
    """`relocate_dead`, `add_new_gaussians` and `position_noise` on
    `utils/testing.mcmc_toy` with the same injected draws on the card and
    on the CPU: the counts, alive and both reset masks identical; every
    entry of every relocated field within 1e-6 of itself (rtol 1e-6, atol
    0); `position_noise` on the CPU's relocated population on both, each
    noised position within 1e-6 of the scale of its rounding
    (`noise_terms`): the noise is a sum of products that can cancel, and
    its opacity gate's argument 100 ((1 - o) - 0.995) cancels too, so that
    the last bit of the card's sigmoid moves it by more than 1e-6 of
    itself."""
    from bags_tpu_torch.utils.testing import mcmc_toy, run_mcmc_toy

    cpu = run_mcmc_toy(mcmc_toy(torch.device("cpu")))
    card = run_mcmc_toy(mcmc_toy(cuda), noise_input=cpu)
    assert card["counts"] == cpu["counts"] == (40, 8)
    for k in ("alive", "reset1", "reset2"):
        assert torch.equal(card[k], cpu[k]), k
    for k in ("xyz", "sh_dc", "sh_rest", "scales_log", "quats", "opacity_raw",
              "asg"):
        torch.testing.assert_close(card[k], cpu[k], rtol=1e-6, atol=0)
    diff = (card["noised_xyz"] - cpu["noised_xyz"]).abs().double()
    assert bool((diff <= 1e-6 * cpu["noise_terms"]).all()), float(
        (diff / cpu["noise_terms"]).max())


def test_lpips_on_card_matches_cpu(cuda, tmp_path):
    """`eval/metrics.Lpips` (a seeded VGG16-layout bundle at tiny widths) on
    the card against the CPU on the same seeded images: rtol 1e-4."""
    from bags_tpu_torch.eval.lpips_weights import VGG16_CONV_IDX, convert_state_dicts
    from bags_tpu_torch.eval.metrics import Lpips

    rng = np.random.default_rng(3)
    backbone, c_in = {}, 3
    for idx in VGG16_CONV_IDX:
        backbone[f"features.{idx}.weight"] = rng.normal(
            0, np.sqrt(2 / (9 * c_in)), (8, c_in, 3, 3)).astype(np.float32)
        backbone[f"features.{idx}.bias"] = np.zeros(8, np.float32)
        c_in = 8
    lin = {f"lin{k}.model.1.weight": np.abs(rng.normal(0, 0.1, (1, 8, 1, 1)))
           for k in range(5)}
    path = str(tmp_path / "vgg.npz")
    np.savez(path, **convert_state_dicts(backbone, lin))
    a = torch.as_tensor(rng.uniform(0, 1, (3, 96, 128)).astype(np.float32))
    b = torch.clamp(a + 0.1 * torch.as_tensor(rng.normal(size=(3, 96, 128))
                                              .astype(np.float32)), 0, 1)
    with torch.no_grad():
        cpu = float(Lpips(path)(a, b))
        card = float(Lpips(path).to(cuda)(a.to(cuda), b.to(cuda)))
    assert cpu > 0 and card == pytest.approx(cpu, rel=1e-4)


def test_trajectory_frame_on_card_matches_cpu(cuda, tmp_path):
    """One `cli.render_trajectory --ply_only` frame through the forward
    kernel against the same frame on the CPU (the plain version): 8-bit
    values within one level, one forward launch."""
    from PIL import Image

    from bags_tpu_torch.cli import render_trajectory as traj_cli
    from bags_tpu_torch.model.gaussians import create_from_points, save_ply
    from bags_tpu_torch.utils.testing import make_lookat_cameras, write_colmap_scene

    rng = np.random.default_rng(4)
    data, model = str(tmp_path / "data"), str(tmp_path / "model")
    cams = make_lookat_cameras(3, 0.9, 0.7, device="cpu")
    pts = rng.normal(size=(400, 3)) * 0.8 + [0.0, 0.0, 6.0]
    write_colmap_scene(data, cams, 64, 48, 64 / (2 * np.tan(0.45)),
                       48 / (2 * np.tan(0.35)), pts, rng.random((400, 3)),
                       images=[np.zeros((48, 64, 3), np.uint8)] * 3)
    g, alive = create_from_points(pts.astype(np.float32),
                                  rng.random((400, 3)).astype(np.float32), 400, 1,
                                  device="cpu")
    ply = os.path.join(model, "point_cloud", "iteration_1")
    os.makedirs(ply)
    save_ply(os.path.join(ply, "point_cloud.ply"), g, alive)
    frames = {}
    for dev in ("cpu", "cuda"):
        composite.fwd_launches = 0
        out = traj_cli.main(["-m", model, "-s", data, "--ply_only", "--sh_degree", "1",
                             "--mode", "sequential", "--n_frames", "1", "--device", dev,
                             "--out", str(tmp_path / dev)])
        assert composite.fwd_launches == (out["frames"] if dev == "cuda" else 0)
        frames[dev] = np.asarray(Image.open(os.path.join(out["dir"], "00000.png")),
                                 np.int16)
    assert np.abs(frames["cuda"] - frames["cpu"]).max() <= 1
    assert frames["cpu"].mean() > 5, "nothing in view"


def test_graphed_prefit_matches_eager(cuda):
    """The lens pre-fit as one CUDA graph a step against the eager loop,
    200 Adam steps of the full 5x512 net each from one state on a 1600x1080
    sensor's control points: the losses within 1e-5 relative, every
    parameter within 1e-4 of the largest entry (capturable Adam rounds
    otherwise than the eager one)."""
    from bags_tpu_torch.calib import distortion
    from bags_tpu_torch.calib.iresnet import init_iresnet_params

    K = np.array([[1000.0, 0, 800], [0, 1000.0, 540], [0, 0, 1]])
    inputs, targets = distortion.colmap_fit_points(K, 1600, 1080,
                                                   [-0.04, 0.0, 0.0, 0.0], cuda)
    nets = [init_iresnet_params(device=cuda) for _ in range(2)]
    distortion.fit_eager(nets[0], inputs, targets, 200, 1e-4)
    distortion.fit_iresnet_to_targets(nets[1], inputs, targets, 200, 1e-4)
    with torch.no_grad():
        loss = [float(distortion.prefit_loss(n, inputs, targets)) for n in nets]
        diff = max(float((a - b).abs().max())
                   for a, b in zip(nets[0].parameters(), nets[1].parameters()))
        largest = max(float(a.abs().max()) for a in nets[0].parameters())
    assert abs(loss[1] - loss[0]) <= 1e-5 * abs(loss[0])
    assert diff <= 1e-4 * largest


# The projection kernels (csrc/projection.cu) against the plain path on the
# card: (SH degree, coefficients a row, pupil shift, global alignment).
PROJ_CASES = {"sh0": (0, 1, False, False), "sh1_shift": (1, 16, True, False),
              "sh2_align": (2, 9, False, True), "sh3_K16_shift_align": (3, 16, True, True),
              "sh3_K25": (3, 25, False, False), "sh4_shift_align": (4, 25, True, True)}
# Float outputs: the kernel rounds each operation as the plain path's
# separate kernels do (an H100 reads them bit for bit equal; the tolerance
# leaves an ulp for logf). Gradients: the backward kernel's hand-derived
# sums round in another order than autograd's chain, and the camera's are
# sums over every slot (the near-plane slots' terms reach 1e16): normwise
# relative differences read at most 4.5e-7 against float64 on an H100.
PROJ_FWD_RTOL = 1e-6
PROJ_GRAD_REL = 1e-4


def _proj_case(name, device):
    """A projection_scene of 2,000 slots (the special ones included, half
    the rest dead) with leaves for every input and camera parameter the
    case has."""
    from bags_tpu_torch.core.camera import GlobalAlignment
    from bags_tpu_torch.utils.testing import projection_scene

    deg, k, shift, align = PROJ_CASES[name]
    sc = projection_scene(2000, k, seed=sorted(PROJ_CASES).index(name),
                          live_every=2, device=device)
    leaves = {a: sc[a].clone() for a in ARGS}
    leaves.update(dq=torch.tensor([0.01, 0.02, -0.01, 0.03], device=device),
                  dt=torch.tensor([0.05, -0.1, 0.2], device=device),
                  fovx=sc["cam"].fovx.clone(), fovy=sc["cam"].fovy.clone())
    if shift:
        leaves["shift"] = torch.tensor([0.03, -0.02, 0.05], device=device)
    if align:
        leaves["align_q"] = torch.tensor([0.998, 0.03, -0.04, 0.02], device=device)
        leaves["align_s"] = torch.tensor(0.05, device=device)
    for v in leaves.values():
        v.requires_grad_(True)
    cam = dataclasses.replace(sc["cam"], dq=leaves["dq"], dt=leaves["dt"],
                              fovx=leaves["fovx"], fovy=leaves["fovy"])
    kw = dict(shift_factors=leaves.get("shift"), align=(
        GlobalAlignment(leaves["align_q"], leaves["align_s"]) if align else None))
    return deg, leaves, cam, sc["static"], kw


def _proj_run(name, device, plain):
    """Outputs and every leaf's gradient of sum(g * out) over the 10 float
    outputs, seeded cotangents, through the kernels or the plain path."""
    from bags_tpu_torch.core import projection as P

    deg, leaves, cam, static, kw = _proj_case(name, device)
    args = [leaves[a] for a in ARGS]
    if plain:
        cv = P.camera_vector(cam, static, kw["align"], kw["shift_factors"])
        proj = P.project_plain(*args, cv, static, deg, kw["shift_factors"] is not None)
    else:
        proj = P.project_gaussians(*args, cam, static, deg, **kw)
    gen = torch.Generator(device=device).manual_seed(3)
    loss = sum((getattr(proj, f) * torch.randn(args[0].shape[0], generator=gen,
                                               device=device)).sum()
               for f in P.FLOAT_FIELDS)
    return proj, dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


@pytest.mark.parametrize("name", sorted(PROJ_CASES))
def test_projection_kernels_match_plain(cuda, name):
    """The forward kernel's outputs against `project_plain` on the card
    (radius, rect_rx, rect_ry equal; floats within PROJ_FWD_RTOL of
    max(1, |plain|)) and every gradient, the camera's dq, dt, fovx, fovy,
    alignment and shift among them, within PROJ_GRAD_REL normwise of the
    plain path's autograd; one forward and one backward launch."""
    from bags_tpu_torch.core import projection as P

    fwd, bwd = P.project_fwd_launches, P.project_bwd_launches
    kern, kgrads = _proj_run(name, cuda, plain=False)
    assert (P.project_fwd_launches, P.project_bwd_launches) == (fwd + 1, bwd + 1)
    plain, pgrads = _proj_run(name, cuda, plain=True)
    assert int((plain.radius > 0).sum()) > 500
    for f in P.INT_FIELDS:
        assert torch.equal(getattr(kern, f), getattr(plain, f)), f
    for f in P.FLOAT_FIELDS:
        a, b = getattr(kern, f).detach(), getattr(plain, f).detach()
        off = float(((a - b).abs() / b.abs().clamp_min(1.0)).max())
        assert off <= PROJ_FWD_RTOL, (f, off)
    for k, b in pgrads.items():
        a = kgrads[k]
        rel = float(torch.linalg.norm((a - b).double()) /
                    torch.linalg.norm(b.double()).clamp_min(1e-30))
        assert rel <= PROJ_GRAD_REL, (k, rel)
    # coefficients above the active degree get zero
    deg = PROJ_CASES[name][0]
    assert bool((kgrads["sh_coeffs"][:, (deg + 1) ** 2:] == 0).all())


def test_projection_camera_grads_repeat(cuda):
    """Two backward passes give the camera gradients bit for bit: the
    kernel sums the camera terms in a fixed order, without atomics."""
    first = _proj_run("sh3_K16_shift_align", cuda, plain=False)[1]
    second = _proj_run("sh3_K16_shift_align", cuda, plain=False)[1]
    for k in first:
        assert torch.equal(first[k], second[k]), k


def test_projection_launches_a_view_and_a_step(cuda):
    """render() launches the forward kernel once a view; the step's backward
    launches the backward kernel once."""
    from bags_tpu_torch.core import projection as P

    sc = _scene("toy_sh3", cuda)
    leaves = [sc[k].clone().requires_grad_(True) for k in ARGS]
    fwd, bwd = P.project_fwd_launches, P.project_bwd_launches
    with torch.no_grad():
        render(*leaves, sc["cam"], sc["static"], RenderConfig(sh_degree=3))
    assert (P.project_fwd_launches, P.project_bwd_launches) == (fwd + 1, bwd)
    out = render(*leaves, sc["cam"], sc["static"], RenderConfig(sh_degree=3))
    out.render.mean().backward()
    assert (P.project_fwd_launches, P.project_bwd_launches) == (fwd + 2, bwd + 1)


def test_projection_wrapper_raises(cuda):
    """On CUDA tensors the wrapper takes only what the kernels take: mixed
    devices and non-contiguous inputs raise before a launch."""
    sc = _scene("toy_sh3", cuda)
    args = {k: sc[k] for k in ARGS}
    for change, match in ((dict(sh_coeffs=sc["sh_coeffs"].cpu()), "sh_coeffs on cpu"),
                          (dict(scales=sc["scales"].t().contiguous().t()),
                           "contiguous")):
        a = {**args, **change}
        with pytest.raises(ValueError, match=match):
            project_gaussians(*[a[k] for k in ARGS], sc["cam"], sc["static"], 3)
