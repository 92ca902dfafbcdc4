"""Synthetic scenes and datasets for tests and the on-card smoke run (port
of `bags_tpu/utils/testing.py`).

The builders draw from numpy with the same seeds and in the same order as
the JAX package's, so both packages get identical inputs.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..core.camera import CameraParams, CameraStatic
from ..data import colmap
from .device import resolve_device


def make_lookat_cameras(n_cams: int, fovx: float, fovy: float,
                        center=(0.0, 0.0, 6.0), radius: float = 6.0,
                        spread: float = 0.5, elev: float = 0.12, device=None):
    """Cameras on an arc with distinct centers, all looking at `center`.
    Returns a list of CameraParams (w2c: X_cam = R X + t, t = -R C)."""
    dev = resolve_device(device)
    center = np.asarray(center, np.float64)
    cams = []
    for i in range(n_cams):
        a = spread * (i - (n_cams - 1) / 2) / max(n_cams - 1, 1) * 2
        b = elev * np.sin(1.7 * i)
        C = center + radius * np.array([np.sin(a), np.sin(b),
                                        -np.cos(a) * np.cos(b)])
        f = center - C
        f = f / np.linalg.norm(f)
        r = np.cross([0.0, 1.0, 0.0], f)
        r = r / np.linalg.norm(r)
        u = np.cross(f, r)
        R = np.stack([r, u, f]).astype(np.float32)
        t = (-R @ C.astype(np.float32)).astype(np.float32)
        cams.append(CameraParams.create(R, t, fovx, fovy, device=dev))
    return cams


def make_toy_scene(n: int = 500, seed: int = 0, width: int = 64,
                   height: int = 64, sh_degree: int = 0, depth_range=(4.0, 8.0),
                   scale_range=(0.02, 0.12), device=None):
    """Random Gaussians in a box in front of a camera at the origin looking
    +z. Same numbers as `bags_tpu.utils.testing.make_toy_scene`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    fovx = fovy = 0.8
    extent_x = np.tan(fovx / 2) * depth_range[0]
    xyz = np.stack([
        rng.uniform(-extent_x, extent_x, n),
        rng.uniform(-extent_x, extent_x, n),
        rng.uniform(*depth_range, n),
    ], axis=-1).astype(np.float32)
    k = (sh_degree + 1) ** 2
    sh = np.zeros((n, k, 3), np.float32)
    sh[:, 0, :] = rng.normal(0, 1.0, size=(n, 3))
    if k > 1:
        sh[:, 1:, :] = rng.normal(0, 0.1, size=(n, k - 1, 3))
    scales = np.exp(rng.uniform(np.log(scale_range[0]), np.log(scale_range[1]),
                                size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opacity = rng.uniform(0.2, 0.95, size=(n,)).astype(np.float32)

    def t(x):
        return torch.as_tensor(x, device=dev)

    cam = CameraParams.create(np.eye(3, dtype=np.float32),
                              np.zeros(3, np.float32), fovx, fovy, device=dev)
    return dict(xyz=t(xyz), scales=t(scales), quats=t(quats),
                opacity=t(opacity), sh_coeffs=t(sh), cam=cam,
                static=CameraStatic(width=width, height=height),
                sh_degree=sh_degree)


def projection_scene(n: int, k: int, seed: int, width: int = 64,
                     height: int = 48, scale_range=(0.02, 0.12),
                     live_every: int = 1, device=None) -> dict:
    """Inputs of `project_gaussians` for n slots with k SH coefficients a
    row, drawn on `device` from `seed` (make_toy_scene's box and camera:
    the origin, looking +z, fovx 0.8, the aspect of width x height): one
    slot in `live_every` alive, the others dead (opacity 0, as the capacity
    past the live Gaussians), and for n >= 64 special slots first: 0-3
    behind the camera, 4-7 inside the depth clamp (z = 1e-8), 8-11 far
    outside the frustum, 12 at the camera centre, 13-15 alive and on screen
    whatever live_every says."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    fovx = 0.8
    fovy = 2.0 * float(np.arctan(np.tan(fovx / 2) * height / width))
    ext = float(np.tan(fovx / 2)) * 4.0
    xyz = torch.stack([uniform(-ext, ext, n), uniform(-ext, ext, n),
                       uniform(4.0, 8.0, n)], dim=-1)
    scales = torch.exp(uniform(np.log(scale_range[0]), np.log(scale_range[1]),
                               n, 3))
    quats = torch.randn((n, 4), generator=gen, device=dev)
    opacity = uniform(0.2, 0.95, n)
    opacity[torch.arange(n, device=dev) % live_every != 0] = 0.0
    sh = 0.1 * torch.randn((n, k, 3), generator=gen, device=dev)
    sh[:, 0] = torch.randn((n, 3), generator=gen, device=dev)
    if n >= 64:
        xyz[0:4, 2] = -2.0
        xyz[4:8, 2] = 1e-8
        xyz[8:12, 0] = 50.0
        xyz[12] = 0.0
        opacity[13:16] = 0.5
    cam = CameraParams.create(np.eye(3, dtype=np.float32),
                              np.zeros(3, np.float32), fovx, fovy, device=dev)
    return dict(xyz=xyz, scales=scales, quats=quats, opacity=opacity,
                sh_coeffs=sh, cam=cam,
                static=CameraStatic(width=width, height=height))


def write_colmap_scene(root: str, cams, width: int, height: int,
                       fx: float, fy: float, points: np.ndarray,
                       colors: np.ndarray, images=None) -> list[str]:
    """Write a COLMAP dataset (binary `sparse/0` + `images/`) for PINHOLE
    cameras `cams` (CameraParams list; w2c quaternion and translation).

    images: one (H, W, 3) uint8 array per camera, or None to write them
    later with `write_image` at the returned paths. The counterpart of
    `tests/test_data.py::_write_colmap_scene`, with given poses.
    """
    sparse = os.path.join(root, "sparse", "0")
    imgdir = os.path.join(root, "images")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(imgdir, exist_ok=True)
    colmap.write_cameras_binary(
        os.path.join(sparse, "cameras.bin"),
        {1: colmap.ColmapCamera(1, "PINHOLE", width, height,
                                np.array([fx, fy, width / 2, height / 2]))})
    records, paths = {}, []
    for i, cam in enumerate(cams, start=1):
        name = f"img_{i:03d}.png"
        records[i] = colmap.ColmapImage(
            i, cam.q_init.detach().cpu().double().numpy(),
            cam.t_init.detach().cpu().double().numpy(), 1, name,
            np.zeros((0, 2)), np.zeros(0, int))
        paths.append(os.path.join(imgdir, name))
    colmap.write_images_binary(os.path.join(sparse, "images.bin"), records)
    colmap.write_points3d_binary(
        os.path.join(sparse, "points3D.bin"), np.asarray(points, np.float64),
        (np.clip(np.asarray(colors), 0, 1) * 255).astype(np.uint8))
    if images is not None:
        for path, img in zip(paths, images):
            write_image(path, img)
    return paths


def known_lens_fisheye(image: torch.Tensor, setup, p_view: torch.Tensor,
                       coeff) -> torch.Tensor:
    """A render at the fisheye setup's extended FoV (3, H, W) warped the way
    the fisheye mode warps, through the closed-form inverse of the
    OPENCV_FISHEYE polynomial `coeff` in place of the lens net: the GT of a
    known-lens dataset (as `tools/lens_recovery.py` makes it)."""
    from ..calib.distortion import analytic_inverse_flow, apply_distortion

    proj = [1.0 / np.tan(setup.fovx / 2), 1.0 / np.tan(setup.fovy / 2)]
    flow = analytic_inverse_flow(coeff, p_view, setup.grid_hw, proj,
                                 setup.flow_hw)
    return apply_distortion(None, p_view, setup.grid_hw, image, None,
                            setup.flow_hw, final_hw=setup.fish_hw,
                            flow=flow)[0]


KNOWN_LENS = (-0.12, 0.02, 0.0, 0.0)   # tools/lens_recovery.py's true lens


def fisheye_toy(device, gt: torch.Tensor = None, hybrid: bool = False) -> dict:
    """A toy fisheye training setup (apply2render; lens, vignetting and the
    pupil shift trained): the 700 SH-3 Gaussians of the 64x48 toy scene,
    nudged off their true positions, two cameras at `--preset fisheye`'s
    extended FoV, a 2-block lens net of width 32 (weights x 0.2), and the
    fisheye GT of camera 1 through the known lens KNOWN_LENS unless `gt` is
    given; `hybrid` adds the specular colour (`toy_asg` features).
    Returns dict(state, schedules, cfg, setup, p_view, gt)."""
    from ..raster.render import RenderConfig, render
    from ..train import calibrated
    from ..train.config import TrainConfig

    dev = resolve_device(device)
    w, h, fov = 64, 48, 0.8
    fx, fy = w / (2 * np.tan(fov / 2)), h / (2 * np.tan(fov / 2))
    cfg = TrainConfig()
    cfg.model.sh_degree = 3
    c = cfg.calib
    c.opt_cam = c.opt_intrinsic = c.opt_distortion = c.outside_rasterizer = True
    c.opt_shift, c.start_vignetting, c.iresnet_lr = True, 0, 1e-4
    c.flow_scale, c.control_point_sample_scale = (2.0, 2.0), 8
    c.hybrid = hybrid
    sc = make_toy_scene(n=700, width=w, height=h, sh_degree=3, seed=0,
                        device=dev)
    setup = calibrated.make_fisheye_setup(fx, fy, (w, h), (w, h),
                                          flow_scale=c.flow_scale,
                                          control_point_sample_scale=8)
    p_view = calibrated.fisheye_control_points(setup, fx, fy, c.flow_scale,
                                               device=dev)
    ext = dict(fovx=torch.full_like(sc["cam"].fovx, setup.fovx),
               fovy=torch.full_like(sc["cam"].fovy, setup.fovy))
    cams = CameraParams.stack([
        dataclasses.replace(sc["cam"], **ext),
        dataclasses.replace(sc["cam"], t_init=torch.tensor([0.1, 0.0, 0.0],
                                                           device=dev), **ext)])
    if gt is None:
        with torch.no_grad():
            img = render(sc["xyz"], sc["scales"], sc["quats"], sc["opacity"],
                         sc["sh_coeffs"], cams[1], setup.render_static,
                         RenderConfig(sh_degree=3)).render
            gt = known_lens_fisheye(img, setup, p_view, KNOWN_LENS)
    state, schedules = _toy_calib_state(sc, cams, cfg, dev,
                                        {"lens": _narrow_net_np()})
    return dict(state=state, schedules=schedules, cfg=cfg, setup=setup,
                p_view=p_view, gt=gt.to(dev))


def _narrow_net_np() -> dict:
    """The toys' lens net: 2 blocks of width 32 (seed 3), weights x 0.2, as
    numpy lists in the JAX layout."""
    from ..calib.iresnet import init_iresnet_params

    net = init_iresnet_params(hidden=32, n_blocks=2, n_layers=2, seed=3)
    return {f: [[(t.detach() * (0.2 if f == "weights" else 1.0)).numpy()
                 for t in blk] for blk in getattr(net, f)]
            for f in ("weights", "biases", "u_vecs")}


def toy_asg(n: int, device=None) -> torch.Tensor:
    """Seeded ASG features (n, 24) for the hybrid toys, normal with std
    0.3 (the trainer starts them at zero, where the first step gives the
    specular MLP's feature weights no gradient)."""
    rng = np.random.default_rng(5)
    return torch.as_tensor(rng.normal(0, 0.3, (n, 24)).astype(np.float32),
                           device=resolve_device(device))


def _toy_train_state(sc, cams, cfg, dev):
    """The toy scene's 700 Gaussians nudged off their true positions (with
    `toy_asg` features when cfg.calib.hybrid) and their TrainState over
    `cams` (spatial lr scale 2)."""
    from ..model.gaussians import Gaussians
    from ..train.loop import init_train_state

    op = sc["opacity"]
    nudge = 0.02 * torch.sin(torch.arange(3 * 700, device=dev,
                                          dtype=torch.float32)).reshape(-1, 3)
    g = Gaussians(xyz=sc["xyz"] + nudge,
                  sh_dc=sc["sh_coeffs"][:, :1].contiguous(),
                  sh_rest=sc["sh_coeffs"][:, 1:].contiguous(),
                  scales_log=torch.log(sc["scales"]), quats=sc["quats"],
                  opacity_raw=torch.log(op / (1 - op)),
                  asg=toy_asg(700, dev) if cfg.calib.hybrid else None)
    return init_train_state(g, torch.ones(700, dtype=torch.bool, device=dev),
                            cams, cfg, 2.0)


def _toy_calib_state(sc, cams, cfg, dev, nets: dict):
    """`_toy_train_state` and the CalibState around it with the nets of
    `nets` ("lens" and, if given, "cubemap_net"), vignetting at its init
    and a zero shift. Returns (state, schedules)."""
    from .. import convert

    base = _toy_train_state(sc, cams, cfg, dev)
    return convert.calib_state_from_numpy(base, cfg, {
        **nets, "vig": {"a_k": np.full(4, 0.01, np.float32),
                        "beta_k": np.linspace(2, 8, 4).astype(np.float32)},
        "shift": np.zeros(3, np.float32)}, device=dev)


def pose_toy(device, gt: torch.Tensor = None, hybrid: bool = False,
             mcmc: bool = False) -> dict:
    """A toy pose-optimising training setup (`train_step`; pose and FoVs
    trained): the 700 SH-3 Gaussians of the 64x48 toy scene nudged off
    their true positions, two cameras (the second moved 0.1 in x), the GT
    the true scene from camera 1 unless `gt` is given; `hybrid` adds the
    specular colour (`toy_asg` features), `mcmc` the MCMC regularisers.
    Returns dict(state, cfg, static, gt)."""
    from ..raster.render import RenderConfig, render
    from ..train.config import TrainConfig

    dev = resolve_device(device)
    cfg = TrainConfig()
    cfg.model.sh_degree = 3
    cfg.calib.opt_cam = cfg.calib.opt_intrinsic = True
    cfg.calib.hybrid, cfg.mcmc = hybrid, mcmc
    sc = make_toy_scene(n=700, width=64, height=48, sh_degree=3, seed=0,
                        device=dev)
    cams = CameraParams.stack([sc["cam"], dataclasses.replace(
        sc["cam"], t_init=torch.tensor([0.1, 0.0, 0.0], device=dev))])
    if gt is None:
        with torch.no_grad():
            gt = render(sc["xyz"], sc["scales"], sc["quats"], sc["opacity"],
                        sc["sh_coeffs"], cams[1], sc["static"],
                        RenderConfig(sh_degree=3)).render
    return dict(state=_toy_train_state(sc, cams, cfg, dev), cfg=cfg,
                static=sc["static"], gt=gt.to(dev))


def mcmc_toy(device) -> dict:
    """A population for the MCMC pieces, from numpy seed 6: capacity 2048,
    1,600 alive SH-1 Gaussians with ASG features, 40 of them under the
    0.005 opacity floor and most of the first 100 just over it, and the
    draws to inject: 40 relocation sources
    among the first 8 live slots (so with repeats), the 8 growth sources
    float32's target asks (1,608 - 1,600) and standard normal noise
    (2048, 3). Returns dict(g, alive, reloc, grow, eps)."""
    from .. import convert

    dev = resolve_device(device)
    cap, n_alive, n_dead = 2048, 1600, 40
    rng = np.random.default_rng(6)
    o = rng.uniform(0.01, 0.99, cap)
    d = dict(xyz=rng.normal(0, 1, (cap, 3)), sh_dc=rng.normal(0, 1, (cap, 1, 3)),
             sh_rest=rng.normal(0, 0.1, (cap, 3, 3)),
             scales_log=rng.uniform(-5, -1, (cap, 3)),
             quats=rng.normal(0, 1, (cap, 4)), opacity_raw=np.log(o / (1 - o)),
             asg=rng.normal(0, 0.3, (cap, 24)))
    d = {k: v.astype(np.float32) for k, v in d.items()}
    dead = rng.choice(n_alive, n_dead, replace=False)
    d["opacity_raw"][dead] = -8.0
    # opacity 0.0067, live and just over the floor: position noise gated on
    d["opacity_raw"][:100] = np.where(np.isin(np.arange(100), dead), -8.0, -5.0)
    d["alive"] = np.arange(cap) < n_alive
    g, alive = convert.gaussians_from_numpy(d, device=dev)
    live = np.setdiff1d(np.arange(n_alive), dead)
    n_new = int(np.float32(1.005) * np.float32(n_alive)) - n_alive
    return dict(g=g, alive=alive, reloc=rng.choice(live[:8], n_dead),
                grow=rng.choice(n_alive, n_new),
                eps=torch.as_tensor(rng.normal(size=(cap, 3)).astype(np.float32),
                                    device=dev))


def run_mcmc_toy(t: dict, noise_input: dict = None) -> dict:
    """`relocate_dead` then `add_new_gaussians` on `mcmc_toy`'s population
    in place, their sources injected (in place of `_sample_by_opacity`'s
    draws), then `position_noise` at xyz lr 3e-4 with its normal draws on
    the population they left or, given `noise_input` (another run's
    result), on that one's fields and alive, so that two devices noise
    the same population: the sharp opacity gate would otherwise magnify
    the relocated opacities' last-bit differences. Returns, on the CPU,
    every field, alive, both reset masks, the counts, the new xyz and
    `noise_terms`, per entry of the new xyz the scale of its rounding, in
    float64: the magnitudes of the terms it adds up, |xyz| + sum_jk |R_ik|
    s_k^2 |R_jk| |eps'_j| (eps' the gated and scaled draws), the noise's
    part times 1 + (1 - gate) (100 |1 - o| + 99.5), for the gate's
    argument 100 ((1 - o) - 0.995) cancels to a few hundredths and the
    gate's relative change is (1 - gate) times the argument's change."""
    from ..core.lie import quat_to_rotmat
    from ..model import mcmc

    g, dev = t["g"], t["alive"].device
    queue = [torch.as_tensor(t["reloc"], device=dev),
             torch.as_tensor(t["grow"], device=dev)]
    sample = mcmc._sample_by_opacity
    mcmc._sample_by_opacity = lambda gen, g_, live, num: queue.pop(0)
    try:
        r1 = mcmc.relocate_dead(g, t["alive"], None)
        r2 = mcmc.add_new_gaussians(g, r1.alive, None)
    finally:
        mcmc._sample_by_opacity = sample
    out = {k: v.detach().cpu() for k, v in g.fields().items()}
    out.update(alive=r2.alive.cpu(), reset1=r1.reset_mask.cpu(),
               reset2=r2.reset_mask.cpu(), counts=(r1.n_relocated, r2.n_relocated))
    src = noise_input or out
    pop = dataclasses.replace(g, **{k: src[k].to(dev) for k in g.fields()})
    with torch.no_grad():
        xyz = mcmc.position_noise(pop, src["alive"].to(dev), t["eps"], 3e-4)
    d = {k: src[k].double() for k in ("xyz", "scales_log", "quats", "opacity_raw")}
    one_minus = 1.0 - torch.sigmoid(d["opacity_raw"])
    gate = torch.sigmoid(100.0 * (one_minus - 0.995))
    eps = t["eps"].cpu().double().abs() * (gate * 5e5 * 3e-4)[:, None]
    rot = quat_to_rotmat(d["quats"]).abs()
    terms = torch.einsum("nik,nk,njk,nj->ni", rot, torch.exp(2 * d["scales_log"]),
                         rot, eps)
    cond = 1.0 + (1.0 - gate) * (100.0 * one_minus.abs() + 99.5)
    out.update(noised_xyz=xyz.cpu(), noise_terms=d["xyz"].abs()
               + terms * (cond * src["alive"])[:, None])
    return out


def write_fisheye_pair(root: str, image_paths, fish_images, width: int,
                       height: int, fx: float, fy: float, coeff) -> None:
    """The fisheye half of a COLMAP dataset at `root`: `fish/images/<name>`
    beside each perspective image path ((H, W, 3) uint8 each), and
    `fish/sparse/0/cameras.bin` with one OPENCV_FISHEYE camera whose
    distortion coefficients are `coeff` (k1..k4), which the fisheye mode's
    lens pre-fit reads."""
    fish = os.path.join(root, "fish")
    os.makedirs(os.path.join(fish, "images"), exist_ok=True)
    os.makedirs(os.path.join(fish, "sparse", "0"), exist_ok=True)
    for path, img in zip(image_paths, fish_images):
        write_image(os.path.join(fish, "images", os.path.basename(path)), img)
    colmap.write_cameras_binary(
        os.path.join(fish, "sparse", "0", "cameras.bin"),
        {1: colmap.ColmapCamera(1, "OPENCV_FISHEYE", width, height, np.array(
            [fx, fy, width / 2, height / 2, *[float(c) for c in coeff]]))})


# The cubemap cameras' rig, inside the Gaussian box of `make_toy_scene`:
# centres CUBE_RIG_OFFSET around CUBE_RIG_CENTER (a small circle in x / y),
# each looking along +z turned by up to CUBE_RIG_YAW radians about y.
CUBE_RIG_CENTER = (0.0, 0.0, 6.0)
CUBE_RIG_OFFSET = 0.2
CUBE_RIG_YAW = 0.3


def cubemap_rig(n_cams: int) -> list:
    """The world-to-camera (R (3, 3), t (3,)) of each cubemap camera, float32
    numpy, so that all five faces see the content of `make_toy_scene`."""
    out = []
    for i in range(n_cams):
        a = 2 * np.pi * i / n_cams
        C = np.asarray(CUBE_RIG_CENTER, np.float64) + CUBE_RIG_OFFSET * np.array(
            [np.cos(a), np.sin(a), 0.0])
        th = CUBE_RIG_YAW * np.sin(a)
        R = np.array([[np.cos(th), 0, -np.sin(th)], [0, 1, 0],
                      [np.sin(th), 0, np.cos(th)]], np.float32)
        out.append((R, (-R @ C.astype(np.float32)).astype(np.float32)))
    return out


def cubemap_cameras(n_cams: int, fovx: float, fovy: float, device=None):
    """The CameraParams of `cubemap_rig(n_cams)` at the given FoVs."""
    dev = resolve_device(device)
    return [CameraParams.create(R, t, fovx, fovy, device=dev)
            for R, t in cubemap_rig(n_cams)]


def cubemap_gt(face_renders, cubemap_net, focal_x: float, focal_y: float,
               mask_radius: float, control_point_sample_scale: int
               ) -> torch.Tensor:
    """The GT of a known-lens cubemap dataset (3, H, W): the five face
    renders (FACES order) warped through `cubemap_net`, stitched by
    maximum intensity and circular-masked, as the cubemap mode's
    evaluation makes its image."""
    from ..calib import cubemap
    from ..train.calibrated import max_intensity_stitch

    _, h, w = face_renders[0].shape
    dev = face_renders[0].device
    K = np.array([[focal_x, 0, w / 2], [0, focal_y, h / 2], [0, 0, 1.0]])
    with torch.no_grad():
        faces, _ = cubemap.render_cubemap_faces(
            lambda i: face_renders[i], cubemap_net, K, w, h,
            control_point_sample_scale,
            cubemap.fov90_square_mask(h, w, focal_x, focal_y, dev))
        return max_intensity_stitch(faces) * cubemap.circular_mask(
            h, w, mask_radius, dev)


def write_cubemap_dataset(root: str, cams, width: int, height: int,
                          focal: float, points: np.ndarray,
                          colors: np.ndarray, render_faces, cubemap_net,
                          mask_radius: float,
                          control_point_sample_scale: int) -> list:
    """A COLMAP dataset for the cubemap mode at `root`: PINHOLE cameras
    `cams` of focal `focal` (the forward face spans 90 degrees where
    focal = width / 2), the `points` / `colors` in points3D, and in
    `images/` each camera's `cubemap_gt` through `cubemap_net`.
    render_faces(cam) returns the camera's five face renders (FACES
    order) and their instance counts. Returns the counts, one list a
    camera."""
    images, counts = [], []
    for cam in cams:
        faces, n = render_faces(cam)
        gt = cubemap_gt(faces, cubemap_net, focal, focal, mask_radius,
                        control_point_sample_scale)
        images.append(np.round(gt.clamp(0, 1).permute(1, 2, 0).cpu().numpy()
                               * 255).astype(np.uint8))
        counts.append(n)
    write_colmap_scene(root, cams, width, height, focal, focal, points,
                       colors, images)
    return counts


def cubemap_toy(device, gt: torch.Tensor = None) -> dict:
    """A toy cubemap training setup: 700 SH-1 Gaussians of the 48x40 toy
    scene, nudged off their true positions, two cameras inside their box
    (focal 24: the forward face spans 90 degrees), mask radius 20, control
    points every 8 pixels, a 2-block cubemap net of width 32 (weights x
    0.2) trained at lr 1e-4, pose and FoVs trained; the GT of camera 0 is
    the true scene through that net (`cubemap_gt`) unless `gt` is given.
    Returns dict(state, schedules, cfg, setup, sub_q, sub_t, gt)."""
    from .. import convert
    from ..raster.render import RenderConfig, render
    from ..train import calibrated
    from ..train.config import TrainConfig

    dev = resolve_device(device)
    w, h, focal = 48, 40, 24.0
    cfg = TrainConfig()
    cfg.model.sh_degree = 1
    c = cfg.calib
    c.cubemap = c.opt_cam = c.opt_intrinsic = True
    c.mask_radius, c.control_point_sample_scale, c.iresnet_lr = 20, 8, 1e-4
    sc = make_toy_scene(n=700, width=w, height=h, sh_degree=1, seed=0,
                        device=dev)
    cams = CameraParams.stack(cubemap_cameras(
        2, 2 * np.arctan(w / (2 * focal)), 2 * np.arctan(h / (2 * focal)),
        device=dev))
    static = CameraStatic(width=w, height=h)
    setup = calibrated.make_cubemap_setup(static, focal, focal, cfg, dev)
    sub_q, sub_t = calibrated.sub_camera_poses(cams)
    net_np = _narrow_net_np()
    if gt is None:
        true = [sc[k] for k in ("xyz", "scales", "quats", "opacity",
                                "sh_coeffs")]
        rcfg = RenderConfig(sh_degree=1, sort_by_distance=True)
        with torch.no_grad():
            faces = [render(*true, c, static, rcfg).render for c in
                     calibrated.face_cameras(cams[0], sub_q[0], sub_t[0])]
            gt = cubemap_gt(faces, convert.iresnet_from_numpy(net_np, dev),
                            focal, focal, c.mask_radius, 8)
    state, schedules = _toy_calib_state(sc, cams, cfg, dev,
                                        {"lens": net_np, "cubemap_net": net_np})
    return dict(state=state, schedules=schedules, cfg=cfg, setup=setup,
                sub_q=sub_q, sub_t=sub_t, gt=gt.to(dev))


def write_image(path: str, img: np.ndarray) -> None:
    """(H, W, 3) uint8 -> PNG."""
    from PIL import Image

    Image.fromarray(img).save(path)


def alpha_boundary_rows(rows: torch.Tensor, tile_start: torch.Tensor,
                        tile_count: torch.Tensor, tiles_x: int, tiles_y: int,
                        seed: int = 0, rel: float = 1e-6
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Instance rows whose opacities put one pair of every instance on the
    edge of the compositing's alpha test.

    For each instance, the pixel of its tile where its power is largest
    (formed in the compositors' operation order) gets o exp(power) =
    (1/255)(1 + eps), eps uniform in (-rel, rel) from numpy's `seed`: about
    half of these pairs pass the test and half fail. The tile's other pixels
    have powers no higher, almost all far lower, so they fail, and an
    instance's gradient is nonzero exactly when its edge pair passes.
    Instances whose largest power is above 0 or would need o > 1 get o = 0
    and fail everywhere. Returns (a copy of rows with the new opacity row,
    alpha (M,): o exp(power) of each instance's edge pair in float32 as the
    compositors form it, 0 where o = 0)."""
    from ..raster import tiles

    count = tile_count.long()
    tile_of = torch.repeat_interleave(
        torch.arange(tiles_x * tiles_y, device=rows.device), count)
    first = torch.cumsum(count, 0) - count
    slots = tile_start.long()[tile_of] + (
        torch.arange(tile_of.numel(), device=rows.device) - first[tile_of])
    px, py = tiles.tile_pixel_coords(tiles_x, tiles_y, rows.device)
    f = rows[:, slots]
    dx = px[tile_of] - f[tiles.R_MX][:, None]
    dy = py[tile_of] - f[tiles.R_MY][:, None]
    power = -0.5 * (f[tiles.R_CA][:, None] * dx * dx
                    + f[tiles.R_CC][:, None] * dy * dy) \
        - f[tiles.R_CB][:, None] * dx * dy
    top = power.max(dim=1).values
    eps = np.random.default_rng(seed).uniform(-rel, rel, slots.numel())
    top64 = top.double().cpu().numpy()
    with np.errstate(over="ignore"):
        o = tiles.ALPHA_MIN * np.exp(-top64) * (1.0 + eps)
    o = torch.as_tensor(np.where((top64 <= 0.0) & (o <= 1.0), o, 0.0)
                        .astype(np.float32), device=rows.device)
    out = rows.clone()
    out[tiles.R_O, slots] = o
    alpha = torch.zeros(rows.shape[1], dtype=torch.float32, device=rows.device)
    alpha[slots] = o * torch.exp(top)
    return out, alpha


# Tile ranges of `chunk_crossing_rows`: (start, count) per tile of a 3x1 grid.
CHUNK_CROSSING_TILES = ((0, 70), (70, 1000), (1070, 130))


def chunk_crossing_rows(device=None, seed: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   int, int]:
    """Compositing inputs whose tile ranges cross the ablation kernels'
    128-slot chunks and the forward's 256-instance batches mid-chunk.

    A 3x1 grid of 16x16 tiles over 1,200 instance slots
    (`CHUNK_CROSSING_TILES`): tile 1 starts mid-chunk at slot 70, spans the
    chunks 0 to 8, and its 256-instance batches end mid-chunk (slots 326,
    582, 838); tile 2 crosses the chunk boundary at 1152. Each slot is a
    Gaussian centred in its tile or within 2 pixels of it (numpy `seed`),
    standard deviations 0.7 to 6 pixels at a random angle (the conic is the
    inverse covariance), opacity 0.02 to 0.9, colour 0 to 1 and depth 0.5
    to 1.5.
    Returns (rows (10, 1200) float32, tile_start, tile_count (3,) int32,
    tiles_x 3, tiles_y 1) on `device` (default cuda)."""
    rng = np.random.default_rng(seed)
    start = np.array([s for s, _ in CHUNK_CROSSING_TILES], np.int32)
    count = np.array([c for _, c in CHUNK_CROSSING_TILES], np.int32)
    m = int(start[-1] + count[-1])
    tile = np.repeat(np.arange(len(start)), count)
    mx = tile * 16 + rng.uniform(-2.0, 17.0, m)
    my = rng.uniform(-2.0, 17.0, m)
    sig = rng.uniform(0.7, 6.0, (m, 2))
    ang = rng.uniform(0.0, np.pi, m)
    c, s = np.cos(ang), np.sin(ang)
    # conic = R diag(1 / sig^2) R^T
    ia, ib = 1.0 / sig[:, 0] ** 2, 1.0 / sig[:, 1] ** 2
    ca, cb, cc = c * c * ia + s * s * ib, c * s * (ia - ib), s * s * ia + c * c * ib
    rows = np.stack([mx, my, ca, cb, cc, rng.uniform(0.02, 0.9, m),
                     *rng.uniform(0.0, 1.0, (3, m)), rng.uniform(0.5, 1.5, m)])
    dev = resolve_device(device)
    return (torch.as_tensor(rows.astype(np.float32), device=dev),
            torch.as_tensor(start, device=dev), torch.as_tensor(count, device=dev),
            len(start), 1)
