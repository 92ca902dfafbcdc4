"""The cubemap driver: `CalibTrainer.run` of the program in its cubemap mode
(`--preset cubemap`, fields of view past 180 degrees), five renders a step.

Set-up makes on the device from the seed a scene that surrounds the rig
(`shell_scene`: Gaussians uniform in direction and in radius about the
rig's centre, the other recipes' SH, scales, rotations and opacities),
the training population (the scene with seeded noise, `scene.perturb`),
a rig of cameras on a small circle about the centre looking outward
(`rig_cameras`) and each camera's GT (`reference/cubemap.gt_image`: the
clean scene's five faces, binned by distance, through the configuration's
known lens, stitched by maximum intensity, disc-masked, 8-bit). It builds
the program's `CalibTrainer` from the configuration's train-CLI arguments,
the disc's radius in whole pixels passed as `--mask_radius` (the preset's
512 at full size; the toy cut scales it), at the configuration's focal
length, over the population in the configuration's capacity, and hands it
to `window.train_window` like the training driver.

The comparison is the training driver's against `reference/cubemap.py`:
each checked step's loss, every leaf's first gradient (the cubemap net's
from its Adam first moment, like the Gaussians') and the Gaussians' and
camera rows' change after the checked steps. The net's change is left
out: at the preset's learning rate of 1e-9 a weight of 0.04 moves 1e-9 a
step, under a third of its float32 spacing there (3.7e-9), so what the
three steps leave is rounding and not arithmetic.

The work is counted per camera on the reference's distance-keyed binning
of the initial population (`cubemap_counts.py`): the five faces' kernel
bounds, the net, the rays and the five warps; `renders_per_step` 5. With
`--trace 1` the program's binned instances a step over the five faces
(its `StepMetrics.face_instances`) are recorded in the first traced
segment (`face_instances`); a program whose metrics lack them records
none.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import statistics
from typing import Dict, List

import numpy as np
import torch

import cubemap_counts
from counts import bound, bwd_bytes, bwd_ops, fwd_bytes, fwd_ops, least_seconds
from reference import cubemap as ref_cube

from .. import core, faults, scene as sc, window
from ..window import CHECK_STEPS, TRACED_STEPS
from . import train as drv

FAMILY = "train"
CHECKS = ("loss_gap", "grad_gap", "change_gap", "camera_order", "config_departures")


def side_faces_dropped(real):
    """The ray field and warps with the four side faces' images zeroed."""
    def faces(*a, **k):
        out, n = real(*a, **k)
        return out[:1] + [torch.zeros_like(f) for f in out[1:]], n
    return faces


PROGRAM_FAULTS = {
    "unchanged": ([("bags_tpu_torch.train.calibrated", "cubemap_train_step")],
                  faults.unchanged),
    "half": ([("bags_tpu_torch.train.calibrated", "l1_loss"),
              ("bags_tpu_torch.train.calibrated", "ssim")], faults.half),
    "side_faces_dropped": ([("bags_tpu_torch.calib.cubemap", "render_cubemap_faces")],
                           side_faces_dropped),
}


def shell_scene(cfg: dict, seed: int, device) -> sc.Scene:
    """The configuration's scene: Gaussians uniform in direction and in
    radius in `shell_radius` about the rig's centre, from one torch
    generator on the device."""
    s = cfg["scene"]
    n, k = s["n_gaussians"], (s["sh_degree"] + 1) ** 2
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kw = dict(generator=gen, device=device)
    d = torch.randn((n, 3), **kw)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    r0, r1 = s["shell_radius"]
    r = r0 + (r1 - r0) * torch.rand((n, 1), **kw)
    xyz = torch.tensor(cfg["cameras"]["center"], device=device) + r * d
    sh = torch.randn((n, k, 3), **kw)
    sh[:, 1:] *= 0.1
    lo, hi = (math.log(x) for x in s["scale_range"])
    scales = torch.exp(lo + (hi - lo) * torch.rand((n, 3), **kw))
    quats = torch.randn((n, 4), **kw)
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    o0, o1 = s["opacity_range"]
    opacity = o0 + (o1 - o0) * torch.rand((n,), **kw)
    return sc.Scene(xyz=xyz, sh=sh, scales=scales, quats=quats, opacity=opacity)


def rig_cameras(cfg: dict):
    """The rig: `n` cameras on a horizontal circle of `radius` about the
    centre, camera i at azimuth 2 pi (i + 1/2) / n looking outward along
    it, pitched by elev sin(1.7 i). (R, t) world-to-camera, float64 numpy.
    The half step keeps every face's rotation off 180 degrees, where the
    sign of its quaternion (w >= 0), which decides the sign of the row
    offset dq's gradient through the face, would be rounding's choice."""
    c = cfg["cameras"]
    center = np.asarray(c["center"], np.float64)
    out = []
    for i in range(c["n"]):
        a = 2 * math.pi * (i + 0.5) / c["n"]
        b = c["elev"] * math.sin(1.7 * i)
        C = center + c["radius"] * np.array([math.sin(a), 0.0, math.cos(a)])
        f = np.array([math.sin(a) * math.cos(b), math.sin(b), math.cos(a) * math.cos(b)])
        out.append(sc._lookat(C, C + f))
    return out


def fovs(cfg: dict):
    fx, fy = cfg["focal"]
    return 2 * math.atan(cfg["width"] / (2 * fx)), 2 * math.atan(cfg["height"] / (2 * fy))


def geometry(cfg: dict, seed: int) -> ref_cube.CubemapGeometry:
    """The reference's sizes; its net from seed + 1, as the program's
    `init_calib_state` draws the cubemap net."""
    cm = cfg["cubemap"]
    return ref_cube.CubemapGeometry(
        width=cfg["width"], height=cfg["height"], focal=float(cfg["focal"][0]),
        mask_radius=int(round(cm["mask_radius"])),
        sample_scale=int(cm["control_point_sample_scale"]), net_seed=seed + 1)


def population(cfg: dict, seed: int, device):
    """(the scene, the training population's raw leaves) of the seed."""
    s_scene, s_train, _, _ = sc.sub_seeds(seed)
    scene = shell_scene(cfg, s_scene, device)
    return scene, sc.perturb(scene.raw(), cfg["train_perturbation"], s_train, device)


def make_inputs(cfg: dict, seed: int, device, age) -> dict:
    """The cameras, the training population and each camera's GT."""
    start_s = age()
    poses = rig_cameras(cfg)
    fovx, fovy = fovs(cfg)
    cams = sc.camera_table(poses, fovx, fovy, device)
    scene, live = population(cfg, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    scene_s = age()
    geo = geometry(cfg, seed)
    raw = scene.raw()
    gts = torch.stack([ref_cube.gt_image(raw, cams["q_init"][i], cams["t_init"][i],
                                         cams["fovx"][i], cams["fovy"][i], geo,
                                         cfg["cubemap"]["known_lens"],
                                         cfg["scene"]["sh_degree"])
                       for i in range(len(poses))])
    del scene, raw
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return dict(live=live, gts=gts, extent=sc.extent(poses), cams=cams, geometry=geo,
                age=age, start_s=start_s, scene_s=scene_s, made_s=age())


def hyper(cfg: dict, traffic: dict, extent: float):
    """The training driver's hyperparameters with the net trained every
    step at the configuration's rate and milestones."""
    h = cfg["hyper"]
    return dataclasses.replace(drv.hyper(cfg, traffic, extent), lens_lr=h["lens_lr"],
                               lens_milestones=tuple(h["lens_milestones"]),
                               opt_lens=True)


def program_config(cfg: dict, traffic: dict, seed: int):
    radius = int(round(cfg["cubemap"]["mask_radius"]))
    return drv.program_config(dict(cfg, train_args=list(cfg["train_args"]) + [
        "--mask_radius", str(radius)]), traffic, seed)


def departures(tc, cfg: dict, traffic: dict) -> List[str]:
    """The training driver's departures but its lens keys, and the cubemap
    mode's own."""
    c, cm, h = tc.calib, cfg["cubemap"], cfg["hyper"]
    out = [d for d in drv.departures(tc, cfg, traffic) if d != "outside_rasterizer"]
    want = {
        "cubemap": (c.cubemap and not c.outside_rasterizer, True),
        "mask_radius": (c.mask_radius, int(round(cm["mask_radius"]))),
        "control_point_sample_scale": (int(c.control_point_sample_scale),
                                       cm["control_point_sample_scale"]),
        "lens_lr": (c.iresnet_lr, h["lens_lr"]),
        "lens_prefit": (not c.no_init_iresnet, False),
    }
    return out + [k for k, (got, exp) in want.items() if got != exp]


NET_NAMES = {"weights": "w", "biases": "b"}


def _net_name(k: str) -> str:
    """".weights[b][l]" -> "cubemap.w[b][l]" (the reference's names)."""
    field = k[1:k.index("[")]
    return f"{ref_cube.NET_PREFIX}.{NET_NAMES[field]}{k[k.index('['):]}"


def _first_grads(trainer, n: int) -> Dict[str, torch.Tensor]:
    out = drv._first_grads(trainer, n)
    for k, m in trainer.state.cubemap_opt.mu.items():
        out[_net_name(k)] = (m / 0.1).to("cpu", copy=True)
    return out


def _program_phase(cell, seed, seconds, trace, device, inputs):
    """The program's trainer through `window.train_window`; returns host
    copies of what the comparison reads and the face counts the program
    reported a step."""
    from bags_tpu_torch.core.camera import CameraParams, CameraStatic
    from bags_tpu_torch.raster.render import RenderConfig
    from bags_tpu_torch.train.calibrated import CalibTrainer

    cfg, traffic = cell.config, cell.traffic
    tc = program_config(cfg, traffic, seed)
    departed = departures(tc, cfg, traffic)
    notes = [f"configuration departs from the file: {d}" for d in departed]
    g, alive = drv._padded(inputs.pop("live"), cfg["capacity"])
    cams = CameraParams(**{k: v.clone() for k, v in inputs["cams"].items()})
    w, h = cfg["width"], cfg["height"]
    fx, fy = cfg["focal"]
    trainer = CalibTrainer(g, alive, cams, CameraStatic(w, h), tc,
                           scene_extent=inputs["extent"], gt_images=inputs["gts"],
                           focal_x=fx, focal_y=fy, persp_wh=(w, h),
                           rcfg=RenderConfig(sh_degree=cfg["scene"]["sh_degree"]),
                           seed=seed)
    del g, cams
    trainer.active_sh_degree = traffic["active_sh_degree"]
    faces: List[object] = []
    step = trainer.step

    def counted(idx, gt, it=None):
        metrics = step(idx, gt, it)
        faces.append((int(idx), getattr(metrics, "face_instances", None)))
        return metrics

    trainer.step = counted
    n = cfg["scene"]["n_gaussians"]
    prog = window.train_window(trainer, seconds, trace, device, inputs["age"],
                               grads=lambda t: _first_grads(t, n),
                               leaves=lambda t: drv._leaves(t, n))
    notes.append(f"set-up: imports done at {inputs['start_s']:.2f} s, scene made at "
                 f"{inputs['scene_s']:.2f} s, GT made at {inputs['made_s']:.2f} s, "
                 f"trainer built at {prog['built_s']:.2f} s, checked steps done at "
                 f"{prog['checked_s']:.2f} s, warm at {prog['setup_s']:.2f} s")
    return dict(prog, notes=notes, departures=departed, faces=faces)


def face_notes(faces) -> List[str]:
    """Each camera's fewest binned instances a face over the run's steps."""
    least: Dict[int, List[int]] = {}
    for c, counts in faces:
        if counts is not None:
            least[c] = [min(a, b) for a, b in zip(least.get(c, counts), counts)]
    return [f"camera {c}: fewest instances a face " + ", ".join(map(str, v))
            for c, v in sorted(least.items())]


def traced_face_instances(faces) -> Dict[str, float]:
    """The program's instances a step over the five faces in the first
    traced segment (the window's steps, then TRACED_STEPS device-traced
    ones, then TRACED_STEPS host-traced ones), or nothing."""
    seg = [counts for _, counts in faces[-2 * TRACED_STEPS:-TRACED_STEPS]]
    if len(seg) != TRACED_STEPS or any(c is None for c in seg):
        return {}
    return {"face_instances": statistics.mean(sum(c) for c in seg)}


def worst_leaf(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> str:
    """The common leaf whose norm is farthest from the reference's, as
    `core.leaf_gap` measures each, with its gap."""
    keys = sorted(set(prog) & set(ref))
    if not keys:
        return "none"
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in keys}
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    med = statistics.median(rn.values())
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys}
    k = max(gaps, key=gaps.get)
    return f"{k} {gaps[k]:.3e}"


def reference_order(cfg: dict, seed: int) -> List[int]:
    """The checked steps' cameras: the first of the trainer's stack, a
    permutation from `np.random.default_rng(seed)` taken from its end."""
    n = cfg["cameras"]["n"]
    return [int(i) for i in np.random.default_rng(seed).permutation(n)[::-1]][:CHECK_STEPS]


def _without_net(after: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in after.items() if not k.startswith(ref_cube.NET_PREFIX + ".")}


def run(cell, seed: int, seconds: float, trace: bool, device, age) -> core.Run:
    cfg, traffic = cell.config, cell.traffic
    inputs = make_inputs(cfg, seed, device, age)
    prog = _program_phase(cell, seed, seconds, trace, device, inputs)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    live = population(cfg, seed, device)[1]
    order = reference_order(cfg, seed)
    hp = hyper(cfg, traffic, inputs["extent"])
    ref = ref_cube.train_steps(live, inputs["cams"], inputs["gts"], order, hp,
                               torch.zeros(3, device=device), inputs["geometry"])
    init = drv.initial_leaves(live, inputs["cams"], None)
    grads_p = {k: v.to(device) for k, v in prog["grads"].items()}
    after_p = {k: v.to(device) for k, v in prog["after"].items()}
    after_r = _without_net(ref["after"])
    nums = core.training_numbers(prog["losses"], ref["losses"], grads_p, ref["grads"],
                                 after_p, after_r, init, drv.own_leaves(hp))
    nums["camera_order"] = 0.0 if prog["check_cams"] == order else 1.0
    nums["config_departures"] = float(len(prog["departures"]))
    checks = {k: (v, cell.limits.get(k, 0.0)) for k, v in nums.items()}
    moved_p = {k: after_p[k] - init[k] for k in after_r}
    moved_r = {k: v - init[k] for k, v in after_r.items()}
    notes = list(prog["notes"]) + face_notes(prog["faces"]) + [
        f"losses program {prog['losses']} reference {ref['losses']}",
        f"worst leaves: gradient {worst_leaf(grads_p, ref['grads'])}, "
        f"change {worst_leaf(moved_p, moved_r)}",
        f"{prog['steps']} steps in the window, cameras {prog['check_cams']} checked"]

    out = core.Run(driver=FAMILY,
                   e2e={"train_ms_per_iter": prog["ms"], "setup_s": prog["setup_s"],
                        "peak_mem_gib": prog["peak"] / 2 ** 30},
                   attempted=prog["steps"], failed=prog["failed"], checks=checks,
                   peak_bytes=prog["peak"], trace=prog["trace"],
                   host_trace=prog["host_trace"],
                   traced_steps=len(prog["traced_cams"]), notes=notes)
    if trace:
        out.work = work(cfg, live, inputs, hp, prog["window_cams"], prog["traced_cams"])
        out.work.update(traced_face_instances(prog["faces"]))
    return out


def work(cfg, live, inputs, hp, window_cams, traced_cams) -> Dict[str, float]:
    """The least seconds of the window's steps (their mean) and the
    kernels' least seconds over the traced steps' five renders each,
    counted per camera on the reference's distance-keyed binning of the
    initial population."""
    w, h = cfg["width"], cfg["height"]
    s = int(cfg["cubemap"]["control_point_sample_scale"])
    points = (h // s) * (w // s)
    n_live = live["xyz"].shape[0]
    per_cam = {}
    for c in sorted(set(window_cams) | set(traced_cams)):
        faces = cubemap_counts.camera_faces(live, inputs["cams"], c, w, h, hp.sh_degree)
        terms = cubemap_counts.step_terms(n_live, faces, w, h, points)
        per_cam[c] = dict(
            step=least_seconds(terms), instances=sum(m for _, m, _ in faces),
            fwd=sum(bound(fwd_bytes(m, nt), fwd_ops(p))[0] for p, m, nt in faces) * 1e-3,
            bwd=sum(bound(bwd_bytes(m, nt), bwd_ops(p))[0] for p, m, nt in faces) * 1e-3)
    return {"renders_per_step": len(ref_cube.FACES),
            "step_least_s": statistics.mean(per_cam[c]["step"] for c in window_cams),
            "fwd_least_s_traced": sum(per_cam[c]["fwd"] for c in traced_cams),
            "bwd_least_s_traced": sum(per_cam[c]["bwd"] for c in traced_cams),
            "instances_mean": statistics.mean(per_cam[c]["instances"]
                                              for c in window_cams)}


def control_readings(cell, seed: int, device) -> list:
    """The TF32 control's, the "half" and "side_faces_dropped" faults'
    loss_gap, grad_gap and change_gap, each planted in the reference and
    read against the float32 reference at the cell's size; a state left
    unchanged reads 1 on change_gap by the measure, with no run."""
    cfg, traffic = cell.config, cell.traffic
    inputs = make_inputs(cfg, seed, device, lambda: 0.0)
    live = inputs["live"]
    order = reference_order(cfg, seed)
    hp = hyper(cfg, traffic, inputs["extent"])
    args = (live, inputs["cams"], inputs["gts"], order, hp,
            torch.zeros(3, device=device), inputs["geometry"])
    truth = ref_cube.train_steps(*args)
    init = drv.initial_leaves(live, inputs["cams"], None)
    ctl = cfg["control"]
    runs = {f"control_{ctl['dtype']}{'_tf32' if ctl['tf32'] else ''}":
            dict(dtype=faults.DTYPES[ctl["dtype"]], tf32=ctl["tf32"]),
            "fault_half": dict(fault="half"),
            "fault_side_faces_dropped": dict(fault="side_faces_dropped")}
    out = []
    for name, kw in runs.items():
        r = ref_cube.train_steps(*args, **kw)
        nums = core.training_numbers(r["losses"], truth["losses"], r["grads"],
                                     truth["grads"], _without_net(r["after"]),
                                     _without_net(truth["after"]), init,
                                     drv.own_leaves(hp))
        out.append({"workload": cell.name, "seed": seed, "reading": name, **nums})
    out.append({"workload": cell.name, "seed": seed, "reading": "fault_unchanged",
                "change_gap": 1.0})
    return out
