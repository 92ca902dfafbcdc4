"""The training driver: `Trainer.run` (pose mode) or `CalibTrainer.run`
(fisheye mode) of the program, as the train CLI builds and drives them.

Set-up makes the scene, the cameras and the GT on the device from the
seed (`scene.py`), builds the program's trainer from the configuration's
train-CLI arguments over the training population in the configuration's
capacity and sets the SH degree the traffic names. `window.train_window`
then drives the trainer's own `run` through the steps the reference
follows (the camera of each is the first of the trainer's reshuffled
stack) and the warm-up, the window and, with `--trace 1`, the two
profiled segments, the second with the benchmark's spans "bench.lens"
around the program's lens flow and warp; a lens window the traffic closes
stays closed. `train_ms_per_iter` is the window's wall time, which ends
in a synchronise, over the steps completed in it. The work of every
camera the window and the first segment used is counted on the
reference's binning of the initial population: one render a step.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
from typing import Dict, List

import numpy as np
import torch

from reference import lens as ref_lens
from reference import render as ref_render
from reference.train import FisheyeGeometry, Hyper, train_steps

from .. import core, faults, scene as sc, window
from ..window import CHECK_STEPS
from ..work import step_work

FAMILY = "train"
CHECKS = ("loss_gap", "grad_gap", "change_gap", "camera_order", "config_departures")
# cam_gap too where the configuration trains camera rows (`own_leaves`)
LENS_SPAN = "bench.lens"

PROGRAM_FAULTS = {
    "unchanged": ([("bags_tpu_torch.train.loop", "train_step"),
                   ("bags_tpu_torch.train.calibrated", "fisheye_train_step")],
                  faults.unchanged),
    "half": ([("bags_tpu_torch.train.loop", "photometric_loss"),
              ("bags_tpu_torch.train.calibrated", "photometric_loss")], faults.half),
    "cam_x2": ([("bags_tpu_torch.train.loop", "row_adam_update")], faults.cam_scaled(2.0)),
    "cam_x0": ([("bags_tpu_torch.train.loop", "row_adam_update")], faults.cam_scaled(0.0)),
}


def _lens_window(cfg: dict, traffic: dict):
    return tuple(traffic.get("lens_window", cfg["hyper"].get("lens_window", (0, 0))))


def hyper(cfg: dict, traffic: dict, extent: float) -> Hyper:
    h = cfg["hyper"]
    pos = h["position_lr"]
    w = _lens_window(cfg, traffic)
    n = CHECK_STEPS
    opt_lens = cfg["mode"] == "fisheye" and all(
        w[0] <= it < w[1] and it >= 1 for it in range(1, n + 1))
    return Hyper(
        lambda_dssim=h["lambda_dssim"], xyz_lr=(pos[0] * extent, pos[1] * extent, pos[2]),
        feature_lr=h["feature_lr"], opacity_lr=h["opacity_lr"],
        scaling_lr=h["scaling_lr"], rotation_lr=h["rotation_lr"],
        rot_lr=h["r_t_lr"][0] if h["opt_cam"] else 0.0,
        trans_lr=h["r_t_lr"][1] if h["opt_cam"] else 0.0, fov_lr=h["fov_lr"],
        pose_milestones=tuple(h["pose_milestones"]), pose_gamma=h["pose_gamma"],
        sh_degree=traffic["active_sh_degree"], lens_lr=h.get("lens_lr", 0.0),
        opt_lens=opt_lens)


def own_leaves(hp: Hyper) -> List[str]:
    """The trained camera rows, whose gradients are compared against their
    own norms (`core.training_numbers`)."""
    return [f"cam.{k}" for k, lr in (("dq", hp.rot_lr), ("dt", hp.trans_lr)) if lr > 0]


def program_config(cfg: dict, traffic: dict, seed: int):
    """The program's TrainConfig as its train CLI parses the
    configuration's arguments, the traffic's lens window applied."""
    from bags_tpu_torch.cli.train import args_to_config, build_parser
    from bags_tpu_torch.train.presets import apply_preset

    args = build_parser().parse_args(apply_preset(["-s", "synthetic", *cfg["train_args"]]))
    tc = args_to_config(args)
    tc.seed = seed
    if "lens_window" in traffic:
        tc.calib.iresnet_opt_duration = tuple(traffic["lens_window"])
    return tc


def departures(tc, cfg: dict, traffic: dict) -> List[str]:
    """Where the program's parsed configuration differs from what the
    configuration file states (the reference trains by the file)."""
    h, o, c = cfg["hyper"], tc.opt, tc.calib
    want = {
        "lambda_dssim": (o.lambda_dssim, h["lambda_dssim"]),
        "position_lr": ([o.position_lr_init, o.position_lr_final,
                         o.position_lr_max_steps], list(h["position_lr"])),
        "feature_lr": (o.feature_lr, h["feature_lr"]),
        "opacity_lr": (o.opacity_lr, h["opacity_lr"]),
        "scaling_lr": (o.scaling_lr, h["scaling_lr"]),
        "rotation_lr": (o.rotation_lr, h["rotation_lr"]),
        "opt_cam": (c.opt_cam, h["opt_cam"]),
        "r_t_lr": (list(c.r_t_lr), list(h["r_t_lr"])),
        "fov_lr": (c.fov_lr if c.opt_intrinsic else 0.0, h["fov_lr"]),
        "pose_milestones": (list(c.pose_lr_milestones), list(h["pose_milestones"])),
        "pose_gamma": (c.pose_lr_gamma, h["pose_gamma"]),
        "sh_degree": (tc.model.sh_degree, cfg["scene"]["sh_degree"]),
        "batch_cams": (o.batch_cams, 1),
        "mcmc": (tc.mcmc, False), "hybrid": (c.hybrid, False),
        "white_background": (tc.model.white_background, False),
    }
    if cfg["mode"] == "fisheye":
        f = cfg["fisheye"]
        want.update({
            "outside_rasterizer": (c.outside_rasterizer and c.opt_distortion, True),
            "apply2gt": (c.apply2gt, False), "opt_shift": (c.opt_shift, False),
            "lens_lr": (c.iresnet_lr, h["lens_lr"]),
            "lens_window": (list(c.iresnet_opt_duration), list(_lens_window(cfg, traffic))),
            "flow_scale": (list(c.flow_scale), list(f["flow_scale"])),
            "control_point_sample_scale": (int(c.control_point_sample_scale),
                                           f["control_point_sample_scale"]),
            "vignetting_off": (c.start_vignetting > 10 ** 6, True),
            "no_distortion_mask": (c.no_distortion_mask, False),
            "lens_prefit": (not c.no_init_iresnet, cfg["lens_prefit_iters"] > 0)})
    else:
        want["outside_rasterizer"] = (c.outside_rasterizer or c.cubemap, False)
    return [k for k, (got, exp) in want.items() if got != exp]


def _padded(live: Dict[str, torch.Tensor], capacity: int):
    """The program's Gaussians of `capacity` rows, the live ones first and
    the rest dead as the train CLI pads an SfM init."""
    from bags_tpu_torch.model.gaussians import Gaussians

    n = live["xyz"].shape[0]
    fill = {"scales_log": -10.0, "opacity_raw": -10.0}

    def pad(k):
        t = live[k]
        rest = torch.full((capacity - n,) + tuple(t.shape[1:]), fill.get(k, 0.0),
                          device=t.device)
        if k == "quats":
            rest[:, 0] = 1e-8
        return torch.cat([t, rest]).contiguous()

    g = Gaussians(**{k: pad(k) for k in ("xyz", "sh_dc", "sh_rest", "scales_log",
                                         "quats", "opacity_raw")})
    return g, torch.arange(capacity, device=live["xyz"].device) < n


def _program_phase(cell, seed, seconds, trace, device, inputs):
    """Everything the program does, from its trainer's construction to the
    traced segment (`window.train_window`); returns host copies of what
    the comparison reads."""
    from bags_tpu_torch.core.camera import CameraParams, CameraStatic
    from bags_tpu_torch.raster.render import RenderConfig
    from bags_tpu_torch.train.calibrated import CalibTrainer
    from bags_tpu_torch.train.loop import Trainer

    cfg, traffic = cell.config, cell.traffic
    tc = program_config(cfg, traffic, seed)
    departed = departures(tc, cfg, traffic)
    notes = [f"configuration departs from the file: {d}" for d in departed]
    g, alive = _padded(inputs.pop("live"), cfg["capacity"])
    cams = CameraParams(**{k: v.clone() for k, v in inputs["cams"].items()})
    rcfg = RenderConfig(sh_degree=cfg["scene"]["sh_degree"])
    w, h = cfg["width"], cfg["height"]
    if cfg["mode"] == "fisheye":
        fx, fy = inputs["fish"]["focal"]
        trainer = CalibTrainer(g, alive, cams, CameraStatic(w, h), tc,
                               scene_extent=inputs["extent"], gt_images=inputs["gts"],
                               focal_x=fx, focal_y=fy, persp_wh=(w, h), fish_wh=(w, h),
                               rcfg=rcfg, seed=seed)
    else:
        trainer = Trainer(g, alive, cams, CameraStatic(w, h), tc,
                          scene_extent=inputs["extent"], gt_images=inputs["gts"],
                          rcfg=rcfg, seed=seed)
    del g, cams
    trainer.active_sh_degree = traffic["active_sh_degree"]
    n = cfg["scene"]["n_gaussians"]
    prog = window.train_window(trainer, seconds, trace, device, inputs["age"],
                               grads=lambda t: _first_grads(t, n),
                               leaves=lambda t: _leaves(t, n), host_spans=_lens_spans)
    notes.append(f"set-up: imports done at {inputs['start_s']:.2f} s, scene made at "
                 f"{inputs['scene_s']:.2f} s, GT made at {inputs['made_s']:.2f} s, "
                 f"trainer built at {prog['built_s']:.2f} s, checked steps done at "
                 f"{prog['checked_s']:.2f} s, warm at {prog['setup_s']:.2f} s")
    lens_s = None
    if trace and cfg["mode"] == "fisheye":
        lens_s = prog["host_trace"].attributed_seconds(LENS_SPAN)
    return dict(prog, lens_s=lens_s, notes=notes, departures=departed)


@contextlib.contextmanager
def _lens_spans():
    """The program's lens flow and warp inside "bench.lens" spans."""
    from bags_tpu_torch.calib import distortion

    patched = {}
    for name in ("compute_flow", "apply_distortion"):
        fn = getattr(distortion, name)
        patched[name] = fn
        setattr(distortion, name, _spanned(fn))
    try:
        yield
    finally:
        for name, fn in patched.items():
            setattr(distortion, name, fn)


def _spanned(fn):
    def wrapper(*a, **k):
        with torch.profiler.record_function(LENS_SPAN):
            return fn(*a, **k)
    return wrapper


def _first_grads(trainer, n: int) -> Dict[str, torch.Tensor]:
    """Each leaf's first gradient as the optimizers hold it after one
    step: Adam's first moment over (1 - beta1)."""
    b = trainer.base
    out = {}
    for k, p in b.g.fields().items():
        out[k] = (b.g_opt.state[p]["exp_avg"][:n] / 0.1).to("cpu", copy=True)
    for f, m in b.cam_opt.mu.items():
        out[f"cam.{f}"] = (m / 0.1).to("cpu", copy=True)
    if hasattr(trainer.state, "lens") and trainer.state.lens_opt.count:
        for k, m in trainer.state.lens_opt.mu.items():
            out[_lens_name(k)] = (m / 0.1).to("cpu", copy=True)
    return out


def _leaves(trainer, n: int) -> Dict[str, torch.Tensor]:
    b = trainer.base
    out = {k: t.detach()[:n].to("cpu", copy=True) for k, t in b.g.fields().items()}
    for f in ("dq", "dt", "fovx", "fovy"):
        out[f"cam.{f}"] = getattr(b.cams, f).detach().to("cpu", copy=True)
    if hasattr(trainer.state, "lens"):
        for k, t in trainer.state.lens.named_tensors(trained_only=True).items():
            out[_lens_name(k)] = t.detach().to("cpu", copy=True)
    return out


def _lens_name(k: str) -> str:
    """".weights[b][l]" -> "lens.w[b][l]", ".biases[b][l]" -> "lens.b[b][l]"."""
    return "lens." + k[1] + k[k.index("["):]


def population(cfg: dict, seed: int, device):
    """(the scene, the training population's raw leaves) of the seed."""
    s_scene, s_train, _, _ = sc.sub_seeds(seed)
    scene = sc.make_scene(cfg, s_scene, device)
    return scene, sc.perturb(scene.raw(), cfg["train_perturbation"], s_train, device)


def reference_setup(cfg: dict, traffic: dict, seed: int, inputs: dict):
    """(the checked steps' cameras, the hyperparameters, the fisheye
    geometry or None) the reference trains with. The cameras are the
    first of the trainer's stack: a permutation drawn from
    `np.random.default_rng(seed)`, taken from its end."""
    n = cfg["cameras"]["n"]
    order = [int(i) for i in np.random.default_rng(seed).permutation(n)[::-1]]
    fish = inputs["fish"]
    geometry = None if fish is None else FisheyeGeometry(
        width=cfg["width"], height=cfg["height"], grid_hw=fish["grid_hw"],
        flow_hw=fish["flow_hw"], fish_hw=fish["fish_hw"], p_view=fish["p_view"],
        lens_seed=seed)
    return order[:CHECK_STEPS], hyper(cfg, traffic, inputs["extent"]), geometry


def initial_leaves(live, cams, geometry) -> Dict[str, torch.Tensor]:
    """Every leaf before the first step, by the reference's names."""
    init = {k: v.float() for k, v in live.items()}
    init.update({f"cam.{k}": cams[k] for k in ("dq", "dt", "fovx", "fovy")})
    if geometry is not None:
        ws, bs, _ = ref_lens.init_lens(geometry.lens_seed, device=live["xyz"].device)
        init.update({f"lens.w[{b}][{l}]": t for b, blk in enumerate(ws)
                     for l, t in enumerate(blk)})
        init.update({f"lens.b[{b}][{l}]": t for b, blk in enumerate(bs)
                     for l, t in enumerate(blk)})
    return init


def make_inputs(cfg: dict, seed: int, device, age) -> dict:
    """The scene's GT, the training population and the cameras."""
    start_s = age()
    clean = sc.lookat_cameras(cfg)
    poses = sc.noisy(clean, cfg["pose_noise"], cfg["noise_seed"]) \
        if any(cfg["pose_noise"]) else clean
    fish = sc.fisheye_geometry(cfg, device) if cfg["mode"] == "fisheye" else None
    scene, live = population(cfg, seed, device)
    if live["xyz"].is_cuda:
        torch.cuda.synchronize(live["xyz"].device)
    scene_s = age()
    gts = sc.gt_images(scene, clean, cfg, device, fish)
    del scene
    fovx = fish["fovx"] if fish else cfg["fov"]
    fovy = fish["fovy"] if fish else cfg["fov"]
    cams = sc.camera_table(poses, fovx, fovy, device)
    if gts.is_cuda:
        torch.cuda.synchronize(gts.device)
    return dict(live=live, gts=gts, fish=fish, extent=sc.extent(clean), cams=cams,
                age=age, start_s=start_s, scene_s=scene_s, made_s=age())


def run(cell, seed: int, seconds: float, trace: bool, device, age) -> core.Run:
    cfg, traffic = cell.config, cell.traffic
    inputs = make_inputs(cfg, seed, device, age)
    prog = _program_phase(cell, seed, seconds, trace, device, inputs)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, from the same inputs, made again from the seed
    live = population(cfg, seed, device)[1]
    order, hp, geometry = reference_setup(cfg, traffic, seed, inputs)
    ref = train_steps(live, inputs["cams"], inputs["gts"], order, hp,
                      torch.zeros(3, device=device), geometry)
    init = initial_leaves(live, inputs["cams"], geometry)
    to_dev = lambda d: {k: v.to(device) for k, v in d.items()}  # noqa: E731
    nums = core.training_numbers(prog["losses"], ref["losses"], to_dev(prog["grads"]),
                                 ref["grads"], to_dev(prog["after"]), ref["after"], init,
                                 own_leaves(hp))
    nums["camera_order"] = 0.0 if prog["check_cams"] == order else 1.0
    nums["config_departures"] = float(len(prog["departures"]))
    checks = {k: (v, cell.limits.get(k, 0.0)) for k, v in nums.items()}
    notes = list(prog["notes"]) + [
        f"losses program {prog['losses']} reference {ref['losses']}",
        f"{prog['steps']} steps in the window, cameras {prog['check_cams']} checked"]

    out = core.Run(driver=FAMILY,
                   e2e={"train_ms_per_iter": prog["ms"], "setup_s": prog["setup_s"],
                        "peak_mem_gib": prog["peak"] / 2 ** 30},
                   attempted=prog["steps"], failed=prog["failed"], checks=checks,
                   peak_bytes=prog["peak"], trace=prog["trace"],
                   host_trace=prog["host_trace"],
                   traced_steps=len(prog["traced_cams"]), lens_s=prog["lens_s"],
                   notes=notes)
    if trace:
        out.work = work(cfg, live, inputs, hp, prog["window_cams"], prog["traced_cams"])
    return out


def work(cfg, live, inputs, hp, window_cams, traced_cams) -> Dict[str, float]:
    """The least seconds of the window's steps (their mean) and the
    kernels' least seconds over the traced steps, counted per camera on
    the reference's projection and binning of the initial population."""
    fish = inputs["fish"]
    cams = inputs["cams"]
    points = fish["grid_hw"][0] * fish["grid_hw"][1] if fish else 0
    per_cam = {}
    for c in sorted(set(window_cams) | set(traced_cams)):
        R, t = ref_render.camera_pose(cams["q_init"][c], cams["t_init"][c],
                                      cams["dq"][c], cams["dt"][c])
        per_cam[c] = step_work(live, None, R, t, cams["fovx"][c], cams["fovy"][c],
                               cfg["width"], cfg["height"], hp.sh_degree,
                               lens_points=points, lens_trained=hp.opt_lens)
    return {"renders_per_step": 1,
            "step_least_s": statistics.mean(per_cam[c]["step"] for c in window_cams),
            "fwd_least_s_traced": sum(per_cam[c]["fwd"] for c in traced_cams),
            "bwd_least_s_traced": sum(per_cam[c]["bwd"] for c in traced_cams),
            "instances_mean": statistics.mean(per_cam[c]["instances"]
                                              for c in window_cams)}


def control_readings(cell, seed: int, device) -> list:
    """The control's and the "half" fault's loss_gap, grad_gap and
    change_gap (and cam_gap where camera rows train), each planted in the
    reference and read against the float32 reference at the cell's size;
    a state left unchanged reads 1 on change_gap by the measure, with no
    run."""
    cfg, traffic = cell.config, cell.traffic
    inputs = make_inputs(cfg, seed, device, lambda: 0.0)
    live = inputs["live"]
    order, hp, geometry = reference_setup(cfg, traffic, seed, inputs)
    args = (live, inputs["cams"], inputs["gts"], order, hp,
            torch.zeros(3, device=device), geometry)
    truth = train_steps(*args)
    init = initial_leaves(live, inputs["cams"], geometry)
    ctl = cfg["control"]
    runs = {f"control_{ctl['dtype']}{'_tf32' if ctl['tf32'] else ''}":
            dict(dtype=faults.DTYPES[ctl["dtype"]], tf32=ctl["tf32"]),
            "fault_half": dict(fault="half")}
    out = []
    for name, kw in runs.items():
        r = train_steps(*args, **kw)
        nums = core.training_numbers(r["losses"], truth["losses"], r["grads"],
                                     truth["grads"], r["after"], truth["after"], init,
                                     own_leaves(hp))
        out.append({"workload": cell.name, "seed": seed, "reading": name, **nums})
    out.append({"workload": cell.name, "seed": seed, "reading": "fault_unchanged",
                "change_gap": 1.0})
    return out
