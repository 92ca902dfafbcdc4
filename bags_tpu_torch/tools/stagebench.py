"""Per-stage timings of a render + loss fwd+bwd step (port of
`tools/stagebench.py`).

    python -m bags_tpu_torch.tools.stagebench [--n 100000 --size 800
        --max_instances 1048576 --device cuda]

On the JAX tools' workload (`utils/profiling.toy_workload`) it times, each
alone: binning, the render forward, render + loss forward, the gather
forward and backward, the compositing kernels forward and backward, the
projection fwd+bwd, the SSIM loss fwd+bwd, and the full step
(`render_step`: `render()` + photometric loss, forward and backward, as
the JAX tool times it; the profile CLI traces it) in ms and Mpix/s. Each
time is the median of 7 calls after a warm-up, CUDA events on the card
(`utils/profiling.timed`); the JAX tool's chain of calls inside one jit
has no counterpart here.

`stage_split` times the program's own step by its spans
(`utils/spans.py`): a listener synchronises the card at every span
boundary and charges the time since the last one to the innermost open
span. `train_step_stages` splits `train_step` of a trained model so,
`fisheye_step_stages` `fisheye_train_step` and `cubemap_step_stages`
`cubemap_train_step` (`chip_smoke.py` calls all three). For a hybrid or
MCMC state the first two add `hybrid_mcmc_stages`: the specular colour's
forward and its backward alone, one `mcmc_step` and one
`mcmc_noise_step`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from ..core.projection import distance_to_camera, project_gaussians
from ..raster import binning, composite, tiles
from ..raster.render import RenderConfig, build_packet_table, gather_rows, render
from ..train.losses import photometric_loss
from ..utils import spans
from ..utils.device import resolve_device
from ..utils.profiling import timed, toy_workload

ARGS = ("xyz", "scales", "quats", "opacity", "sh_coeffs")
CAM_LEAVES = ("dq", "dt", "fovx", "fovy")
# the spans of `render_step`
STAGES = ("render", "projection", "binning", "gather", "composite", "loss",
          "backward")
# the layer spans of a training step (a fisheye step adds "lens")
STEP_STAGES = ("projection", "binning", "gather", "composite", "loss",
               "backward", "optimizers")


def _leaves(sc):
    """Fresh leaves of the five Gaussian tensors and of the camera's
    `CAM_LEAVES`, and the camera made of them."""
    leaves = [sc[k].detach().requires_grad_(True) for k in ARGS]
    cam_leaves = [getattr(sc["cam"], f).detach().requires_grad_(True)
                  for f in CAM_LEAVES]
    return leaves, cam_leaves, dataclasses.replace(
        sc["cam"], **dict(zip(CAM_LEAVES, cam_leaves)))


def render_step(sc, cfg, gt):
    """One `render()` + photometric-loss step against `gt` (3, H, W),
    forward and backward, its loss and backward under their spans. Returns
    the loss and its gradients: the five Gaussian tensors of `ARGS`, then
    the camera's `CAM_LEAVES`."""
    leaves, cam_leaves, cam = _leaves(sc)
    img = render(*leaves, cam, sc["static"], cfg).render
    with spans.span("loss"):
        loss = photometric_loss(img, gt)
    with spans.span("backward"):
        grads = torch.autograd.grad(loss, leaves + cam_leaves)
    return loss.detach(), grads


def stage_times(n, size, max_instances, device):
    """Median ms of each stage on the tools' workload; prints one line
    each and returns {stage: ms} (and "Mpix/s" of the full step)."""
    device = resolve_device(device)
    sc, proj, bins, rows, tx, ty = toy_workload(n, size, max_instances, device)
    static = sc["static"]
    args = [sc[k] for k in ARGS]
    cfg = RenderConfig(sh_degree=3, max_instances=max_instances)
    gt = torch.zeros((3, size, size), device=device)
    print(f"n_instances: {bins.n_instances} dropped: {bins.n_dropped} "
          f"device: {device}")
    out = {}

    def report(name, fn):
        out[name] = timed(fn, device)
        print(f"{name:26s}: {out[name]:7.3f} ms")

    with torch.no_grad():
        report("binning", lambda: binning.bin_gaussians(
            proj, tx, ty, max_instances))
        report("render fwd (full)", lambda: render(
            *args, sc["cam"], static, cfg).render)
        report("render+loss fwd", lambda: photometric_loss(render(
            *args, sc["cam"], static, cfg).render, gt))
        table = build_packet_table(proj, proj.x2d, proj.y2d)
        report("gather fwd", lambda: gather_rows(table, None, bins.gauss_id))

    table_g = table.clone().requires_grad_(True)
    absp = torch.zeros((n, 2), device=device, requires_grad=True)
    rows_g = gather_rows(table_g, absp, bins.gauss_id)
    report("gather bwd (index_add_)", lambda: torch.autograd.grad(
        rows_g, [table_g, absp], rows, retain_graph=True))

    with torch.no_grad():
        comp = (rows, bins.tile_start, bins.tile_count, tx, ty)
        report("composite fwd", lambda: composite.composite_fwd(*comp))
        color, t_final = composite.composite_fwd(*comp)
        g_t = torch.zeros_like(t_final)
        report("composite bwd", lambda: composite.composite_bwd(
            *comp, color, g_t, color, t_final))

    def proj_fwd_bwd():
        xyz = args[0].detach().requires_grad_(True)
        x2d = project_gaussians(xyz, *args[1:], sc["cam"], static, 3).x2d
        return torch.autograd.grad(x2d, xyz, x2d.detach())
    report("projection fwd+bwd", proj_fwd_bwd)

    img0 = torch.zeros((3, size, size), device=device, requires_grad=True)
    report("ssim loss fwd+bwd", lambda: torch.autograd.grad(
        photometric_loss(img0, gt), img0))

    report("FULL fwd+bwd step", lambda: render_step(sc, cfg, gt))
    out["Mpix/s"] = size * size / (out["FULL fwd+bwd step"] / 1e3) / 1e6
    print(f"  -> {out['Mpix/s']:.2f} Mpix/s")
    return out


def train_step_stages(state, scene, cfg, device):
    """Where a training step of `state` on `scene`'s train view 0 goes, on
    the card, at SH degree 0: `train_step` split by its spans
    (`stage_split`), the backward kernel timed apart
    (`backward_kernel_ms`), then `train_step` itself and the peak memory;
    for a hybrid or MCMC state `hybrid_mcmc_stages` follows. Prints and
    returns the stages (ms), the step times and the peak memory (GiB)."""
    from ..train.loop import train_step

    idx = 0
    gt = scene.train_image(idx)
    bg = torch.zeros(3, device=device)
    rcfg = RenderConfig(sh_degree=0)

    def step():
        return train_step(state, gt, idx, bg, scene.static, rcfg, cfg)

    stages = stage_split(step)
    cam = state.cams[idx]
    bwd_ms, instances = backward_kernel_ms(state, cam, scene.static, 0, device)
    stages["backward_kernel"] = bwd_ms
    stages["backward_rest"] = stages["backward"] - bwd_ms
    stages.update(hybrid_mcmc_stages(state, cfg, cam, device))

    step_ms, peak = _step_ms_and_peak(step)
    print("train step stages_ms " + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    print(f"train step: {instances} instances, {int(state.alive.sum())} live of "
          f"{state.capacity}; step_ms " + " ".join(f"{x:.2f}" for x in step_ms)
          + f"; peak memory {peak:.2f} GiB")
    return {"stages_ms": stages, "step_ms": step_ms, "peak_gib": peak}


def backward_kernel_ms(state, cam, static, sh_degree, device,
                       sort_by_distance: bool = False):
    """The backward compositing kernel alone on `cam`'s view of the
    TrainState `state` (CUDA events, median of 10, random cotangents) and
    the view's instance count."""
    g = state.g
    with torch.no_grad():
        proj = project_gaussians(g.xyz, g.scaling(), g.quats,
                                 g.opacity(state.alive), g.sh_coeffs(), cam,
                                 static, sh_degree, align=state.align)
        tx, ty = tiles.tile_grid(static.width, static.height)
        bins = binning.bin_gaussians(proj, tx, ty, sort_key_depth=(
            distance_to_camera(g.xyz, cam, state.align)
            if sort_by_distance else None))
        rows = build_packet_table(proj, proj.x2d, proj.y2d).index_select(
            1, bins.gauss_id)
        comp = (rows, bins.tile_start, bins.tile_count, tx, ty)
        color4, t_final = composite.composite_fwd(*comp)
        g_c, g_tf = torch.randn_like(color4), torch.randn_like(t_final)
        ms = timed(lambda: composite.composite_bwd(*comp, g_c, g_tf, color4,
                                                   t_final), device, 10)
    return ms, bins.n_instances


def hybrid_mcmc_stages(state, cfg, cam, device) -> dict:
    """The hybrid and MCMC stages of a TrainState `state` on the card, each
    alone (ms): the specular colour seen from `cam` forward
    (`specular_fwd_alone`, CUDA events, median of 5) and with its backward
    to xyz, asg and the MLP (`specular_fwd_bwd_alone`; `specular_bwd_alone`
    the difference) when hybrid; one `mcmc_step` (host clock to a
    synchronise: it reads the counts) and `mcmc_noise_step` (median of 5)
    with `--mcmc`. Both MCMC steps change the state, as in training."""
    from ..train.loop import extra_color, mcmc_noise_step, mcmc_step

    out = {}
    if state.spec is not None:
        leaves = [state.g.xyz, state.g.asg,
                  *state.spec.named_tensors().values()]

        def spec():
            return extra_color(state, cam)

        with torch.no_grad():
            out["specular_fwd_alone"] = timed(spec, device, 5)
        out["specular_fwd_bwd_alone"] = timed(lambda: torch.autograd.grad(
            spec(), leaves, torch.ones((state.capacity, 3), device=device)),
            device, 5)
        out["specular_bwd_alone"] = (out["specular_fwd_bwd_alone"]
                                     - out["specular_fwd_alone"])
    if cfg.mcmc:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mcmc_step(state, cfg)
        torch.cuda.synchronize()
        out["mcmc_step"] = (time.perf_counter() - t0) * 1e3
        out["mcmc_noise_step"] = timed(lambda: mcmc_noise_step(state, cfg),
                                       device, 5)
    return out


def trace_calls(fn, trace_dir: str, reps: int = 1) -> dict:
    """`fn` run once as a warm-up and `reps` times under `torch.profiler`
    (CPU and CUDA), the Chrome trace written to `trace_dir/trace.json` and
    summarised (`cli/profile.summarize_trace`: device ms per kernel name,
    launches, device-busy ms and the span from the first kernel's start to
    the last one's end)."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from ..cli.profile import summarize_trace

    fn()
    torch.cuda.synchronize()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    return summarize_trace(path)


def print_busy(label: str, summary: dict, reps: int = 1, top: int = 8) -> None:
    busy, span = summary["busy_ms"], summary["span_ms"]
    print(f"{label}: device busy {busy / reps:.3f} ms of {span / reps:.3f} ms "
          f"a call ({100 * busy / max(span, 1e-9):.1f}%), "
          f"{summary['launches'] // reps} kernel launches a call; top kernels "
          "(ms a call): " + "; ".join(
              f"{ms / reps:.3f} {name[:60]}" for name, ms in sorted(
                  summary["kernel_ms"].items(), key=lambda kv: -kv[1])[:top]))


def stage_split(step, reps: int = 3) -> dict:
    """step() run `reps` times under a span listener that synchronises the
    card at every span boundary (`utils/spans.listening`): the last rep's
    host ms by span name, each span charged the time in which it was the
    innermost open one, summed over the spans of a name (a cubemap step's
    five renders); the time outside every span under "other"."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    stages, stack, last = {}, [], [0.0]

    def charge():
        sync()
        now = time.perf_counter()
        key = stack[-1] if stack else "other"
        stages[key] = stages.get(key, 0.0) + (now - last[0]) * 1e3
        last[0] = now

    def listen(name, event):
        charge()
        if event == "enter":
            stack.append(name)
        else:
            stack.pop()

    for _ in range(reps):
        stages.clear()
        sync()
        last[0] = time.perf_counter()
        with spans.listening(listen):
            step()
        charge()
    return stages


def _step_ms_and_peak(step):
    """5 calls of step() on the host clock, each ended by a synchronise, and
    the peak memory they reached (GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return step_ms, torch.cuda.max_memory_allocated() / 2**30


def fisheye_step_stages(trainer, fish_gt, device, trace_dir: str) -> dict:
    """Where a fisheye training step of a CalibTrainer's state on camera 0
    goes, on the card, at SH degree 0 (a training step before the first
    SH ramp): `fisheye_train_step` split by its spans (`stage_split`:
    `STEP_STAGES` and "lens"); then, timed apart with CUDA events, the
    backward kernel, the lens flow (alone and with its backward), and its
    pieces with their backwards: the Newton inverse of the control points,
    the upsampling of the control flow and the warp with the crop, and
    `hybrid_mcmc_stages`; a profiler trace of one step (device-busy share,
    kernels by time, the spans); 5 whole steps (host clock) and the peak
    memory. Prints them and returns
    {"stages_ms", "step_ms", "peak_gib", "instances", "trace"}."""
    from ..calib.distortion import compute_flow
    from ..calib.iresnet import iresnet_forward
    from ..train.calibrated import fisheye_train_step
    from ..utils.image import center_crop_resample, grid_sample, resize_bilinear

    setup, cfg = trainer.setup, trainer.cfg
    idx, sh_degree = 0, 0
    rcfg = RenderConfig(sh_degree=sh_degree)
    opt_lens, use_vig = trainer.lens_window(1)

    def step():
        return fisheye_train_step(trainer.state, fish_gt, trainer.p_view, idx,
                                  trainer.bg, setup, rcfg, cfg,
                                  trainer.schedules, opt_lens, use_vig)

    stages = stage_split(step)
    base = trainer.base
    cam = base.cams[idx]
    stages["backward_kernel"], instances = backward_kernel_ms(
        base, cam, setup.render_static, sh_degree, device)
    stages["backward_rest"] = stages["backward"] - stages["backward_kernel"]

    lens, p_view = trainer.state.lens, trainer.p_view
    apply2gt = cfg.calib.apply2gt
    ps = torch.stack([1.0 / torch.tan(cam.fovx * 0.5),
                      1.0 / torch.tan(cam.fovy * 0.5)])
    params = lens.parameters()

    def with_grad(f, leaves):
        out = f()
        torch.autograd.grad(out, leaves, torch.ones_like(out))

    def flow():
        return compute_flow(lens, p_view, setup.grid_hw, ps, setup.flow_hw,
                            sensor_to_frustum=apply2gt)

    def inverse():
        return iresnet_forward(lens, p_view, sensor_to_frustum=apply2gt)

    ctrl = inverse().detach().reshape(*setup.grid_hw, 2).permute(2, 0, 1)
    ctrl = ctrl.contiguous().requires_grad_(True)
    image = (fish_gt if apply2gt else torch.rand(
        (3, setup.render_static.height, setup.render_static.width),
        device=device)).requires_grad_(True)
    fl = flow().detach().requires_grad_(True)

    def warp():
        w = grid_sample(image, fl)
        return w if apply2gt else center_crop_resample(w, *setup.fish_hw)

    with torch.no_grad():
        stages["lens_flow_alone"] = timed(flow, device, 5)
        stages["lens_inverse_alone"] = timed(inverse, device, 5)
    stages["lens_flow_fwd_bwd_alone"] = timed(lambda: with_grad(flow, params),
                                              device, 5)
    stages["lens_inverse_fwd_bwd_alone"] = timed(
        lambda: with_grad(inverse, params), device, 5)
    stages["flow_upsample_fwd_bwd_alone"] = timed(lambda: with_grad(
        lambda: resize_bilinear(ctrl, setup.flow_hw), [ctrl]), device, 5)
    stages["warp_crop_fwd_bwd_alone"] = timed(lambda: with_grad(
        warp, [image, fl]), device, 5)
    stages.update(hybrid_mcmc_stages(base, cfg, cam, device))

    summary = trace_calls(step, trace_dir)
    print_busy("fisheye step trace", summary)
    step_ms, peak = _step_ms_and_peak(step)
    print("fisheye step stages_ms " + json.dumps(
        {k: round(v, 3) for k, v in stages.items()}))
    print(f"fisheye step (SH {sh_degree}): {instances} instances at "
          f"{setup.render_static.width}x{setup.render_static.height}, "
          f"{int(base.alive.sum())} live of {base.capacity}, control grid "
          f"{setup.grid_hw}, flow {setup.flow_hw}; step_ms "
          + " ".join(f"{x:.2f}" for x in step_ms) + f"; peak memory {peak:.2f} GiB")
    return {"stages_ms": stages, "step_ms": step_ms, "peak_gib": peak,
            "instances": instances, "trace": summary}


def cubemap_step_stages(trainer, gt, device, trace_dir: str) -> dict:
    """Where a cubemap training step of a CalibTrainer's state on camera 0
    against `gt` goes, on the card, at SH degree 0 (a training step before
    the first SH ramp): `cubemap_train_step` split by its spans
    (`stage_split`: `STEP_STAGES`, each summed over the five renders, and
    "lens", the ray field and the five warps); then, timed apart with CUDA events, the backward kernel on each face's
    render (their sum `backward_kernel`), the ray field (the cubemap net
    on the control grid and the upsampling) alone and with its backward,
    and the five warps with their backward; a profiler trace of one step
    (device-busy share, launches, kernels by time); 5 whole steps (host
    clock) and the peak memory. Prints them and returns {"stages_ms",
    "step_ms", "peak_gib", "instances", "trace"}."""
    from ..calib import cubemap
    from ..train.calibrated import cubemap_train_step, face_cameras

    setup, cfg = trainer.setup, trainer.cfg
    idx, sh_degree = 0, 0
    rcfg = RenderConfig(sh_degree=sh_degree)
    sub_q, sub_t = trainer.sub_q[idx], trainer.sub_t[idx]

    def step():
        return cubemap_train_step(trainer.state, gt, idx, trainer.bg, sub_q,
                                  sub_t, setup, rcfg, cfg, trainer.schedules)

    stages = stage_split(step)
    base = trainer.base
    static = setup.static
    instances, bwd_ms, face_renders = [], 0.0, []
    for c in face_cameras(base.cams[idx], sub_q, sub_t):
        ms, n = backward_kernel_ms(base, c, static, sh_degree, device,
                                   sort_by_distance=True)
        bwd_ms += ms
        instances.append(n)
        face_renders.append(torch.rand((3, static.height, static.width),
                                       device=device))
    stages["backward_kernel"] = bwd_ms
    stages["backward_rest"] = stages["backward"] - bwd_ms

    net = trainer.state.cubemap_net
    params = net.parameters()
    renders = [r.requires_grad_(True) for r in face_renders]

    def with_grad(f, leaves):
        out = f()
        outs = out if isinstance(out, list) else [out]
        torch.autograd.grad(outs, leaves, [torch.ones_like(o) for o in outs])

    def rays():
        return cubemap.distorted_rays(net, setup.K, static.width,
                                      static.height, setup.scale)

    fixed = rays().detach()

    def warps():
        return [cubemap.warp_to_face(setup.K, fixed, r * setup.mask90, face,
                                     static.height, static.width)
                for r, face in zip(renders, cubemap.FACES)]

    with torch.no_grad():
        stages["ray_field_alone"] = timed(rays, device, 5)
    stages["ray_field_fwd_bwd_alone"] = timed(lambda: with_grad(rays, params),
                                              device, 5)
    stages["warps_fwd_bwd_alone"] = timed(lambda: with_grad(warps, renders),
                                          device, 5)

    summary = trace_calls(step, trace_dir)
    print_busy("cubemap step trace", summary)
    step_ms, peak = _step_ms_and_peak(step)
    print("cubemap step stages_ms " + json.dumps(
        {k: round(v, 3) for k, v in stages.items()}))
    print(f"cubemap step (SH {sh_degree}): instances per face "
          f"{dict(zip(cubemap.FACES, instances))} at {static.width}x"
          f"{static.height}, {int(base.alive.sum())} live of {base.capacity}; "
          "step_ms " + " ".join(f"{x:.2f}" for x in step_ms)
          + f"; peak memory {peak:.2f} GiB")
    return {"stages_ms": stages, "step_ms": step_ms, "peak_gib": peak,
            "instances": instances, "trace": summary}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--size", type=int, default=800)
    p.add_argument("--max_instances", type=int, default=2 ** 20)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return stage_times(args.n, args.size, args.max_instances, args.device)


if __name__ == "__main__":
    main()
