"""Benchmark of the port: forward + backward rasterisation throughput
(pixels/s on one card). Port of the root `bench.py`.

    python -m bags_tpu_torch.cli.bench [--large]

Prints the workload's instance count, then ONE JSON line: {"metric",
"value", "unit", "vs_baseline", "precision"}.

Workload: the JAX bench's toy scene (`utils/testing.make_toy_scene`, the
same numbers), 100,000 Gaussians at 800x800, scales (0.008, 0.035), SH
degree 3, seed 0; `--large` is BASELINE config 4's scale, 1,000,000
Gaussians at 1600x1080, scales (0.0025, 0.011). A timed step renders,
takes `photometric_loss` against a zero GT and the gradients of every
Gaussian field and every camera field: one warm-up, then 20 steps on the
host clock ending in `torch.cuda.synchronize()`.

The port composites in float32 alone: the JAX bench's `fast` and `exact2`
lines measure its bf16 split-term ladder, which the port does not have
(ROADMAP "Not ported"), so only the exact line is printed and `precision`
is "exact". `BAGS_TPU_BENCH_BATCH=K` > 1 times K views a step (the JAX
bench's camera batch, bench.py:44-60): the workload's camera with dt moved
by 1e-3 k for view k, the mean of the K losses, the gradients of the
Gaussians and of every view's camera fields; pixels/s counts K x H x W.

vs_baseline: the reference publishes no numbers (BASELINE.md), so the
baseline constant is the throughput a stock CUDA 3DGS forward + backward
reaches on an RTX 4090-class GPU (about 25 training iterations/s at
800x800, about 1.6e7 pixels/s), the hardware class the reference README
targets.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import torch

BASELINE_PIXELS_PER_S = 1.6e7
ITERS = 20

# name -> (Gaussians, width, height, scale range, metric)
WORKLOADS = {
    "default": (100_000, 800, 800, (0.008, 0.035), "pixels_per_s_fwd_bwd"),
    "large": (1_000_000, 1600, 1080, (0.0025, 0.011),
              "pixels_per_s_fwd_bwd_large"),
}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(large: bool = False, batch_cams: int = 1, device=None,
         n: int = None, width: int = None, height: int = None,
         iters: int = ITERS) -> dict:
    """Run the benchmark (n, width and height shrink the workload for
    tests); prints and returns the JSON line's dict."""
    from ..raster.render import RenderConfig, render
    from ..train.losses import photometric_loss
    from ..utils.device import resolve_device
    from ..utils.testing import make_toy_scene

    device = resolve_device(device)
    n0, w0, h0, scale_range, metric = WORKLOADS["large" if large else "default"]
    width, height = width or w0, height or h0
    sc = make_toy_scene(n=n or n0, width=width, height=height, sh_degree=3,
                        seed=0, scale_range=scale_range, device=device)
    gauss = [sc[k].requires_grad_(True)
             for k in ("xyz", "scales", "quats", "opacity", "sh_coeffs")]
    cams = [sc["cam"]] + [dataclasses.replace(sc["cam"], dt=sc["cam"].dt + 1e-3 * k)
                          for k in range(1, batch_cams)]
    cam_leaves = [getattr(cam, f).requires_grad_(True) for cam in cams
                  for f in ("q_init", "t_init", "dq", "dt", "fovx", "fovy")]
    cfg = RenderConfig(sh_degree=3)
    gt = torch.zeros((3, height, width), device=device)

    def step():
        outs = [render(*gauss, cam, sc["static"], cfg) for cam in cams]
        losses = [photometric_loss(out.render, gt) for out in outs]
        loss = losses[0] if len(losses) == 1 else torch.stack(losses).mean()
        torch.autograd.grad(loss, gauss + cam_leaves)
        return outs[0]

    out = step()                                   # warm-up
    print(f"instances {out.gauss_id.numel()}")
    del out
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    sync(device)
    pixels_per_s = batch_cams * width * height * iters / (
        time.perf_counter() - t0)
    line = {
        "metric": metric,
        "value": round(pixels_per_s, 1),
        "unit": "pixels/s/chip",
        "vs_baseline": round(pixels_per_s / BASELINE_PIXELS_PER_S, 4),
        "precision": "exact",
    }
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main(large="--large" in sys.argv,
         batch_cams=int(os.environ.get("BAGS_TPU_BENCH_BATCH", "1")))
