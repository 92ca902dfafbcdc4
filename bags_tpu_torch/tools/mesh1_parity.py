"""Mesh-1 parity (port of `tools/mesh1_parity.py`): `ShardedTrainer` at a
world size of one against the plain `Trainer`, step for step, from the same
population and seed.

    python -m bags_tpu_torch.tools.mesh1_parity [--steps 4] [--device cpu]

On the card the sharded trainer runs over NCCL and calls every collective
of the multi-GPU path (the packet all-gather and its reduce-scatter, the
gradient and loss all-reduces), and both compositing kernels render the
slab: the check that the sharded path runs on the hardware where only one
card is available. The toy is the JAX tool's: 96 points in a 128-slot
population (SH 1), two identity cameras at FoV 0.8, a 64x48 constant GT
of 0.4, `--opt_cam`. Prints both loss curves and the largest xyz
difference and asserts the losses within 5e-4 (the JAX tool's tolerance);
returns {"plain": [...], "mesh1": [...], "max_loss_diff", "max_xyz_diff"}.
The process group is started here unless one exists (a world of one).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

TOL = 5e-4


def _trainer(cls, device, mesh: int):
    from ..core.camera import CameraParams, CameraStatic
    from ..model.gaussians import create_from_points
    from ..train.config import CalibConfig, TrainConfig

    static = CameraStatic(width=64, height=48)
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-1, 1, 96), rng.uniform(-1, 1, 96),
                    rng.uniform(4, 8, 96)], -1).astype(np.float32)
    cols = rng.uniform(0, 1, (96, 3)).astype(np.float32)
    g, alive = create_from_points(pts, cols, 128, sh_degree=1, device=device)
    cams = CameraParams.stack([CameraParams.create(
        np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 0.8, 0.8,
        device=device) for _ in range(2)])
    cfg = TrainConfig(calib=CalibConfig(opt_cam=True), mesh=mesh)
    cfg.model.sh_degree = 1
    gt = torch.full((2, 3, 48, 64), 0.4, device=device)
    return cls(g, alive, cams, static, cfg, scene_extent=8.0, gt_images=gt,
               seed=0)


def main(argv=None) -> dict:
    import torch.distributed as dist

    from ..dist.trainer import ShardedTrainer, init_distributed
    from ..train.loop import Trainer
    from ..utils.device import resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device, started = init_distributed(resolve_device(args.device), 1)
    try:
        plain = _trainer(Trainer, device, 0)
        mesh1 = _trainer(ShardedTrainer, device, 1)
        l1 = np.array([h[1] for h in plain.run(args.steps, log_every=1)])
        l2 = np.array([h[1] for h in mesh1.run(args.steps, log_every=1)])
        dx = float(torch.max(torch.abs(plain.state.g.xyz.detach()
                                       - mesh1.state.g.xyz.detach())))
    finally:
        if started:
            dist.destroy_process_group()
    out = {"plain": l1.tolist(), "mesh1": l2.tolist(),
           "max_loss_diff": float(np.abs(l1 - l2).max()), "max_xyz_diff": dx}
    print("plain  losses:", np.round(l1, 6))
    print("mesh-1 losses:", np.round(l2, 6))
    if not np.allclose(l1, l2, atol=TOL):
        raise AssertionError(f"mesh-1 sharded != unsharded: {out}")
    print(f"MESH-1 PARITY OK (max loss delta {out['max_loss_diff']:.2e}, "
          f"max xyz delta {dx:.2e})")
    return out


if __name__ == "__main__":
    main()
