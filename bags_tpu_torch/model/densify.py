"""Adaptive density control (port of `bags_tpu/model/densify.py`).

Clone, split, prune and the opacity reset, with the reference's thresholds,
on the JAX package's fixed-capacity population: the parameters keep their
capacity C and an `alive` mask says which rows are Gaussians. Clone and
split copy selected rows into dead slots by the same rank pairing (the i-th
selected slot goes to the i-th dead slot, both in slot order), so both
packages write the same slots. The parameter tensors are updated in place
(they are the optimizer's leaves); the functions return a `reset_mask` of
the slots whose Adam moments the caller zeroes (`zero_moments_at`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..core.lie import quat_to_rotmat
from .gaussians import Gaussians


@dataclasses.dataclass
class DensifyStats:
    """Screen-space gradient accumulators (`gaussian_model.py:449-455`)."""

    grad_accum: torch.Tensor      # (C,) sum ||d mean2d|| (signed-sum channel)
    grad_accum_abs: torch.Tensor  # (C,) sum ||d mean2d_abs|| (abs channel)
    denom: torch.Tensor           # (C,) visible-step counts
    max_radii2d: torch.Tensor     # (C,) running max screen radius

    @staticmethod
    def zeros(capacity: int, device=None) -> "DensifyStats":
        return DensifyStats(*(torch.zeros(capacity, device=device)
                              for _ in range(4)))


def update_stats(stats: DensifyStats, probe_grad: torch.Tensor,
                 probe_grad_abs: Optional[torch.Tensor], radii: torch.Tensor,
                 visibility: torch.Tensor) -> DensifyStats:
    """Accumulate one step's statistics for the visible Gaussians."""
    vis = visibility
    zero = torch.zeros((), device=vis.device)
    norm = torch.linalg.norm(probe_grad[:, :2], dim=-1)
    norm_abs = (torch.linalg.norm(probe_grad_abs[:, :2], dim=-1)
                if probe_grad_abs is not None else norm)
    return DensifyStats(
        grad_accum=stats.grad_accum + torch.where(vis, norm, zero),
        grad_accum_abs=stats.grad_accum_abs + torch.where(vis, norm_abs, zero),
        denom=stats.denom + vis.to(torch.float32),
        max_radii2d=torch.maximum(
            stats.max_radii2d, torch.where(vis, radii.to(torch.float32), zero)),
    )


class DensifyResult(NamedTuple):
    alive: torch.Tensor
    reset_mask: torch.Tensor  # (C,) slots whose Adam moments must be zeroed
    n_cloned: int
    n_split: int
    n_pruned: int


def _rank_pair(sel: torch.Tensor, dead: torch.Tensor):
    """The i-th selected slot and the i-th dead slot, for the first
    min(#sel, #dead) pairs: (src, dst) index tensors."""
    src = torch.argsort((~sel).to(torch.uint8), stable=True)
    dst = torch.argsort((~dead).to(torch.uint8), stable=True)
    k = min(int(sel.sum()), int(dead.sum()))
    return src[:k], dst[:k]


def _copy_rows(g: Gaussians, src, dst, overrides: dict) -> None:
    """Row src -> dst across every field that is set (`asg` with --hybrid),
    with per-field overrides (values already in src order)."""
    for name, arr in g.fields().items():
        arr[dst] = overrides[name] if name in overrides else arr[src]


@torch.no_grad()
def densify_and_clone(g: Gaussians, alive, grads, grad_threshold,
                      percent_dense, scene_extent):
    """Small, under-reconstructed Gaussians are duplicated into dead slots
    (`densify_and_clone`, gaussian_model.py:418-431). Returns (alive,
    written mask, count)."""
    max_scale = torch.exp(g.scales_log).amax(dim=-1)
    sel = alive & (grads >= grad_threshold) & \
        (max_scale <= percent_dense * scene_extent)
    src, dst = _rank_pair(sel, ~alive)
    _copy_rows(g, src, dst, {})
    written = torch.zeros_like(alive)
    written[dst] = True
    return alive | written, written, int(dst.numel())


@torch.no_grad()
def densify_and_split(g: Gaussians, alive, grads, grad_threshold,
                      percent_dense, scene_extent, gen: torch.Generator,
                      n_children: int = 2):
    """Large, over-reconstructed Gaussians are split into two children with
    scale / (0.8 N) and positions drawn from the parent
    (`densify_and_split`, gaussian_model.py:393-416): child 1 takes a dead
    slot, child 0 overwrites the parent. The offsets come from `gen`."""
    c = alive.shape[0]
    scales = torch.exp(g.scales_log)
    sel = alive & (grads >= grad_threshold) & \
        (scales.amax(dim=-1) > percent_dense * scene_extent)
    rot = quat_to_rotmat(g.quats)

    def child_values(idx):
        noise = torch.randn((idx.numel(), 3), generator=gen,
                            device=gen.device) * scales[idx]
        offset = torch.einsum("nij,nj->ni", rot[idx], noise)
        return {"xyz": g.xyz[idx] + offset,
                "scales_log": torch.log(torch.clamp(
                    scales[idx] / (0.8 * n_children), min=1e-10))}

    src, dst = _rank_pair(sel, ~alive)
    _copy_rows(g, src, dst, child_values(src))
    written = torch.zeros_like(alive)
    written[dst] = True
    alive = alive | written

    # Child 0 in place of every selected parent, also those whose sibling
    # found no dead slot (the reference prunes every selected parent).
    parents = torch.nonzero(sel).squeeze(1)
    vals0 = child_values(parents)
    g.xyz[parents] = vals0["xyz"]
    g.scales_log[parents] = vals0["scales_log"]
    return alive, written | sel, int(dst.numel())


@torch.no_grad()
def prune(g: Gaussians, alive, min_opacity, max_radii2d, max_screen_size,
          scene_extent):
    """Kill low-opacity and oversized Gaussians (gaussian_model.py:440-445);
    max_screen_size <= 0 disables the size tests."""
    mask = torch.sigmoid(g.opacity_raw) < min_opacity
    if max_screen_size > 0:
        big_vs = max_radii2d > max_screen_size
        big_ws = torch.exp(g.scales_log).amax(dim=-1) > 0.1 * scene_extent
        mask = mask | big_vs | big_ws
    pruned = alive & mask
    return alive & ~mask, pruned, int(pruned.sum())


def densify_and_prune(g: Gaussians, alive, stats: DensifyStats,
                      gen: torch.Generator, grad_threshold: float,
                      min_opacity: float, scene_extent: float,
                      max_screen_size: float, percent_dense: float = 0.01,
                      use_abs_grad: bool = False) -> DensifyResult:
    """Clone -> split -> prune from the accumulated screen-space gradient
    averages (`densify_and_prune`, gaussian_model.py:433-447). Updates `g`
    in place."""
    accum = stats.grad_accum_abs if use_abs_grad else stats.grad_accum
    grads = accum / torch.clamp(stats.denom, min=1.0)
    grads = torch.nan_to_num(grads, nan=0.0)

    alive, w1, n_cloned = densify_and_clone(
        g, alive, grads, grad_threshold, percent_dense, scene_extent)
    alive, w2, n_split = densify_and_split(
        g, alive, grads, grad_threshold, percent_dense, scene_extent, gen)
    alive, pruned, n_pruned = prune(g, alive, min_opacity, stats.max_radii2d,
                                    max_screen_size, scene_extent)
    return DensifyResult(alive, w1 | w2 | pruned, n_cloned, n_split, n_pruned)


@torch.no_grad()
def reset_opacity(g: Gaussians) -> None:
    """Clamp opacities to <= 0.01 in place (`reset_opacity`,
    gaussian_model.py:253-256). The caller zeroes the opacity moments."""
    x = torch.clamp(torch.sigmoid(g.opacity_raw), max=0.01)
    g.opacity_raw.copy_(torch.log(x / (1.0 - x)))


@torch.no_grad()
def zero_moments_at(opt: torch.optim.Optimizer, reset_mask: torch.Tensor) -> None:
    """Zero the Adam moments (`exp_avg`, `exp_avg_sq`) of the `reset_mask`
    rows of every parameter, in place: the fixed-capacity analogue of the
    reference's zero-initialised optimizer state for new rows. Step counts
    stay."""
    for group in opt.param_groups:
        for p in group["params"]:
            state = opt.state.get(p)
            if state and p.shape[:1] == reset_mask.shape:
                state["exp_avg"][reset_mask] = 0.0
                state["exp_avg_sq"][reset_mask] = 0.0
