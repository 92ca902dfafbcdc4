"""Tile binning (port of `bags_tpu/raster/binning.py`): depth-sorted
per-tile instance lists with dynamic sizes.

Each Gaussian is duplicated once per 16x16 tile its opacity-aware rect
covers; the instances are sorted by (tile, depth rank) with ONE stable sort
of an int64 key tile_id * (N + 1) + rank, so within a tile they stay in
depth order. Per-tile ranges come from a bincount of the sorted tile ids.
No static instance budget: `max_instances`, when given, keeps the nearest
whole Gaussians up to the budget and reports the rest in `n_dropped`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.projection import Projected
from .tiles import TILE_H, TILE_W


@dataclasses.dataclass
class TileBins:
    gauss_id: torch.Tensor    # (M,) int64 slot -> Gaussian, tile-major, depth order within
    tile_start: torch.Tensor  # (T,) int32 first slot of each tile
    tile_count: torch.Tensor  # (T,) int32 instances per tile
    n_instances: int          # M
    n_dropped: int            # instances past the budget (0 with no budget)


def compute_tile_rects(x2d, y2d, radius_x, radius_y, tiles_x: int, tiles_y: int):
    """Per-Gaussian covered tile rectangle with per-axis extents:
    [floor((p - r) / 16), floor((p + r) / 16) + 1) clamped to the grid.
    Returns x0, y0, nx (>= 1) and the tile count (0 for culled)."""
    rx = radius_x.to(x2d.dtype)
    ry = radius_y.to(y2d.dtype)
    x0 = torch.clamp(torch.floor((x2d - rx) / TILE_W), 0, tiles_x).to(torch.int64)
    y0 = torch.clamp(torch.floor((y2d - ry) / TILE_H), 0, tiles_y).to(torch.int64)
    x1 = torch.clamp(torch.floor((x2d + rx) / TILE_W) + 1, 0, tiles_x).to(torch.int64)
    y1 = torch.clamp(torch.floor((y2d + ry) / TILE_H) + 1, 0, tiles_y).to(torch.int64)
    alive = (radius_x > 0) & (radius_y > 0)
    nx = torch.where(alive, x1 - x0, 0)
    ny = torch.where(alive, y1 - y0, 0)
    ntiles = torch.clamp(nx, min=0) * torch.clamp(ny, min=0)
    return x0, y0, torch.clamp(nx, min=1), ntiles


@torch.no_grad()
def bin_gaussians(proj: Projected, tiles_x: int, tiles_y: int,
                  max_instances: Optional[int] = None,
                  sort_key_depth: Optional[torch.Tensor] = None) -> TileBins:
    """Build depth-sorted per-tile instance lists.

    sort_key_depth: optional override of the depth sort key (camera
    distance for the cubemap variant).
    """
    device = proj.x2d.device
    n = proj.x2d.shape[0]
    num_tiles = tiles_x * tiles_y
    x0, y0, nx, ntiles = compute_tile_rects(
        proj.x2d, proj.y2d, proj.rect_rx, proj.rect_ry, tiles_x, tiles_y)

    # --- depth rank: stable sort, culled Gaussians last at +inf ----------
    depth_src = proj.depth if sort_key_depth is None else sort_key_depth
    dkey = torch.where(ntiles > 0, depth_src.to(torch.float32),
                       torch.full_like(depth_src, float("inf"),
                                       dtype=torch.float32))
    depth_order = torch.sort(dkey, stable=True).indices           # rank -> id
    seg_len = ntiles[depth_order]

    # --- budget: keep the nearest whole Gaussians -------------------------
    n_dropped = 0
    if max_instances is not None:
        cum = torch.cumsum(seg_len, 0)
        total_all = int(cum[-1]) if n else 0
        n_dropped = max(total_all - max_instances, 0)
        seg_len = torch.where(cum <= max_instances, seg_len, 0)

    # --- expand: one slot per (Gaussian, covered tile), rank-major --------
    rank = torch.repeat_interleave(torch.arange(n, device=device), seg_len)
    m = rank.shape[0]
    seg_off = torch.cumsum(seg_len, 0) - seg_len
    local = torch.arange(m, device=device) - seg_off[rank]
    g = depth_order[rank]
    nx_s = nx[g]
    tile_id = (y0[g] + local // nx_s) * tiles_x + x0[g] + local % nx_s

    # --- sort by (tile, rank): ties impossible, rank order within tile ----
    key = torch.sort(tile_id * (n + 1) + rank, stable=True).values
    tile_sorted = key // (n + 1)
    gauss_id = depth_order[key % (n + 1)]
    tile_count = torch.bincount(tile_sorted, minlength=num_tiles)
    tile_start = torch.cumsum(tile_count, 0) - tile_count
    return TileBins(gauss_id=gauss_id,
                    tile_start=tile_start.to(torch.int32),
                    tile_count=tile_count.to(torch.int32),
                    n_instances=m, n_dropped=n_dropped)

