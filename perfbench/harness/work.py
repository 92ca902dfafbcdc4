"""The work of one view or one training step, counted on the reference's
projection and binning of the live Gaussians (`counts.py`'s terms).

A population's dead slots are dropped first, so a program that carries
a capacity larger than its live count is held to the live count's work.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from counts import (bound, bwd_bytes, bwd_ops, fwd_bytes, fwd_ops, least_seconds,
                    pair_counts, step_terms, view_terms)
from reference import render as ref_render


def live(params: Dict[str, torch.Tensor], alive: Optional[torch.Tensor]):
    """The raw leaves of the live rows."""
    return params if alive is None else {k: v[alive] for k, v in params.items()}


@torch.no_grad()
def view_counts(params, R, t, fovx, fovy, width, height, sh_degree):
    """(pairs, instances, tiles) of one view of raw leaves `params`."""
    proj = ref_render.project(
        params["xyz"], torch.exp(params["scales_log"]), params["quats"],
        torch.sigmoid(params["opacity_raw"]),
        torch.cat([params["sh_dc"], params["sh_rest"]], dim=1), R, t, fovx, fovy,
        width, height, sh_degree)
    gid, start, count = ref_render.bin_tiles(proj, width, height)
    rows = torch.stack([proj[k] for k in ("mx", "my", "a", "b", "c", "opacity",
                                          "r", "g", "bl", "depth")])[:, gid]
    tx, ty = ref_render.tile_grid(width, height)
    return pair_counts(rows, start, count, tx, ty), int(gid.shape[0]), tx * ty


def step_work(params, alive, R, t, fovx, fovy, width, height, sh_degree,
              lens_points: int = 0, lens_trained: bool = False) -> Dict[str, float]:
    """A training step's least seconds and its kernels' least seconds."""
    p = live(params, alive)
    pairs, m, nt = view_counts(p, R, t, fovx, fovy, width, height, sh_degree)
    terms = step_terms(p["xyz"].shape[0], pairs, m, nt, width, height,
                       lens_points=lens_points, lens_trained=lens_trained)
    return dict(step=least_seconds(terms), terms=terms, instances=m,
                fwd=bound(fwd_bytes(m, nt), fwd_ops(pairs))[0] * 1e-3,
                bwd=bound(bwd_bytes(m, nt), bwd_ops(pairs))[0] * 1e-3)


def view_work(params, alive, R, t, fovx, fovy, width, height, sh_degree
              ) -> Dict[str, float]:
    """A rendered view's least seconds and its forward kernel's."""
    p = live(params, alive)
    pairs, m, nt = view_counts(p, R, t, fovx, fovy, width, height, sh_degree)
    terms = view_terms(p["xyz"].shape[0], pairs, m, nt)
    return dict(view=least_seconds(terms), terms=terms, instances=m,
                fwd=bound(fwd_bytes(m, nt), fwd_ops(pairs))[0] * 1e-3)
