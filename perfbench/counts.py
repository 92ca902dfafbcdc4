"""The benchmark's yardstick of work: the H100's published peaks, the
compositing kernels' operation and byte counts, and the least time the card
could take for a training step or a view.

The kernel arithmetic is a frozen copy of `bags_tpu_torch/utils/profiling.py`
(`OPS_*`, `footprint`, `pair_counts`, `fwd_ops`, `bwd_ops`, `fwd_bytes`,
`bwd_bytes`, `bound`) as it stood when the benchmark was defined, so that a
kernel built another way later is held to the same work. It imports nothing
of the program: the pairs are counted on the benchmark's own reference
projection and binning (`reference/render.py`).

`step_terms` and `view_terms` list the pieces of work a pose or fisheye
training step and a rendered view need, each as (FP32 operations, bytes),
counted from the cell's inputs: the live Gaussians (never the capacity),
the image and loss sizes, the pixel-instance pairs of the reference
binning, the lens net's products at its widths and Adam's reads and
writes of the live parameters. Each byte is counted once: a piece that
could run fused with its neighbour is charged only what it must read from
or write to memory. `least_seconds` sums, over the pieces, the larger of
operations over 67 TFLOP/s and bytes over 3.35 TB/s.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, FP32 (non-tensor) FLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

# --- frozen copy of utils/profiling.py's kernel arithmetic -----------------
TILE_W = TILE_H = 16
NPIX = 256
ALPHA_MIN, ALPHA_MAX, T_EPS = 1.0 / 255.0, 0.99, 1e-4
R_MX, R_MY, R_CA, R_CB, R_CC, R_O = range(6)
OPS_VISITED, OPS_EXP, OPS_ALPHA, OPS_COMPOSITED = 12, 4, 3, 9
OPS_BWD_INCLUDED = 1 + 36 + 6 + 1 + 1 + 18 + 10
P_MIN_MARGIN, FOOTPRINT_K = 1e-3, 2.04


class Pairs(NamedTuple):
    visited: int
    power_le_0: int
    alpha_pass: int
    included: int
    in_footprint: int
    exp_needed: int


def footprint(f):
    """Per instance of rows f: (p_min, ex, ey), the box outside which a
    pair fails the alpha test for certain."""
    a, b, c, o = f[R_CA], f[R_CB], f[R_CC], f[R_O]
    p_min = torch.log(ALPHA_MIN / o) - P_MIN_MARGIN
    det = a * c - b * b
    k = -FOOTPRINT_K * p_min
    ex = torch.sqrt(k * c / det) * 1.001 + 1e-3
    ey = torch.sqrt(k * a / det) * 1.001 + 1e-3
    everywhere = ~((a > 0) & (c > 0) & (det > 1e-3 * a * c) & (a < 1e18)
                   & (c < 1e18) & (f[R_MX].abs() < 1e9)
                   & (f[R_MY].abs() < 1e9)) | torch.isnan(p_min)
    inf = torch.full_like(ex, float("inf"))
    ex, ey = (torch.where(p_min > 0, -1.0, torch.where(everywhere, inf, e))
              for e in (ex, ey))
    return p_min, ex, ey


def _tile_pixels(tiles_x, tiles_y, device):
    t = torch.arange(tiles_x * tiles_y, device=device)
    off = torch.arange(NPIX, device=device)
    px = ((t % tiles_x) * TILE_W)[:, None] + (off % TILE_W)[None, :]
    py = ((t // tiles_x) * TILE_H)[:, None] + (off // TILE_W)[None, :]
    return px.float(), py.float()


@torch.no_grad()
def pair_counts(rows, tile_start, tile_count, tiles_x, tiles_y, chunk=32) -> Pairs:
    """Pixel-instance pairs the compositing visits (each pixel up to and
    including the instance that ends it), and of those the ones it needs."""
    px, py = _tile_pixels(tiles_x, tiles_y, rows.device)
    start, count = tile_start.long(), tile_count.long()
    t_run = torch.ones_like(px)
    done = torch.zeros_like(px, dtype=torch.bool)
    offs = torch.arange(chunk, device=rows.device)
    counts = [0] * len(Pairs._fields)
    for k in range(0, int(count.max()) if count.numel() else 0, chunk):
        act = torch.nonzero((count > k) & ~done.all(dim=1)).squeeze(1)
        if act.numel() == 0:
            break
        in_range = (k + offs)[None, :] < count[act, None]
        f = rows[:, torch.where(in_range, start[act, None] + k + offs, 0)]
        dx = px[act][:, None, :] - f[0][..., None]
        dy = py[act][:, None, :] - f[1][..., None]
        power = -0.5 * (f[2][..., None] * dx * dx + f[4][..., None] * dy * dy) \
            - f[3][..., None] * dx * dy
        alpha = torch.clamp(f[5][..., None] * torch.exp(power), max=ALPHA_MAX)
        ok = (alpha >= ALPHA_MIN) & (power <= 0) & in_range[..., None]
        a = torch.where(ok, alpha, 0.0)
        cp = torch.cumprod(1.0 - a, dim=1)
        t_before = t_run[act][:, None, :] * torch.cat(
            [torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        kill = ok & (t_before * (1.0 - a) < T_EPS)
        killed_before = (torch.cumsum(kill.int(), dim=1) - kill.int()) > 0
        visited = in_range[..., None] & ~killed_before & ~done[act][:, None, :]
        inc = visited & ok & ~kill
        p_min, ex, ey = (x[..., None] for x in footprint(f))
        in_box = (dx.abs() <= ex) & (dy.abs() <= ey)
        needs_exp = (power <= 0) & ~(power < p_min)
        for i, m in enumerate((visited, visited & (power <= 0), visited & ok, inc,
                               visited & in_box, visited & needs_exp)):
            counts[i] += int(m.sum())
        t_run[act] = t_run[act] * torch.where(inc, 1.0 - a, 1.0).prod(dim=1)
        done[act] |= (kill & visited).any(dim=1)
    return Pairs(*counts)


def fwd_ops(p: Pairs) -> int:
    return (OPS_VISITED * p.in_footprint + OPS_EXP * p.exp_needed
            + OPS_ALPHA * p.alpha_pass + OPS_COMPOSITED * p.included)


def bwd_ops(p: Pairs) -> int:
    return (OPS_VISITED * p.in_footprint + OPS_EXP * p.exp_needed
            + OPS_ALPHA * p.alpha_pass + OPS_BWD_INCLUDED * p.included)


def fwd_bytes(n_instances: int, num_tiles: int) -> int:
    return 10 * 4 * n_instances + 2 * 4 * num_tiles + 5 * 4 * 256 * num_tiles


def bwd_bytes(n_instances: int, num_tiles: int) -> int:
    return 2 * 10 * 4 * n_instances + 2 * 4 * num_tiles + 10 * 4 * 256 * num_tiles


def bound(n_bytes, n_ops) -> Tuple[float, str]:
    """(least ms, what bounds it) on the published peaks."""
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_FP32_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")
# --- end of the frozen copy -------------------------------------------------

# Floats a live Gaussian holds at SH 3: position 3, scales 3, rotation 4,
# opacity 1, SH 16 x 3; and the 10 floats of its screen-space packet.
PARAM_FLOATS = 3 + 3 + 4 + 1 + 48
PACKET_FLOATS = 10
# FP32 operations of one Gaussian's projection and SH-3 colour (rotation
# and covariance 60, EWA projection and conic 60, radius and rectangle 30,
# the SH basis 30 and its 16 x 3 products 96), of their backward (twice
# the forward) and of Adam's update of one parameter (moments 6, bias
# corrections and step 6).
OPS_PROJECT, OPS_PROJECT_BWD, OPS_ADAM = 276, 552, 12
# SSIM over an 11 x 11 separable window: 5 maps x 2 passes x 11 taps x 2
# operations a pixel and channel, the map itself 30; its backward twice that.
OPS_SSIM_PX = 5 * 2 * 11 * 2 + 30
# The lens net: 5 blocks of 2 -> 512 x 4 -> 2, 12 Newton iterations.
LENS_DIMS = (2, 512, 512, 512, 512, 2)
LENS_BLOCKS, LENS_NEWTON = 5, 12


def lens_eval_ops() -> int:
    """One point's residual and 2x2 Jacobian sweep through one block: each
    layer's product for the values and the two tangents (the first layer's
    tangents are its weight rows), ELU and its derivative."""
    ops = 0
    for i, (a, b) in enumerate(zip(LENS_DIMS[:-1], LENS_DIMS[1:])):
        ops += 2 * a * b * (1 if i == 0 else 3) + 6 * b
    return ops


def lens_terms(n_points: int, trained: bool) -> Dict[str, Tuple[int, int]]:
    """The lens net's Newton inverse at the control points, and with
    `trained` its backward: per block the Jacobian at the solution and one
    forward and backward sweep of the residual (three times the forward's
    products)."""
    fwd = LENS_BLOCKS * LENS_NEWTON * n_points * lens_eval_ops()
    terms = {"lens_inverse": (fwd, 0)}
    if trained:
        mlp = sum(2 * a * b for a, b in zip(LENS_DIMS[:-1], LENS_DIMS[1:]))
        terms["lens_backward"] = (LENS_BLOCKS * n_points * (lens_eval_ops() + 3 * mlp), 0)
    return terms


def view_terms(n_live: int, pairs: Pairs, n_instances: int, num_tiles: int
               ) -> Dict[str, Tuple[int, int]]:
    """A rendered view: projection and SH of the live Gaussians (their
    parameters read, their packets written), binning (a key and an id
    written per instance, a range per tile), the forward compositing."""
    return {
        "projection": (OPS_PROJECT * n_live,
                       4 * (PARAM_FLOATS + PACKET_FLOATS) * n_live),
        "binning": (0, 12 * n_instances + 8 * num_tiles),
        "composite_fwd": (fwd_ops(pairs), fwd_bytes(n_instances, num_tiles)),
    }


def step_terms(n_live: int, pairs: Pairs, n_instances: int, num_tiles: int,
               width: int, height: int, lens_points: int = 0,
               lens_trained: bool = False) -> Dict[str, Tuple[int, int]]:
    """A training step: the view's pieces, the loss and its gradient over
    the image (the render and the GT read, the image gradient written), the
    compositing backward, the projection backward fused with Adam (per live
    parameter: the parameter, both moments read and written, the packet
    gradients read) and, in the fisheye mode, the lens net and the warp
    (the render read and the fisheye image written, and the same again in
    the backward)."""
    px = width * height
    terms = view_terms(n_live, pairs, n_instances, num_tiles)
    terms["loss"] = (3 * px * 3 * OPS_SSIM_PX, 3 * 4 * 3 * px)
    terms["composite_bwd"] = (bwd_ops(pairs), bwd_bytes(n_instances, num_tiles))
    terms["projection_bwd_adam"] = (
        (OPS_PROJECT_BWD + OPS_ADAM * PARAM_FLOATS) * n_live,
        4 * (6 * PARAM_FLOATS + PACKET_FLOATS) * n_live)
    if lens_points:
        terms.update(lens_terms(lens_points, lens_trained))
        terms["warp"] = (2 * 3 * px * 16, 2 * 2 * 3 * 4 * px)
    return terms


def least_seconds(terms: Dict[str, Tuple[int, int]]) -> float:
    """Sum over the pieces of max(operations / peak, bytes / peak)."""
    return sum(max(o / PEAK_FP32_PER_S, b / PEAK_BYTES_PER_S)
               for o, b in terms.values())
