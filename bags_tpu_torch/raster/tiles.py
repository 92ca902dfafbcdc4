"""Tile geometry, compositing constants and the plain tiled compositor
(port of `bags_tpu/raster/tiles.py`).

Pixel centres sit at integer coordinates (no +0.5), as in the reference
rasterizer. A tile is TILE_W x TILE_H = 16 x 16 pixels, flattened row-major
to NPIX = 256.

`composite_tiles_plain` is the plain PyTorch version of the forward
compositing kernel (`raster/composite.py`, `csrc/composite_fwd.cu`): same
inputs, same outputs, same per-pixel semantics. The CPU path and the tests
use it, and it is the oracle the kernel is held against on the card.
"""

from __future__ import annotations

import torch

TILE_W = 16
TILE_H = 16
NPIX = TILE_W * TILE_H

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4

# Instance-row layout (feature-major, one column per tile instance):
# mx my | conic a b c | opacity | r g b | depth.
R_MX, R_MY, R_CA, R_CB, R_CC, R_O, R_R, R_G, R_B, R_D = range(10)
F_ACTIVE = 10


def tile_grid(width: int, height: int) -> tuple[int, int]:
    return -(-width // TILE_W), -(-height // TILE_H)


def tile_pixel_coords(tiles_x: int, tiles_y: int, device=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel-center coordinates of every tile: (T, NPIX) x and y."""
    t = torch.arange(tiles_x * tiles_y, device=device)
    off = torch.arange(NPIX, device=device)
    px = ((t % tiles_x) * TILE_W)[:, None] + (off % TILE_W)[None, :]
    py = ((t // tiles_x) * TILE_H)[:, None] + (off // TILE_W)[None, :]
    return px.to(torch.float32), py.to(torch.float32)


def composite_tiles_plain(rows: torch.Tensor, tile_start: torch.Tensor,
                          tile_count: torch.Tensor, tiles_x: int, tiles_y: int,
                          chunk: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """Front-to-back alpha compositing of each tile's depth-sorted instances.

    rows: (F >= 10, M) float32 feature-major instance rows (layout above);
    tile t owns columns [tile_start[t], tile_start[t] + tile_count[t]).
    Returns color+depth (T, 4, NPIX) with no background, and the final
    transmittance (T, NPIX).

    Per pixel: alpha = min(0.99, o exp(power)), skipped when power > 0 or
    alpha < 1/255; the pass stops at the first Gaussian with
    T (1 - alpha) < 1e-4, and that Gaussian is itself excluded.

    Chunks of `chunk` instances per tile run as one batched step over the
    tiles that still have instances and unfinished pixels: transmittance
    within a chunk is an exclusive cumprod scaled by the running T. There
    is no per-tile instance cap; the loop runs to the largest tile count.
    Differentiable through autograd (the masks are control flow).
    """
    device = rows.device
    num_tiles = tiles_x * tiles_y
    px, py = tile_pixel_coords(tiles_x, tiles_y, device)
    start = tile_start.to(torch.int64)
    count = tile_count.to(torch.int64)
    acc = rows.new_zeros((num_tiles, NPIX, 4))
    t_run = rows.new_ones((num_tiles, NPIX))
    done = torch.zeros((num_tiles, NPIX), dtype=torch.bool, device=device)
    max_count = int(count.max()) if num_tiles else 0
    offs = torch.arange(chunk, device=device)

    for k in range(0, max_count, chunk):
        act = torch.nonzero((count > k) & ~done.all(dim=1)).squeeze(1)
        if act.numel() == 0:
            break
        in_range = (k + offs)[None, :] < count[act, None]           # (A, K)
        idx = torch.where(in_range, start[act, None] + k + offs[None, :], 0)
        feat = rows[:F_ACTIVE, idx]                                 # (F, A, K)
        feat = torch.where(in_range[None], feat, torch.zeros_like(feat))
        mx, my, ca, cb, cc, op = (feat[i][..., None] for i in range(6))

        dx = px[act][:, None, :] - mx                               # (A, K, P)
        dy = py[act][:, None, :] - my
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp(op * torch.exp(power), max=ALPHA_MAX)
        ok = (alpha >= ALPHA_MIN) & (power <= 0.0)
        a = torch.where(ok, alpha, torch.zeros_like(alpha))

        t_act = t_run[act]
        one_minus = 1.0 - a
        cp = torch.cumprod(one_minus, dim=1)
        t_before = t_act[:, None, :] * torch.cat(
            [torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        kill = (a > 0) & (t_before * one_minus < T_EPS)
        done_before = (torch.cumsum(kill.to(torch.int32), dim=1) > 0) \
            | done[act][:, None, :]
        include = (a > 0) & ~done_before

        a_inc = torch.where(include, a, torch.zeros_like(a))
        cp_inc = torch.cumprod(1.0 - a_inc, dim=1)
        t_before_inc = t_act[:, None, :] * torch.cat(
            [torch.ones_like(cp_inc[:, :1]), cp_inc[:, :-1]], dim=1)
        w = a_inc * t_before_inc                                    # (A, K, P)
        col = feat[R_R:R_D + 1].permute(1, 2, 0)                    # (A, K, 4)
        acc = acc.index_add(0, act, torch.einsum("akp,akc->apc", w, col))
        t_run = t_run.index_copy(0, act, t_act * cp_inc[:, -1, :])
        done = done.index_copy(0, act, done[act] | kill.any(dim=1))

    return acc.permute(0, 2, 1).contiguous(), t_run


def tiles_to_image(tile_vals: torch.Tensor, tiles_x: int, tiles_y: int,
                   width: int, height: int) -> torch.Tensor:
    """(T, NPIX, C) -> (C, H, W), cropping the tile padding."""
    c = tile_vals.shape[-1]
    img = tile_vals.reshape(tiles_y, tiles_x, TILE_H, TILE_W, c)
    img = img.permute(4, 0, 2, 1, 3).reshape(c, tiles_y * TILE_H,
                                             tiles_x * TILE_W)
    return img[:, :height, :width]


def image_to_tiles(img: torch.Tensor, tiles_x: int, tiles_y: int) -> torch.Tensor:
    """(C, H, W) -> (T, NPIX, C), zero-padding to tile multiples."""
    c, h, w = img.shape
    img = torch.nn.functional.pad(
        img, (0, tiles_x * TILE_W - w, 0, tiles_y * TILE_H - h))
    img = img.reshape(c, tiles_y, TILE_H, tiles_x, TILE_W)
    return img.permute(1, 3, 2, 4, 0).reshape(tiles_y * tiles_x, NPIX, c)
