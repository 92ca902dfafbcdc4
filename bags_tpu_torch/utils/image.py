"""Differentiable image resampling (port of three functions of
`bags_tpu/utils/image.py`), on the shapes the JAX package uses.

  * `grid_sample`: bilinear, zeros padding, align_corners=True, of a
    (C, H, W) image at an (Ho, Wo, 2) grid of xy in [-1, 1]
    (`F.grid_sample`), with the JAX package's result where a sample
    position is not finite (below);
  * `resize_bilinear`: half-pixel-centre bilinear upsampling
    (`F.interpolate`, align_corners=False, no antialias). The JAX package's
    `jax.image.resize(method="linear")` agrees with it only when
    upsampling (JAX antialiases a downsample), and every caller upsamples a
    control grid, so a downsample raises;
  * `center_crop_resample`: the centred window taken by `grid_sample`.

The banded tent-matmul warp (`banded_warp`, `required_ky`) is a TPU
workaround for gathers and is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _jax_tap(i: torch.Tensor, n: int) -> torch.Tensor:
    """The pixel the JAX package gathers for tap position i (float), as an
    align_corners coordinate in [-1, 1]: clipped to [0, n - 1], NaN to 0
    (XLA's float-to-int conversion)."""
    return torch.nan_to_num(torch.clamp(i, 0, n - 1), nan=0.0) * (2.0 / (n - 1)) - 1.0


def grid_sample(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample `image` (C, H, W) at `grid` (Ho, Wo, 2) of xy in
    [-1, 1] (align_corners=True); taps outside the image read zero.
    Differentiable in both.

    Where a sample position (x + 1) (W - 1) / 2 or its y is inf or NaN
    (a cubemap face grid divides by a ray's x or y, which can be 0), the
    JAX package's bilinear weights are NaN: the sample is NaN, its grid
    cotangent is NaN in each coordinate whose partner is not finite, and
    each of its four taps' clipped pixels gets a NaN image cotangent.
    `F.grid_sample` gives none of that, so it samples those positions from
    far outside the image (0, no gradient), and two terms that are 0 at a
    finite sample add JAX's, with no host synchronisation: tx (ty x 0) (the
    value and the grid cotangent) and the four clipped taps times it, read
    by a nearest-pixel `F.grid_sample` (from outside the image, so reading
    and scattering nothing, at a finite sample). Left as `F.grid_sample`
    has it: a non-finite coordinate whose partner is finite gets a grid
    cotangent of 0 where JAX's is finite, and a non-finite cotangent of a
    finite sample reaches the image only at its taps inside the image,
    where JAX's also reaches the clipped pixels of its taps outside."""
    c, h, w = image.shape
    ho, wo = grid.shape[:2]
    fx = (grid[..., 0] + 1.0) * 0.5 * (w - 1)
    fy = (grid[..., 1] + 1.0) * 0.5 * (h - 1)
    x0, y0 = torch.floor(fx.detach()), torch.floor(fy.detach())
    tx, ty = fx - x0, fy - y0
    bad = ~(torch.isfinite(tx) & torch.isfinite(ty)).detach()
    out = F.grid_sample(image[None], grid.masked_fill(bad[..., None], -1e4)[None],
                        mode="bilinear", padding_mode="zeros", align_corners=True)[0]
    nan_w = tx * (ty * 0.0)
    xs = [_jax_tap(x0 + d, w) for d in (0, 1)]
    ys = [_jax_tap(y0 + d, h) for d in (0, 1)]
    taps = torch.stack([torch.stack((x, y), dim=-1) for y in ys for x in xs])
    taps = taps.masked_fill(~bad[..., None], -1e4).reshape(1, 4 * ho, wo, 2)
    vals = F.grid_sample(image[None], taps, mode="nearest", padding_mode="zeros",
                         align_corners=True)[0].reshape(c, 4, ho, wo)
    return out + nan_w + vals.sum(dim=1) * nan_w.detach()


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """x (..., H, W) resized up to out_hw with half-pixel centres."""
    h, w = x.shape[-2:]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if oh < h or ow < w:
        raise ValueError(f"resize_bilinear upsamples only: ({h}, {w}) -> "
                         f"({oh}, {ow}); the JAX package antialiases a "
                         "downsample and the two would differ")
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(1, -1, h, w), size=(oh, ow), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.reshape(*lead, oh, ow)


def center_crop_resample(image: torch.Tensor, target_h: int, target_w: int
                         ) -> torch.Tensor:
    """The centred target_h x target_w window of `image` (C, H, W), sampled
    by `grid_sample` at the window's pixel positions.

    The positions go through [-1, 1] and back, so each lands within an ulp
    of its pixel, to one side or the other as rounding decides (here and in
    the JAX package, whose `jnp.linspace` rounds differently). Beside a
    pixel that reads zero, the side decides whether the sample is exactly
    0 or ~1e-7 of the neighbour, and so whether the exact-zero validity
    mask keeps it: on the test scenes a few such pixels differ between
    the packages (`tests/test_torch_lens_warp.py`)."""
    _, h, w = image.shape
    start_y = (h - target_h) // 2
    start_x = (w - target_w) // 2
    opts = dict(dtype=image.dtype, device=image.device)
    ys = torch.linspace(start_y, start_y + target_h - 1, target_h, **opts)
    xs = torch.linspace(start_x, start_x + target_w - 1, target_w, **opts)
    gy = 2.0 * ys / (h - 1) - 1.0
    gx = 2.0 * xs / (w - 1) - 1.0
    grid = torch.stack(torch.meshgrid(gx, gy, indexing="xy"), dim=-1)
    return grid_sample(image, grid)
