"""Differentiable image resampling (port of three functions of
`bags_tpu/utils/image.py`), on the shapes the JAX package uses.

  * `grid_sample`: bilinear, zeros padding, align_corners=True, of a
    (C, H, W) image at an (Ho, Wo, 2) grid of xy in [-1, 1]
    (`F.grid_sample`);
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


def grid_sample(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample `image` (C, H, W) at `grid` (Ho, Wo, 2) of xy in
    [-1, 1] (align_corners=True); taps outside the image read zero.
    Differentiable in both."""
    return F.grid_sample(image[None], grid[None], mode="bilinear",
                         padding_mode="zeros", align_corners=True)[0]


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
