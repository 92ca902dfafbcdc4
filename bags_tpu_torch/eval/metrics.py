"""Image quality metrics (port of `bags_tpu/eval/metrics.py`, PSNR only)."""

from __future__ import annotations

import torch


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """20 log10(1 / sqrt(mse)) per image, images in [0, 1] shaped
    (..., C, H, W); reduces over the last three axes."""
    mse = torch.mean((img1 - img2) ** 2, dim=(-3, -2, -1))
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))
