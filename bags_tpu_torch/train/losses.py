"""Photometric losses: L1, L2, windowed SSIM (port of
`bags_tpu/train/losses.py`).

The 11x11 Gaussian-window (sigma 1.5) SSIM with C1 = 0.01^2, C2 = 0.03^2 and
zero "SAME" padding, and the training objective
(1 - lambda) L1 + lambda (1 - SSIM) with lambda = 0.2. The window is
separable: two depthwise `F.conv2d` passes (cuDNN on the card, in full
float32: the package switches TF32 off) over the five stacked moment maps.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - gt))


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def _blur(img: torch.Tensor, window_size: int) -> torch.Tensor:
    """Separable depthwise blur of (C, H, W) with zero 'SAME' padding."""
    c = img.shape[0]
    half = window_size // 2
    w = torch.as_tensor(_gaussian_window(window_size), device=img.device)
    x = F.conv2d(img[None], w.view(1, 1, -1, 1).repeat(c, 1, 1, 1),
                 padding=(half, 0), groups=c)
    x = F.conv2d(x, w.view(1, 1, 1, -1).repeat(c, 1, 1, 1),
                 padding=(0, half), groups=c)
    return x[0]


def ssim_map(img1: torch.Tensor, img2: torch.Tensor,
             window_size: int = 11) -> torch.Tensor:
    """The windowed SSIM map (C, H, W) of (C, H, W) images."""
    c = img1.shape[0]
    b = _blur(torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2]),
              window_size)
    mu1, mu2 = b[:c], b[c:2 * c]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = b[2 * c:3 * c] - mu1_sq
    sigma2_sq = b[3 * c:4 * c] - mu2_sq
    sigma12 = b[4 * c:5 * c] - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / \
        ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """Windowed SSIM of (C, H, W) images: the mean of the SSIM map, or the
    per-channel means when not `size_average`."""
    smap = ssim_map(img1, img2, window_size)
    return smap.mean() if size_average else smap.mean(dim=(-2, -1))


def photometric_loss(pred: torch.Tensor, gt: torch.Tensor,
                     lambda_dssim: float = 0.2) -> torch.Tensor:
    """(1 - lambda) L1 + lambda (1 - SSIM)."""
    return (1.0 - lambda_dssim) * l1_loss(pred, gt) + \
        lambda_dssim * (1.0 - ssim(pred, gt))


def masked_photometric_loss(pred, gt, mask, lambda_dssim: float = 0.2):
    """Both images pre-multiplied by the validity mask, then the plain
    objective."""
    return photometric_loss(pred * mask, gt * mask, lambda_dssim)
