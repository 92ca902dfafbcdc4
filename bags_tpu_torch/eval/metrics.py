"""Image quality metrics: PSNR, SSIM and LPIPS (port of
`bags_tpu/eval/metrics.py`).

LPIPS reads only local weights (`eval/lpips_weights.py`): a directory of
the untouched upstream files or an npz bundle. Nothing is downloaded.
Without weights `Lpips.available` is False and a call returns NaN, which
callers print as "n/a" rather than as a number.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..train.losses import ssim  # noqa: F401  (re-export)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """20 log10(1 / sqrt(mse)) per image, images in [0, 1] shaped
    (..., C, H, W); reduces over the last three axes."""
    mse = torch.mean((img1 - img2) ** 2, dim=(-3, -2, -1))
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


# LPIPS input scaling: [0, 1] -> [-1, 1], then the shift and scale layer.
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _same_pads(size: int, k: int, stride: int):
    """XLA's "SAME" padding of one axis: (low, high), the odd pixel high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Lpips(torch.nn.Module):
    """LPIPS from a local weights bundle (vgg16 or alexnet backbone).

    The npz layout: conv{i}_w / conv{i}_b for the backbone convs, optional
    conv{i}_stride / conv{i}_pad / pool_after_{i}[_k/_s] geometry keys
    (absent: the VGG16 defaults, stride 1, SAME padding, 2x2/s2 pools),
    tap_{i} for the tapped ReLUs and lin{k}_w for the per-layer linear
    calibration. `weights_path` (else `BAGS_TPU_LPIPS_WEIGHTS`) is such an
    npz or a directory of the upstream .pth files, where `net` picks the
    backbone ('alex' is the reference's in-loop default, 'vgg' its offline
    metrics CLI's); npz bundles describe themselves and ignore `net`. The
    weights are buffers: move the module with `.to(device)`.
    """

    def __init__(self, weights_path: Optional[str] = None,
                 net: Optional[str] = None):
        super().__init__()
        weights_path = weights_path or os.environ.get("BAGS_TPU_LPIPS_WEIGHTS")
        self.available = bool(weights_path and os.path.exists(weights_path))
        self.net = None
        self.arch = ()
        if not self.available:
            return
        if os.path.isdir(weights_path):
            from .lpips_weights import load_official_dir
            data = load_official_dir(weights_path, net=net)
            names = list(data)
        else:
            data = np.load(weights_path)
            names = list(data.files)
        for k in names:
            if k.endswith(("_w", "_b")):
                self.register_buffer(k, torch.as_tensor(
                    np.asarray(data[k], np.float32)))
        n_conv = sum(1 for k in names
                     if k.startswith("conv") and k.endswith("_w"))
        arch = []
        for i in range(n_conv):
            if f"pool_after_{i}_k" in names:
                pool = (int(data[f"pool_after_{i}_k"]),
                        int(data[f"pool_after_{i}_s"]))
            elif f"pool_after_{i}" in names:
                pool = (2, 2)
            else:
                pool = None
            arch.append((
                int(data[f"conv{i}_stride"]) if f"conv{i}_stride" in names
                else 1,
                int(data[f"conv{i}_pad"]) if f"conv{i}_pad" in names
                else None,
                f"tap_{i}" in names,
                pool))
        self.arch = tuple(arch)
        self.net = "alex" if any(s != 1 for s, _, _, _ in arch) else "vgg"

    def _features(self, img: torch.Tensor) -> list:
        shift = img.new_tensor(_SHIFT).reshape(3, 1, 1)
        scale = img.new_tensor(_SCALE).reshape(3, 1, 1)
        h = (((img * 2.0 - 1.0) - shift) / scale)[None]
        feats = []
        for i, (stride, pad, tapped, pool) in enumerate(self.arch):
            w, b = getattr(self, f"conv{i}_w"), getattr(self, f"conv{i}_b")
            if pad is None:
                (top, bottom), (left, right) = (
                    _same_pads(h.shape[-2], w.shape[-2], stride),
                    _same_pads(h.shape[-1], w.shape[-1], stride))
                if top == bottom and left == right:
                    padding = (top, left)
                else:
                    h = F.pad(h, (left, right, top, bottom))
                    padding = 0
            else:
                padding = pad
            h = F.relu(F.conv2d(h, w, b, stride=stride, padding=padding))
            if tapped:               # the tap is the ReLU before any pool
                feats.append(h)
            if pool is not None:
                h = F.max_pool2d(h, pool[0], pool[1])
        return feats

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """LPIPS distance of two (3, H, W) images in [0, 1]; NaN without
        weights."""
        if not self.available:
            return torch.tensor(math.nan)
        total = img1.new_zeros(())
        for k, (a, b) in enumerate(zip(self._features(img1),
                                       self._features(img2))):
            a = a / torch.linalg.vector_norm(a, dim=1, keepdim=True).clamp_min(1e-10)
            b = b / torch.linalg.vector_norm(b, dim=1, keepdim=True).clamp_min(1e-10)
            w = getattr(self, f"lin{k}_w").reshape(1, -1, 1, 1)
            total = total + torch.mean(torch.sum((a - b) ** 2 * w, dim=1))
        return total
