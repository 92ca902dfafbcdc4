"""Plain photometric loss and Adam updates of the reference.

The objective is 3DGS's: (1 - lambda) L1 + lambda (1 - SSIM), SSIM over an
11x11 Gaussian window (sigma 1.5) with C1 = 0.01^2, C2 = 0.03^2 and zero
padding, as a separable depthwise blur. The Adam steps are the textbook
update with betas (0.9, 0.999) and eps 1e-15 outside the square root, one
state per tensor (`AdamState`), and per camera row for the cameras.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BETA1, BETA2, EPS = 0.9, 0.999, 1e-15


def _window(n: int = 11, sigma: float = 1.5, device=None, dtype=None):
    xs = torch.arange(n, dtype=torch.float64) - n // 2
    g = torch.exp(-(xs ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).to(device=device, dtype=dtype)


def _blur(img: torch.Tensor) -> torch.Tensor:
    c = img.shape[0]
    w = _window(device=img.device, dtype=img.dtype)
    x = F.conv2d(img[None], w.view(1, 1, -1, 1).repeat(c, 1, 1, 1),
                 padding=(5, 0), groups=c)
    return F.conv2d(x, w.view(1, 1, 1, -1).repeat(c, 1, 1, 1),
                    padding=(0, 5), groups=c)[0]


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    c = a.shape[0]
    m = _blur(torch.cat([a, b, a * a, b * b, a * b]))
    mu1, mu2 = m[:c], m[c:2 * c]
    s1 = m[2 * c:3 * c] - mu1 * mu1
    s2 = m[3 * c:4 * c] - mu2 * mu2
    s12 = m[4 * c:] - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))).mean()


def photometric(pred: torch.Tensor, gt: torch.Tensor, lam: float) -> torch.Tensor:
    return (1.0 - lam) * (pred - gt).abs().mean() + lam * (1.0 - ssim(pred, gt))


class AdamState:
    """Moments and a step count of one tensor."""

    def __init__(self, p: torch.Tensor):
        self.m = torch.zeros_like(p)
        self.v = torch.zeros_like(p)
        self.n = 0

    @torch.no_grad()
    def step(self, p: torch.Tensor, g: torch.Tensor, lr: float) -> None:
        self.n += 1
        self.m = BETA1 * self.m + (1 - BETA1) * g
        self.v = BETA2 * self.v + (1 - BETA2) * g * g
        mh = self.m / (1 - BETA1 ** self.n)
        vh = self.v / (1 - BETA2 ** self.n)
        p -= lr * mh / (torch.sqrt(vh) + EPS)


def expon_lr(step: int, lr_init: float, lr_final: float, max_steps: int) -> float:
    """3DGS's log-linear position schedule (no delay)."""
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def multistep(step: int, base: float, milestones, gamma: float) -> float:
    return base * gamma ** sum(step >= m for m in milestones)
