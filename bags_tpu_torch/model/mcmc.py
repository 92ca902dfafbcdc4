"""MCMC densification (port of `bags_tpu/model/mcmc.py`).

3DGS-MCMC relocation on the fixed-capacity population:
  * every densification interval, dead Gaussians (alive with opacity <=
    min_opacity) move onto sources drawn with probability proportional to
    opacity over the live ones; each source and its copies take the merged
    opacity and scale of `compute_relocation` for the source's n_merge (1 +
    the times it was drawn):
      o_new = 1 - (1 - o_old)^(1/N)
      s_new = s_old o_old / sum_{i=1..N} sum_{k=0..i-1} C(i-1,k) (-1)^k
                              o_new^(k+1) / sqrt(k+1);
  * growth toward cap_max by GROWTH a step (`add_new_gaussians`), into
    the first non-alive slots;
  * position noise after each optimizer step (`position_noise`).

The pairing is the JAX package's: the dead (or non-alive) slots in index
order, the i-th of them receiving draw i. The JAX package draws C
categorical samples and keeps the first n_dead (its sampler builds a
(C, C) array); the port draws just those n_dead (or n_new), i.i.d. from the
same distribution, with `torch.multinomial` on the tensors' device and an
explicit generator. Reading n_dead (or the live count) is one host
synchronisation per relocation. The parameter tensors are updated in
place; each function returns the slots whose Adam moments the caller
zeroes.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.projection import build_covariance
from .gaussians import Gaussians

N_MAX = 51
GROWTH = 1.005     # add_new_gaussians' factor on the live count

_BINOMS = np.zeros((N_MAX, N_MAX), np.float32)
for _n in range(N_MAX):
    for _k in range(_n + 1):
        _BINOMS[_n, _k] = math.comb(_n, _k)


def compute_relocation(opacity_old: torch.Tensor, scale_old: torch.Tensor,
                       n_merge: torch.Tensor):
    """The `compute_relocation` kernel, vectorised: (N,), (N, 3), (N,)
    integer -> new opacity (N,), new scale (N, 3), in the inputs' dtype."""
    dt, dev = opacity_old.dtype, opacity_old.device
    n_merge = torch.clamp(n_merge, 1, N_MAX - 1)
    new_opacity = 1.0 - (1.0 - opacity_old) ** (1.0 / n_merge.to(dt))
    # the table, k and sqrt(k + 1) are float32 in the JAX package at any
    # precision (its float64 results use them rounded so)
    binoms = torch.as_tensor(_BINOMS, device=dev).to(dt)
    ks = torch.arange(N_MAX, dtype=torch.float32, device=dev)
    root = torch.sqrt(ks + 1.0).to(dt)
    ks = ks.to(dt)
    # term[k] = (-1)^k new_o^(k+1) / sqrt(k+1)
    terms = ((-1.0) ** ks)[None, :] * new_opacity[:, None] ** (ks[None, :] + 1) \
        / root[None, :]
    inner = terms @ binoms.T                     # inner[:, i-1] for row i-1
    i_mask = torch.arange(N_MAX, device=dev)[None, :] < n_merge[:, None]
    denom = torch.sum(torch.where(i_mask, inner, torch.zeros((), dtype=dt,
                                                             device=dev)), dim=1)
    coeff = opacity_old / torch.clamp(denom, min=1e-8)
    return new_opacity, scale_old * coeff[:, None]


class RelocateResult(NamedTuple):
    alive: torch.Tensor
    reset_mask: torch.Tensor   # (C,) slots whose Adam moments must be zeroed
    n_relocated: int


def _sample_by_opacity(gen: torch.Generator, g: Gaussians, live: torch.Tensor,
                       num: int) -> torch.Tensor:
    """`num` i.i.d. slot indices with probability proportional to
    sigmoid(opacity_raw) over `live` (no other slot is ever drawn)."""
    if num == 0:
        return torch.zeros(0, dtype=torch.long, device=live.device)
    w = torch.where(live, torch.sigmoid(g.opacity_raw.detach()),
                    torch.zeros((), device=live.device))
    return torch.multinomial(w, num, replacement=True, generator=gen)


def _move_onto(g: Gaussians, src: torch.Tensor, dst: torch.Tensor,
               min_opacity: float) -> torch.Tensor:
    """Row src[i] -> dst[i] across every field, the copies and their
    sources taking the merged opacity (clipped to [min_opacity, 1 - 1e-7])
    and scale of `compute_relocation`. Returns the (C,) mask of the slots
    written (the copies and the sources)."""
    sources, inv, counts = torch.unique(src, return_inverse=True,
                                        return_counts=True)
    new_o, new_s = compute_relocation(
        torch.sigmoid(g.opacity_raw[sources]),
        torch.exp(g.scales_log[sources]), counts + 1)
    new_o = torch.clamp(new_o, min_opacity, 1.0 - 1e-7)
    merged = {"opacity_raw": torch.log(new_o / (1.0 - new_o)),
              "scales_log": torch.log(torch.clamp(new_s, min=1e-10))}
    for name, arr in g.fields().items():
        arr[dst] = merged[name][inv] if name in merged else arr[src]
    for name, vals in merged.items():
        getattr(g, name)[sources] = vals
    touched = torch.zeros(g.xyz.shape[0], dtype=torch.bool, device=dst.device)
    touched[dst] = True
    touched[sources] = True
    return touched


@torch.no_grad()
def relocate_dead(g: Gaussians, alive: torch.Tensor, gen: torch.Generator,
                  min_opacity: float = 0.005) -> RelocateResult:
    """`relocate_gs`: every dead Gaussian (alive, opacity <= min_opacity)
    takes a copy of an opacity-drawn live source, in place."""
    dead = alive & (torch.sigmoid(g.opacity_raw) <= min_opacity)
    live = alive & ~dead
    n_dead, n_live = torch.stack([dead.sum(), live.sum()]).tolist()
    if n_dead and not n_live:
        raise ValueError(f"{n_dead} dead Gaussians and none live to copy")
    src = _sample_by_opacity(gen, g, live, n_dead)
    dst = torch.argsort((~dead).to(torch.uint8), stable=True)[:n_dead]
    reset = _move_onto(g, src, dst, min_opacity)
    return RelocateResult(alive.clone(), reset, n_dead)


@torch.no_grad()
def add_new_gaussians(g: Gaussians, alive: torch.Tensor, gen: torch.Generator,
                      cap_max: int | None = None) -> RelocateResult:
    """`add_new_gs`: grow the live count from N to min(cap,
    int(float32(GROWTH) * float32(N))) (the JAX package's float32 product)
    by copies of opacity-drawn alive sources into the first non-alive
    slots, in place."""
    c = alive.shape[0]
    cap = min(cap_max or c, c)
    current = int(alive.sum())
    target = min(cap, int(np.float32(GROWTH) * np.float32(current)))
    n_new = max(target - current, 0)
    src = _sample_by_opacity(gen, g, alive, n_new)
    dst = torch.argsort(alive.to(torch.uint8), stable=True)[:n_new]
    reset = _move_onto(g, src, dst, 0.005)
    added = torch.zeros_like(alive)
    added[dst] = True
    return RelocateResult(alive | added, reset, n_new)


def position_noise(g: Gaussians, alive: torch.Tensor, eps: torch.Tensor,
                   xyz_lr: float, noise_lr: float = 5e5) -> torch.Tensor:
    """SGLD exploration noise: standard normal draws `eps` (C, 3) shaped by
    each Gaussian's covariance and gated by a sharp sigmoid of
    1 - opacity. Returns the new xyz (dead rows unchanged)."""
    opac = torch.sigmoid(g.opacity_raw)
    gate = torch.sigmoid(100.0 * ((1.0 - opac) - 0.995))
    eps = eps * gate[:, None] * noise_lr * xyz_lr
    cov = build_covariance(torch.exp(g.scales_log), g.quats)
    noise = torch.einsum("nij,nj->ni", cov, eps)
    return g.xyz + noise * alive[:, None].to(noise.dtype)
