"""Invertible residual network (i-ResNet) lens field (port of
`bags_tpu/calib/iresnet.py`).

An invertible map R^2 -> R^2 between in-lens (sensor) and ideal-frustum ray
coordinates: 5 blocks y = x + g(x), each g an MLP of 4 hidden layers of
width 512 with ELU, whose linear layers are spectrally normalised at call
time so that each block's Lipschitz bound is 0.9.

  * Spectral normalisation: 5 power iterations on the detached weight and
    the stored vector u; sigma = u^T W v stays differentiable in W only.
    The stored `u_vecs` are never updated (constants of every step), so
    the function is the JAX package's; `torch.nn.utils.spectral_norm`
    would update u on every call.
  * Inverse: per point, an unrolled, undamped 2x2 Newton iteration with no
    early exit (12 iterations in float32, 16 in float64), with the
    residual's exact Jacobian from a hand-rolled tangent sweep.
  * Backward of the inverse (`_BlockInverse`): the exact per-point adjoint
    of x + g(x) = y, (I + J)^T u = v solved in closed form; the parameter
    cotangent is -dg/dtheta^T u (the spectral normalisation recomputed
    under autograd), y's is u. Nothing differentiates through the loop.

Weights are stored as the JAX package stores them: `weights[b][l]` (in,
out), `biases[b][l]` (out,), `u_vecs[b][l]` (in,).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

N_BLOCKS = 5
HIDDEN = 512
N_LAYERS = 4          # hidden layers per block
LIPSCHITZ = 0.9
NEWTON_ITERS = 12
POWER_ITERS = 5


@dataclasses.dataclass
class IResNetParams:
    """weights[b][l] (in, out) and biases[b][l] (out,) are the trained
    leaves; u_vecs[b][l] (in,) are the power iteration's constant vectors
    (no gradient, never updated)."""

    weights: List[List[torch.Tensor]]
    biases: List[List[torch.Tensor]]
    u_vecs: List[List[torch.Tensor]]

    def parameters(self) -> List[torch.Tensor]:
        """The trained leaves: every weight, then every bias, block-major."""
        return ([w for blk in self.weights for w in blk]
                + [b for blk in self.biases for b in blk])

    def named_tensors(self, trained_only: bool = False
                      ) -> Dict[str, torch.Tensor]:
        """The tensors by their JAX pytree paths, e.g. ".weights[0][1]";
        trained_only leaves out `u_vecs`."""
        fields = ("weights", "biases") + (() if trained_only else ("u_vecs",))
        return {f".{field}[{b}][{l}]": t
                for field in fields
                for b, blk in enumerate(getattr(self, field))
                for l, t in enumerate(blk)}


def init_iresnet_params(input_dim: int = 2, hidden: int = HIDDEN,
                        n_blocks: int = N_BLOCKS, n_layers: int = N_LAYERS,
                        seed: int = 0, device=None,
                        dtype: torch.dtype = torch.float32) -> IResNetParams:
    """The JAX package's initialisation, draw for draw from
    `np.random.default_rng(seed)`: weights N(0, 1/fan_in), zero biases,
    N(0, 1) power-iteration vectors. The weights and biases require grad."""
    rng = np.random.default_rng(seed)
    weights, biases, u_vecs = [], [], []

    def leaf(a, grad):
        return torch.as_tensor(a, device=device).to(dtype).requires_grad_(grad)

    for _ in range(n_blocks):
        dims = [input_dim] + [hidden] * n_layers + [input_dim]
        ws, bs, us = [], [], []
        for i in range(len(dims) - 1):
            w = rng.normal(0, 1.0 / np.sqrt(dims[i]),
                           (dims[i], dims[i + 1])).astype(np.float32)
            ws.append(leaf(w, True))
            bs.append(leaf(np.zeros(dims[i + 1], np.float32), True))
            us.append(leaf(rng.normal(size=(dims[i],)).astype(np.float32),
                           False))
        weights.append(ws)
        biases.append(bs)
        u_vecs.append(us)
    return IResNetParams(weights=weights, biases=biases, u_vecs=u_vecs)


def _spectral_normalize(w: torch.Tensor, u: torch.Tensor,
                        target: float) -> torch.Tensor:
    """w scaled so that its spectral norm is <= target. The power iteration
    runs on detached copies (u and v are constants of the step); sigma =
    u^T W v stays differentiable in w."""
    with torch.no_grad():
        wc, u = w.detach(), u.detach()
        v = None
        for _ in range(POWER_ITERS):
            v = wc.T @ u
            v = v / torch.clamp(torch.linalg.norm(v), min=1e-12)
            u = wc @ v
            u = u / torch.clamp(torch.linalg.norm(u), min=1e-12)
    sigma = u @ (w @ v)
    scale = torch.clamp(target / torch.clamp(sigma.abs(), min=1e-12), max=1.0)
    return w * scale


def _norm_weights(ws, us) -> List[torch.Tensor]:
    """A block's spectrally normalised weights, computed once per call."""
    per_layer = LIPSCHITZ ** (1.0 / len(ws))
    return [_spectral_normalize(w, u, per_layer) for w, u in zip(ws, us)]


def _residual_from_ws(ws, biases, x: torch.Tensor) -> torch.Tensor:
    """g(x) from normalised weights. x: (..., 2)."""
    h = x
    n = len(ws)
    for i in range(n):
        h = h @ ws[i] + biases[i]
        if i < n - 1:
            h = F.elu(h)
    return h


def _residual_and_jac2x2(ws, biases, x: torch.Tensor):
    """g(x) and its per-point 2x2 Jacobian in one sweep of tangents
    t <- (t @ W) * elu'(z), elu'(z) = exp(min(z, 0)); the first tangent
    layer is W's rows. Returns (g, j00, j01, j10, j11), j_ij = dg_i/dx_j."""
    n = len(ws)
    h = x
    t0 = t1 = None
    for i in range(n):
        z = h @ ws[i] + biases[i]
        if i == 0:
            t0 = ws[i][0].expand_as(z)
            t1 = ws[i][1].expand_as(z)
        else:
            t0 = t0 @ ws[i]
            t1 = t1 @ ws[i]
        if i < n - 1:
            dz = torch.exp(torch.clamp(z, max=0.0))
            h = F.elu(z)
            t0 = t0 * dz
            t1 = t1 * dz
        else:
            h = z
    return h, t0[..., 0], t1[..., 0], t0[..., 1], t1[..., 1]


def _solve_fixed_point(ws, bs, y: torch.Tensor, iters: int = None
                       ) -> torch.Tensor:
    """x with x + g(x) = y by unrolled, undamped per-point 2x2 Newton from
    x = y (no early exit). I + J is invertible (singular values in
    [1 - L, 1 + L]), so each step is defined."""
    if iters is None:
        iters = NEWTON_ITERS if y.dtype == torch.float32 else NEWTON_ITERS + 4
    x = y
    for _ in range(iters):
        g, j00, j01, j10, j11 = _residual_and_jac2x2(ws, bs, x)
        f = x + g - y
        a = j00 + 1.0
        d = j11 + 1.0
        det = a * d - j01 * j10
        sx = (d * f[..., 0] - j01 * f[..., 1]) / det
        sy = (a * f[..., 1] - j10 * f[..., 0]) / det
        x = x - torch.stack([sx, sy], dim=-1)
    return x


class _BlockInverse(torch.autograd.Function):
    """One block's inverse with the implicit-function backward. Inputs: y,
    the layer count n, then the block's n raw weights, n biases and n
    power-iteration vectors."""

    @staticmethod
    def forward(ctx, y, n, *tensors):
        ws, bs, us = tensors[:n], tensors[n:2 * n], tensors[2 * n:]
        with torch.no_grad():
            x = _solve_fixed_point(_norm_weights(ws, us), bs, y)
        ctx.n = n
        ctx.save_for_backward(x, *tensors)
        return x

    @staticmethod
    def backward(ctx, v):
        x, *tensors = ctx.saved_tensors
        n = ctx.n
        ws, bs, us = tensors[:n], tensors[n:2 * n], tensors[2 * n:]
        with torch.no_grad():
            _, j00, j01, j10, j11 = _residual_and_jac2x2(
                _norm_weights(ws, us), bs, x)
            # (I + J)^T u = v per point: [[1 + j00, j10], [j01, 1 + j11]]
            a = j00 + 1.0
            d = j11 + 1.0
            det = a * d - j01 * j10
            u = torch.stack([(d * v[..., 0] - j10 * v[..., 1]) / det,
                             (a * v[..., 1] - j01 * v[..., 0]) / det], dim=-1)
        want = ctx.needs_input_grad[2:2 * n + 2]
        p_cot = [None] * (2 * n)
        if any(want):
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(True) for t in ws + bs]
                g = _residual_from_ws(_norm_weights(leaves[:n], us),
                                      leaves[n:], x)
                grads = torch.autograd.grad(g, leaves, u)
            p_cot = [-gr if w else None for gr, w in zip(grads, want)]
        return (u, None, *p_cot, *([None] * n))


def _block_residual(params: IResNetParams, b: int, x: torch.Tensor
                    ) -> torch.Tensor:
    ws = _norm_weights(params.weights[b], params.u_vecs[b])
    return _residual_from_ws(ws, params.biases[b], x)


def iresnet_forward(params: IResNetParams, x: torch.Tensor,
                    sensor_to_frustum: bool = True) -> torch.Tensor:
    """Apply the network to points x (..., 2): the composition of the
    blocks (sensor -> frustum), or with sensor_to_frustum=False their
    inverses in reverse order, each by Newton with the implicit backward."""
    n_blocks = len(params.weights)
    if sensor_to_frustum:
        for b in range(n_blocks):
            x = x + _block_residual(params, b, x)
        return x
    for b in reversed(range(n_blocks)):
        n = len(params.weights[b])
        x = _BlockInverse.apply(x, n, *params.weights[b], *params.biases[b],
                                *params.u_vecs[b])
    return x


@torch.no_grad()
def inverse_residual(params: IResNetParams, y: torch.Tensor) -> float:
    """max |x + g(x) - y| over the points y (..., 2) at the inverse x, the
    whole network composed: how far the Newton inverse is from converged."""
    x = iresnet_forward(params, y, sensor_to_frustum=False)
    return float((iresnet_forward(params, x) - y).abs().max())
