"""Process-group helpers and collectives of the tile-parallel trainer (port
of `bags_tpu/dist/mesh.py`; the JAX package's mesh axis 'tile' is the
default `torch.distributed` group here).

Layout, as in the JAX package: the Gaussian slots are split into D
contiguous blocks of C / D rows, rank r owning rows [r C / D, (r + 1) C / D)
with their Adam moments and densify statistics; the image is split into D
slabs of tile rows, the tile-row grid padded to a multiple of D. The
cameras, the alignment and the specular MLP are replicated.

Every collective of the trainer goes through the functions here, on the
default group, whatever its size: a world of one calls the same
collectives as a world of four. Each function adds its call and its bytes
to `COUNTS` under its kind (`KINDS`); `reset_counts()` starts a new tally.
The bytes are the collective's whole tensor as this rank sees it: an
all-gather's output, a reduce-scatter's input, an all-reduce's tensor, a
broadcast's tensors, the rows a halo exchange sends. Counting reads shapes
only: it adds no synchronisation.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ..core.camera import CameraStatic
from ..raster.tiles import TILE_H, tile_grid

# The JAX package's per-rank instance budget is rounded up to its binning
# chunk (`bags_tpu/raster/binning.py:55`, `dist/sharded.py:107`).
CHUNK = 128

# torch 2.13 names the tensor collectives *_single; older releases
# *_into_tensor / reduce_scatter_tensor.
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)


# The kinds of `COUNTS`: the packet all-gather of the sharded render and its
# backward reduce-scatter, the image all-gather of the calibrated modes and
# its backward reduce-scatter, the other all-gathers (sort keys, population,
# checkpoints), the all-reduces, the broadcasts, and the halo rows sent
# forward and their gradients sent back.
KINDS = ("packet_all_gather", "packet_reduce_scatter", "image_all_gather",
         "image_reduce_scatter", "all_gather", "all_reduce", "broadcast",
         "halo_send", "halo_grad_send")
COUNTS: Dict[str, List[int]] = {k: [0, 0] for k in KINDS}


def reset_counts() -> None:
    """Set every kind's calls and bytes to 0."""
    for c in COUNTS.values():
        c[0] = c[1] = 0


def counts() -> Dict[str, tuple]:
    """{kind: (calls, bytes)} of the kinds called since the last reset."""
    return {k: (c[0], c[1]) for k, c in COUNTS.items() if c[0]}


def _count(kind: str, nbytes: int) -> None:
    c = COUNTS[kind]
    c[0] += 1
    c[1] += int(nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def rank_world() -> tuple[int, int]:
    """(this rank, the world size) of the default group."""
    return dist.get_rank(), dist.get_world_size()


def padded_height(height: int, n_ranks: int, tile: int = TILE_H) -> int:
    """Image rows after padding the tile-row grid to a multiple of n_ranks."""
    tiles_y = -(-height // tile)
    return (-(-tiles_y // n_ranks) * n_ranks) * tile


def tiles_y_local(static: CameraStatic, n_ranks: int) -> int:
    """Tile rows of each rank's slab (`_tiles_y_local`, sharded.py:95)."""
    _, tiles_y = tile_grid(static.width, static.height)
    return -(-tiles_y // n_ranks)


def row_block(capacity: int, rank: int, n_ranks: int) -> slice:
    """The Gaussian slots rank `rank` owns: a contiguous block of C / D."""
    if capacity % n_ranks:
        raise ValueError(f"capacity {capacity} does not divide into "
                         f"{n_ranks} ranks' blocks")
    n = capacity // n_ranks
    return slice(rank * n, (rank + 1) * n)


def local_budget(max_instances: Optional[int], n_ranks: int) -> Optional[int]:
    """Each rank's instance budget: max_instances / D rounded up to CHUNK
    (None: no budget)."""
    if max_instances is None:
        return None
    return -(-(max_instances // n_ranks) // CHUNK) * CHUNK


def _gather(x: torch.Tensor, kind: str) -> torch.Tensor:
    d = dist.get_world_size()
    out = x.new_empty((d * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather(out, x.detach().contiguous())
    _count(kind, _nbytes(out))
    return out


def _scatter_sum(g: torch.Tensor, kind: str) -> torch.Tensor:
    """The sum over the ranks of their (D n, ...) tensors' n-row blocks,
    rank r keeping block r."""
    d = dist.get_world_size()
    out = g.new_empty((g.shape[0] // d,) + tuple(g.shape[1:]))
    _reduce_scatter(out, g.contiguous())
    _count(kind, _nbytes(g))
    return out


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's (n, ...) block, concatenated in rank order (no grad; a
    bool tensor travels as uint8)."""
    if x.dtype == torch.bool:
        return all_gather_rows(x.to(torch.uint8)).to(torch.bool)
    return _gather(x, "all_gather")


class _AllGatherCols(torch.autograd.Function):
    """(F, n) feature-major blocks -> (F, D n), the ranks' columns in rank
    order; the backward reduce-scatters the cotangent: each rank's block
    gets the sum over ranks of the gradients of its columns."""

    @staticmethod
    def forward(ctx, x):
        d = dist.get_world_size()
        f, n = x.shape
        out = _gather(x, "packet_all_gather")                    # (D F, n)
        return out.view(d, f, n).transpose(0, 1).reshape(f, d * n)

    @staticmethod
    def backward(ctx, g):
        d = dist.get_world_size()
        f, n = g.shape[0], g.shape[1] // d
        return _scatter_sum(g.reshape(f, d, n).transpose(0, 1).reshape(d * f, n),
                            "packet_reduce_scatter")


def all_gather_cols_grad(x: torch.Tensor) -> torch.Tensor:
    """Differentiable all-gather of (F, n) blocks into (F, D n) (backward:
    a reduce-scatter). At D = 1 both ways are one copy of x."""
    return _AllGatherCols.apply(x)


class _Depend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dep):
        ctx.dep = (dep.shape, dep.dtype, dep.device)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.dep
        return g, torch.zeros(shape, dtype=dtype, device=device)


def depend(x: torch.Tensor, dep: torch.Tensor) -> torch.Tensor:
    """A copy of x whose backward also gives `dep` a zero gradient, so that
    the collectives behind `dep` run in this rank's backward as in its
    peers' (a slab that holds no instance does not depend on the gathered
    packet, and its peers' backward waits for its reduce-scatter)."""
    return _Depend.apply(x, dep)


class _AllGatherImageRows(torch.autograd.Function):
    """(C, Hl, W) slabs -> (C, D Hl, W), the ranks' rows in rank order; the
    backward reduce-scatters the cotangent: each rank's slab gets the sum
    over ranks of the gradients of its rows."""

    @staticmethod
    def forward(ctx, x):
        d = dist.get_world_size()
        c, h, w = x.shape
        out = _gather(x, "image_all_gather")                     # (D C, Hl, W)
        return out.view(d, c, h, w).transpose(0, 1).reshape(c, d * h, w)

    @staticmethod
    def backward(ctx, g):
        d = dist.get_world_size()
        c, h, w = g.shape[0], g.shape[1] // d, g.shape[2]
        return _scatter_sum(g.reshape(c, d, h, w).transpose(0, 1).reshape(d * c, h, w),
                            "image_reduce_scatter")


def all_gather_image_rows(x: torch.Tensor) -> torch.Tensor:
    """Differentiable all-gather of each rank's (C, Hl, W) slab into the
    (C, D Hl, W) frame (backward: a reduce-scatter of the frame's
    gradient). At D = 1 both ways are one copy of x."""
    return _AllGatherImageRows.apply(x)


def broadcast_(tensors: List[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor, in place, with rank `src`'s (no grad)."""
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src)
            _count("broadcast", _nbytes(t))


def all_reduce_sum(tensors: List[torch.Tensor]) -> None:
    """Sum each tensor over the ranks, in place, with one all-reduce of
    their concatenation (all of one dtype and device)."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    _count("all_reduce", _nbytes(flat))
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def _p2p(ops, kind: str) -> None:
    """Run `ops`, pairs of a send and then a receive, and count the sent
    bytes."""
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        _count(kind, sum(_nbytes(op.tensor) for op in ops[::2]))


class HaloExchange(torch.autograd.Function):
    """The `halo` rows next to each slab edge (`jax.lax.ppermute` of
    `_halo_slab_loss`, sharded.py:66-69). x (C, Hl, W) -> (top, bottom):
    the previous rank's last rows and the next rank's first rows, zeros at
    the first and last rank. The backward sends each halo's gradient back
    to the rank whose rows it was."""

    @staticmethod
    def forward(ctx, x, halo: int):
        rank, d = rank_world()
        ctx.halo = halo
        top = x.new_zeros((x.shape[0], halo, x.shape[2]))
        bot = torch.zeros_like(top)
        ops = []
        if rank > 0:
            ops += [dist.P2POp(dist.isend, x[:, :halo].contiguous(), rank - 1),
                    dist.P2POp(dist.irecv, top, rank - 1)]
        if rank < d - 1:
            ops += [dist.P2POp(dist.isend, x[:, -halo:].contiguous(), rank + 1),
                    dist.P2POp(dist.irecv, bot, rank + 1)]
        _p2p(ops, "halo_send")
        ctx.shape = x.shape
        return top, bot

    @staticmethod
    def backward(ctx, g_top, g_bot):
        rank, d = rank_world()
        halo = ctx.halo
        grad = g_top.new_zeros(ctx.shape)
        from_above = g_top.new_zeros((ctx.shape[0], halo, ctx.shape[2]))
        from_below = torch.zeros_like(from_above)
        ops = []
        if rank > 0:
            ops += [dist.P2POp(dist.isend, g_top.contiguous(), rank - 1),
                    dist.P2POp(dist.irecv, from_above, rank - 1)]
        if rank < d - 1:
            ops += [dist.P2POp(dist.isend, g_bot.contiguous(), rank + 1),
                    dist.P2POp(dist.irecv, from_below, rank + 1)]
        _p2p(ops, "halo_grad_send")
        grad[:, :halo] += from_above
        grad[:, -halo:] += from_below
        return grad, None
