"""Ablation timings of the forward compositing loop (port of
`tools/kernablate.py`).

    python -m bags_tpu_torch.tools.kernablate          # the four modes
    python -m bags_tpu_torch.tools.kernablate real     # fori and the variants
                                                       # against the forward

The JAX tool prices its own loop in two ways, and so does this one, each
pointed at the loop that runs here.

The modes. `composite_ablate(..., mode)` runs one of four deliberately
invalid variants of the forward kernel's loop, for timing only (the port of
`make_kernel(mode)`'s `kern`, `csrc/composite_ablate.cu`): each tile walks
its 128-slot chunks aligned to global multiples of 128, and each pixel
every instance of its tile in them, with no termination. Per pair, with
`power` as in the forward, ok = alpha >= 1/255 and power <= 0, a = alpha
where ok, 0 elsewhere:

  dma_only           w = power
  no_transcendental  alpha = min(0.99, o power), w = a (1 + S), S the
                     exclusive running sum of a inside the chunk
  no_scan            alpha = min(0.99, o exp(power)), w = a exp(log1p(-a))
  full               alpha as no_scan, w = a exp(L), L the exclusive
                     running sum of log1p(-a) inside the chunk

and every mode returns sum(colour w) per pixel (r, g, b, depth) and
t = 1 - 0 * sum(w). `no_transcendental` composites nothing: o >= 0 and
power <= 0 make o power <= 0 < 1/255 for every pair, in the JAX tool too.
The kernel runs them in the forward kernel's loop (its instance layout,
8x4-pixel warps and per-pair arithmetic, chunks copied asynchronously while
the one before is composited) with every pair visited, so dma_only prices
the copy and the walk over every pair with its power, no_transcendental
the alpha test on top, no_scan the exp and log1p of the accepted pairs,
full the running sum of the log.

The real variants. Each computes the forward's function bit for bit, so
its plain version is `tiles.composite_tiles_plain`, and its time beside the
forward kernel's prices the one piece it lacks:

  fori          without the block exit (the port of `fori_kernel`): the
                block loads every batch of its tile and a warp whose pixels
                are done skips the work
  no_exp_skip   without the exp skip below p_min
  no_cull       without the footprint cull: every warp visits every
                instance of the batch
  no_walk       a step and a bit test for every batch instance in place of
                the walk over ballot words of kept instances
  index_order   the tiles launched in index order in place of
                `composite.tile_order` (whose `argsort` `real` also times
                alone)

For CUDA tensors the wrappers launch the kernels or raise; for CPU tensors
they run the plain versions. `launches` counts the kernel launches per mode,
of `fori` and per variant.

`modes()` and `real_variants()` run the JAX tool's workload (100,000 toy
Gaussians at SH 3, 800x800, an instance budget of 2^20). `modes()` prints
one `mode: ms` line each (CUDA events on the card, median of 7);
`real_variants()` times fori and each variant in turns with the forward
kernel (variant, forward, forward, variant), prints each with the
forward's time and its largest difference from it (0), then
`real while_loop` (the forward kernel) and `tile_order` alone.
"""

from __future__ import annotations

import argparse

import torch

from ..raster import composite
from ..raster.tiles import (ALPHA_MAX, ALPHA_MIN, F_ACTIVE, NPIX, R_CA, R_CB,
                            R_CC, R_D, R_MX, R_MY, R_O, R_R,
                            composite_tiles_plain, tile_pixel_coords)
from ..utils.device import resolve_device
from ..utils.profiling import timed, toy_workload

MODES = ("dma_only", "no_transcendental", "no_scan", "full")
# The forward's variants; index_order launches the forward's own kernel,
# the others the kernel variant numbered here in
# `composite_fwd_variant_launch`.
VARIANTS = ("no_exp_skip", "no_cull", "no_walk", "index_order")
_KERNEL_VARIANT = {"no_exp_skip": 1, "no_cull": 2, "no_walk": 3}
CHUNK = 128  # slots per chunk, the TPU tool's lane width K

# Kernel launches made through `composite_ablate` (per mode),
# `composite_fwd_fori` (key "fori") and `composite_fwd_variant` (per
# variant) in this process.
launches = {name: 0 for name in MODES + ("fori",) + VARIANTS}


def _mode_weights(mode, power, op, valid, exclusive_sum):
    """(A, K, P) weights of ablation mode `mode` (see the module docstring)."""
    if mode == "dma_only":
        return torch.where(valid, power, torch.zeros_like(power))
    lin = mode == "no_transcendental"
    alpha = torch.clamp(op * (power if lin else torch.exp(power)), max=ALPHA_MAX)
    ok = (alpha >= ALPHA_MIN) & (power <= 0.0) & valid
    a = torch.where(ok, alpha, torch.zeros_like(alpha))
    if lin:
        return a * (1.0 + exclusive_sum(a))
    if mode == "no_scan":
        return a * torch.exp(torch.log1p(-a))
    return a * torch.exp(exclusive_sum(torch.log1p(-a)))


def composite_ablate_plain(rows, tile_start, tile_count, tiles_x, tiles_y,
                           mode, tile_batch=512):
    """Plain PyTorch version of the ablation kernel of mode `mode`.

    Arguments as `composite.composite_fwd`. Returns colour+depth
    (T, 4, 256) and t (T, 256). Chunk i of every tile that has one runs as
    one batched step, `tile_batch` tiles at a time to bound memory.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    device = rows.device
    num_tiles = tiles_x * tiles_y
    px, py = tile_pixel_coords(tiles_x, tiles_y, device)
    start = tile_start.to(torch.int64)
    end = start + tile_count.to(torch.int64)
    first = start // CHUNK
    n_chunks = torch.where(tile_count > 0, (end + CHUNK - 1) // CHUNK - first, 0)
    acc = rows.new_zeros((num_tiles, NPIX, 4))
    t_out = rows.new_ones((num_tiles, NPIX))
    lanes = torch.arange(CHUNK, device=device)

    def exclusive_sum(x):
        return torch.cat([torch.zeros_like(x[:, :1]),
                          torch.cumsum(x, dim=1)[:, :-1]], dim=1)

    for i in range(int(n_chunks.max()) if num_tiles else 0):
        for act in torch.nonzero(n_chunks > i).squeeze(1).split(tile_batch):
            pos = (first[act, None] + i) * CHUNK + lanes              # (A, K)
            valid = (pos >= start[act, None]) & (pos < end[act, None])
            feat = rows[:F_ACTIVE, torch.where(valid, pos, 0)]        # (F, A, K)
            feat = torch.where(valid[None], feat, torch.zeros_like(feat))
            mx, my, ca, cb, cc, op = (feat[r][..., None] for r in
                                      (R_MX, R_MY, R_CA, R_CB, R_CC, R_O))
            dx = px[act][:, None, :] - mx                             # (A, K, P)
            dy = py[act][:, None, :] - my
            power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            w = _mode_weights(mode, power, op, valid[..., None], exclusive_sum)
            col = feat[R_R:R_D + 1].permute(1, 2, 0)                  # (A, K, 4)
            acc[act] += torch.einsum("akp,akc->apc", w, col)
            t_out[act] = t_out[act] - 0.0 * w.sum(dim=1)
    return acc.permute(0, 2, 1).contiguous(), t_out


def composite_ablate(rows: torch.Tensor, tile_start: torch.Tensor,
                     tile_count: torch.Tensor, tiles_x: int, tiles_y: int,
                     mode: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Ablation variant `mode` of the forward loop, for timing only.

    Arguments as `composite.composite_fwd`. Returns colour+depth
    (T, 4, 256) and t (T, 256). CUDA tensors launch
    `csrc/composite_ablate.cu`, CPU tensors run `composite_ablate_plain`.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    composite.check_inputs(rows, tile_start, tile_count, tiles_x, tiles_y)
    if rows.device.type == "cpu":
        return composite_ablate_plain(rows, tile_start, tile_count, tiles_x,
                                      tiles_y, mode)
    out = composite.launch_tiles("composite_ablate", rows, tile_start,
                                 tile_count, tiles_x, tiles_y, MODES.index(mode))
    launches[mode] += 1
    return out


def composite_fwd_fori(rows: torch.Tensor, tile_start: torch.Tensor,
                       tile_count: torch.Tensor, tiles_x: int, tiles_y: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward compositing with its early exit as a compute skip.

    Arguments and outputs as `composite.composite_fwd` (not
    differentiable). CUDA tensors launch `csrc/composite_fwd.cu`'s kernel
    without its block exit (`composite_fwd_fori_launch`), in the forward's
    launch order; CPU tensors run `tiles.composite_tiles_plain`.
    """
    composite.check_inputs(rows, tile_start, tile_count, tiles_x, tiles_y)
    if rows.device.type == "cpu":
        return composite_tiles_plain(rows, tile_start, tile_count, tiles_x,
                                     tiles_y)
    out = composite.launch_tiles("composite_fwd_fori", rows, tile_start,
                                 tile_count, tiles_x, tiles_y,
                                 order=composite.tile_order(tile_count))
    launches["fori"] += 1
    return out


def composite_fwd_variant(rows: torch.Tensor, tile_start: torch.Tensor,
                          tile_count: torch.Tensor, tiles_x: int, tiles_y: int,
                          name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward compositing without the piece `name` of its loop (one of
    `VARIANTS`), for timing only.

    Arguments and outputs as `composite.composite_fwd` (not
    differentiable); the function is the forward's, bit for bit. CUDA
    tensors launch `csrc/composite_fwd.cu`'s kernel without that piece
    (`composite_fwd_variant_launch`) in the forward's launch order, or for
    "index_order" the forward's kernel with the tiles in index order; CPU
    tensors run `tiles.composite_tiles_plain`.
    """
    if name not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {name!r}")
    composite.check_inputs(rows, tile_start, tile_count, tiles_x, tiles_y)
    if rows.device.type == "cpu":
        return composite_tiles_plain(rows, tile_start, tile_count, tiles_x,
                                     tiles_y)
    if name == "index_order":
        out = composite.launch_tiles(
            "composite_fwd", rows, tile_start, tile_count, tiles_x, tiles_y,
            order=torch.arange(tiles_x * tiles_y, dtype=torch.int32,
                               device=rows.device))
    else:
        out = composite.launch_tiles(
            "composite_fwd_variant", rows, tile_start, tile_count, tiles_x,
            tiles_y, _KERNEL_VARIANT[name],
            order=composite.tile_order(tile_count))
    launches[name] += 1
    return out


def kernel_info(name: str) -> dict:
    """`composite.kernel_info` of the kernel that ablation mode or forward
    variant `name` launches, on the current card."""
    if name in MODES:
        return composite.kernel_info("composite_ablate", MODES.index(name))
    if name == "index_order":
        return composite.kernel_info("composite_fwd")
    return composite.kernel_info("composite_fwd_variant", _KERNEL_VARIANT[name])


def _workload(args):
    device = resolve_device(args.device)
    _, _, bins, rows, tx, ty = toy_workload(args.n, args.size,
                                            args.max_instances, device)
    return device, (rows, bins.tile_start, bins.tile_count, tx, ty)


def modes(args) -> dict:
    """Each mode's median ms on the workload; returns {mode: ms}."""
    device, inputs = _workload(args)
    out = {}
    with torch.no_grad():
        for mode in MODES:
            out[mode] = timed(lambda: composite_ablate(*inputs, mode), device)
            print(f"{mode:22s}: {out[mode]:7.3f} ms")
    return out


def real_variants(args) -> dict:
    """fori and each variant against the forward kernel on the workload,
    timed in turns (variant, forward, forward, variant; the mean of each
    pair of medians), with the largest difference of each from the
    forward's output, and `tile_order` alone. Returns {"variants": {name:
    {"ms", "fwd_ms", "dcolor", "dt"}}, "fori": ms, "while": ms of the
    forward over every turn, "tile_order": ms, "dcolor", "dt": the largest
    over fori and the variants}."""
    device, inputs = _workload(args)
    runs = {"fori": lambda: composite_fwd_fori(*inputs),
            **{v: (lambda v=v: composite_fwd_variant(*inputs, v))
               for v in VARIANTS}}

    def forward():
        return composite.composite_fwd(*inputs)

    out, fwd_all = {"variants": {}}, []
    with torch.no_grad():
        want = forward()
        for name, fn in runs.items():
            times = {name: [], "fwd": []}
            for which in (name, "fwd", "fwd", name):
                times[which].append(timed(fn if which == name else forward,
                                          device))
            got = fn()
            res = {"ms": sum(times[name]) / 2, "fwd_ms": sum(times["fwd"]) / 2,
                   "dcolor": float((got[0] - want[0]).abs().max()),
                   "dt": float((got[1] - want[1]).abs().max())}
            out["variants"][name] = res
            fwd_all += times["fwd"]
            label = "real fori+when" if name == "fori" else f"real {name}"
            print(f"{label:22s}: {res['ms']:7.3f} ms (forward in turns "
                  f"{res['fwd_ms']:7.3f} ms), max |dcolor| {res['dcolor']}, "
                  f"max |dt| {res['dt']}")
        out["tile_order"] = timed(lambda: composite.tile_order(inputs[2]), device)
    out["fori"] = out["variants"]["fori"]["ms"]
    out["while"] = sorted(fwd_all)[len(fwd_all) // 2]
    out["dcolor"] = max(r["dcolor"] for r in out["variants"].values())
    out["dt"] = max(r["dt"] for r in out["variants"].values())
    print(f"{'real while_loop':22s}: {out['while']:7.3f} ms")
    print(f"{'tile_order (argsort)':22s}: {out['tile_order']:7.3f} ms")
    print("max |dcolor|:", out["dcolor"], "max |dt|:", out["dt"])
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("which", nargs="?", choices=("real",),
                   help="'real': fori and the variants against the forward "
                        "kernel")
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--size", type=int, default=800)
    p.add_argument("--max_instances", type=int, default=2 ** 20)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    return real_variants(args) if args.which == "real" else modes(args)


if __name__ == "__main__":
    main()
