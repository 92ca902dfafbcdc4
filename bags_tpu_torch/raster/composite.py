"""Tile compositing: the CUDA kernels' wrappers, build and launch counts.

`composite_fwd` is the port of the TPU kernel
`bags_tpu/raster/pallas_raster.py::_fwd_kernel` (via `_composite_fwd_call`)
and `composite_bwd` the port of its backward `_bwd_kernel` (via
`composite_bwd_padded` and `_composite_core_bwd`). For CUDA tensors they
launch the hand-written kernels `bags_tpu_torch/csrc/composite_fwd.cu` and
`csrc/composite_bwd.cu`, or raise; for CPU tensors they run the plain
PyTorch versions `tiles.composite_tiles_plain` and
`tiles.composite_bwd_plain`. They never fall back from a kernel to its plain
version. The profiling tool's kernels (the forward's no-exit twin fori and
its variants without one piece of the loop each in `csrc/composite_fwd.cu`,
the ablation modes in `csrc/composite_ablate.cu`, wrapped in
`bags_tpu_torch/tools/kernablate.py`) are built and launched here too, and
so are the projection's (`csrc/projection.cu`, wrapped in
`core/projection.py`, which calls `load_kernel`).

The kernels are compiled with nvcc for sm_90a into shared libraries with a
plain C entry point, at first use, into `build/` at the repository root (one
nvcc process per source, every source not yet built started together at the
first load; the build tag hashes the source, every header of `csrc/`, which
the sources include, and the flags), and loaded with ctypes. Both
compositing kernels take the tiles in launch order, most instances first
(`tile_order`). On the card `composite_fwd` is
differentiable through `_CompositeFwd`, which computes that order once per
frame for the forward and its backward, whose kernel it launches; on the
CPU autograd differentiates the plain forward. The backward kernel writes
only the slots its tile reaches, so `_launch_bwd` allocates d_rows
zero-filled. `kernel_info` reads a kernel's resident blocks per SM,
registers, shared and local memory on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from .tiles import F_ACTIVE, NPIX, composite_bwd_plain, composite_tiles_plain

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = {"composite_fwd": CSRC / "composite_fwd.cu",
           "composite_bwd": CSRC / "composite_bwd.cu",
           "composite_ablate": CSRC / "composite_ablate.cu",
           "projection": CSRC / "projection.cu"}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
# Flags of one source beside NVCC_FLAGS: the projection rounds every
# product and sum on its own, as PyTorch's separate elementwise kernels do.
SOURCE_FLAGS = {"projection": ["-fmad=false"]}

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# rows, row stride, tile_start, tile_count, [tile_order,] tiles_x, num_tiles,
# then the outputs and the stream
_TILES = [_P, _I64, _P, _P, _I, _I, _P, _P, _P]
_ORDERED = [_P, _I64, _P, _P, _P, _I, _I, _P, _P, _P]
# C function -> (source, argument types); each returns a cudaError_t.
_ARGTYPES = {
    "composite_fwd_launch": ("composite_fwd", _ORDERED),
    "composite_fwd_fori_launch": ("composite_fwd", _ORDERED),
    "composite_fwd_info": ("composite_fwd", [_P]),
    "composite_fwd_variant_launch": ("composite_fwd", [_I] + _ORDERED),
    "composite_fwd_variant_info": ("composite_fwd", [_I, _P]),
    "composite_bwd_launch": ("composite_bwd",
                             [_P, _I64, _P, _P, _P, _I, _I] + [_P] * 6),
    "composite_bwd_info": ("composite_bwd", [_P]),
    "composite_ablate_launch": ("composite_ablate", [_I] + _TILES),
    "composite_ablate_info": ("composite_ablate", [_I, _P]),
    # deg, xyz, scales, quats, opacity, sh, K, camera, has_shift, width,
    # height, n, then the outputs (and for the backward the 10 output
    # gradients, the 5 input gradients, the camera partials and their
    # count, the camera gradient) and the stream
    "project_fwd_launch": ("projection",
                           [_I] + [_P] * 5 + [_I, _P, _I, _I, _I, _I64]
                           + [_P] * 3),
    "project_bwd_launch": ("projection",
                           [_I] + [_P] * 5 + [_I, _P, _I, _I, _I, _I64]
                           + [_P] * 16 + [_I64, _P, _P]),
    "project_info": ("projection", [_I, _I, _I, _P]),
}

# Kernel launches made through `composite_fwd` / `composite_bwd` in this
# process.
fwd_launches = 0
bwd_launches = 0

_libs: dict = {}
build_log: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _flags(name: str) -> list:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, [])


def _out_path(name: str) -> Path:
    """The library of source `name`, tagged by the source, every header of
    `csrc/` and the flags, so that editing an included header rebuilds it."""
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:12]}.so"


def build(names=tuple(SOURCES)) -> dict:
    """Compile the kernels `names` (once per source content), one nvcc
    process per source, all started together. Returns {name: .so path};
    `build_log[name]` gets the seconds from the start to that compiler's
    exit and ptxas's register / shared-memory report."""
    outs = {name: _out_path(name) for name in names}
    procs = {}
    start = time.perf_counter()
    for name, out in outs.items():
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    while procs:
        for name, (cmd, tmp, proc) in list(procs.items()):
            if proc.poll() is None:
                continue
            del procs[name]
            stdout, stderr = proc.communicate()
            build_log[name] = (time.perf_counter() - start, stderr)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{stdout}\n{stderr}")
            else:
                os.replace(tmp, outs[name])
        time.sleep(0.02)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load_kernel(symbol: str):
    """The C function `symbol` (a key of `_ARGTYPES`). The first load builds
    every source not yet built, one nvcc process each, all at once, so the
    main path's kernels cost one compile time of set-up, not one each."""
    if symbol not in _libs:
        source, argtypes = _ARGTYPES[symbol]
        lib = ctypes.CDLL(str(build()[source]))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[symbol] = fn
    return _libs[symbol]


def check_inputs(rows, tile_start, tile_count, tiles_x, tiles_y):
    """Raise on rows / tile ranges the kernels do not take."""
    num_tiles = tiles_x * tiles_y
    if rows.dtype != torch.float32 or rows.dim() != 2 or rows.shape[0] < F_ACTIVE:
        raise ValueError(f"rows must be float32 (F >= {F_ACTIVE}, M), got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    for name, x in (("tile_start", tile_start), ("tile_count", tile_count)):
        if x.dtype != torch.int32 or tuple(x.shape) != (num_tiles,):
            raise ValueError(f"{name} must be int32 ({num_tiles},), got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != rows.device:
            raise ValueError(f"{name} on {x.device}, rows on {rows.device}")
    if not (rows.is_contiguous() and tile_start.is_contiguous()
            and tile_count.is_contiguous()):
        raise ValueError("rows, tile_start and tile_count must be contiguous")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"compositing runs on cuda or cpu, not {rows.device}")


def _check_pixels(rows, num_tiles, **tensors):
    """Per-pixel tensors of the backward: float32, contiguous, on the device
    of rows, shaped (T, 4, 256) for colour-like and (T, 256) for the rest."""
    for name, x in tensors.items():
        shape = ((num_tiles, 4, NPIX) if name in ("g_color", "color")
                 else (num_tiles, NPIX))
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != rows.device:
            raise ValueError(f"{name} on {x.device}, rows on {rows.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def tile_order(tile_count: torch.Tensor) -> torch.Tensor:
    """The tiles in launch order, the most instances first: the last wave of
    blocks then holds the short tiles. (T,) int32."""
    return torch.argsort(tile_count, descending=True, stable=True).int()


def launch_tiles(name, rows, tile_start, tile_count, tiles_x, tiles_y, *lead,
                 order=None):
    """Launch the per-tile kernel `name` (arguments as `composite_fwd`,
    after the int arguments `lead`, with the launch order `order` after
    tile_count where the kernel takes one) on the current stream; raise if
    the launch fails. Returns color+depth (T, 4, 256) and t (T, 256)."""
    fn = load_kernel(f"{name}_launch")
    num_tiles = tiles_x * tiles_y
    color = torch.empty((num_tiles, 4, NPIX), dtype=torch.float32,
                        device=rows.device)
    t_final = torch.empty((num_tiles, NPIX), dtype=torch.float32,
                          device=rows.device)
    ordered = () if order is None else (order.data_ptr(),)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*lead, rows.data_ptr(), rows.shape[1], tile_start.data_ptr(),
                 tile_count.data_ptr(), *ordered, tiles_x, num_tiles,
                 color.data_ptr(), t_final.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return color, t_final


def _launch_fwd(rows, tile_start, tile_count, tiles_x, tiles_y, order):
    global fwd_launches
    out = launch_tiles("composite_fwd", rows, tile_start, tile_count, tiles_x,
                       tiles_y, order=order)
    fwd_launches += 1
    return out


def _launch_bwd(rows, tile_start, tile_count, tiles_x, tiles_y, g_color, g_t,
                color, t_final, order=None):
    """The backward kernel; `order` is the forward's `tile_order`, computed
    here where the caller has none."""
    global bwd_launches
    fn = load_kernel("composite_bwd_launch")
    num_tiles = tiles_x * tiles_y
    d_rows = torch.zeros((F_ACTIVE, rows.shape[1]), dtype=torch.float32,
                         device=rows.device)
    if order is None:
        order = tile_order(tile_count)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(rows.data_ptr(), rows.shape[1], tile_start.data_ptr(),
                 tile_count.data_ptr(), order.data_ptr(), tiles_x, num_tiles,
                 g_color.data_ptr(), g_t.data_ptr(), color.data_ptr(),
                 t_final.data_ptr(), d_rows.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"composite_bwd kernel launch failed: cudaError {err}")
    bwd_launches += 1
    return d_rows


def kernel_info(name: str, *lead) -> dict:
    """The resources of kernel `name` ("composite_fwd", "composite_bwd"; with
    the int `lead`, the mode or variant number of "composite_ablate" or
    "composite_fwd_variant") on the current card: resident blocks per SM
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor` at 256 threads a block),
    registers per thread, static shared memory per block (bytes) and local
    memory per thread (bytes; spills)."""
    out = (ctypes.c_int * 4)()
    err = load_kernel(f"{name}_info")(*lead, out)
    if err != 0:
        raise RuntimeError(f"{name}_info failed: cudaError {err}")
    return dict(zip(("blocks_per_sm", "registers", "smem_bytes", "local_bytes"),
                    out))


class _CompositeFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, tile_start, tile_count, tiles_x, tiles_y):
        order = tile_order(tile_count)
        color, t_final = _launch_fwd(rows, tile_start, tile_count, tiles_x,
                                     tiles_y, order)
        ctx.save_for_backward(rows, tile_start, tile_count, order, color,
                              t_final)
        ctx.tiles = (tiles_x, tiles_y)
        return color, t_final

    @staticmethod
    def backward(ctx, g_color, g_t):
        rows, tile_start, tile_count, order, color, t_final = ctx.saved_tensors
        g_color = (torch.zeros_like(color) if g_color is None
                   else g_color.contiguous())
        g_t = torch.zeros_like(t_final) if g_t is None else g_t.contiguous()
        _check_pixels(rows, ctx.tiles[0] * ctx.tiles[1], g_color=g_color,
                      g_t=g_t)
        d_rows = _launch_bwd(rows, tile_start, tile_count, *ctx.tiles,
                             g_color, g_t, color, t_final, order)
        if rows.shape[0] > F_ACTIVE:
            d_rows = torch.cat([d_rows, d_rows.new_zeros(
                (rows.shape[0] - F_ACTIVE, rows.shape[1]))])
        return d_rows, None, None, None, None


def composite_fwd(rows: torch.Tensor, tile_start: torch.Tensor,
                  tile_count: torch.Tensor, tiles_x: int, tiles_y: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Composite each tile's depth-sorted instance rows.

    rows: (F >= 10, M) float32 feature-major instance rows
    (mx my ca cb cc o r g b depth); tile_start / tile_count: (T,) int32.
    Returns color+depth (T, 4, 256) without background and t_final (T, 256).
    """
    check_inputs(rows, tile_start, tile_count, tiles_x, tiles_y)
    if rows.device.type == "cpu":
        return composite_tiles_plain(rows, tile_start, tile_count,
                                     tiles_x, tiles_y)
    return _CompositeFwd.apply(rows, tile_start, tile_count, tiles_x, tiles_y)


def composite_bwd(rows: torch.Tensor, tile_start: torch.Tensor,
                  tile_count: torch.Tensor, tiles_x: int, tiles_y: int,
                  g_color: torch.Tensor, g_t: torch.Tensor,
                  color: torch.Tensor, t_final: torch.Tensor) -> torch.Tensor:
    """Per-instance gradients of the compositing.

    rows, tile_start, tile_count: as `composite_fwd`; color (T, 4, 256) and
    t_final (T, 256): its outputs; g_color, g_t: their cotangents. Returns
    d_rows (10, M) float32 in slot order (mx my ca cb cc o r g b depth).
    """
    check_inputs(rows, tile_start, tile_count, tiles_x, tiles_y)
    _check_pixels(rows, tiles_x * tiles_y, g_color=g_color, g_t=g_t,
                  color=color, t_final=t_final)
    if rows.device.type == "cpu":
        return composite_bwd_plain(rows, tile_start, tile_count, tiles_x,
                                   tiles_y, g_color, g_t, color, t_final)
    return _launch_bwd(rows, tile_start, tile_count, tiles_x, tiles_y,
                       g_color, g_t, color, t_final)
