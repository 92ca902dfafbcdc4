"""Forward compositing: the CUDA kernel's wrapper, build and launch count.

`composite_fwd` is the port of the TPU kernel
`bags_tpu/raster/pallas_raster.py::_fwd_kernel` (via `_composite_fwd_call`).
For a CUDA tensor it launches the hand-written kernel
`bags_tpu_torch/csrc/composite_fwd.cu`, or raises; for a CPU tensor it runs
the plain PyTorch version `tiles.composite_tiles_plain`. It never falls back
from the kernel to the plain version.

The kernel is compiled with nvcc for sm_90a into a shared library with a
plain C entry point, at first use, into `build/` at the repository root,
and loaded with ctypes. Its backward is slice 2 of the port: on the card,
the gradient raises; on the CPU, autograd differentiates the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .tiles import F_ACTIVE, NPIX, composite_tiles_plain

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "composite_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# Kernel launches made through `composite_fwd` in this process.
launches = 0

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build() -> Path:
    """Compile the kernel (once per source content) and return the .so path."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"composite_fwd_{tag}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.composite_fwd_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(rows, tile_start, tile_count, tiles_x, tiles_y):
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


def _launch(rows, tile_start, tile_count, tiles_x, tiles_y):
    global launches
    lib = _load()
    num_tiles = tiles_x * tiles_y
    color = torch.empty((num_tiles, 4, NPIX), dtype=torch.float32,
                        device=rows.device)
    t_final = torch.empty((num_tiles, NPIX), dtype=torch.float32,
                          device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.composite_fwd_launch(
            rows.data_ptr(), rows.shape[1], tile_start.data_ptr(),
            tile_count.data_ptr(), tiles_x, num_tiles, color.data_ptr(),
            t_final.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"composite_fwd kernel launch failed: cudaError {err}")
    launches += 1
    return color, t_final


class _CompositeFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, tile_start, tile_count, tiles_x, tiles_y):
        return _launch(rows, tile_start, tile_count, tiles_x, tiles_y)

    @staticmethod
    def backward(ctx, g_color, g_t):
        raise NotImplementedError("composite backward kernel: slice 2")


def composite_fwd(rows: torch.Tensor, tile_start: torch.Tensor,
                  tile_count: torch.Tensor, tiles_x: int, tiles_y: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Composite each tile's depth-sorted instance rows.

    rows: (F >= 10, M) float32 feature-major instance rows
    (mx my ca cb cc o r g b depth); tile_start / tile_count: (T,) int32.
    Returns color+depth (T, 4, 256) without background and t_final (T, 256).
    """
    _check(rows, tile_start, tile_count, tiles_x, tiles_y)
    if rows.device.type == "cpu":
        return composite_tiles_plain(rows, tile_start, tile_count,
                                     tiles_x, tiles_y)
    if rows.device.type != "cuda":
        raise ValueError(f"composite_fwd runs on cuda or cpu, not {rows.device}")
    return _CompositeFwd.apply(rows, tile_start, tile_count, tiles_x, tiles_y)
