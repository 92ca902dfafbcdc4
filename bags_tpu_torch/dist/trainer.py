"""`ShardedTrainer`, the training loop over `torch.distributed` ranks, and
`init_distributed` (port of `bags_tpu/dist/trainer.py`).

  * Each step runs tile-parallel (`sharded.sharded_train_step`): rank r
    holds the Gaussian slots of `mesh.row_block` with their Adam moments,
    alive mask and densify statistics, and renders its slab of tile rows
    against its rows of the GT, zero-padded to `mesh.padded_height`.
  * Densify, opacity reset and MCMC relocation and noise run under the
    mesh: the JAX package runs its single-device functions through GSPMD;
    here every rank all-gathers the population, runs the port's
    single-device function (`train/loop.py`) with its generator, which is
    seeded and advanced identically on every rank, and keeps its own
    block. The replicated state stays the same on every rank.
  * Checkpoints: a save gathers the row leaves and rank 0 writes the
    single-device file (`train/checkpoint.py`); a load keeps this rank's
    block, so checkpoints move between process counts.

`ShardedCalibTrainer` (`bags_tpu/dist/trainer.py:179`) is `CalibTrainer`
over the same blocks: the fisheye and cubemap modes with the steps of
`dist/calib.py`, the lens or cubemap net pre-fitted on every rank and
rank 0's broadcast, and calibrated checkpoints that move between process
counts and to and from `CalibTrainer`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.camera import CameraStatic
from ..model.densify import DensifyResult, DensifyStats, zero_moments_at
from ..model.gaussians import Gaussians
from ..raster.render import RenderConfig
from ..train.calibrated import (CalibTrainer, load_calib_checkpoint,
                                save_calib_checkpoint)
from ..train.checkpoint import load_checkpoint, save_checkpoint
from ..train.config import TrainConfig
from ..train.loop import (StepMetrics, Trainer, densify_population,
                          mcmc_noise_step, relocate_population)
from .calib import (fisheye_gt_rows, sharded_cubemap_step,
                    sharded_fisheye_step)
from .mesh import (all_gather_rows, all_reduce_sum, broadcast_, padded_height,
                   rank_world, row_block)
from .sharded import sharded_train_step


def init_distributed(device, mesh: int) -> tuple[torch.device, bool]:
    """Join the process group of `--mesh N` training, starting it where
    none exists (`init_distributed`, trainer.py:46): under torchrun
    (RANK / WORLD_SIZE / LOCAL_RANK in the environment) from the
    environment, on the card LOCAL_RANK; without them and with N = 1, a
    world of one on a TCP store of this process on localhost. NCCL for a
    CUDA device, gloo for the CPU. N must be the world size. Returns (the
    device this rank trains on, whether this call started the group: its
    caller then ends it with `dist.destroy_process_group()`)."""
    device = torch.device(device)
    started = not dist.is_initialized()
    if started:
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            if device.type == "cuda":
                device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
                torch.cuda.set_device(device)
            dist.init_process_group(backend)
        elif mesh == 1:
            store = dist.TCPStore("127.0.0.1", 0, world_size=1, is_master=True)
            dist.init_process_group(backend, store=store, rank=0, world_size=1)
        else:
            raise RuntimeError(
                f"--mesh {mesh} runs one process per rank: start it with "
                f"torchrun --nproc_per_node {mesh} -m bags_tpu_torch.cli.train")
    if dist.get_world_size() != mesh:
        raise ValueError(f"--mesh {mesh} but the process group has "
                         f"{dist.get_world_size()} ranks")
    return device, started


class ShardedTrainer(Trainer):
    """`Trainer` over the ranks of the default process group (`--mesh N`):
    the same cadences, camera order and checkpoints, this rank holding its
    block of the population. `g` and `alive` are the whole population
    (capacity divisible by the world size); the trainer keeps its block."""

    def __init__(self, g: Gaussians, alive, cams, static: CameraStatic,
                 cfg: TrainConfig, scene_extent: float, gt_images, bg=None,
                 rcfg: Optional[RenderConfig] = None, seed: int = 0):
        if not dist.is_initialized():
            raise RuntimeError("ShardedTrainer needs a process group "
                               "(dist/trainer.init_distributed)")
        self.rank, self.world = rank_world()
        self.full_capacity = int(alive.shape[0])
        self.rows = row_block(self.full_capacity, self.rank, self.world)
        self.pad_height = padded_height(static.height, self.world)
        block = Gaussians(**{k: v[self.rows].detach().clone()
                             for k, v in g.fields().items()})
        super().__init__(block, alive[self.rows].clone(), cams, static, cfg,
                         scene_extent, gt_images, bg=bg, rcfg=rcfg, seed=seed)

    def slab(self, gt: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a GT ((3, H, W) or (K, 3, H, W)) zero-padded
        to `pad_height` rows (`_pad_gt`, trainer.py:115)."""
        pad = self.pad_height - gt.shape[-2]
        if pad:
            gt = F.pad(gt, (0, 0, 0, pad))
        hl = self.pad_height // self.world
        return gt[..., self.rank * hl:(self.rank + 1) * hl, :]

    def step(self, idx, gt: torch.Tensor, it: Optional[int] = None
             ) -> StepMetrics:
        rcfg = dataclasses.replace(self.rcfg, sh_degree=self.active_sh_degree)
        return sharded_train_step(self.state, self.slab(gt), idx, self.bg,
                                  self.static, rcfg, self.cfg)

    # -- the population transforms on the whole population ---------------

    def n_alive(self) -> int:
        n = self.base.alive.sum().to(torch.float64).reshape(1)
        all_reduce_sum([n])
        return int(n[0])

    @torch.no_grad()
    def _gather(self):
        """(Gaussians, alive, statistics) of the whole population."""
        st = self.base
        g = Gaussians(**{k: all_gather_rows(v) for k, v in st.g.fields().items()})
        stats = DensifyStats(*(all_gather_rows(getattr(st.stats, f))
                               for f in ("grad_accum", "grad_accum_abs",
                                         "denom", "max_radii2d")))
        return g, all_gather_rows(st.alive), stats

    @torch.no_grad()
    def _keep(self, g: Gaussians, alive: torch.Tensor, reset: torch.Tensor
              ) -> None:
        """Keep this rank's block of a transformed population: its rows
        into the leaves, its alive mask, its Adam moments zeroed at the
        reset rows."""
        st = self.base
        for k, t in st.g.fields().items():
            t.copy_(getattr(g, k)[self.rows])
        st.alive = alive[self.rows].clone()
        zero_moments_at(st.g_opt, reset[self.rows])

    def densify(self, max_screen: float) -> DensifyResult:
        g, alive, stats = self._gather()
        res = densify_population(g, alive, stats, self.base.gen, self.cfg,
                                 self.scene_extent, max_screen)
        self._keep(g, res.alive, res.reset_mask)
        self.base.stats = DensifyStats.zeros(self.base.capacity,
                                             self.base.alive.device)
        return res

    def relocate(self):
        g, alive, _ = self._gather()
        alive, reset, n_rel, n_add = relocate_population(
            g, alive, self.base.gen, self.cfg)
        self._keep(g, alive, reset)
        return n_rel, n_add

    def add_noise(self) -> None:
        st = self.base
        eps = torch.randn((self.full_capacity, 3), generator=st.gen,
                          device=st.gen.device)
        mcmc_noise_step(st, self.cfg, eps=eps[self.rows])

    def population(self):
        g, alive, _ = self._gather()
        return g, alive

    # -- checkpoints ----------------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        """Every rank gathers; rank 0 writes the single-device file."""
        save_checkpoint(path, self.state, gather=all_gather_rows,
                        write=self.rank == 0)

    def load_checkpoint(self, path: str, with_optimizer: bool = True) -> None:
        load_checkpoint(path, self.state, with_optimizer, rows=self.rows)


class ShardedCalibTrainer(CalibTrainer, ShardedTrainer):
    """`CalibTrainer` over the ranks of the default process group (`--mesh N`
    with `--outside_rasterizer` or `--cubemap`; `ShardedCalibTrainer`,
    trainer.py:179): `CalibTrainer`'s setup, CalibState, schedules, lens
    window, pre-fits and evaluation around `ShardedTrainer`'s row blocks,
    population transforms and GT slabs (the base classes in this order,
    so `CalibTrainer.__init__` builds its state on `ShardedTrainer`'s). Every
    rank pre-fits the lens or cubemap net and then takes rank 0's
    (broadcast), so the replicated nets are alike bit for bit.

    The fisheye step's GT is sharded by fisheye output rows, zero-padded to
    D ceil(fh / D) rows; with `--apply2gt` every rank takes it whole. The
    cubemap step's GT is sharded as the pose path's. `--batch_cams > 1`
    raises (trainer.py:205-207). Checkpoints are `CalibTrainer`'s file,
    written by rank 0 from the gathered blocks, so they interchange with
    `CalibTrainer` and any process count."""

    def __init__(self, g, alive, cams, static, cfg: TrainConfig,
                 scene_extent: float, gt_images, focal_x: float,
                 focal_y: float, persp_wh, fish_wh=None, source_path: str = "",
                 bg=None, rcfg: Optional[RenderConfig] = None, seed: int = 0,
                 fish_images=None):
        if cfg.opt.batch_cams > 1:
            raise ValueError("--batch_cams > 1 is not supported with the "
                             "sharded fisheye/cubemap calibrated modes")
        super().__init__(g, alive, cams, static, cfg, scene_extent, gt_images,
                         focal_x, focal_y, persp_wh, fish_wh=fish_wh,
                         source_path=source_path, bg=bg, rcfg=rcfg, seed=seed,
                         fish_images=fish_images)
        net = self.state.cubemap_net if self.mode == "cubemap" else self.state.lens
        broadcast_(list(net.named_tensors().values()))

    def step(self, idx: int, gt: torch.Tensor, it: Optional[int] = None
             ) -> StepMetrics:
        rcfg = dataclasses.replace(self.rcfg, sh_degree=self.active_sh_degree)
        if self.mode == "cubemap":
            return sharded_cubemap_step(
                self.state, self.slab(gt), idx, self.bg, self.sub_q[idx],
                self.sub_t[idx], self.setup, rcfg, self.cfg, self.schedules)
        opt_lens, use_vig = self.lens_window(
            self.base.step + 1 if it is None else it)
        return sharded_fisheye_step(
            self.state, fisheye_gt_rows(gt, self.cfg.calib.apply2gt),
            self.p_view, idx, self.bg,
            self.setup, rcfg, self.cfg, self.schedules, opt_lens, use_vig)

    def save_checkpoint(self, path: str) -> None:
        """Every rank gathers; rank 0 writes `CalibTrainer`'s file."""
        save_calib_checkpoint(path, self.state, gather=all_gather_rows,
                              write=self.rank == 0)

    def load_checkpoint(self, path: str, with_optimizer: bool = True) -> None:
        load_calib_checkpoint(path, self.state, with_optimizer, rows=self.rows)
