"""Configuration dataclasses (a copy of `bags_tpu/train/config.py`, so that
a `cfg.json` written by either package loads in the other).

Mirrors the reference's reflection-based argparse groups
(its `arguments/__init__.py:47-98` ModelParams /
PipelineParams / OptimizationParams) and the ~40 ad-hoc train.py flags
(`train.py:687-748`), with identical defaults, as plain dataclasses that
serialize to/from JSON (replacing the `cfg_args` eval-of-literal persistence,
arguments/__init__.py:100-120).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


@dataclasses.dataclass
class ModelConfig:
    """`ModelParams` (arguments/__init__.py:47-65)."""

    sh_degree: int = 3
    asg_degree: int = 24
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    eval: bool = False
    cap_max: int = -1          # static capacity; -1 -> auto (4x init points)
    init_type: str = "sfm"
    num_init_points: int = 100_000  # random-init population (the reference
    #   hardcodes 100k, dataset_readers.py:288; tunable here for small scenes)


@dataclasses.dataclass
class PipelineConfig:
    """`PipelineParams` (arguments/__init__.py:67-72)."""

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclasses.dataclass
class OptimizationConfig:
    """`OptimizationParams` (arguments/__init__.py:74-98) — exact defaults."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    abs_densify_grad_threshold: float = 0.0004
    # K training views per iteration (1 = reference semantics). K > 1
    # renders/backprops K cameras per step: Gaussian grads average over
    # views, every sampled camera takes one Adam step, densify stats
    # accumulate per view — a larger batch that amortizes fixed per-step
    # cost on TPU. Cadences (densify/eval/SH ramp) stay per ITERATION.
    batch_cams: int = 1
    # MCMC variant (3DGS-MCMC) regularizers (arguments/__init__.py:95-97)
    noise_lr: float = 5e5
    scale_reg: float = 0.01
    opacity_reg: float = 0.01
    # Specular MLP schedule horizon (arguments/__init__.py:81)
    specular_lr_max_steps: int = 30_000


@dataclasses.dataclass
class CalibConfig:
    """Camera-calibration flags (train.py:707-748)."""

    opt_cam: bool = False
    opt_intrinsic: bool = False
    r_t_lr: Tuple[float, float] = (0.01, 0.01)
    fov_lr: float = 0.01                       # scene/__init__.py:181-186
    global_alignment_lr: float = 0.01
    opt_global_alignment: bool = False
    r_t_noise: Tuple[float, float] = (0.0, 0.0)
    fov_noise: float = 1.0                     # log-normal scale (1.0 = none)
    pose_lr_milestones: Tuple[int, int] = (7000, 30000)  # MultiStepLR x0.5
    pose_lr_gamma: float = 0.5
    opt_distortion: bool = False
    opt_shift: bool = False
    outside_rasterizer: bool = False
    apply2gt: bool = False
    cubemap: bool = False
    start_vignetting: int = 10_000_000_000
    start_opt_lens: int = 1
    iresnet_lr: float = 1e-7
    iresnet_opt_duration: Tuple[int, int] = (0, 30000)
    flow_scale: Tuple[float, float] = (1.0, 1.0)
    render_resolution: float = 1.0
    control_point_sample_scale: float = 8.0
    extend_scale: float = 2.0
    no_distortion_mask: bool = False
    if_circular_mask: bool = False
    mask_radius: int = 512
    no_init_iresnet: bool = False
    hybrid: bool = False                        # specular ASG color
    # gather-free banded lens warp under --precision fast (utils/image.
    # banded_warp); False forces the f32 gather warp in all modes
    banded_warp: bool = True


@dataclasses.dataclass
class TrainConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    pipe: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    opt: OptimizationConfig = dataclasses.field(default_factory=OptimizationConfig)
    calib: CalibConfig = dataclasses.field(default_factory=CalibConfig)
    abs_grad: bool = False                      # train.py:729
    opacity_threshold: float = 0.005            # train.py:744
    mcmc: bool = False
    random_init_pc: bool = False
    test_iterations: Tuple[int, ...] = (7000, 30000)
    save_iterations: Tuple[int, ...] = (7000, 30000)
    checkpoint_iterations: Tuple[int, ...] = (7000, 15000, 30000)
    max_instances: int = 2 ** 20
    # Grow max_instances (recompile) when a step reports dropped instances,
    # instead of silently degrading. The CUDA reference resizes its instance
    # buffers dynamically per frame; under XLA static shapes this is the
    # equivalent: bump the budget one ladder step and re-jit.
    auto_capacity: bool = True
    seed: int = 0
    mesh: int = 0                               # N-device tile-parallel mesh
    # Pallas compositing precision: "fast" = single-pass bf16 MXU scans with
    # f32 accumulation (training default; quality delta in README),
    # "exact" = CUDA-parity f32 via 3x-bf16 splits (RenderConfig.precision).
    precision: str = "fast"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "TrainConfig":
        d = json.loads(text)

        def build(cls, sub):
            fields = {f.name: f for f in dataclasses.fields(cls)}
            kw = {}
            for k, v in sub.items():
                if k not in fields:
                    continue
                if isinstance(v, list):
                    v = tuple(v)
                kw[k] = v
            return cls(**kw)

        return TrainConfig(
            model=build(ModelConfig, d.get("model", {})),
            pipe=build(PipelineConfig, d.get("pipe", {})),
            opt=build(OptimizationConfig, d.get("opt", {})),
            calib=build(CalibConfig, d.get("calib", {})),
            **{k: (tuple(v) if isinstance(v, list) else v)
               for k, v in d.items()
               if k not in ("model", "pipe", "opt", "calib")},
        )
