"""Named training presets replacing the reference's launch-script zoo (a copy
of `bags_tpu/train/presets.py`).

The reference encodes canonical hyperparameters in ~25 shell scripts
(`training_script/`, `script/`, `script_cvpr/`, `high_resolution.sh`;
SURVEY.md §2.1). Here each workload family is a named preset of CLI
arguments for `train.py --preset <name>` (explicit flags still override).

Sources (README.md:86-131 + script_cvpr):
  * vanilla            — stock 3DGS reconstruction
  * pose_noise         — NeRF-Synthetic + injected pose noise, pose opt
  * pose_intrinsics    — pose + FoV optimization
  * fisheye            — single-planar fisheye, iResNet distortion,
                         apply-to-render direction
  * fisheye_apply2gt   — distortion applied to the GT instead
  * fisheye_mcmc       — fisheye with the MCMC densifier
  * cubemap            — >180° FoV five-face training
  * eyeful / smerf     — large real captures, apply2gt direction
"""

PRESETS = {
    "vanilla": [
        "--iterations", "30000",
    ],
    # README.md:86-94 (lego w/ noise 0.15/0.15)
    "pose_noise": [
        "--r_t_noise", "0.15", "0.15", "1.0",
        "--r_t_lr", "0.01", "0.02",
        "--iterations", "30000", "--eval", "--opt_cam",
        "--init_type", "random",
    ],
    "pose_intrinsics": [
        "--r_t_noise", "0.15", "0.15", "1.1",
        "--r_t_lr", "0.01", "0.02",
        "--iterations", "30000", "--eval", "--opt_cam", "--opt_intrinsic",
        "--init_type", "random",
    ],
    # README.md:111-123 (cube scene)
    "fisheye": [
        "--r_t_lr", "0.002", "0.002",
        "--control_point_sample_scale", "16",
        "--opt_distortion", "--outside_rasterizer",
        "--flow_scale", "2.0", "2.0",
        "--iresnet_lr", "1e-7",
        "--opacity_reset_interval", "100000",
        "--densify_until_iter", "100000",
        "--iresnet_opt_duration", "0", "7000",
        "--iterations", "30000", "--eval",
    ],
    "fisheye_apply2gt": [
        "--r_t_lr", "0.002", "0.002",
        "--control_point_sample_scale", "16",
        "--opt_distortion", "--outside_rasterizer", "--apply2gt",
        "--flow_scale", "2.0", "2.0",
        "--iresnet_lr", "1e-7",
        "--opacity_reset_interval", "100000",
        "--densify_until_iter", "100000",
        "--iterations", "30000", "--eval",
    ],
    "fisheye_mcmc": [
        "--r_t_lr", "0.002", "0.002",
        "--control_point_sample_scale", "16",
        "--opt_distortion", "--outside_rasterizer",
        "--flow_scale", "2.0", "2.0",
        "--iresnet_lr", "1e-7", "--mcmc",
        "--iterations", "30000", "--eval",
    ],
    # README.md:131 (hilbert_largefov, 20k iters)
    "cubemap": [
        "--r_t_lr", "0.002", "0.002",
        "--cubemap", "--no_init_iresnet",
        "--opacity_reset_interval", "20000",
        "--densify_until_iter", "20000",
        "--iresnet_opt_duration", "0", "7000",
        "--control_point_sample_scale", "8",
        "--iresnet_lr", "1e-9", "--mask_radius", "512",
        "--iterations", "20000", "--eval",
    ],
    "eyeful": [
        "--r_t_lr", "0.002", "0.002",
        "--opt_distortion", "--outside_rasterizer", "--apply2gt",
        "--flow_scale", "2.0", "2.0",
        "--iresnet_lr", "1e-7",
        "--iterations", "40000", "--eval",
    ],
    "smerf": [
        "--r_t_lr", "0.002", "0.002",
        "--opt_distortion", "--outside_rasterizer", "--apply2gt",
        "--flow_scale", "2.0", "2.0",
        "--iresnet_lr", "1e-7",
        "--iterations", "40000", "--eval",
    ],
}


def apply_preset(argv: list[str]) -> list[str]:
    """Expand `--preset NAME` into its flag list (explicit flags win since
    argparse takes the last occurrence)."""
    if "--preset" not in argv:
        return argv
    i = argv.index("--preset")
    name = argv[i + 1]
    if name not in PRESETS:
        raise SystemExit(
            f"unknown preset '{name}'; available: {', '.join(PRESETS)}")
    return argv[:i] + PRESETS[name] + argv[i + 2:]
