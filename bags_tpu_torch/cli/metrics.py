"""Metrics CLI of the port: offline PSNR, SSIM and LPIPS over rendered image
directories. Port of the root `metrics.py`.

    python -m bags_tpu_torch.cli.metrics -m MODEL [MODEL ...] [--device cpu]

Walks `MODEL/{test,train}/<method>/{renders,gt}` (the render CLI's output),
computes per-view and mean metrics and writes `results.json` and
`per_view.json` with the JAX CLI's keys. LPIPS uses the vgg backbone, as
the reference's offline metrics do, from local weights only
(`BAGS_TPU_LPIPS_WEIGHTS`, `eval/metrics.Lpips`); without them it is
written as "n/a (no weights)". Runs on `--device cuda` (the default) or
`--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

LPIPS_NA = "n/a (no weights)"


def load_image(path: str, device) -> torch.Tensor:
    """An 8-bit image file as (3, H, W) float32 in [0, 1] on `device`."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im, dtype=np.float32) / 255.0
    return torch.as_tensor(arr[..., :3].transpose(2, 0, 1).copy(),
                           device=device)


def main(argv=None) -> dict:
    """Run the CLI; returns {model_path: results} as written."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model_paths", "-m", nargs="+", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..eval.metrics import Lpips, psnr, ssim
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    lpips = Lpips(net="vgg").to(device)
    out = {}
    for model_path in args.model_paths:
        full, per_view = {}, {}
        for split in ("test", "train"):
            split_dir = os.path.join(model_path, split)
            if not os.path.isdir(split_dir):
                continue
            for method in sorted(os.listdir(split_dir)):
                rdir = os.path.join(split_dir, method, "renders")
                gdir = os.path.join(split_dir, method, "gt")
                if not (os.path.isdir(rdir) and os.path.isdir(gdir)):
                    continue
                names = sorted(os.listdir(rdir))
                psnrs, ssims, lpipss = [], [], []
                with torch.no_grad():
                    for name in names:
                        r = load_image(os.path.join(rdir, name), device)
                        g = load_image(os.path.join(gdir, name), device)
                        psnrs.append(float(psnr(r, g)))
                        ssims.append(float(ssim(r, g)))
                        if lpips.available:
                            lpipss.append(float(lpips(r, g)))
                key = f"{split}/{method}"
                full[key] = {
                    "PSNR": float(np.mean(psnrs)),
                    "SSIM": float(np.mean(ssims)),
                    "LPIPS": float(np.mean(lpipss)) if lpipss else LPIPS_NA,
                }
                per_view[key] = {
                    "PSNR": dict(zip(names, psnrs)),
                    "SSIM": dict(zip(names, ssims)),
                    "LPIPS": dict(zip(names, lpipss)) if lpipss else LPIPS_NA,
                }
                print(f"{model_path} {key}: PSNR {full[key]['PSNR']:.3f} "
                      f"SSIM {full[key]['SSIM']:.4f}")
        with open(os.path.join(model_path, "results.json"), "w") as f:
            json.dump(full, f, indent=2)
        with open(os.path.join(model_path, "per_view.json"), "w") as f:
            json.dump(per_view, f, indent=2)
        out[model_path] = full
    return out


if __name__ == "__main__":
    main()
