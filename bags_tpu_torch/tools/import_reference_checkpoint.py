"""Import a reference training checkpoint (`chkpnt{it}.pth`) as a PLY model
(port of `tools/import_reference_checkpoint.py`).

The reference saves `torch.save((gaussians.capture(), iteration), ...)`.
This tool reads that file with `eval/lpips_weights.load_torch_object` (the
restricted `torch.load`), takes the 12- or 15-element capture and writes
the model as a `point_cloud.ply` with `model/gaussians.save_ply`, which
both packages and the reference read. The per-camera optimised poses
(`cams_train{it}.pt`) pickle whole modules, which the restricted loader
refuses.

    python -m bags_tpu_torch.tools.import_reference_checkpoint \
        --pth chkpnt30000.pth --out point_cloud.ply [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def capture_to_gaussians(cap, device=None):
    """A reference `gaussians.capture()` tuple -> (Gaussians, alive, active
    SH degree). Handles the 12- and 15-element layouts."""
    from ..model.gaussians import Gaussians
    from ..utils.device import resolve_device

    if len(cap) == 12:
        (sh_deg, xyz, f_dc, f_rest, scaling, rotation, opacity,
         _max_radii, _grad_accum, _denom, _opt, _lr_scale) = cap
    elif len(cap) == 15:
        (sh_deg, xyz, _, _, f_dc, f_rest, scaling, rotation, opacity,
         _, _max_radii, _grad_accum, _denom, _opt, _lr_scale) = cap
    else:
        raise ValueError(f"unrecognized capture tuple of {len(cap)} items")
    dev = resolve_device(device)
    n = np.asarray(xyz).shape[0]

    def t(x, shape):
        return torch.as_tensor(np.asarray(x, np.float32).reshape(shape),
                               device=dev)

    g = Gaussians(xyz=t(xyz, (n, 3)), sh_dc=t(f_dc, (n, 1, 3)),
                  sh_rest=t(f_rest, (n, -1, 3)), scales_log=t(scaling, (n, 3)),
                  quats=t(rotation, (n, 4)), opacity_raw=t(opacity, (n,)))
    return g, torch.ones(n, dtype=torch.bool, device=dev), int(np.asarray(sh_deg))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pth", required=True, help="reference chkpnt{it}.pth file")
    p.add_argument("--out", required=True, help="output .ply path")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..eval.lpips_weights import load_torch_object
    from ..model.gaussians import save_ply

    obj = load_torch_object(args.pth)
    # chkpnt files are (capture tuple, iteration); a bare capture also loads
    if (isinstance(obj, tuple) and len(obj) == 2
            and isinstance(obj[1], (int, np.integer))):
        cap, it = obj
    else:
        cap, it = obj, -1
    g, alive, sh_deg = capture_to_gaussians(cap, args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_ply(args.out, g, alive)
    print(f"imported {int(alive.sum())} Gaussians (iteration {it}, active SH "
          f"degree {sh_deg}) -> {args.out}")


if __name__ == "__main__":
    main()
