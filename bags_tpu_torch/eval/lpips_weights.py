"""Loader for the official LPIPS weight files (port of
`bags_tpu/eval/lpips_weights.py`).

The reference evaluates LPIPS by downloading two torch checkpoints at run
time: the torchvision backbone (`vgg16-397923af.pth` or
`alexnet-owt-*.pth`) and the richzhang LPIPS v0.1 linear calibration
(`vgg.pth` / `alex.pth`). Nothing is downloaded here: drop the two
untouched upstream files in one directory and pass it as `weights_path` of
`eval/metrics.Lpips` (or `BAGS_TPU_LPIPS_WEIGHTS`):

    some_dir/
      vgg16-397923af.pth   # torchvision backbone (any vgg16*.pth)
      vgg.pth              # LPIPS v0.1 linear weights

The files are read with `torch.load(..., weights_only=True)`, PyTorch's
restricted unpickler: it reads the zip format (torch >= 1.6) and the legacy
format of the 2017-era release files, and refuses any class beyond what a
plain state dict needs. `map_location="cpu"` because a reference checkpoint
stores CUDA storages. Tensors come back as numpy arrays (0-d tensors as
numpy scalars, bfloat16 as float32), converted to the npz layout that
`Lpips` executes (`tools/convert_lpips.py` documents it).
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _to_numpy(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        arr = t.numpy()
        return arr[()] if arr.ndim == 0 else np.ascontiguousarray(arr)
    if isinstance(obj, dict):
        return type(obj)((k, _to_numpy(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def load_torch_object(path: str):
    """Load any plain torch .pth pickle (nested dicts / lists / tuples of
    tensors and scalars) with tensors as numpy arrays. Zip and legacy
    formats; classes beyond what a plain checkpoint needs are refused."""
    return _to_numpy(torch.load(path, map_location="cpu", weights_only=True))


def load_torch_pth(path: str) -> dict:
    """Load a torch .pth state dict as a flat dict of numpy arrays (entries
    that are not arrays, 0-d tensors among them, are left out)."""
    obj = load_torch_object(path)
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a state dict, got {type(obj)}")
    return {str(k): v for k, v in obj.items() if isinstance(v, np.ndarray)}


# Backbone structure tables, as torchvision's vgg16().features and
# alexnet().features are instantiated by the reference's LPIPS module:
#   VGG16: 13 3x3/s1/p1 convs, 2x2/s2 max-pools, taps at the five ReLUs
#     conv1_2, 2_2, 3_3, 4_3, 5_3;
#   AlexNet-OWT: 5 convs (11x11/s4/p2, 5x5/s1/p2, then 3x3/s1/p1), 3x3/s2
#     max-pools after the first two ReLUs, all five ReLUs tapped.

VGG16_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
_POOL_AFTER_CONV = [1, 3, 6, 9]          # pool before conv i+1
_TAPS = {1: 0, 3: 1, 6: 2, 9: 3, 12: 4}  # conv_i -> lpips layer k

ALEX_CONV_IDX = [0, 3, 6, 8, 10]
ALEX_STRIDES = [4, 1, 1, 1, 1]
ALEX_PADS = [2, 2, 1, 1, 1]
_ALEX_POOL_AFTER_CONV = [0, 1]           # MaxPool(3, 2) after these ReLUs


def convert_state_dicts(backbone_sd: dict, lin_sd: dict,
                        net: str = "vgg") -> dict:
    """(backbone state dict, lpips-linear state dict) -> the npz layout
    `eval/metrics.Lpips` consumes. `net` selects the backbone structure
    table ('vgg' = torchvision vgg16, 'alex' = alexnet-owt)."""
    if net == "vgg":
        conv_idx, pools, taps = VGG16_CONV_IDX, _POOL_AFTER_CONV, _TAPS
    elif net == "alex":
        conv_idx = ALEX_CONV_IDX
        pools = _ALEX_POOL_AFTER_CONV
        taps = {i: i for i in range(5)}
    else:
        raise ValueError(f"net must be 'vgg' or 'alex', got {net!r}")
    arrays = {}
    for conv_i, feat_idx in enumerate(conv_idx):
        for suffix, out in (("weight", "w"), ("bias", "b")):
            key = f"features.{feat_idx}.{suffix}"
            if key not in backbone_sd:
                raise KeyError(f"backbone file lacks {key} — not a "
                               f"torchvision {net} checkpoint?")
            arrays[f"conv{conv_i}_{out}"] = np.asarray(
                backbone_sd[key], np.float32)
        if net == "alex":
            # non-default conv geometry travels in the bundle (absent keys
            # mean the VGG defaults: stride 1, SAME padding, 2x2/s2 pools)
            arrays[f"conv{conv_i}_stride"] = np.asarray(ALEX_STRIDES[conv_i])
            arrays[f"conv{conv_i}_pad"] = np.asarray(ALEX_PADS[conv_i])
    for conv_i in pools:
        if net == "alex":
            arrays[f"pool_after_{conv_i}_k"] = np.asarray(3)
            arrays[f"pool_after_{conv_i}_s"] = np.asarray(2)
        else:
            arrays[f"pool_after_{conv_i}"] = np.asarray(1)
    for conv_i, k in taps.items():
        arrays[f"tap_{conv_i}"] = np.asarray(k)
    for k in range(5):
        for key in (f"lin{k}.model.1.weight", f"lin.{k}.model.1.weight",
                    f"{k}.1.weight"):
            if key in lin_sd:
                break
        else:
            raise KeyError(
                f"no linear weight for tap {k} in {sorted(lin_sd)[:6]} — "
                f"not an LPIPS v0.1 {net}.pth?")
        arrays[f"lin{k}_w"] = np.asarray(lin_sd[key],
                                         np.float32).reshape(-1)
    return arrays


def load_official_dir(path: str, net: str = None) -> dict:
    """Resolve a directory holding the two untouched upstream files into
    the npz-layout dict: a torchvision backbone (`vgg16*.pth` or
    `alexnet*.pth`) plus the matching LPIPS v0.1 linear file (`vgg.pth` /
    `alex.pth`). `net` picks the pair when both are present (falling back
    to the other pair if it is incomplete); when None, alex is preferred
    (the reference's in-loop default) if its files exist."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".pth"))
    pairs = {
        "alex": (next((f for f in files if f.startswith("alexnet")), None),
                 "alex.pth" if "alex.pth" in files else None),
        "vgg": (next((f for f in files if f.startswith("vgg16")), None),
                next((f for f in files
                      if f == "vgg.pth" or
                      (not f.startswith(("vgg16", "alexnet"))
                       and f != "alex.pth")), None)),
    }
    order = ["alex", "vgg"]
    if net in pairs:
        order.remove(net)
        order.insert(0, net)
    for cand in order:
        backbone, lin = pairs[cand]
        if backbone and lin:
            return convert_state_dicts(
                load_torch_pth(os.path.join(path, backbone)),
                load_torch_pth(os.path.join(path, lin)), net=cand)
    raise FileNotFoundError(
        f"{path}: need a torchvision backbone (vgg16*.pth / alexnet*.pth) "
        f"plus its LPIPS v0.1 linear file (vgg.pth / alex.pth); "
        f"found {files}" + (f" for net={net}" if net else ""))
