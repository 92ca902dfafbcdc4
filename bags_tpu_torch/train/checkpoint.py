"""Checkpoint save / restore of the full training state (port of
`bags_tpu/train/checkpoint.py`).

One `chkpnt{it}.npz` holds every leaf by name. The leaves the JAX package
also has use its names (format v2, `"v2|" + jax.tree_util.keystr(path)`):
`.g.<field>` (`.g.asg` with `--hybrid`), `.alive`, `.cams.<field>`,
`.align.quaternion`, `.align.log_scale`, `.stats.<field>` and `.step`, so
either package reads the other's model, cameras and statistics. A hybrid
state adds its specular MLP (`.spec.feat_w`, ...) and its Adam state, which
has optax's layout, under optax's names (`.spec_opt[0].count`,
`.spec_opt[0].mu.feat_w`, `.spec_opt[0].nu.feat_w`, ...,
`.spec_opt[1].count`, the schedule's count). The other optimizer states and
the generator are the port's own (`"torch|..."` names); the JAX package's
are ignored on load.

A calibrated state (`train/calibrated.py`) writes its base state under
`.base` (`.base.g.xyz`, ...) and its own leaves beside it.

A state sharded over ranks (`dist/trainer.py`) holds one block of the
Gaussian slots: its save gathers the row leaves (`is_row_leaf`) to every
rank and rank 0 writes the same file a single device would, and its load
reads the file and keeps its block (`rows`), so a checkpoint moves between
process counts.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import Callable, Optional

import numpy as np
import torch

from .optim import CAMERA_FIELDS, gaussian_groups
from .loop import TrainState

PREFIX = "v2|"
PORT = "torch|"


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _model_leaves(state: TrainState) -> dict:
    """The leaves named as the JAX package names them, as live tensors."""
    out = {f".g.{k}": t for k, t in state.g.fields().items()}
    out[".alive"] = state.alive
    out.update({f".cams.{f.name}": getattr(state.cams, f.name)
                for f in dataclasses.fields(state.cams)})
    out[".align.quaternion"] = state.align.quaternion
    out[".align.log_scale"] = state.align.log_scale
    out.update({f".stats.{f.name}": getattr(state.stats, f.name)
                for f in dataclasses.fields(state.stats)})
    if state.spec is not None:
        out.update({".spec" + k: t
                    for k, t in state.spec.named_tensors().items()})
    return out


def _spec_opt_leaves(state: TrainState) -> dict:
    """The specular Adam moments under optax's names (no counts)."""
    if state.spec_opt is None:
        return {}
    st = state.spec_opt
    out = {f".spec_opt[0].mu{k}": v for k, v in st.mu.items()}
    out.update({f".spec_opt[0].nu{k}": v for k, v in st.nu.items()})
    return out


def _adam_leaves(prefix: str, opt: torch.optim.Optimizer, names) -> dict:
    out = {}
    for group, name in zip(opt.param_groups, names):
        for i, p in enumerate(group["params"]):
            for k, v in opt.state.get(p, {}).items():
                out[f"{prefix}.{name}.{i}.{k}"] = v
    return out


def _optimizer_leaves(state: TrainState) -> dict:
    out = _adam_leaves("g_opt", state.g_opt,
                       [n for n, _ in gaussian_groups(state.g)])
    out.update(_adam_leaves("align_opt", state.align_opt, ["align"]))
    for f in CAMERA_FIELDS:
        out[f"cam_opt.mu.{f}"] = state.cam_opt.mu[f]
        out[f"cam_opt.nu.{f}"] = state.cam_opt.nu[f]
    out["cam_opt.count"] = state.cam_opt.count
    out["gen"] = state.gen.get_state()
    return out


def is_row_leaf(name: str) -> bool:
    """Whether the leaf `name` (without prefix) has one row per Gaussian
    slot: the Gaussians, alive, the statistics and the Gaussians' Adam
    moments."""
    return name.startswith((".g.", ".alive", ".stats.")) or (
        name.startswith("g_opt.") and not name.endswith(".step"))


def save_checkpoint(path: str, state: TrainState, pre: str = "",
                    extra: Optional[dict] = None,
                    gather: Optional[Callable] = None,
                    write: bool = True) -> None:
    """Write `state`, its JAX-named leaves under `pre` (a calibrated state
    writes its base under ".base") and the arrays of `extra` beside them.
    gather: applied to every row leaf (a sharded state's all-gather, which
    every rank calls); write: whether this process writes the file."""
    model, opt = _model_leaves(state), _optimizer_leaves(state)
    if gather is not None:
        model = {k: gather(v) if is_row_leaf(k) else v for k, v in model.items()}
        opt = {k: gather(v) if is_row_leaf(k) else v for k, v in opt.items()}
    if not write:
        return
    arrays = {PREFIX + pre + k: _host(v) for k, v in model.items()}
    arrays[PREFIX + pre + ".step"] = np.asarray(state.step, np.int32)
    arrays.update({PREFIX + pre + k: _host(v)
                   for k, v in _spec_opt_leaves(state).items()})
    if state.spec_opt is not None:
        for i in (0, 1):
            arrays[f"{PREFIX}{pre}.spec_opt[{i}].count"] = np.asarray(
                state.spec_opt.count, np.int32)
    arrays.update({PORT + k: _host(v) for k, v in opt.items()})
    arrays.update(extra or {})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)


def _restore_adam(prefix: str, opt: torch.optim.Optimizer, names, data,
                  path: str, rows: Optional[slice] = None) -> None:
    for group, name in zip(opt.param_groups, names):
        for i, p in enumerate(group["params"]):
            keys = {k.rsplit(".", 1)[1]: k for k in data.files
                    if k.startswith(f"{PORT}{prefix}.{name}.{i}.")}
            if not keys:
                opt.state.pop(p, None)       # saved before the first step
                continue
            st = {}
            for k, key in keys.items():
                v = torch.as_tensor(data[key])
                if rows is not None and is_row_leaf(key[len(PORT):]):
                    v = v[rows]
                st[k] = v if k == "step" else v.to(p.device)
                if k != "step" and st[k].shape != p.shape:
                    raise ValueError(f"{path}: {key} has shape "
                                     f"{tuple(st[k].shape)}, parameter "
                                     f"{tuple(p.shape)}")
            opt.state[p] = st


def copy_leaves(data, path: str, leaves: dict,
                rows: Optional[slice] = None, pre: str = "") -> None:
    """Copy the arrays `"v2|" + pre + name` of `data` into the tensors of
    `leaves` ({name: tensor}); every one must be there, in its shape. With
    `rows`, a row leaf's block `rows` is copied."""
    missing = [pre + n for n in leaves if PREFIX + pre + n not in data.files]
    if missing:
        raise ValueError(f"checkpoint {path} is missing leaves {missing[:8]}")
    for name, t in leaves.items():
        arr = data[PREFIX + pre + name]
        if rows is not None and is_row_leaf(name):
            arr = arr[rows]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{path}: {name} has shape {arr.shape}, the "
                             f"state {tuple(t.shape)}")
        t.copy_(torch.as_tensor(arr))


@torch.no_grad()
def load_checkpoint(path: str, state: TrainState,
                    with_optimizer: bool = True, pre: str = "",
                    rows: Optional[slice] = None) -> TrainState:
    """Restore `state` in place from `path` and return it. The model,
    camera, alignment and statistics leaves, and a hybrid state's specular
    MLP and its Adam state, must all be present under their JAX names
    (under `pre`), with the template's shapes: a hybrid checkpoint loads
    into a hybrid template. `with_optimizer=False` (for rendering)
    restores only those, so a checkpoint the JAX package wrote loads too.
    rows: a sharded state's block of the Gaussian slots."""
    data = np.load(path)
    copy_leaves(data, path, {**_model_leaves(state), **_spec_opt_leaves(state)},
                rows, pre)
    state.step = int(data[PREFIX + pre + ".step"])
    if state.spec_opt is not None:
        state.spec_opt.count = int(data[f"{PREFIX}{pre}.spec_opt[0].count"])
    if not with_optimizer:
        return state
    if not any(f.startswith(PORT) for f in data.files):
        raise ValueError(f"checkpoint {path} holds no optimizer state of "
                         "this package (written by the JAX package?)")
    _restore_adam("g_opt", state.g_opt,
                  [n for n, _ in gaussian_groups(state.g)], data, path, rows)
    _restore_adam("align_opt", state.align_opt, ["align"], data, path)
    for f in CAMERA_FIELDS:
        state.cam_opt.mu[f].copy_(torch.as_tensor(data[f"{PORT}cam_opt.mu.{f}"]))
        state.cam_opt.nu[f].copy_(torch.as_tensor(data[f"{PORT}cam_opt.nu.{f}"]))
    state.cam_opt.count.copy_(torch.as_tensor(data[f"{PORT}cam_opt.count"]))
    state.gen.set_state(torch.as_tensor(data[f"{PORT}gen"]))
    return state


def find_max_iteration(folder: str, pattern: str = r"iteration_(\d+)") -> int:
    """The largest iteration matching `pattern` in `folder`, or -1."""
    its = [int(m.group(1)) for p in glob.glob(os.path.join(folder, "*"))
           if (m := re.search(pattern, os.path.basename(p)))]
    return max(its) if its else -1
