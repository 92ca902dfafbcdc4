"""The work of a cubemap training step, on the yardstick of `counts.py`.

A step renders five faces of the live Gaussians, each binned in order of
distance to its camera (`reference/cubemap.py`), runs the cubemap net
forward on the control grid and warps each face through the ray field.
`face_counts` counts one face's pixel-instance pairs on the reference's
projection and its distance-keyed binning; `step_terms` lists the step's
pieces as (FP32 operations, bytes):

- per face: the view's pieces (`counts.view_terms`: projection and SH,
  binning, the forward compositing), the compositing backward and the
  face's loss and its gradient (as `counts.step_terms` counts one loss);
  the projection backward once fused with Adam (`counts.step_terms`), and
  for each further face only its packet gradients read and its
  projection's backward operations;
- the net: each control point through the 5 blocks of 2 -> 512 x 4 -> 2
  forward (the products 2ab a layer, ELU 6 operations a hidden unit) and
  backward (the products twice: the input's and the weights' gradients,
  ELU's derivative 6 a hidden unit); its weights read forward and
  backward and their gradients written; the spectral normalisation's
  power iterations, under a thousandth of the products, are left out;
- the rays: the tan warp and the upsample, 36 operations a pixel each
  way; the rays written (3 floats a pixel) and their gradient read (2);
- per face the warp: the gather as `counts.step_terms` counts the fisheye
  warp (16 operations a pixel and channel each way, the render read and
  the image written each way) and the reprojection, 10 operations a pixel
  each way, the rays read and their gradient written.

Each byte is counted once where a piece could run fused with its
neighbour, as in `counts.py`.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from counts import (OPS_ADAM, OPS_PROJECT_BWD, OPS_SSIM_PX, PACKET_FLOATS,
                    PARAM_FLOATS, Pairs, bwd_bytes, bwd_ops, pair_counts,
                    view_terms)
from reference import cubemap as ref_cube
from reference import render as ref_render

NET_DIMS = (2, 512, 512, 512, 512, 2)
NET_BLOCKS = 5
OPS_ELU = 6
OPS_RAYS_PX = 36
OPS_REPROJECT_PX = 10
OPS_GATHER_PX = 16


def net_params(dims=NET_DIMS, blocks: int = NET_BLOCKS) -> int:
    """Weights and biases of the net."""
    return blocks * sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))


def net_terms(points: int, dims=NET_DIMS, blocks: int = NET_BLOCKS
              ) -> Dict[str, Tuple[int, int]]:
    """The net's forward and backward at `points` control points."""
    prods = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    elu = OPS_ELU * sum(dims[1:-1])
    weights = 4 * net_params(dims, blocks)
    io = 4 * 2 * 2 * points                     # points in, residual out
    return {"net_fwd": (blocks * points * (prods + elu), weights + io),
            "net_bwd": (blocks * points * (2 * prods + elu), 2 * weights + io)}


def ray_terms(width: int, height: int) -> Dict[str, Tuple[int, int]]:
    px = width * height
    return {"rays": (2 * OPS_RAYS_PX * px, 4 * (3 + 2) * px)}


def warp_terms(width: int, height: int) -> Tuple[int, int]:
    """One face's reprojection and gather, forward and backward."""
    px = width * height
    return (2 * 3 * px * OPS_GATHER_PX + 2 * OPS_REPROJECT_PX * px,
            2 * 2 * 3 * 4 * px + 2 * 3 * 4 * px)


def loss_terms(width: int, height: int) -> Tuple[int, int]:
    px = width * height
    return (3 * px * 3 * OPS_SSIM_PX, 3 * 4 * 3 * px)


def step_terms(n_live: int, faces: List[Tuple[Pairs, int, int]], width: int,
               height: int, points: int) -> Dict[str, Tuple[int, int]]:
    """A cubemap step: `faces` the (pairs, instances, tiles) of each face."""
    terms: Dict[str, Tuple[int, int]] = {}
    for i, (pairs, m, nt) in enumerate(faces):
        for k, v in view_terms(n_live, pairs, m, nt).items():
            terms[f"{k}.{i}"] = v
        terms[f"composite_bwd.{i}"] = (bwd_ops(pairs), bwd_bytes(m, nt))
        terms[f"loss.{i}"] = loss_terms(width, height)
        terms[f"warp.{i}"] = warp_terms(width, height)
        if i:
            terms[f"projection_bwd.{i}"] = (OPS_PROJECT_BWD * n_live,
                                            4 * PACKET_FLOATS * n_live)
    terms["projection_bwd_adam"] = (
        (OPS_PROJECT_BWD + OPS_ADAM * PARAM_FLOATS) * n_live,
        4 * (6 * PARAM_FLOATS + PACKET_FLOATS) * n_live)
    terms.update(net_terms(points))
    terms.update(ray_terms(width, height))
    return terms


@torch.no_grad()
def face_counts(params: Dict[str, torch.Tensor], R, t, fovx, fovy, width: int,
                height: int, sh_degree: int) -> Tuple[Pairs, int, int]:
    """(pairs, instances, tiles) of one face of the raw leaves `params`,
    binned by distance to the camera's centre."""
    proj = ref_render.project(
        params["xyz"], torch.exp(params["scales_log"]), params["quats"],
        torch.sigmoid(params["opacity_raw"]),
        torch.cat([params["sh_dc"], params["sh_rest"]], dim=1), R, t, fovx, fovy,
        width, height, sh_degree)
    center = ref_cube.face_center(R, t)
    dist = torch.linalg.norm(params["xyz"] - center[None, :], dim=-1)
    gid, start, count = ref_render.bin_tiles(dict(proj, depth=dist), width, height)
    rows = torch.stack([proj[k] for k in ("mx", "my", "a", "b", "c", "opacity",
                                          "r", "g", "bl", "depth")])[:, gid]
    tx, ty = ref_render.tile_grid(width, height)
    return pair_counts(rows, start, count, tx, ty), int(gid.shape[0]), tx * ty


def camera_faces(params, cams: Dict[str, torch.Tensor], c: int, width: int,
                 height: int, sh_degree: int) -> List[Tuple[Pairs, int, int]]:
    """The five faces' counts of camera row `c` of the camera table."""
    q, t = ref_cube.face_poses(cams["q_init"][c], cams["t_init"][c])
    out = []
    for f in range(len(ref_cube.FACES)):
        Rw, tw = ref_render.camera_pose(q[f], t[f], cams["dq"][c], cams["dt"][c])
        out.append(face_counts(params, Rw, tw, cams["fovx"][c], cams["fovy"][c],
                               width, height, sh_degree))
    return out
