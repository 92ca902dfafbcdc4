"""On-card tests of the port's CUDA kernel (`gpu` marker). They skip without
a card. The file imports neither JAX nor `bags_tpu`, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from bags_tpu_torch.core.projection import project_gaussians
from bags_tpu_torch.raster import binning, composite, tiles
from bags_tpu_torch.raster.render import RenderConfig, build_packet_table, render
from bags_tpu_torch.utils.testing import make_toy_scene

pytestmark = pytest.mark.gpu
ARGS = ("xyz", "scales", "quats", "opacity", "sh_coeffs")

SCENES = {
    "toy_sh3": (dict(n=700, width=64, height=48, sh_degree=3, seed=0), None),
    "unaligned_spill": (dict(n=700, width=64, height=48, seed=21,
                             scale_range=(0.01, 0.05)), None),
    # low opacities keep pixels compositing through > 4096 instances a tile
    "dense_tile": (dict(n=20000, width=32, height=32, seed=5,
                        scale_range=(0.1, 0.4)), (0.005, 0.02)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _scene(name, device):
    kw, opacity = SCENES[name]
    sc = make_toy_scene(**kw, device=device)
    if opacity is not None:
        sc["opacity"] = torch.as_tensor(np.random.default_rng(kw["seed"]).uniform(
            *opacity, kw["n"]).astype(np.float32), device=device)
    return sc


def _rows(sc):
    proj = project_gaussians(*[sc[k] for k in ARGS], sc["cam"], sc["static"],
                             sc["sh_degree"])
    tx, ty = tiles.tile_grid(sc["static"].width, sc["static"].height)
    bins = binning.bin_gaussians(proj, tx, ty)
    rows = build_packet_table(proj, proj.x2d, proj.y2d).index_select(
        1, bins.gauss_id)
    return rows, bins, tx, ty


@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernel_matches_plain(cuda, name):
    rows, bins, tx, ty = _rows(_scene(name, cuda))
    before = composite.launches
    kc, kt = composite.composite_fwd(rows, bins.tile_start, bins.tile_count, tx, ty)
    assert composite.launches == before + 1
    pc, pt = tiles.composite_tiles_plain(rows, bins.tile_start, bins.tile_count,
                                         tx, ty)
    torch.testing.assert_close(kc, pc, atol=2e-5, rtol=0)
    torch.testing.assert_close(kt, pt, atol=2e-5, rtol=0)
    if name == "dense_tile":
        assert int(bins.tile_count.max()) > 4096


def test_render_on_card_matches_cpu(cuda):
    cfg, bg = RenderConfig(sh_degree=3), [0.3, 0.6, 0.9]
    outs = []
    for dev in (cuda, torch.device("cpu")):
        sc = _scene("toy_sh3", dev)
        outs.append(render(*[sc[k] for k in ARGS], sc["cam"], sc["static"], cfg,
                           bg=torch.tensor(bg, device=dev)))
    for f in ("render", "t_final", "depth_map", "mean2d"):
        torch.testing.assert_close(getattr(outs[0], f).cpu(), getattr(outs[1], f),
                                   atol=2e-5, rtol=2e-5)
    assert torch.equal(outs[0].radii.cpu(), outs[1].radii)
    assert torch.equal(outs[0].gauss_id.cpu(), outs[1].gauss_id)


def test_backward_on_card_is_slice_2(cuda):
    sc = _scene("toy_sh3", cuda)
    xyz = sc["xyz"].clone().requires_grad_(True)
    out = render(xyz, *[sc[k] for k in ARGS[1:]], sc["cam"], sc["static"],
                 RenderConfig(sh_degree=3))
    with pytest.raises(NotImplementedError, match="slice 2"):
        out.render.sum().backward()


def test_wrapper_rejects_mixed_devices(cuda):
    rows, bins, tx, ty = _rows(_scene("toy_sh3", cuda))
    with pytest.raises(ValueError, match="tile_start"):
        composite.composite_fwd(rows, bins.tile_start.cpu(), bins.tile_count, tx, ty)
