"""Port parity, the cubemap module: `bags_tpu_torch/calib/cubemap.py`, the
sub-cameras' rotation and the cubemap net's pre-fit against `bags_tpu` on
the same numpy inputs (CPU).

Float64 cases (JAX under `jax.enable_x64`) hold to 1e-8 of each tensor's
largest entry. Both packages round the pixel ray grid to float32 and take
its tan warp in float32, in float64 mode too, where the two tan
implementations differ by an ulp; so the float64 cases of the whole face
pipeline give both packages the same grid in float64 (`f64_grids`), and
the float32 cases hold the packages' own grids. Float32 cases hold images
at atol 2e-5 and gradients at atol 1e-5, rtol 1e-3, except where a side
face's grid is ill-conditioned (`test_render_cubemap_faces_f32`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lens_nets import close_rel, jax_lens, lens_np, to_np
from bags_tpu.calib import cubemap as jcube
from bags_tpu.calib import distortion as jdist
from bags_tpu.calib import iresnet as jres
from bags_tpu.core import camera as jcamera
from bags_tpu_torch import convert
from bags_tpu_torch.calib import cubemap as tcube
from bags_tpu_torch.calib import distortion as tdist
from bags_tpu_torch.core import camera as tcamera
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

REL64 = 1e-8
W, H, FOCAL, SCALE = 32, 24, 16.0, 8
K = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1.0]])
KNOWN_LENS = (-0.12, 0.02, 0.0, 0.0)


def _grid64(K, width, height, sample_rate=1):
    """`generate_ray_grid`'s rays without their rounding to float32."""
    i, j = np.meshgrid(np.linspace(0, width, width // sample_rate),
                       np.linspace(0, height, height // sample_rate),
                       indexing="ij")
    pts = np.stack((i.T, j.T), axis=-1).reshape(-1, 2)
    view = (np.linalg.inv(np.asarray(K, np.float64))
            @ np.concatenate([pts, np.ones((len(pts), 1))], axis=1).T).T
    return view[:, :2] / view[:, 2:3]


@pytest.fixture
def f64_grids(monkeypatch):
    """Both packages' ray grids in float64 (so the tan warp is too)."""
    monkeypatch.setattr(jcube, "generate_ray_grid",
                        lambda *a: jnp.asarray(_grid64(*a)))
    monkeypatch.setattr(tcube, "generate_ray_grid",
                        lambda *a, device=None: torch.as_tensor(_grid64(*a)))


def _net(hidden=32, n_blocks=2, n_layers=2, seed=3, weight_scale=0.2,
         dtype=np.float32):
    """A JAX cubemap net as numpy lists, weights scaled."""
    net = jres.init_iresnet_params(hidden=hidden, n_blocks=n_blocks,
                                   n_layers=n_layers, seed=seed)
    d = lens_np(net, dtype)
    d["weights"] = [[w * weight_scale for w in blk] for blk in d["weights"]]
    return d


def _rays(seed=0, n=W * H):
    """Homogeneous rays like the distorted field's: x, y in [-2.5, 2.5],
    none within 0.05 of 0, z = 1."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.05, 2.5, (n, 2)) * rng.choice([-1.0, 1.0], (n, 2))
    return np.concatenate([xy, np.ones((n, 1))], axis=1)


def _rotation(seed):
    q = np.random.default_rng(seed).normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


@pytest.mark.parametrize("rot", range(len(jcube.SUB_CAMERA_ROTATIONS)))
def test_rotate_camera_pose_f64(rot):
    degs = jcube.SUB_CAMERA_ROTATIONS[rot]
    assert tcube.SUB_CAMERA_ROTATIONS[rot] == degs
    R, t = _rotation(rot), np.random.default_rng(10 + rot).normal(size=3)
    with jax.enable_x64():
        jR, jt = jcamera.rotate_camera_pose(jnp.asarray(R), jnp.asarray(t),
                                            *degs)
        jR, jt = np.asarray(jR), np.asarray(jt)
    tR, tt = tcamera.rotate_camera_pose(torch.as_tensor(R), torch.as_tensor(t),
                                        *degs)
    close_rel(tR, jR, REL64)
    close_rel(tt, jt, REL64)
    # the centre stays where it was
    np.testing.assert_allclose(-to_np(tR).T @ to_np(tt), -R.T @ t, atol=1e-12)


@pytest.mark.parametrize("face", jcube.FACES)
def test_face_grid_and_warp_f64(face):
    """The face grid, the warp and the warp's VJP into the image and the
    rays, from the same float64 rays."""
    rays = _rays()
    img = np.random.default_rng(1).random((3, H, W))
    w_out = np.random.default_rng(2).normal(size=(3, H, W))
    with jax.enable_x64():
        jgrid = np.asarray(jcube.face_grid(jnp.asarray(K, jnp.float32),
                                           jnp.asarray(rays), face, H, W,
                                           (H, W)))

        def jf(im, r):
            out, _ = jcube.warp_to_face(np.asarray(K, np.float32), r, im,
                                        face, H, W)
            return jnp.sum(out * w_out), out
        (_, jout), jgrads = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
            jnp.asarray(img), jnp.asarray(rays))
        jout, jgrads = np.asarray(jout), [np.asarray(g) for g in jgrads]
    tr = torch.as_tensor(rays).requires_grad_(True)
    ti = torch.as_tensor(img).requires_grad_(True)
    close_rel(tcube.face_grid(K, tr, face, H, W, (H, W)), jgrid, REL64)
    tout = tcube.warp_to_face(K, tr, ti, face, H, W)
    (tout * torch.as_tensor(w_out)).sum().backward()
    close_rel(tout, jout, REL64)
    close_rel(ti.grad, jgrads[0], REL64)
    close_rel(tr.grad, jgrads[1], REL64)
    assert np.abs(jout).max() > 0.1, "the warp must sample the image"


def test_ray_grid_and_masks():
    for s in (1, SCALE):
        np.testing.assert_array_equal(
            tcube.generate_ray_grid(K, W, H, s).numpy(),
            np.asarray(jcube.generate_ray_grid(K, W, H, s)))
    img = np.random.default_rng(3).random((3, 7, 9)).astype(np.float32)
    for d in ("left", "right", "up", "down"):
        np.testing.assert_array_equal(
            tcube.mask_half(torch.as_tensor(img), d).numpy(),
            np.asarray(jcube.mask_half(jnp.asarray(img), d)))
    for hw, r in (((40, 48), 20), ((33, 32), 11.5)):
        np.testing.assert_array_equal(tcube.circular_mask(*hw, r).numpy(),
                                      np.asarray(jcube.circular_mask(*hw, r)))
    for hw, f in (((40, 48), (24.0, 24.0)), ((40, 48), (15.0, 18.0)),
                  ((33, 31), (10.5, 8.0))):
        np.testing.assert_array_equal(
            tcube.fov90_square_mask(*hw, *f).numpy(),
            np.asarray(jcube.fov90_square_mask(*hw, *f)))


@pytest.mark.parametrize("which", ["narrow_f64", "narrow_f32", "full_f32"])
def test_distorted_rays(which):
    """The distorted ray field, its corner rays past 90 degrees (the
    unclipped tan warp changes sign there): a narrow net at 48x40 in
    float64 (1e-8 of the largest entry) and float32, and the full-size
    5x512 net at 32x32 in float32 (atol 1e-5 of the largest entry)."""
    if which == "full_f32":
        d = lens_np(jres.init_iresnet_params(seed=4), np.float32)
        w, h, f = 32, 32, 12.0
    else:
        d = _net(dtype=np.float64 if which == "narrow_f64" else np.float32)
        w, h, f = 48, 40, FOCAL
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    assert np.hypot(w / 2, h / 2) / f > np.pi / 2
    f64 = which.endswith("f64")
    with jax.enable_x64(f64):
        jr = np.asarray(jcube.distorted_rays(
            jax_lens(d, jnp.float64 if f64 else jnp.float32), k, w, h, SCALE))
    tr = tcube.distorted_rays(convert.iresnet_from_numpy(d, "cpu"), k, w, h,
                              SCALE)
    assert tr.dtype == (torch.float64 if f64 else torch.float32)
    close_rel(tr, jr, REL64 if f64 else 1e-5)


def _faces_vjp_jax(d, renders, w_outs, k, w, h, f64):
    """JAX's five warped faces and the VJP of sum_i <face_i, w_i> into the
    renders and the net."""
    mask90 = jcube.fov90_square_mask(h, w, k[0, 0], k[1, 1])
    with jax.enable_x64(f64):
        dt = jnp.float64 if f64 else jnp.float32
        net = jax_lens(d, dt)

        def f(rs, p):
            faces, _ = jcube.render_cubemap_faces(
                lambda i: rs[i], p, k, w, h, SCALE, mask90)
            return sum(jnp.sum(a * b) for a, b in zip(faces, w_outs)), faces
        (_, faces), (g_r, g_p) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))([jnp.asarray(r, dt) for r in renders],
                                              net)
        return ([np.asarray(x) for x in faces], [np.asarray(x) for x in g_r],
                lens_np(g_p))


def _faces_vjp_port(d, renders, w_outs, k, w, h):
    net = convert.iresnet_from_numpy(d, "cpu")
    rs = [torch.as_tensor(r).requires_grad_(True) for r in renders]
    mask90 = tcube.fov90_square_mask(h, w, k[0, 0], k[1, 1])
    faces, zero = tcube.render_cubemap_faces(lambda i: rs[i], net, k, w, h,
                                             SCALE, mask90)
    assert zero == 0
    sum((a * torch.as_tensor(b)).sum() for a, b in zip(faces, w_outs)).backward()
    return faces, [r.grad for r in rs], net


def _inputs(dtype, w=W, h=H):
    rng = np.random.default_rng(5)
    renders = [rng.random((3, h, w)).astype(dtype) for _ in range(5)]
    w_outs = [rng.normal(size=(3, h, w)).astype(dtype) for _ in range(5)]
    return renders, w_outs


def test_render_cubemap_faces_f64(f64_grids):
    """The five warped faces and their VJP into the five renders and every
    weight and bias of the net, float64, to 1e-8 of each largest entry."""
    d = _net(dtype=np.float64)
    renders, w_outs = _inputs(np.float64)
    jfaces, jg_r, jg_p = _faces_vjp_jax(d, renders, w_outs, K, W, H, True)
    faces, g_r, net = _faces_vjp_port(d, renders, w_outs, K, W, H)
    for i in range(5):
        close_rel(faces[i], jfaces[i], REL64)
        close_rel(g_r[i], jg_r[i], REL64)
        assert np.abs(jfaces[i]).max() > 0.1, f"face {i} samples nothing"
    for f in ("weights", "biases"):
        for b, blk in enumerate(getattr(net, f)):
            for l, t in enumerate(blk):
                close_rel(t.grad, jg_p[f][b][l], REL64)


def test_render_cubemap_faces_f32():
    """float32: images at atol 2e-5, the render and net gradients at atol
    1e-5, rtol 1e-3. The side faces divide by the ray's x or y, so near
    the centre column (left, right) or row (up, down) of the ray field a
    sample position is a large multiple of the ray's float32 rounding,
    which the two packages' tan and products round differently: a face
    pixel may differ by more than 2e-5 only where its sample position,
    taken from each package's own float32 grid, differs by more than 1e-5
    pixel."""
    d = _net()
    renders, w_outs = _inputs(np.float32)
    jfaces, jg_r, jg_p = _faces_vjp_jax(d, renders, w_outs, K, W, H, False)
    faces, g_r, net = _faces_vjp_port(d, renders, w_outs, K, W, H)
    jrays = jcube.distorted_rays(jax_lens(d, jnp.float32), K, W, H, SCALE)
    trays = tcube.distorted_rays(net, K, W, H, SCALE).detach()
    for i, face in enumerate(tcube.FACES):
        diff = np.abs(to_np(faces[i]) - jfaces[i]).max(0)
        jpos = np.asarray(jcube.face_grid(jnp.asarray(K, jnp.float32), jrays,
                                          face, H, W, (H, W)))
        tpos = to_np(tcube.face_grid(K, trays, face, H, W, (H, W)))
        moved = (np.abs(jpos.astype(np.float64) - tpos) * (W - 1) / 2).max(-1)
        off = diff > 2e-5
        assert (moved[off] > 1e-5).all(), (face, diff[off & (moved <= 1e-5)])
        assert off.sum() <= 0.02 * off.size, (face, int(off.sum()))
    for i in range(5):
        np.testing.assert_allclose(to_np(g_r[i]), jg_r[i], atol=1e-5, rtol=1e-3)
    for f in ("weights", "biases"):
        for b, blk in enumerate(getattr(net, f)):
            for l, t in enumerate(blk):
                np.testing.assert_allclose(to_np(t.grad), jg_p[f][b][l],
                                           atol=1e-5, rtol=1e-3,
                                           err_msg=f"{f}[{b}][{l}]")


def test_non_finite_face_grid_matches_jax(f64_grids):
    """An odd width and a zero net: the centre column's rays have x = 0
    exactly (and the centre pixel y = 0 too), so the left and right face
    grids hold -inf, inf and NaN (0 / 0), the up and down faces' centre
    row likewise. JAX's gather `grid_sample` returns NaN there and NaN
    cotangents. The port reads zero there and passes those samples no
    cotangent, as `F.grid_sample` reads a position at infinity
    (`calib/cubemap.py`): its faces and its VJP into the renders are
    finite, 0 where JAX's faces are NaN, and within float64 rounding of
    JAX's wherever JAX's are finite. Into the net, both packages' VJPs are
    NaN in the same entries (the division's derivative at the rays with a
    zero coordinate), which the training step's NaN guard drops."""
    w, h = 33, 25
    k = np.array([[FOCAL, 0, w / 2], [0, FOCAL, h / 2], [0, 0, 1.0]])
    d = _net(dtype=np.float64, weight_scale=0.0)
    renders, w_outs = _inputs(np.float64, w, h)
    jfaces, jg_r, jg_p = _faces_vjp_jax(d, renders, w_outs, k, w, h, True)
    faces, g_r, net = _faces_vjp_port(d, renders, w_outs, k, w, h)
    assert tcube.distorted_rays(net, k, w, h, SCALE)[16 * w + 16, 0] == 0.0

    def near(got, want):
        finite = np.abs(want[np.isfinite(want)])
        np.testing.assert_allclose(got[np.isfinite(want)], want[np.isfinite(want)],
                                   atol=1e-8 * finite.max(initial=1.0))
    for i in range(5):
        face, g = to_np(faces[i]), to_np(g_r[i])
        assert np.isfinite(face).all() and np.isfinite(g).all()
        assert (face[np.isnan(jfaces[i])] == 0).all()
        near(face, np.asarray(jfaces[i]))
        near(g, np.asarray(jg_r[i]))
    assert all(np.isnan(jfaces[i]).any() for i in range(1, 5))
    assert np.isnan(jg_p["weights"][0][0]).any()
    for f in ("weights", "biases"):
        for b, blk in enumerate(getattr(net, f)):
            for l, t in enumerate(blk):
                got, want = to_np(t.grad), np.asarray(jg_p[f][b][l])
                np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
                near(got, want)


def test_cubemap_to_perspective():
    """Values against JAX on random faces (atol 1e-5), and the JAX
    package's own check: faces painted with 0.5 + 0.5 d(u, v) resample
    into the same field of the perspective view's rays (max error 0.02,
    the centre pixel looking down +z)."""
    rng = np.random.default_rng(6)
    faces = [rng.random((3, 17, 17)).astype(np.float32) for _ in range(5)]
    args = (100.0, 80.0, 24, 20)
    np.testing.assert_allclose(
        tcube.cubemap_to_perspective(*map(torch.as_tensor, faces), *args).numpy(),
        np.asarray(jcube.cubemap_to_perspective(*map(jnp.asarray, faces), *args)),
        atol=1e-5)

    n = 65

    def face(frame):
        u = np.linspace(-1, 1, n)[None, :] * np.ones((n, 1))
        v = np.linspace(-1, 1, n)[:, None] * np.ones((1, n))
        dd = frame(u, v)
        return torch.as_tensor(0.5 + 0.5 * dd / np.linalg.norm(dd, axis=0),
                               dtype=torch.float32)

    one = np.ones((n, n))
    out = tcube.cubemap_to_perspective(
        face(lambda u, v: np.stack([u, v, one])),
        face(lambda u, v: np.stack([-one, v, u])),
        face(lambda u, v: np.stack([one, v, -u])),
        face(lambda u, v: np.stack([u, one, -v])),
        face(lambda u, v: np.stack([u, -one, v])), 120.0, 120.0, 48, 48).numpy()
    f = 24.0 / np.tan(np.deg2rad(60.0))
    jj, ii = np.meshgrid(np.arange(48), np.arange(48), indexing="ij")
    dd = np.stack([(ii - 24.0) / f, (24.0 - jj) / f, np.ones((48, 48))])
    assert np.abs(out - (0.5 + 0.5 * dd / np.linalg.norm(dd, axis=0))).max() < 0.02
    np.testing.assert_allclose(out[:, 24, 24], [0.5, 0.5, 1.0], atol=0.04)


def test_init_cubemap_net_samples_and_fit(monkeypatch):
    """`cubemap_fit_points` are the samples JAX's `init_cubemap_net` fits
    (captured from its call of `fit_iresnet_to_targets`), bit for bit; a
    2-step fit of a narrow float64 net then agrees with JAX's to 1e-8."""
    seen = {}

    def capture(params, inputs, targets, iters, lr):
        seen.update(inputs=np.asarray(inputs), targets=np.asarray(targets),
                    iters=iters, lr=lr)
        return params

    monkeypatch.setattr(jdist, "fit_iresnet_to_targets", capture)
    jdist.init_cubemap_net(None, KNOWN_LENS)
    monkeypatch.undo()
    inputs, targets = tdist.cubemap_fit_points(KNOWN_LENS)
    assert inputs.shape == targets.shape == (160_000, 2)
    np.testing.assert_array_equal(inputs.numpy(), seen["inputs"])
    np.testing.assert_array_equal(targets.numpy(), seen["targets"])
    assert (seen["iters"], seen["lr"]) == (100, 1e-4)

    d = _net(hidden=8, dtype=np.float64)
    with jax.enable_x64():
        jfit = lens_np(jdist.init_cubemap_net(jax_lens(d, jnp.float64),
                                              KNOWN_LENS, iters=2))
    tnet = convert.iresnet_from_numpy(d, "cpu")
    tdist.init_cubemap_net(tnet, KNOWN_LENS, iters=2)
    for f in ("weights", "biases"):
        for b, blk in enumerate(getattr(tnet, f)):
            for l, t in enumerate(blk):
                close_rel(t.detach(), jfit[f][b][l], REL64)
                assert np.abs(jfit[f][b][l] - d[f][b][l]).max() > 0
