"""Port parity, LPIPS: the port's weight loaders (`eval/lpips_weights.py`,
on `torch.load(weights_only=True)`) against the JAX package's numpy
unpickler on the same `torch.save` files, and the port's `Lpips` module
against JAX's `Lpips` on the same seeded images."""

import os

import jax
import numpy as np
import pytest
import torch

from bags_tpu.eval import lpips_weights as jw
from bags_tpu.eval.metrics import Lpips as JaxLpips
from bags_tpu.eval.metrics import _lpips_forward
from bags_tpu_torch.eval import lpips_weights as pw
from bags_tpu_torch.eval.metrics import Lpips
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-5    # LPIPS, float32, port against JAX

# JAX's Lpips.__call__, jitted (eager it takes seconds a call on the CPU)
_jax_forward = jax.jit(_lpips_forward, static_argnums=1)


def _jax_lpips(ref, a, b):
    return float(_jax_forward(ref.params, ref.arch, a, b))


def _vgg_sd(rng, width=4):
    """VGG16-shaped state dict (torchvision key layout, tiny channels)."""
    sd, c_in = {}, 3
    for idx in pw.VGG16_CONV_IDX:
        sd[f"features.{idx}.weight"] = torch.tensor(
            rng.normal(0, 0.2, (width, c_in, 3, 3)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.tensor(
            rng.normal(0, 0.01, width).astype(np.float32))
        c_in = width
    return sd


def _alex_sd(rng, width=6):
    """AlexNet-shaped state dict, the real geometry at tiny channels."""
    sd, c_in = {}, 3
    for conv_i, idx in enumerate(pw.ALEX_CONV_IDX):
        k = (11, 5, 3, 3, 3)[conv_i]
        sd[f"features.{idx}.weight"] = torch.tensor(
            rng.normal(0, 0.2, (width, c_in, k, k)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.tensor(
            rng.normal(0, 0.01, width).astype(np.float32))
        c_in = width
    return sd


def _lin_sd(rng, width):
    return {f"lin{k}.model.1.weight": torch.tensor(
        np.abs(rng.normal(0, 0.1, (1, width, 1, 1))).astype(np.float32))
        for k in range(5)}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """One directory per backbone with the two upstream-named files (the
    backbone in the zip format, the linear file in the legacy one), and
    each converted to an npz bundle."""
    root = tmp_path_factory.mktemp("lpips")
    rng = np.random.default_rng(4)
    out = {}
    for net, sd, name, width in (("vgg", _vgg_sd(rng), "vgg16-397923af.pth", 4),
                                 ("alex", _alex_sd(rng), "alexnet-owt-7be5be79.pth", 6)):
        d = root / net
        d.mkdir()
        torch.save(sd, str(d / name))
        torch.save(_lin_sd(rng, width), str(d / f"{net}.pth"),
                   _use_new_zipfile_serialization=False)
        npz = str(root / f"{net}.npz")
        np.savez(npz, **jw.load_official_dir(str(d), net=net))
        out[net] = (str(d), npz)
    return out


@pytest.mark.parametrize("legacy", [False, True])
def test_loaders_match_jax(tmp_path, legacy):
    rng = np.random.default_rng(2)
    obj = ({
        "a.weight": torch.tensor(rng.normal(size=(4, 3, 3, 3)).astype(np.float32)),
        "b.weight": torch.nn.Parameter(torch.tensor(
            rng.normal(size=(2, 4)).astype(np.float32))),
        "c.long": torch.arange(6, dtype=torch.int64).reshape(2, 3),
        "d.noncontig": torch.tensor(rng.normal(size=(4, 5)).astype(np.float32)).t(),
        "e.half": torch.tensor(rng.normal(size=5).astype(np.float16)),
        "f.bf16": torch.tensor(rng.normal(size=5).astype(np.float32)).bfloat16(),
        "g.scalar": torch.tensor(3.5),
        "h.bool": torch.tensor([True, False]),
        "nested": [torch.ones(2), {"k": (torch.zeros(1), 7)}],
        "n": 12,
    }, 30000)
    path = str(tmp_path / "obj.pth")
    torch.save(obj, path, _use_new_zipfile_serialization=not legacy)

    def same(a, b):
        assert type(a) is type(b), (type(a), type(b))
        if isinstance(a, dict):
            assert list(a) == list(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b

    same(pw.load_torch_object(path), jw.load_torch_object(path))
    state = str(tmp_path / "sd.pth")
    torch.save(obj[0], state, _use_new_zipfile_serialization=not legacy)
    same(pw.load_torch_pth(state), jw.load_torch_pth(state))


def test_loader_refuses_arbitrary_classes(tmp_path):
    class Evil:
        def __reduce__(self):
            return (print, ("pwned",))

    path = str(tmp_path / "evil.pth")
    torch.save({"x": Evil()}, path)
    import pickle
    with pytest.raises(pickle.UnpicklingError, match="[Uu]nsupported global"):
        pw.load_torch_pth(path)


@pytest.mark.parametrize("net", ["vgg", "alex"])
def test_official_dir_matches_jax(weights, net):
    d, _ = weights[net]
    got, want = pw.load_official_dir(d, net=net), jw.load_official_dir(d, net=net)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def _images(seed, hw=(48, 56)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (3,) + hw).astype(np.float32)
    b = np.clip(a + 0.15 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("net, source", [("vgg", "dir"), ("vgg", "npz"),
                                         ("alex", "dir"), ("alex", "npz")])
def test_lpips_matches_jax(weights, net, source):
    path = weights[net][0 if source == "dir" else 1]
    port, ref = Lpips(path, net=net), JaxLpips(path, net=net)
    assert port.available and port.net == ref.net == net
    assert port.arch == ref.arch
    a, b = _images(8 if net == "vgg" else 9, (48, 56) if net == "vgg" else (96, 88))
    got = float(port(torch.as_tensor(a), torch.as_tensor(b)))
    want = _jax_lpips(ref, a, b)
    assert got > 0 and got == pytest.approx(want, rel=RTOL)
    assert float(port(torch.as_tensor(a), torch.as_tensor(a))) == pytest.approx(
        0.0, abs=1e-6)


def test_lpips_same_padding_with_stride(tmp_path):
    """A stride-2 conv with no pad key: JAX's SAME padding is asymmetric
    there (the odd pixel at the high side), on odd and even sizes."""
    rng = np.random.default_rng(11)
    arrays = {"conv0_w": rng.normal(0, 0.3, (5, 3, 4, 4)).astype(np.float32),
              "conv0_b": rng.normal(0, 0.01, 5).astype(np.float32),
              "conv0_stride": np.asarray(2), "tap_0": np.asarray(0),
              "conv1_w": rng.normal(0, 0.3, (6, 5, 3, 3)).astype(np.float32),
              "conv1_b": rng.normal(0, 0.01, 6).astype(np.float32),
              "conv1_stride": np.asarray(2), "tap_1": np.asarray(1),
              "pool_after_0_k": np.asarray(3), "pool_after_0_s": np.asarray(1)}
    for k, c in enumerate((5, 6)):
        arrays[f"lin{k}_w"] = np.abs(rng.normal(0, 0.1, c)).astype(np.float32)
    npz = str(tmp_path / "strided.npz")
    np.savez(npz, **arrays)
    port, ref = Lpips(npz), JaxLpips(npz)
    assert port.arch == ref.arch == ((2, None, True, (3, 1)), (2, None, True, None))
    for hw in ((33, 30), (32, 31)):
        a, b = _images(12, hw)
        want = _jax_lpips(ref, a, b)
        assert float(port(torch.as_tensor(a), torch.as_tensor(b))) == \
            pytest.approx(want, rel=RTOL)


def test_lpips_without_weights_is_nan(monkeypatch, tmp_path):
    monkeypatch.delenv("BAGS_TPU_LPIPS_WEIGHTS", raising=False)
    for path in (None, str(tmp_path / "missing.npz")):
        lp = Lpips(path)
        assert not lp.available
        assert np.isnan(float(lp(torch.zeros(3, 8, 8), torch.zeros(3, 8, 8))))


def test_lpips_reads_the_environment(weights, monkeypatch):
    monkeypatch.setenv("BAGS_TPU_LPIPS_WEIGHTS", weights["vgg"][1])
    assert Lpips().available and Lpips().net == "vgg"
    assert os.path.exists(weights["vgg"][1])
