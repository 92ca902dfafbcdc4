"""Port parity, the profiling tool's kernels: the JAX tool `tools/kernablate.py`
itself, unedited, runs `main()` and `real_variants()` in Pallas interpret mode
with every `pallas_call` recorded, on a 3,000-Gaussian scene at its own
800x800 workload (its timer made one call, its compilation cache off). The
port's plain versions of the four ablation modes, of `fori` and of the real
forward then take the recorded inputs and are held to the recorded outputs.
The CUDA kernels are held against these plain versions on the card
(`tests/test_torch_gpu.py`, `chip_smoke.py`). The forward's variants, which
the JAX tool does not have, are held here to `composite_tiles_plain` on the
CPU, and `real` on a tiny CPU workload."""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import bags_tpu.utils.testing as jtesting
import tools.kernablate as jka
from bags_tpu_torch.raster.tiles import composite_tiles_plain
from bags_tpu_torch.tools import kernablate as ka
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

N_GAUSS = 3000  # 111 of the 2,500 tiles then span more than one chunk
TILES = (50, 50)


@pytest.fixture(scope="module")
def recorded():
    """[(kernel name, scalar-prefetch args, outputs)] of every pallas_call
    the JAX tool made, in order, and its instance rows (the same in all)."""
    calls, rows = [], []
    orig_call, orig_make = pl.pallas_call, jtesting.make_toy_scene

    def recording(kernel, *args, **kwargs):
        f = orig_call(kernel, *args, **{**kwargs, "interpret": True})
        name = getattr(getattr(kernel, "func", kernel), "__name__", "")

        def call(*operands):
            out = f(*operands)
            if not rows:
                rows.append(np.asarray(operands[4]))
            assert np.array_equal(np.asarray(operands[4]), rows[0])
            calls.append((name, [np.asarray(x) for x in operands[:4]],
                          [np.asarray(o) for o in out]))
            return out
        return call

    mp = pytest.MonkeyPatch()
    mp.setattr(pl, "pallas_call", recording)
    mp.setattr(jka, "timed_chain",
               lambda f, perturb, **kw: (jax.block_until_ready(f(0.0)), 0.0)[1])
    mp.setattr(jka, "enable_persistent_cache", lambda *a, **kw: None)
    mp.setattr(jtesting, "make_toy_scene",
               lambda **kw: orig_make(**{**kw, "n": N_GAUSS}))
    mp.setenv("BAGS_TPU_PALLAS_INTERPRET", "1")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            jka.main()
            jka.real_variants()
    finally:
        mp.undo()
    return calls, rows[0]


def _port_inputs(scalars, rows):
    """The port's (rows, tile_start, tile_count, tiles_x, tiles_y) of a
    recorded call: a tile's first slot is chunk0 * 128 + off."""
    chunk0, off, count, _ = scalars
    start = chunk0.astype(np.int64) * ka.CHUNK + off
    return (torch.tensor(rows[:10]), torch.tensor(start.astype(np.int32)),
            torch.tensor(count), *TILES)


def _calls(recorded, name):
    return [c for c in recorded[0] if c[0] == name]


def test_tool_made_every_call(recorded):
    assert [c[0] for c in recorded[0]] == ["kern"] * 4 + [
        "fori_kernel", "_fwd_kernel"] * 2


def test_scene_spans_many_chunks(recorded):
    _, start, count, _, _ = _port_inputs(_calls(recorded, "kern")[0][1], recorded[1])
    end = start.long() + count
    spans = (end + ka.CHUNK - 1) // ka.CHUNK - start.long() // ka.CHUNK
    assert int(((spans > 1) & (count > 0)).sum()) >= 100


@pytest.mark.parametrize("mode", ka.MODES)
def test_ablation_mode_matches_jax_tool(recorded, mode):
    """dma_only within 1e-6 of max |JAX| (its weight, power, is unbounded);
    no_scan and full within the forward's 2e-5; no_transcendental zero in
    both (o power <= 0 < 1/255 rejects every pair); t exactly 1 in all."""
    _, scalars, (j_color, j_t) = _calls(recorded, "kern")[ka.MODES.index(mode)]
    color, t = ka.composite_ablate_plain(*_port_inputs(scalars, recorded[1]), mode)
    color = color.numpy()
    assert np.all(t.numpy() == 1.0) and np.all(j_t == 1.0)
    err, top = np.abs(color - j_color).max(), np.abs(j_color).max()
    if mode == "no_transcendental":
        assert top == 0.0 and np.abs(color).max() == 0.0
    elif mode == "dma_only":
        assert top > 1e3 and err <= 1e-6 * top, (err, top)
    else:
        assert top > 1.0 and err <= 2e-5, err


@pytest.mark.parametrize("name", ["fori_kernel", "_fwd_kernel"])
def test_fori_and_real_forward_match_plain(recorded, name):
    """`composite_tiles_plain`, the plain version of both, within the
    forward's 2e-5 of each recorded call."""
    calls = _calls(recorded, name)
    color, t = composite_tiles_plain(*_port_inputs(calls[0][1], recorded[1]))
    for _, scalars, (j_color, j_t) in calls:
        assert all(np.array_equal(a, b) for a, b in zip(scalars, calls[0][1]))
        np.testing.assert_allclose(color.numpy(), j_color, atol=2e-5, rtol=0)
        np.testing.assert_allclose(t.numpy(), j_t[..., 0], atol=2e-5, rtol=0)


def test_jax_fori_equals_jax_real(recorded):
    for (_, _, fori), (_, _, real) in zip(_calls(recorded, "fori_kernel"),
                                          _calls(recorded, "_fwd_kernel")):
        assert all(np.array_equal(a, b) for a, b in zip(fori, real))


def test_cpu_wrappers_run_the_plain_versions(recorded):
    """On CPU tensors the wrappers return the plain versions' outputs and
    launch nothing; an unknown mode raises. The first two tile rows."""
    rows, start, count, tiles_x, _ = _port_inputs(
        _calls(recorded, "kern")[0][1], recorded[1])
    inputs = (rows, start[:2 * tiles_x].contiguous(),
              count[:2 * tiles_x].contiguous(), tiles_x, 2)
    assert int(inputs[2].sum()) > 0
    before = dict(ka.launches)
    for mode in ka.MODES:
        got = ka.composite_ablate(*inputs, mode)
        want = ka.composite_ablate_plain(*inputs, mode)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = ka.composite_fwd_fori(*inputs)
    assert all(torch.equal(a, b) for a, b in zip(got, composite_tiles_plain(*inputs)))
    assert ka.launches == before
    with pytest.raises(ValueError, match="mode"):
        ka.composite_ablate(*inputs, "fast")


def test_kernablate_cli_on_cpu(capsys):
    small = ["--device", "cpu", "--n", "300", "--size", "64"]
    times = ka.main(small)
    assert sorted(times) == sorted(ka.MODES)
    real = ka.main(["real"] + small)
    out = capsys.readouterr().out
    for label in ka.MODES + ("real fori+when", "real while_loop", "max |dcolor|"):
        assert label in out
    assert real["dcolor"] == 0.0 and real["dt"] == 0.0


def test_fwd_variant_rejects_unknown_name(recorded):
    rows, start, count, tiles_x, _ = _port_inputs(
        _calls(recorded, "kern")[0][1], recorded[1])
    with pytest.raises(ValueError, match="variant"):
        ka.composite_fwd_variant(rows, start, count, tiles_x, TILES[1], "fast")


@pytest.mark.parametrize("name", ka.VARIANTS)
def test_fwd_variant_on_cpu_is_plain(recorded, name):
    """On CPU tensors each variant of the forward returns
    `composite_tiles_plain`'s output and launches nothing. The first two
    tile rows of the JAX tool's workload."""
    rows, start, count, tiles_x, _ = _port_inputs(
        _calls(recorded, "kern")[0][1], recorded[1])
    inputs = (rows, start[:2 * tiles_x].contiguous(),
              count[:2 * tiles_x].contiguous(), tiles_x, 2)
    before = dict(ka.launches)
    got = ka.composite_fwd_variant(*inputs, name)
    assert all(torch.equal(a, b) for a, b in zip(got, composite_tiles_plain(*inputs)))
    assert ka.launches == before


def test_real_variants_on_cpu():
    """`real` on a tiny CPU workload returns fori and every variant, each
    with its time, the forward's in the same turns and a difference of 0."""
    out = ka.real_variants(ka.parse_args(["real", "--device", "cpu", "--n", "300",
                                          "--size", "64"]))
    assert sorted(out["variants"]) == sorted(("fori",) + ka.VARIANTS)
    for res in out["variants"].values():
        assert res["dcolor"] == 0.0 and res["dt"] == 0.0
        assert res["ms"] > 0.0 and res["fwd_ms"] > 0.0
    assert out["tile_order"] > 0.0 and out["dcolor"] == 0.0 and out["dt"] == 0.0


def test_chunk_crossing_rows_cross_chunks_and_batches():
    """The inputs of the ablation kernels' chunk test: a tile that starts
    mid-chunk, spans at least three chunks and whose 256-instance batches
    end mid-chunk; every mode's plain version gives finite colour there and
    t exactly 1."""
    from bags_tpu_torch.utils.testing import chunk_crossing_rows

    args = chunk_crossing_rows("cpu")
    start, count = args[1].long(), args[2].long()
    end = start + count
    spans = (end - 1) // ka.CHUNK - start // ka.CHUNK + 1
    mid_start = (start % ka.CHUNK != 0) & (spans >= 3)
    batch_ends = [s + b for s, c in zip(start.tolist(), count.tolist())
                  for b in range(256, c, 256)]
    assert bool(mid_start.any())
    assert batch_ends and all(b % ka.CHUNK != 0 for b in batch_ends)
    for mode in ka.MODES:
        color, t = ka.composite_ablate_plain(*args, mode)
        assert bool(torch.isfinite(color).all()) and bool((t == 1).all())
        assert (float(color.abs().max()) > 0) == (mode != "no_transcendental")
