"""Port parity, the MCMC densifier (`bags_tpu_torch/model/mcmc.py`) against
`bags_tpu/model/mcmc.py` (CPU, JAX at a tiny capacity):
`compute_relocation` in float32 and float64, `relocate_dead` and
`add_new_gaussians` with the same draws injected into both packages (the
JAX sampler monkeypatched; it draws C samples and keeps the first n, so its
injected draws are padded to C), `position_noise` with the same normal
draws, and the port's sampler alone against opacity-proportional
probabilities."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bags_tpu.model import mcmc as jmcmc
from bags_tpu.model.gaussians import Gaussians as JGaussians
from bags_tpu_torch import convert
from bags_tpu_torch.model import mcmc as tmcmc
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FIELDS = ("xyz", "sh_dc", "sh_rest", "scales_log", "quats", "opacity_raw",
          "asg")
RTOL32 = 1e-6


def population(cap: int, n_alive: int, n_dead: int, seed: int = 0) -> dict:
    """numpy fields of a hybrid SH-1 population: the first n_alive slots
    alive, n_dead of them (spread out) at raw opacity -8 (sigmoid 3.4e-4,
    under the 0.005 threshold), the rest across (0.01, 0.99); dead slots
    at the JAX package's padding."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.01, 0.99, cap).astype(np.float32)
    d = dict(xyz=rng.normal(0, 1, (cap, 3)), sh_dc=rng.normal(0, 1, (cap, 1, 3)),
             sh_rest=rng.normal(0, 0.1, (cap, 3, 3)),
             scales_log=rng.uniform(-5, -1, (cap, 3)),
             quats=rng.normal(0, 1, (cap, 4)), opacity_raw=np.log(o / (1 - o)),
             asg=rng.normal(0, 0.3, (cap, 24)))
    d = {k: v.astype(np.float32) for k, v in d.items()}
    dead = rng.choice(n_alive, n_dead, replace=False)
    d["opacity_raw"][dead] = -8.0
    d["opacity_raw"][n_alive:] = -10.0
    d["scales_log"][n_alive:] = -10.0
    d["alive"] = np.arange(cap) < n_alive
    return d


def both(d):
    """(JAX Gaussians, JAX alive, port Gaussians, port alive) of `d`."""
    jg = JGaussians(**{f: jnp.asarray(d[f]) for f in FIELDS})
    tg, talive = convert.gaussians_from_numpy(d, device="cpu")
    return jg, jnp.asarray(d["alive"]), tg, talive


def inject(monkeypatch, module, draws, pad_to=None):
    """Make `module._sample_by_opacity` return the next of `draws` (each
    padded with zeros to `pad_to` for JAX), checking the count asked."""
    queue = list(draws)

    def fake(key, g, live, num):
        d = np.asarray(queue.pop(0))
        if pad_to is None:
            assert num == len(d), (num, len(d))
            return torch.as_tensor(d, dtype=torch.long)
        return jnp.asarray(np.concatenate([d, np.zeros(pad_to - len(d), d.dtype)]))

    monkeypatch.setattr(module, "_sample_by_opacity", fake)


def assert_same(tg, jg, talive=None, jalive=None):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tg, f).numpy(), np.asarray(getattr(jg, f)),
                                   rtol=RTOL32, atol=0, err_msg=f)
    if talive is not None:
        np.testing.assert_array_equal(talive.numpy(), np.asarray(jalive))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_compute_relocation_matches_jax(dtype):
    """n_merge 1-50 (and 0 and 60, which clip) against opacities across
    (0, 1): new opacity and scale, float32 rtol 1e-6, float64 1e-12. The
    scale's denominator is an alternating binomial sum; at opacity 0.9999
    and n_merge >= 16 it cancels so far that each package's float32 value
    is off the float64 one by up to 1e-5 (their `pow`s differ in the last
    ulp). An entry off JAX's by more than 1e-6 must be one of those
    (opacity >= 0.999), and there the port's float32 value is no farther
    from the float64 value than twice JAX's, plus 1e-6 (ROADMAP.md Queue
    3)."""
    rng = np.random.default_rng(1)
    n_merge = np.repeat(np.arange(0, 61), 9).astype(np.int32)
    o = np.tile(np.array([1e-4, 0.01, 0.1, 0.3, 0.5, 0.7, 0.9, 0.99, 0.9999]),
                61).astype(dtype)
    s = rng.uniform(1e-3, 1.0, (o.size, 3)).astype(dtype)
    rtol = RTOL32 if dtype == "float32" else 1e-12
    with jax.enable_x64(dtype == "float64"):
        jo, js = jmcmc.compute_relocation(jnp.asarray(o), jnp.asarray(s),
                                          jnp.asarray(n_merge))
        jo, js = np.asarray(jo), np.asarray(js)
    to, ts = tmcmc.compute_relocation(torch.as_tensor(o), torch.as_tensor(s),
                                      torch.as_tensor(n_merge))
    assert to.dtype == getattr(torch, dtype) and jo.dtype == dtype
    np.testing.assert_allclose(to.numpy(), jo, rtol=rtol, atol=0)
    ts = ts.numpy()
    off = np.abs(ts - js) > rtol * np.abs(js)
    if dtype == "float64":
        assert not off.any()
        return
    with jax.enable_x64():
        _, js64 = jmcmc.compute_relocation(jnp.asarray(o.astype(np.float64)),
                                           jnp.asarray(s.astype(np.float64)),
                                           jnp.asarray(n_merge))
        js64 = np.asarray(js64)
    rows = off.any(axis=1)
    assert (o[rows] >= 0.999).all() and (n_merge[rows] >= 16).all()
    assert rows.sum() <= 0.05 * rows.size
    np.testing.assert_array_less(
        np.abs(ts - js64)[off],
        (2 * np.abs(js - js64) + 1e-6 * np.abs(js64))[off])


@pytest.mark.parametrize("cap,n_alive", [(256, 200), (2048, 1600)])
def test_relocate_and_grow_match_jax(monkeypatch, cap, n_alive):
    """relocate_dead then add_new_gaussians (as `mcmc_step` chains them) with
    the same draws in both packages, sources drawn with repeats: every
    field, alive and the reset mask after each, the counts and the slots
    written exact. At 200 (1,600) live the float32 growth target is 201
    (1,608), the float64 one 200 (1,607): both packages take float32's."""
    rng = np.random.default_rng(2)
    d = population(cap, n_alive, n_dead=20)
    jg, jalive, tg, talive = both(d)
    o = 1 / (1 + np.exp(-d["opacity_raw"]))
    live = np.flatnonzero(d["alive"] & (o > 0.005))
    dead = np.flatnonzero(d["alive"] & (o <= 0.005))
    reloc = rng.choice(live[:6], 20)                  # repeats: n_merge > 1
    assert len(np.unique(reloc)) < 20
    target = int(np.float32(1.005) * np.float32(n_alive))
    assert target == int(1.005 * n_alive) + 1         # float64 gives one fewer
    grow = rng.choice(np.arange(n_alive), target - n_alive)

    inject(monkeypatch, jmcmc, [reloc, grow], pad_to=cap)
    inject(monkeypatch, tmcmc, [reloc, grow])
    key = jax.random.PRNGKey(0)
    # jitted: each function traces once, taking its injected draws then
    jr1 = jax.jit(jmcmc.relocate_dead)(jg, jalive, key)
    tr1 = tmcmc.relocate_dead(tg, talive, None)
    assert tr1.n_relocated == int(jr1.n_relocated) == 20
    np.testing.assert_array_equal(tr1.reset_mask.numpy(), np.asarray(jr1.reset_mask))
    np.testing.assert_array_equal(np.flatnonzero(tr1.reset_mask.numpy()),
                                  np.union1d(dead, reloc))
    assert_same(tg, jr1.gaussians, tr1.alive, jr1.alive)
    for i, (dst, src) in enumerate(zip(dead, reloc)):   # rank i gets draw i
        for f in ("xyz", "quats", "asg", "sh_rest"):
            np.testing.assert_array_equal(getattr(tg, f)[dst].numpy(), d[f][src])

    jr2 = jax.jit(jmcmc.add_new_gaussians)(jr1.gaussians, jr1.alive, key)
    tr2 = tmcmc.add_new_gaussians(tg, tr1.alive, None)
    assert tr2.n_relocated == int(jr2.n_relocated) == target - n_alive
    assert int(tr2.alive.sum()) == target
    np.testing.assert_array_equal(tr2.reset_mask.numpy(), np.asarray(jr2.reset_mask))
    new = np.arange(n_alive, target)                  # the first non-alive slots
    np.testing.assert_array_equal(np.flatnonzero(tr2.reset_mask.numpy()),
                                  np.union1d(new, grow))
    assert_same(tg, jr2.gaussians, tr2.alive, jr2.alive)


def test_relocation_merges_at_n_merge(monkeypatch):
    """A source drawn k times and its k copies all take `compute_relocation`
    at n_merge k + 1 (clipped at the 0.005 floor and 1 - 1e-7): checked
    from the port's own `compute_relocation`, so that the pairing and the
    merge are tested apart from the parity above."""
    d = population(64, 48, n_dead=6, seed=3)
    _, _, tg, talive = both(d)
    o = 1 / (1 + np.exp(-d["opacity_raw"]))
    live = np.flatnonzero(d["alive"] & (o > 0.005))
    dead = np.flatnonzero(d["alive"] & (o <= 0.005))
    reloc = np.array([live[0]] * 3 + [live[1]] * 2 + [live[2]])
    inject(monkeypatch, tmcmc, [reloc])
    tmcmc.relocate_dead(tg, talive, None)
    for src, k in ((live[0], 3), (live[1], 2), (live[2], 1)):
        no, ns = tmcmc.compute_relocation(
            torch.tensor([o[src]]), torch.exp(torch.as_tensor(d["scales_log"][src:src + 1])),
            torch.tensor([k + 1]))
        no = torch.clamp(no, 0.005, 1 - 1e-7)
        rows = [src] + list(dead[reloc == src])
        assert len(rows) == k + 1
        for r in rows:
            torch.testing.assert_close(torch.sigmoid(tg.opacity_raw[r]), no[0],
                                       rtol=1e-6, atol=0)
            torch.testing.assert_close(tg.scales_log[r], torch.log(ns[0]),
                                       rtol=1e-6, atol=0)


def test_position_noise_matches_jax():
    """The same normal draws (JAX's own, from its key) through both: the new
    xyz within 1e-6 of the largest noise; dead rows unchanged."""
    d = population(256, 200, n_dead=20, seed=4)
    d["opacity_raw"][:100] = -6.0            # gated on: 1 - o > 0.995
    jg, jalive, tg, talive = both(d)
    key = jax.random.PRNGKey(7)
    eps = np.asarray(jax.random.normal(key, (256, 3)))
    jxyz = np.asarray(jax.jit(jmcmc.position_noise)(jg, jalive, key,
                                                    jnp.float32(3e-4)))
    txyz = tmcmc.position_noise(tg, talive, torch.tensor(eps), 3e-4).numpy()
    noise = np.abs(jxyz - d["xyz"]).max()
    assert noise > 1e-3
    np.testing.assert_allclose(txyz, jxyz, atol=1e-6 * noise, rtol=0)
    np.testing.assert_array_equal(txyz[200:], d["xyz"][200:])


def test_sampler_draws_proportional_to_opacity():
    """200,000 draws over 50 live slots of 80 (the others dead or not
    alive): no other slot is drawn, and the counts pass a chi-square test
    against probabilities proportional to opacity (p > 1e-3, fixed seed)."""
    from scipy.stats import chisquare

    d = population(80, 60, n_dead=10, seed=5)
    tg, talive = convert.gaussians_from_numpy(d, device="cpu")
    o = torch.sigmoid(tg.opacity_raw)
    live = talive & (o > 0.005)
    assert int(live.sum()) == 50
    gen = torch.Generator().manual_seed(0)
    draws = tmcmc._sample_by_opacity(gen, tg, live, 200_000)
    counts = torch.bincount(draws, minlength=80).numpy()
    assert counts[~live.numpy()].sum() == 0
    p = o[live].double().numpy()
    expected = 200_000 * p / p.sum()
    assert chisquare(counts[live.numpy()], expected).pvalue > 1e-3
    assert tmcmc._sample_by_opacity(gen, tg, live, 0).numel() == 0
