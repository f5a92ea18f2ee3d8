"""The port's tiered engine and census planners vs the JAX package's.

The JAX tiered engine runs here on its XLA backend (``dense_backend="xla"``,
as ``tests/test_tiered.py`` runs it): its twins compute the Pallas kernels'
function, and the Pallas kernels in interpret mode would take minutes on
these runs. Collision counts and dead sets must be exact; positions hold to
atol 1e-6·side and velocities to atol 1e-5·max|v| (``_assert_same_run``).
Tiered against the port's own dense engine holds to the tolerance
``tests/test_tiered.py`` uses: f32 reduction trees of another shape.
"""

import numpy as np
import pytest
import torch

from particlesimulation_tpu.config import Precision as JPrecision
from particlesimulation_tpu.config import SimConfig as JSimConfig
from particlesimulation_tpu.engine import Engine as JEngine
from particlesimulation_tpu.ops.banded import plan_bands as jplan_bands
from particlesimulation_tpu.ops.tiered import plan_tiers as jplan_tiers
from particlesimulation_tpu_torch.config import SimConfig
from particlesimulation_tpu_torch.engine import MAX_DENSE_KCAP, Engine
from particlesimulation_tpu_torch.ops.banded import plan_bands
from particlesimulation_tpu_torch.ops.tiered import plan_tiers
from tests.test_golden import FAST_VECTORS
from tests.test_torch_engine import _assert_same_run

torch.set_num_threads(2)

CLUSTERED = (-7, 24.0, 12, 2000)


def _hist(kind, ncside=20):
    rng = np.random.default_rng(5)
    n = ncside * ncside
    g = np.linspace(-3, 3, ncside)
    if kind == "uniform":
        return rng.poisson(60, n)
    if kind == "blob":
        return rng.poisson(np.exp(-(g[:, None] ** 2 + g[None, :] ** 2))
                           * 900).reshape(-1)
    hist = rng.poisson(40, n)
    if kind == "hot_cell":
        hist[17] = 700
    else:  # hot cells scattered over the grid: no band plan
        hist[rng.choice(n, 12, replace=False)] = 600
    return hist


@pytest.mark.parametrize("kind", ["uniform", "blob", "hot_cell", "scattered"])
def test_planners_match_jax(kind):
    hist = _hist(kind)
    tiers = plan_tiers(hist, hist.size, MAX_DENSE_KCAP)
    bands = plan_bands(hist.reshape(20, 20), 20, MAX_DENSE_KCAP)
    assert tiers == jplan_tiers(hist, hist.size, MAX_DENSE_KCAP)
    assert bands == jplan_bands(hist.reshape(20, 20), 20, MAX_DENSE_KCAP)
    if kind == "scattered":
        assert tiers is not None and bands is None


def _jax_run(cfg, steps, **kw):
    jeng = JEngine(JSimConfig(*cfg, precision=JPrecision.FAST),
                   dense_backend="xla", **kw)
    return jeng, jeng.run(jeng.init_state(), steps)


def _port_run(cfg, steps, plan=None, **kw):
    eng = Engine(SimConfig(*cfg), device="cpu", **kw)
    state = eng.init_state()
    if plan is not None:
        eng._tier_plan = plan
    return eng, eng.run(state, steps)


def test_tiered_matches_jax_clustered():
    jeng, ref = _jax_run(CLUSTERED, 12, impl="tiered")
    eng, got = _port_run(CLUSTERED, 12, impl="tiered")
    assert eng.impl == jeng.impl == "tiered"
    assert eng._tier_plan == jeng._tier_plan
    assert len(eng._tier_plan) >= 2 and int(ref.collisions) > 0
    _assert_same_run(got, ref, CLUSTERED[1])


def test_tiered_matches_dense():
    _, a = _port_run(CLUSTERED, 12, impl="dense")
    engb, b = _port_run(CLUSTERED, 12, impl="tiered")
    assert engb.impl == "tiered"  # did not escalate away
    assert int(a.collisions) == int(b.collisions)
    assert torch.equal(a.pid, b.pid) and torch.equal(a.alive, b.alive)
    for f in ("x", "y", "vx", "vy", "m"):
        np.testing.assert_allclose(getattr(a, f).numpy(),
                                   getattr(b, f).numpy(), rtol=2e-5,
                                   atol=2e-5, err_msg=f)
    assert int(b.overflow) == 0


def test_engine_tiles_hold_every_particle():
    """The dense and tiered engines' tiles as the launch sweep and the chip
    check take them: every live particle's mass in exactly one slot, and a
    stencil row of 8 per tile row."""
    from particlesimulation_tpu_torch.engine import make_dense_step
    from particlesimulation_tpu_torch.ops.cuda.launch_sweep import (
        class_tiles, dense_tiles)

    config = SimConfig(*CLUSTERED)
    eng = Engine(config, device="cpu", impl="tiered")
    state = eng.init_state()
    total = float(state.m[state.alive > 0].double().sum())
    classes = class_tiles(config, eng._tier_plan, state)
    deng = Engine(config, device="cpu", impl="dense")
    dstate = deng.init_state()  # sorted by (cell, pid), as the step wants
    dense = dense_tiles(config,
                        make_dense_step(config, deng.kcap)[1](dstate))
    assert len(classes) == len(eng._tier_plan) >= 2
    for (k, r), tiles in zip(eng._tier_plan, classes):
        assert tiles[0].shape == (r, k)
        assert all(t.shape == (r, 8) for t in tiles[3:])
    for sets in (classes, [dense]):
        got = sum(float(t[2].double().sum()) for t in sets)
        assert got == pytest.approx(total, rel=1e-6)
        assert sum(int((t[2] > 0).sum()) for t in sets) == int(
            (state.alive > 0).sum())


def test_tiered_overflow_retry_lossless():
    """An undersized plan (top cap below the real max occupancy) heals
    through the retry ladder and matches the right-sized run."""
    _, ref = _port_run(CLUSTERED, 12, impl="tiered")
    eng, out = _port_run(CLUSTERED, 12, plan=((16, 144), (32, 256)),
                         impl="tiered")
    assert eng.impl == "tiered"  # healed without falling back to dense
    assert eng._tier_plan[-1][0] > 32
    assert int(ref.collisions) == int(out.collisions)
    assert torch.equal(ref.alive, out.alive)
    for f in ("x", "y"):
        np.testing.assert_allclose(getattr(ref, f).numpy(),
                                   getattr(out, f).numpy(), rtol=2e-5,
                                   atol=2e-5, err_msg=f)


def test_tiered_row_deficit_grows_rows():
    """A class with too few rows flags a negative overflow; the ladder grows
    every class's rows, as the JAX ladder does."""
    _, ref = _port_run(CLUSTERED, 4, impl="tiered")
    # 52 cells hold more than 8 particles: class 1 lacks 20 rows.
    eng, out = _port_run(CLUSTERED, 4, plan=((8, 144), (256, 32)),
                         impl="tiered")
    assert eng.impl == "tiered"
    assert eng._tier_plan[0] == (8, 144) and eng._tier_plan[1][1] > 32
    assert int(out.collisions) == int(ref.collisions)
    assert torch.equal(out.alive, ref.alive)


@pytest.mark.parametrize("vec", FAST_VECTORS,
                         ids=[f"v{i}" for i in range(len(FAST_VECTORS))])
def test_fast_golden_tiered(vec):
    """The reference harness tolerance: coordinates ±0.001, exact count."""
    seed, side, nc, n, steps, ex, ey, ec = vec
    eng, out = _port_run((seed, side, nc, n), steps, impl="tiered")
    x, y, c = eng.result(out)
    assert abs(x - ex) <= 0.001, f"x: {x:.4f} vs {ex:.3f}"
    assert abs(y - ey) <= 0.001, f"y: {y:.4f} vs {ey:.3f}"
    assert c == ec
    assert int(out.overflow) == 0


# A clustered load with a band plan: the JAX census routes it to banded
# (tests/test_tiered.py), and the port's raises there
# (tests/test_torch_engine.py::test_unported_engines_raise[clustered]).
BANDED_LOAD = SimConfig(-7, 5000.0, 100, 200_000)


def test_census_honours_clustered_impl_tiered(monkeypatch):
    monkeypatch.setenv("PSIM_DENSE", "1")
    monkeypatch.setenv("PSIM_CLUSTERED_IMPL", "tiered")
    jeng = JEngine(JSimConfig(-7, 5000.0, 100, 200_000,
                              precision=JPrecision.FAST))
    jeng.init_state()
    eng = Engine(BANDED_LOAD, device="cpu", clustered_impl="tiered")
    eng.init_state()
    assert eng.impl == jeng.impl == "tiered"
    assert eng._tier_plan == jeng._tier_plan


def test_census_routes_load_without_band_plan_to_tiered(monkeypatch):
    """-23 100 20 20000 is clustered and has no band plan: the JAX census
    runs it on the tiered engine, and so does the port's."""
    monkeypatch.setenv("PSIM_DENSE", "1")
    cfg = (-23, 100.0, 20, 20_000)
    jeng, ref = _jax_run(cfg, 3)
    eng, got = _port_run(cfg, 3)
    assert eng.impl == jeng.impl == "tiered"
    assert eng._tier_plan == jeng._tier_plan == ((96, 400), (416, 96))
    _assert_same_run(got, ref, cfg[1])
