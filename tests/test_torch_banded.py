"""The port's banded engine on the CPU vs the JAX package's, end to end.

Both start from the same host initializer, on the same band plan. Collision
counts and dead sets must be exact; positions hold to atol 1e-6·side and
velocities to atol 1e-5·max|v| (``_assert_same_run``): the port delivers
cross-band movers in one pass where the JAX engine ships them through halo
rows, so slots lie in another order and the pair sums run in another order.
The JAX banded engine runs its XLA fused functions on the CPU, as
``tests/test_banded.py`` runs it. One JAX banded run costs seconds, so only
the first four tests run it; the rest compare inside the port.
"""

import numpy as np
import pytest
import torch

from particlesimulation_tpu.config import Precision as JPrecision
from particlesimulation_tpu.config import SimConfig as JSimConfig
from particlesimulation_tpu.engine import Engine as JEngine
from particlesimulation_tpu.ops import banded as jbanded
from particlesimulation_tpu_torch import engine as port_engine
from particlesimulation_tpu_torch.config import SimConfig
from particlesimulation_tpu_torch.engine import MAX_DENSE_KCAP, Engine
from particlesimulation_tpu_torch.ops import banded
from particlesimulation_tpu_torch.ops.cuda.launch_sweep import (UNEVEN,
                                                                UNEVEN_BANDS)
from tests.test_golden import FAST_VECTORS
from tests.test_torch_engine import _assert_same_run

torch.set_num_threads(2)

# tests/test_banded.py's configs and plans.
CLUSTERED = ((-7, 100.0, 12, 4000), ((0, 3, 64), (3, 3, 256), (6, 3, 256),
                                     (9, 3, 64)))
MIGRATION = ((5, 8.0, 8, 600), ((0, 2, 64), (2, 2, 64), (4, 2, 64),
                                (6, 2, 64)))
RETRY = ((-3, 50.0, 10, 3000), ((0, 3, 32), (3, 4, 32), (7, 3, 32)))
GOLDEN3 = ((-10, 3.0, 3, 100), ((0, 1, 64), (1, 1, 128), (2, 1, 64)))


def _jax_run(args, steps, impl, plan=None):
    eng = JEngine(JSimConfig(*args, precision=JPrecision.FAST), impl=impl)
    if plan is not None:
        eng._band_plan = plan
    return eng, eng.run(eng.init_state(), steps)


def _port_run(args, steps, plan=None, **kw):
    eng = Engine(SimConfig(*args), device="cpu", **kw)
    state = eng.init_state()
    if plan is not None:
        eng._band_plan = plan
    return eng, eng.run(state, steps)


def _band_of(state, side, nc, plan):
    """Each particle's band (by pid) from its position's grid row."""
    order = torch.argsort(state.pid)
    row = torch.clamp((state.y[order] / (side / nc)).to(torch.int64), 0,
                      nc - 1)
    edges = torch.tensor([r0 for r0, _, _ in plan[1:]])
    return torch.bucketize(row, edges, right=True)


def test_banded_matches_jax_clustered():
    """Normal-mode blob across 4 uneven-K bands: the JAX banded result, no
    pid lost or duplicated, the mass kept."""
    args, plan = CLUSTERED
    _, ref = _jax_run(args, 25, "banded", plan)
    eng, got = _port_run(args, 25, plan, impl="banded")
    assert eng.impl == "banded" and eng._band_plan == plan
    assert eng.kcap == 256
    assert int(got.collisions) > 0
    _assert_same_run(got, ref, args[1])
    assert torch.equal(torch.sort(got.pid).values, torch.arange(args[3]))
    np.testing.assert_allclose(float(got.m.double().sum()),
                               float(np.asarray(ref.m, np.float64).sum()),
                               rtol=1e-6)


def test_banded_migration_across_bands():
    """A fast-moving uniform load on four 2-row bands: the JAX banded result
    after 30 steps, and movers crossed every band boundary, the periodic one
    (last band to first) included."""
    (seed, side, nc, n), plan = MIGRATION
    _, ref = _jax_run((seed, side, nc, n), 30, "banded", plan)
    eng, got = _port_run((seed, side, nc, n), 30, plan, impl="banded")
    assert eng.impl == "banded"
    _assert_same_run(got, ref, side)
    # The crossings, counted over runs of one step each.
    state = eng.init_state()
    crossings = np.zeros((len(plan), len(plan)), np.int64)
    band = _band_of(state, side, nc, plan)
    for _ in range(30):
        state = eng.run(state, 1)
        nxt = _band_of(state, side, nc, plan)
        np.add.at(crossings, (band.numpy(), nxt.numpy()), 1)
        band = nxt
    nb = len(plan)
    for b in range(nb):  # both ways over every boundary, wrap included
        assert crossings[b, (b + 1) % nb] > 0 and crossings[(b + 1) % nb, b] > 0


def test_banded_capacity_retry_lossless():
    """K 32 bands on a blob overflow: the ladder grows the plan (and goes to
    dense after attempt 2) as the JAX ladder does on the same input, and
    loses no particle and no collision against the JAX resident run."""
    args, plan = RETRY
    jeng, jout = _jax_run(args, 10, "banded", plan)
    _, ref = _jax_run(args, 10, "resident")
    eng, got = _port_run(args, 10, plan, impl="banded")
    assert eng.impl == jeng.impl
    assert eng._band_plan == jeng._band_plan
    assert eng.kcap == jeng.kcap
    assert int(got.overflow) == 0
    _assert_same_run(got, jout, args[1])
    assert int(got.collisions) == int(ref.collisions)
    assert torch.equal(torch.sort(got.pid).values, torch.arange(args[3]))


def test_banded_golden_vector_3():
    """Golden vector 3 (-10 3 3 100 10 -> 1.733 1.643 / 2) through forced
    3-band tiles, as the JAX banded engine gives it."""
    args, plan = GOLDEN3
    vec = next(v for v in FAST_VECTORS if v[:4] == args)
    _, ref = _jax_run(args, vec[4], "banded", plan)
    eng, got = _port_run(args, vec[4], plan, impl="banded")
    x, y, c = eng.result(got)
    assert eng.impl == "banded"
    assert (f"{x:.3f} {y:.3f}", c) == ("1.733 1.643", 2)
    _assert_same_run(got, ref, args[1])


@pytest.mark.parametrize("ncside,band_rows,kcap", [
    (316, 27, 192), (16, 1, 32), (16, 5, 64), (10, 10, 96), (7, 100, 32)])
def test_uniform_band_plan_matches_jax(ncside, band_rows, kcap):
    assert banded.uniform_band_plan(ncside, band_rows, kcap) == (
        jbanded.uniform_band_plan(ncside, band_rows, kcap))


@pytest.mark.parametrize("plan,max_kcap", [
    (CLUSTERED[1], 1 << 30), (RETRY[1], MAX_DENSE_KCAP),
    (((0, 41, 896), (41, 59, 32)), MAX_DENSE_KCAP),   # 1344 capped at 1024
    (((0, 4, 1024), (4, 4, 700)), MAX_DENSE_KCAP),
    (((0, 2, 33), (2, 1, 100)), 4096)])
def test_grow_plan_matches_jax(plan, max_kcap):
    assert banded.grow_plan(plan, 1.5, max_kcap) == jbanded.grow_plan(
        plan, 1.5, max_kcap)
    assert max(k for _, _, k in banded.grow_plan(plan, 1.5, max_kcap)) <= (
        max_kcap)


@pytest.mark.parametrize("kind", ["uniform", "rows"])
def test_plan_bands_matches_jax(kind):
    """``tests/test_banded.py::test_plan_bands_shapes``'s histograms: the
    JAX cap (4096) and the port's (1024) give the same plan."""
    if kind == "uniform":
        hist, nc = np.full((20, 20), 9), 20
    else:
        hist, nc = np.ones((64, 64), np.int64), 64
        hist[28:36] = 600
    got = banded.plan_bands(hist, nc, MAX_DENSE_KCAP)
    assert got == jbanded.plan_bands(hist, nc, 4096)
    assert (got is None) == (kind == "uniform")


def test_uniform_plan_matches_resident():
    """Bands all at resident's kcap split the resident engine's pool
    without moving a slot: the same layout, the same delivery, the same
    row sums, so the run is resident's bit for bit on the CPU."""
    args = (2, 100.0, 16, 12000)
    res_eng, ref = _port_run(args, 5, impl="resident")
    plan = banded.uniform_band_plan(args[2], 5, res_eng.kcap)
    eng, got = _port_run(args, 5, plan, impl="banded")
    assert eng.impl == "banded" and len(plan) == 4
    assert int(got.collisions) == int(ref.collisions) > 0
    for f in ("x", "y", "vx", "vy", "m", "alive", "pid"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


@pytest.mark.parametrize("args", [(-7, 5000.0, 100, 200_000), UNEVEN],
                         ids=["blob", "uneven"])
def test_census_routes_clustered_load_like_jax(args, monkeypatch):
    """A clustered load with a band plan goes to banded, with JAX's plan
    (init only, no run)."""
    monkeypatch.setenv("PSIM_DENSE", "1")
    jeng = JEngine(JSimConfig(*args, precision=JPrecision.FAST))
    jeng.init_state()
    eng = Engine(SimConfig(*args), device="cpu")
    eng.init_state()
    assert eng.impl == jeng.impl == "banded"
    assert eng._band_plan == jeng._band_plan
    if args == UNEVEN:
        assert eng._band_plan == UNEVEN_BANDS


@pytest.fixture
def stream_env(monkeypatch):
    """``tests/test_stream_route.py``'s thresholds, on both packages."""
    monkeypatch.setenv("PSIM_DENSE", "1")
    monkeypatch.setenv("PSIM_STREAM_BYTES", "1000")
    monkeypatch.setenv("PSIM_STREAM_BAND_BYTES", "8000")
    monkeypatch.setattr(port_engine, "_STREAM_BYTES", 1000)
    monkeypatch.setattr(port_engine, "_STREAM_BAND_BYTES", 8000)


STREAM = (1, 8.0, 16, 2000)


def test_stream_route_fires_and_matches_resident(stream_env):
    """Above the threshold a uniform load runs banded on JAX's uniform plan,
    with resident's collisions, dead set and positions."""
    jeng = JEngine(JSimConfig(*STREAM, precision=JPrecision.FAST),
                   dense_backend="xla")
    jeng.init_state()
    eng, got = _port_run(STREAM, 5)
    assert eng.impl == jeng.impl == "banded"
    assert eng._band_plan == jeng._band_plan and len(eng._band_plan) >= 2
    _, ref = _port_run(STREAM, 5, impl="resident")
    assert int(got.collisions) == int(ref.collisions)
    assert torch.equal(got.alive, ref.alive)
    np.testing.assert_allclose(got.x.numpy(), ref.x.numpy(), rtol=0,
                               atol=1e-6 * STREAM[1])


def test_stream_route_respects_explicit_impl(stream_env):
    eng, _ = _port_run(STREAM, 2, impl="resident")
    assert eng.impl == "resident"


def test_stream_route_quiet_below_threshold():
    eng, _ = _port_run(STREAM, 2)
    assert eng.impl == "resident"


def test_stream_route_at_1e7():
    """The N scaling row's 1e7 point (seed 1, side 5000, ncside 316): at
    the census kcap 192 its 479 MB of tile state stream through 12 bands,
    eleven of 27 rows and one of 19. The census runs on a Poisson(100)
    histogram here (the host initializer at 1e7 is a chip-run size)."""
    eng = Engine(SimConfig(1, 5000.0, 316, 10_000_000), device="cpu")
    hist = np.random.default_rng(1).poisson(100.0, 316 * 316)
    eng._census(hist, 192)
    assert eng.impl == "banded"
    assert eng._band_plan == jbanded.uniform_band_plan(316, 27, 192)
    assert [rw for _, rw, _ in eng._band_plan] == [27] * 11 + [19]


@pytest.mark.parametrize("args,plan,ends", [
    # Every band at K 32 on a blob whose hottest cell holds ~200: 32, 64,
    # 96, then dense.
    ((-3, 50.0, 10, 3000), ((0, 5, 32), (5, 5, 32)), "dense"),
    # A blob whose hottest cell holds 1116: 256, 384, 576, then dense,
    # whose K goes past the kernels' 1024, so the ladder ends on the sweep.
    ((-3, 10.0, 6, 8000), ((0, 3, 256), (3, 3, 256)), "sweep"),
], ids=["dense", "sweep"])
def test_ladder_leaves_banded(args, plan, ends):
    """A plan whose growth does not converge: the ladder ends on dense (or
    on the sweep above the kernels' cap), with that engine's own result."""
    steps = 3 if ends == "dense" else 1
    eng, got = _port_run(args, steps, plan, impl="banded")
    assert eng.impl == ends and eng._band_plan is None
    _, ref = _port_run(args, steps, impl=ends)
    assert int(got.overflow) == 0
    for f in ("x", "y", "vx", "m", "alive", "pid", "collisions"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
