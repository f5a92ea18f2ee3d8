"""The port's resident engine on the CPU vs the JAX package's, end to end.

Both start from the same host initializer. Collision counts and dead sets
must be exact; positions hold to atol 1e-6·side and velocities to
atol 1e-5·max|v|, because the fused pair sums run in another order (in
practice the trajectories of these short runs agree bit for bit).
"""

import numpy as np
import pytest
import torch

from particlesimulation_tpu.config import Precision as JPrecision
from particlesimulation_tpu.config import SimConfig as JSimConfig
from particlesimulation_tpu.engine import Engine as JEngine
from particlesimulation_tpu.engine import make_resident_run as jmake_resident_run
from particlesimulation_tpu.ops.tiered import plan_tiers as jplan_tiers
from particlesimulation_tpu_torch.config import Precision, SimConfig
from particlesimulation_tpu_torch.engine import (MAX_DENSE_KCAP, Engine,
                                                 _clustered, make_resident_run)
from particlesimulation_tpu_torch.models import Simulation
from particlesimulation_tpu_torch.ops.tiered import plan_tiers
from particlesimulation_tpu_torch.state import state_from_numpy
from tests.test_golden import FAST_VECTORS

torch.set_num_threads(2)

FIELDS = ("x", "y", "vx", "vy", "m", "alive")


def _by_pid(state):
    pid = np.asarray(state.pid)
    order = np.argsort(pid)
    return {f: np.asarray(getattr(state, f))[order] for f in FIELDS}


def _port_by_pid(state):
    order = torch.argsort(state.pid)
    return {f: getattr(state, f)[order].numpy() for f in FIELDS}


def _assert_same_run(got, ref, side):
    assert int(got.collisions) == int(ref.collisions)
    a, b = _port_by_pid(got), _by_pid(ref)
    np.testing.assert_array_equal(a["alive"], b["alive"])
    for f in ("x", "y"):
        np.testing.assert_allclose(a[f], b[f], rtol=0, atol=1e-6 * side)
    vmax = float(np.abs(b["vx"]).max())
    np.testing.assert_allclose(a["vx"], b["vx"], rtol=0, atol=1e-5 * vmax)
    assert int(got.overflow) == 0


@pytest.mark.parametrize("seed,side,nc,n,steps,pair_impl", [
    (5893, 0.08, 4, 120, 5, None),    # v2 force form (side < 100), collisions
    (2, 100.0, 16, 12000, 5, None),   # v4 force form (side >= 100), collisions
    (5893, 0.08, 4, 120, 5, "v1"),    # the ungated v1 kernel
], ids=["v2", "v4", "v1"])
def test_engine_matches_jax_resident(seed, side, nc, n, steps, pair_impl,
                                     monkeypatch):
    if pair_impl is not None:
        monkeypatch.setenv("PSIM_PALLAS_PAIR", pair_impl)
    jeng = JEngine(JSimConfig(seed, side, nc, n, precision=JPrecision.FAST),
                   impl="resident", dense_backend="pallas")
    ref = jeng.run(jeng.init_state(), steps)
    eng = Engine(SimConfig(seed, side, nc, n), impl="resident", device="cpu",
                 pair_impl=pair_impl)
    got = eng.run(eng.init_state(), steps)
    assert eng.kcap == jeng.kcap
    assert int(ref.collisions) > 0
    _assert_same_run(got, ref, side)


def test_prologue_matches_jax_with_limbo():
    """The prologue lays out the tiles exactly as the JAX package's does,
    parking an out-of-range particle in its clamped row (19, 19)."""
    cfg = JSimConfig(seed=1, side=100.0, ncside=20, n_particles=64,
                     precision=JPrecision.FAST)
    state = JEngine(cfg, impl="resident", dense_backend="xla").init_state()
    i0 = int(np.argmin(np.asarray(state.pid)))
    state = state._replace(x=state.x.at[i0].set(100.0),
                           y=state.y.at[i0].set(97.0))
    _, jprologue, _ = jmake_resident_run(cfg, 32)
    ref = jprologue(state)
    prologue, _, _ = make_resident_run(SimConfig(1, 100.0, 20, 64), 32)
    got = prologue(state_from_numpy(
        {f: np.asarray(getattr(state, f)) for f in state._fields}, "cpu"))
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    occ, pid = got.occ.numpy(), got.pid.numpy()
    assert (occ[399] & (pid[399] == 0)).any()


def test_resident_pair_tiles_hold_every_particle():
    """The tiles ``make_resident_run``'s ``pair_tiles`` gives (the chip check
    holds and times the fused kernel on them at the flagship): step n's
    tiles hold every particle alive after n - 1 steps in exactly one alive
    slot, with its mass, and the rows keep the holes rebin leaves."""
    cfg = SimConfig(5893, 0.08, 4, 120)
    eng = Engine(cfg, impl="resident", device="cpu")
    state = eng.init_state()
    _, pair_tiles, run = make_resident_run(cfg, eng.kcap)
    x, y, mf, alive, pid = pair_tiles(state, 3)
    ref = run(state, 2)
    live = ref.alive > 0
    assert int(ref.collisions) > 0 and int(live.sum()) < cfg.n_particles
    assert x.shape == y.shape == (cfg.ncells, eng.kcap)
    assert torch.equal(torch.sort(pid[alive > 0]).values,
                       torch.sort(ref.pid[live]).values)
    assert float(mf.double().sum()) == pytest.approx(
        float(ref.m[live].double().sum()), rel=1e-6)
    used = mf > 0
    assert bool((~used[:, :-1] & used[:, 1:]).any())  # a hole before a slot


@pytest.mark.parametrize("vec", FAST_VECTORS,
                         ids=[f"v{i}" for i in range(len(FAST_VECTORS))])
def test_fast_golden(vec):
    """The reference harness tolerance: coordinates ±0.001, exact count."""
    seed, side, nc, n, steps, ex, ey, ec = vec
    eng = Engine(SimConfig(seed, side, nc, n), impl="resident", device="cpu")
    out = eng.run(eng.init_state(), steps)
    x, y, c = eng.result(out)
    assert abs(x - ex) <= 0.001, f"x: {x:.4f} vs {ex:.3f}"
    assert abs(y - ey) <= 0.001, f"y: {y:.4f} vs {ey:.3f}"
    assert c == ec
    assert int(out.overflow) == 0


@pytest.mark.parametrize("start", ["small", "full"])
def test_capacity_retry_is_lossless(start):
    """Tiles too small at the start (prologue overflow) or filling up during
    the run (undelivered movers) are replayed at a larger kcap; the result
    equals a run started at the census kcap."""
    cfg = SimConfig(seed=1, side=10.0, ncside=2, n_particles=400)
    base = Engine(cfg, impl="resident", device="cpu")
    state = base.init_state()
    ref = base.run(state, 20)
    if start == "small":
        kcap = 8
    else:
        # Exactly the fullest cell's occupancy: its row has no free slot.
        kcap = int(np.bincount(
            (state.y.numpy() // 5).astype(int) * 2
            + (state.x.numpy() // 5).astype(int)).max())
    eng = Engine(cfg, kcap=kcap, impl="resident", device="cpu")
    out = eng.run(state, 20)
    assert eng.kcap > kcap
    _assert_same_run(out, _numpy_state(ref), cfg.side)


def _numpy_state(state):
    return type(state)(*(t.numpy() for t in state))


def test_simulation_facade():
    seed, side, nc, n, steps, ex, ey, ec = FAST_VECTORS[2]
    out = Simulation(seed, side, nc, n, device="cpu").run(steps)
    assert abs(out.particle0[0] - ex) <= 0.001
    assert abs(out.particle0[1] - ey) <= 0.001
    assert out.collisions == ec
    g = out.gather()
    assert (g["pid"] == np.arange(n)).all()


@pytest.mark.parametrize("case", ["banded", "shards", "clustered", "stream"])
def test_unported_engines_raise(case):
    """The sharded engines raise; the banded routes, which raised until the
    banded engine was ported, now build and route: ``impl="banded"`` runs,
    a clustered load with a band plan and a uniform load above 256 MB of
    tiles (init only) go to banded, the latter on a uniform plan."""
    cfg = dict(seed=1, side=100.0, ncside=10, n_particles=2000)
    if case == "shards":
        with pytest.raises(NotImplementedError):
            Engine(SimConfig(**cfg, n_shards=2), device="cpu")
        return
    if case == "banded":
        eng = Engine(SimConfig(**cfg), device="cpu", impl=case)
        out = eng.run(eng.init_state(), 2)
        assert int(out.overflow) == 0 and out.x.shape == (2000,)
    else:
        if case == "clustered":   # normal-mode blob with a band plan
            cfg.update(seed=-7, side=5000.0, ncside=100, n_particles=200_000)
        else:                     # > 256 MB of tiles: banded streaming
            cfg.update(side=600.0, ncside=600, n_particles=540_000)
        eng = Engine(SimConfig(**cfg), device="cpu")
        eng.init_state()
    assert eng.impl == "banded"
    plan = eng._band_plan
    assert sum(rw for _, rw, _ in plan) == cfg["ncside"]
    assert (len({k for _, _, k in plan}) == 1) == (case != "clustered")
    assert len(plan) >= (1 if case == "banded" else 2)


@pytest.mark.parametrize("args", [
    (1, 100.0, 40, 1000),       # sparse, ncside >= 16: supercell
    (50, 10000.0, 1300, 500_000),  # SMALL: supercell, S = 10
    (1, 100.0, 64, 500),        # the JAX test's auto-selected supercell
    (1, 100.0, 97, 2000),       # no divisor of 97: a rounded S
    (1, 100.0, 10, 100),        # sparse, ncside < 16: the sweep
    (1, 2.0, 3, 10),            # golden vector N1's grid: the sweep
    (1, 100.0, 15, 200),        # just under 16: the sweep
])
def test_sparse_census_matches_jax(args):
    """Average occupancy < 1.5: the census takes supercell where the JAX
    package's ``choose_supercell_factor`` gives an S (the same S), and the
    sweep where it gives none, as the JAX census does where tiles are the
    default."""
    from particlesimulation_tpu.ops.supercell import choose_supercell_factor
    s = choose_supercell_factor(JSimConfig(*args))
    eng = Engine(SimConfig(*args), device="cpu")
    assert eng.impl == ("sweep" if s is None else "supercell")
    if s is not None:
        assert eng._supercell_factor() == s


@pytest.mark.parametrize("case", ["sweep", "parity"])
def test_sweep_and_parity_routes_run(case):
    """The config of ``test_unported_engines_raise``, through the f32 sweep
    (``impl="sweep"``) and the f64 parity engine, against the JAX package's
    sweep and parity engines: parity bit for bit, the sweep to f32 rounding
    (other summation orders), collisions and dead sets exact."""
    args = (1, 100.0, 10, 2000)
    if case == "sweep":
        jeng = JEngine(JSimConfig(*args, precision=JPrecision.FAST),
                       impl="sweep")
        eng = Engine(SimConfig(*args), impl="sweep", device="cpu")
    else:
        jeng = JEngine(JSimConfig(*args, precision=JPrecision.PARITY))
        eng = Engine(SimConfig(*args, precision=Precision.PARITY),
                     device="cpu")
    ref = jeng.run(jeng.init_state(), 3)
    got = eng.run(eng.init_state(), 3)
    assert eng.impl == "sweep"
    if case == "parity":
        assert got.x.dtype == torch.float64
        for f in FIELDS + ("pid", "collisions"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(ref, f)))
    else:
        _assert_same_run(got, ref, args[1])


@pytest.mark.parametrize("kind", ["uniform", "blob", "hot_cell"])
def test_clustered_census_matches_jax_planner(kind):
    rng = np.random.default_rng(5)
    ncells = 400
    if kind == "uniform":
        hist = rng.poisson(60, ncells)
    elif kind == "blob":
        hist = rng.poisson(np.exp(-np.linspace(-3, 3, ncells) ** 2) * 900)
    else:
        hist = rng.poisson(40, ncells)
        hist[17] = 700
    plan = jplan_tiers(hist, ncells, MAX_DENSE_KCAP)
    want = plan is not None and plan[-1][0] >= 2 * plan[0][0]
    assert _clustered(plan_tiers(hist, ncells, MAX_DENSE_KCAP)) == want


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(SimConfig(1, 100.0, 10, 2000))
