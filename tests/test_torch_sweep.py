"""The port's sweep engine (f64 parity and f32) vs the JAX package's.

The same NumPy inputs, made from seeds, go through the JAX functions and the
port's. Tolerances:

* parity (float64): bit for bit — COM, the force sweeps (the port's global
  form and its occupancy sweep against JAX's global and blocked forms), the
  engine step by step against ``tests/oracle_np.NpOracle`` and the whole
  state against the JAX parity engine;
* collisions (both precisions): count and dead set exact;
* f32: COM and forces within rtol 1e-5 of the JAX values plus 1e-6·max|f|
  (other summation orders; torch.rsqrt and XLA's may differ by an ulp);
  golden vectors at the reference harness's ±0.001, the count exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesimulation_tpu.config import Precision as JPrecision
from particlesimulation_tpu.config import SimConfig as JSimConfig
from particlesimulation_tpu.engine import Engine as JEngine
from particlesimulation_tpu.ops import collisions as jcollisions
from particlesimulation_tpu.ops import com as jcom
from particlesimulation_tpu.ops import forces as jforces
from particlesimulation_tpu_torch import engine as engine_mod
from particlesimulation_tpu_torch.config import EPSILON, Precision, SimConfig
from particlesimulation_tpu_torch.engine import Engine, make_step
from particlesimulation_tpu_torch.initializer import init_particles_host
from particlesimulation_tpu_torch.models import Simulation
from particlesimulation_tpu_torch.ops import binning, collisions, com, forces
from tests.oracle_np import NpOracle
from tests.test_golden import FAST_VECTORS
from tests.test_step_vs_oracle import _unsorted_view

torch.set_num_threads(2)

FIELDS = ("x", "y", "vx", "vy", "m", "alive", "pid")

# (n, side, ncside, hot cell (fraction, cx, cy) or None)
CONFIGS = [
    (300, 4.0, 3, None),             # small, dense cells
    (1000, 10.0, 7, (0.4, 2, 3)),    # hot cell: 40% of the particles
    (2000, 50.0, 20, (0.2, 0, 0)),   # hot corner cell, sparse background
    (37, 2.0, 2, None),              # ncside 2: stencil aliasing
    (60, 1.0, 1, None),              # ncside 1: one cell
]
IDS = ["dense", "hot", "corner", "nc2", "nc1"]


def _inputs(n, side, nc, cluster, dtype, seed, chains=False):
    """Random particles sorted by (key, pid), as NumPy arrays: x, y, m,
    alive, key, pos, and kmax. Dead particles carry m = 0, as in the
    engines; ``chains`` plants ε-near triples so that collisions occur."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, side, n)
    y = rng.uniform(0, side, n)
    if cluster:
        frac, cx, cy = cluster
        k = int(n * frac)
        w = side / nc
        x[:k] = rng.uniform(cx * w, (cx + 1) * w, k)
        y[:k] = rng.uniform(cy * w, (cy + 1) * w, k)
    if chains:
        for i in range(0, n - 3, 7):
            x[i + 1] = x[i + 2] = x[i]
            y[i + 1] = y[i] + EPSILON / 3
            y[i + 2] = y[i] - EPSILON / 3
    m = rng.uniform(0.5, 2.0, n)
    alive = rng.uniform(size=n) > 0.1
    m[~alive] = 0.0
    x, y, m = (torch.from_numpy(a.astype(dtype)) for a in (x, y, m))
    key, _ = binning.cell_keys(x, y, side, nc)
    key, _, x, y, m, alive = binning.sort_by_cell(
        key, torch.arange(n, dtype=torch.int32), x, y, m,
        torch.from_numpy(alive))
    pos, _ = binning.segment_positions(key)
    kmax = int(binning.max_occupancy(pos, key < nc * nc))
    return [a.numpy() for a in (x, y, m, alive, key, pos)] + [kmax]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _eq(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_com_parity_bitexact_vs_jax_incl_dead():
    """Dead massless particles first in a cell (the cell adopts the next
    particle's position) and inside massive cells (``(mx*m + 0*x)/m``)."""
    x, y, m, alive, key, pos, kmax = _inputs(400, 4.0, 3, None, np.float64, 3)
    first = np.flatnonzero(pos == 0)
    m[first[:4]] = 0.0           # a dead particle opens four cells
    m[first[4] + 1] = 0.0        # and sits inside a massive one
    m[first[5]:first[5] + 3] = 0.0  # three in a row open a cell
    ncells = 9
    got = com.com_parity(*_t(key, x, y, m), ncells)
    ref = jcom.com_parity(*_j(key, x, y, m), ncells)
    for a, b in zip(got, ref):
        _eq(a, b)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_com_fast_vs_jax(cfg):
    x, y, m, alive, key, pos, kmax = _inputs(*cfg, np.float32, 4)
    ncells = cfg[2] ** 2
    got = com.com_fast(*_t(key, x, y, m), ncells)
    ref = jcom.com_fast(*_j(key, x, y, m), ncells)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7 * cfg[1])


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_parity_force_sweeps_bitexact_vs_jax(cfg):
    """The port's global sweep and its occupancy sweep (the engine's) equal
    JAX's global and blocked sweeps bit for bit, and each other."""
    x, y, m, alive, key, pos, kmax = _inputs(*cfg, np.float64, 5)
    ncells = cfg[2] ** 2
    glob = forces.pairwise_forces_parity(*_t(x, y, m, alive, key), kmax,
                                         ncells)
    occ = forces.pairwise_forces_parity_blocked(*_t(x, y, m, alive, key),
                                                ncells)
    jglob = jforces.pairwise_forces_parity(*_j(x, y, m, alive, key), kmax,
                                           ncells)
    jblk = jforces.pairwise_forces_parity_blocked(
        *_j(x, y, m, alive, key), kmax, ncells, block=128)
    for got in (glob, occ):
        for a, b, c in zip(got, jglob, jblk):
            _eq(a, b)
            _eq(a, c)
    assert float(glob[0].abs().max()) > 0


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_fast_forces_and_monopole_vs_jax(cfg):
    x, y, m, alive, key, pos, kmax = _inputs(*cfg, np.float32, 6)
    side, nc = cfg[1], cfg[2]
    ncells = nc * nc
    fx, fy = forces.pairwise_forces_fast(*_t(x, y, m, alive, key), ncells)
    jfx, jfy = jforces.pairwise_forces_fast(*_j(x, y, m, alive, key), kmax,
                                            ncells)
    rng = np.random.default_rng(7)
    tables = [rng.uniform(0.0, 2.0, (8, ncells + 1)).astype(np.float32),
              rng.uniform(-side, 2 * side, (8, ncells + 1)).astype(np.float32),
              rng.uniform(-side, 2 * side, (8, ncells + 1)).astype(np.float32)]
    got = forces.monopole_forces(*_t(x, y, m, alive, key), fx, fy,
                                 *_t(*tables), ncells)
    ref = jforces.monopole_forces(*_j(x, y, m, alive, key), jfx, jfy,
                                  *_j(*tables), ncells, False)
    for a, b in zip((fx, fy) + tuple(got), (jfx, jfy) + tuple(ref)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(b).max()))


def test_monopole_parity_bitexact_vs_jax():
    x, y, m, alive, key, pos, kmax = _inputs(300, 4.0, 3, None, np.float64, 8)
    rng = np.random.default_rng(9)
    tables = [rng.uniform(0.0, 2.0, (8, 10)), rng.uniform(-4, 8, (8, 10)),
              rng.uniform(-4, 8, (8, 10))]
    c0 = key[0]
    tables[1][2, c0], tables[2][2, c0] = x[0], y[0]  # a zero distance
    f0 = rng.uniform(-1, 1, (2, len(x)))
    got = forces.monopole_forces(*_t(x, y, m, alive, key, *f0, *tables), 9)
    ref = jforces.monopole_forces(*_j(x, y, m, alive, key, *f0, *tables), 9,
                                  True)
    for a, b in zip(got, ref):
        _eq(a, b)


@pytest.mark.parametrize(
    "cfg,dtype", [(c, np.float64) for c in CONFIGS]
    + [(CONFIGS[0], np.float32), (CONFIGS[1], np.float32)],
    ids=[f"{i}-f64" for i in IDS] + ["dense-f32", "hot-f32"])
def test_collisions_exact_vs_jax(cfg, dtype):
    x, y, m, alive, key, pos, kmax = _inputs(*cfg, dtype, 10, chains=True)
    ncells = cfg[2] ** 2
    args = _t(x, y, alive, key, pos)
    jargs = _j(x, y, alive, key, pos)
    cnt_g, died_g = collisions.detect_collisions(*args, kmax, EPSILON, ncells)
    cnt_b, died_b = collisions.detect_collisions_blocked(*args, EPSILON,
                                                         ncells)
    jcnt, jdied = jcollisions.detect_collisions(*jargs, jnp.int32(kmax),
                                               EPSILON, ncells)
    jcnt_b, jdied_b = jcollisions.detect_collisions_blocked(
        *jargs, jnp.int32(kmax), EPSILON, ncells, block=128)
    assert int(jcnt) == int(jcnt_b) == int(cnt_g) == int(cnt_b) > 0
    for died in (died_g, died_b):
        _eq(died, jdied)
        _eq(died, jdied_b)


def test_occupancy_plan():
    key = torch.tensor([0, 0, 0, 2, 2, 5, 9, 9], dtype=torch.int32)
    plan = binning.occupancy(key, 9)
    assert (plan.kmax, plan.lanes, plan.cells) == (3, [6, 5, 3], [3, 2, 1])
    assert plan.order.tolist() == [0, 1, 2, 3, 4, 5, 6, 7]
    key = torch.tensor([1, 3, 3, 4, 4, 4], dtype=torch.int32)
    plan = binning.occupancy(key, 9)
    assert plan.order.tolist() == [3, 4, 5, 1, 2, 0]
    _eq(forces.cell_occupancy_per_lane(key),
        jforces.cell_occupancy_per_lane(jnp.asarray(key.numpy())))


@pytest.mark.parametrize(
    "seed,side,nc,n,steps",
    [
        (1, 2.0, 3, 10, 5),
        (1, 1.0, 5, 100, 10),
        (-10, 3.0, 3, 100, 10),
        (5893, 0.05, 3, 10, 10),   # tiny domain → collisions
        (8555, 0.05, 3, 30, 20),   # more collisions, multi-death cells
        (7, 0.08, 2, 40, 15),      # ncside=2: stencil aliasing
        (9, 0.05, 1, 12, 15),      # ncside=1: full aliasing, single cell
    ],
)
def test_parity_engine_step_bitexact_vs_oracle(seed, side, nc, n, steps):
    cfg = SimConfig(seed, side, nc, n, precision=Precision.PARITY)
    eng = Engine(cfg, device="cpu")
    state = eng.init_state()
    assert eng.impl == "sweep" and state.x.dtype == torch.float64
    oracle = NpOracle(side, nc, *init_particles_host(cfg))
    for t in range(steps):
        state = eng.run_debug(state, 1)
        oracle.step()
        got = _unsorted_view(state)
        for f in ("x", "y", "vx", "vy", "m", "alive"):
            np.testing.assert_array_equal(got[f], getattr(oracle, f),
                                          err_msg=f"{f} step {t}")
        assert int(state.collisions) == oracle.collisions, f"step {t}"


@pytest.mark.parametrize("seed,side,nc,n,steps", [
    (8555, 0.05, 3, 30, 20),     # multi-death cells (8 collisions)
    (3, 40.0, 6, 2000, 4),       # ~55 particles a cell
])
def test_parity_engine_bitexact_vs_jax(seed, side, nc, n, steps):
    """The whole state, field by field, against the JAX parity engine."""
    jeng = JEngine(JSimConfig(seed, side, nc, n, precision=JPrecision.PARITY))
    ref = jeng.run(jeng.init_state(), steps)
    eng = Engine(SimConfig(seed, side, nc, n, precision=Precision.PARITY),
                 impl="resident", device="cpu")
    got = eng.run(eng.init_state(), steps)
    assert eng.impl == "sweep"
    for f in FIELDS + ("collisions", "panics"):
        _eq(getattr(got, f), getattr(ref, f))


def test_run_matches_stepwise():
    cfg = SimConfig(5893, 0.05, 3, 10, precision=Precision.PARITY)
    eng = Engine(cfg, device="cpu")
    a = eng.run(eng.init_state(), 10)
    b = eng.run_debug(eng.init_state(), 10)
    for f in FIELDS + ("collisions",):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("precision", ["parity", "fast"])
@pytest.mark.parametrize("vec", FAST_VECTORS,
                         ids=[f"v{i}" for i in range(len(FAST_VECTORS))])
def test_golden_through_the_sweep(vec, precision):
    """Parity must give the golden values exactly (at 3 decimals, as the
    reference prints them); the f32 sweep within the harness's ±0.001."""
    seed, side, nc, n, steps, ex, ey, ec = vec
    eng = Engine(SimConfig(seed, side, nc, n, precision=Precision(precision)),
                 impl="sweep", device="cpu")
    out = eng.run(eng.init_state(), steps)
    x, y, c = eng.result(out)
    assert c == ec and int(out.overflow) == 0
    if precision == "parity":
        assert f"{x:.3f} {y:.3f}" == f"{ex:.3f} {ey:.3f}"
    else:
        assert abs(x - ex) <= 0.001 and abs(y - ey) <= 0.001, (x, y)


def test_fast_sweep_vs_jax_sweep():
    cfg = (-10, 3.0, 3, 100)
    jeng = JEngine(JSimConfig(*cfg, precision=JPrecision.FAST), impl="sweep")
    ref = jeng.run(jeng.init_state(), 10)
    eng = Engine(SimConfig(*cfg), impl="sweep", device="cpu")
    got = eng.run(eng.init_state(), 10)
    assert got.x.dtype == torch.float32
    _eq(got.collisions, ref.collisions)
    a, b = _unsorted_view(got), _unsorted_view(ref)
    np.testing.assert_array_equal(a["alive"], b["alive"])
    for f in ("x", "y"):
        np.testing.assert_allclose(a[f], b[f], rtol=0, atol=1e-5 * cfg[1])


def test_census_sends_small_sparse_grids_to_the_sweep():
    eng = Engine(SimConfig(1, 2.0, 3, 10), device="cpu")
    assert eng.impl == "sweep"
    x, y, c = eng.result(eng.run(eng.init_state(), 1))
    assert (f"{x:.3f} {y:.3f}", c) == ("1.570 0.056", 0)


def test_rank_overflow_guard(monkeypatch):
    """A cell at or above RANK_LIMIT occupants must raise, not corrupt the
    set rule. The limit is lowered (65535 occupants would take too long)."""
    monkeypatch.setattr(collisions, "RANK_LIMIT", 8)
    eng = Engine(SimConfig(1, 1.0, 1, 32, precision=Precision.PARITY),
                 device="cpu")
    with pytest.raises(RuntimeError, match="rank overflow"):
        eng.run(eng.init_state(), 1)
    assert not collisions.rank_overflow(7) and collisions.rank_overflow(8)


def test_make_step_reads_the_occupancy_once_a_step(monkeypatch):
    """One occupancy read a step, plus one at the start of a run."""
    calls = []
    real = binning.occupancy
    monkeypatch.setattr(binning, "occupancy",
                        lambda *a: calls.append(1) or real(*a))
    cfg = SimConfig(1, 1.0, 5, 100, precision=Precision.PARITY)
    eng = Engine(cfg, device="cpu")
    _, run = make_step(cfg)
    run(eng.init_state(), 3)
    assert len(calls) == 4
    assert engine_mod.RANK_OVF > engine_mod.MAX_DENSE_KCAP


def test_simulation_facade_parity():
    seed, side, nc, n, steps, ex, ey, ec = FAST_VECTORS[3]
    out = Simulation(seed, side, nc, n, precision="parity",
                     device="cpu").run(steps)
    assert out.engine.impl == "sweep"
    assert f"{out.particle0[0]:.3f} {out.particle0[1]:.3f}" == \
        f"{ex:.3f} {ey:.3f}"
    assert out.collisions == ec
    assert out.gather()["x"].dtype == np.float64
