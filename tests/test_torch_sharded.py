"""The port's mesh engine (``parallel/sharded``) on the CPU, against the JAX
package's ``ShardedEngine`` and the port's single-device engines.

JAX runs on the 8 virtual CPU devices of the test bootstrap; the port on
its local mesh (D shards in one process). Each JAX run happens once, in a
module-scoped cache, and several checks read it.

* Parity (f64): the port's mesh run equals the port's single-device parity
  run, the NumPy oracle and JAX's mesh run bit for bit, every field by
  pid, on even, uneven and D = 1 decompositions (tests/test_sharded.py's
  configs; see ``test_parity_mesh_bitwise`` for the one place JAX's jitted
  engines leave the oracle's bits).
* Fast (f32 resident tiles): collision counts and dead sets exact,
  positions within 1e-6·side and velocities within 1e-5·max|v|
  (``test_torch_engine._assert_same_run``), against JAX's sharded resident
  run and the port's single-device resident run
  (tests/test_sharded_resident.py's configs).
"""

import numpy as np
import pytest
import torch

from particlesimulation_tpu.config import Precision as JPrecision
from particlesimulation_tpu.config import SimConfig as JSimConfig
from particlesimulation_tpu.engine import Engine as JEngine
from particlesimulation_tpu.parallel.balance import (
    plan_shard_rows as jplan_shard_rows)
from particlesimulation_tpu.parallel.sharded import (
    ShardedEngine as JShardedEngine)
from particlesimulation_tpu_torch import engine as port_engine
from particlesimulation_tpu_torch.config import Precision, SimConfig
from particlesimulation_tpu_torch.engine import Engine
from particlesimulation_tpu_torch.initializer import init_particles_host
from particlesimulation_tpu_torch.ops import collisions
from particlesimulation_tpu_torch.ops.cuda import cell_pairs
from particlesimulation_tpu_torch.parallel.balance import plan_shard_rows
from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine
from particlesimulation_tpu_torch.parallel.sharded_resident import (
    make_sharded_resident_run)
from tests.oracle_np import NpOracle

torch.set_num_threads(2)

FIELDS = ("pid", "x", "y", "vx", "vy", "m", "alive")
# tests/test_sharded.py: even (:38-46), uneven (:79), the ring wrap (:102,
# default capacities), and D = 1 (tests/test_sharded_resident.py:52).
PARITY = [
    (1, 2.0, 8, 200, 10, 8),
    (1, 1.0, 8, 500, 15, 4),
    (-10, 3.0, 16, 300, 10, 8),
    (5893, 0.05, 8, 64, 12, 8),   # collisions + migration in a tiny box
    (17, 0.12, 4, 120, 20, 2),
    (1, 2.0, 9, 200, 10, 4),      # 9 rows on 4 shards: 3+2+2+2
    (-10, 3.0, 13, 300, 10, 8),   # 13 rows on 8 shards
    (17, 0.12, 5, 120, 20, 3),    # 2+2+1
    (5893, 0.05, 8, 64, 12, 7),   # a shard count not a power of two
    (3, 8.0, 8, 400, 30, 8),      # fast movers across the wrapping row
    (17, 0.12, 4, 120, 20, 1),    # D = 1: the ring wraps onto itself
]
# tests/test_sharded_resident.py:44-52.
RESIDENT = [
    (5893, 0.05, 8, 64, 12, 8),   # collisions + migration, tiny box
    (-10, 3.0, 16, 300, 10, 8),   # normal-mode clustering
    (1, 2.0, 9, 200, 10, 4),      # uneven 9 rows / 4 shards
    (-10, 3.0, 13, 300, 10, 8),   # uneven 13 rows / 8 shards
    (17, 0.12, 4, 120, 20, 1),    # D = 1: the ring wraps onto itself
    (3, 8.0, 8, 400, 30, 8),      # fast movers, wraparound row
]
_JAX = {}


def _full_slabs(args):
    """tests/test_sharded.py's capacities: full-size slabs, except for the
    ring wrap, which runs the defaults."""
    n = args[3]
    return {} if args[0] == 3 else dict(shard_capacity=n,
                                        migration_capacity=n)


def _jax_mesh(args, precision):
    """The JAX ShardedEngine's run, once per config: (gathered, count)."""
    key = (args, precision)
    if key not in _JAX:
        seed, side, nc, n, steps, d = args
        if precision == "parity":
            eng = JShardedEngine(JSimConfig(
                seed, side, nc, n, precision=JPrecision.PARITY, n_shards=d,
                **_full_slabs(args)))
        else:
            eng = JShardedEngine(JSimConfig(
                seed, side, nc, n, precision=JPrecision.FAST, n_shards=d),
                impl="resident")
        out = eng.run(eng.init_state(), steps)
        assert int(np.asarray(out.overflow)) == 0
        _JAX[key] = (eng.gather(out), int(np.asarray(out.collisions)))
    return _JAX[key]


def _jax_single(args):
    """The JAX single-device parity run by pid, once per config."""
    seed, side, nc, n, steps, _ = args
    key = (args[:5], "single")
    if key not in _JAX:
        eng = JEngine(JSimConfig(seed, side, nc, n,
                                 precision=JPrecision.PARITY))
        out = eng.run(eng.init_state(), steps)
        order = np.argsort(np.asarray(out.pid))
        _JAX[key] = {f: np.asarray(getattr(out, f))[order] for f in FIELDS}
    return _JAX[key]


def _single(state):
    """A single-device port state by pid, as NumPy arrays."""
    order = torch.argsort(state.pid)
    return {f: getattr(state, f)[order].numpy() for f in FIELDS}


def _assert_close(got, ref, side):
    """Fast-path tolerance: dead sets exact, positions within 1e-6·side,
    velocities within 1e-5·max|v|."""
    np.testing.assert_array_equal(got["pid"], ref["pid"])
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    for f in ("x", "y"):
        np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=1e-6 * side)
    vmax = float(np.abs(ref["vx"]).max())
    np.testing.assert_allclose(got["vx"], ref["vx"], rtol=0,
                               atol=1e-5 * vmax)


@pytest.mark.parametrize("args", PARITY, ids=lambda a: "_".join(map(str, a)))
def test_parity_mesh_bitwise(args):
    """Port mesh == port single device == the NumPy oracle (the reference's
    arithmetic, ``tests/oracle_np``) == JAX mesh, bit for bit.

    On the tiny box (5893 0.05 8 64) the JAX engines, single-device and
    mesh alike, round one particle's y a few ulps off the oracle (XLA's
    jitted integrate; its eager ops give the oracle's bits): there the port
    is held to the oracle, and the JAX mesh to the JAX single-device run bit
    for bit and to the oracle in every field but that one y, within 4
    ulps."""
    seed, side, nc, n, steps, d = args
    eng = ShardedEngine(SimConfig(seed, side, nc, n,
                                  precision=Precision.PARITY, n_shards=d,
                                  **_full_slabs(args)), device="cpu")
    out = eng.run(eng.init_state(), steps)
    got = eng.gather(out)
    assert eng.impl == "sweep" and out.x.dtype == torch.float64
    assert int(out.overflow) == 0
    single = Engine(SimConfig(seed, side, nc, n, precision=Precision.PARITY),
                    device="cpu")
    ss = single.run(single.init_state(), steps)
    oracle = NpOracle(side, nc, *init_particles_host(single.config))
    for _ in range(steps):
        oracle.step()
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], _single(ss)[f], err_msg=f)
        if f != "pid":
            np.testing.assert_array_equal(got[f], getattr(oracle, f),
                                          err_msg=f)
    assert int(out.collisions) == int(ss.collisions) == oracle.collisions
    ref, ref_count = _jax_mesh(args, "parity")
    assert ref_count == oracle.collisions
    if args[:4] != (5893, 0.05, 8, 64):
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
        return
    jsingle = _jax_single(args)
    for f in FIELDS:
        np.testing.assert_array_equal(ref[f], jsingle[f], err_msg=f)
        if f not in ("pid", "y"):
            np.testing.assert_array_equal(ref[f], getattr(oracle, f),
                                          err_msg=f)
    assert np.count_nonzero(ref["y"] != oracle.y) <= 1
    np.testing.assert_array_max_ulp(ref["y"], oracle.y, maxulp=4)


@pytest.mark.parametrize("args", RESIDENT,
                         ids=lambda a: "_".join(map(str, a)))
def test_resident_mesh_matches(args):
    """Fast mesh: JAX's sharded resident result and the port's single-device
    resident one, to the f32 tolerance; no pid lost or duplicated."""
    seed, side, nc, n, steps, d = args
    eng = ShardedEngine(SimConfig(seed, side, nc, n, n_shards=d),
                        impl="resident", device="cpu")
    out = eng.run(eng.init_state(), steps)
    assert eng.impl == "resident" and int(out.overflow) == 0
    got = eng.gather(out)
    np.testing.assert_array_equal(got["pid"], np.arange(n))
    ref, ref_count = _jax_mesh(args, "fast")
    single = Engine(SimConfig(seed, side, nc, n), impl="resident",
                    device="cpu")
    ss = single.run(single.init_state(), steps)
    assert int(out.collisions) == ref_count == int(ss.collisions)
    _assert_close(got, ref, side)
    _assert_close(got, _single(ss), side)


@pytest.mark.parametrize("precision", ["parity", "fast"])
def test_chunked_runs_compose(precision):
    """run(10) + run(10) == run(20): the slab <-> tile round trip between
    runs loses nothing. Parity bit for bit; fast to the f32 tolerance, with
    the count and dead set exact (each run's prologue lays a cell's
    particles out in pid order, so the pair sums of a chunked run go in
    another slot order than those of the run that did not stop)."""
    cfg = SimConfig(3, 8.0, 8, 400, precision=Precision(precision),
                    n_shards=8)
    e1 = ShardedEngine(cfg, device="cpu")
    s1 = e1.run(e1.run(e1.init_state(), 10), 10)
    e2 = ShardedEngine(cfg, device="cpu")
    s2 = e2.run(e2.init_state(), 20)
    g1, g2 = e1.gather(s1), e2.gather(s2)
    assert int(s1.collisions) == int(s2.collisions)
    if precision == "fast":
        _assert_close(g1, g2, cfg.side)
        return
    for f in FIELDS:
        np.testing.assert_array_equal(g1[f], g2[f], err_msg=f)


@pytest.mark.parametrize("weights", ["uniform", "blob", "random"])
def test_plan_shard_rows_equals_jax(weights):
    rng = np.random.default_rng(7)
    y = np.arange(100)
    w = {"uniform": np.full(100, 50),
         "blob": (1e6 * np.exp(-((y - 50) / 15.0) ** 2 / 2)
                  / np.sqrt(2 * np.pi) / 15).astype(int),
         "random": rng.integers(0, 1000, 100) ** 3}[weights]
    for d in (2, 3, 8, 13):
        assert plan_shard_rows(w, d) == jplan_shard_rows(w, d)
    assert (plan_shard_rows(w, 8) is None) == (weights == "uniform")


def test_balanced_parity_bitwise():
    """A normal-mode blob on 8 shards: the census plans uneven row
    boundaries (JAX's), and the f64 run stays bitwise equal to JAX's mesh
    run and to the single device (tests/test_shard_balance.py:49)."""
    base = (-4, 12.0, 24, 800)
    cfg = dict(precision=Precision.PARITY, n_shards=8, shard_capacity=800,
               migration_capacity=800)
    eng = ShardedEngine(SimConfig(*base, **cfg), device="cpu")
    state = eng.init_state()
    rows = np.diff(list(eng.config.row_starts) + [24])
    assert eng.config.row_starts and rows.max() > rows.min()
    out = eng.run(state, 12)
    jeng = JShardedEngine(JSimConfig(*base, precision=JPrecision.PARITY,
                                     n_shards=8, shard_capacity=800,
                                     migration_capacity=800))
    jout = jeng.run(jeng.init_state(), 12)
    assert jeng.config.row_starts == eng.config.row_starts
    single = Engine(SimConfig(*base, precision=Precision.PARITY),
                    device="cpu")
    ss = single.run(single.init_state(), 12)
    got, ref = eng.gather(out), jeng.gather(jout)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
        np.testing.assert_array_equal(got[f], _single(ss)[f], err_msg=f)
    assert int(out.collisions) == int(ss.collisions)


def test_balanced_resident_matches_single():
    """Forced uneven boundaries on resident tiles: collision count and dead
    set of the single device (tests/test_shard_balance.py:80)."""
    base = (-6, 8.0, 16, 900)
    eng = ShardedEngine(SimConfig(*base, n_shards=4, shard_capacity=900,
                                  migration_capacity=900,
                                  row_starts=(0, 6, 10, 14)),
                        impl="resident", device="cpu")
    out = eng.run(eng.init_state(), 15)
    single = Engine(SimConfig(*base), impl="resident", device="cpu")
    ss = single.run(single.init_state(), 15)
    assert int(out.collisions) == int(ss.collisions)
    _assert_close(eng.gather(out), _single(ss), base[1])


def _counts(eng, state):
    return state.valid.view(eng.config.n_shards, -1).sum(1)


@pytest.mark.parametrize("case", ["migration", "slab_sweep",
                                  "slab_resident", "tile", "ship"])
def test_ladder_replays_losslessly(case):
    """Each overflow cause replays the run and ends on the result of a run
    that had the capacity from the start, bit for bit: the sweep's
    migration buffer and slab slots, the resident slab (CAP_OVF), tiles
    and ship rounds (SHIP_OVF)."""
    precision = (Precision.PARITY if case in ("migration", "slab_sweep")
                 else Precision.FAST)
    args, steps, d = {"migration": ((3, 8.0, 8, 400), 30, 8),
                      "slab_sweep": ((3, 8.0, 8, 400), 30, 8),
                      "slab_resident": ((3, 8.0, 8, 400), 30, 8),
                      "tile": ((1, 1.0, 8, 500), 5, 4),
                      "ship": ((5893, 0.05, 8, 64), 12, 8)}[case]
    impl = None if precision is Precision.PARITY else "resident"

    def engine(**kw):
        return ShardedEngine(SimConfig(*args, precision=precision,
                                       n_shards=d, **kw),
                             impl=impl, device="cpu")

    big = engine()
    if case == "migration":
        eng = engine(migration_capacity=1)
    elif case.startswith("slab"):
        # Slabs exactly as full as the fullest shard at the start.
        tight = int(_counts(big, big.init_state()).max())
        big = engine()
        eng = engine(shard_capacity=tight)
    elif case == "tile":
        eng = ShardedEngine(SimConfig(*args, n_shards=d), impl=impl,
                            kcap=8, device="cpu")
    else:
        eng = engine()
    state = eng.init_state()
    cap0 = eng.capacity
    out = eng.run(state, steps)
    assert int(out.overflow) == 0
    grew = {"migration": lambda: eng.bcap > 1,
            "slab_sweep": lambda: eng.capacity > cap0,
            "slab_resident": lambda: eng.capacity > cap0,
            "tile": lambda: eng.kcap > 8,
            "ship": lambda: eng.ship_rounds > 1}[case]
    assert grew() and eng.impl == ("sweep" if impl is None else "resident")
    if case == "tile":
        big = ShardedEngine(SimConfig(*args, n_shards=d), impl=impl,
                            kcap=eng.kcap, device="cpu")
    if case == "ship":
        big.ship_rounds = eng.ship_rounds
    ref = big.run(big.init_state(), steps)
    got, want = eng.gather(out), big.gather(ref)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert int(out.collisions) == int(ref.collisions)


def test_rank_overflow_guard(monkeypatch):
    """A cell at or above RANK_LIMIT occupants raises on the mesh as on one
    device (``test_torch_sweep.test_rank_overflow_guard``), however many
    steps raise it: the sentinel holds by maximum and does not add up. The
    limit is lowered (65535 occupants would take too long); 4 steps are
    enough for a sum of sentinels to wrap the int32 counter to 0."""
    monkeypatch.setattr(collisions, "RANK_LIMIT", 8)
    eng = ShardedEngine(SimConfig(1, 1.0, 2, 64, precision=Precision.PARITY,
                                  n_shards=2), device="cpu")
    with pytest.raises(RuntimeError, match="rank overflow"):
        eng.run(eng.init_state(), 4)


@pytest.mark.parametrize("case", ["sparse", "clustered", "stream", "banded",
                                  "banded-cols", "banded-cyclic", "supercell"])
def test_mesh_routes_match_jax(case, monkeypatch):
    """The port's mesh census takes JAX's route after ``init_state`` (no
    run): the same impl, super-cell factor, band plan and banded variant as
    the JAX ``ShardedEngine`` on the bootstrap's virtual devices. An
    explicit banded or supercell impl on a uniform load declines to
    resident tiles, as in JAX."""
    args, impl = (1, 100.0, 10, 2000), None
    if case == "sparse":       # 0.8 a cell: super-cell tiles at S = 2
        args = (5893, 0.5, 16, 200)
    elif case == "clustered":  # a normal-mode blob with a band plan
        args = (-7, 5000.0, 100, 200_000)
    elif case == "stream":     # tiles above the (lowered) threshold
        monkeypatch.setattr(port_engine, "_STREAM_BYTES", 10_000)
        monkeypatch.setattr(port_engine, "_STREAM_BAND_BYTES", 10_000)
        monkeypatch.setenv("PSIM_STREAM_BYTES", "10000")
        monkeypatch.setenv("PSIM_STREAM_BAND_BYTES", "10000")
    else:
        impl = case
    eng = ShardedEngine(SimConfig(*args, n_shards=4), impl=impl,
                        device="cpu")
    eng.init_state()
    jeng = JShardedEngine(JSimConfig(*args, precision=JPrecision.FAST,
                                     n_shards=4), impl=impl)
    jeng.init_state()
    want = {"sparse": "supercell", "clustered": "banded",
            "stream": "banded"}.get(case, "resident")
    assert eng.impl == jeng.impl == want
    assert eng._sc_factor == jeng._sc_factor
    plan = jeng._band_plan if jeng.impl == "banded" else None
    assert (eng._band_plan if eng.impl == "banded" else None) == (
        plan and tuple(tuple(p) for p in plan))
    if eng.impl == "banded":
        assert eng.banded_variant == jeng.banded_variant == "cols"
        assert len(plan) >= 2
    assert eng.ownership_plan() == jeng.ownership_plan()
    assert eng.config.row_starts == jeng.config.row_starts


def test_pair_tiles_are_the_runs():
    """The tiles ``pair_tiles`` gives are those the run's pair passes take:
    the fused pass's count on step k's tiles is the count step k adds."""
    cfg = SimConfig(5893, 0.05, 8, 64, n_shards=4)
    eng = ShardedEngine(cfg, impl="resident", device="cpu")
    state = eng.init_state()
    eng.run(state, 0)
    _, pair_tiles, run = make_sharded_resident_run(
        cfg, eng.mesh, eng.kcap, eng.capacity, eng.ship_rounds)
    counts = [int(run(state, k).collisions) for k in range(4)]
    for k in range(1, 4):
        x, y, mf, alive, pid = pair_tiles(state, k)
        assert x.shape == (4 * (cfg.rows_max + 2) * 8, eng.kcap)
        _, _, count, _ = cell_pairs.fused_pairs_ref(
            x, y, mf, alive, pid, eng.kcap, port_engine.EPSILON)
        assert int(count) == counts[k] - counts[k - 1]


@pytest.mark.parametrize("nc,d,starts", [(100, 4, ()), (100, 3, ()),
                                         (13, 8, ()), (8, 4, (0, 3, 4, 6)),
                                         (24, 8, (0, 5, 8, 10, 12, 14, 16,
                                                  19))])
def test_config_geometry_equals_jax(nc, d, starts):
    """The row decomposition and the resolved capacities, as JAX's config
    gives them."""
    kw = dict(n_shards=d, row_starts=starts)
    cfg = SimConfig(1, 10.0, nc, 1000, **kw)
    jcfg = JSimConfig(1, 10.0, nc, 1000, **kw)
    rows = np.arange(nc)
    np.testing.assert_array_equal(cfg.shard_of_row(rows),
                                  jcfg.shard_of_row(rows))
    assert cfg.rows_max == jcfg.rows_max
    assert [(cfg.row0_of_shard(s), cfg.rows_of_shard(s)) for s in range(d)] \
        == [(jcfg.row0_of_shard(s), jcfg.rows_of_shard(s)) for s in range(d)]
    assert (cfg.resolved_shard_capacity(), cfg.resolved_migration_capacity()) \
        == (jcfg.resolved_shard_capacity(), jcfg.resolved_migration_capacity())


@pytest.mark.parametrize("starts", [(1, 2, 4, 6), (0, 2, 2, 6), (0, 2, 4),
                                    (0, 2, 4, 8)])
def test_config_refuses_bad_row_starts(starts):
    with pytest.raises(ValueError, match="row_starts"):
        SimConfig(1, 4.0, 8, 10, n_shards=4, row_starts=starts)


def test_simulation_builds_the_mesh():
    """``Simulation(n_shards > 1)`` runs the mesh engine; its result and
    gather are the engine's."""
    from particlesimulation_tpu_torch.models import Simulation

    sim = Simulation(5893, 0.05, 3, 10, precision="parity", n_shards=3,
                     device="cpu")
    assert isinstance(sim.engine, ShardedEngine)
    out = sim.run(10)
    assert out.collisions == 2
    assert (round(out.particle0[0], 3), round(out.particle0[1], 3)) == (
        0.002, 0.035)
    np.testing.assert_array_equal(out.gather()["pid"], np.arange(10))
