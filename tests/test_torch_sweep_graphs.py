"""The sweep, dense and tiered runs replayed from a captured step
(``ops/graphed.loop_run``) against the plain loop, and the sweep's
occupancy on the device, on the CPU.

* The occupancy: ``sweep.sweep_occupancy_ref`` (the plain version of the
  occupancy kernel) and the kernel's own method as a NumPy model (each
  cell's last lane writes its count, the sentinels and large cells summed,
  the maximum taken: no sorted keys assumed), field for field against the
  port's earlier occupancy (an ``index_add_`` of ones, read back, with the
  host histograms) and JAX's ``max_occupancy``, on sorted lanes and on the
  mesh's layout (sentinel lanes between the cells), a 2600-lane cell and a
  10 000-lane cell among them; ``Occupancy``'s host part derived from the
  device part, and refused on a plan that was not read.
* The runs: the sweep (parity and f32), the D = 2 and (2, 2) parity
  meshes, dense and tiered graphed (StepGraph's CPU twin, the same step
  function on the same static carry) against ``run_eager``, every field bit
  for bit, at 0, 1 and 4 steps, a second state on the same graphs; the
  parity sweep's graphed run against the JAX parity engine bit for bit.
* The rank guard set on the device: a step whose kmax reaches the
  collision rank limit (lowered, as the plain tests lower it) flags
  ``RANK_OVF`` in its state's overflow, graphed and eager.
* A run of 0 steps captures the engine's graphs and returns its input's
  bits, so that the CLI's timed run makes no capture.
"""

import numpy as np
import pytest
import torch

from particlesimulation_tpu.config import Precision as JPrecision
from particlesimulation_tpu.config import SimConfig as JSimConfig
from particlesimulation_tpu.engine import Engine as JEngine
from particlesimulation_tpu.ops import binning as jbinning
from particlesimulation_tpu_torch import engine as engine_mod
from particlesimulation_tpu_torch.config import Precision, SimConfig
from particlesimulation_tpu_torch.engine import Engine
from particlesimulation_tpu_torch.ops import (binning, collisions, graphed,
                                          stencil)
from particlesimulation_tpu_torch.ops.cuda import adversarial as adv
from particlesimulation_tpu_torch.ops.cuda import sweep
from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine
from particlesimulation_tpu_torch.parallel.sharded2d import Sharded2DEngine

torch.set_num_threads(2)

SIDE, NC = adv.SWEEP_SIDE, adv.SWEEP_NCSIDE
NCELLS = NC * NC
CASES = ("planted", "hot", "wide", "huge")


def _lanes(case, mesh):
    """An adversarial case's sorted lanes (key int32, pos int64), or in the
    mesh's layout (``adversarial.mesh_lane_order``)."""
    xs, ys, _, _ = adv.sweep_particles(case)
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    key, _ = binning.cell_keys(x, y, SIDE, NC)
    key, _ = binning.sort_by_cell(key, torch.arange(x.shape[0],
                                                    dtype=torch.int32))
    pos, _ = binning.segment_positions(key)
    if mesh:
        perm = torch.from_numpy(adv.mesh_lane_order(key.numpy(), NCELLS))
        key, pos = key[perm].contiguous(), pos[perm].contiguous()
    return key, pos


def _earlier_occupancy(key, ncells):
    """The port's occupancy before it moved to the device: an index_add_
    of ones, the counts read back, the histograms on the host."""
    k = key.to(torch.int64)
    counts = torch.zeros(ncells + 1, dtype=torch.int64)
    counts.index_add_(0, k, torch.ones_like(k))
    host = counts[:ncells].numpy()
    kmax = int(host.max())
    hist = np.bincount(host, minlength=kmax + 1)
    cells_ge = np.cumsum(hist[::-1])[::-1]
    lanes_ge = np.cumsum((hist * np.arange(kmax + 1))[::-1])[::-1]
    return counts, kmax, lanes_ge[1:].tolist(), cells_ge[1:].tolist()


def occupancy_model(key, pos, ncells, block=256):
    """The occupancy kernel's method in NumPy (csrc/sweep.cu
    ``sweep_occupancy_kernel``): zeroed counts; a real lane whose next lane
    holds another key writes pos + 1; each block of ``block`` lanes adds
    its sentinels and cells of more than SMALL_CELL lanes, and takes the
    maximum of its counts."""
    k, p = key.numpy().astype(np.int64), pos.numpy()
    n = k.shape[0]
    out = np.zeros(ncells + 3, dtype=np.int64)
    real = (k >= 0) & (k < ncells)
    last = real & np.append(k[1:] != k[:-1], True)
    c = np.where(last, p + 1, 0)
    out[k[last]] = c[last]
    for b in range(0, n, block):
        sl = slice(b, b + block)
        out[ncells] += int((~real[sl]).sum())
        out[ncells + 1] = max(out[ncells + 1], int(c[sl].max()))
        out[ncells + 2] += int((c[sl] > sweep.SMALL_CELL).sum())
    return out[:ncells + 1], out[ncells + 1], out[ncells + 2]


OCC = [(c, mesh) for c in CASES for mesh in (False, True)]


@pytest.mark.parametrize("case,mesh", OCC, ids=[
    f"{c}-{'mesh' if m else 'sorted'}" for c, m in OCC])
def test_occupancy_field_for_field(case, mesh):
    """The plain version and the kernel's model against the earlier
    occupancy, field for field: counts (the sentinels' last), kmax, the
    large cells; kmax also against JAX's max_occupancy."""
    key, pos = _lanes(case, mesh)
    counts, kmax, lanes, cells = _earlier_occupancy(key, NCELLS)
    large = cells[sweep.SMALL_CELL] if kmax > sweep.SMALL_CELL else 0
    got = sweep.sweep_occupancy_ref(key, pos, NCELLS)
    model = occupancy_model(key, pos, NCELLS)
    for occ in (got, model):
        np.testing.assert_array_equal(np.asarray(occ[0]), counts.numpy())
        assert int(occ[1]) == kmax and int(occ[2]) == large
    assert got[0].dtype == got[1].dtype == got[2].dtype == torch.int64
    assert got[1].shape == got[2].shape == ()
    if not mesh:
        jk = int(jbinning.max_occupancy(np.asarray(pos.numpy(), np.int32),
                                        key.numpy() < NCELLS))
        assert jk == kmax
    if case == "planted":
        assert int(counts[NCELLS]) > 0       # sentinel lanes
    if case in ("wide", "huge"):
        assert large > 0 and kmax > sweep.SMALL_CELL
    if case == "huge":
        assert kmax > sweep.CHUNK
    # The plan's host part, derived from the device part, is the earlier
    # occupancy's; on sorted keys its lane order too.
    plan = binning.occupancy(key, NCELLS, pos)
    assert (plan.host_kmax, plan.lanes, plan.cells) == (kmax, lanes, cells)
    assert int(plan.kmax) == kmax and int(plan.large) == large
    if not mesh:
        want = torch.sort(torch.where(key < NCELLS, -counts[key.long()], 0),
                          stable=True).indices
        assert torch.equal(plan.order, want)


def test_occupancy_host_part_needs_a_read():
    """A plan whose counts lie off the CPU raises on its host part until
    ``read()`` copies them back (no quiet readback); the device part is
    there all along."""
    key, pos = _lanes("planted", False)
    counts, kmax, large = sweep.sweep_occupancy_ref(key, pos, NCELLS)
    meta = binning.Occupancy(counts.to("meta"), kmax.to("meta"),
                             large.to("meta"), key.to("meta"))
    for read in (lambda p: p.lanes, lambda p: p.cells,
                 lambda p: p.host_kmax, lambda p: p.order):
        with pytest.raises(RuntimeError, match="read"):
            read(meta)
    assert meta.counts.device.type == "meta"
    cpu = binning.occupancy(key, NCELLS, pos)
    assert cpu.read() is cpu and cpu.host_kmax == int(kmax)


def test_occupancy_checks_its_arguments():
    key, pos = _lanes("planted", False)
    for bad in ((key.long(), pos), (key, pos.int()), (key, pos[:-1]),
                (key[None], pos)):
        with pytest.raises((TypeError, ValueError)):
            sweep.sweep_occupancy(*bad, NCELLS)


# --- Runs graphed against eager ---------------------------------------------

# name: (engine class, config args, config keywords, engine keywords, the
# engine that must run). Small configs with collisions.
RUNS = {
    "parity sweep": (Engine, (8555, 0.05, 3, 30), {"precision": "parity"},
                     {}, "sweep"),
    "f32 sweep": (Engine, (-10, 3.0, 3, 100), {}, {"impl": "sweep"},
                  "sweep"),
    "mesh parity D=2": (ShardedEngine, (5893, 0.05, 8, 64),
                        {"n_shards": 2, "precision": "parity"}, {}, "sweep"),
    "2D parity (2, 2)": (Sharded2DEngine, (5893, 0.05, 8, 64),
                         {"n_shards": 4, "mesh_shape": (2, 2),
                          "precision": "parity"}, {}, "sweep"),
    "dense": (Engine, (5893, 0.08, 4, 120), {}, {"impl": "dense"}, "dense"),
    "tiered": (Engine, (-7, 24.0, 12, 2000), {}, {"impl": "tiered"},
               "tiered"),
}
NAMES = list(RUNS)
_CACHE = {}


def _build(name):
    cls, args, cfg_kw, eng_kw, _ = RUNS[name]
    if cfg_kw.get("precision") == "parity":
        cfg_kw = {**cfg_kw, "precision": Precision.PARITY}
    eng = cls(SimConfig(*args, **cfg_kw), device="cpu", **eng_kw)
    return eng, eng.init_state()


@pytest.fixture(scope="module")
def engines():
    if not _CACHE:
        for name in NAMES:
            _CACHE[name] = _build(name)
    return _CACHE


def _bits(state):
    """Every field of a state, cloned, floats by their bit patterns."""
    out = {}
    for f in state._fields:
        t = getattr(state, f).detach().clone()
        if t.is_floating_point():
            t = t.view(torch.int64 if t.dtype == torch.float64
                       else torch.int32)
        out[f] = t
    return out


def _assert_bits(a, b):
    assert a.keys() == b.keys()
    for f in a:
        assert a[f].dtype == b[f].dtype and torch.equal(a[f], b[f]), f


@pytest.mark.parametrize("steps", [0, 1, 4])
@pytest.mark.parametrize("name", NAMES)
def test_graphed_equals_eager(engines, name, steps):
    """The graphed run (its CPU twin) and the plain loop, bit for bit, the
    input state untouched by either."""
    eng, state = engines[name]
    before = _bits(state)
    got = eng.run(state, steps)
    assert eng.impl == RUNS[name][4] and int(got.overflow) == 0
    assert isinstance(eng._run, graphed.GraphedRun)
    _assert_bits(_bits(got), _bits(eng.run_eager(state, steps)))
    _assert_bits(_bits(state), before)
    if steps:
        assert eng._run.graphs.names == ("step",)


@pytest.mark.parametrize("name", NAMES)
def test_second_state_reuses_the_graphs(engines, name):
    """The same engine on its own result after 4 steps: the graphs reused,
    graphed = eager, the first result unchanged by the second run."""
    eng, state = engines[name]
    first = eng.run(state, 4)
    kept = _bits(first)
    graphs = eng._run.graphs
    captures = graphs.captures
    second = eng.run(first, 4)
    assert eng._run.graphs is graphs and graphs.captures == captures
    _assert_bits(_bits(first), kept)
    _assert_bits(_bits(second), _bits(eng.run_eager(first, 4)))
    if "parity" in name or name == "dense":
        assert int(second.collisions) > 0


def test_parity_graphed_matches_jax():
    """The parity sweep's graphed run against the JAX parity engine, every
    field bit for bit (``tests/test_torch_sweep.py``'s comparison)."""
    seed, side, nc, n, steps = 8555, 0.05, 3, 30, 20
    jeng = JEngine(JSimConfig(seed, side, nc, n, precision=JPrecision.PARITY))
    ref = jeng.run(jeng.init_state(), steps)
    eng = Engine(SimConfig(seed, side, nc, n, precision=Precision.PARITY),
                 device="cpu")
    got = eng.run(eng.init_state(), steps)
    assert eng.impl == "sweep" and eng._run.graphs.names == ("step",)
    for f in ("x", "y", "vx", "vy", "m", "alive", "pid", "collisions",
              "panics"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert int(got.collisions) > 0


@pytest.mark.parametrize("how", ["graphed", "eager"])
def test_rank_guard_set_on_the_device(monkeypatch, how):
    """A step whose kmax reaches the rank limit (lowered to 8: 32 particles
    share one cell) sets RANK_OVF in the state's overflow, read back only
    after the run; the collision pass ran no detection."""
    monkeypatch.setattr(collisions, "RANK_LIMIT", 8)
    cfg = SimConfig(1, 1.0, 1, 32, precision=Precision.PARITY)
    eng = Engine(cfg, device="cpu")
    state = eng.init_state()
    _, run = engine_mod.make_step(cfg)
    out = (run if how == "graphed" else run.eager)(state, 2)
    assert int(out.overflow) == engine_mod.RANK_OVF
    assert int(out.collisions) == 0
    if how == "graphed":
        assert run.graphs.names == ("step",)


def test_rank_flag():
    over = torch.tensor(5, dtype=torch.int32)
    for kmax, want in ((collisions.RANK_LIMIT - 1, 5),
                       (collisions.RANK_LIMIT, engine_mod.RANK_OVF)):
        got = engine_mod.rank_flag(over, torch.tensor(kmax))
        assert got.dtype == torch.int32 and int(got) == want


# --- A run of 0 steps captures ----------------------------------------------

ZERO = ["parity sweep", "mesh parity D=2", "dense", "tiered", "resident"]


@pytest.mark.parametrize("name", ZERO)
def test_zero_steps_capture(name):
    """``run(state, 0)`` (the CLI's warm-up) returns the state's bits and
    captures the run's graphs; the timed run that follows captures
    nothing."""
    if name == "resident":
        eng = Engine(SimConfig(5893, 0.08, 4, 120), impl="resident",
                     device="cpu")
        state = eng.init_state()
    else:
        eng, state = _build(name)
    before = _bits(state)
    state0 = eng.run(state, 0)
    _assert_bits(_bits(state0), before)
    _assert_bits(_bits(state), before)
    graphs = eng._run.graphs
    names, captures = graphs.names, graphs.captures
    assert names and captures == len(names)
    out = eng.run(state0, 3)
    assert graphs.captures == captures and graphs.names == names
    _assert_bits(_bits(out), _bits(eng.run_eager(state, 3)))


# --- The graphed runs and the stencil plans' cache -------------------------

PLANNED = ["parity sweep", "f32 sweep", "dense", "tiered", "resident"]


@pytest.mark.parametrize("name", PLANNED)
def test_graphed_runs_outlive_the_plan_cache(name):
    """On the CPU the tables are the plain gather by ``ops/stencil``'s
    bounded plan cache (a CUDA tensor launches the tables kernel, which
    reads no plan): a graphed run whose plan the cache evicted (cleared,
    then filled with other grids) runs again with the same bits and no new
    capture, on a new plan of its grid."""
    if name == "resident":
        eng = Engine(SimConfig(5893, 0.08, 4, 120), impl="resident",
                     device="cpu")
        state = eng.init_state()
    else:
        eng, state = _build(name)
    first = _bits(eng.run(state, 2))
    graphs = eng._run.graphs
    captures = graphs.captures
    dtype = torch.float64 if "parity" in name else torch.float32
    key = (float(eng.config.side), eng.config.ncside, dtype,
           torch.device("cpu"))
    plan = stencil._stencil_plan(*key)
    stencil._stencil_plan.cache_clear()
    for nc in range(5, 5 + stencil._stencil_plan.cache_info().maxsize):
        stencil._stencil_plan(1.0, nc, dtype, torch.device("cpu"))
    _assert_bits(_bits(eng.run(state, 2)), first)
    assert graphs.captures == captures
    assert stencil._stencil_plan(*key) is not plan


def test_stencil_plan_cache():
    """``ops/stencil``'s plan cache: one plan a grid, which every tables
    call on the grid reuses, at most 8 grids; a plan made anew gives the
    same tables."""
    M = torch.rand(9, dtype=torch.float64)
    stencil._stencil_plan.cache_clear()
    first = stencil.stencil_tables(M, M, M, 1.0, 3)
    hits = stencil._stencil_plan.cache_info().hits
    again = stencil.stencil_tables(M, M, M, 1.0, 3)
    assert stencil._stencil_plan.cache_info().hits == hits + 1
    stencil._stencil_plan.cache_clear()
    fresh = stencil.stencil_tables(M, M, M, 1.0, 3)
    for a, b, c in zip(first, again, fresh):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert stencil._stencil_plan.cache_info().maxsize == 8
