"""Tile runs replayed from a captured step (``ops/graphed``) against the
plain loop, on the CPU.

Every engine that runs ``ops/resident.make_tile_run`` (resident, banded,
supercell; the 1D mesh's resident, supercell, column bands and
block-cyclic bands; the 2D mesh's resident tiles) runs its steps through a
``graphed.StepGraph``: on a CUDA device a captured graph, here its twin,
which calls the same step function on the same static carry. Each run is
held bit for bit against ``run_eager`` (every field of the state and every
counter) at 0, 1, 2 and 5 steps, on a second state with the graphs reused,
and after a retry that small tiles force; the first result must not
change when the engine runs again. The launch accounting (a capture's
counts added on each replay) is held on a stub step. The resident engine
and the mesh's fast resident route at D = 2 are also held against the JAX
package from the same host-initialised state, under the tolerances of
tests/test_torch_engine.py and tests/test_torch_sharded.py.
"""

import numpy as np
import pytest
import torch

from particlesimulation_tpu.config import Precision as JPrecision
from particlesimulation_tpu.config import SimConfig as JSimConfig
from particlesimulation_tpu.engine import Engine as JEngine
from particlesimulation_tpu.parallel.sharded import (
    ShardedEngine as JShardedEngine)
from particlesimulation_tpu_torch.config import SimConfig
from particlesimulation_tpu_torch.engine import Engine
from particlesimulation_tpu_torch.ops import graphed
from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine
from particlesimulation_tpu_torch.parallel.sharded2d import Sharded2DEngine

torch.set_num_threads(2)

# name: (engine class, config args, config keywords, engine keywords, band
# plan or None, the retry's start: ("kcap", k) or ("plan", plan)). Small
# configs with collisions; each retry start overflows and the ladder ends
# on the same tile engine.
ENGINES = {
    "resident": (Engine, (5893, 0.08, 4, 120), {}, {"impl": "resident"},
                 None, ("kcap", 8)),
    "banded": (Engine, (5, 8.0, 8, 600), {}, {"impl": "banded"},
               ((0, 2, 64), (2, 2, 64), (4, 2, 64), (6, 2, 64)),
               ("plan", ((0, 2, 16), (2, 2, 16), (4, 2, 16), (6, 2, 16)))),
    "supercell": (Engine, (-10, 4.0, 16, 1200), {}, {"impl": "supercell"},
                  None, ("kcap", 8)),
    "mesh resident": (ShardedEngine, (5893, 0.05, 8, 256), {"n_shards": 4},
                      {"impl": "resident"}, None, ("kcap", 4)),
    "mesh supercell": (ShardedEngine, (5893, 0.5, 16, 380), {"n_shards": 2},
                       {"impl": "supercell"}, None, ("kcap", 8)),
    "mesh column bands": (ShardedEngine, (5893, 0.05, 16, 256),
                          {"n_shards": 8}, {"impl": "banded"},
                          ((0, 8, 96), (8, 8, 96)),
                          ("plan", ((0, 8, 4), (8, 8, 4)))),
    "mesh cyclic bands": (ShardedEngine, (5893, 0.05, 8, 256),
                          {"n_shards": 8}, {"impl": "banded-cyclic"},
                          ((0, 8, 64),), ("plan", ((0, 8, 4),))),
    "2D resident": (Sharded2DEngine, (5893, 0.05, 8, 256),
                    {"n_shards": 4, "mesh_shape": (2, 2)}, {}, None,
                    ("kcap", 4)),
}
NAMES = list(ENGINES)
WANT = {"resident": "resident", "banded": "banded", "supercell": "supercell",
        "mesh resident": "resident", "mesh supercell": "supercell",
        "mesh column bands": "banded", "mesh cyclic bands": "banded",
        "2D resident": "resident"}
_CACHE = {}


def _target(eng):
    return eng.target() if hasattr(eng, "target") else eng


def _build(name, retry=False):
    """(engine, its initial state); ``retry``: tiles the run outgrows."""
    cls, args, cfg_kw, eng_kw, plan, (how, small) = ENGINES[name]
    kw = dict(eng_kw)
    if retry and how == "kcap":
        kw["kcap"] = small
    eng = cls(SimConfig(*args, **cfg_kw), device="cpu", **kw)
    if plan is not None:
        eng._band_plan = small if retry else plan
    state = eng.init_state()
    _target(eng)._build()
    return eng, state


@pytest.fixture(scope="module")
def engines():
    """One engine and its initial state a name, built once."""
    if not _CACHE:
        for name in NAMES:
            _CACHE[name] = _build(name)
    return _CACHE


def _bits(state):
    """Every field of a state, cloned, floats by their bit patterns."""
    out = {}
    for f in state._fields:
        t = getattr(state, f).detach().clone()
        if t.dtype == torch.float32:
            t = t.view(torch.int32)
        elif t.dtype == torch.float64:
            t = t.view(torch.int64)
        out[f] = t
    return out


def _assert_bits(a, b):
    assert a.keys() == b.keys()
    for f in a:
        assert a[f].dtype == b[f].dtype and torch.equal(a[f], b[f]), f


@pytest.mark.parametrize("steps", [0, 1, 2, 5])
@pytest.mark.parametrize("name", NAMES)
def test_graphed_equals_eager(engines, name, steps):
    """The graphed run (its CPU twin) and the plain loop, bit for bit, the
    input state untouched by either."""
    eng, state = engines[name]
    before = _bits(state)
    got = eng.run(state, steps)
    assert eng.impl == WANT[name] and int(got.overflow) == 0
    assert isinstance(_target(eng)._run, graphed.GraphedRun)
    _assert_bits(_bits(got), _bits(eng.run_eager(state, steps)))
    _assert_bits(_bits(state), before)


@pytest.mark.parametrize("name", NAMES)
def test_second_state_reuses_the_graphs(engines, name):
    """The same engine on another state (its own result after 5 steps):
    the graphs reused, the result a fresh engine's, graphed and eager; the
    first result unchanged by the second run."""
    eng, state = engines[name]
    first = eng.run(state, 5)
    kept = _bits(first)
    graphs = _target(eng)._run.graphs
    names = graphs.names
    assert names
    second = eng.run(first, 5)
    assert graphs.names == names and _target(eng)._run.graphs is graphs
    _assert_bits(_bits(first), kept)
    fresh, _ = _build(name)
    assert _target(fresh).kcap == _target(eng).kcap
    want = _bits(second)
    _assert_bits(want, _bits(fresh.run(first, 5)))
    _assert_bits(want, _bits(fresh.run_eager(first, 5)))
    assert int(second.collisions) >= int(first.collisions)


@pytest.mark.parametrize("name", NAMES)
def test_retry_graphed_equals_eager(name):
    """Tiles too small for the run: the ladder replays it on larger tiles
    of the same engine, graphed as eager, bit for bit."""
    eng, state = _build(name, retry=True)
    k0 = _target(eng).kcap
    got = eng.run(state, 5)
    ref_eng, ref_state = _build(name, retry=True)
    ref = ref_eng.run_eager(ref_state, 5)
    assert _target(eng).kcap > k0 and eng.impl == WANT[name]
    assert _target(ref_eng).kcap == _target(eng).kcap
    assert ref_eng.impl == eng.impl and int(got.overflow) == 0
    _assert_bits(_bits(got), _bits(ref))


def test_rebuild_releases_the_graphs():
    """A rebuild drops the old run's graphs and static carry."""
    eng, state = _build("resident", retry=True)
    old = eng._run
    eng.run(state, 2)  # captures at kcap 8, overflows and rebuilds
    assert eng._run is not old and old.graphs.names == ()
    with pytest.raises(RuntimeError, match="no carry"):
        old.graphs.step("middle", None)


# --- StepGraph on a stub step ----------------------------------------------


def _stub(counts):
    """A step that adds 1 to its carry and counts 2 launches of "a" and 1
    of "b" on each call, plus one "late" launch from its second call on."""
    calls = []

    def step(x, pair):
        calls.append(1)
        counts["a"] += 2
        counts["b"] += 1
        if len(calls) > 1:
            counts["late"] += 1
        return x + 1, (pair[0] * 2, pair[1])

    return step, calls


def test_launches_add_the_capture_on_each_replay():
    """The first step (the warm-up) counts its own launches and stands for
    the capture; each replay adds the capture's counts and no others, as a
    graph replays what it captured."""
    counts = {"a": 0, "b": 0, "late": 0}
    sg = graphed.StepGraph(counters=(counts,))
    step, calls = _stub(counts)
    sg.load((torch.zeros(4), (torch.ones(2), torch.arange(3))))
    sg.step("s", step)
    assert counts == {"a": 2, "b": 1, "late": 0}
    for _ in range(3):
        sg.step("s", None)
    assert counts == {"a": 8, "b": 4, "late": 0}
    assert len(calls) == 4
    x, (p, q) = sg.carry()
    assert torch.equal(x, torch.full((4,), 4.0))
    assert torch.equal(p, torch.full((2,), 16.0))
    assert torch.equal(q, torch.arange(3))
    assert sg.names == ("s",) and sg.capture_s == {"s": 0.0}


def test_load_copies_and_own_clones():
    """``load`` copies into the static carry (the caller's tensors are
    never written); ``own`` clones what shares the carry's memory."""
    sg = graphed.StepGraph(counters=())
    src = torch.arange(5.0)
    sg.load((src,))
    sg.step("s", lambda x: (x.add_(1),))
    assert torch.equal(src, torch.arange(5.0))
    (x,) = sg.carry()
    mine, other = sg.own((x[1:], torch.ones(2)))
    assert mine.untyped_storage().data_ptr() != x.untyped_storage(
        ).data_ptr()
    assert torch.equal(mine, torch.arange(2.0, 6.0))
    sg.load((torch.zeros(5),))
    assert sg.carry()[0] is x and torch.equal(mine, torch.arange(2.0, 6.0))
    sg.load((torch.zeros(6),))  # another shape: a new carry, no graphs
    assert sg.carry()[0] is not x and sg.names == ()


@pytest.mark.parametrize("bad", ["structure", "dtype", "shape", "swap"])
def test_step_refuses_a_carry_it_cannot_write_back(bad):
    sg = graphed.StepGraph(counters=())
    sg.load((torch.zeros(3), torch.ones(3)))
    fn = {"structure": lambda a, b: (a,),
          "dtype": lambda a, b: (a.double(), b),
          "shape": lambda a, b: (a[:2], b),
          "swap": lambda a, b: (b, a)}[bad]
    with pytest.raises(ValueError):
        sg.step("s", fn)


def test_carry_must_be_tensors_on_one_device():
    sg = graphed.StepGraph(counters=())
    with pytest.raises(TypeError):
        sg.load((torch.zeros(2), 3))
    with pytest.raises(TypeError):
        sg.load(())
    with pytest.raises(ValueError):
        sg.load((torch.zeros(2, device="meta"),))


# --- Against the JAX package ------------------------------------------------


def _by_pid(pid, fields):
    order = np.argsort(np.asarray(pid))
    return {f: np.asarray(v)[order] for f, v in fields.items()}


def _assert_close(got, ref, side):
    """Dead sets exact, positions within 1e-6·side, velocities within
    1e-5·max|v| (tests/test_torch_engine.py, tests/test_torch_sharded.py)."""
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    for f in ("x", "y"):
        np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=1e-6 * side)
    vmax = float(np.abs(ref["vx"]).max())
    np.testing.assert_allclose(got["vx"], ref["vx"], rtol=0,
                               atol=1e-5 * vmax)


FIELDS = ("x", "y", "vx", "vy", "m", "alive")


def test_resident_graphed_matches_jax():
    """The resident engine's graphed run against JAX's resident engine from
    the same host initializer: count and dead set exact, f32 tolerance."""
    seed, side, nc, n, steps = 5893, 0.08, 4, 120, 5
    jeng = JEngine(JSimConfig(seed, side, nc, n, precision=JPrecision.FAST),
                   impl="resident", dense_backend="pallas")
    ref = jeng.run(jeng.init_state(), steps)
    eng = Engine(SimConfig(seed, side, nc, n), impl="resident", device="cpu")
    got = eng.run(eng.init_state(), steps)
    assert eng.kcap == jeng.kcap and int(got.overflow) == 0
    assert int(got.collisions) == int(ref.collisions) > 0
    _assert_close(
        _by_pid(got.pid, {f: getattr(got, f).numpy() for f in FIELDS}),
        _by_pid(ref.pid, {f: getattr(ref, f) for f in FIELDS}), side)


def test_mesh_d2_graphed_matches_jax():
    """The mesh's fast resident route at D = 2, graphed, against JAX's
    ShardedEngine on two virtual devices: count and dead set exact, f32
    tolerance, every pid once."""
    seed, side, nc, n, steps, d = 5893, 0.05, 8, 64, 12, 2
    jeng = JShardedEngine(JSimConfig(seed, side, nc, n,
                                     precision=JPrecision.FAST, n_shards=d),
                          impl="resident")
    jout = jeng.run(jeng.init_state(), steps)
    assert int(np.asarray(jout.overflow)) == 0
    eng = ShardedEngine(SimConfig(seed, side, nc, n, n_shards=d),
                        impl="resident", device="cpu")
    out = eng.run(eng.init_state(), steps)
    assert eng.impl == "resident" and int(out.overflow) == 0
    assert isinstance(eng._run, graphed.GraphedRun) and eng._run.graphs.names
    got, ref = eng.gather(out), jeng.gather(jout)
    np.testing.assert_array_equal(got["pid"], np.arange(n))
    np.testing.assert_array_equal(ref["pid"], np.arange(n))
    assert int(out.collisions) == int(np.asarray(jout.collisions)) > 0
    _assert_close(got, ref, side)
