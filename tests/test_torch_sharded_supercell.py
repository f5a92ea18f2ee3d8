"""The port's sharded super-cell engine (``parallel/sharded_supercell``) on
the CPU, against the JAX package's ``ShardedEngine(impl="supercell")`` on the
bootstrap's 8 virtual CPU devices and against the port's one-device
supercell engine.

Collision counts and dead sets exact; positions within 1e-6·side and
velocities within 1e-5·max|v| (``test_torch_engine._assert_same_run``'s
tolerances). Each JAX run happens once, in a module-scoped cache.
"""

import numpy as np
import pytest
import torch

from particlesimulation_tpu.config import Precision as JPrecision
from particlesimulation_tpu.config import SimConfig as JSimConfig
from particlesimulation_tpu.parallel.sharded import (
    ShardedEngine as JShardedEngine)
from particlesimulation_tpu.parallel.sharded_supercell import (
    sc_row_starts as jsc_row_starts)
from particlesimulation_tpu_torch import engine as port_engine
from particlesimulation_tpu_torch.config import SimConfig
from particlesimulation_tpu_torch.engine import Engine
from particlesimulation_tpu_torch.ops.cuda import cell_pairs
from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine
from particlesimulation_tpu_torch.parallel.sharded_supercell import (
    make_sharded_supercell_run, sc_row_starts)
from tests.test_torch_sharded import _assert_close, _single

torch.set_num_threads(2)

# tests/test_sharded_supercell.py:46-50: even, ragged (8 super-rows on 3
# shards), migration, collisions, and D = 1 (a ring onto itself).
CONFIGS = [
    ((1, 3.0, 24, 300), 20, 8),
    ((1, 3.0, 24, 300), 20, 3),
    ((7, 6.0, 32, 400), 15, 8),
    ((5893, 0.5, 16, 200), 15, 2),
    ((1, 3.0, 24, 300), 12, 1),
]
_JAX = {}


def _jax(args, steps, d):
    """JAX's sharded super-cell run, once per config: (gathered, count)."""
    key = (args, steps, d)
    if key not in _JAX:
        eng = JShardedEngine(JSimConfig(*args, precision=JPrecision.FAST,
                                        n_shards=d), impl="supercell")
        out = eng.run(eng.init_state(), steps)
        assert eng.impl == "supercell" and int(np.asarray(out.overflow)) == 0
        _JAX[key] = (eng.gather(out), int(np.asarray(out.collisions)),
                     eng._sc_factor, eng.kcap)
    return _JAX[key]


def _mesh(args, d, **kw):
    return ShardedEngine(SimConfig(*args, n_shards=d), impl="supercell",
                         device="cpu", **kw)


@pytest.mark.parametrize("args,steps,d", CONFIGS,
                         ids=lambda a: "_".join(map(str, a))
                         if isinstance(a, tuple) else str(a))
def test_supercell_mesh_matches_jax(args, steps, d):
    """The port's mesh against JAX's mesh and the port's one-device
    supercell run: count and dead set exact, f32 tolerance; no pid lost."""
    eng = _mesh(args, d)
    out = eng.run(eng.init_state(), steps)
    ref, ref_count, jS, jkcap = _jax(args, steps, d)
    assert eng.impl == "supercell" and int(out.overflow) == 0
    assert (eng._sc_factor, eng.kcap) == (jS, jkcap)
    got = eng.gather(out)
    np.testing.assert_array_equal(got["pid"], np.arange(args[3]))
    single = Engine(SimConfig(*args), impl="supercell", device="cpu")
    ss = single.run(single.init_state(), steps)
    assert int(out.collisions) == ref_count == int(ss.collisions)
    _assert_close(got, ref, args[1])
    _assert_close(got, _single(ss), args[1])


def test_sc_row_starts_equal_jax():
    for nsc in (8, 13, 130):
        for d in (1, 2, 3, 4, 8):
            if nsc >= d:
                assert sc_row_starts(nsc, d) == jsc_row_starts(nsc, d)
    assert sc_row_starts(130, 4) == (0, 33, 66, 98, 130)


def test_supercell_mesh_migrates_and_collides():
    """Collisions happen, and particles change owner block of super-rows
    (tests/test_sharded_supercell.py:76)."""
    args = (5893, 0.5, 16, 200)
    eng = _mesh(args, 4)
    state = eng.init_state()
    out = eng.run(state, 15)
    assert int(out.collisions) > 0
    S = eng._sc_factor
    nsc = 16 // S
    starts = np.asarray(sc_row_starts(nsc, 4))
    w = args[1] / args[2]

    def owner(g):
        scrow = np.clip((g["y"] / w).astype(np.int64) // S, 0, nsc - 1)
        return np.searchsorted(starts, scrow, side="right") - 1

    assert (owner(eng.gather(state)) != owner(eng.gather(out))).sum() > 0
    # And each slab holds its owner's particles only.
    for s in range(4):
        valid = out.valid.view(4, -1)[s]
        g = {f: getattr(out, f).view(4, -1)[s][valid].numpy()
             for f in ("x", "y")}
        assert (owner(g) == s).all()


def test_supercell_mesh_chunked_runs_compose():
    """run(10) + run(10) against run(20): the count and dead set exact,
    positions to the f32 tolerance (the prologue lays a tile's particles
    out in pid order, so a chunked run sums in another slot order)."""
    args = (1, 3.0, 24, 300)
    e1, e2 = _mesh(args, 8), _mesh(args, 8)
    s1 = e1.run(e1.run(e1.init_state(), 10), 10)
    s2 = e2.run(e2.init_state(), 20)
    assert int(s1.collisions) == int(s2.collisions)
    _assert_close(e1.gather(s1), e2.gather(s2), args[1])


def test_supercell_mesh_kcap_ladder():
    """Tiles too small: the ladder grows kcap and ends on the result of a
    run that had the capacity from the start."""
    args = (5893, 0.5, 16, 200)
    eng = _mesh(args, 2, kcap=4)    # 7 particles in the fullest tile
    out = eng.run(eng.init_state(), 15)
    assert eng.impl == "supercell" and eng.kcap > 4
    assert int(out.overflow) == 0
    big = _mesh(args, 2, kcap=eng.kcap)
    ref = big.run(big.init_state(), 15)
    assert int(out.collisions) == int(ref.collisions)
    got, want = eng.gather(out), big.gather(ref)
    for f in ("pid", "alive", "x", "y", "vx", "vy", "m"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_supercell_mesh_escalates_past_the_kernel_cap():
    """A kcap above the kernels' 4096 runs the mesh sweep (re-packed by row
    block), as one device's supercell -> sweep rung: the one-device
    supercell run's count and dead set."""
    args = (5893, 0.5, 16, 200)
    eng = _mesh(args, 4, kcap=cell_pairs.MAX_KCAP + 32)
    out = eng.run(eng.init_state(), 15)
    assert eng.impl == "sweep" and int(out.overflow) == 0
    single = Engine(SimConfig(*args), impl="supercell", device="cpu")
    ss = single.run(single.init_state(), 15)
    assert int(out.collisions) == int(ss.collisions)
    _assert_close(eng.gather(out), _single(ss), args[1])


def test_supercell_mesh_pair_tiles_are_the_runs():
    """``pair_tiles`` gives the labelled tiles the run's pair passes take:
    the count of the labelled pass on step k's tiles is the count step k
    adds; the halo super-rows carry label -1."""
    args = (5893, 0.5, 16, 200)
    eng = _mesh(args, 4)
    state = eng.init_state()
    eng.run(state, 0)
    _, pair_tiles, run = make_sharded_supercell_run(
        eng.config, eng.mesh, eng.kcap, eng.capacity, eng._sc_factor)
    counts = [int(run(state, k).collisions) for k in range(4)]
    nsc = 16 // eng._sc_factor
    for k in range(1, 4):
        x, y, mf, alive, pid, sub = pair_tiles(state, k)
        nrows_t = x.shape[0] // (4 * nsc)
        halo = sub.view(4, nrows_t, nsc, -1)[:, [0, nrows_t - 1]]
        assert (halo == -1).all()
        _, _, count, _ = cell_pairs.fused_pairs_ref(
            x, y, mf, alive, pid, eng.kcap, port_engine.EPSILON, sub=sub)
        assert int(count) == counts[k] - counts[k - 1]


def test_supercell_mesh_through_simulation_and_cli(capsys):
    """``Simulation(n_shards=4)`` and the CLI's ``--mesh 4 --engine fast``
    take the census's super-cell route and print the engine's result."""
    from particlesimulation_tpu_torch.cli import main
    from particlesimulation_tpu_torch.models import Simulation

    args = (5893, 0.5, 16, 200)
    sim = Simulation(*args, n_shards=4, device="cpu")
    out = sim.run(15)
    assert sim.engine.impl == "supercell"
    eng = _mesh(args, 4)
    ref = eng.run(eng.init_state(), 15)
    assert out.collisions == int(ref.collisions)
    assert main(["5893", "0.5", "16", "200", "15", "--engine", "fast",
                 "--mesh", "4", "--device", "cpu"]) == 0
    x, y, c = eng.result(ref)
    assert capsys.readouterr().out.split("\n")[:2] == [f"{x:.3f} {y:.3f}",
                                                       str(c)]
