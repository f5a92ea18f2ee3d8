"""The port's column-sharded banded engine (``parallel/sharded_banded_cols``)
on the CPU, against the JAX package's ``ShardedEngine(impl="banded-cols")``
on the bootstrap's 8 virtual CPU devices and against the port's one-device
resident engine (tests/test_sharded_banded.py's reference).

Collision counts and dead sets exact; positions within 1e-6·side and
velocities within 1e-5·max|v| (``test_torch_engine._assert_same_run``'s
tolerances) of the port's one-device run, and of JAX's mesh where the two
packages' one-device runs are that close. Each JAX run happens once, in a
module-scoped cache.
"""

import numpy as np
import pytest
import torch

from particlesimulation_tpu.config import Precision as JPrecision
from particlesimulation_tpu.config import SimConfig as JSimConfig
from particlesimulation_tpu.parallel.sharded import (
    ShardedEngine as JShardedEngine)
from particlesimulation_tpu.parallel.sharded_banded_cols import (
    col_owner as jcol_owner)
from particlesimulation_tpu_torch import engine as port_engine
from particlesimulation_tpu_torch.config import SimConfig
from particlesimulation_tpu_torch.engine import Engine
from particlesimulation_tpu_torch.ops import resident as res
from particlesimulation_tpu_torch.ops.cuda import cell_pairs
from particlesimulation_tpu_torch.parallel import sharded_banded_cols
from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine
from particlesimulation_tpu_torch.parallel.sharded_banded_cols import (
    col_owner, make_sharded_banded_cols_run)
from tests.test_torch_sharded import _assert_close, _single

torch.set_num_threads(2)

# tests/test_sharded_banded.py:58-70 and :97 (ragged columns): one band over
# 8 shards, two equal bands with collisions and migration, a blob on two
# bands of distinct K, a ragged band (13 rows and 13 columns on 8 shards),
# D = 1, bands of 4 and 5 rows on 4 shards, and 13 columns on 8 shards with
# migration across the x wrap.
PLANS = [
    ((5893, 0.05, 8, 64), 12, 8, ((0, 8, 64),)),
    ((5893, 0.05, 16, 256), 12, 8, ((0, 8, 96), (8, 8, 96))),
    ((-10, 3.0, 16, 600), 10, 8, ((0, 8, 96), (8, 8, 64))),
    ((-10, 3.0, 13, 300), 10, 8, ((0, 13, 96),)),
    ((17, 0.12, 8, 120), 20, 1, ((0, 4, 64), (4, 4, 64))),
    ((3, 8.0, 9, 400), 30, 4, ((0, 4, 96), (4, 5, 96))),
    ((17, 0.12, 13, 300), 20, 8, ((0, 6, 96), (6, 7, 96))),
]
_JAX = {}


def _ids(case):
    args, steps, d, plan = case
    return f"{'_'.join(map(str, args))}-D{d}-{len(plan)}bands"


def _jax(args, steps, d, plan):
    """JAX's column-sharded banded run, once per case: (gathered, count)."""
    key = (args, steps, d, plan)
    if key not in _JAX:
        eng = JShardedEngine(JSimConfig(*args, precision=JPrecision.FAST,
                                        n_shards=d), impl="banded-cols")
        eng._band_plan = plan
        out = eng.run(eng.init_state(), steps)
        assert eng.impl == "banded" and int(np.asarray(out.overflow)) == 0
        _JAX[key] = (eng.gather(out), int(np.asarray(out.collisions)))
    return _JAX[key]


def _mesh(args, d, plan=None, impl="banded"):
    eng = ShardedEngine(SimConfig(*args, n_shards=d), impl=impl,
                        device="cpu")
    if plan is not None:
        eng._band_plan = plan
    return eng


@pytest.mark.parametrize("case", PLANS, ids=[_ids(c) for c in PLANS])
def test_banded_mesh_matches_jax(case):
    """The port's mesh against JAX's banded-cols mesh and the port's
    one-device resident run: count and dead set exact, f32 tolerance; no
    pid lost."""
    args, steps, d, plan = case
    eng = _mesh(args, d, plan)
    out = eng.run(eng.init_state(), steps)
    assert eng.impl == "banded" and eng._band_plan == plan
    assert int(out.overflow) == 0
    got = eng.gather(out)
    np.testing.assert_array_equal(got["pid"], np.arange(args[3]))
    ref, ref_count = _jax(args, steps, d, plan)
    single = Engine(SimConfig(*args), impl="resident", device="cpu")
    ss = single.run(single.init_state(), steps)
    assert int(out.collisions) == ref_count == int(ss.collisions)
    _assert_close(got, _single(ss), args[1])
    # Against JAX: the f32 tolerance, or the distance between the two
    # packages' one-device runs where that is larger (the tiny box with 98
    # collisions: 5.96e-8 = 1.2e-6·side); the mesh may add nothing to it.
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    for f, scale in (("x", args[1]), ("y", args[1]),
                     ("vx", float(np.abs(ref["vx"]).max()) * 10)):
        tol = max(1e-6 * scale, float(np.abs(_single(ss)[f] - ref[f]).max()))
        np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=tol,
                                   err_msg=f)


def test_col_owner_equals_jax():
    for nc in (8, 9, 13, 100, 447):
        for d in (1, 2, 3, 4, 8):
            cols = np.arange(nc)
            np.testing.assert_array_equal(col_owner(nc, d, cols),
                                          jcol_owner(nc, d, cols))


def test_banded_mesh_grows_its_plan():
    """Bands too narrow for their cells: the ladder grows the plan and ends
    on the result of a run that had it from the start."""
    args, steps, d = (-10, 3.0, 16, 600), 10, 8
    # 15 and 19 particles in the bands' fullest cells.
    eng = _mesh(args, d, ((0, 8, 8), (8, 8, 8)))
    out = eng.run(eng.init_state(), steps)
    assert eng.impl == "banded" and int(out.overflow) == 0
    grown = eng._band_plan
    assert all(k > 8 for _, _, k in grown)
    big = _mesh(args, d, grown)
    ref = big.run(big.init_state(), steps)
    assert int(out.collisions) == int(ref.collisions)
    got, want = eng.gather(out), big.gather(ref)
    for f in ("pid", "alive", "x", "y", "vx", "vy", "m"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_banded_mesh_ladder_reaches_the_sweep(monkeypatch):
    """Where a grown plan cannot pass the kernels' K (lowered here to 16,
    below the 19 particles of the fullest cell), the ladder escalates to
    the mesh sweep, re-packed by row block: the one-device resident run's
    count and dead set."""
    monkeypatch.setattr(port_engine, "MAX_XLA_KCAP", 16)
    args, steps, d = (-10, 3.0, 16, 600), 10, 8
    eng = _mesh(args, d, ((0, 8, 8), (8, 8, 8)))
    out = eng.run(eng.init_state(), steps)
    assert eng.impl == "sweep" and int(out.overflow) == 0
    single = Engine(SimConfig(*args), impl="resident", device="cpu")
    ss = single.run(single.init_state(), steps)
    assert int(out.collisions) == int(ss.collisions)
    _assert_close(eng.gather(out), _single(ss), args[1])


def test_halo_columns_hold_movers_at_their_own_row(monkeypatch):
    """The column-first rule: a mover bound for another shard waits in the
    halo column at its own destination row, so no particle sits in a halo
    cell of another row (JAX's corner halo cells stay empty), and the halo
    columns are empty once the ship round has delivered (no SHIP_OVF)."""
    args, steps, d, plan = PLANS[6]
    seen = []

    def spy(mesh, phases, row_start, rows, geometry, dest):
        (_, halo), = phases

        def watched(x, y, occ, row, shard, gy, lc, c0, cnt):
            if x.shape[0] == halo.numel():  # the halo slots
                _, cy, _ = res.cell_of(x, y, args[1], args[2])
                seen.append((int(occ.sum()),
                             bool(((cy == gy) | ~occ).all()),
                             bool(((lc == 0) | (lc == lc.max())).all())))
            return dest(x, y, occ, row, shard, gy, lc, c0, cnt)

        return real(mesh, phases, row_start, rows, geometry, watched)

    real = sharded_banded_cols.make_halo_transport
    monkeypatch.setattr(sharded_banded_cols, "make_halo_transport", spy)
    eng = _mesh(args, d, plan)
    out = eng.run(eng.init_state(), steps)
    assert int(out.overflow) == 0 and eng.ship_rounds == 1
    assert len(seen) == steps
    assert sum(n for n, _, _ in seen) > 0          # movers crossed shards
    assert all(same_row and halo for _, same_row, halo in seen)


def test_streaming_route_equals_resident_mesh(monkeypatch):
    """A uniform load above the (lowered) streaming threshold takes equal
    bands on the column-sharded engine; it ends on the resident mesh's
    count and dead set."""
    monkeypatch.setattr(port_engine, "_STREAM_BYTES", 1)
    monkeypatch.setattr(port_engine, "_STREAM_BAND_BYTES", 4000)
    args, steps, d = (1, 8.0, 16, 2048), 5, 8
    eng = ShardedEngine(SimConfig(*args, n_shards=d), device="cpu")
    state = eng.init_state()
    assert eng.impl == "banded" and len(eng._band_plan) >= 2
    out = eng.run(state, steps)
    assert eng.impl == "banded" and int(out.overflow) == 0
    res_eng = ShardedEngine(SimConfig(*args, n_shards=d), impl="resident",
                            device="cpu")
    ref = res_eng.run(res_eng.init_state(), steps)
    assert int(out.collisions) == int(ref.collisions)
    _assert_close(eng.gather(out), res_eng.gather(ref), args[1])


def test_banded_mesh_pair_tiles_are_the_runs():
    """``pair_tiles`` gives per band the tiles the run's pair passes take:
    the counts of the fused pass on step k's band tiles add up to the count
    step k adds."""
    args, d, plan = (5893, 0.05, 16, 256), 8, ((0, 8, 96), (8, 8, 96))
    eng = _mesh(args, d, plan)
    state = eng.init_state()
    eng.run(state, 0)
    _, pair_tiles, run = make_sharded_banded_cols_run(
        eng.config, eng.mesh, plan, eng.capacity)
    counts = [int(run(state, k).collisions) for k in range(4)]
    for k in range(1, 4):
        total = 0
        for (x, y, mf, alive, pid), (_, rw, kb) in zip(pair_tiles(state, k),
                                                       plan):
            assert x.shape == (d * rw * (16 // d + 2), kb)
            total += int(cell_pairs.fused_pairs_ref(
                x, y, mf, alive, pid, kb, port_engine.EPSILON)[2])
        assert total == counts[k] - counts[k - 1]


@pytest.mark.parametrize("impl", ["banded", "resident"])
def test_pack_bins_in_the_runs_precision(impl):
    """A particle on a shard boundary is packed where the run bins it: x =
    0.49999999 is column 4 in f64 but column 5 in f32 (cell width 0.1), so
    a slab filled by the f64 cell would hold a stray for the f32 run (the
    census bands by columns, resident tiles by rows)."""
    eng = _mesh((1, 1.0, 10, 100), 2,
                ((0, 5, 32), (5, 5, 32)) if impl == "banded" else None,
                impl=impl)
    g = {k: v.astype(np.float64) if v.dtype == np.float32 else v
         for k, v in eng.gather(eng.init_state()).items()}
    axis = "x" if impl == "banded" else "y"
    g[axis][0] = 0.49999999
    assert int(g[axis][0] / 0.1) == 4
    assert int(np.float32(g[axis][0]) / np.float32(0.1)) == 5
    out = eng.run(eng.pack_particles(g), 1)
    assert eng.impl == impl and int(out.overflow) == 0
