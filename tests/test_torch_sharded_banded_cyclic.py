"""The port's block-cyclic banded mesh (``parallel/sharded_banded``,
``ShardedEngine(impl="banded-cyclic")``) on the CPU, against the JAX
package's ``ShardedEngine(impl="banded-cyclic")`` on the bootstrap's 8
virtual CPU devices and against the port's one-device banded engine on the
same plan.

Collision counts and dead sets exact; positions within 1e-6·side and
velocities within 1e-5·max|v| (``test_torch_engine._assert_same_run``'s
tolerances) of the port's one-device run, and of JAX's mesh where the two
packages' one-device runs are that close. The planners and the chunk map
equal JAX's. Each JAX run happens once, in a module-scoped cache.
"""

import numpy as np
import pytest
import torch

from particlesimulation_tpu.config import Precision as JPrecision
from particlesimulation_tpu.config import SimConfig as JSimConfig
from particlesimulation_tpu.ops.banded import (
    plan_bands_cyclic as jplan_bands_cyclic)
from particlesimulation_tpu.parallel.sharded import (
    ShardedEngine as JShardedEngine)
from particlesimulation_tpu.parallel.sharded_banded import (
    cyclic_owner_of_rows as jcyclic_owner_of_rows)
from particlesimulation_tpu.utils import checkpointing as jckpt
from particlesimulation_tpu_torch import engine as port_engine
from particlesimulation_tpu_torch.config import SimConfig
from particlesimulation_tpu_torch.engine import Engine
from particlesimulation_tpu_torch.engine import MAX_XLA_KCAP as JAX_MAX_KCAP
from particlesimulation_tpu_torch.initializer import init_particles_host
from particlesimulation_tpu_torch.ops.banded import plan_bands_cyclic
from particlesimulation_tpu_torch.ops.cuda import stencil as stencil_ops
from particlesimulation_tpu_torch.parallel.mesh import LocalMesh
from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine
from particlesimulation_tpu_torch.parallel.sharded_banded import (
    cyclic_layout, cyclic_owner_of_rows)
from particlesimulation_tpu_torch.state import ShardedState
from particlesimulation_tpu_torch.utils import checkpointing
from tests.test_torch_sharded import FIELDS, _assert_close, _single

torch.set_num_threads(2)

# tests/test_sharded_banded.py:53-71: one band over 8 shards, two equal
# bands with collisions and migration, a blob on two bands of distinct K, a
# ragged band (13 rows on 8 shards), D = 1 (both edge shifts wrap onto the
# one shard), and bands of 4 and 5 rows on 4 shards.
PLANS = [
    ((5893, 0.05, 8, 64), 12, 8, ((0, 8, 64),)),
    ((5893, 0.05, 16, 256), 12, 8, ((0, 8, 96), (8, 8, 96))),
    ((-10, 3.0, 16, 600), 10, 8, ((0, 8, 96), (8, 8, 64))),
    ((-10, 3.0, 13, 300), 10, 8, ((0, 13, 96),)),
    ((17, 0.12, 8, 120), 20, 1, ((0, 4, 64), (4, 4, 64))),
    ((3, 8.0, 9, 400), 30, 4, ((0, 4, 96), (4, 5, 96))),
]
_JAX = {}


def _ids(case):
    args, steps, d, plan = case
    return f"{'_'.join(map(str, args))}-D{d}-{len(plan)}bands"


def _jax(args, steps, d, plan):
    """JAX's block-cyclic banded run, once per case: (engine, initial
    state, final state, gathered, count)."""
    key = (args, steps, d, plan)
    if key not in _JAX:
        eng = JShardedEngine(JSimConfig(*args, precision=JPrecision.FAST,
                                        n_shards=d), impl="banded-cyclic")
        eng._band_plan = plan
        s0 = eng.init_state()
        out = eng.run(s0, steps)
        assert eng.impl == "banded" and eng.banded_variant == "cyclic"
        assert int(np.asarray(out.overflow)) == 0
        _JAX[key] = (eng, s0, out, eng.gather(out),
                     int(np.asarray(out.collisions)))
    return _JAX[key]


def _port(args, steps, d, plan):
    """The port's block-cyclic run, once per case: (engine, final state)."""
    key = (args, steps, d, plan, "port")
    if key not in _JAX:
        eng = _mesh(args, d, plan)
        _JAX[key] = (eng, eng.run(eng.init_state(), steps))
    return _JAX[key]


def _mesh(args, d, plan=None, impl="banded-cyclic"):
    eng = ShardedEngine(SimConfig(*args, n_shards=d), impl=impl,
                        device="cpu")
    if plan is not None:
        eng._band_plan = plan
    return eng


def _uneven_census():
    """UNEVEN's initial census (the reference report's clustered
    workload, -23 5000 100 1000000)."""
    cfg = SimConfig(-23, 5000.0, 100, 1_000_000)
    xs, ys = init_particles_host(cfg)[:2]
    cx, cy = (np.clip((a / 50.0).astype(np.int64), 0, 99) for a in (xs, ys))
    return np.bincount(cy * 100 + cx, minlength=10_000)


@pytest.mark.parametrize("hist", ["uneven", "blob", "uniform", "random"])
def test_planner_and_chunk_map_equal_jax(hist):
    """``plan_bands_cyclic`` at JAX's K cap and ``cyclic_owner_of_rows``
    give JAX's plans and owners, UNEVEN's census among the histograms."""
    rng = np.random.default_rng(3)
    if hist == "uneven":
        h, nc = _uneven_census(), 100
    else:
        nc = 40
        y, x = np.mgrid[:nc, :nc]
        h = {"blob": (2000 * np.exp(-((y - 20) ** 2 + (x - 15) ** 2) / 50)
                      ).astype(int),
             "uniform": np.full((nc, nc), 30),
             "random": rng.integers(0, 50, (nc, nc)) ** 2}[hist].reshape(-1)
    planned = 0
    for d in (1, 2, 3, 4, 8):
        plan = plan_bands_cyclic(h, nc, d, JAX_MAX_KCAP)
        assert plan == jplan_bands_cyclic(h, nc, d, JAX_MAX_KCAP)
        if plan is None:
            continue
        planned += 1
        assert all(rw >= d for _, rw, _ in plan)
        rows = np.arange(nc)
        owner = cyclic_owner_of_rows(plan, d, rows)
        np.testing.assert_array_equal(owner,
                                      jcyclic_owner_of_rows(plan, d, rows))
        assert np.bincount(owner, minlength=d).min() > 0
    assert (planned == 0) == (hist in ("uniform", "random"))


@pytest.mark.parametrize("case", PLANS, ids=[_ids(c) for c in PLANS])
def test_cyclic_mesh_matches_jax(case):
    """The port's block-cyclic mesh against JAX's and the port's one-device
    banded run on the same plan: count and dead set exact, f32 tolerance;
    no pid lost."""
    args, steps, d, plan = case
    eng, out = _port(*case)
    assert eng.impl == "banded" and eng.banded_variant == "cyclic"
    assert eng._band_plan == plan and int(out.overflow) == 0
    got = eng.gather(out)
    np.testing.assert_array_equal(got["pid"], np.arange(args[3]))
    *_, ref, ref_count = _jax(args, steps, d, plan)
    single = Engine(SimConfig(*args), impl="banded", device="cpu")
    s0 = single.init_state()
    single._band_plan = plan
    ss = single.run(s0, steps)
    assert single.impl == "banded"
    assert int(out.collisions) == ref_count == int(ss.collisions)
    _assert_close(got, _single(ss), args[1])
    # Against JAX: the f32 tolerance, or the distance between the two
    # packages' one-device runs where that is larger (the tiny boxes); the
    # mesh may add nothing to it.
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    for f, scale in (("x", args[1]), ("y", args[1]),
                     ("vx", float(np.abs(ref["vx"]).max()) * 10)):
        tol = max(1e-6 * scale, float(np.abs(_single(ss)[f] - ref[f]).max()))
        np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=tol,
                                   err_msg=f)


def test_variants_agree():
    """Both banded decompositions on a shard-divisible plan
    (tests/test_sharded_banded.py:82): the same count and dead set, and
    positions to the f32 tolerance."""
    args, steps, d, plan = PLANS[1]
    cols = _mesh(args, d, plan, "banded-cols")
    out = cols.run(cols.init_state(), steps)
    cyclic, ref = _port(*PLANS[1])
    assert (cols.banded_variant, cyclic.banded_variant) == ("cols", "cyclic")
    assert int(out.collisions) == int(ref.collisions)
    _assert_close(cols.gather(out), cyclic.gather(ref), args[1])


def test_edge_shift_of_the_com_halo():
    """Each chunk's COM halo rows are the global grid's rows just above and
    below it, across the edge shards' band shift, on 3 shards with a
    ragged band (5 rows) and at D = 1, where both shifts wrap onto the one
    shard."""
    nc = 11
    grid = torch.arange(nc * 2, dtype=torch.float64).view(nc, 2)
    for d, plan in ((3, ((0, 3, 32), (3, 5, 32), (8, 3, 32))),
                    (1, ((0, 4, 32), (4, 7, 32)))):
        owner = cyclic_owner_of_rows(plan, d, np.arange(nc))
        mesh = LocalMesh(d, "cpu")
        grids, cnt, first = [], [], []
        for r0, rw, _ in plan:
            rows = [[r for r in range(r0, r0 + rw) if owner[r] == s]
                    for s in range(d)]
            cmax = max(map(len, rows))
            g = torch.zeros(d, cmax, 2, dtype=torch.float64)
            for s, rs in enumerate(rows):
                g[s, :len(rs)] = grid[rs]
            grids.append((g,))
            cnt.append([len(rs) for rs in rows])
            first.append([rs[0] for rs in rows])
        layout = cyclic_layout(mesh, [g[0].shape[1] for g in grids], 2,
                               [torch.tensor(f) for f in first],
                               [torch.tensor(c) for c in cnt])
        padded = stencil_ops.padded_grids(
            grids, layout, stencil_ops.exchange(mesh, layout, grids))
        for b, (gp,) in enumerate(padded):
            for s in range(d):
                top, n = first[b][s], cnt[b][s]
                assert torch.equal(gp[s, 0], grid[(top - 1) % nc])
                assert torch.equal(gp[s, n + 1], grid[(top + n) % nc])
                assert torch.equal(gp[s, 1:n + 1], grid[top:top + n])


def test_cyclic_plan_grows_on_overflow():
    """Bands too narrow for their cells: the ladder grows the plan and ends
    on the result of a run that had it from the start."""
    args, steps, d = (-10, 3.0, 16, 600), 10, 8
    eng = _mesh(args, d, ((0, 8, 8), (8, 8, 8)))
    out = eng.run(eng.init_state(), steps)
    assert eng.impl == "banded" and int(out.overflow) == 0
    grown = eng._band_plan
    assert all(k > 8 for _, _, k in grown)
    big = _mesh(args, d, grown)
    ref = big.run(big.init_state(), steps)
    assert int(out.collisions) == int(ref.collisions)
    got, want = eng.gather(out), big.gather(ref)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_cyclic_ladder_reaches_the_sweep(monkeypatch):
    """Where a grown plan cannot pass the kernels' K (lowered to 16, below
    the fullest cell's 19), the ladder re-packs onto the mesh sweep by row
    block: the one-device resident run's count and dead set."""
    monkeypatch.setattr(port_engine, "MAX_XLA_KCAP", 16)
    args, steps, d = (-10, 3.0, 16, 600), 10, 8
    eng = _mesh(args, d, ((0, 8, 8), (8, 8, 8)))
    out = eng.run(eng.init_state(), steps)
    assert eng.impl == "sweep" and int(out.overflow) == 0
    ss = Engine(SimConfig(*args), impl="resident", device="cpu")
    ss = ss.run(ss.init_state(), steps)
    assert int(out.collisions) == int(ss.collisions)
    _assert_close(eng.gather(out), _single(ss), args[1])


def test_census_plans_cyclic_bands():
    """``impl="banded-cyclic"`` on a clustered load with no plan given
    plans JAX's shard-divisible bands; the census never picks it."""
    args = (-7, 5000.0, 100, 200_000)
    eng = _mesh(args, 2)
    eng.init_state()
    jeng = JShardedEngine(JSimConfig(*args, precision=JPrecision.FAST,
                                     n_shards=2), impl="banded-cyclic")
    jeng.init_state()
    assert eng.impl == jeng.impl == "banded"
    assert eng._band_plan == tuple(map(tuple, jeng._band_plan))
    assert len(eng._band_plan) >= 2
    assert eng.ownership_plan() == jeng.ownership_plan() == eng._band_plan
    auto = ShardedEngine(SimConfig(*args, n_shards=2), device="cpu")
    auto.init_state()
    assert auto.impl == "banded" and auto.banded_variant == "cols"


@pytest.mark.parametrize("source", ["port", "jax"])
def test_cyclic_checkpoint_resumes_as_saved(source, tmp_path):
    """A cyclic checkpoint (its band plan recorded as its ownership), of
    the port or of JAX, restored into the port's cyclic engine on that
    plan: the slabs placed as saved, and the resumed run ends on JAX's
    uninterrupted run's count and dead set."""
    args, steps, d, plan = PLANS[5]
    jeng, js0, jout, ref, ref_count = _jax(args, steps, d, plan)
    path = str(tmp_path / "cyclic.npz")
    eng = _mesh(args, d, plan)
    s0 = eng.init_state()
    if source == "port":
        mid = eng.run(s0, 15)
        checkpointing.save_sharded_state(path, mid, engine=eng)
    else:
        jmid = jeng.run(js0, 15)
        jckpt.save_sharded_state(path, jmid, n_shards=d,
                                 band_plan=jeng.ownership_plan())
        eng.capacity = jeng.capacity
        mid = None
    with np.load(path) as z:
        saved = {f: z[f] for f in z.files}
    assert tuple(map(tuple, saved["band_plan"])) == plan
    restored = checkpointing.restore_sharded(path, eng)
    for f in ShardedState._fields:
        np.testing.assert_array_equal(getattr(restored, f).numpy(), saved[f],
                                      err_msg=f)
    out = eng.run(restored, steps - 15)
    assert int(out.overflow) == 0 and int(out.collisions) == ref_count
    got = eng.gather(out)
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    np.testing.assert_allclose(got["x"], ref["x"], rtol=0, atol=1e-3)
