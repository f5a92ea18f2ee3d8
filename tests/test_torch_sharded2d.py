"""The port's 2D rectangle mesh (``parallel/sharded2d``,
``parallel/sharded2d_resident``) on the CPU, against the JAX package's
``Sharded2DEngine`` on the bootstrap's 8 virtual CPU devices and against
the port's one-device engines.

* The 2D local mesh: ``ppermute`` along each axis, the row-major layout.
* Parity (f64): the port's 2D run equals the port's one-device parity run
  and JAX's 2D run bit for bit, every field by pid (tests/test_sharded2d.py's
  configs, non-square and uneven aspects among them), and the NumPy oracle
  where JAX's jitted engines leave its bits.
* Fast (f32 rectangle tiles): collision counts and dead sets exact,
  positions within 1e-6·side and velocities within 1e-5·max|v|
  (``test_torch_engine._assert_same_run``), against JAX's 2D resident run
  and the port's one-device resident run.
* The census's delegation to the 1D mesh, which (unlike JAX) also packs,
  saves and restores through the delegate; checkpoints; the ladders.

Each JAX run happens once, in a module-scoped cache.
"""

import numpy as np
import pytest
import torch

from particlesimulation_tpu.config import Precision as JPrecision
from particlesimulation_tpu.config import SimConfig as JSimConfig
from particlesimulation_tpu.parallel.sharded2d import (
    AxisDecomp as JAxisDecomp)
from particlesimulation_tpu.parallel.sharded2d import (
    Sharded2DEngine as JSharded2DEngine)
from particlesimulation_tpu.utils import checkpointing as jckpt
from particlesimulation_tpu_torch import engine as port_engine
from particlesimulation_tpu_torch.config import Precision, SimConfig
from particlesimulation_tpu_torch.engine import Engine
from particlesimulation_tpu_torch.initializer import init_particles_host
from particlesimulation_tpu_torch.ops import resident as res
from particlesimulation_tpu_torch.parallel import sharded2d_resident
from particlesimulation_tpu_torch.parallel.mesh import LocalMesh
from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine
from particlesimulation_tpu_torch.parallel.sharded2d import (AxisDecomp,
                                                             Sharded2DEngine)
from particlesimulation_tpu_torch.state import ShardedState
from particlesimulation_tpu_torch.utils import checkpointing
from tests.oracle_np import NpOracle
from tests.test_torch_sharded import FIELDS, _assert_close, _single

torch.set_num_threads(2)

PARITY, FAST = Precision.PARITY, Precision.FAST
# tests/test_sharded2d.py:64-70 and :91-97: (seed, side, nc, n, steps,
# mesh shape); non-square, column-only and uneven (both axes, 6 shards, a
# prime side) aspects.
PARITY_CASES = [
    (1, 2.0, 8, 200, 10, (2, 4)),
    (-10, 3.0, 16, 300, 10, (2, 2)),
    (1, 2.0, 8, 200, 10, (1, 8)),
    (17, 0.12, 5, 120, 20, (2, 3)),
    (5893, 0.05, 7, 64, 12, (3, 2)),
    (5893, 0.05, 8, 64, 12, (2, 4)),   # where JAX leaves the oracle's bits
]
# tests/test_sharded2d_resident.py:51-59.
RESIDENT_CASES = [
    (5893, 0.05, 8, 64, 12, (2, 4)),
    (5893, 0.05, 8, 64, 12, (4, 2)),
    (17, 0.12, 4, 120, 20, (1, 1)),
    (3, 8.0, 8, 400, 30, (1, 8)),
    (1, 2.0, 9, 200, 10, (2, 2)),      # 9 rows and columns on 2 x 2
]
_JAX = {}


def _cfg(args, precision=FAST, full=False, **kw):
    """A 2D config of (seed, side, nc, n, steps, shape); ``full``: slabs
    and buffers of n entries (tests/test_sharded2d.py's)."""
    seed, side, nc, n, _, shape = args
    if full:
        kw.update(shard_capacity=n, migration_capacity=n)
    return dict(seed=seed, side=side, ncside=nc, n_particles=n,
                precision=precision, n_shards=shape[0] * shape[1],
                mesh_shape=shape, **kw)


def _mesh(args, precision=FAST, impl=None, full=False, **kw):
    return Sharded2DEngine(SimConfig(**_cfg(args, precision, full, **kw)),
                           impl=impl, device="cpu")


def _jax(args, precision):
    """JAX's Sharded2DEngine run, once per case: (gathered, count)."""
    key = (args, precision)
    if key not in _JAX:
        parity = precision is PARITY
        cfg = _cfg(args, JPrecision.PARITY if parity else JPrecision.FAST,
                   full=parity)
        eng = JSharded2DEngine(JSimConfig(**cfg), args[5],
                               impl=None if parity else "resident")
        out = eng.run(eng.init_state(), args[4])
        assert int(np.asarray(out.overflow)) == 0
        _JAX[key] = (eng.gather(out), int(np.asarray(out.collisions)))
    return _JAX[key]


def _one_device(args, precision=FAST, impl=None):
    seed, side, nc, n, steps, _ = args
    eng = Engine(SimConfig(seed, side, nc, n, precision=precision),
                 impl=impl, device="cpu")
    out = eng.run(eng.init_state(), steps)
    return _single(out), int(out.collisions)


@pytest.mark.parametrize("size,nb", [(3, 1), (8, 3), (9, 4), (13, 4),
                                     (100, 7), (5, 5)])
def test_axis_decomp_equals_jax(size, nb):
    got, want = AxisDecomp(size, nb), JAxisDecomp(size, nb)
    lines = np.arange(size)
    np.testing.assert_array_equal(got.owner_of(lines), want.owner_of(lines))
    assert got.max_blocks == want.max_blocks
    assert [(got.first_of(s), got.count_of(s)) for s in range(nb)] == [
        (want.first_of(s), want.count_of(s)) for s in range(nb)]


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (2, 3)])
def test_local_mesh_ppermute_on_both_axes(shape):
    """Shard r·d_c + c sits at (r, c): a rows shift moves a leaf to (r +
    shift, c), a cols shift to (r, c + shift), each wrapping within its
    axis; a (D, 1) mesh's rows axis is the 1D ring."""
    d_r, d_c = shape
    mesh = LocalMesh(d_r * d_c, "cpu", shape)
    r, c = mesh.coords
    assert torch.equal(r * d_c + c, mesh.shard_ids)
    leaf = torch.stack([mesh.shard_ids, -mesh.shard_ids], dim=1)
    for shift in (1, -1, 2):
        got = mesh.ppermute({"a": leaf}, shift, "rows")["a"]
        src = ((r - shift) % d_r) * d_c + c
        assert torch.equal(got[:, 0], src) and torch.equal(got[:, 1], -src)
        got = mesh.ppermute((leaf,), shift, "cols")[0]
        assert torch.equal(got[:, 0], r * d_c + (c - shift) % d_c)
    ring = LocalMesh(d_r * d_c, "cpu")
    assert ring.shape == (d_r * d_c, 1)
    assert torch.equal(ring.ppermute(leaf, 1), torch.roll(leaf, 1, 0))


@pytest.mark.parametrize("args", PARITY_CASES,
                         ids=lambda a: "_".join(map(str, a[:5])) + "-"
                         + "x".join(map(str, a[5])))
def test_parity_2d_bitwise(args):
    """Port 2D mesh == port one device == JAX 2D mesh, bit for bit by pid;
    on the tiny box (5893 0.05 8 64), where the JAX engines round one y a
    few ulps off the NumPy oracle (``test_torch_sharded``), the port is
    held to the oracle and JAX to it within 4 ulps."""
    eng = _mesh(args, PARITY, full=True)
    out = eng.run(eng.init_state(), args[4])
    assert eng.impl == "sweep" and out.x.dtype == torch.float64
    assert int(out.overflow) == 0
    got = eng.gather(out)
    single, count = _one_device(args, PARITY)
    ref, ref_count = _jax(args, PARITY)
    assert int(out.collisions) == count == ref_count
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], single[f], err_msg=f)
    if args[:4] != (5893, 0.05, 8, 64):
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
        return
    oracle = NpOracle(args[1], args[2], *init_particles_host(eng.config))
    for _ in range(args[4]):
        oracle.step()
    assert count == oracle.collisions
    for f in FIELDS[1:]:
        want = np.asarray(getattr(oracle, f))
        np.testing.assert_array_equal(got[f], want, err_msg=f)
        if f == "alive":
            np.testing.assert_array_equal(ref[f], want)
        else:
            np.testing.assert_array_max_ulp(ref[f], want, maxulp=4)


@pytest.mark.parametrize("args", RESIDENT_CASES,
                         ids=lambda a: "_".join(map(str, a[:5])) + "-"
                         + "x".join(map(str, a[5])))
def test_resident_2d_matches(args):
    """Rectangle tiles: JAX's 2D resident result and the port's one-device
    resident one, to the f32 tolerance; no pid lost or duplicated."""
    eng = _mesh(args, impl="resident")
    out = eng.run(eng.init_state(), args[4])
    assert eng.impl == "resident" and int(out.overflow) == 0
    got = eng.gather(out)
    np.testing.assert_array_equal(got["pid"], np.arange(args[3]))
    ref, ref_count = _jax(args, FAST)
    single, count = _one_device(args, impl="resident")
    assert int(out.collisions) == ref_count == count
    _assert_close(got, ref, args[1])
    _assert_close(got, single, args[1])


def _diagonal(precision):
    """tests/test_sharded2d.py:126: particle 0 at (2.04, 2.04) on a 4 x 4
    grid of side 4, moving (-1, -1), crosses the (2, 2) block corner of a
    2 x 2 mesh in one step: a row hop and a column hop at once."""
    base = dict(seed=1, side=4.0, ncside=4, n_particles=8,
                precision=precision)
    xs, ys, vxs, vys, ms = init_particles_host(SimConfig(**base))
    g = dict(x=xs.copy(), y=ys.copy(), vx=vxs.copy(), vy=vys.copy(), m=ms,
             alive=np.ones(8, dtype=bool), pid=np.arange(8, dtype=np.int32))
    g["x"][0] = g["y"][0] = 2.04
    g["vx"][0] = g["vy"][0] = -1.0
    return base, g


@pytest.mark.parametrize("precision", ["parity", "fast"])
def test_diagonal_mover(precision, monkeypatch):
    """The diagonal mover reaches its cell: parity bit for bit the one
    device; on rectangle tiles the one-device resident run's bits, with the
    mover routed through a halo row at its own column and then a halo
    column at its own row, so the corner halo cells stay empty."""
    base, g = _diagonal(Precision(precision))
    corners = []

    def spy(mesh, phases, row_start, rows, geometry, dest):
        migrate = real(mesh, phases, row_start, rows, geometry, dest)

        def watched(ts, ship_rounds):
            out = migrate(ts, ship_rounds)
            occ = out[0].occ.view(4, 4, 4, -1).any(-1)   # (shard, row, col)
            corners.append(int(occ[:, ::3, ::3].sum()))
            return out

        return watched

    real = sharded2d_resident.make_halo_transport
    monkeypatch.setattr(sharded2d_resident, "make_halo_transport", spy)
    cfg = SimConfig(**base, n_shards=4, mesh_shape=(2, 2), shard_capacity=16,
                    migration_capacity=8)
    eng = Sharded2DEngine(cfg, impl=None if precision == "parity"
                          else "resident", device="cpu")
    state = eng.pack_particles(g)
    cells = []
    for _ in range(3):
        state = eng.run(state, 1)
        x, y = (getattr(state, k)[state.pid == 0][0] for k in ("x", "y"))
        cells.append((int(y // 1.0), int(x // 1.0)))
    assert cells[0] == (1, 1)     # from block (1, 1) to block (0, 0)
    se = Engine(SimConfig(**base), impl=None if precision == "parity"
                else "resident", device="cpu")
    one = se.run(_packed(se, g), 3)
    got, want = eng.gather(state), _single(one)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert corners == ([] if precision == "parity" else [0, 0, 0])


def _packed(eng, g):
    """A one-device state of host arrays, sorted by (cell key, pid)."""
    from particlesimulation_tpu_torch.state import state_from_numpy

    w = eng.config.side / eng.config.ncside
    nc = eng.config.ncside
    key = (np.clip((g["y"] / w).astype(np.int64), 0, nc - 1) * nc
           + np.clip((g["x"] / w).astype(np.int64), 0, nc - 1))
    o = np.lexsort((g["pid"], key))
    fields = {k: np.asarray(v)[o] for k, v in g.items()}
    fields.update(collisions=np.int64(0), panics=np.int32(0),
                  overflow=np.int32(0))
    return state_from_numpy(fields, torch.device("cpu"), eng.dtype)


@pytest.mark.parametrize("precision", ["parity", "fast"])
def test_chunked_runs_compose(precision):
    """run(5) + run(5) == run(10) at (2, 3): parity bit for bit; fast with
    the count and dead set exact, positions to the f32 tolerance (each
    run's prologue lays a cell out in pid order)."""
    args = (17, 0.12, 5, 120, 10, (2, 3))
    e1, e2 = _mesh(args, Precision(precision)), _mesh(args,
                                                      Precision(precision))
    s1 = e1.run(e1.run(e1.init_state(), 5), 5)
    s2 = e2.run(e2.init_state(), 10)
    g1, g2 = e1.gather(s1), e2.gather(s2)
    assert int(s1.collisions) == int(s2.collisions)
    if precision == "fast":
        assert e1.impl == e2.impl == "resident"
        _assert_close(g1, g2, args[1])
        return
    for f in FIELDS:
        np.testing.assert_array_equal(g1[f], g2[f], err_msg=f)


@pytest.mark.parametrize("case", ["migration", "slab_sweep", "slab_resident",
                                  "tile", "ship", "to_sweep"])
def test_ladder_replays_losslessly(case, monkeypatch):
    """Each overflow cause replays the run and ends on the result of a run
    that had the capacity from the start, bit for bit: the sweep's buffers
    and slab, the resident slab (CAP_OVF), tiles, ship rounds (SHIP_OVF);
    and tiles past the kernels' K (lowered here to 16) go to the sweep on
    the same rectangles."""
    parity = case in ("migration", "slab_sweep")
    args = {"migration": (17, 0.12, 4, 120, 20, (2, 2)),
            "slab_sweep": (3, 8.0, 8, 400, 30, (2, 4)),
            "slab_resident": (17, 0.12, 4, 120, 20, (2, 2)),
            "tile": (1, 1.0, 8, 500, 5, (2, 2)),
            "ship": (5893, 0.05, 8, 64, 12, (8, 1)),
            "to_sweep": (1, 1.0, 8, 500, 5, (2, 2))}[case]
    precision = PARITY if parity else FAST
    impl = None if parity else "resident"
    if case == "to_sweep":
        monkeypatch.setattr(port_engine, "MAX_XLA_KCAP", 16)
    big = _mesh(args, precision, impl)
    if case == "migration":
        # tests/test_sharded2d.py:186's capacities.
        eng = _mesh(args, precision, impl, shard_capacity=40,
                    migration_capacity=2)
    elif case.startswith("slab"):
        d = args[5][0] * args[5][1]
        tight = int(big.init_state().valid.view(d, -1).sum(1).max())
        eng = _mesh(args, precision, impl, shard_capacity=tight)
        big = _mesh(args, precision, impl)
    elif case in ("tile", "to_sweep"):
        eng = Sharded2DEngine(SimConfig(**_cfg(args)), impl=impl, kcap=8,
                              device="cpu")
    else:
        eng = _mesh(args, precision, impl)
    state = eng.init_state()
    cap0 = eng.capacity
    out = eng.run(state, args[4])
    assert int(out.overflow) == 0
    grew = {"migration": lambda: eng.bcap > 2,
            "slab_sweep": lambda: eng.capacity > cap0,
            "slab_resident": lambda: eng.capacity > cap0,
            "tile": lambda: eng.kcap > 8,
            "ship": lambda: eng.ship_rounds > 1,
            "to_sweep": lambda: eng.impl == "sweep"}[case]
    assert grew()
    if case == "to_sweep":
        big = _mesh(args, precision, "sweep")
    else:
        assert eng.impl == ("sweep" if parity else "resident")
    if case == "tile":
        big = Sharded2DEngine(SimConfig(**_cfg(args)), impl=impl,
                              kcap=eng.kcap, device="cpu")
    if case == "ship":
        big.ship_rounds = eng.ship_rounds
    ref = big.run(big.init_state(), args[4])
    got, want = eng.gather(out), big.gather(ref)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert int(out.collisions) == int(ref.collisions)


@pytest.mark.parametrize("case", ["sparse", "clustered", "uniform"])
def test_census_routes_as_jax(case):
    """The census under ``mesh_shape`` (2, 4) (tests/test_sharded2d.py:
    294-340): sparse loads delegate to super-cells (run: the one-device
    supercell run's count and dead set), clustered ones to column bands on
    JAX's plan (at init only), uniform ones stay on rectangle tiles (run).
    The route, super-cell factor and band plan are JAX's."""
    args = {"sparse": (1, 3.0, 24, 300, 8, (2, 4)),
            "clustered": (-7, 5000.0, 100, 200_000, 0, (2, 4)),
            "uniform": (3, 8.0, 8, 400, 5, (2, 4))}[case]
    eng = _mesh(args)
    state = eng.init_state()
    jeng = JSharded2DEngine(JSimConfig(**_cfg(args, JPrecision.FAST)),
                            args[5])
    jeng.init_state()
    want = {"sparse": "supercell", "clustered": "banded",
            "uniform": "resident"}[case]
    assert eng.impl == jeng.impl == want
    assert (eng.target() is eng) == (jeng._delegate is None) == (
        case == "uniform")
    if case != "uniform":
        d, jd = eng.target(), jeng._delegate
        assert isinstance(d, ShardedEngine) and d.config.mesh_shape == ()
        assert d._sc_factor == jd._sc_factor
        assert d.banded_variant == jd.banded_variant == "cols"
        assert d._band_plan == (jd._band_plan and tuple(
            tuple(p) for p in jd._band_plan))
    if case == "clustered":
        assert len(eng.target()._band_plan) >= 2
        return
    out = eng.run(state, args[4])
    assert int(out.overflow) == 0
    single, count = _one_device(args, impl=None if case == "uniform"
                                else "supercell")
    assert int(out.collisions) == count
    np.testing.assert_array_equal(eng.gather(out)["alive"], single["alive"])


def test_delegation_forwards_every_slab_entry(tmp_path):
    """A 2D engine whose census delegated (sparse: super-cells) packs,
    saves and restores through its delegate. In JAX only run, result and
    gather forward: its pack_particles there builds rectangle slabs, which
    the delegate's super-row run flags as strays. Here a re-pack of the
    gathered state runs on, a checkpoint records the delegate's geometry
    and ownership and restores as saved, and a fresh 2D engine restoring
    it routes on the checkpoint's particles and resumes on its delegate."""
    args = (1, 3.0, 24, 300, 8, (2, 4))
    eng = _mesh(args)
    mid = eng.run(eng.init_state(), 4)
    d = eng.target()
    assert d is not eng and eng.impl == "supercell"
    assert eng.ownership_plan() == d.ownership_plan() == (
        (-2, d._sc_factor, -2),)
    full = eng.run(mid, 4)
    repacked = eng.pack_particles(eng.gather(mid),
                                  collisions=int(mid.collisions))
    assert repacked.x.shape == (8 * d.capacity,)
    out = eng.run(repacked, 4)
    assert int(out.overflow) == 0 and int(out.collisions) == int(
        full.collisions)
    path = str(tmp_path / "delegated.npz")
    checkpointing.save_sharded_state(path, mid, engine=eng)
    with np.load(path) as z:
        assert tuple(z["mesh_shape"]) == () and int(z["n_shards"]) == 8
        assert tuple(map(tuple, z["band_plan"])) == d.ownership_plan()
    restored = checkpointing.restore_sharded(path, eng)
    for f in ShardedState._fields:
        assert torch.equal(getattr(restored, f), getattr(mid, f)), f
    fresh = _mesh(args)
    out = fresh.run(checkpointing.restore_sharded(path, fresh), 4)
    assert fresh.impl == "supercell" and int(out.overflow) == 0
    assert int(out.collisions) == int(full.collisions)
    np.testing.assert_array_equal(fresh.gather(out)["alive"],
                                  eng.gather(full)["alive"])


def test_fresh_init_state_routes_again():
    """A delegated engine's ``init_state`` runs the census anew."""
    eng = _mesh((1, 3.0, 24, 300, 8, (2, 4)))
    eng.init_state()
    first = eng.target()
    eng.init_state()
    assert eng.target() is not first and eng.impl == "supercell"


@pytest.mark.parametrize("shape,d,ok", [
    ((2, 2), 8, False),     # the product is not n_shards
    ((5, 2), 10, False),    # 5 rows of shards on 4 grid rows
    ((1, 5), 5, False),     # 5 columns of shards on 4 grid columns
    ((2, 2, 1), 4, False),  # not a pair
    ((2, 4), 8, True),      # 8 shards on 4 grid rows: the rectangles fit
    ((), 8, False),         # no mesh_shape: the row split needs a row each
    ((), 4, True)])
def test_config_mesh_shape_validation(shape, d, ok):
    """``mesh_shape`` validates as JAX's SimConfig does
    (tests/test_sharded2d.py:216)."""
    base = dict(seed=1, side=1.0, ncside=4, n_particles=10, n_shards=d,
                mesh_shape=shape)
    for cls in (SimConfig, JSimConfig):
        if ok:
            assert cls(**base).mesh_shape == shape
        else:
            with pytest.raises(ValueError):
                cls(**base)


_CKPT = {}


def _ckpt_run():
    """(2, 4) parity: 8 steps saved, and the uninterrupted 20."""
    if not _CKPT:
        args = (17, 0.12, 8, 120, 20, (2, 4))
        eng = _mesh(args, PARITY, shard_capacity=60, migration_capacity=60)
        s0 = eng.init_state()
        _CKPT.update(args=args, eng=eng, mid=eng.run(s0, 8),
                     full=eng.run(s0, 20))
    return _CKPT


def test_2d_checkpoint_resumes_bit_exact(tmp_path):
    """Save at step 8 at (2, 4), restore as saved, 12 more steps: the
    uninterrupted run's slabs bit for bit (tests/test_sharded2d.py:227)."""
    c = _ckpt_run()
    path = str(tmp_path / "ck2d.npz")
    checkpointing.save_sharded_state(path, c["mid"], engine=c["eng"])
    with np.load(path) as z:
        assert tuple(z["mesh_shape"]) == (2, 4)
    restored = checkpointing.restore_sharded(path, c["eng"])
    assert torch.equal(restored.x, c["mid"].x)
    out = c["eng"].run(restored, 12)
    for f in ShardedState._fields:
        assert torch.equal(getattr(out, f), getattr(c["full"], f)), f


@pytest.mark.parametrize("dst", ["4x2", "1d"])
def test_2d_checkpoint_repacks(dst, tmp_path):
    """The (2, 4) checkpoint onto (4, 2), and a (2, 2) one onto the 1D mesh
    of 4 shards, re-packed (tests/test_sharded2d.py:256): the resumed run
    is the uninterrupted one's by pid, bit for bit."""
    path = str(tmp_path / "ck.npz")
    if dst == "4x2":
        c = _ckpt_run()
        args, mid, full = c["args"], c["mid"], c["eng"].gather(c["full"])
        checkpointing.save_sharded_state(path, mid, engine=c["eng"])
        eng = _mesh(args[:5] + ((4, 2),), PARITY, full=True)
    else:
        args = (17, 0.12, 8, 120, 20, (2, 2))
        src = _mesh(args, PARITY, full=True)
        s0 = src.init_state()
        mid, full = src.run(s0, 8), src.gather(src.run(s0, 20))
        checkpointing.save_sharded_state(path, mid, engine=src)
        eng = ShardedEngine(SimConfig(*args[:4], precision=PARITY,
                                      n_shards=4), device="cpu")
    out = eng.run(checkpointing.restore_sharded(path, eng), 12)
    got = eng.gather(out)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], full[f], err_msg=f)


def test_2d_checkpoint_crosses_packages(tmp_path):
    """A JAX (2, 4) parity checkpoint resumes in the port as saved, and the
    port's resumes in JAX as saved: each resumed run is the other package's
    uninterrupted one, bit for bit by pid."""
    args = (17, 0.12, 8, 120, 20, (2, 4))
    cfg = _cfg(args, JPrecision.PARITY, shard_capacity=60,
               migration_capacity=60)
    jeng = JSharded2DEngine(JSimConfig(**cfg), args[5])
    js0 = jeng.init_state()
    jmid = jeng.run(js0, 8)
    jfull = jeng.gather(jeng.run(js0, 20))
    path = str(tmp_path / "jax2d.npz")
    jckpt.save_sharded_state(path, jmid, n_shards=8, mesh_shape=(2, 4))
    c = _ckpt_run()
    restored = checkpointing.restore_sharded(path, c["eng"])
    np.testing.assert_array_equal(restored.x.numpy(), np.asarray(jmid.x))
    got = c["eng"].gather(c["eng"].run(restored, 12))
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], jfull[f], err_msg=f)
    checkpointing.save_sharded_state(path, c["mid"], engine=c["eng"])
    back = jckpt.restore_sharded(path, jeng)
    np.testing.assert_array_equal(np.asarray(back.x), c["mid"].x.numpy())
    got = jeng.gather(jeng.run(back, 12))
    want = c["eng"].gather(c["full"])
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_pack_bins_in_the_runs_precision():
    """A particle on a column-block boundary is packed where the f32 run
    bins it (x = 0.49999999: column 4 in f64, 5 in f32), on the 2D mesh's
    columns as on the 1D mesh's rows."""
    eng = _mesh((1, 1.0, 10, 100, 1, (1, 2)), impl="resident")
    g = {k: v.astype(np.float64) if v.dtype == np.float32 else v
         for k, v in eng.gather(eng.init_state()).items()}
    g["x"][0] = 0.49999999
    assert int(g["x"][0] / 0.1) == 4
    assert int(np.float32(g["x"][0]) / np.float32(0.1)) == 5
    out = eng.run(eng.pack_particles(g), 1)
    assert eng.impl == "resident" and int(out.overflow) == 0


def test_runs_on_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        Sharded2DEngine(SimConfig(**_cfg((1, 2.0, 8, 200, 1, (2, 2)))))
    with pytest.raises(ValueError, match="mesh_shape"):
        Sharded2DEngine(SimConfig(1, 2.0, 8, 200, n_shards=4),
                        device="cpu")


def test_halo_ring_of_tiles():
    """The tile grid's halo cells: a resident run's tiles after a step hold
    particles only in owned cells (halo rows and columns empty once the
    ship round has delivered)."""
    args = (5893, 0.05, 8, 64, 12, (2, 4))
    eng = _mesh(args, impl="resident")
    state = eng.init_state()
    eng.run(state, 0)
    _, pair_tiles, _ = sharded2d_resident.make_sharded2d_resident_run(
        eng.config, eng.mesh, eng.dec_r, eng.dec_c, eng.kcap, eng.capacity)
    x, y, mf, alive, pid = pair_tiles(state, 3)
    binned = (mf > 0).view(8, 6, 4, -1).any(-1)
    assert binned[:, 1:5, 1:3].any()
    assert not binned[:, 0].any() and not binned[:, 5].any()
    assert not binned[:, :, 0].any() and not binned[:, :, 3].any()
    assert x.shape == (8 * 6 * 4, eng.kcap)
    _, _, valid = res.cell_of(x, y, args[1], args[2])
    assert bool(valid[mf > 0].all())
