"""The port's checkpoints (``utils/checkpointing``) on the CPU: round trips,
restores across mesh geometry, and checkpoints crossing between the port
and the JAX package (the same ``.npz`` format, field for field).

A resume is held to the run that did not stop: bit for bit in parity,
where the result does not depend on slab or slot layout, and wherever the
slabs are placed as saved; the collision count and dead set exactly, and
positions within 1e-3, where a fast run is re-packed (the JAX package's
tests/test_utils.py tolerance for that case).
"""

import numpy as np
import pytest
import torch

from particlesimulation_tpu.config import Precision as JPrecision
from particlesimulation_tpu.config import SimConfig as JSimConfig
from particlesimulation_tpu.engine import Engine as JEngine
from particlesimulation_tpu.parallel.sharded import (
    ShardedEngine as JShardedEngine)
from particlesimulation_tpu.utils import checkpointing as jckpt
from particlesimulation_tpu_torch.config import Precision, SimConfig
from particlesimulation_tpu_torch.engine import Engine
from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine
from particlesimulation_tpu_torch.state import ShardedState, SimState
from particlesimulation_tpu_torch.utils import checkpointing

torch.set_num_threads(2)

FIELDS = ("pid", "x", "y", "vx", "vy", "m", "alive")
MESH = (3, 8.0, 8, 400)        # tests/test_utils.py's mesh config
SINGLE = (8555, 0.05, 3, 30)   # several deaths in one cell


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _by_pid(state):
    """Every particle field of a single-device state (either package's) in
    pid order."""
    order = np.argsort(_np(state.pid))
    return {f: _np(getattr(state, f))[order] for f in FIELDS}


def _assert_same(a, b, count_a, count_b, exact=True):
    assert int(count_a) == int(count_b)
    np.testing.assert_array_equal(a["pid"], b["pid"])
    np.testing.assert_array_equal(a["alive"], b["alive"])
    for f in ("x", "y", "vx", "vy", "m"):
        if exact:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
        elif f in ("x", "y"):
            assert np.max(np.abs(a[f] - b[f])) < 1e-3, f


def _mesh(precision="parity", d=4, args=MESH, **kw):
    return ShardedEngine(SimConfig(*args, precision=Precision(precision),
                                   n_shards=d, **kw), device="cpu")


@pytest.mark.parametrize("precision", ["parity", "fast"])
def test_single_device_round_trip(precision, tmp_path):
    """save_state / load_state: the same dtypes and bits, and the resumed
    run equals the one that did not stop."""
    eng = Engine(SimConfig(*SINGLE, precision=Precision(precision)),
                 device="cpu")
    mid = eng.run(eng.init_state(), 10)
    path = str(tmp_path / "mid.npz")
    checkpointing.save_state(path, mid)
    restored = checkpointing.load_state(path, device="cpu")
    assert isinstance(restored, SimState)
    for f in SimState._fields:
        a, b = getattr(mid, f), getattr(restored, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    a, b = eng.run(mid, 10), eng.run(restored, 10)
    _assert_same(_by_pid(a), _by_pid(b), a.collisions, b.collisions)


@pytest.mark.parametrize("precision", ["parity", "fast"])
def test_mesh_round_trip_as_is(precision, tmp_path):
    """A mesh checkpoint restored onto the engine that wrote it: the slabs
    placed as saved, bit for bit, and the resumed run equals the one that
    did not stop."""
    eng = _mesh(precision)
    mid = eng.run(eng.init_state(), 10)
    path = str(tmp_path / "mid.npz")
    checkpointing.save_sharded_state(path, mid, n_shards=4,
                                     row_starts=eng.config.row_starts)
    restored = checkpointing.restore_sharded(path, eng)
    assert isinstance(restored, ShardedState)
    for f in ShardedState._fields:
        a, b = getattr(mid, f), getattr(restored, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    # A mesh state through save_state / load_state keeps its fields too.
    checkpointing.save_state(path, mid)
    loaded = checkpointing.load_state(path, device="cpu")
    assert all(torch.equal(getattr(mid, f), getattr(loaded, f))
               for f in ShardedState._fields)
    a, b = eng.run(mid, 10), eng.run(restored, 10)
    _assert_same(eng.gather(a), eng.gather(b), a.collisions, b.collisions)


@pytest.mark.parametrize("change", ["width", "row_starts", "mesh_shape",
                                    "band_plan"])
def test_restore_repacks(change, tmp_path):
    """A checkpoint whose geometry differs from the engine's (another mesh
    width, other row boundaries, a 2D mesh's or a banded engine's
    ownership) is re-packed, not placed as saved, and the resumed parity
    run equals the one that did not stop, bit for bit."""
    # Explicit row boundaries (the default split where the case keeps it),
    # so that the census planner leaves them as they are.
    starts = (0, 3, 4, 5) if change == "row_starts" else (0, 2, 4, 6)
    src = ShardedEngine(SimConfig(-4, 8.0, 8, 400, precision=Precision.PARITY,
                                  n_shards=4, row_starts=starts),
                        device="cpu")
    mid = src.run(src.init_state(), 10)
    path = str(tmp_path / "mid.npz")
    checkpointing.save_sharded_state(
        path, mid, n_shards=4, row_starts=src.config.row_starts,
        mesh_shape=(2, 2) if change == "mesh_shape" else (),
        band_plan=((0, 4, 96), (4, 4, 96)) if change == "band_plan" else ())
    d = 2 if change == "width" else 4
    dst = ShardedEngine(SimConfig(-4, 8.0, 8, 400,
                                  precision=Precision.PARITY, n_shards=d,
                                  row_starts=(0, 4) if d == 2 else
                                  (0, 2, 4, 6)),
                        device="cpu")
    dst.capacity = src.capacity
    restored = checkpointing.restore_sharded(path, dst)
    want = dst.pack_particles(src.gather(mid), collisions=mid.collisions,
                              panics=mid.panics)
    assert all(torch.equal(getattr(restored, f), getattr(want, f))
               for f in ShardedState._fields)
    a, b = src.run(mid, 10), dst.run(restored, 10)
    assert int(b.overflow) == 0
    _assert_same(src.gather(a), dst.gather(b), a.collisions, b.collisions)


@pytest.mark.parametrize("where", ["single", "mesh"])
def test_port_checkpoint_resumes_in_jax(where, tmp_path):
    """A parity checkpoint written by the port loads in the JAX package
    (``load_state``; ``restore_sharded`` onto its mesh engine) and resumes
    there bit for bit with the port's own resume."""
    path = str(tmp_path / "port.npz")
    if where == "single":
        eng = Engine(SimConfig(*SINGLE, precision=Precision.PARITY),
                     device="cpu")
        mid = eng.run(eng.init_state(), 10)
        checkpointing.save_state(path, mid)
        jeng = JEngine(JSimConfig(*SINGLE, precision=JPrecision.PARITY))
        ref = jeng.run(jckpt.load_state(path), 10)
        got = eng.run(mid, 10)
        _assert_same(_by_pid(got), _by_pid(ref), got.collisions,
                     np.asarray(ref.collisions))
        return
    eng = _mesh()
    mid = eng.run(eng.init_state(), 10)
    checkpointing.save_sharded_state(path, mid, n_shards=4)
    jeng = JShardedEngine(JSimConfig(*MESH, precision=JPrecision.PARITY,
                                     n_shards=4))
    ref = jeng.run(jckpt.restore_sharded(path, jeng), 10)
    got = eng.run(mid, 10)
    _assert_same(eng.gather(got), jeng.gather(ref), got.collisions,
                 np.asarray(ref.collisions))


@pytest.mark.parametrize("where", ["single", "mesh"])
def test_jax_checkpoint_resumes_in_port(where, tmp_path):
    """And the reverse: a JAX parity checkpoint resumes in the port bit for
    bit with JAX's own resume."""
    path = str(tmp_path / "jax.npz")
    if where == "single":
        jeng = JEngine(JSimConfig(*SINGLE, precision=JPrecision.PARITY))
        mid = jeng.run(jeng.init_state(), 10)
        jckpt.save_state(path, mid)
        eng = Engine(SimConfig(*SINGLE, precision=Precision.PARITY),
                     device="cpu")
        got = eng.run(checkpointing.load_state(path, device="cpu"), 10)
        ref = jeng.run(mid, 10)
        _assert_same(_by_pid(got), _by_pid(ref), got.collisions,
                     np.asarray(ref.collisions))
        return
    jeng = JShardedEngine(JSimConfig(*MESH, precision=JPrecision.PARITY,
                                     n_shards=4))
    mid = jeng.run(jeng.init_state(), 10)
    jckpt.save_sharded_state(path, mid, n_shards=4)
    eng = _mesh()
    eng.capacity = jeng.capacity
    restored = checkpointing.restore_sharded(path, eng)
    # Same geometry: JAX's slabs placed as saved.
    np.testing.assert_array_equal(restored.x.numpy(), np.asarray(mid.x))
    got = eng.run(restored, 10)
    ref = jeng.run(mid, 10)
    _assert_same(eng.gather(got), jeng.gather(ref), got.collisions,
                 np.asarray(ref.collisions))


_BANDED = {}


@pytest.mark.parametrize("impl", ["resident", "sweep"])
def test_jax_banded_checkpoint_repacks(impl, tmp_path):
    """A checkpoint of the JAX block-cyclic banded mesh engine restores onto
    the port's resident or sweep mesh by re-packing (its slabs own cells by
    band, not by row block; the JAX package's
    test_sharded_checkpoint_banded_to_resident_repacks), and the resumed
    run keeps JAX's collisions and dead set, positions within 1e-3."""
    base = (-10, 3.0, 8, 400)
    path = str(tmp_path / "banded.npz")
    if not _BANDED:
        eb = JShardedEngine(JSimConfig(*base, precision=JPrecision.FAST,
                                       n_shards=4), impl="banded-cyclic")
        eb._band_plan = ((0, 4, 96), (4, 4, 96))
        mid = eb.run(eb.init_state(), 8)
        jckpt.save_sharded_state(path, mid, n_shards=4,
                                 band_plan=eb.ownership_plan())
        ref = eb.run(mid, 8)
        with open(path, "rb") as f:
            _BANDED.update(npz=f.read(), capacity=eb.capacity,
                           ref=eb.gather(ref),
                           count=int(np.asarray(ref.collisions)))
    else:
        with open(path, "wb") as f:
            f.write(_BANDED["npz"])
    eng = ShardedEngine(SimConfig(*base, n_shards=4), impl=impl,
                        device="cpu")
    eng.capacity = _BANDED["capacity"]
    restored = checkpointing.restore_sharded(path, eng)
    with np.load(path) as z:
        assert not np.array_equal(restored.pid.numpy(), z["pid"])
    got = eng.run(restored, 8)
    assert int(got.overflow) == 0 and eng.impl == impl
    _assert_same(eng.gather(got), _BANDED["ref"], got.collisions,
                 _BANDED["count"], exact=False)


# The census's other mesh routes: super-cell tiles (owned by blocks of
# super-rows) and column bands (owned by blocks of columns); checkpoints
# record the ownership in ``band_plan`` (``ShardedEngine.ownership_plan``).
ROUTES = {"supercell": ((5893, 0.5, 16, 200), None),
          "banded": ((-10, 3.0, 16, 600), ((0, 8, 96), (8, 8, 64)))}
_ROUTE_REF = {}


def _route(kind, d=4, impl=None):
    args, plan = ROUTES[kind]
    eng = ShardedEngine(SimConfig(*args, n_shards=d), impl=impl or kind,
                        device="cpu")
    if plan is not None and (impl or kind) == "banded":
        eng._band_plan = plan
    return eng


def _route_ref(kind):
    """The uninterrupted 16-step run of a route: (gathered, count)."""
    if kind not in _ROUTE_REF:
        eng = _route(kind)
        out = eng.run(eng.init_state(), 16)
        _ROUTE_REF[kind] = (eng.gather(out), int(out.collisions))
    return _ROUTE_REF[kind]


def _route_mid(kind, path):
    """8 steps of the route's mesh, saved with its ownership."""
    eng = _route(kind)
    mid = eng.run(eng.init_state(), 8)
    checkpointing.save_sharded_state(path, mid, n_shards=4,
                                     band_plan=eng.ownership_plan())
    return eng, mid


@pytest.mark.parametrize("kind", list(ROUTES))
def test_route_checkpoint_resumes_as_saved(kind, tmp_path):
    """A super-cell or column-band mesh checkpoint restored onto an engine
    of the same route: the slabs placed as saved, bit for bit, and the
    resumed run ends on the uninterrupted run's count and dead set."""
    path = str(tmp_path / "mid.npz")
    eng, mid = _route_mid(kind, path)
    assert eng.ownership_plan() == {
        "supercell": ((-2, eng._sc_factor, -2),),
        "banded": ((-1, -1, -1),)}[kind]
    restored = checkpointing.restore_sharded(path, eng)
    for f in ShardedState._fields:
        assert torch.equal(getattr(mid, f), getattr(restored, f)), f
    out = eng.run(restored, 8)
    assert eng.impl == kind and int(out.overflow) == 0
    ref, count = _route_ref(kind)
    _assert_same(eng.gather(out), ref, out.collisions, count, exact=False)


@pytest.mark.parametrize("dst", ["rows", "width"])
@pytest.mark.parametrize("kind", list(ROUTES))
def test_route_checkpoint_repacks(kind, dst, tmp_path):
    """The same checkpoint onto a row-block engine (resident tiles, the
    ownership differs) or onto the same route at D = 2 (the width differs)
    is re-packed, and the resumed run ends on the uninterrupted run's count
    and dead set."""
    path = str(tmp_path / "mid.npz")
    src, mid = _route_mid(kind, path)
    dst_eng = (_route(kind, impl="resident") if dst == "rows"
               else _route(kind, d=2))
    dst_eng.capacity = src.capacity
    packs = []
    pack = dst_eng.pack_particles
    dst_eng.pack_particles = lambda *a, **kw: packs.append(1) or pack(*a,
                                                                      **kw)
    restored = checkpointing.restore_sharded(path, dst_eng)
    assert packs
    want = pack(src.gather(mid), collisions=mid.collisions,
                panics=mid.panics)
    assert all(torch.equal(getattr(restored, f), getattr(want, f))
               for f in ShardedState._fields)
    out = dst_eng.run(restored, 8)
    assert int(out.overflow) == 0
    assert dst_eng.impl == ("resident" if dst == "rows" else kind)
    ref, count = _route_ref(kind)
    _assert_same(dst_eng.gather(out), ref, out.collisions, count,
                 exact=False)


def _jax_route(kind):
    args, plan = ROUTES[kind]
    jeng = JShardedEngine(JSimConfig(*args, precision=JPrecision.FAST,
                                     n_shards=4),
                          impl="banded-cols" if kind == "banded" else kind)
    if plan is not None:
        jeng._band_plan = plan
    return jeng


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("kind", list(ROUTES))
def test_route_checkpoint_crosses_packages(kind, direction, tmp_path):
    """A super-cell or column-band checkpoint written by one package
    resumes in the other's engine of the same route, placed as saved (the
    ownership sentinels agree), and the two packages' resumes end on the
    same count and dead set."""
    path = str(tmp_path / "mid.npz")
    eng, jeng = _route(kind), _jax_route(kind)
    if direction == "port_to_jax":
        mid = eng.run(eng.init_state(), 8)
        checkpointing.save_sharded_state(path, mid, n_shards=4,
                                         band_plan=eng.ownership_plan())
        jeng.capacity = eng.capacity
        jmid = jckpt.restore_sharded(path, jeng)
        np.testing.assert_array_equal(np.asarray(jmid.pid), mid.pid.numpy())
    else:
        jmid = jeng.run(jeng.init_state(), 8)
        jckpt.save_sharded_state(path, jmid, n_shards=4,
                                 band_plan=jeng.ownership_plan())
        eng.init_state()
        eng.capacity = jeng.capacity
        mid = checkpointing.restore_sharded(path, eng)
        np.testing.assert_array_equal(mid.pid.numpy(), np.asarray(jmid.pid))
    got, ref = eng.run(mid, 8), jeng.run(jmid, 8)
    assert eng.impl == kind and jeng.impl == kind
    _assert_same(eng.gather(got), jeng.gather(ref), got.collisions,
                 np.asarray(ref.collisions), exact=False)
