"""The migration pack (``ops/cuda/migrate``) and the mesh and super-cell
engines' monopole + integrate (``ops/cuda/advance``'s
``tile_monopole_integrate`` and ``gathered_monopole_integrate``) on the
CPU, where each wrapper runs its plain version:

* the wrappers against today's plain code, bit for bit, on the
  adversarial inputs of ``ops/cuda/adversarial`` (``pack_cases``,
  ``compact_cases``, ``mesh_monopole_case``), in place where the kernels
  write in place, and a NumPy model of the kernels' chunked scans (a count
  a chunk, a block's offset the counts before it, ranks in slot order
  within it) against them;
* the migration against JAX's mesh: one step builder of each package at
  capacities that force a migration overflow, at D = 2 and on the (2, 2)
  mesh, the same overflow counts and final slabs bit for bit;
* every engine that now calls the kernels run twice on one state: the same
  bits, the state untouched (the packs and the monopole pass write in
  place, so every prologue and migration must hand them fresh tensors).

The kernels themselves run only on the card (``chip_smoke.py`` phase bf
holds them to these plain versions there); the whole meshes against JAX
are ``tests/test_torch_sharded*.py``'s and ``tests/test_torch_supercell.py``'s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesimulation_tpu.config import Precision as JPrecision
from particlesimulation_tpu.config import SimConfig as JSimConfig
from particlesimulation_tpu.parallel.sharded import (
    ShardedEngine as JShardedEngine)
from particlesimulation_tpu.parallel.sharded2d import (
    Sharded2DEngine as JSharded2DEngine)
from particlesimulation_tpu_torch.config import DELTAT, Precision, SimConfig
from particlesimulation_tpu_torch.engine import Engine
from particlesimulation_tpu_torch.ops import dense, integrate
from particlesimulation_tpu_torch.ops.cuda import adversarial, advance
from particlesimulation_tpu_torch.ops.cuda import migrate
from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine
from particlesimulation_tpu_torch.parallel.sharded2d import Sharded2DEngine

torch.set_num_threads(2)

CHUNK = adversarial.MIGRATE_CHUNK
_JAX = {}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _bits(t):
    """A tensor's bytes (floats by their bit patterns, NaNs too)."""
    return t.detach().contiguous().numpy().tobytes()


def _same(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert _bits(a) == _bits(b), what


# --- the migration pack ----------------------------------------------------

def _pack_model(dst, valid, src, take):
    """NumPy model of ``csrc/migrate.cu``'s pack, in place on copies: each
    chunk's counts, a block's offset the counts of the chunks before it,
    the arrivals' list by rank, then each chunk's free slots from its
    offset on while below the row's arrivals (a block past them returns)."""
    dst = {k: v.copy() for k, v in dst.items()}
    valid = valid.copy()
    L, C = valid.shape
    B = take.shape[1]
    overflow = np.zeros(L, np.int32)
    for l in range(L):
        free_c = [int(np.sum(~valid[l, c:c + CHUNK]))
                  for c in range(0, C, CHUNK)]
        take_c = [int(np.sum(take[l, c:c + CHUNK]))
                  for c in range(0, B, CHUNK)]
        n_arr = sum(take_c)
        overflow[l] = max(n_arr - sum(free_c), 0)
        arr_at = np.zeros(B, np.int64)
        for b, c in enumerate(range(0, B, CHUNK)):
            q = sum(take_c[:b])
            for j in range(c, min(c + CHUNK, B)):
                if take[l, j]:
                    arr_at[q] = j
                    q += 1
        for b, c in enumerate(range(0, C, CHUNK)):
            q = sum(free_c[:b])
            if q >= n_arr:
                continue
            for s in range(c, min(c + CHUNK, C)):
                if q >= n_arr:
                    break
                if valid[l, s]:
                    continue
                for k in dst:
                    dst[k][l, s] = src[k][l, arr_at[q]]
                valid[l, s] = True
                q += 1
    return dst, valid, overflow


def _compact_model(slab, emig, bcap, extra):
    """NumPy model of ``csrc/migrate.cu``'s compact: the valid flags of the
    first min(bcap, C) entries, set below the row's emigrants; an
    emigrant's entry its rank among them, where below min(bcap, C); a
    chunk with no emigrant, or whose first rank is past the buffer, writes
    no field. The fields of the entries past the emigrants stay NaN (the
    kernel leaves them as the new tensors held them)."""
    L, C = emig.shape
    B = min(bcap, C)
    fields = {**slab, **extra}
    buf = {k: np.full((L, B), np.nan if v.dtype.kind == "f" else -1, v.dtype)
           for k, v in fields.items()}
    buf["valid"] = np.zeros((L, B), bool)
    overflow = np.zeros(L, np.int32)
    for l in range(L):
        counts = [int(np.sum(emig[l, c:c + CHUNK]))
                  for c in range(0, C, CHUNK)]
        n_emig = sum(counts)
        overflow[l] = max(n_emig - bcap, 0)
        buf["valid"][l] = np.arange(B) < n_emig
        for b, c in enumerate(range(0, C, CHUNK)):
            rank = sum(counts[:b])
            if counts[b] == 0 or rank >= B:
                continue
            for s in range(c, min(c + CHUNK, C)):
                if emig[l, s] and rank < B:
                    for k in fields:
                        buf[k][l, rank] = fields[k][l, s]
                rank += bool(emig[l, s])
    return buf, overflow


@pytest.mark.parametrize("case", adversarial.MIGRATE_CASES)
def test_pack_is_the_plain_pack(case):
    """``pack`` on CPU tensors: in place (the same tensors back), each field
    and valid the plain version's bits, the overflow its count; the NumPy
    model of the kernels' chunks gives the same."""
    dst, valid, src, take = adversarial.pack_cases()[case]
    tdst = {k: _t(v) for k, v in dst.items()}
    tvalid, tsrc, ttake = _t(valid), {k: _t(v) for k, v in src.items()}, \
        _t(take)
    ref, ref_valid, ref_ovf = migrate.pack_ref(
        {k: v.clone() for k, v in tdst.items()}, tvalid.clone(), tsrc, ttake)
    before = dict(migrate.LAUNCHES)
    ids = {k: id(v) for k, v in tdst.items()}
    got, got_valid, ovf = migrate.pack(tdst, tvalid, tsrc, ttake)
    assert migrate.LAUNCHES == before
    assert got is tdst and got_valid is tvalid
    assert {k: id(v) for k, v in got.items()} == ids
    for k in dst:
        _same(got[k], ref[k], k)
    _same(got_valid, ref_valid, "valid")
    _same(ovf, ref_ovf, "overflow")
    want = np.maximum(take.sum(1) - (~valid).sum(1), 0)
    np.testing.assert_array_equal(ovf.numpy(), want)
    mdst, mvalid, movf = _pack_model(dst, valid, src, take)
    for k in dst:
        assert mdst[k].tobytes() == _bits(got[k]), k
    np.testing.assert_array_equal(mvalid, got_valid.numpy())
    np.testing.assert_array_equal(movf, ovf.numpy())
    if case == "spread, last slot free":
        assert bool(got_valid[1, -1]) and bool(got_valid[2, -1])
    # Only the landed slots changed.
    landed = got_valid.numpy() & ~valid
    for k in dst:
        np.testing.assert_array_equal(got[k].numpy()[~landed],
                                      dst[k][~landed], err_msg=k)


@pytest.mark.parametrize("case", adversarial.COMPACT_CASES)
def test_compact_is_the_plain_buffer(case):
    """``compact`` on CPU tensors: the plain version's buffer, every entry
    (the ones past the emigrants too) and the overflow; the NumPy model of
    the kernels' chunks gives the same valid flags, valid entries and
    overflow."""
    slab, emig, bcap, extra = adversarial.compact_cases()[case]
    args = ({k: _t(v) for k, v in slab.items()}, _t(emig), bcap)
    textra = {k: _t(v) for k, v in extra.items()}
    buf, ovf = migrate.compact(*args, **textra)
    ref, ref_ovf = migrate.compact_ref(*args, **textra)
    assert list(buf) == list(ref) == [*slab, *extra, "valid"]
    for k in ref:
        _same(buf[k], ref[k], k)
    _same(ovf, ref_ovf, "overflow")
    mbuf, movf = _compact_model(slab, emig, bcap, extra)
    ok = buf["valid"].numpy()
    np.testing.assert_array_equal(mbuf["valid"], ok)
    for k in mbuf:
        assert mbuf[k][ok].tobytes() == buf[k].numpy()[ok].tobytes(), k
    np.testing.assert_array_equal(movf, ovf.numpy())
    assert buf["x"].shape[1] == min(bcap, emig.shape[1])


def test_migrate_wrappers_check_their_inputs():
    """A tensor on another device than the CPU or a card raises; so do
    mismatched rows, dtypes and too many fields."""
    dst, valid, src, take = adversarial.pack_cases()["no arrival"]
    tdst = {k: _t(v) for k, v in dst.items()}
    tsrc = {k: _t(v) for k, v in src.items()}
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in tdst.items()}
    mvalid = torch.empty(valid.shape, dtype=torch.bool, device="meta")
    msrc = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in tsrc.items()}
    mtake = torch.empty(take.shape, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no migration pack for device"):
        migrate.pack(meta, mvalid, msrc, mtake)
    with pytest.raises(ValueError, match="no emigrant buffer for device"):
        migrate.compact(meta, mvalid, 4)
    with pytest.raises(ValueError):
        migrate.pack(tdst, _t(valid)[:1], tsrc, _t(take))
    with pytest.raises(ValueError):
        migrate.pack(tdst, _t(valid), tsrc, _t(take)[:, :-1])
    with pytest.raises(TypeError):
        migrate.pack(tdst, _t(valid).int(), tsrc, _t(take))
    with pytest.raises(KeyError):
        migrate.pack({**tdst, "other": tdst["x"]}, _t(valid), tsrc,
                     _t(take))
    with pytest.raises(ValueError):
        migrate.compact(tdst, _t(valid), 0)
    with pytest.raises(ValueError, match="at most"):
        migrate._fields([("f", tdst["x"], tdst["x"])] * 13)
    with pytest.raises(TypeError):
        migrate._fields([("f", tdst["x"], tdst["x"].float())])


# --- the migration against JAX's mesh --------------------------------------

# (seed, side, nc, n, steps), the mesh shape, and what overflows: the
# slabs (each exactly as full as the fullest shard at the start, arrivals
# past the free slots) or the emigrant buffers (one entry).
OVERFLOW_CASES = [((3, 8.0, 8, 400, 6), (2, 1), "slab"),
                  ((3, 8.0, 8, 400, 6), (2, 1), "buffer"),
                  ((3, 8.0, 8, 400, 6), (2, 2), "slab"),
                  ((3, 8.0, 8, 400, 6), (2, 2), "buffer")]


def _overflow_caps(args, shape, what):
    """(shard_capacity, migration_capacity) of an overflow case."""
    seed, side, nc, n, _ = args
    d = shape[0] * shape[1]
    cfg = SimConfig(seed, side, nc, n, precision=Precision.PARITY,
                    n_shards=d, mesh_shape=() if shape[1] == 1 else shape)
    eng = (ShardedEngine(cfg, device="cpu") if shape[1] == 1
           else Sharded2DEngine(cfg, device="cpu"))
    tight = int(eng.init_state().valid.view(d, -1).sum(1).max())
    return (tight, n) if what == "slab" else (n, 1)


def _jax_overflow(args, shape, caps):
    """JAX's mesh step builder at the given capacities (no ladder): the
    final state's overflow, collisions and gathered particles, once a
    case."""
    key = (args, shape, caps)
    if key not in _JAX:
        seed, side, nc, n, steps = args
        d = shape[0] * shape[1]
        cfg = JSimConfig(seed, side, nc, n, precision=JPrecision.PARITY,
                         n_shards=d, shard_capacity=caps[0],
                         migration_capacity=caps[1])
        eng = (JShardedEngine(cfg) if shape[1] == 1
               else JSharded2DEngine(cfg, shape))
        state = eng.init_state()
        eng._build()
        out = eng._run(state._replace(overflow=jnp.zeros_like(state.overflow)),
                       jnp.int32(steps))
        _JAX[key] = (int(np.asarray(out.overflow)),
                     int(np.asarray(out.collisions)), eng.gather(out))
    return _JAX[key]


@pytest.mark.parametrize("case", OVERFLOW_CASES,
                         ids=lambda c: f"{'x'.join(map(str, c[1]))}-{c[2]}")
def test_migration_overflow_matches_jax(case):
    """The port's sweep step at capacities too small for the run's
    migration (the plain pack and emigrant buffer on the CPU) against
    JAX's: the same overflow count (arrivals past a slab's free slots, or
    emigrants past the buffer, every step's summed), collision count and
    particles, bit for bit, with the particles the overflow lost gone from
    both."""
    args, shape, what = case
    seed, side, nc, n, steps = args
    caps = _overflow_caps(args, shape, what)
    d = shape[0] * shape[1]
    kw = dict(precision=Precision.PARITY, n_shards=d, shard_capacity=caps[0],
              migration_capacity=caps[1])
    if shape[1] == 1:
        eng = ShardedEngine(SimConfig(seed, side, nc, n, **kw), device="cpu")
    else:
        eng = Sharded2DEngine(SimConfig(seed, side, nc, n, mesh_shape=shape,
                                        **kw), device="cpu")
    state = eng.init_state()
    assert eng.capacity == caps[0]
    eng._build()
    out = eng._run(state, steps)
    ovf, count, ref = _jax_overflow(args, shape, caps)
    assert int(out.overflow) == ovf > 0
    assert int(out.collisions) == count
    got = eng.gather(out)
    assert len(got["pid"]) < n if what == "slab" else True
    for f in ("pid", "x", "y", "vx", "vy", "m", "alive"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


# --- the mesh and super-cell monopole + integrate ---------------------------

def _monopole_inputs(case):
    fields = {k: _t(case[k]) for k in ("x", "y", "vx", "vy", "m", "mf",
                                       "fxd", "fyd")}
    return fields


def _old_chain(f, form, tables, idx, side):
    """Today's plain code of the engines: the monopole (``dense``'s
    ``monopole_tile_forces`` on row tables, or ``monopole_gathered`` by
    each slot's index), then ``integrate.integrate`` of ``fxd + fxm``."""
    if form == "tile":
        fxm, fym = dense.monopole_tile_forces(f["x"], f["y"], f["mf"],
                                              *tables)
    else:
        fxm, fym = dense.monopole_gathered(f["x"], f["y"], f["mf"], *tables,
                                           idx)
    return integrate.integrate(f["x"], f["y"], f["vx"], f["vy"], f["m"],
                               f["fxd"] + fxm, f["fyd"] + fym, side, DELTAT)


MONOPOLE_MODES = ("tile", "slots int64", "slots int32", "slots binned",
                  "rows", "pool rows")


@pytest.mark.parametrize("mode", MONOPOLE_MODES)
def test_mesh_monopole_is_the_plain_chain(mode):
    """Both wrappers on CPU tensors, in place (the same tensors back, the
    frozen slots' bits unchanged), give the bits of the engines' plain
    monopole + integrate on ``adversarial.mesh_monopole_case``: the row
    tables' form on the resident meshes' tiles; the gathered form by each
    row's index (uniform rows, a band pool's rows of 1 to 3K slots, given
    as their runs) with the binned mask; and the gathered plain version by
    each slot's index (int64, int32; negative or past the table: the
    sentinel; with a binned mask), the super-cell routes' plain chain."""
    case = adversarial.mesh_monopole_case()
    side = case["side"]
    f = _monopole_inputs(case)
    nrows, kcap = f["x"].shape
    sentinel = nrows
    binned = _t(case["binned"])
    if mode == "tile":
        tables = tuple(_t(t) for t in case["tile"])
        want = _old_chain(f, "tile", tables, None, side)
        call = (advance.tile_monopole_integrate,
                (tables, _t(case["row_start"]), side, DELTAT), {})
    else:
        tables = tuple(_t(t) for t in case["gathered"])
        slot = _t(case["slot_index"])
        fn = advance.gathered_monopole_integrate
        if mode.startswith("slots"):
            fn = advance.gathered_monopole_integrate_ref
            at = slot.int() if mode == "slots int32" else slot
            idx = torch.where((slot >= 0) & (slot < nrows), slot, sentinel)
            kw = {}
            if mode == "slots binned":
                at = torch.where(binned, torch.arange(nrows)[:, None], 7)
                idx = torch.where(binned, at, sentinel)
                kw = {"binned": binned}
        else:
            rs = _t(case["row_start" if mode == "rows" else "pool_row_start"])
            at = _t(case["row_index" if mode == "rows"
                         else "pool_row_index"])
            row_of = torch.repeat_interleave(torch.arange(len(at)),
                                             rs[1:] - rs[:-1]).view(
                                                 nrows, kcap)
            cell = at[row_of]
            idx = torch.where(binned & (cell >= 0) & (cell < nrows), cell,
                              sentinel)
            runs = tuple((n, w) for _, n, w in advance._segments(rs))
            kw = {"runs": runs, "binned": binned}
        want = _old_chain(f, "gathered", tables, idx, side)
        call = (fn, (tables, at, side, DELTAT), kw)
    fn, rest, kw = call
    before = {k: v.clone() for k, v in f.items()}
    got = fn(f["x"], f["y"], f["vx"], f["vy"], f["m"], f["mf"], f["fxd"],
             f["fyd"], *rest, **kw)
    assert all(a is f[k] for a, k in zip(got, ("x", "y", "vx", "vy")))
    for k, a, b in zip(("x", "y", "vx", "vy"), got, want):
        _same(a, b, k)
    frozen = before["m"] == 0
    for k in ("x", "y", "vx", "vy"):
        assert _bits(f[k][frozen]) == _bits(before[k][frozen]), k
    for k in ("m", "mf", "fxd", "fyd"):
        _same(f[k], before[k], k)


def test_the_case_tells_the_two_forms_apart():
    """On the planted slots a subnormal d² from a COM (row 7), the row
    tables' form gives NaN where its neighbour mass is 0 (0 · inv³ = 0 ·
    inf) and the gathered form drops the term: the case holds each kernel
    to its own form."""
    case = adversarial.mesh_monopole_case()
    f = _monopole_inputs(case)
    tile = _old_chain(f, "tile", tuple(_t(t) for t in case["tile"]), None,
                      case["side"])
    slot = _t(case["slot_index"])
    idx = torch.where((slot >= 0) & (slot < 25), slot, 25)
    gath = _old_chain(f, "gathered", tuple(_t(t) for t in case["gathered"]),
                      idx, case["side"])
    assert bool(torch.isnan(tile[0][7, 1])) and bool(
        torch.isfinite(gath[0][7, 1]))
    assert bool(torch.isnan(tile[0][7, 3])) and bool(
        torch.isfinite(gath[0][7, 3]))


def test_mesh_monopole_wrappers_check_their_inputs():
    case = adversarial.mesh_monopole_case()
    f = _monopole_inputs(case)
    args = [f[k] for k in ("x", "y", "vx", "vy", "m", "mf", "fxd", "fyd")]
    tile = tuple(_t(t) for t in case["tile"])
    gathered = tuple(_t(t) for t in case["gathered"])
    rs = _t(case["row_start"])
    meta = [torch.empty(a.shape, device="meta") for a in args]
    before = dict(advance.LAUNCHES)
    with pytest.raises(ValueError, match="device"):
        advance.tile_monopole_integrate(
            *meta, tuple(torch.empty(t.shape, device="meta") for t in tile),
            torch.empty(rs.shape, dtype=torch.int64, device="meta"),
            10.0, DELTAT)
    with pytest.raises(ValueError):  # the row tables of another grid
        advance.tile_monopole_integrate(*args, gathered, rs, 10.0, DELTAT)
    with pytest.raises(ValueError):  # row starts of other rows
        advance.tile_monopole_integrate(*args, tile, rs[:-1], 10.0, DELTAT)
    runs = ((rs.numel() - 1, args[0].shape[1]),)
    ri = _t(case["row_index"])
    with pytest.raises(TypeError):
        advance.gathered_monopole_integrate(
            *args, gathered, ri.float(), 10.0, DELTAT, runs)
    with pytest.raises(TypeError):  # a row index of int32
        advance.gathered_monopole_integrate(
            *args, gathered, ri.int(), 10.0, DELTAT, runs)
    with pytest.raises(ValueError):  # an index a slot: the plain version's
        advance.gathered_monopole_integrate(
            *args, gathered, _t(case["slot_index"]), 10.0, DELTAT, runs)
    with pytest.raises(ValueError):  # tables of two layouts
        advance.gathered_monopole_integrate(
            *args, (gathered[0], gathered[1].T.contiguous().T, gathered[2]),
            ri, 10.0, DELTAT, runs)
    with pytest.raises(TypeError):
        advance.gathered_monopole_integrate(
            *args[:5], args[5].double(), *args[6:], gathered, ri, 10.0,
            DELTAT, runs)
    assert advance.LAUNCHES == before


# --- the engines on the kernels, run twice -----------------------------------

def _twice_engine(kind):
    if kind == "parity mesh D=2 (buffer retry)":
        return ShardedEngine(SimConfig(3, 8.0, 8, 400,
                                       precision=Precision.PARITY,
                                       n_shards=2, migration_capacity=1),
                             device="cpu")
    if kind == "2D parity (2, 2) (slab retry)":
        probe = Sharded2DEngine(SimConfig(-10, 3.0, 16, 300,
                                          precision=Precision.PARITY,
                                          n_shards=4, mesh_shape=(2, 2)),
                                device="cpu")
        tight = int(probe.init_state().valid.view(4, -1).sum(1).max())
        return Sharded2DEngine(SimConfig(-10, 3.0, 16, 300,
                                         precision=Precision.PARITY,
                                         n_shards=4, mesh_shape=(2, 2),
                                         shard_capacity=tight),
                               device="cpu")
    if kind == "2D resident (2, 2)":
        return Sharded2DEngine(SimConfig(1, 2.0, 9, 200, n_shards=4,
                                         mesh_shape=(2, 2)),
                               impl="resident", device="cpu")
    if kind == "mesh supercell D=3":
        return ShardedEngine(SimConfig(1, 3.0, 24, 300, n_shards=3),
                             impl="supercell", device="cpu")
    if kind == "column bands D=4":
        eng = ShardedEngine(SimConfig(3, 8.0, 9, 400, n_shards=4),
                            impl="banded", device="cpu")
        eng._band_plan = ((0, 4, 96), (4, 5, 96))
        return eng
    if kind == "cyclic bands D=2":
        eng = ShardedEngine(SimConfig(-10, 3.0, 16, 600, n_shards=2),
                            impl="banded-cyclic", device="cpu")
        eng._band_plan = ((0, 8, 96), (8, 8, 64))
        return eng
    return Engine(SimConfig(1, 3.0, 24, 300), impl="supercell",
                  device="cpu")


TWICE = ("parity mesh D=2 (buffer retry)", "2D parity (2, 2) (slab retry)",
         "2D resident (2, 2)", "mesh supercell D=3", "column bands D=4",
         "cyclic bands D=2", "supercell")


@pytest.mark.parametrize("kind", TWICE)
def test_engine_on_the_kernels_run_twice(kind):
    """``run`` twice on one state gives the same bits and leaves the state
    as it was: the packs and the monopole pass write in place, into
    tensors each migration copied and each prologue laid out anew (the
    parity cases replay a retried run: a buffer of 1 entry, slabs as full
    as the fullest shard)."""
    eng = _twice_engine(kind)
    state = eng.init_state()
    before = [_bits(getattr(state, k)) for k in state._fields]
    runs = [eng.run(state, 4) for _ in range(2)]
    for k, b in zip(state._fields, before):
        assert _bits(getattr(state, k)) == b, k
    for k in runs[0]._fields:
        assert _bits(getattr(runs[0], k)) == _bits(getattr(runs[1], k)), k
    want = {"parity mesh D=2 (buffer retry)": "sweep",
            "2D parity (2, 2) (slab retry)": "sweep",
            "2D resident (2, 2)": "resident", "mesh supercell D=3":
            "supercell", "column bands D=4": "banded",
            "cyclic bands D=2": "banded", "supercell": "supercell"}[kind]
    assert eng.impl == want
    if kind.startswith("parity mesh"):
        assert eng.bcap > 1
