"""The advance phase's plain versions (``ops/cuda/advance``) against the JAX
package, and the engines rewired onto them against their earlier bits.

* ``cell_sums_rows_ref`` against ``jnp.sum`` of the JAX engine's
  ``mono_tables``: within (K·2⁻²⁴)·Σ|terms| a row (two f32 sums of K terms
  in other orders), the limbo count exactly;
* ``monopole_integrate_ref`` against JAX's ``stencil_tables`` ->
  ``monopole_tile_forces`` -> ``integrate`` -> ``cell_of`` from the same
  sums: positions and velocities within rtol 1e-6 (torch's and XLA's rsqrt
  may differ by an ulp), the destination rows and moving flags exactly;
* ``deliver`` (the wrapper, on the CPU its plain version) against JAX's
  ``rebin`` on ``adversarial.deliver_cases``: each row's pid multiset and
  the undelivered count, as ``tests/test_torch_ops.py`` holds ``rebin``;
  in place (the passed tensors hold the result; with movers undelivered
  not a bit changes), and a cycle of three full rows swapping movers into
  each other's vacated slots;
* ``monopole_integrate`` in place: the input tensors returned, empty and
  dead slots untouched, the wrap's edges (``adversarial.wrap_case``) as
  ``np.fmod`` gives them;
* the resident and banded engines on the CPU: the bits of the run the
  plain functions gave before the advance phase took the wrappers
  (``assert_array_equal``), and ``Engine.run`` twice on one state (every
  tile engine and the mesh resident) the same result, the state untouched.

The kernels themselves run only on the card (``chip_smoke.py`` phases
ar-at hold them to these plain versions there); the last two tests cover
the chip check's helpers that the CPU can run.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesimulation_tpu.config import DELTAT as JDELTAT
from particlesimulation_tpu.ops import dense_xla as jdense
from particlesimulation_tpu.ops import integrate as jintegrate
from particlesimulation_tpu.ops import resident as jres
from particlesimulation_tpu.ops import stencil as jstencil
from particlesimulation_tpu_torch.config import DELTAT, EPSILON, SimConfig
from particlesimulation_tpu_torch.engine import Engine, make_resident_run
from particlesimulation_tpu_torch.ops import dense, integrate, stencil
from particlesimulation_tpu_torch.ops import resident as res
from particlesimulation_tpu_torch.ops.banded import make_banded_run
from particlesimulation_tpu_torch.ops.cuda import adversarial, advance
from particlesimulation_tpu_torch.ops.cuda import cell_pairs

torch.set_num_threads(2)

FIELDS = ("x", "y", "vx", "vy", "m", "occ", "pid")


def _tiles(fields):
    return res.TileState(
        **{k: torch.from_numpy(fields[k].copy()) for k in FIELDS},
        collisions=torch.zeros((), dtype=torch.int64),
        panics=torch.zeros((), dtype=torch.int32),
        overflow=torch.zeros((), dtype=torch.int32))


def _clone(ts):
    """The tiles in new tensors (the advance wrappers write in place)."""
    return ts._replace(**{k: getattr(ts, k).clone() for k in FIELDS})


def _jtiles(fields):
    return jres.TileState(**{k: jnp.asarray(fields[k]) for k in FIELDS},
                          collisions=jnp.int64(0), panics=jnp.int32(0),
                          overflow=jnp.int32(0))


def _rows(ncells, kcap):
    return torch.arange(ncells + 1) * kcap


def _jax_sums(fields, side, nc):
    jts = _jtiles(fields)
    binned, limbo = jres.binned_mask(jts, side, nc)
    mf = jnp.where(binned, jts.m, 0.0)
    return ([np.asarray(jnp.sum(t, axis=1)) for t in (mf, mf * jts.x,
                                                       mf * jts.y)],
            int(limbo), [np.asarray(t) for t in (mf, mf * jts.x, mf * jts.y)])


@pytest.mark.parametrize("kcap", [32, 160, 1024])
def test_cell_sums_ref_matches_jax(kcap):
    fields, _, _, side, nc = adversarial.advance_case(kcap, seed=kcap)
    ts = _tiles(fields)
    sums, limbo = advance.cell_sums_rows_ref(
        ts.x, ts.y, ts.m, ts.occ, _rows(nc * nc, kcap), side, nc)
    ref, jlimbo, terms = _jax_sums(fields, side, nc)
    assert limbo.dtype == torch.int32 and int(limbo) == jlimbo > 0
    for got, want, t in zip(sums, ref, terms):
        bound = kcap * 2.0 ** -24 * np.abs(t).sum(axis=1)
        assert (np.abs(got.numpy() - want) <= bound).all()


def test_cell_sums_ref_on_rows_of_many_widths():
    """Rows of 13 widths (a banded pool) in runs of equal widths: each row
    summed as a row of its own run, within the bound of float64 sums."""
    rng = np.random.default_rng(5)
    nc, side = 13, 13.0
    widths = np.repeat(rng.integers(1, 80, 13), nc)
    start = np.concatenate([[0], np.cumsum(widths)])
    n = int(start[-1])
    row = np.repeat(np.arange(nc * nc), widths)
    occ = rng.random(n) < 0.6
    x = (row % nc + rng.random(n)).astype(np.float32)
    y = (row // nc + rng.random(n)).astype(np.float32)
    x[rng.random(n) < 0.05] += side
    m = np.where(occ, rng.uniform(0.5, 1.0, n), 0.0).astype(np.float32)
    sums, limbo = advance.cell_sums_rows_ref(
        *map(torch.from_numpy, (x, y, m, occ)), torch.from_numpy(start), side,
        nc)
    binned = occ & (x < side)
    assert int(limbo) == int((occ & ~binned).sum())
    mf = np.where(binned, m, 0.0).astype(np.float32)
    for got, t in zip(sums.numpy(), (mf, mf * x, mf * y)):
        ref = np.add.reduceat(t.astype(np.float64), start[:-1])
        bound = widths * 2.0 ** -24 * np.add.reduceat(np.abs(t), start[:-1])
        assert (np.abs(got - ref) <= bound + 1e-30).all()


def _jax_advance(fields, fxd, fyd, sums, side, nc):
    """The JAX engine's composition: COM, stencil tables, monopole terms,
    integrate, then each slot's cell."""
    ncells = nc * nc
    M, SX, SY = (jnp.asarray(s) for s in sums)
    safe = jnp.where(M > 0, M, jnp.float32(1.0))
    MX = jnp.where(M > 0, SX / safe, jnp.float32(0.0))
    MY = jnp.where(M > 0, SY / safe, jnp.float32(0.0))
    tables = [t[:, :ncells].T
              for t in jstencil.stencil_tables(M, MX, MY, side, nc)]
    jts = _jtiles(fields)
    binned, _ = jres.binned_mask(jts, side, nc)
    mf = jnp.where(binned, jts.m, 0.0)
    fxm, fym = jdense.monopole_tile_forces(jts.x, jts.y, mf, *tables)
    x, y, vx, vy = jintegrate.integrate(jts.x, jts.y, jts.vx, jts.vy, jts.m,
                                        jnp.asarray(fxd) + fxm,
                                        jnp.asarray(fyd) + fym, side, JDELTAT)
    cx, cy, valid = jres.cell_of(x, y, side, nc)
    dest = cy * nc + cx
    moving = jts.occ & valid & (dest != jnp.arange(ncells)[:, None])
    return [np.asarray(a) for a in (x, y, vx, vy, dest, moving)]


@pytest.mark.parametrize("kcap", [32, 160])
def test_monopole_integrate_ref_matches_jax(kcap):
    fields, fxd, fyd, side, nc = adversarial.advance_case(kcap, seed=kcap)
    ts = _tiles(fields)
    sums, _ = advance.cell_sums_rows_ref(ts.x, ts.y, ts.m, ts.occ,
                                         _rows(nc * nc, kcap), side, nc)
    got = advance.monopole_integrate_ref(
        ts.x, ts.y, ts.vx, ts.vy, ts.m, ts.occ, torch.from_numpy(fxd),
        torch.from_numpy(fyd), sums, _rows(nc * nc, kcap), side, nc, DELTAT)
    ref = _jax_advance(fields, fxd, fyd, sums.numpy(), side, nc)
    for a, b in zip(got[:4], ref[:4]):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(b).max()))
    np.testing.assert_array_equal(got[4].numpy(), ref[4])
    np.testing.assert_array_equal(got[5].numpy(), ref[5])
    assert got[4].dtype == torch.int32 and got[5].dtype == torch.bool
    # The planted cases: the d² = 0 term adds nothing (finite forces), the
    # frozen slots keep their state, the wrap lands in [0, side].
    occ = fields["occ"]
    assert np.isfinite(got[0].numpy()[occ]).all()
    frozen = occ & (fields["m"] == 0)
    assert frozen.any()
    for a, k in zip(got[:4], ("x", "y", "vx", "vy")):
        np.testing.assert_array_equal(a.numpy()[frozen], fields[k][frozen])
    moved = occ & ~frozen
    assert ((got[0].numpy()[moved] >= 0) & (got[0].numpy()[moved] <= side)
            ).all()


def _old_monopole_integrate(ts, fxd, fyd, side, nc, kcap):
    """The resident engine's advance before the wrappers, up to rebin."""
    binned, _ = res.binned_mask(ts, side, nc)
    mf = torch.where(binned, ts.m, 0.0)
    tables = stencil.tables_from_sums(
        torch.sum(mf, dim=1), torch.sum(mf * ts.x, dim=1),
        torch.sum(mf * ts.y, dim=1), side, nc)
    fxm, fym = dense.monopole_tile_forces(ts.x, ts.y, mf, *tables)
    return integrate.integrate(ts.x, ts.y, ts.vx, ts.vy, ts.m, fxd + fxm,
                               fyd + fym, side, DELTAT)


@pytest.mark.parametrize("kcap", [32, 160])
def test_plain_advance_is_the_old_composition(kcap):
    """cell_sums_rows_ref -> monopole_integrate_ref on (ncells, K) tiles
    gives the bits of the plain composition the resident engine ran."""
    fields, fxd, fyd, side, nc = adversarial.advance_case(kcap, seed=1)
    ts = _tiles(fields)
    fxd, fyd = torch.from_numpy(fxd), torch.from_numpy(fyd)
    rs = _rows(nc * nc, kcap)
    sums, _ = advance.cell_sums_rows(ts.x, ts.y, ts.m, ts.occ, rs, side, nc)
    t = _clone(ts)
    got = advance.monopole_integrate(t.x, t.y, t.vx, t.vy, t.m, t.occ,
                                     fxd, fyd, sums, rs, side, nc, DELTAT)
    ref = _old_monopole_integrate(ts, fxd, fyd, side, nc, kcap)
    for a, b in zip(got, ref):
        assert a.shape == (nc * nc, kcap)
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    cx, cy, valid = res.cell_of(*ref[:2], side, nc)
    np.testing.assert_array_equal(got[4].numpy(), (cy * nc + cx).numpy())


def _movers(ts, side, nc):
    cx, cy, valid = res.cell_of(ts.x, ts.y, side, nc)
    dest = cy * nc + cx
    row = torch.arange(nc * nc)[:, None]
    return ts.occ & valid & (dest != row), dest


def _pid_rows(occ, pid):
    return [sorted(pid[r][occ[r]].tolist()) for r in range(occ.shape[0])]


@pytest.mark.parametrize("kcap", [32, 160, 1024])
@pytest.mark.parametrize("case", ["traffic", "crowd", "full"])
def test_deliver_matches_jax_rebin(case, kcap):
    """The cases JAX's delivery rounds deliver alike. (Two full rows that
    swap particles, the ``vacated`` case, overflow there: a round lands
    arrivals only in slots free before it, where the one-pass delivery
    counts the slots free after this step's departures.)"""
    fields, side, nc = adversarial.deliver_cases(kcap, seed=kcap)[case]
    ts = _tiles(fields)
    moving, dest = _movers(ts, side, nc)
    assert int(moving.sum()) > 0
    out, left = advance.deliver(ts, moving, dest, _rows(nc * nc, kcap))
    jout, jleft = jres.rebin(_jtiles(fields), side, nc, kcap)
    assert left.dtype == torch.int32 and int(left) == int(jleft)
    # In place: the passed tensors hold the result.
    assert all(getattr(out, k) is getattr(ts, k) for k in FIELDS)
    if case == "full":
        assert int(left) == 2
        for k in FIELDS:  # all or nothing: the tiles come back unchanged
            np.testing.assert_array_equal(getattr(out, k).numpy(), fields[k])
        return
    assert int(left) == 0
    occ, pid = out.occ.numpy(), out.pid.numpy()
    assert _pid_rows(occ, pid) == _pid_rows(np.asarray(jout.occ),
                                            np.asarray(jout.pid))
    # Each particle's values moved with it; an emptied slot has m 0.
    src = {int(p): i for i, p in enumerate(fields["pid"].reshape(-1))
           if fields["occ"].reshape(-1)[i]}
    idx = np.array([src[int(p)] for p in pid[occ]])
    for k in ("x", "y", "vx", "vy", "m"):
        np.testing.assert_array_equal(getattr(out, k).numpy()[occ],
                                      fields[k].reshape(-1)[idx])
    assert (out.m.numpy()[~occ] == 0).all()
    if case == "crowd":
        assert occ[5].sum() > max(32, kcap // 2) or occ[5].all()


def test_deliver_cases_land_in_vacated_slots():
    """The vacated case: rows 0 and 1 stay full, every arrival in a slot
    its mover left in the same step."""
    fields, side, nc = adversarial.deliver_cases(64, seed=3)["vacated"]
    ts = _tiles(fields)
    moving, dest = _movers(ts, side, nc)
    out, left = advance.deliver(_clone(ts), moving, dest, _rows(nc * nc, 64))
    assert int(left) == 0
    assert out.occ[:2].all()
    left_slots = moving[:2].numpy()
    assert left_slots.sum() == 32
    # The arrivals sit exactly in the vacated slots, in source-slot order.
    for row, other in ((0, 1), (1, 0)):
        arrived = out.pid[row][torch.from_numpy(left_slots[row])]
        expect = ts.pid[other][moving[other]]
        np.testing.assert_array_equal(arrived.numpy(), expect.numpy())


@pytest.mark.parametrize("dest_dtype", [torch.int32, torch.int64])
def test_deliver_at_is_the_pool_delivery_of_those_slots(dest_dtype):
    """``at=`` gives the whole pool's delivery with no mover outside it, in
    every field and slot."""
    fields, side, nc = adversarial.deliver_cases(32, seed=9)["traffic"]
    ts = _tiles(fields)
    moving, dest = _movers(ts, side, nc)
    dest = dest.to(dest_dtype)
    rs = _rows(nc * nc, 32)
    rng = np.random.default_rng(9)
    at = torch.from_numpy(np.sort(rng.choice(moving.numel(), 400,
                                             replace=False)))
    inside = torch.zeros(moving.numel(), dtype=torch.bool)
    inside[at] = True
    pool, left = advance.deliver(_clone(ts),
                                 moving & inside.view(moving.shape), dest, rs)
    sub, left_at = advance.deliver(_clone(ts), moving.reshape(-1)[at],
                                   dest.reshape(-1)[at], rs, at=at)
    assert int(left) == int(left_at) == 0 and int(moving.reshape(-1)[at].sum())
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(sub, k).numpy(),
                                      getattr(pool, k).numpy())


def _pair_pass(pair_args, kcap, form):
    def pair_pass(ts, collide):
        fx, fy, count, ft = cell_pairs.fused_pairs(
            *pair_args(ts), kcap, EPSILON, collide=collide, force_form=form)
        return fx, fy, count, ft != cell_pairs.INF
    return pair_pass


def _same_state(a, b):
    for k in ("x", "y", "vx", "vy", "m", "alive", "pid", "collisions",
              "panics", "overflow"):
        np.testing.assert_array_equal(getattr(a, k).numpy(),
                                      getattr(b, k).numpy(), err_msg=k)


@pytest.mark.parametrize("args,steps", [((2, 100.0, 16, 12000), 4),
                                        ((-10, 3.0, 3, 100), 6)])
def test_resident_engine_keeps_its_cpu_bits(args, steps):
    cfg = SimConfig(*args)
    eng = Engine(cfg, impl="resident", device="cpu")
    state = eng.init_state()
    kcap = eng.kcap
    side, nc = cfg.side, cfg.ncside
    prologue, _, run = make_resident_run(cfg, kcap)

    def pair_args(ts):
        binned, _ = res.binned_mask(ts, side, nc)
        mf = torch.where(binned, ts.m, 0.0)
        return ts.x, ts.y, mf, (binned & (ts.m > 0)).to(torch.int32), ts.pid

    def old_advance(ts, fxd, fyd):
        _, limbo = res.binned_mask(ts, side, nc)
        x, y, vx, vy = _old_monopole_integrate(ts, fxd, fyd, side, nc, kcap)
        ts, undelivered = res.rebin(ts._replace(x=x, y=y, vx=vx, vy=vy),
                                    side, nc, kcap)
        return ts, undelivered, limbo

    _, old_run = res.make_tile_run(
        prologue, old_advance, pair_args,
        _pair_pass(pair_args, kcap, dense.pair_force_form(side)), kcap,
        side, nc)
    _same_state(run(state, steps), old_run(state, steps))


@pytest.mark.parametrize("args,plan,steps", [
    ((-7, 100.0, 12, 4000), ((0, 3, 64), (3, 3, 256), (6, 3, 256),
                             (9, 3, 64)), 4),
    ((5, 8.0, 8, 600), ((0, 2, 64), (2, 2, 64), (4, 2, 64), (6, 2, 64)), 6),
])
def test_banded_engine_keeps_its_cpu_bits(args, plan, steps):
    cfg = SimConfig(*args)
    state = Engine(cfg, impl="banded", device="cpu").init_state()
    side, nc = cfg.side, cfg.ncside
    prologue, _, run = make_banded_run(cfg, plan)
    sizes = [rw * nc * k for _, rw, k in plan]
    offs = np.cumsum([0] + sizes).tolist()
    row_start = torch.cat(
        [off + k * torch.arange(rw * nc) for (_, rw, k), off
         in zip(plan, offs)] + [torch.full((1,), offs[-1])])
    row_of = torch.cat([torch.arange(r0 * nc, (r0 + rw) * nc,
                                     dtype=torch.int32).repeat_interleave(k)
                        for r0, rw, k in plan])
    form = dense.pair_force_form(side)

    def views(a):
        return [a[..., o:o + s].view(*a.shape[:-1], rw * nc, k)
                for (_, rw, k), o, s in zip(plan, offs, sizes)]

    def pair_args(ts):
        binned, _ = res.binned_mask(ts, side, nc)
        mf = torch.mul(ts.m, binned)
        alive = (binned & (ts.m > 0)).to(torch.int32)
        return list(zip(*(views(a) for a in (ts.x, ts.y, mf, alive,
                                             ts.pid))))

    def pair_pass(ts, collide):
        outs = [cell_pairs.fused_pairs(*t, k, EPSILON, collide=collide,
                                       force_form=form)
                for t, (_, _, k) in zip(pair_args(ts), plan)]
        fx, fy, count, ft = zip(*outs)
        return (torch.cat([a.reshape(-1) for a in fx]),
                torch.cat([a.reshape(-1) for a in fy]),
                torch.sum(torch.stack(count), dtype=torch.int32),
                torch.cat([a.reshape(-1) for a in ft]) != cell_pairs.INF)

    def old_advance(ts, fxd, fyd):
        sums = torch.empty((3, ts.x.numel()), dtype=ts.x.dtype)
        binned, limbo = res.binned_mask(ts, side, nc)
        mf = torch.mul(ts.m, binned, out=sums[0])
        torch.mul(mf, ts.x, out=sums[1])
        torch.mul(mf, ts.y, out=sums[2])
        cell = torch.cat([v.sum(dim=2) for v in views(sums)], dim=1)
        fxm, fym = dense.monopole_gathered(
            ts.x, ts.y, mf, *stencil.stencil_tables(
                *stencil.com_from_sums(*cell), side, nc), row_of)
        x, y, vx, vy = integrate.integrate(ts.x, ts.y, ts.vx, ts.vy, ts.m,
                                           fxd + fxm, fyd + fym, side, DELTAT)
        ts = ts._replace(x=x, y=y, vx=vx, vy=vy)
        cx, cy, valid = res.cell_of(ts.x, ts.y, side, nc)
        dest = cy * nc + cx
        ts, undelivered = advance.deliver(
            ts, ts.occ & valid & (dest != row_of), dest, row_start)
        return ts, undelivered, limbo

    kmax = max(k for _, _, k in plan)
    _, old_run = res.make_tile_run(prologue, old_advance, pair_args,
                                   pair_pass, kmax, side, nc)
    _same_state(run(state, steps), old_run(state, steps))


def _small(kcap=32, nc=3):
    fields, fxd, fyd, side, nc = adversarial.advance_case(kcap)
    ts = _tiles(fields)
    return ts, torch.from_numpy(fxd), torch.from_numpy(fyd), side, nc


def test_wrappers_dispatch_by_device_not_by_cuda_availability(monkeypatch):
    """A CPU tensor takes the plain version, with CUDA said to be there or
    not; a tensor on another device raises; no launch is counted."""
    ts, fxd, fyd, side, nc = _small()
    rs = _rows(nc * nc, 32)
    before = dict(advance.LAUNCHES)
    for avail in (True, False):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: avail)
        sums, limbo = advance.cell_sums_rows(ts.x, ts.y, ts.m, ts.occ, rs,
                                             side, nc)
        ref = advance.cell_sums_rows_ref(ts.x, ts.y, ts.m, ts.occ, rs, side,
                                         nc)
        assert torch.equal(sums, ref[0]) and torch.equal(limbo, ref[1])
        t = _clone(ts)
        out = advance.monopole_integrate(t.x, t.y, t.vx, t.vy, t.m, t.occ,
                                         fxd, fyd, sums, rs, side, nc,
                                         DELTAT)
        moved, left = advance.deliver(_clone(t), out[5], out[4], rs)
        ref_moved, ref_left = advance.deliver_ref(_clone(t), out[5], out[4],
                                                  rs)
        assert int(left) == int(ref_left)
        for k in FIELDS:
            assert torch.equal(getattr(moved, k), getattr(ref_moved, k))
    assert advance.LAUNCHES == before
    meta = ts._replace(**{k: torch.empty(getattr(ts, k).shape,
                                         dtype=getattr(ts, k).dtype,
                                         device="meta") for k in FIELDS})
    rs_meta = torch.empty(rs.shape, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="device"):
        advance.cell_sums_rows(meta.x, meta.y, meta.m, meta.occ, rs_meta,
                               side, nc)
    with pytest.raises(ValueError, match="device"):
        advance.monopole_integrate(
            meta.x, meta.y, meta.vx, meta.vy, meta.m, meta.occ, meta.x,
            meta.y, torch.empty((3, nc * nc), device="meta"), rs_meta, side,
            nc, DELTAT)
    with pytest.raises(ValueError, match="device"):
        advance.deliver(meta, meta.occ, meta.pid, rs_meta)
    with pytest.raises(ValueError, match="device"):  # mixed devices
        advance.cell_sums_rows(ts.x, ts.y, ts.m, ts.occ, rs_meta, side, nc)


@pytest.mark.parametrize("bad", ["dtype", "size", "rows", "grid", "dest",
                                 "strided"])
def test_wrappers_reject_bad_input(bad):
    ts, fxd, fyd, side, nc = _small()
    rs = _rows(nc * nc, 32)
    if bad == "dtype":
        with pytest.raises(TypeError):
            advance.cell_sums_rows(ts.x, ts.y, ts.m.double(), ts.occ, rs,
                                   side, nc)
    elif bad == "size":
        with pytest.raises(ValueError):
            advance.monopole_integrate(ts.x, ts.y, ts.vx, ts.vy, ts.m,
                                       ts.occ, fxd[:, :16], fyd, torch.zeros(
                                           3, nc * nc), rs, side, nc, DELTAT)
    elif bad == "rows":
        with pytest.raises(ValueError):
            advance.cell_sums_rows(ts.x, ts.y, ts.m, ts.occ, rs.int(), side,
                                   nc)
    elif bad == "grid":
        with pytest.raises(ValueError, match="grid"):
            advance.monopole_integrate(ts.x, ts.y, ts.vx, ts.vy, ts.m,
                                       ts.occ, fxd, fyd, torch.zeros(
                                           3, nc * nc), rs, side, nc + 1,
                                       DELTAT)
    elif bad == "dest":
        with pytest.raises(TypeError):
            advance.deliver(ts, ts.occ, ts.x, rs)
    else:
        with pytest.raises(ValueError, match="contiguous"):
            advance.cell_sums_rows(ts.x.t(), ts.y, ts.m, ts.occ, rs, side,
                                   nc)


def test_segments_group_runs_of_equal_width():
    rs = torch.tensor([0, 4, 8, 12, 14, 16, 19])
    assert advance._segments(rs) == [(0, 3, 4), (12, 2, 2), (16, 1, 3)]
    np.testing.assert_array_equal(advance._row_of(rs).numpy(),
                                  np.repeat(np.arange(6), [4, 4, 4, 2, 2, 3]))
    assert advance.cell_width(5000.0, 100) == np.float32(50.0)


def test_chip_check_catches_the_engines_advance():
    """The chip check counts the advance phase's launches on the phase the
    engine hands ``make_tile_run``: caught so, it is the engine's own (a
    call gives the plain composition's bits on the CPU) and the hook is
    put back."""
    import chip_smoke

    cfg = SimConfig(2, 100.0, 16, 12000)
    eng = Engine(cfg, impl="resident", device="cpu")
    state = eng.init_state()
    orig = res.make_tile_run
    ph = chip_smoke._tile_phases(make_resident_run, cfg, eng.kcap)
    assert res.make_tile_run is orig
    ts, fxd, fyd = chip_smoke._advance_inputs(ph, state)
    got, left, limbo = ph["advance"](chip_smoke._clone_tiles(ts), fxd, fyd)
    x, y, vx, vy = _old_monopole_integrate(ts, fxd, fyd, cfg.side,
                                           cfg.ncside, eng.kcap)
    ref, ref_left = res.rebin(ts._replace(x=x, y=y, vx=vx, vy=vy), cfg.side,
                              cfg.ncside, eng.kcap)
    assert int(left) == int(ref_left) == 0 and int(limbo) == 0
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      getattr(ref, k).numpy())


def test_chip_check_compares_bit_patterns():
    import chip_smoke

    zero, nan = torch.tensor([0.0]), torch.tensor([float("nan")])
    assert chip_smoke._bits_equal(zero, zero.clone())
    assert not chip_smoke._bits_equal(zero, -zero)
    assert chip_smoke._bits_equal(nan, nan.clone())
    assert not chip_smoke._bits_equal(zero, zero.double())
    assert chip_smoke._bits_equal(torch.tensor([3]), torch.tensor([3]))


def test_advance_module_does_not_import_resident():
    """``ops/resident.rebin`` calls ``advance.deliver``, so the kernels'
    module takes nothing of ``ops/resident`` (no import cycle)."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(advance))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
        elif isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
    assert not any(n.endswith(("ops.resident", "ops.resident.cell_of"))
                   for n in names), names
    assert res.cell_of is advance.cell_of
    assert res.rebin.__globals__["advance_ops"] is advance


def test_chip_check_delivery_bound_is_what_the_function_moves():
    """The delivery's bound counts occ and moving a slot, 58 bytes a mover
    and the row starts; the floor of a design that writes new tiles, kept
    beside it, 51 bytes a slot."""
    import chip_smoke

    nslots, nrows, movers = 1_600_000, 10_000, 9_992
    need = 2 * nslots + 58 * movers + 8 * nrows
    ms, by, _ = chip_smoke._deliver_bound(nslots, nrows, movers)
    assert by == "bytes"
    assert ms == pytest.approx(need / chip_smoke.PEAK_BYTES * 1e3)
    tiles = chip_smoke._new_tiles_bound(nslots, nrows, movers)[0]
    assert tiles == pytest.approx((51 * nslots + 4 * movers + 8 * nrows)
                                  / chip_smoke.PEAK_BYTES * 1e3)
    assert chip_smoke._deliver_bound(nslots, nrows, 0)[0] < ms


def test_chip_check_monopole_bound_is_what_the_function_moves():
    """The monopole pass's bound counts 50 bytes a live slot and 18 a
    frozen one (x, y, m, occ read; dest, moving written), the rows' sums
    and starts; the copy-out floor kept beside it, 50 bytes a slot."""
    import chip_smoke

    nslots, nrows, live = 1_600_000, 10_000, 999_000
    need = 50 * live + 18 * (nslots - live) + 20 * nrows
    ms, by, sfu = chip_smoke._monopole_bound(nslots, nrows, live)
    assert by == "bytes"
    assert ms == pytest.approx(need / chip_smoke.PEAK_BYTES * 1e3)
    assert sfu == pytest.approx(8 * live / chip_smoke.PEAK_SFU * 1e3)
    copy = chip_smoke._monopole_copy_bound(nslots, nrows)[0]
    assert copy == pytest.approx((50 * nslots + 20 * nrows)
                                 / chip_smoke.PEAK_BYTES * 1e3)
    assert chip_smoke._monopole_bound(nslots, nrows, nslots)[0] == copy
    assert chip_smoke._monopole_bound(nslots, nrows, 0)[0] < ms


def test_chip_check_clones_the_tiles():
    """Each check and timing of the in-place wrappers takes its own copy
    of the tiles: new tensors with the same bits."""
    import chip_smoke

    ts, *_ = _small()
    t = chip_smoke._clone_tiles(ts)
    for k in FIELDS:
        a, b = getattr(ts, k), getattr(t, k)
        assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)
    assert t.collisions is ts.collisions
    sweep = chip_smoke._measures()
    assert sweep.fresh_inputs(None, 2) == [None, None]
    made = sweep.fresh_inputs(lambda: chip_smoke._clone_tiles(ts), 3)
    assert len({m.x.data_ptr() for m in made}) == 3


def test_chip_check_times_every_checkout_by_its_own_measure():
    """The device-time measure is ``launch_sweep.device_ms`` of the
    checkout that holds chip_smoke.py, loaded from its file whatever
    package comes first on the path, and it calls ``fn`` with each fresh
    input (or with none)."""
    import chip_smoke
    from particlesimulation_tpu_torch.ops.cuda import launch_sweep

    sweep = chip_smoke._measures()
    assert sweep is chip_smoke._measures()
    assert os.path.samefile(sweep.__file__, os.path.join(
        chip_smoke.ROOT, "particlesimulation_tpu_torch", "ops", "cuda",
        "launch_sweep.py"))
    assert sweep.device_ms.__code__.co_code == (
        launch_sweep.device_ms.__code__.co_code)
    assert sweep.call_with(lambda: 1, None) == 1
    assert sweep.call_with(lambda a: a + 1, 2) == 3


@pytest.mark.parametrize("kcap", [32, 160])
def test_deliver_cycle_lands_in_vacated_slots(kcap):
    """Three full rows hand movers on in a cycle (0 to 1, 1 to 2, 2 to 0):
    each arrival lands in a slot vacated in the same step, in source-slot
    order, with its own fields; the rows stay full and nothing else
    changes. The in-place delivery must read every mover before it writes
    any slot (the kernel stages them)."""
    fields, side, nc = adversarial.deliver_cases(kcap, seed=kcap)["cycle"]
    ts = _tiles(fields)
    moving, dest = _movers(ts, side, nc)
    out, left = advance.deliver(ts, moving, dest, _rows(nc * nc, kcap))
    assert int(left) == 0 and out.occ[:3].all()
    mv = moving.numpy()
    for row in range(3):
        src = (row + 2) % 3           # the row whose movers arrive here
        assert mv[row].sum() == mv[src].sum() == max(1, kcap // 4)
        landed = np.flatnonzero(mv[row])
        for k in ("x", "y", "vx", "vy", "m", "pid"):
            np.testing.assert_array_equal(
                getattr(out, k).numpy()[row][landed],
                fields[k][src][np.flatnonzero(mv[src])])
    stay = ~mv
    stay[3:] = True
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(out, k).numpy()[stay],
                                      fields[k][stay])


@pytest.mark.parametrize("kcap", [32, 160])
@pytest.mark.parametrize("limited", [False, True])
def test_deliver_undelivered_leaves_every_byte(kcap, limited):
    """With movers undelivered (a full row), not a bit of the passed tiles
    changes, through the pool-wide delivery and through ``at=``."""
    fields, side, nc = adversarial.deliver_cases(kcap, seed=kcap)["full"]
    ts = _tiles(fields)
    moving, dest = _movers(ts, side, nc)
    rs = _rows(nc * nc, kcap)
    if limited:
        at = torch.nonzero(moving.reshape(-1))[:, 0]
        out, left = advance.deliver(ts, moving.reshape(-1)[at],
                                    dest.reshape(-1)[at], rs, at=at)
    else:
        out, left = advance.deliver(ts, moving, dest, rs)
    assert int(left) == 2
    for k in FIELDS:
        assert getattr(out, k) is getattr(ts, k)
        a = getattr(out, k).numpy()
        assert a.tobytes() == fields[k].tobytes(), k


@pytest.mark.parametrize("kcap", [32, 160])
def test_monopole_integrate_in_place(kcap):
    """The outputs x, y, vx, vy are the input tensors; empty and dead slots
    (m = 0, frozen) keep every bit; dest and moving are new tensors."""
    fields, fxd, fyd, side, nc = adversarial.advance_case(kcap, seed=kcap)
    ts = _tiles(fields)
    rs = _rows(nc * nc, kcap)
    sums, _ = advance.cell_sums_rows(ts.x, ts.y, ts.m, ts.occ, rs, side, nc)
    ref = _old_monopole_integrate(_clone(ts), torch.from_numpy(fxd),
                                  torch.from_numpy(fyd), side, nc, kcap)
    got = advance.monopole_integrate(ts.x, ts.y, ts.vx, ts.vy, ts.m, ts.occ,
                                     torch.from_numpy(fxd),
                                     torch.from_numpy(fyd), sums, rs, side,
                                     nc, DELTAT)
    assert all(a is b for a, b in zip(got[:4], (ts.x, ts.y, ts.vx, ts.vy)))
    frozen = fields["m"] == 0
    assert (frozen & fields["occ"]).any() and (frozen & ~fields["occ"]).any()
    for a, b, k in zip(got[:4], ref, ("x", "y", "vx", "vy")):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert a.numpy()[frozen].tobytes() == fields[k][frozen].tobytes()
    assert got[4].data_ptr() != ts.pid.data_ptr()
    assert got[4].dtype == torch.int32 and got[5].dtype == torch.bool


@pytest.mark.parametrize("kcap", [16, 32])
def test_monopole_wrap_edges(kcap):
    """``adversarial.wrap_case``: particles at rest under no force, so the
    wrap alone moves them: x and y are np.fmod(x + side, side) in float32
    bit for bit (fmod of 2·side is 0; a sum x + side is never -0.0), the
    dead slot keeps -0.0, and the old composition gives the same bits."""
    fields, fxd, fyd, side, nc = adversarial.wrap_case(kcap)
    ts = _tiles(fields)
    rs = _rows(nc * nc, kcap)
    sums, _ = advance.cell_sums_rows(ts.x, ts.y, ts.m, ts.occ, rs, side, nc)
    ref = _old_monopole_integrate(_clone(ts), torch.from_numpy(fxd),
                                  torch.from_numpy(fyd), side, nc, kcap)
    got = advance.monopole_integrate(ts.x, ts.y, ts.vx, ts.vy, ts.m, ts.occ,
                                     torch.from_numpy(fxd),
                                     torch.from_numpy(fyd), sums, rs, side,
                                     nc, DELTAT)
    for a, b in zip(got[:4], ref):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    live = fields["occ"] & (fields["m"] != 0)
    s32 = np.float32(side)
    for a, k in ((got[0], "x"), (got[1], "y")):
        want = np.fmod(fields[k][live] + np.float32(0.0) + s32, s32)
        assert a.numpy()[live].tobytes() == want.tobytes()
    assert (got[0].numpy()[live] == 0).sum() >= 2   # a = side, a = 2 side
    dead = fields["occ"] & (fields["m"] == 0)
    assert dead.sum() == (kcap >= 27) and np.signbit(
        got[0].numpy()[dead]).all()


def _twice_engine(kind):
    if kind == "resident":   # tiles of K 32 overflow: the ladder replays
        return Engine(SimConfig(2, 100.0, 16, 12000), impl="resident",
                      kcap=32, device="cpu")
    if kind == "banded":
        eng = Engine(SimConfig(-7, 100.0, 12, 4000), impl="banded",
                     device="cpu")
        eng._band_plan = ((0, 3, 64), (3, 3, 256), (6, 3, 256), (9, 3, 64))
        return eng
    if kind == "supercell":
        return Engine(SimConfig(1, 3.0, 24, 300), impl="supercell",
                      device="cpu")
    from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine

    return ShardedEngine(SimConfig(2, 100.0, 16, 12000, n_shards=2),
                         impl="resident", device="cpu")


@pytest.mark.parametrize("kind", ["resident", "banded", "supercell", "mesh"])
def test_engine_run_twice_same_state(kind):
    """The advance wrappers write the tiles in place: ``Engine.run`` on one
    state twice gives the same result bit for bit and leaves the input
    state as it was (each prologue lays the tiles out in new tensors, the
    ladder's replays included)."""
    eng = _twice_engine(kind)
    state = eng.init_state()
    before = [getattr(state, k).clone() for k in state._fields]
    runs = [eng.run(state, 3) for _ in range(2)]
    assert eng.impl == ("resident" if kind == "mesh" else kind)
    for k, b in zip(state._fields, before):
        assert getattr(state, k).numpy().tobytes() == b.numpy().tobytes(), k
    for k in runs[0]._fields:
        a, b = (getattr(r, k).numpy() for r in runs)
        assert a.tobytes() == b.tobytes(), k

