"""Sharded slot-resident fast engine: resident tiles with halo rows
(counterpart of the JAX package's ``parallel/sharded_resident.py``).

Each shard's state lives in ``(nrows_t * ncside, K)`` slot tiles covering
its row block plus two *particle halo rows*; one step, written against the
mesh interface of ``parallel/mesh``, does

* local COM from the tiles (row sums) and the one-row COM halo ring
  (``sharded.halo_pad``; the reference's ghost-cell Isend/Irecv,
  mpi/parsim-mpi.cpp:670-815), then the monopole terms on the tiles;
* integration, then migration: a rebin (``ops/resident.rebin`` with a
  ``dest_fn`` on the local grid) delivers every mover in one pass, an
  emigrant into the halo row on its side; the halo rows then ship to the
  ring neighbours (``mesh.ppermute``; the reference's Alltoall +
  point-to-point exchange, mpi/parsim-mpi.cpp:512-600), arrive in the
  neighbour's opposite halo row, and a second rebin delivers them to their
  cells (or on to the far halo row, if their row is further on);
* the fused collision(t) + pair-force(t+1) pass, the hand-written kernel of
  ``ops/cuda/cell_pairs``, on every shard's tiles, halo rows included.

The shards' tiles are stacked into one pool, so each pass (and the pair
kernel) runs once over all local shards: launches do not grow with D.

Shipping rounds: the JAX engine repeats them in a ``while_loop`` gated on
the ``psum`` of the halo occupants, a count the host would read every
round; the port holds no host read inside a run. It runs ``ship_rounds``
rounds (1 by default: an emigrant crosses one shard boundary in the common
case) and turns halo occupants left after the last round into the
``SHIP_OVF`` sentinel; the engine's ladder then replays the run losslessly
with D + ``SHIP_SLACK`` rounds, the JAX engine's cap.

Local tile grid (height ``rows_max + 2``):

    local row 0             = top halo    (emigrants heading to shard-1)
    local rows 1..rows_mine = owned rows  (global rows row0..row0+rows_mine-1)
    local rows rows_mine+1..rows_max = unused (uneven decomposition only: JAX
                              delivers hop by hop through them; one-pass
                              delivery leaves them empty)
    local row rows_max+1    = bottom halo (emigrants heading to shard+1)

Capacity overflow anywhere (tile occupancy, a full row at delivery, a slab
out of slots at the epilogue) raises ``overflow`` and the engine retries the
run losslessly; no particle is ever dropped (the reference PANIC-skips,
serial/parsim.cpp:276-280).

The f64 slab path (``parallel/sharded``) carries the bitwise claim; this is
the throughput path (f32): cells that receive immigrants fill their slots
in another order than the single-device resident engine, so trajectories
agree to f32 tolerance and collision counts and dead sets exactly on the
test configs.
"""

from __future__ import annotations

import torch

from particlesimulation_tpu_torch.config import DELTAT, EPSILON, SimConfig
from particlesimulation_tpu_torch.ops import binning, dense, integrate
from particlesimulation_tpu_torch.ops import resident as res
from particlesimulation_tpu_torch.ops.cuda import cell_pairs
from particlesimulation_tpu_torch.ops.stencil import com_from_sums
from particlesimulation_tpu_torch.parallel.sharded import (
    CAP_OVF, INT32_MAX, SHIP_OVF, STRAY_OVF, halo_pad, shard_rows, sort_slabs,
    stencil_tables_halo)
from particlesimulation_tpu_torch.state import ShardedState

_FIELDS = ("x", "y", "vx", "vy", "m", "occ", "pid")


def make_sharded_resident_run(config: SimConfig, mesh, kcap: int, cap: int,
                              ship_rounds: int = 1):
    """Build (prologue, pair_tiles, run) over the mesh's slabs of ``cap``
    slots at tile capacity ``kcap``, as ``engine.make_resident_run`` does
    on one device: ``run(state, n_steps)`` returns the final ShardedState;
    ``pair_tiles(state, n_steps)`` the (x, y, mf, alive, pid) tiles, every
    local shard's stacked, that step ``n_steps`` of that run hands the
    fused pair kernel."""
    side = config.side
    nc = config.ncside
    ncells = config.ncells
    rows_max = config.rows_max
    nrows_t = rows_max + 2
    ncells_t = nrows_t * nc                 # tile rows of one shard
    nslots_t = ncells_t * kcap
    dev = mesh.device
    L = len(mesh.local_shards)
    form = dense.pair_force_form(side)
    row0, rows_mine = shard_rows(config, mesh)
    lpos = torch.arange(L, device=dev)[:, None]

    # Per tile row of the pool: its shard's local row, column, row0 and
    # owned-row count, (L * ncells_t, 1).
    def per_row(v):
        return v[:, None].expand(L, ncells_t).reshape(-1, 1)

    trow = torch.arange(ncells_t, device=dev)
    lrow = (trow // nc).repeat(L)[:, None]
    col = (trow % nc).repeat(L)[:, None]
    row0_t, mine_t = per_row(row0), per_row(rows_mine)
    shard_t = per_row(torch.arange(L, device=dev))
    owned_row = (lrow >= 1) & (lrow <= mine_t)
    halo_row = (lrow == 0) | (lrow == nrows_t - 1)

    def prologue(slab: ShardedState) -> res.TileState:
        """Each shard's sorted slab into its tiles."""
        x, y, vx, vy, m, _, valid, pid = (a.view(L, -1) for a in slab[:8])
        key, in_range = binning.cell_keys(x, y, side, nc)
        gy = key // nc
        gx = key - gy * nc
        # A particle outside its shard's rows cannot come from init_state
        # or an epilogue: flag it (the run is invalid) rather than mis-bin.
        mine = (gy >= row0[:, None]) & (gy < (row0 + rows_mine)[:, None])
        stray = torch.sum(valid & in_range & ~mine, dim=1, dtype=torch.int32)
        ok = valid & in_range & mine
        tkey = torch.where(ok, (gy - row0[:, None] + 1) * nc + gx, ncells_t)
        pos, _ = binning.segment_positions(
            (lpos * (ncells_t + 1) + tkey).reshape(-1))
        pos = pos.view(L, -1)
        kmax = torch.amax(torch.where(ok, pos + 1, 0), dim=1)
        ovf = torch.where(kmax > kcap, kmax, 0).to(torch.int32)
        ovf = torch.maximum(ovf, torch.where(stray > 0, STRAY_OVF, 0)
                            .to(torch.int32))
        fits = pos < kcap
        idx = torch.where(ok & fits, tkey * kcap + pos, nslots_t)
        # Out-of-range (PANIC2-limbo) particles park in the first owned
        # row's leading cell, filling from slot kcap-1 downward so they
        # cannot overwrite its residents (which fill from slot 0 up); they
        # stay out of the physics until back in range. A rank crossing
        # flags overflow.
        limbo = valid & ~in_range
        idx = torch.where(limbo & fits, nc * kcap + (kcap - 1 - pos), idx)
        crowd = (torch.sum(ok & (tkey == nc), dim=1, dtype=torch.int32)
                 + torch.sum(limbo, dim=1, dtype=torch.int32))
        ovf = torch.maximum(ovf, torch.where(crowd > kcap, crowd, 0)
                            .to(torch.int32))
        # Shard l's slots are l * nslots_t ...; the dump slot is past the end.
        idx = torch.where(idx < nslots_t, lpos * nslots_t + idx,
                          L * nslots_t).reshape(-1)

        def scatter(a, fill=0):
            flat = torch.full((L * nslots_t + 1,), fill, dtype=a.dtype,
                              device=dev)
            flat[idx] = a.reshape(-1)
            return flat[:-1].view(L * ncells_t, kcap)

        return res.TileState(
            x=scatter(x), y=scatter(y), vx=scatter(vx), vy=scatter(vy),
            m=scatter(m), occ=scatter(valid & fits, False), pid=scatter(pid),
            collisions=slab.collisions, panics=slab.panics,
            # pmax, not psum: sentinels must not add up across shards.
            overflow=torch.maximum(slab.overflow, mesh.pmax(ovf)))

    def physics_mass(ts):
        _, _, valid = res.cell_of(ts.x, ts.y, side, nc)
        binned = ts.occ & valid & owned_row
        limbo = torch.sum((ts.occ & ~valid).view(L, -1), dim=1,
                          dtype=torch.int32)
        return torch.where(binned, ts.m, 0.0), binned, mesh.psum(limbo)

    def mono_tables(ts, mf):
        """(L * ncells_t, 8) stencil rows: COM of the owned rows, the halo
        ring, the tables; zero rows for the particle halo rows."""
        sums = (torch.sum(mf, dim=1), torch.sum(mf * ts.x, dim=1),
                torch.sum(mf * ts.y, dim=1))
        grids = tuple(a.view(L, nrows_t, nc)[:, 1:rows_max + 1]
                      for a in com_from_sums(*sums))
        tables = stencil_tables_halo(*halo_pad(mesh, grids, rows_mine),
                                     side, nc, row0)
        zpad = tables[0].new_zeros(L, nc, 8)
        return tuple(torch.cat([zpad, t[:, :-1].T.reshape(L, -1, 8), zpad],
                               dim=1).view(L * ncells_t, 8)
                     for t in tables)

    def dest_fn(ts):
        """Movers and their destination cells on the stacked local grids
        (L * nrows_t rows of nc cells): a particle of this shard's rows goes to its
        cell; another goes to the halo row toward its row (by the minimal
        image from its own row), and one that arrived in a halo row goes on
        to the opposite one."""
        cxg, cyg, valid = res.cell_of(ts.x, ts.y, side, nc)
        mine = (cyg >= row0_t) & (cyg < row0_t + mine_t)
        delta = _wrap_delta(cyg - (row0_t + lrow - 1), nc)
        away = torch.where(lrow + delta < 1, 0, nrows_t - 1)
        away = torch.where(lrow == 0, nrows_t - 1,
                           torch.where(lrow == nrows_t - 1, 0, away))
        dest_y = torch.where(mine, cyg - row0_t + 1, away)
        moving = ts.occ & valid & ((dest_y != lrow) | (cxg != col))
        return moving, ((shard_t * nrows_t + dest_y) * nc
                        + torch.clamp(cxg, 0, nc - 1))

    def rebin(ts):
        ts, undelivered = res.rebin(ts, side, nc, kcap, dest_fn=dest_fn,
                                    nrows=L * nrows_t)
        return ts, mesh.psum(undelivered[None])

    def ship(ts):
        """One round: the halo rows go to the ring neighbours, arriving in
        their opposite halo rows."""
        grids = {f: getattr(ts, f).view(L, nrows_t, nc, kcap)
                 for f in _FIELDS}
        from_above = mesh.ppermute({f: g[:, -1] for f, g in grids.items()},
                                   1)
        from_below = mesh.ppermute({f: g[:, 0] for f, g in grids.items()},
                                   -1)
        return ts._replace(**{
            f: torch.cat([from_above[f][:, None], g[:, 1:-1],
                          from_below[f][:, None]], dim=1).view(-1, kcap)
            for f, g in grids.items()})

    def advance(ts, fxd, fyd):
        """Monopole, integrate, migration; (ts, undelivered, limbo)."""
        mf, _, limbo = physics_mass(ts)
        fxm, fym = dense.monopole_tile_forces(ts.x, ts.y, mf,
                                              *mono_tables(ts, mf))
        x, y, vx, vy = integrate.integrate(ts.x, ts.y, ts.vx, ts.vy, ts.m,
                                           fxd + fxm, fyd + fym, side, DELTAT)
        ts, undelivered = rebin(ts._replace(x=x, y=y, vx=vx, vy=vy))
        for _ in range(ship_rounds):
            ts, und = rebin(ship(ts))
            undelivered = undelivered + und
        pending = mesh.psum(torch.sum((ts.occ & halo_row).view(L, -1), dim=1,
                                      dtype=torch.int32))
        # A row too full to deliver into is the tile overflow (grow kcap);
        # otherwise halo occupants left are emigrants still in transit.
        ship_ovf = torch.where((pending > 0) & (undelivered == 0), SHIP_OVF,
                               0).to(torch.int32)
        return (ts._replace(overflow=torch.maximum(ts.overflow, ship_ovf)),
                undelivered, limbo)

    def pair_args(ts):
        mf, binned, _ = physics_mass(ts)
        return ts.x, ts.y, mf, (binned & (ts.m > 0)).to(torch.int32), ts.pid

    def pair_pass(ts, collide: bool):
        fx, fy, count, ft = cell_pairs.fused_pairs(
            *pair_args(ts), kcap, EPSILON, collide=collide, force_form=form)
        return fx, fy, mesh.psum(count[None]), ft != cell_pairs.INF

    def epilogue(ts, state):
        """Tiles back to sorted slabs of ``cap`` slots."""
        occ = ts.occ.view(L, -1)
        pad = max(0, cap - nslots_t)

        def flat(a):
            a = a.view(L, -1)
            return torch.cat([a, a.new_zeros(L, pad)], dim=1) if pad else a

        occ = flat(occ)
        order = torch.argsort((~occ).to(torch.uint8), dim=1,
                              stable=True)[:, :cap]
        valid = torch.gather(occ, 1, order)

        def take(a, fill=0):
            return torch.where(valid, torch.gather(flat(a), 1, order), fill)

        n_occ = torch.sum(occ, dim=1, dtype=torch.int32)
        # Slab exhaustion is its own cause (growing kcap cannot fix it).
        ovf = torch.where(n_occ > cap, CAP_OVF + (n_occ - cap), 0)
        x, y, m = take(ts.x), take(ts.y), take(ts.m)
        key, _ = binning.cell_keys(x, y, side, nc)
        key = torch.where(valid, key, ncells + 1)
        _, pid, x, y, vx, vy, m, alive, valid = sort_slabs(
            key, take(ts.pid, INT32_MAX), x, y, take(ts.vx), take(ts.vy), m,
            valid & (m > 0), valid)
        return ShardedState(
            x=x.reshape(-1), y=y.reshape(-1), vx=vx.reshape(-1),
            vy=vy.reshape(-1), m=m.reshape(-1), alive=alive.reshape(-1),
            valid=valid.reshape(-1), pid=pid.reshape(-1),
            collisions=ts.collisions, panics=ts.panics,
            overflow=torch.maximum(ts.overflow,
                                   mesh.pmax(ovf.to(torch.int32))))

    pair_tiles, run = res.make_tile_run(prologue, advance, pair_args,
                                        pair_pass, kcap, side, nc,
                                        finish=epilogue)
    return prologue, pair_tiles, run


def _wrap_delta(d, ncside: int):
    """Minimal-image cell delta in [-nc/2, nc/2)."""
    half = ncside // 2
    return torch.remainder(d + half, ncside) - half
