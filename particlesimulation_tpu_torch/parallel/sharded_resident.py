"""Sharded slot-resident fast engine: resident tiles with halo rows
(counterpart of the JAX package's ``parallel/sharded_resident.py``).

Each shard's state lives in ``(nrows_t * ncside, K)`` slot tiles covering
its row block plus two *particle halo rows*; one step, written against the
mesh interface of ``parallel/mesh``, does

* local COM from the tiles (row sums) and the one-row COM halo ring
  (``ops/cuda/stencil.mesh_tables``: one row each way over the ring, the
  reference's ghost-cell Isend/Irecv, mpi/parsim-mpi.cpp:670-815, and the
  tables kernel), then the monopole terms on the tiles and
  the integration, one kernel (``ops/cuda/advance.tile_monopole_integrate``);
* migration: one delivery (``ops/cuda/advance.deliver``
  on the local grid) moves every mover in one pass, an emigrant into the
  halo row on its side; the halo rows then ship to the ring neighbours
  (``mesh.ppermute``; the reference's Alltoall + point-to-point exchange,
  mpi/parsim-mpi.cpp:512-600), arrive in the neighbour's opposite halo
  row, and a delivery of the halo slots alone moves the arrivals to their
  cells (or on to the far halo row, if their row is further on);
* the fused collision(t) + pair-force(t+1) pass, the hand-written kernel of
  ``ops/cuda/cell_pairs``, on every shard's tiles, halo rows included.

The shards' tiles are stacked into one pool, so each pass (and the pair
kernel) runs once over all local shards: launches do not grow with D.

The halo transport (``make_halo_transport``: the ship round, the delivery
of the halo slots alone after it, the ``SHIP_OVF`` accounting), the tile
layout of sorted slabs (``slabs_to_tiles``) and its inverse
(``tiles_to_slabs``) are shared with the super-cell mesh
(``parallel/sharded_supercell``, halo super-rows) and the column-sharded
bands (``parallel/sharded_banded_cols``, halo columns).

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
from particlesimulation_tpu_torch.ops import binning, dense
from particlesimulation_tpu_torch.ops import resident as res
from particlesimulation_tpu_torch.ops.cuda import advance as advance_ops
from particlesimulation_tpu_torch.ops.cuda import cell_pairs
from particlesimulation_tpu_torch.ops.cuda import stencil as stencil_ops
from particlesimulation_tpu_torch.parallel.sharded import (
    CAP_OVF, INT32_MAX, SHIP_OVF, STRAY_OVF, shard_rows, sort_slabs)
from particlesimulation_tpu_torch.state import ShardedState

_FIELDS = ("x", "y", "vx", "vy", "m", "occ", "pid")


def wrap_delta(d, n: int):
    """Minimal-image delta in [-n/2, n/2) on a ring of ``n``."""
    half = n // 2
    return torch.remainder(d + half, n) - half


def halo_dest_row(gy, row0, rows_mine, lrow, nrows_t: int, n: int):
    """Destination local row of a particle in global row ``gy`` (of ``n``)
    sitting in local row ``lrow`` of a grid of ``nrows_t`` rows whose rows 1
    to ``rows_mine`` are global rows ``row0`` on: its own row if this shard
    owns it; else the halo row toward it (row 0 or ``nrows_t - 1``, by the
    minimal image from its current row), and for one that arrived in a
    halo row, the opposite halo row."""
    delta = wrap_delta(gy - (row0 + lrow - 1), n)
    away = torch.where(lrow + delta < 1, 0, nrows_t - 1)
    away = torch.where(lrow == 0, nrows_t - 1,
                       torch.where(lrow == nrows_t - 1, 0, away))
    mine = (gy >= row0) & (gy < row0 + rows_mine)
    return torch.where(mine, gy - row0 + 1, away)


def halo_row_slots(n_shards: int, nrows_t: int, ncols: int, kcap: int,
                   device):
    """(low, high): each shard's slots of local rows 0 and ``nrows_t - 1``
    of its ``nrows_t × ncols`` grid of ``kcap``-slot rows, the shards' grids
    stacked; (L, ncols·kcap) int64 flat slot indices each."""
    per_shard = nrows_t * ncols * kcap
    base = torch.arange(n_shards, device=device)[:, None] * per_shard
    row = torch.arange(ncols * kcap, device=device)[None, :]
    return base + row, base + (nrows_t - 1) * ncols * kcap + row


def index_ship(mesh, low, high, axis: str = "rows"):
    """A ship phase of ``make_halo_transport``: each shard's ``high`` halo
    slots go to the ``low`` ones of the next shard along the mesh's
    ``axis``, its ``low`` ones to the previous shard's ``high`` ones.
    ``low``, ``high``: (L, H) flat slot indices of each shard's halos, the
    same H on every shard. Returns (ship, halo slots)."""
    def ship(ts):
        for f in _FIELDS:
            flat = getattr(ts, f).view(-1)
            lo, hi = flat[low], flat[high]
            flat[low] = mesh.ppermute(hi, 1, axis)
            flat[high] = mesh.ppermute(lo, -1, axis)

    return ship, torch.cat([low, high], dim=1)


def make_halo_transport(mesh, phases, row_start, rows, geometry, dest):
    """The migration of a tile mesh whose shards exchange particles through
    halos. ``phases``: the ship phases of a round, in order, each a pair
    (ship, halo): ``ship(ts)`` moves the halos' particles to the shards
    they are bound for, in place on the tiles, and returns None or the (L,)
    count of arrivals it had no slot for; ``halo``: (L, H) flat slot
    indices of each shard's halos of that phase (``index_ship``'s for two
    halos of one index set: ``halo_row_slots``' rows, the banded meshes'
    halo columns; the 2D mesh's rows phase, then its cols phase).
    ``row_start``: the pool's row starts (``advance_ops.deliver``'s).
    ``geometry(rows)`` gives the engine's per-slot geometry of the given
    pool rows (a tuple of tensors); ``dest(x, y, occ, *geometry)`` gives
    (moving, destination pool row).

    Returns ``migrate(ts, ship_rounds)`` -> (ts, undelivered): one delivery
    of every mover, then ``ship_rounds`` rounds, each of every phase's ship
    and a delivery of that phase's halo slots alone (only an arrival can
    move then); halo occupants left after the last round raise ``SHIP_OVF``
    (the engine's ladder adds rounds), unless a row was too full to deliver
    into (the tile overflow, which ``undelivered`` reports)."""
    geo_all = geometry(rows)
    steps = []
    for ship, halo in phases:
        cand, _ = torch.sort(halo.reshape(-1))
        cand_rows = torch.searchsorted(row_start, cand, right=True) - 1
        steps.append((ship, cand, geometry(cand_rows)))

    def migrate(ts, ship_rounds: int):
        moving, to = dest(ts.x, ts.y, ts.occ, *geo_all)
        ts, undelivered = advance_ops.deliver(ts, moving, to, row_start)
        undelivered = mesh.psum(undelivered[None])
        for _ in range(ship_rounds):
            for ship, cand, geo_cand in steps:
                dropped = ship(ts)
                if dropped is not None:
                    undelivered = undelivered + mesh.psum(dropped)
                moving, to = dest(*(a.reshape(-1)[cand]
                                    for a in (ts.x, ts.y, ts.occ)),
                                  *geo_cand)
                ts, und = advance_ops.deliver(ts, moving, to, row_start,
                                          at=cand)
                undelivered = undelivered + mesh.psum(und[None])
        occ = ts.occ.view(-1)
        pending = sum(mesh.psum(torch.sum(occ[halo], dim=1,
                                          dtype=torch.int32))
                      for _, halo in phases)
        # A row too full to deliver into is the tile overflow (grow the
        # tiles); otherwise halo occupants left are emigrants in transit.
        ship_ovf = torch.where((pending > 0) & (undelivered == 0), SHIP_OVF,
                               0).to(torch.int32)
        return (ts._replace(overflow=torch.maximum(ts.overflow, ship_ovf)),
                undelivered)

    return migrate


def slabs_to_tiles(slab: ShardedState, mesh, row, ok, limbo, stray,
                   park_row, row_start, nslots: int, shape):
    """Lay each shard's sorted slab out in the pool's rows.

    ``row``: (L, C) the pool row of each slab slot's particle where ``ok``;
    ``limbo``: the valid out-of-range (PANIC2-limbo) particles, which park
    in the tail slots of pool row ``park_row[l]`` of their shard (L,), from
    the top down, so that they cannot overwrite its residents (which fill
    from slot 0 up); they stay out of the physics until back in range.
    ``stray``: (L,) count of particles outside their shard (an invalid
    run). A row's particles take its slots in pid order. A row too full, or
    the park row's residents and the limbo together, flag overflow
    (lossless retry). Returns the TileState, each field ``shape``."""
    L = len(mesh.local_shards)
    dev = mesh.device
    nrows = row_start.shape[0] - 1
    x, y, vx, vy, m, _, _, pid = (a.view(L, -1) for a in slab[:8])
    key = torch.where(ok, row, torch.where(limbo, nrows, nrows + 1))
    key, pid, x, y, vx, vy, m, ok, limbo = sort_slabs(
        key, pid, x, y, vx, vy, m, ok, limbo)
    lpos = torch.arange(L, device=dev)[:, None]
    pos, _ = binning.segment_positions((lpos * (nrows + 2) + key).reshape(-1))
    pos = pos.view(L, -1)
    kc = torch.clamp(key, max=nrows - 1)
    start = row_start[kc]
    fits = ok & (pos < row_start[kc + 1] - start)
    ovf = torch.amax(torch.where(ok & ~fits, pos + 1, 0), dim=1)
    idx = torch.where(fits, start + pos, nslots)
    pstart = row_start[park_row][:, None]
    pwidth = row_start[park_row + 1][:, None] - pstart
    parked = limbo & (pos < pwidth)
    idx = torch.where(parked, pstart + pwidth - 1 - pos, idx).reshape(-1)
    crowd = (torch.sum(ok & (key == park_row[:, None]), dim=1)
             + torch.sum(limbo, dim=1))
    ovf = torch.maximum(ovf, torch.where(crowd > pwidth[:, 0], crowd, 0))
    ovf = torch.maximum(ovf, torch.where(stray > 0, STRAY_OVF, 0))

    def scatter(a, fill=0):
        flat = torch.full((nslots + 1,), fill, dtype=a.dtype, device=dev)
        flat[idx] = a.reshape(-1)
        return flat[:nslots].view(shape)

    return res.TileState(
        x=scatter(x), y=scatter(y), vx=scatter(vx), vy=scatter(vy),
        m=scatter(m), occ=scatter(torch.ones_like(ok), False),
        pid=scatter(pid), collisions=slab.collisions, panics=slab.panics,
        # pmax, not psum: sentinels must not add up across shards.
        overflow=torch.maximum(slab.overflow,
                               mesh.pmax(ovf.to(torch.int32))))


def tiles_to_slabs(ts, mesh, cap: int, side: float, nc: int,
                   shard_slots=None) -> ShardedState:
    """Tiles back to each shard's slab of ``cap`` slots, sorted by (cell
    key, pid). ``shard_slots``: (L, S) flat slot indices of each shard's
    tiles, where a shard's tiles are not the L-th part of the pool."""
    L = len(mesh.local_shards)

    def flat(a):
        a = a.reshape(L, -1) if shard_slots is None else a.view(-1)[
            shard_slots]
        pad = cap - a.shape[1]
        return torch.cat([a, a.new_zeros(L, pad)], dim=1) if pad > 0 else a

    occ = flat(ts.occ)
    order = torch.argsort((~occ).to(torch.uint8), dim=1,
                          stable=True)[:, :cap]
    valid = torch.gather(occ, 1, order)

    def take(a, fill=0):
        return torch.where(valid, torch.gather(flat(a), 1, order), fill)

    n_occ = torch.sum(occ, dim=1, dtype=torch.int32)
    # Slab exhaustion is its own cause (growing the tiles cannot fix it).
    ovf = torch.where(n_occ > cap, CAP_OVF + (n_occ - cap), 0)
    x, y, m = take(ts.x), take(ts.y), take(ts.m)
    key, _ = binning.cell_keys(x, y, side, nc)
    key = torch.where(valid, key, nc * nc + 1)
    _, pid, x, y, vx, vy, m, alive, valid = sort_slabs(
        key, take(ts.pid, INT32_MAX), x, y, take(ts.vx), take(ts.vy), m,
        valid & (m > 0), valid)
    return ShardedState(
        x=x.reshape(-1), y=y.reshape(-1), vx=vx.reshape(-1),
        vy=vy.reshape(-1), m=m.reshape(-1), alive=alive.reshape(-1),
        valid=valid.reshape(-1), pid=pid.reshape(-1),
        collisions=ts.collisions, panics=ts.panics,
        overflow=torch.maximum(ts.overflow, mesh.pmax(ovf.to(torch.int32))))


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
    rows_max = config.rows_max
    nrows_t = rows_max + 2
    ncells_t = nrows_t * nc                 # tile rows of one shard
    dev = mesh.device
    L = len(mesh.local_shards)
    nslots = L * ncells_t * kcap
    form = dense.pair_force_form(side)
    row0, rows_mine = shard_rows(config, mesh)
    lpos = torch.arange(L, device=dev)[:, None]
    row_start = torch.arange(L * ncells_t + 1, device=dev) * kcap

    trow = torch.arange(ncells_t, device=dev)
    lrow = (trow // nc).repeat(L)[:, None]
    mine_t = rows_mine[:, None].expand(L, ncells_t).reshape(-1, 1)
    owned_row = (lrow >= 1) & (lrow <= mine_t)

    def prologue(slab: ShardedState) -> res.TileState:
        """Each shard's sorted slab into its tiles."""
        x, y, valid = (a.view(L, -1) for a in (slab.x, slab.y, slab.valid))
        key, in_range = binning.cell_keys(x, y, side, nc)
        gy = key // nc
        gx = key - gy * nc
        mine = (gy >= row0[:, None]) & (gy < (row0 + rows_mine)[:, None])
        # A particle outside its shard's rows cannot come from init_state
        # or an epilogue: flag it (the run is invalid) rather than mis-bin.
        stray = torch.sum(valid & in_range & ~mine, dim=1)
        row = lpos * ncells_t + (gy - row0[:, None] + 1) * nc + gx
        return slabs_to_tiles(slab, mesh, row, valid & in_range & mine,
                              valid & ~in_range, stray,
                              lpos[:, 0] * ncells_t + nc, row_start, nslots,
                              (L * ncells_t, kcap))

    def physics_mass(ts):
        _, _, valid = res.cell_of(ts.x, ts.y, side, nc)
        binned = ts.occ & valid & owned_row
        limbo = torch.sum((ts.occ & ~valid).view(L, -1), dim=1,
                          dtype=torch.int32)
        return torch.where(binned, ts.m, 0.0), binned, mesh.psum(limbo)

    # The COM halo of the owned rows; the tables row-aligned with the
    # tiles, zero rows for the particle halo rows.
    layout = stencil_ops.HaloLayout((rows_max,), nc, row0=(row0,),
                                    rows_mine=(rows_mine,), aligned=(1, 0))

    def mono_tables(ts, mf):
        """(L * ncells_t, 8) stencil rows: COM of the owned rows, the halo
        ring, the tables; zero rows for the particle halo rows."""
        sums = (torch.sum(mf, dim=1), torch.sum(mf * ts.x, dim=1),
                torch.sum(mf * ts.y, dim=1))
        grids = [tuple(a.view(L, nrows_t, nc)[:, 1:rows_max + 1]
                       for a in sums)]
        return stencil_ops.mesh_tables(mesh, layout, grids, side, nc,
                                       from_sums=True)

    def geometry(rows):
        """Per pool row: its shard, local row and column, and the shard's
        first global row and owned-row count."""
        shard = rows // ncells_t
        return (shard, rows % ncells_t // nc, rows % nc, row0[shard],
                rows_mine[shard])

    def dest(x, y, occ, shard, lr, col, r0, mine_n):
        """Movers and their destination rows on the stacked local grids: a
        particle of this shard's rows goes to its cell, another to the halo
        row toward its row (``halo_dest_row``), at its column."""
        cx, cy, valid = res.cell_of(x, y, side, nc)
        dest_y = halo_dest_row(cy, r0, mine_n, lr, nrows_t, nc)
        moving = occ & valid & ((dest_y != lr) | (cx != col))
        return moving, ((shard * nrows_t + dest_y) * nc
                        + torch.clamp(cx, 0, nc - 1))

    migrate = make_halo_transport(
        mesh, [index_ship(mesh, *halo_row_slots(L, nrows_t, nc, kcap, dev))],
        row_start, torch.arange(L * ncells_t, device=dev)[:, None], geometry,
        dest)

    def advance(ts, fxd, fyd):
        """Monopole and integrate (one kernel, in place), migration; (ts,
        undelivered, limbo)."""
        mf, _, limbo = physics_mass(ts)
        advance_ops.tile_monopole_integrate(
            ts.x, ts.y, ts.vx, ts.vy, ts.m, mf, fxd, fyd, mono_tables(ts, mf),
            row_start, side, DELTAT)
        ts, undelivered = migrate(ts, ship_rounds)
        return ts, undelivered, limbo

    def pair_args(ts):
        mf, binned, _ = physics_mass(ts)
        return ts.x, ts.y, mf, (binned & (ts.m > 0)).to(torch.int32), ts.pid

    def pair_pass(ts, collide: bool, out=None):
        fx, fy, count, ft = cell_pairs.fused_pairs(
            *pair_args(ts), kcap, EPSILON, collide=collide, force_form=form,
            out=out)
        return fx, fy, mesh.psum(count[None]), ft != cell_pairs.INF

    pair_tiles, run = res.make_tile_run(
        prologue, advance, pair_args, pair_pass, kcap, side, nc,
        finish=lambda ts, _: tiles_to_slabs(ts, mesh, cap, side, nc))
    return prologue, pair_tiles, run
