"""Rectangle-sharded slot-resident fast engine: rectangle tiles with a halo
ring (counterpart of the JAX package's ``parallel/sharded2d_resident.py``).

Each shard's state lives in ``(ncells_t, K)`` slot tiles over its cell
rectangle plus a one-cell particle halo ring; one step, written against the
2D mesh of ``parallel/mesh``, does

* local COM from the tiles (row sums) and the two-phase COM halo
  (``sharded2d.com_halo_layout``), then the monopole terms on the tiles
  and the integration, one kernel
  (``ops/cuda/advance.tile_monopole_integrate``);
* migration routed dimension-ordered: one delivery
  (``ops/cuda/advance.deliver``) moves every mover in one pass, a mover
  bound for another row block into the top or bottom halo row, keeping its
  column, and one whose row block matches but column block does not into
  the left or right halo column at its row; then each ship round
  (``sharded_resident.make_halo_transport``) ships the halo rows along the
  rows axis, delivers the arrivals (to their cells, on to a halo column,
  or on to the far halo row), ships the halo columns along the cols axis
  and delivers those arrivals;
* the fused collision(t) + pair-force(t+1) pass, the hand-written kernel of
  ``ops/cuda/cell_pairs``, once over every shard's tiles.

Local tile grid of a shard ((rows_max + 2) × (cols_max + 2) cells):

    local row 0 / col 0                   = top / left halo
    rows 1..rows_mine × cols 1..cols_mine = the owned rectangle
    rows / cols beyond the owned extent   = unused (uneven split only; the
                                            one-pass delivery leaves them
                                            empty)
    row rows_max + 1 / col cols_max + 1   = bottom / right halo

The corner halo cells stay empty: a mover enters a halo row only at an
owned column, and a halo column only at an owned row, and the two axes'
neighbours share the column and row blocks, so halo rows and columns ship
with no corner case and every arrival lands at an owned row or column.

As on the 1D mesh, JAX's ``psum``-gated ship loop becomes ``ship_rounds``
rounds (1 by default) and ``SHIP_OVF`` for halo occupants left, which the
engine's ladder replays with d_r + d_c + ``SHIP_SLACK`` rounds. Capacity
overflow anywhere raises ``overflow`` and the engine replays the run; no
particle is dropped. The f64 slab sweep carries the bitwise claim; this is
the f32 throughput path: counts and dead sets exact against the one-device
resident engine on the test configs, trajectories to f32 tolerance.
"""

from __future__ import annotations

import torch

from particlesimulation_tpu_torch.config import DELTAT, EPSILON, SimConfig
from particlesimulation_tpu_torch.ops import binning, dense
from particlesimulation_tpu_torch.ops import resident as res
from particlesimulation_tpu_torch.ops.cuda import advance as advance_ops
from particlesimulation_tpu_torch.ops.cuda import cell_pairs
from particlesimulation_tpu_torch.ops.cuda import stencil as stencil_ops
from particlesimulation_tpu_torch.parallel.sharded2d import (
    AxisDecomp, com_halo_layout, rect_geometry)
from particlesimulation_tpu_torch.parallel.sharded_resident import (
    halo_dest_row, index_ship, make_halo_transport, slabs_to_tiles,
    tiles_to_slabs)


def make_sharded2d_resident_run(config: SimConfig, mesh, dec_r: AxisDecomp,
                                dec_c: AxisDecomp, kcap: int, cap: int,
                                ship_rounds: int = 1):
    """Build (prologue, pair_tiles, run) over the 2D mesh's slabs of ``cap``
    slots at tile capacity ``kcap``, as
    ``sharded_resident.make_sharded_resident_run`` does on the 1D mesh:
    ``pair_tiles(state, n_steps)`` gives the (x, y, mf, alive, pid) tiles,
    every local shard's stacked, that step ``n_steps`` hands the fused pair
    kernel."""
    side = config.side
    nc = config.ncside
    rows_max, cols_max = dec_r.max_blocks, dec_c.max_blocks
    nrows_t, ncols_t = rows_max + 2, cols_max + 2
    ncells_t = nrows_t * ncols_t            # tile rows of one shard
    dev = mesh.device
    L = len(mesh.local_shards)
    nslots = L * ncells_t * kcap
    form = dense.pair_force_form(side)
    row0, rows_mine, col0, cols_mine = rect_geometry(mesh, dec_r, dec_c)
    lpos = torch.arange(L, device=dev)[:, None]
    row_start = torch.arange(L * ncells_t + 1, device=dev) * kcap

    trow = torch.arange(L * ncells_t, device=dev)
    shard_of = trow // ncells_t
    lrow = (trow % ncells_t // ncols_t)[:, None]
    lcol = (trow % ncols_t)[:, None]
    owned = ((lrow >= 1) & (lrow <= rows_mine[shard_of][:, None])
             & (lcol >= 1) & (lcol <= cols_mine[shard_of][:, None]))

    def prologue(slab) -> res.TileState:
        """Each shard's sorted slab into its tiles; out-of-range particles
        park in the first owned cell."""
        x, y, valid = (a.view(L, -1) for a in (slab.x, slab.y, slab.valid))
        key, in_range = binning.cell_keys(x, y, side, nc)
        gy = key // nc
        gx = key - gy * nc
        r0, c0 = row0[:, None], col0[:, None]
        mine = ((gy >= r0) & (gy < r0 + rows_mine[:, None])
                & (gx >= c0) & (gx < c0 + cols_mine[:, None]))
        # A particle outside its shard's rectangle cannot come from
        # init_state or an epilogue: flag it rather than mis-bin it.
        stray = torch.sum(valid & in_range & ~mine, dim=1)
        row = lpos * ncells_t + (gy - r0 + 1) * ncols_t + gx - c0 + 1
        return slabs_to_tiles(slab, mesh, row, valid & in_range & mine,
                              valid & ~in_range, stray,
                              lpos[:, 0] * ncells_t + ncols_t + 1, row_start,
                              nslots, (L * ncells_t, kcap))

    def physics_mass(ts):
        _, _, valid = res.cell_of(ts.x, ts.y, side, nc)
        binned = ts.occ & valid & owned
        limbo = torch.sum((ts.occ & ~valid).view(L, -1), dim=1,
                          dtype=torch.int32)
        return torch.where(binned, ts.m, 0.0), binned, mesh.psum(limbo)

    layout = com_halo_layout(dec_r, dec_c, row0, rows_mine, col0, cols_mine,
                             aligned=(1, 1))

    def mono_tables(ts, mf):
        """(L * ncells_t, 8) stencil rows: COM of the rectangles, the
        two-phase halo, the tables; zero rows for the halo ring."""
        sums = (torch.sum(mf, dim=1), torch.sum(mf * ts.x, dim=1),
                torch.sum(mf * ts.y, dim=1))
        grids = [tuple(a.view(L, nrows_t, ncols_t)[:, 1:rows_max + 1,
                                                   1:cols_max + 1]
                       for a in sums)]
        return stencil_ops.mesh_tables(mesh, layout, grids, side, nc,
                                       from_sums=True)

    def geometry(rows):
        """Per pool row: the row itself, its shard's local index, local row
        and column, and the shard's rectangle."""
        shard = rows // ncells_t
        return (rows, shard, rows % ncells_t // ncols_t, rows % ncols_t,
                row0[shard], rows_mine[shard], col0[shard], cols_mine[shard])

    def dest(x, y, occ, row, shard, lr, lc, r0, rmine, c0, cmine):
        """Movers and their destination rows, dimension-ordered: the row of
        the particle's cell if this shard owns it, else the halo row toward
        it at the particle's own column; then, at an owned row, the column
        of its cell if owned, else the halo column toward it
        (``halo_dest_row`` on each axis)."""
        cx, cy, valid = res.cell_of(x, y, side, nc)
        dr = halo_dest_row(cy, r0, rmine, lr, nrows_t, nc)
        dc = torch.where((dr == 0) | (dr == nrows_t - 1), lc,
                         halo_dest_row(cx, c0, cmine, lc, ncols_t, nc))
        to = (shard * nrows_t + dr) * ncols_t + dc
        return occ & valid & (to != row), to

    def halo_slots(lines, at):
        """(L, H) flat slots of each shard's tile line ``at`` (``lines``
        "rows": local row ``at``; "cols": local column ``at``)."""
        base = torch.arange(L, device=dev)[:, None] * ncells_t
        if lines == "rows":
            cells = base + at * ncols_t + torch.arange(ncols_t, device=dev)
        else:
            cells = base + torch.arange(nrows_t, device=dev) * ncols_t + at
        return (cells[:, :, None] * kcap
                + torch.arange(kcap, device=dev)).reshape(L, -1)

    migrate = make_halo_transport(
        mesh, [index_ship(mesh, halo_slots("rows", 0),
                          halo_slots("rows", nrows_t - 1), "rows"),
               index_ship(mesh, halo_slots("cols", 0),
                          halo_slots("cols", ncols_t - 1), "cols")],
        row_start, trow[:, None], geometry, dest)

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
