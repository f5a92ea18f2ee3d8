"""Column-sharded banded engine: clustered loads on the 1D mesh
(counterpart of the JAX package's ``parallel/sharded_banded_cols.py``).

The mesh axis runs along grid *columns*, and the row bands of the
one-device banded engine (``ops/banded``) stay whole: every shard owns a
contiguous column range (``col_owner``) of every band. A band's per-cell
pair cost depends on its K, not on the column, so the unquantized
one-device plan balances the shards by construction, and only column
movers cross shards (the reference's ghost exchange and migration,
mpi/parsim-mpi.cpp:670-815,512-600, turned 90 degrees).

The JAX engine keeps per-band buffers with two halo rows each and moves
cross-band movers through them in rounds. This engine composes the port's
one-pool banded design (``ops/banded``: one slot pool, one delivery for
every mover) with the column split:

* each shard holds every band's rows over its own columns plus two halo
  columns, at that band's K: local column 0 is the left halo, columns 1 to
  CNT the owned ones, and column CMAXC + 1 the right halo (a shard with
  fewer columns leaves the ones between empty). The pool is band-major:
  a band's rows of every shard are contiguous, so the fused pair kernel
  and the COM row sums run once a band over all shards;
* a mover that stays in its shard moves in one delivery, across bands
  too; a mover bound for another shard parks in the halo column at its
  destination row (JAX's column-first rule: no particle waits in a halo
  cell of another row), so the receiving shard's delivery finishes it;
* the halo columns' slots are one fixed index set, the same on every
  shard, at each band's K: one ship round gathers them, ppermutes them and
  delivers the arrivals (``sharded_resident.make_halo_transport``). So
  JAX's uniform halo lane cut (``PSIM_BAND_HALO_W``) has no counterpart;
* the stencil tables (``ops/cuda/stencil.mesh_tables``: the sums' edge
  columns each way over the ring, then one kernel from the sums and the
  halo columns to the tables) and the 8 monopole terms with the
  integration (one kernel, ``ops/cuda/advance.gathered_monopole_integrate``:
  a binned slot's terms at its pool row's cell) run once over the pool.

Capacity overflow anywhere flags ``overflow`` and the engine replays the
run with a grown plan; no particle is dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from particlesimulation_tpu_torch.config import DELTAT, EPSILON, SimConfig
from particlesimulation_tpu_torch.ops import binning, dense
from particlesimulation_tpu_torch.ops import resident as res
from particlesimulation_tpu_torch.ops.cuda import advance as advance_ops
from particlesimulation_tpu_torch.ops.cuda import cell_pairs
from particlesimulation_tpu_torch.ops.cuda import stencil as stencil_ops
from particlesimulation_tpu_torch.parallel.sharded_resident import (
    halo_dest_row, index_ship, make_halo_transport, slabs_to_tiles,
    tiles_to_slabs)


def col_owner(ncside: int, n_shards: int, cols):
    """Owning shard of each global grid column (NumPy), the balanced-uneven
    split: the first ``ncside % n_shards`` shards own one column more."""
    cols = np.asarray(cols)
    base, rem = divmod(ncside, n_shards)
    split = rem * (base + 1)
    return np.where(cols < split, cols // (base + 1),
                    rem + (cols - split) // max(1, base))


def make_sharded_banded_cols_run(config: SimConfig, mesh, plan, cap: int,
                                 ship_rounds: int = 1):
    """Build (prologue, pair_tiles, run) over the mesh's slabs of ``cap``
    slots and the band plan ``[(row0, rows, kcap), ...]`` (contiguous over
    the grid rows; the one-device plan, unquantized), as
    ``sharded_resident.make_sharded_resident_run`` does.
    ``pair_tiles(state, n_steps)`` gives per band the (x, y, mf, alive,
    pid) tiles of every local shard that step ``n_steps`` hands its pair
    pass."""
    side = config.side
    nc = config.ncside
    d = config.n_shards
    bands = [(int(r0), int(rw), int(k)) for r0, rw, k in plan]
    if bands[0][0] != 0 or any(r0 + rw != nxt[0] for (r0, rw, _), nxt
                               in zip(bands, bands[1:])) or (
            bands[-1][0] + bands[-1][1] != nc):
        raise ValueError(f"band plan {plan} does not cover the {nc} grid "
                         f"rows contiguously")
    if not all(1 <= k <= cell_pairs.MAX_KCAP for _, _, k in bands):
        raise ValueError(f"band plan {plan}: K outside [1, "
                         f"{cell_pairs.MAX_KCAP}]")
    if d > nc:
        raise ValueError(f"{d} shards > {nc} grid columns")
    dev = mesh.device
    L = len(mesh.local_shards)
    form = dense.pair_force_form(side)
    base, rem = divmod(nc, d)
    cmaxc = base + (1 if rem else 0)
    wide = cmaxc + 2                         # + 2 halo columns
    col0 = torch.tensor([s * base + min(s, rem) for s in mesh.local_shards],
                        device=dev)
    cnt = torch.tensor([base + (s < rem) for s in mesh.local_shards],
                       device=dev)
    kmax = max(k for _, _, k in bands)

    # Pool layout, band-major: band b's rows are (shard, band row, local
    # column) in that order, K_b slots each.
    nrows_b = [L * rw * wide for _, rw, _ in bands]
    sizes = [n * k for n, (_, _, k) in zip(nrows_b, bands)]
    offs = np.cumsum([0] + sizes).tolist()
    rbase = np.cumsum([0] + nrows_b).tolist()
    nslots = offs[-1]
    # The pool's rows as runs of one width, a band each: the row starts
    # and the monopole pass (whose kernel finds a slot's row from the runs)
    # read this one layout.
    runs = tuple((n, k) for n, (_, _, k) in zip(nrows_b, bands))
    row_start = advance_ops.row_starts(runs, dev)
    # Per pool row: shard, global row, local column; per global row: the
    # pool row of (shard 0, that row, column 0), and the stride a shard.
    shard_r, gy_r, lc_r = (torch.cat(t) for t in zip(*(
        (torch.arange(L, device=dev).repeat_interleave(rw * wide),
         (r0 + torch.arange(rw, device=dev)).repeat_interleave(wide)
         .repeat(L),
         torch.arange(wide, device=dev).repeat(L * rw))
        for r0, rw, _ in bands)))
    row_base = torch.cat([rb + wide * torch.arange(rw, device=dev)
                          for rb, (_, rw, _) in zip(rbase, bands)])
    row_stride = torch.cat([torch.full((rw,), rw * wide, device=dev)
                            for _, rw, _ in bands])
    row_of = torch.cat([(rb + torch.arange(n, device=dev))
                        .repeat_interleave(k)
                        for rb, n, (_, _, k) in zip(rbase, nrows_b, bands)])
    ncl = nc * cmaxc                         # cells of a local COM grid
    owned = ((lc_r >= 1) & (lc_r <= cnt[shard_r]))[row_of]
    # Each pool row's cell in the local COM grids' tables (meaningful on
    # owned columns).
    cell_of_row = shard_r * ncl + gy_r * cmaxc + lc_r - 1

    def pool_row(shard, gy, lc):
        gy = torch.clamp(gy, 0, nc - 1)
        return row_base[gy] + shard * row_stride[gy] + lc

    def views(a):
        """Each band's (..., rows_b, K_b) view of a (..., slots) tensor."""
        return [a[..., o:o + s].view(*a.shape[:-1], n, k)
                for (_, _, k), o, s, n in zip(bands, offs, sizes, nrows_b)]

    def slots_at(lc):
        """(L, H) flat slots of local column ``lc`` of every band row of
        each shard, band by band."""
        per = []
        for (_, rw, k), o in zip(bands, offs):
            rows = (torch.arange(L, device=dev)[:, None] * rw
                    + torch.arange(rw, device=dev)) * wide + lc
            per.append((o + rows[:, :, None] * k
                        + torch.arange(k, device=dev)).reshape(L, -1))
        return torch.cat(per, dim=1)

    shard_slots = torch.cat([(o + torch.arange(s, device=dev)).view(L, -1)
                             for o, s in zip(offs, sizes)], dim=1)

    def geometry(rows):
        """Per pool row: the row itself, its shard, global row and local
        column, and the shard's first column and column count."""
        shard = shard_r[rows]
        return rows, shard, gy_r[rows], lc_r[rows], col0[shard], cnt[shard]

    def dest(x, y, occ, row, shard, _gy, lc, c0, cnt_s):
        """Movers and their destination rows: to the particle's own row
        (any band), at its column if this shard owns it, else in the halo
        column toward it (the column-first rule)."""
        cx, cy, valid = res.cell_of(x, y, side, nc)
        dest_c = halo_dest_row(cx, c0, cnt_s, lc, wide, nc)
        to = pool_row(shard, cy, dest_c)
        return occ & valid & (to != row), to

    migrate = make_halo_transport(
        mesh, [index_ship(mesh, slots_at(0), slots_at(wide - 1))], row_start,
        row_of, geometry, dest)

    def prologue(slab) -> res.TileState:
        """Each shard's sorted slab into its column tiles; out-of-range
        particles park in band 0's first row, first owned column."""
        x, y, valid = (a.view(L, -1) for a in (slab.x, slab.y, slab.valid))
        key, in_range = binning.cell_keys(x, y, side, nc)
        gy = key // nc
        gx = key - gy * nc
        c0 = col0[:, None]
        mine = (gx >= c0) & (gx < c0 + cnt[:, None])
        stray = torch.sum(valid & in_range & ~mine, dim=1)
        shard = torch.arange(L, device=dev)
        row = pool_row(shard[:, None], gy, gx - c0 + 1)
        return slabs_to_tiles(slab, mesh, row, valid & in_range & mine,
                              valid & ~in_range, stray,
                              pool_row(shard, shard * 0, 1), row_start,
                              nslots, (nslots,))

    def physics_mass(ts, out=None):
        """(mf, binned, limbo count): zero mf keeps unbinned slots (out of
        range, or in a halo column) out of every physics pass."""
        _, _, valid = res.cell_of(ts.x, ts.y, side, nc)
        binned = ts.occ & valid & owned
        limbo = torch.sum(ts.occ & ~valid, dtype=torch.int32)
        return torch.mul(ts.m, binned, out=out), binned, mesh.psum(limbo[None])

    # The column halo: rows wrap locally (every shard holds every row).
    layout = stencil_ops.HaloLayout((nc,), cmaxc, col0=col0, cols_mine=cnt,
                                    y_ge=False)

    def mono_tables(sums):
        """The stencil tables from the per-cell sums of the COM row sums a
        band (``sums``: (3, slots) of m, m·x, m·y): the local grids' sums,
        the column halo, the tables (a zero sentinel cell last)."""
        cells = torch.cat([v.sum(dim=2).view(3, L, rw, wide)
                           for v, (_, rw, _) in zip(views(sums), bands)],
                          dim=2)[..., 1:cmaxc + 1]       # (3, L, nc, cmaxc)
        return stencil_ops.mesh_tables(mesh, layout, [tuple(cells)], side, nc,
                                       from_sums=True)

    def advance(ts, fxd, fyd):
        """Monopole and integrate over the pool (one kernel, in place, a
        binned slot's terms at its row's cell), migration; only the COM row
        sums run a band. (ts, undelivered, limbo)."""
        sums = torch.empty((3, nslots), dtype=ts.x.dtype, device=dev)
        mf, binned, limbo = physics_mass(ts, out=sums[0])
        torch.mul(mf, ts.x, out=sums[1])
        torch.mul(mf, ts.y, out=sums[2])
        advance_ops.gathered_monopole_integrate(
            ts.x, ts.y, ts.vx, ts.vy, ts.m, mf, fxd, fyd, mono_tables(sums),
            cell_of_row, side, DELTAT, runs, binned=binned)
        ts, undelivered = migrate(ts, ship_rounds)
        return ts, undelivered, limbo

    def pair_args(ts):
        mf, binned, _ = physics_mass(ts)
        alive = (binned & (ts.m > 0)).to(torch.int32)
        return list(zip(*(views(a) for a in (ts.x, ts.y, mf, alive,
                                             ts.pid))))

    def pair_pass(ts, collide: bool, out=None):
        """The fused collision(t) + pair-force(t+1) pass, one launch a band
        over every shard's rows of it; (fx, fy, count, died) over the
        pool, the forces written into ``out`` (pool tensors) where given."""
        fxo, fyo = ([[None] * len(bands)] * 2 if out is None
                    else [views(o) for o in out])
        outs = [cell_pairs.fused_pairs(
                    *tiles, k, EPSILON, collide=collide, force_form=form,
                    out=None if out is None else (ox, oy))
                for tiles, (_, _, k), ox, oy in zip(pair_args(ts), bands,
                                                    fxo, fyo)]
        fx, fy, count, ft = zip(*outs)
        if out is None:
            out = (torch.cat([a.reshape(-1) for a in fx]),
                   torch.cat([a.reshape(-1) for a in fy]))
        return (*out,
                mesh.psum(torch.sum(torch.stack(count), dtype=torch.int32)
                          [None]),
                torch.cat([a.reshape(-1) for a in ft]) != cell_pairs.INF)

    pair_tiles, run = res.make_tile_run(
        prologue, advance, pair_args, pair_pass, kmax, side, nc,
        finish=lambda ts, _: tiles_to_slabs(ts, mesh, cap, side, nc,
                                            shard_slots))
    return prologue, pair_tiles, run
