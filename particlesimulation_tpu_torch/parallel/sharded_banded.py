"""Block-cyclic banded engine: clustered loads on the 1D mesh by row chunks
(counterpart of the JAX package's ``parallel/sharded_banded.py``).

The row bands of the one-device banded engine (``ops/banded``) are split
across the shards block-cyclically: every shard owns a contiguous chunk of
every band's rows (balanced-uneven, ``cyclic_owner_of_rows``), the chunks
in ring order, global rows ``[B0S0 B0S1 … B0S(D-1) B1S0 …]``. Each shard
then holds one chunk of every band at that band's K, so the shards' shapes
agree, and each samples 1/D of every band, so a spatially coherent load
balances by construction (``ops/banded.plan_bands_cyclic`` plans bands of
whole multiples of D rows, the last taking the rest). Every chunk boundary
lies between ring neighbours: the COM halo and particle shipping are one
``ppermute`` each way (the reference's ghost exchange and migration,
mpi/parsim-mpi.cpp:670-815,512-600).

The edge-shard band shift: chunk (b, s)'s upper neighbour is chunk (b, s-1)
but shard 0's is chunk (b-1, D-1), and chunk (b, s)'s lower neighbour is
(b, s+1) but shard D-1's is (b+1, 0). The halos are stacked per band, so
shard 0 takes what arrives from above rolled one band on, and shard D-1
what arrives from below rolled one band back; at D = 1 both shifts wrap
onto the one shard. A halo row of shard 0 or D-1 therefore receives the
particles of a band of another K.

This engine composes JAX's decomposition with the port's one-pool banded
design (``ops/banded``'s docstring): every band's chunk of every shard,
each with two halo rows at the band's K, lies in one band-major slot pool,
so the fused pair kernel and the COM row sums run once a band over all
shards, the monopole and the integration once over the pool (one kernel,
``ops/cuda/advance.gathered_monopole_integrate``: a binned slot's terms at
its pool row's cell), and a mover whose new row this shard owns moves in
one delivery,
across bands too; a mover bound for another shard parks in its chunk's
halo row toward it, at its own column. One ship round stages the halo
rows of every band at the widest K (no lane is cut: JAX's
``PSIM_BAND_HALO_W`` has no counterpart), ships both ways, applies the edge
shift and lands each cell's arrivals in the receiving halo row's first
slots (arrivals past its K flag the tile overflow, and the ladder grows
the plan), and a delivery of the halo slots moves them on
(``sharded_resident.make_halo_transport``, in place of JAX's psum-gated
ship loop). Capacity overflow anywhere flags ``overflow``; the engine
replays the run; no particle is dropped.
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
    _FIELDS, make_halo_transport, slabs_to_tiles, tiles_to_slabs, wrap_delta)


def cyclic_owner_of_rows(plan, n_shards: int, rows):
    """Owning shard of each global grid row (NumPy) under the block-cyclic
    chunk map: row r of band (r0, rw, _) belongs to the shard whose
    balanced-uneven chunk of that band holds it (the reference's
    ``cell_y / rows_per_proc`` rule, mpi/parsim-mpi.cpp:396-403, with the
    chunks interleaved across bands)."""
    rows = np.asarray(rows)
    out = np.zeros(rows.shape, dtype=np.int64)
    for r0, rw, _ in plan:
        base, rem = divmod(rw, n_shards)
        sel = (rows >= r0) & (rows < r0 + rw)
        off = rows[sel] - r0
        split = rem * (base + 1)
        out[sel] = np.where(off < split, off // (base + 1),
                            rem + (off - split) // max(1, base))
    return out


def cyclic_layout(mesh, rows, C: int, row0, rows_mine):
    """The cyclic bands' COM halo (``ops/cuda/stencil.HaloLayout``): band b
    of ``rows[b]`` rows a chunk, each shard's chunk from global row
    ``row0[b]``, ``rows_mine[b]`` owned ((L,) int64 each); shard 0 takes its
    top halo line from the band above, shard D - 1 its bottom line from
    the band below (the edge-shard band shift), the 1D form's mirrors."""
    return stencil_ops.HaloLayout(
        tuple(rows), C, row0=tuple(row0), rows_mine=tuple(rows_mine),
        top_shift=mesh.shard_ids == 0,
        bot_shift=mesh.shard_ids == mesh.size - 1)


def make_sharded_banded_run(config: SimConfig, mesh, plan, cap: int,
                            ship_rounds: int = 1):
    """Build (prologue, pair_tiles, run) over the mesh's slabs of ``cap``
    slots and the band plan ``[(row0, rows, kcap), ...]`` (contiguous over
    the grid rows, every band at least one row a shard), as
    ``sharded_banded_cols.make_sharded_banded_cols_run`` does:
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
    if any(rw < d for _, rw, _ in bands):
        raise ValueError(f"band plan {plan}: a band of fewer rows than the "
                         f"{d} shards")
    dev = mesh.device
    L = len(mesh.local_shards)
    B = len(bands)
    form = dense.pair_force_form(side)
    sid = mesh.shard_ids
    ks = [k for _, _, k in bands]
    kmax = max(ks)
    cmax = [rw // d + (1 if rw % d else 0) for _, rw, _ in bands]
    nrt = [c + 2 for c in cmax]              # + 2 halo rows a chunk

    def chunk_of(r0, rw, s):
        base, rem = divmod(rw, d)
        return r0 + s * base + min(s, rem), base + (1 if s < rem else 0)

    g0_cnt = torch.tensor([[chunk_of(r0, rw, s) for s in mesh.local_shards]
                           for r0, rw, _ in bands], device=dev)
    G0, CNT = g0_cnt[..., 0], g0_cnt[..., 1]                 # (B, L) each

    # Pool layout, band-major: band b's rows are (shard, chunk row, column)
    # in that order, K_b slots each; chunk row 0 and nrt_b - 1 are halos.
    nrows_b = [L * n * nc for n in nrt]
    sizes = [n * k for n, k in zip(nrows_b, ks)]
    offs = np.cumsum([0] + sizes).tolist()
    rbase = np.cumsum([0] + nrows_b).tolist()
    nslots = offs[-1]
    # The pool's rows as runs of one width, a band each: the row starts
    # and the monopole pass (whose kernel finds a slot's row from the runs)
    # read this one layout.
    runs = tuple(zip(nrows_b, ks))
    row_start = advance_ops.row_starts(runs, dev)
    # Per pool row: local shard, band, chunk row.
    lsh_r, band_r, lr_r = (torch.cat(t) for t in zip(*(
        (torch.arange(L, device=dev).repeat_interleave(n * nc),
         torch.full((L * n * nc,), b, device=dev),
         torch.arange(n, device=dev).repeat_interleave(nc).repeat(L))
        for b, n in enumerate(nrt))))
    rbase_t = torch.tensor(rbase[:-1], device=dev)
    nrt_t = torch.tensor(nrt, device=dev)
    chunk_r = rbase_t[band_r] + lsh_r * nrt_t[band_r] * nc
    row_of = torch.cat([(rb + torch.arange(n, device=dev))
                        .repeat_interleave(k)
                        for rb, n, k in zip(rbase, nrows_b, ks)])
    owned = ((lr_r >= 1) & (lr_r <= CNT[band_r, lsh_r]))[row_of]
    # Per global row: its band and owning shard.
    band_of_row = torch.tensor(np.repeat(np.arange(B),
                                         [rw for _, rw, _ in bands]),
                               device=dev)
    owner_of_row = torch.as_tensor(cyclic_owner_of_rows(bands, d,
                                                        np.arange(nc)),
                                   device=dev)

    def own_row(lsh, gy, gx):
        """Pool row of global cell (gy, gx) in local shard ``lsh``'s chunk
        (meaningful where that shard owns row gy)."""
        b = band_of_row[gy]
        return (rbase_t[b] + (lsh * nrt_t[b] + gy - G0[b, lsh] + 1) * nc
                + gx)

    def views(a):
        """Each band's (..., rows_b, K_b) view of a (..., slots) tensor."""
        return [a[..., o:o + s].view(*a.shape[:-1], n, k)
                for k, o, s, n in zip(ks, offs, sizes, nrows_b)]

    shard_slots = torch.cat([(o + torch.arange(s, device=dev)).view(L, -1)
                             for o, s in zip(offs, sizes)], dim=1)

    def geometry(rows):
        """Per pool row: the row itself, its local shard, chunk row, the
        chunk's first global row, its height with halos, its first pool
        row."""
        lsh, b = lsh_r[rows], band_r[rows]
        return rows, lsh, lr_r[rows], G0[b, lsh], nrt_t[b], chunk_r[rows]

    def dest(x, y, occ, row, lsh, lr, g0, nrt_b, chunk):
        """Movers and their destination rows: to the particle's own cell if
        this shard owns its row (any band), else to its chunk's halo row
        toward it (by the minimal image from its row; an arrival in a halo
        row goes on to the opposite one), at its column."""
        cx, cy, valid = res.cell_of(x, y, side, nc)
        gy, gx = (torch.clamp(c, 0, nc - 1) for c in (cy, cx))
        up = torch.where(lr == 0, False, torch.where(
            lr == nrt_b - 1, True, wrap_delta(cy - (g0 + lr - 1), nc) < 0))
        away = chunk + torch.where(up, 0, (nrt_b - 1) * nc) + gx
        to = torch.where(owner_of_row[gy] == sid[lsh], own_row(lsh, gy, gx),
                         away)
        return occ & valid & (to != row), to

    # The halo rows' slots: (L, sum_b nc * K_b) for the top halos and the
    # bottom ones, band by band; their places in a staging of (B, nc,
    # kmax) lanes a shard; and each staging lane's slot in the pool (lanes
    # past a band's K read slot 0 and are masked).
    def halo_rows(lr_of_band):
        per, lane = [], []
        for b, (o, k, n) in enumerate(zip(offs, ks, nrt)):
            rows = ((torch.arange(L, device=dev)[:, None] * n
                     + lr_of_band(n)) * nc + torch.arange(nc, device=dev))
            slots = o + rows[:, :, None] * k + torch.arange(k, device=dev)
            per.append(slots.reshape(L, -1))
            lane.append(torch.nn.functional.pad(slots, (0, kmax - k),
                                                value=-1))
        return torch.cat(per, dim=1), torch.stack(lane, dim=1).reshape(L, -1)

    top_slots, top_lanes = halo_rows(lambda n: 0)
    bot_slots, bot_lanes = halo_rows(lambda n: n - 1)
    staged_at = torch.cat([
        (b * nc * kmax + torch.arange(nc, device=dev)[:, None] * kmax
         + torch.arange(k, device=dev)).reshape(-1)
        for b, k in enumerate(ks)])
    k_lane = torch.tensor(ks, device=dev)[None, :, None, None]

    def ship(ts):
        """One round both ways, in place: the bottom halos go to the next
        shard's top halos, the top halos to the previous shard's bottom
        ones, each staged at kmax lanes a cell; shard 0 takes its arrivals
        from above one band on, shard D-1 those from below one band back;
        a cell's arrivals fill the receiving halo cell's first slots.
        Returns the (L,) count of arrivals past a receiving cell's K."""
        def stage(lanes):
            out = {f: getattr(ts, f).view(-1)[lanes.clamp(min=0)]
                   for f in _FIELDS}
            out["occ"] = out["occ"] & (lanes >= 0)
            return out

        down, up = stage(bot_lanes), stage(top_lanes)
        dropped = 0
        for arrived, shift, edge, slots in (
                (mesh.ppermute(down, 1), 1, sid == 0, top_slots),
                (mesh.ppermute(up, -1), -1, sid == d - 1, bot_slots)):
            arrived = {f: torch.where(edge[:, None, None],
                                      torch.roll(v.view(L, B, -1), shift, 1),
                                      v.view(L, B, -1)).view(L, B, nc, kmax)
                       for f, v in arrived.items()}
            occ = arrived["occ"]
            rank = torch.cumsum(occ.to(torch.int32), dim=-1) - 1
            dropped = dropped + torch.sum(occ & (rank >= k_lane),
                                          dim=(1, 2, 3), dtype=torch.int32)
            to = torch.where(occ, rank, kmax)
            for f, v in arrived.items():
                comp = v.new_zeros(L, B, nc, kmax + 1).scatter_(-1, to, v)
                getattr(ts, f).view(-1)[slots] = comp[..., :kmax].reshape(
                    L, -1)[:, staged_at]
        return dropped

    migrate = make_halo_transport(
        mesh, [(ship, torch.cat([top_slots, bot_slots], dim=1))], row_start,
        row_of, geometry, dest)

    def prologue(slab) -> res.TileState:
        """Each shard's sorted slab into its chunk tiles; out-of-range
        particles park in band 0's first owned row, column 0."""
        x, y, valid = (a.view(L, -1) for a in (slab.x, slab.y, slab.valid))
        key, in_range = binning.cell_keys(x, y, side, nc)
        gy = torch.where(in_range, key // nc, 0)
        gx = torch.where(in_range, key - gy * nc, 0)
        lsh = torch.arange(L, device=dev)
        mine = owner_of_row[gy] == sid[:, None]
        stray = torch.sum(valid & in_range & ~mine, dim=1)
        return slabs_to_tiles(slab, mesh, own_row(lsh[:, None], gy, gx),
                              valid & in_range & mine, valid & ~in_range,
                              stray, rbase[0] + (lsh * nrt[0] + 1) * nc,
                              row_start, nslots, (nslots,))

    def physics_mass(ts, out=None):
        """(mf, binned, limbo count): zero mf keeps unbinned slots (out of
        range, or in a halo row) out of every physics pass."""
        _, _, valid = res.cell_of(ts.x, ts.y, side, nc)
        binned = ts.occ & valid & owned
        limbo = torch.sum(ts.occ & ~valid, dtype=torch.int32)
        return torch.mul(ts.m, binned, out=out), binned, mesh.psum(limbo[None])

    # Each pool row's cell in the bands' stacked stencil tables
    # (meaningful on owned rows).
    tbase = np.cumsum([0] + [L * c * nc for c in cmax]).tolist()
    cell_of_row = torch.cat([
        tb + ((torch.arange(L, device=dev)[:, None] * c
               + torch.arange(-1, n - 1, device=dev)) * nc)[..., None]
        .expand(L, n, nc).reshape(-1) + torch.arange(nc, device=dev).repeat(
            L * n)
        for tb, c, n in zip(tbase, cmax, nrt)])

    layout = cyclic_layout(mesh, cmax, nc,
                           [G0[b].contiguous() for b in range(B)],
                           [CNT[b].contiguous() for b in range(B)])

    def mono_tables(sums):
        """The stencil tables from the per-cell sums of the COM row sums a
        band (``sums``: (3, slots) of m, m·x, m·y): each chunk's COM grid,
        the cyclic halo, the tables, stacked band by band (a zero sentinel
        cell last)."""
        grids = [tuple(v.sum(dim=2).view(3, L, n, nc)[:, :, 1:c + 1])
                 for v, n, c in zip(views(sums), nrt, cmax)]
        return stencil_ops.mesh_tables(mesh, layout, grids, side, nc,
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
        over every shard's chunk of it; (fx, fy, count, died) over the
        pool, the forces written into ``out`` (pool tensors) where given."""
        fxo, fyo = ([[None] * len(ks)] * 2 if out is None
                    else [views(o) for o in out])
        outs = [cell_pairs.fused_pairs(
                    *tiles, k, EPSILON, collide=collide, force_form=form,
                    out=None if out is None else (ox, oy))
                for tiles, k, ox, oy in zip(pair_args(ts), ks, fxo, fyo)]
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
