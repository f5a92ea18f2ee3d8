"""Sharded super-cell engine: sparse grids on the 1D mesh (counterpart of
the JAX package's ``parallel/sharded_supercell.py``).

The reference runs every workload distributed, its sparse SMALL (ncside
1300, N = 5e5, 0.3 particles a cell) too, under the same row decomposition
(reference mpi/run_tests.sh:8-16), where work per rank scales with the grid,
not the particles. On one device the answer to that regime is the super-cell
engine (``ops/supercell``: one tile row per S x S block of cells); this is
its composition with the mesh. Each shard owns a block of super-rows of the
(nsc, nsc) super-cell grid (``sc_row_starts``), so the sharded resident
engine's halo design (``parallel/sharded_resident``) applies at super-row
granularity:

* local tiles: ``(scrows_max + 2) · nsc`` rows of K, one halo super-row a
  side; every local shard's tiles sit in one pool, so each pass and each
  kernel launch covers all shards;
* migration: one delivery over the pool (an emigrant into the halo
  super-row toward its super-row), then ship rounds of the halo super-rows
  to the ring neighbours, each followed by a delivery of the halo slots
  alone (``sharded_resident.make_halo_transport``);
* pairs: the labelled fused kernel (``cell_pairs.fused_pairs(..., sub=)``),
  a slot's label its cell within its super-cell, -1 for unbinned slots and
  for the halo super-rows (a residue there never pairs: it raises
  ``SHIP_OVF`` and the run replays);
* COM and monopole at cell granularity: the per-cell M, Σm·x and Σm·y by
  the cell sums kernel onto each shard's local cell grid (its owned
  super-rows' S cell rows each), one boundary cell row of sums exchanged
  each way (``ops/cuda/stencil.exchange``; the reference's ghost-cell COM
  halo, mpi/parsim-mpi.cpp:670-815), and each slot's 8 terms built at its
  cell from the sums and those lines with the integration in one kernel
  (``ops/cuda/advance.supercell_monopole_integrate``, as ``ops/supercell``
  does; the plain version builds the halo tables). The JAX engine's
  one-hot contractions are a layout for a TPU's matrix unit.

Requires ``ncside % S == 0`` (shard boundaries at super-rows are cell-row
boundaries) and ``nsc >= n_shards`` (``supercell_shard_viable``). Capacity
overflow anywhere flags ``overflow`` and the engine replays the run with
larger tiles; no particle is dropped.
"""

from __future__ import annotations

import torch

from particlesimulation_tpu_torch.config import DELTAT, EPSILON, SimConfig
from particlesimulation_tpu_torch.ops import dense
from particlesimulation_tpu_torch.ops import resident as res
from particlesimulation_tpu_torch.ops.cuda import advance as advance_ops
from particlesimulation_tpu_torch.ops.cuda import cell_pairs
from particlesimulation_tpu_torch.ops.cuda import stencil as stencil_ops
from particlesimulation_tpu_torch.parallel.sharded_resident import (
    halo_dest_row, halo_row_slots, index_ship, make_halo_transport,
    slabs_to_tiles, tiles_to_slabs)


def sc_row_starts(nsc: int, d: int) -> tuple:
    """Balanced-uneven super-row split, the first ``nsc % d`` shards one
    super-row more (``config.row0_of_shard``'s rule); d + 1 boundaries."""
    base, rem = divmod(nsc, d)
    starts = [0]
    for i in range(d):
        starts.append(starts[-1] + base + (1 if i < rem else 0))
    return tuple(starts)


def supercell_shard_viable(config: SimConfig, S: int | None) -> bool:
    """Whether the sharded super-cell layout applies to this config."""
    if S is None or S < 2 or config.ncside % S != 0:
        return False
    return config.ncside // S >= max(2, config.n_shards)


def make_sharded_supercell_run(config: SimConfig, mesh, kcap: int, cap: int,
                               S: int, ship_rounds: int = 1):
    """Build (prologue, pair_tiles, run) over the mesh's slabs of ``cap``
    slots at tile capacity ``kcap`` and super-cell factor ``S``, as
    ``sharded_resident.make_sharded_resident_run`` does;
    ``pair_tiles(state, n_steps)`` gives the labelled pair pass's (x, y, mf,
    alive, pid, sub) tiles, every local shard's stacked."""
    side = config.side
    nc = config.ncside
    if not supercell_shard_viable(config, S):
        raise ValueError(f"S={S}: the sharded super-cell layout needs S | "
                         f"ncside={nc} and ncside/S >= {config.n_shards}")
    nsc = nc // S
    dev = mesh.device
    L = len(mesh.local_shards)
    starts = sc_row_starts(nsc, config.n_shards)
    scrows_max = max(b - a for a, b in zip(starts, starts[1:]))
    nrows_t = scrows_max + 2                 # + 2 halo super-rows
    ncells_t = nrows_t * nsc                 # tile rows of one shard
    rows_cells = scrows_max * S              # cell rows of a local grid
    ncl = rows_cells * nc                    # cells of a local grid
    nslots = L * ncells_t * kcap
    form = dense.pair_force_form(side)
    row0 = torch.tensor([starts[s] for s in mesh.local_shards], device=dev)
    rows_mine = torch.tensor([starts[s + 1] - starts[s]
                              for s in mesh.local_shards], device=dev)
    lpos = torch.arange(L, device=dev)[:, None]
    row_start = torch.arange(L * ncells_t + 1, device=dev) * kcap
    trow = torch.arange(L * ncells_t, device=dev)[:, None]
    shard_t = trow // ncells_t
    lrow = trow % ncells_t // nsc
    owned_row = (lrow >= 1) & (lrow <= rows_mine[shard_t])
    cell0_t = shard_t * ncl - row0[shard_t] * S * nc  # local cell of (0, 0)
    # The cell rows of each pool row's shard.
    cy0_t, cy1_t = row0[shard_t] * S, (row0 + rows_mine)[shard_t] * S

    def geometry(rows):
        """Per pool row: its shard, local super-row and super-column, and
        the shard's first super-row and owned super-row count."""
        shard = rows // ncells_t
        return (shard, rows % ncells_t // nsc, rows % nsc, row0[shard],
                rows_mine[shard])

    def dest(x, y, occ, shard, lr, col, r0, mine_n):
        """Movers and their destination rows: a particle of this shard's
        super-rows goes to its super-cell, another to the halo super-row
        toward its super-row, at its super-column."""
        cx, cy, valid = res.cell_of(x, y, side, nc)
        scx = cx // S
        dest_y = halo_dest_row(cy // S, r0, mine_n, lr, nrows_t, nsc)
        moving = occ & valid & ((dest_y != lr) | (scx != col))
        return moving, ((shard * nrows_t + dest_y) * nsc
                        + torch.clamp(scx, 0, nsc - 1))

    migrate = make_halo_transport(
        mesh, [index_ship(mesh, *halo_row_slots(L, nrows_t, nsc, kcap, dev))],
        row_start, trow, geometry, dest)

    def prologue(slab) -> res.TileState:
        """Each shard's sorted slab into its super-cell tiles, a tile's
        particles in pid order."""
        x, y, valid = (a.view(L, -1) for a in (slab.x, slab.y, slab.valid))
        cx, cy, in_range = res.cell_of(x, y, side, nc)
        scy = cy // S
        mine = (scy >= row0[:, None]) & (scy < (row0 + rows_mine)[:, None])
        stray = torch.sum(valid & in_range & ~mine, dim=1)
        row = lpos * ncells_t + (scy - row0[:, None] + 1) * nsc + cx // S
        return slabs_to_tiles(slab, mesh, row, valid & in_range & mine,
                              valid & ~in_range, stray,
                              lpos[:, 0] * ncells_t + nsc, row_start, nslots,
                              (L * ncells_t, kcap))

    def physics(ts):
        """(mf, binned, limbo count, label, local cell): zero mf and label
        -1 keep unbinned slots (out of range, or in a halo super-row) out
        of every physics pass."""
        cx, cy, valid = res.cell_of(ts.x, ts.y, side, nc)
        # A particle a full row could not take (the run's tile overflow:
        # it replays) stays in its slot, maybe outside its shard's cell
        # rows: it bins nowhere, so that every cell index lies on its
        # shard's grid (this rank's alone on a DistMesh).
        binned = ts.occ & valid & owned_row & (cy >= cy0_t) & (cy < cy1_t)
        limbo = torch.sum((ts.occ & ~valid).view(L, -1), dim=1,
                          dtype=torch.int32)
        sub = (cy % S) * S + cx % S
        return (torch.where(binned, ts.m, 0.0), binned, mesh.psum(limbo),
                torch.where(binned, sub, -1),
                torch.where(binned, cell0_t + cy * nc + cx, -1))

    # The cell rows' COM halo: each shard's cell rows start at row0 * S.
    layout = stencil_ops.HaloLayout((rows_cells,), nc, row0=(row0 * S,),
                                    rows_mine=(rows_mine * S,))

    def mono_sums(ts, mf, cell):
        """The local cell grids' sums and the boundary cell rows' halo
        lines, from which the monopole pass builds each slot's terms at its
        cell."""
        sums = cell_pairs.supercell_cell_sums(mf, mf * ts.x, mf * ts.y,
                                              cell.to(torch.int32), L * ncl)
        grids = [tuple(a.view(L, rows_cells, nc) for a in sums)]
        return sums, stencil_ops.exchange(mesh, layout, grids)

    def advance(ts, fxd, fyd):
        """Monopole and integrate (one kernel, in place, each slot's terms
        at its cell from the sums, an unbinned slot's the sentinel's),
        migration; (ts, undelivered, limbo)."""
        mf, _, limbo, _, cell = physics(ts)
        sums, lines = mono_sums(ts, mf, cell)
        advance_ops.supercell_monopole_integrate(
            ts.x, ts.y, ts.vx, ts.vy, ts.m, mf, fxd, fyd, sums, cell, side,
            nc, DELTAT, S, layout=layout, lines=lines)
        ts, undelivered = migrate(ts, ship_rounds)
        return ts, undelivered, limbo

    def pair_args(ts):
        mf, binned, _, sub, _ = physics(ts)
        alive = (binned & (ts.m > 0)).to(torch.int32)
        return ts.x, ts.y, mf, alive, ts.pid, sub.to(torch.int32)

    def pair_pass(ts, collide: bool, out=None):
        x, y, mf, alive, pid, sub = pair_args(ts)
        fx, fy, count, ft = cell_pairs.fused_pairs(
            x, y, mf, alive, pid, kcap, EPSILON, collide=collide,
            force_form=form, sub=sub, out=out)
        return fx, fy, mesh.psum(count[None]), ft != cell_pairs.INF

    pair_tiles, run = res.make_tile_run(
        prologue, advance, pair_args, pair_pass, kcap, side, nc,
        finish=lambda ts, _: tiles_to_slabs(ts, mesh, cap, side, nc))
    return prologue, pair_tiles, run
