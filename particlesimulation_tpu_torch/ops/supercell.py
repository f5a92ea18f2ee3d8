"""Super-cell resident engine for sparse grids.

Counterpart of the JAX package's ``ops/supercell.py``. On a sparse grid (the
reference's SMALL workload: ncside 1300, N = 5e5, 0.3 particles a cell)
one tile row per cell pads two orders of magnitude of empty slots, so here
one tile row covers an S x S block of cells, a "super-cell", and the tiles
track the particles, not the grid:

* storage: (nsc², K) slot tiles, nsc = ceil(ncside / S); a slot's cell is
  derived from its position each pass (nothing stored);
* pair pass: the resident engine's fused kernel in its labelled form
  (``cell_pairs.fused_pairs(..., sub=)``), the label being the slot's cell
  within its super-cell: pairs interact and collide only within one cell,
  the reference's same-cell rule (serial/parsim.cpp:356-366,393-411);
* monopole: the per-cell mass and moment sums straight onto the true
  (ncside, ncside) grid (``cell_pairs.supercell_cell_sums``), then each
  slot's 8 terms at its own cell from those sums (periodic mirrors at cell
  granularity) and the integration in one kernel
  (``ops/cuda/advance.supercell_monopole_integrate``: each super-cell
  row's neighbourhood staged once; no stencil table is built on the card,
  the plain version builds it);
* rebin: ``ops/resident.rebin`` over the super-cell grid; only super-cell
  crossers move.

S need not divide ncside: edge super-cells then cover fewer cells. The
physics happens at cell granularity on the true grid, so the partition is
only a storage and transport layout. The JAX package has two monopole paths
(a general one and a halo-table one for S | ncside) that its tests hold
equal; the port has one, the general path's function.
"""

from __future__ import annotations

import math

import torch

from particlesimulation_tpu_torch.config import DELTAT, EPSILON, SimConfig
from particlesimulation_tpu_torch.ops import binning, dense
from particlesimulation_tpu_torch.ops import resident as res
from particlesimulation_tpu_torch.ops.cuda import advance as advance_ops
from particlesimulation_tpu_torch.ops.cuda import cell_pairs


def choose_supercell_factor(config: SimConfig, target_occ: float = 24.0,
                            min_nsc: int = 8) -> int | None:
    """S such that a super-cell row holds about ``target_occ`` particles, or
    None where the layout does not apply (average occupancy of 1.5 or more,
    or a grid under 2·min_nsc cells a side). A divisor of ncside within a
    factor 2 of the ideal S is preferred (an even partition)."""
    nc = config.ncside
    avg = config.n_particles / max(1, config.ncells)
    if avg >= 1.5 or nc < 2 * min_nsc:
        return None
    s_ideal = max(2.0, (target_occ / max(avg, 1e-9)) ** 0.5)
    s_max = nc // min_nsc
    if s_max < 2:
        return None
    divs = [d for d in range(2, s_max + 1) if nc % d == 0]
    if divs:
        best = min(divs, key=lambda d: abs(math.log(d / s_ideal)))
        if abs(math.log(best / s_ideal)) <= math.log(2.0):
            return best
    return min(max(2, int(round(s_ideal))), s_max)


def make_supercell_run(config: SimConfig, kcap: int, S: int,
                       pair_impl: str | None = None):
    """Build (prologue, pair_tiles, run) over (nsc², kcap) super-cell tiles,
    as ``engine.make_resident_run`` does over cell tiles. ``pair_tiles``
    gives the labelled pair pass's (x, y, mf, alive, pid, sub) tiles."""
    side = config.side
    nc = config.ncside
    ncells = config.ncells
    nsc = -(-nc // S)
    rows = nsc * nsc
    nslots = rows * kcap
    if pair_impl is None:
        pair_impl = dense.pair_force_form(side)
    if pair_impl not in cell_pairs.FORCE_FORMS:
        # The ungated v1 kernel has no labelled form.
        raise ValueError(f"pair_impl {pair_impl!r}: the supercell pair pass "
                         f"takes {cell_pairs.FORCE_FORMS}")

    def geometry(x, y):
        """Per slot: super-cell row, label (cell within the super-cell),
        true cell key and whether the position is in the box."""
        cx, cy, valid = res.cell_of(x, y, side, nc)
        scx, scy = cx // S, cy // S
        rowk = scy * nsc + scx
        sub = (cy - scy * S) * S + (cx - scx * S)
        return rowk, sub, cy * nc + cx, valid

    def physics(ts):
        """(mf, binned, limbo count, label, true cell) of the tiles: zero
        mf silences out-of-range slots in every physics pass."""
        _, sub, cell, valid = geometry(ts.x, ts.y)
        binned = ts.occ & valid
        limbo_count = torch.sum(ts.occ & ~valid, dtype=torch.int32)
        return torch.where(binned, ts.m, 0.0), binned, limbo_count, sub, cell

    def scatter(idx, a, fill=0):
        flat = torch.full((nslots + 1,), fill, dtype=a.dtype, device=a.device)
        flat[idx] = a
        return flat[:nslots].reshape(rows, kcap)

    def prologue(state) -> res.TileState:
        # One (row, pid) sort: the state is sorted by cell key, which is not
        # monotone in the super-cell row.
        rowk, _, _, valid = geometry(state.x, state.y)
        key = torch.where(valid, rowk, rows)
        key, pid, x, y, vx, vy, m = binning.sort_by_cell(
            key, state.pid, state.x, state.y, state.vx, state.vy, state.m)
        pos, _ = binning.segment_positions(key)
        inbox = key < rows
        kmax = binning.max_occupancy(pos, inbox)
        ovf = torch.where(kmax > kcap, kmax, 0).to(torch.int32)
        ok = inbox & (pos < kcap)
        idx = torch.where(ok, key.to(torch.int64) * kcap + pos, nslots)
        # Out-of-range (PANIC2-limbo) particles park in row 0's tail slots,
        # top down; row 0's residents and them must fit its kcap slots.
        limbo = ~inbox & (pos < kcap)
        idx = torch.where(limbo, kcap - 1 - pos, idx)
        crowd = (torch.sum(ok & (key == 0), dtype=torch.int32)
                 + torch.sum(~inbox, dtype=torch.int32))
        ovf = torch.maximum(ovf, torch.where(crowd > kcap, crowd, 0))
        return res.TileState(
            x=scatter(idx, x), y=scatter(idx, y),
            vx=scatter(idx, vx), vy=scatter(idx, vy), m=scatter(idx, m),
            occ=scatter(idx, torch.ones_like(m, dtype=torch.bool), False),
            pid=scatter(idx, pid),
            collisions=state.collisions, panics=state.panics,
            overflow=torch.maximum(state.overflow, ovf))

    def mono_sums(ts, mf, cell):
        """The true grid's per-cell sums (a binned slot's ``cell``, -1 for
        the others), from which the monopole pass builds its terms."""
        return cell_pairs.supercell_cell_sums(mf, mf * ts.x, mf * ts.y, cell,
                                              ncells)

    def dest_fn(ts):
        rowk, _, _, valid = geometry(ts.x, ts.y)
        rowid = torch.arange(rows, device=ts.x.device)[:, None]
        return ts.occ & valid & (rowk != rowid), rowk

    def pair_args(ts):
        mf, binned, _, sub, _ = physics(ts)
        # Unbinned slots get label -1; they carry mf = 0 and alive = 0.
        sub = torch.where(binned, sub, -1)
        alive = (binned & (ts.m > 0)).to(torch.int32)
        return ts.x, ts.y, mf, alive, ts.pid, sub

    def pair_pass(ts, collide: bool, out=None):
        x, y, mf, alive, pid, sub = pair_args(ts)
        fx, fy, count, ft = cell_pairs.fused_pairs(
            x, y, mf, alive, pid, kcap, EPSILON, collide=collide,
            force_form=pair_impl, sub=sub, out=out)
        return fx, fy, count, ft != cell_pairs.INF

    def advance(ts, fxd, fyd):
        """Phases 1-3 of a step: monopole and integrate (one kernel, in
        place, each binned slot's terms at its own cell from the cell sums,
        the others' the sentinel's), rebin."""
        mf, binned, limbo_count, _, cell = physics(ts)
        cell = torch.where(binned, cell, -1)
        advance_ops.supercell_monopole_integrate(
            ts.x, ts.y, ts.vx, ts.vy, ts.m, mf, fxd, fyd,
            mono_sums(ts, mf, cell), cell, side, nc, DELTAT, S)
        ts, undelivered = res.rebin(ts, side, nsc, kcap, dest_fn=dest_fn)
        return ts, undelivered, limbo_count

    pair_tiles, run = res.make_tile_run(prologue, advance, pair_args,
                                        pair_pass, kcap, side, nc)
    return prologue, pair_tiles, run
