"""Slot-resident state and rebinning: move particles between cell tiles.

The resident representation keeps the *state itself* in (ncells, K) slot
tiles and re-bins by moving the few particles that changed cell ("movers")
directly between rows. The JAX package delivers movers in rounds of rolls
and one-hot reductions because a TPU punishes scatters; on a GPU a scatter is
cheap, so ``rebin`` delivers every mover in one pass:

1. mark the movers (occupied, in range, destination row != current row);
2. sort them stably by (destination row, source slot);
3. give each mover its rank within its destination row;
4. land it in that row's rank-th free slot, where free slots are counted
   after this step's departures;
5. count every mover beyond a row's free slots as undelivered.

Slot order inside a row is free: collision tie-breaks go by pid rank, and
the pair kernel compacts each row's used slots in shared memory itself, so
the tiles are never compacted and keep their holes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from particlesimulation_tpu_torch.ops.binning import segment_positions


class TileState(NamedTuple):
    """Slot-resident simulation state. Tile tensors are (ncells, K)."""

    x: torch.Tensor
    y: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    m: torch.Tensor
    occ: torch.Tensor     # bool: slot holds a particle (alive or dead)
    pid: torch.Tensor     # int32
    collisions: torch.Tensor
    panics: torch.Tensor
    overflow: torch.Tensor


def cell_of(x, y, side: float, ncside: int):
    """Per-slot cell coordinates (int32) and validity (C truncation)."""
    w = torch.full((), side / ncside, dtype=x.dtype, device=x.device)
    cx = (x / w).to(torch.int32)
    cy = (y / w).to(torch.int32)
    valid = (cx >= 0) & (cx < ncside) & (cy >= 0) & (cy < ncside)
    return cx, cy, valid


def binned_mask(ts: TileState, side: float, ncside: int):
    """Occupied slots whose position is in range, and the count of the rest.

    The reference's PANIC2 skip leaves out-of-range particles unbinned but
    integrating; here they stay in their last row, masked out of COM, forces
    and collisions.
    """
    _, _, valid = cell_of(ts.x, ts.y, side, ncside)
    return ts.occ & valid, torch.sum(ts.occ & ~valid, dtype=torch.int32)


def rebin(ts: TileState, side: float, ncside: int, kcap: int, dest_fn=None):
    """Deliver all movers to their destination rows. Returns (ts', undelivered).

    The tiles hold one row per cell of an ``ncside × ncside`` row grid.
    ``dest_fn(ts) -> (moving, dest_row)`` marks the movers and gives each
    slot's destination row on a grid of other rows (the supercell engine's
    super-cells, ``ops/supercell``); by default a slot's row is its cell.

    ``undelivered`` (int32, 0-d) counts the movers beyond their destination
    rows' free slots. When it is nonzero no mover moves: the tiles come back
    unchanged, nothing is lost, and the engine flags overflow and replays the
    run with larger tiles.
    """
    ncells = ncside * ncside
    nslots = ncells * kcap
    dev = ts.x.device
    row = torch.arange(ncells, device=dev)[:, None]
    if dest_fn is None:
        cx, cy, valid = cell_of(ts.x, ts.y, side, ncside)
        dest = (cy * ncside + cx).to(torch.int64)
        moving = ts.occ & valid & (dest != row)
    else:
        moving, dest = dest_fn(ts)
        dest = dest.to(torch.int64)

    # Free slots after departures, and each row's q-th free column.
    free = ~ts.occ | moving
    fr = torch.cumsum(free, dim=1)                       # 1-based free rank
    n_free = fr[:, -1]
    col = torch.arange(kcap, device=dev).expand(ncells, kcap)
    slot_of_rank = torch.full((nslots + 1,), kcap, dtype=torch.int64,
                              device=dev)
    slot_of_rank[torch.where(free, row * kcap + fr - 1, nslots).reshape(-1)] = (
        col.reshape(-1))

    # Movers sorted by (destination row, source slot); rank within the row.
    mkey = torch.where(moving, dest, ncells).reshape(-1)
    mkey, src = torch.sort(mkey, stable=True)
    rank, _ = segment_positions(mkey)
    is_mover = mkey < ncells
    drow = torch.clamp(mkey, max=ncells - 1)
    fits = is_mover & (rank < n_free[drow])
    undelivered = torch.sum(is_mover & ~fits, dtype=torch.int32)
    act = fits & (undelivered == 0)
    tgt = drow * kcap + slot_of_rank[drow * kcap + torch.clamp(rank, max=kcap - 1)]
    # Inactive entries write to a dump slot past the end.
    tgt = torch.where(act, tgt, nslots)
    src_act = torch.where(act, src, nslots)

    def move(a):
        flat = torch.cat([a.reshape(-1), a.new_zeros(1)])
        vals = flat[src]
        flat[tgt] = vals
        return flat[:nslots].reshape(ncells, kcap)

    occ = torch.cat([ts.occ.reshape(-1), ts.occ.new_zeros(1)])
    occ = occ.index_fill_(0, src_act, False).index_fill_(0, tgt, True)
    occ = occ[:nslots].reshape(ncells, kcap)
    m = torch.where(occ, move(ts.m), 0.0)
    out = ts._replace(x=move(ts.x), y=move(ts.y), vx=move(ts.vx),
                      vy=move(ts.vy), m=m, occ=occ, pid=move(ts.pid))
    return out, undelivered


def epilogue(ts: TileState, n: int, side: float, ncside: int):
    """The SimState of tiles holding ``n`` particles: compacted to N
    particle-major arrays and sorted by (cell key, pid), once per run."""
    from particlesimulation_tpu_torch.ops import binning
    from particlesimulation_tpu_torch.state import SimState

    occf = ts.occ.reshape(-1)
    order = torch.argsort((~occf).to(torch.uint8), stable=True)[:n]
    x, y, vx, vy, m, pid, occ = (a.reshape(-1)[order] for a in (
        ts.x, ts.y, ts.vx, ts.vy, ts.m, ts.pid, ts.occ))
    key, _ = binning.cell_keys(x, y, side, ncside)
    key, pid, x, y, vx, vy, m, alive = binning.sort_by_cell(
        key, pid, x, y, vx, vy, m, occ & (m > 0))
    return SimState(x=x, y=y, vx=vx, vy=vy, m=m, alive=alive, pid=pid,
                    collisions=ts.collisions, panics=ts.panics,
                    overflow=ts.overflow)


def make_tile_run(prologue, advance, pair_args, pair_pass, kcap: int,
                  side: float, ncside: int):
    """(pair_tiles, run) of a slot-resident engine from its phases.

    ``prologue(state)`` lays a sorted SimState out in tiles;
    ``advance(ts, fxd, fyd)`` runs a step's monopole, integrate and rebin
    and returns (ts, undelivered, limbo_count); ``pair_args(ts)`` gives the
    pair pass's tile arguments and ``pair_pass(ts, collide)`` runs it, giving
    (fx, fy, count, died). ``run(state, n_steps)`` returns the final SimState
    (on ``ncside``'s cell grid); ``pair_tiles(state, n_steps)`` the
    ``pair_args`` that step ``n_steps`` of that run hands its pair pass (0:
    the run's first pass), holes and limbo slots as they lie.
    """

    def step(ts, fxd, fyd):
        ts, undelivered, limbo_count = advance(ts, fxd, fyd)
        fxd, fyd, count, died = pair_pass(ts, collide=True)
        ovf = torch.where(undelivered > 0, kcap + 1, 0).to(torch.int32)
        ts = ts._replace(
            m=torch.where(died, 0.0, ts.m),
            collisions=ts.collisions + count,
            panics=ts.panics + limbo_count,
            overflow=torch.maximum(ts.overflow, ovf))
        return ts, fxd, fyd

    def run(state, n_steps: int):
        ts = prologue(state)
        fxd, fyd, _, _ = pair_pass(ts, collide=False)
        for _ in range(n_steps):
            ts, fxd, fyd = step(ts, fxd, fyd)
        return epilogue(ts, state.x.shape[0], side, ncside)

    def pair_tiles(state, n_steps: int):
        ts = prologue(state)
        if n_steps > 0:
            fxd, fyd, _, _ = pair_pass(ts, collide=False)
            for _ in range(n_steps - 1):
                ts, fxd, fyd = step(ts, fxd, fyd)
            ts = advance(ts, fxd, fyd)[0]
        return pair_args(ts)

    return pair_tiles, run
