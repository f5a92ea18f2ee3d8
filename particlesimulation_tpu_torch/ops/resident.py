"""Slot-resident state and rebinning: move particles between cell tiles.

The resident representation keeps the *state itself* in (ncells, K) slot
tiles and re-bins by moving the few particles that changed cell ("movers")
directly between rows. The JAX package delivers movers in rounds of rolls
and one-hot reductions because a TPU punishes scatters; on a GPU a scatter is
cheap, so ``rebin`` delivers every mover in one pass (``deliver``, which
also takes rows of different widths in one slot pool, the banded engine's):

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


def rebin(ts: TileState, side: float, ncside: int, kcap: int, dest_fn=None,
          nrows: int | None = None):
    """Deliver all movers to their destination rows. Returns (ts', undelivered).

    The tiles hold one row per cell of an ``nrows × ncside`` row grid
    (``nrows`` defaults to ``ncside``; the mesh engine's stacked local
    grids have each shard's owned rows and two halo rows). ``dest_fn(ts) ->
    (moving, dest_row)`` marks the movers and gives each slot's destination
    row on that grid or on a grid of other rows (the supercell engine's
    super-cells, ``ops/supercell``; the mesh engine's local rows); by
    default a slot's row is its cell. ``undelivered`` is ``deliver``'s.
    """
    ncells = (nrows or ncside) * ncside
    dev = ts.x.device
    if dest_fn is None:
        row = torch.arange(ncells, device=dev)[:, None]
        cx, cy, valid = cell_of(ts.x, ts.y, side, ncside)
        dest = cy * ncside + cx
        moving = ts.occ & valid & (dest != row)
    else:
        moving, dest = dest_fn(ts)
    return deliver(ts, moving, dest,
                   torch.arange(ncells + 1, device=dev) * kcap)


def deliver(ts: TileState, moving, dest, row_start, at=None):
    """Move the ``moving`` slots to rows ``dest``, in one pass.

    The tiles are a pool of slots in which row r holds the contiguous slots
    ``row_start[r]`` to ``row_start[r + 1]`` (flat indices; rows may differ
    in width, as the banded engine's do). A mover lands in its destination
    row's rank-th free slot, free slots counted after this step's departures
    in slot order, its rank being its place among the row's movers sorted by
    source slot. Returns (ts', undelivered): ``undelivered`` (int32, 0-d)
    counts the movers beyond their destination rows' free slots. When it is
    nonzero no mover moves: the tiles come back unchanged, nothing is lost,
    and the engine flags overflow and replays the run with larger tiles.

    ``at`` (int64 flat slot indices, ascending) limits the movers to those
    slots: ``moving`` and ``dest`` are then given for them alone, and the
    sort and the moves cover them alone (the mesh engines' halo slots after
    a ship round). The result is the whole pool's delivery with no mover
    outside ``at``.
    """
    shape = ts.x.shape
    nslots = ts.x.numel()
    nrows = row_start.shape[0] - 1
    dev = ts.x.device
    occf = ts.occ.reshape(-1)
    moving = moving.reshape(-1)
    if at is None:
        leaving = moving
    else:
        leaving = torch.zeros_like(occf).index_put_((at,), moving)

    # Free slots after departures: the free slots before each row (a row's
    # k-th free slot is the pool's (before[r] + k)-th), and the slot of the
    # q-th free slot of the pool.
    free = ~occf | leaving
    cum = torch.cumsum(free, dim=0)                      # 1-based free rank
    before = torch.cat([cum.new_zeros(1), cum])[row_start]
    n_free = before[1:] - before[:-1]

    # Movers sorted by (destination row, source slot); rank within the row.
    mkey = torch.where(moving, dest.reshape(-1).to(torch.int64), nrows)
    mkey, src = torch.sort(mkey, stable=True)
    if at is not None:
        src = at[src]
    rank, _ = segment_positions(mkey)
    is_mover = mkey < nrows
    drow = torch.clamp(mkey, max=nrows - 1)
    fits = is_mover & (rank < n_free[drow])
    undelivered = torch.sum(is_mover & ~fits, dtype=torch.int32)
    act = fits & (undelivered == 0)
    q = torch.clamp(before[drow] + rank, max=nslots)
    if at is None:
        slot_of_free = torch.full((nslots + 1,), nslots, dtype=torch.int64,
                                  device=dev)
        slot_of_free[torch.where(free, cum - 1, nslots)] = torch.arange(
            nslots, device=dev)
        slot = slot_of_free[q]
    else:
        # A few movers: a binary search of the free ranks.
        slot = torch.searchsorted(cum, q + 1)
    # Inactive entries write to a dump slot past the end.
    tgt = torch.where(act, slot, nslots)
    src_act = torch.where(act, src, nslots)

    def move(a):
        flat = torch.cat([a.reshape(-1), a.new_zeros(1)])
        vals = flat[src]
        flat[tgt] = vals
        return flat[:nslots].reshape(shape)

    occ = torch.cat([occf, occf.new_zeros(1)])
    occ = occ.index_fill_(0, src_act, False).index_fill_(0, tgt, True)
    occ = occ[:nslots].reshape(shape)
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
                  side: float, ncside: int, finish=None):
    """(pair_tiles, run) of a slot-resident engine from its phases.

    ``prologue(state)`` lays a state out in tiles; ``advance(ts, fxd,
    fyd)`` runs a step's monopole, integrate and rebin and returns (ts,
    undelivered, limbo_count); ``pair_args(ts)`` gives the pair pass's tile
    arguments and ``pair_pass(ts, collide)`` runs it, giving (fx, fy,
    count, died); ``finish(ts, state)`` gives the run's final state from
    its tiles and its input state (by default ``epilogue``'s SimState on
    ``ncside``'s cell grid). ``run(state, n_steps)`` returns the final
    state; ``pair_tiles(state, n_steps)`` the ``pair_args`` that step
    ``n_steps`` of that run hands its pair pass (0: the run's first pass),
    holes and limbo slots as they lie.
    """
    if finish is None:
        def finish(ts, state):
            return epilogue(ts, state.x.shape[0], side, ncside)

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
        return finish(ts, state)

    def pair_tiles(state, n_steps: int):
        ts = prologue(state)
        if n_steps > 0:
            fxd, fyd, _, _ = pair_pass(ts, collide=False)
            for _ in range(n_steps - 1):
                ts, fxd, fyd = step(ts, fxd, fyd)
            ts = advance(ts, fxd, fyd)[0]
        return pair_args(ts)

    return pair_tiles, run
