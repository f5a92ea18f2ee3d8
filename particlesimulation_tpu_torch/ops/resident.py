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


def rebin(ts: TileState, side: float, ncside: int, kcap: int):
    """Deliver all movers to their destination rows. Returns (ts', undelivered).

    ``undelivered`` (int32, 0-d) counts the movers beyond their destination
    rows' free slots. When it is nonzero no mover moves: the tiles come back
    unchanged, nothing is lost, and the engine flags overflow and replays the
    run with larger tiles.
    """
    ncells = ncside * ncside
    nslots = ncells * kcap
    dev = ts.x.device
    cx, cy, valid = cell_of(ts.x, ts.y, side, ncside)
    dest = (cy * ncside + cx).to(torch.int64)
    row = torch.arange(ncells, device=dev)[:, None]
    moving = ts.occ & valid & (dest != row)

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
