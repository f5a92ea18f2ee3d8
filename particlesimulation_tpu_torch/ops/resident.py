"""Slot-resident state and rebinning: move particles between cell tiles.

The resident representation keeps the *state itself* in (ncells, K) slot
tiles and re-bins by moving the few particles that changed cell ("movers")
directly between rows. The JAX package delivers movers in rounds of rolls
and one-hot reductions because a TPU punishes scatters; on a GPU a scatter is
cheap, so ``rebin`` delivers every mover in one pass
(``ops/cuda/advance.deliver``, which also takes rows of different widths in
one slot pool, the banded engine's, and runs a hand-written kernel on the
GPU):

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

from particlesimulation_tpu_torch.ops import graphed
from particlesimulation_tpu_torch.ops.binning import cell_of
from particlesimulation_tpu_torch.ops.cuda import advance as advance_ops


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
    default a slot's row is its cell. ``undelivered`` is
    ``ops/cuda/advance.deliver``'s.
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
    return advance_ops.deliver(ts, moving, dest,
                               torch.arange(ncells + 1, device=dev) * kcap)


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
                  side: float, ncside: int, finish=None, settle=None):
    """(pair_tiles, run) of a slot-resident engine from its phases.

    ``prologue(state)`` lays a state out in tiles; ``pair_args(ts)`` gives
    the pair pass's tile arguments and ``pair_pass(ts, collide)`` runs it;
    ``finish(ts, state)`` gives the run's final state from its tiles and
    its input state (by default ``epilogue``'s SimState on ``ncside``'s cell
    grid). ``run(state, n_steps)`` returns the final state;
    ``pair_tiles(state, n_steps)`` the ``pair_args`` that step ``n_steps``
    of that run hands its pair pass (0: the run's first pass), holes and
    limbo slots as they lie.

    Without ``settle``, ``advance(ts, fxd, fyd)`` runs a step's cell sums,
    monopole, integrate and rebin and returns (ts, undelivered,
    limbo_count), ``pair_pass`` gives (fx, fy, count, died), and the step's
    tail (deaths, counters) is plain torch here, in place.

    With ``settle`` (the resident and banded engines), the tail and the
    next step's cell sums run as one pass after each pair pass:
    ``pair_pass`` gives (fx, fy, count, ft) and ``settle(ts, ft, count,
    undelivered, sums)`` zeroes the dead slots' m and updates the counters
    in place (None skips a part: the first pass kills none and counts
    nothing), and with ``sums`` returns the row sums and counts the limbo
    slots into the panics; ``advance(ts, fxd, fyd, sums)`` takes those
    sums and returns (ts, undelivered). So a run of n steps settles after
    its first pass and after each step's pass with sums, but the last,
    and panics counts the limbo slots of the tiles at the start of steps 1
    to n, as without ``settle``. The run's counters are cloned first: they
    are updated in place. ``pair_pass(ts, collide, out)`` writes a step's
    forces into ``out``, the forces the step's advance read, and
    ``settle(..., out)`` its sums into the sums the advance read, so that
    a step's carry is updated in place.

    ``run`` is a ``graphed.GraphedRun``: the prologue and the first pair pass
    (with its settle) run eagerly, their tiles, forces, sums and counters
    are copied into the run's static carry (``graphed.StepGraph``), and the
    steps replay graphs captured on it at the run's first steps, the
    steady step's and, with ``settle``, the last step's (no sums; the
    JAX package's ``jax.jit`` over ``lax.fori_loop``); ``finish`` reads the
    carry and what it hands out is cloned where it shares the carry's
    memory. The graphs serve every ``n_steps`` and live as long as ``run``;
    a run of 0 steps captures them. ``run.eager`` is the plain loop, each
    step dispatched from Python: the same bits.
    """
    if finish is None:
        def finish(ts, state):
            return epilogue(ts, state.x.shape[0], side, ncside)

    if settle is not None:
        return _settled_run(prologue, advance, pair_args, pair_pass, settle,
                            finish)

    def start(state):
        # The prologue's tiles with the run's own counters, and the forces
        # of the first pass.
        ts = _own_counters(prologue(state))
        fxd, fyd, _, _ = pair_pass(ts, collide=False)
        return ts, fxd, fyd

    def step(ts, fxd, fyd):
        ts, undelivered, limbo_count = advance(ts, fxd, fyd)
        fxd, fyd, count, died = pair_pass(ts, collide=True, out=(fxd, fyd))
        ovf = torch.where(undelivered > 0, kcap + 1, 0).to(torch.int32)
        ts.m.masked_fill_(died, 0.0)
        ts.collisions.add_(count)
        ts.panics.add_(limbo_count)
        ts.overflow.copy_(torch.maximum(ts.overflow, ovf))
        return ts, fxd, fyd

    def pair_tiles(state, n_steps: int):
        if n_steps == 0:
            return pair_args(prologue(state))
        ts, fxd, fyd = start(state)
        for _ in range(n_steps - 1):
            ts, fxd, fyd = step(ts, fxd, fyd)
        return pair_args(advance(ts, fxd, fyd)[0])

    return pair_tiles, graphed.loop_run(start, step,
                                        lambda c, state: finish(c[0], state))


def _own_counters(ts):
    """``ts`` with its counters cloned: a run updates them in place."""
    return ts._replace(collisions=ts.collisions.clone(),
                       panics=ts.panics.clone(),
                       overflow=ts.overflow.clone())


def _settled_run(prologue, advance, pair_args, pair_pass, settle, finish):
    """``make_tile_run``'s (pair_tiles, run) with ``settle``."""

    def start(state):
        # The prologue's tiles; the tiles with the run's own counters after
        # its first pass and their settle, the carried forces and step 1's
        # sums.
        first = prologue(state)
        ts = _own_counters(first)
        fxd, fyd, _, _ = pair_pass(ts, collide=False)
        return first, ts, fxd, fyd, settle(ts, None, None, None, sums=True)

    def step(ts, fxd, fyd, sums, last: bool):
        ts, undelivered = advance(ts, fxd, fyd, sums)
        fxd, fyd, count, ft = pair_pass(ts, collide=True, out=(fxd, fyd))
        sums = settle(ts, ft, count, undelivered, sums=not last, out=sums)
        return ts, fxd, fyd, sums

    def run_eager(state, n_steps: int):
        first, ts, fxd, fyd, sums = start(state)
        if n_steps == 0:
            # The first settle counted step 1's limbo slots: not this run's.
            return finish(ts._replace(panics=first.panics), state)
        for i in range(n_steps):
            ts, fxd, fyd, sums = step(ts, fxd, fyd, sums, i == n_steps - 1)
        return finish(ts, state)

    def middle(ts, fxd, fyd, sums):
        return step(ts, fxd, fyd, sums, False)

    def last(ts, fxd, fyd, sums):
        # No sums after the last pass: the carry keeps the last ones.
        return step(ts, fxd, fyd, sums, True)[:3] + (sums,)

    graphs = graphed.StepGraph()

    def run(state, n_steps: int):
        first, *carry = start(state)
        if n_steps == 0:
            out = finish(carry[0]._replace(panics=first.panics), state)
            del first
            graphs.load(tuple(carry))
            del carry
            graphs.capture("middle", middle)
            graphs.capture("last", last)
            return out
        del first
        graphs.load(tuple(carry))
        del carry
        for _ in range(n_steps - 1):
            graphs.step("middle", middle)
        graphs.step("last", last)
        return graphs.own(finish(graphs.carry()[0], state))

    def pair_tiles(state, n_steps: int):
        if n_steps == 0:
            return pair_args(prologue(state))
        _, ts, fxd, fyd, sums = start(state)
        for _ in range(n_steps - 1):
            ts, fxd, fyd, sums = step(ts, fxd, fyd, sums, False)
        return pair_args(advance(ts, fxd, fyd, sums)[0])

    return pair_tiles, graphed.GraphedRun(run, run_eager, graphs)
