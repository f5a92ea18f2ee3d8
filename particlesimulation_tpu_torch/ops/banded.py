"""Row-banded resident tiles: per-band capacity without a per-step sort.

Counterpart of the JAX package's ``ops/banded.py``. On a clustered load (the
reference report's UNEVEN, ``-23 5000 100 1000000``: cell occupancy median
21, max 761) one tile capacity for every cell pads the cold cells to the
hottest one's K. Occupancy is spatially coherent, so contiguous bands of
grid rows, each with its own K (``plan_bands``, a boundary DP over the grid
rows), track the profile with static shapes, and the state stays resident
in its slots (no per-step sort). The same split with one K streams large
uniform loads (``uniform_band_plan``, the census's route above
``engine._STREAM_BYTES`` of tile state).

The JAX engine keeps one tile buffer per band with two halo rows, and ships
cross-band movers through the halo rows in a ``while_loop`` of exchange
rounds. Here, as ``ops/resident.rebin`` replaced JAX's delivery rounds, a
GPU scatter delivers every mover in one pass:

* one slot pool: band b's tiles are a contiguous ``(rows_b·ncside, K_b)``
  view of flat per-field tensors at a fixed offset, one row per cell, and
  no halo rows;
* one rebin for all bands (``ops/cuda/advance.deliver`` on the pool's per-row
  starts): a cross-band mover is a mover, landing in the rank-th free slot
  of its destination cell's row wherever that row lies; undelivered movers
  flag overflow and the engine retries losslessly with a grown plan;
* the 8 monopole terms with the integrator, the delivery, the pair
  pass's masks, and after the pair pass the step's tail with the next
  step's cell sums run once over the whole pool, on rows of each band's
  width (``ops/cuda/advance``: four kernels on the GPU); only the fused
  pair kernel runs per band, at its band's K. So the launches a step grow
  with the band count by one, and a run reads nothing back from the device
  but its overflow.

Not ported, because one-pass delivery or the GPU leaves them no function:
the halo rows, their lane budget (``HALO_W``, ``PSIM_BAND_HALO_W``) and the
shipping loop's round slack (``SHIP_SLACK``); the band-major fused step
(``fused=True``, ``SHIP_OVF``, ``PSIM_BANDED_FUSED_BARRIER``), which kept a
band's working set in a TPU's VMEM; the ``PSIM_ABLATE`` debug ablation; and
the compact collision mode (``PSIM_COLLIDE=compact``; block, the JAX
default, is the only mode).
"""

from __future__ import annotations

import numpy as np
import torch

from particlesimulation_tpu_torch.config import DELTAT, EPSILON, SimConfig
from particlesimulation_tpu_torch.ops import binning, dense
from particlesimulation_tpu_torch.ops import resident as res
from particlesimulation_tpu_torch.ops.binning import round_cap
from particlesimulation_tpu_torch.ops.cuda import advance as advance_ops
from particlesimulation_tpu_torch.ops.cuda import cell_pairs

# Cost-model weights of the JAX planner, in pair-lane units: per-slot
# K-proportional traversal, and a fixed cost per band (its default
# PSIM_BAND_PENALTY).
_SLOT_WEIGHT = 220
_BAND_PENALTY = 10_000_000


def plan_bands(hist2d, ncside: int, max_kcap: int):
    """Partition grid rows into bands with per-band tile capacity.

    ``hist2d``: (ncside, ncside) per-cell occupancy census (y-major).
    Returns ``[(row0, rows, kcap), ...]`` covering rows contiguously, or
    None when one band (uniform occupancy) is as good.
    """
    occ = np.asarray(hist2d).reshape(ncside, ncside)
    row_kmax = occ.max(axis=1).astype(np.int64)  # per grid row

    def seg_k(i, j):
        return min(round_cap(int(row_kmax[i:j].max()) * 1.15 + 4), max_kcap)

    def seg_cost(i, j):
        k = seg_k(i, j)
        return ((j - i + 2) * ncside * k * (_SLOT_WEIGHT + k)
                + _BAND_PENALTY)

    # O(n^2) boundary DP over grid rows.
    best = np.full(ncside + 1, np.inf)
    cut = np.zeros(ncside + 1, np.int64)
    best[0] = 0.0
    for j in range(1, ncside + 1):
        for i in range(j):
            c = best[i] + seg_cost(i, j)
            if c < best[j]:
                best[j] = c
                cut[j] = i
    if best[ncside] > 0.7 * seg_cost(0, ncside):
        return None
    bounds = []
    j = ncside
    while j > 0:
        i = int(cut[j])
        bounds.append((i, j))
        j = i
    bounds.reverse()
    return [(i, j - i, seg_k(i, j)) for i, j in bounds]


def plan_bands_cyclic(hist2d, ncside: int, n_shards: int, max_kcap: int):
    """Band plan with boundaries at multiples of ``n_shards`` rows, for the
    block-cyclic mesh (``parallel/sharded_banded``), where every shard owns
    1/n_shards of every band's rows: the same cost model and return shape
    as ``plan_bands``, over super-rows of ``n_shards`` rows (each band's
    cost counts two halo rows a shard); the last band takes the ``ncside %
    n_shards`` rows left over. None where one band is within 30% (uniform
    occupancy) or there are fewer rows than shards."""
    d = int(n_shards)
    if d < 1 or ncside < d:
        return None
    occ = np.asarray(hist2d).reshape(ncside, ncside)
    row_kmax = occ.max(axis=1).astype(np.int64)
    g = ncside // d  # candidate boundaries: 0, d, 2d, ..., g*d (+ tail)

    def hi(j):
        return ncside if j == g else j * d

    def seg_k(i, j):
        return min(round_cap(int(row_kmax[i * d:hi(j)].max()) * 1.15 + 4),
                   max_kcap)

    def seg_cost(i, j):
        k = seg_k(i, j)
        return ((hi(j) - i * d + 2 * d) * ncside * k * (_SLOT_WEIGHT + k)
                + d * _BAND_PENALTY)

    best = np.full(g + 1, np.inf)
    cut = np.zeros(g + 1, np.int64)
    best[0] = 0.0
    for j in range(1, g + 1):
        for i in range(j):
            c = best[i] + seg_cost(i, j)
            if c < best[j]:
                best[j] = c
                cut[j] = i
    if best[g] > 0.7 * seg_cost(0, g):
        return None
    bounds = []
    j = g
    while j > 0:
        i = int(cut[j])
        bounds.append((i, j))
        j = i
    bounds.reverse()
    return [(i * d, hi(j) - i * d, seg_k(i, j)) for i, j in bounds]


def uniform_band_plan(ncside: int, band_rows: int, kcap: int):
    """Equal-rows band plan at one K: the streaming split for uniform loads
    (the census's route above ``engine._STREAM_BYTES`` of tile state)."""
    band_rows = max(1, int(band_rows))
    plan = []
    r = 0
    while r < ncside:
        rows = min(band_rows, ncside - r)
        plan.append((r, rows, kcap))
        r += rows
    return tuple(plan)


def grow_plan(plan, factor: float = 1.5, max_kcap: int = 1 << 30):
    """Lossless-retry growth: every band's capacity scales up."""
    return [(r0, rw, min(round_cap(k * factor), max_kcap))
            for r0, rw, k in plan]


def row_starts(plan, ncside: int, device):
    """The pool's rows of a band plan: each cell row's first slot, in grid
    order, and the pool's end (int64, (ncside² + 1,), on ``device``)."""
    starts, off = [], 0
    for _, rw, k in plan:
        starts.append(off + k * torch.arange(rw * ncside, device=device))
        off += rw * ncside * k
    starts.append(torch.full((1,), off, device=device))
    return torch.cat(starts)


def make_banded_run(config: SimConfig, plan):
    """Build (prologue, pair_tiles, run) of the banded engine over ``plan``,
    ``[(row0, rows, kcap), ...]`` contiguous over the grid rows, as
    ``engine.make_resident_run`` does over one capacity. The step is the
    resident step (carried post-move pair forces, the fused collision(t) +
    pair-force(t+1) pass). ``pair_tiles(state, n_steps)`` gives per band
    the (x, y, mf, alive, pid) tiles that step ``n_steps`` hands its pair
    pass. The pair kernel's force form is ``dense.pair_force_form``'s."""
    side = config.side
    nc = config.ncside
    ncells = config.ncells
    bands = [(int(r0), int(rw), int(k)) for r0, rw, k in plan]
    if bands[0][0] != 0 or any(r0 + rw != nxt[0] for (r0, rw, _), nxt
                               in zip(bands, bands[1:])) or (
            bands[-1][0] + bands[-1][1] != nc):
        raise ValueError(f"band plan {plan} does not cover the {nc} grid "
                         f"rows contiguously")
    if not all(1 <= k <= cell_pairs.MAX_KCAP for _, _, k in bands):
        raise ValueError(f"band plan {plan}: K outside [1, "
                         f"{cell_pairs.MAX_KCAP}]")
    # The epilogue's compaction needs at least N slots.
    sizes = [rw * nc * k for _, rw, k in bands]
    nslots = sum(sizes)
    if nslots < config.n_particles:
        raise ValueError(f"band plan holds {nslots} slots < "
                         f"N={config.n_particles}")
    offs = np.cumsum([0] + sizes).tolist()
    kmax = max(k for _, _, k in bands)
    form = dense.pair_force_form(side)
    geometry = {}

    def geom(dev):
        """``row_starts`` of the plan, made once a device."""
        if dev not in geometry:
            geometry[dev] = row_starts(bands, nc, dev)
        return geometry[dev]

    def views(a):
        """Each band's (..., rows_b·ncside, K_b) view of a (..., slots) pool
        tensor."""
        return [a[..., o:o + s].view(*a.shape[:-1], rw * nc, k)
                for (_, rw, k), o, s in zip(bands, offs, sizes)]

    def prologue(state) -> res.TileState:
        """The particles scattered into their cells' rows, in (cell, pid)
        order. Out-of-range (PANIC2-limbo) particles park in band 0's first
        row, cell 0, in its tail slots from the top down; a cell above its
        band's K, or cell 0 and the limbo above K_0 together, flags
        overflow (lossless retry)."""
        row_start = geom(state.x.device)
        key, _ = binning.cell_keys(state.x, state.y, side, nc)
        key, pid, x, y, vx, vy, m = binning.sort_by_cell(
            key, state.pid, state.x, state.y, state.vx, state.vy, state.m)
        pos, _ = binning.segment_positions(key)
        valid = key < ncells
        kc = torch.clamp(key, max=ncells - 1).to(torch.int64)
        start = row_start[kc]
        ok = valid & (pos < row_start[kc + 1] - start)
        ovf = torch.max(torch.where(valid & ~ok, pos + 1, 0))
        idx = torch.where(ok, start + pos, nslots)
        k0 = bands[0][2]
        idx = torch.where(~valid & (pos < k0), k0 - 1 - pos, idx)
        crowd = (torch.sum(ok & (key == 0), dtype=torch.int32)
                 + torch.sum(~valid, dtype=torch.int32))
        ovf = torch.maximum(ovf, torch.where(crowd > k0, crowd, 0)).to(
            torch.int32)

        def scatter(a, fill=0):
            flat = torch.full((nslots + 1,), fill, dtype=a.dtype,
                              device=a.device)
            flat[idx] = a
            return flat[:nslots]

        return res.TileState(
            x=scatter(x), y=scatter(y), vx=scatter(vx), vy=scatter(vy),
            m=scatter(m),
            occ=scatter(torch.ones_like(m, dtype=torch.bool), False),
            pid=scatter(pid),
            collisions=state.collisions, panics=state.panics,
            overflow=torch.maximum(state.overflow, ovf))

    def pair_args(ts):
        # Zero mf silences unbinned slots in the pair pass: they exert and
        # receive no force and never collide. One launch masks the whole
        # pool; each band takes its views.
        mf, alive = advance_ops.pair_masks(ts.x, ts.y, ts.m, ts.occ, side, nc)
        return list(zip(*(views(a) for a in (ts.x, ts.y, mf, alive,
                                             ts.pid))))

    def pair_pass(ts, collide: bool, out=None):
        """The fused collision(t) + pair-force(t+1) pass, one launch per
        band at its K; (fx, fy, count, ft) over the pool, the forces
        written into ``out`` (pool tensors) where given."""
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
        return (*out, torch.sum(torch.stack(count), dtype=torch.int32),
                torch.cat([a.reshape(-1) for a in ft]))

    def settle(ts, ft, count, undelivered, sums, out=None):
        """The step's tail and the next step's cell sums over the whole
        pool, one kernel on the GPU (``ops/cuda/advance.settle_sums``)."""
        return advance_ops.settle_sums(ts, ft, count, undelivered,
                                       geom(ts.x.device), side, nc, kmax,
                                       sums, out)

    def advance(ts, fxd, fyd, sums):
        """The monopole terms and the integrator (m==0 slots frozen), then
        the delivery of the movers, each once over the whole pool whatever
        the band count; two kernels on the GPU (``ops/cuda/advance``)."""
        row_start = geom(ts.x.device)
        x, y, vx, vy, dest, moving = advance_ops.monopole_integrate(
            ts.x, ts.y, ts.vx, ts.vy, ts.m, ts.occ, fxd, fyd, sums,
            row_start, side, nc, DELTAT)
        return advance_ops.deliver(ts._replace(x=x, y=y, vx=vx, vy=vy),
                                   moving, dest, row_start)

    pair_tiles, run = res.make_tile_run(prologue, advance, pair_args,
                                        pair_pass, kmax, side, nc,
                                        settle=settle)
    return prologue, pair_tiles, run
