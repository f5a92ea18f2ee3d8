"""Occupancy-classed dense tiles for clustered (high-variance) grids.

Counterpart of the JAX package's ``ops/tiered.py``. On a clustered load (the
reference harness's normal-mode ``-seed`` inits, serial/parsim.cpp:220-232)
one hot cell would size every cell's tile row in the single-tier dense
engine. Here cells are grouped by occupancy into T classes with static caps
k_0 < k_1 < ... < k_{T-1}: class 0 keeps a row for every cell (row = cell
id), and each higher class holds a compact, census-budgeted row list. All
classes live in one flat slot buffer, so the tile build is one scatter per
field and the force readback one gather; each class's tiles are a view of
that buffer, and the dense engine's two kernels run on each view.

Capacity comes from a host-side occupancy census (``plan_tiers``) and is
guarded on the device: occupancy beyond the top cap flags
``state.overflow`` positive, a class row-budget deficit flags it negative,
and the engine's lossless retry ladder re-plans.
"""

from __future__ import annotations

import numpy as np
import torch

from particlesimulation_tpu_torch.config import DELTAT, EPSILON, SimConfig
from particlesimulation_tpu_torch.ops import (binning, collisions, graphed,
                                              integrate, stencil)
from particlesimulation_tpu_torch.ops.cuda import cell_pairs
from particlesimulation_tpu_torch.state import SimState

INF = cell_pairs.INF

# Cost-model weights of the JAX planner (pair-lane units): a fixed charge
# per extra class, and the linear per-slot passes.
_CLASS_PENALTY = 8_000_000
_SLOT_WEIGHT = 24


def plan_tiers(occ_hist, ncells: int, max_kcap: int):
    """Choose class caps and row budgets from a host-side occupancy census.

    Returns ``[(cap_0, rows_0=ncells), (cap_1, rows_1), ...]`` (caps
    ascending, row budgets census * 1.3 headroom) minimising
    ``sum rows*k^2 + slot/class overheads`` by a boundary DP over
    32-multiples, or None when the best ladder saves < 40% of the
    single-tier cost. Of equal costs the first cap in ascending order wins,
    as in the JAX planner.
    """
    occ = np.asarray(occ_hist)
    maxocc = int(occ.max()) if occ.size else 0
    top = min(binning.round_cap(maxocc * 1.1 + 4), max_kcap)
    single = ncells * top * top + _SLOT_WEIGHT * ncells * top
    caps = list(range(32, top, 32)) + [top]
    # Occupancy counts above each candidate boundary.
    above = {k: int((occ > k).sum()) for k in [0] + caps}
    # tail[k]: the cheapest (cost, plan) of the classes above cap k.
    tail = {top: (0, ())}

    def cheapest(prev: int, first: bool):
        best = None
        for k in caps:
            if k <= prev:
                continue
            rows = (ncells if first else
                    max(32, -(-int((above[prev] - above[k]) * 1.3) // 32) * 32))
            cost, plan = tail[k]
            cand = (rows * k * k + _SLOT_WEIGHT * rows * k + _CLASS_PENALTY
                    + cost, ((k, rows),) + plan)
            if best is None or cand[0] < best[0]:
                best = cand
        return best

    for prev in reversed(caps[:-1]):
        tail[prev] = cheapest(prev, False)
    cost, plan = cheapest(0, True)
    if cost > 0.6 * single or len(plan) < 2:
        return None
    return list(plan)


def make_tiered_step(config: SimConfig, plan, device):
    """Fast f32 step over occupancy-classed dense tiles on ``device``.

    ``plan``: [(cap, rows), ...] caps ascending, rows_0 == ncells. Mirrors
    ``engine.make_dense_step`` (same step sequence, same carried post-move
    tiles) with the tile build and consumption split across the classes;
    ``run`` is a ``graphed.GraphedRun`` on the carry (state, tiles), the
    plan's sizes fixed here at build time. Returns (step, build_tiles,
    run).
    """
    side = config.side
    nc = config.ncside
    ncells = config.ncells
    plan = [(int(k), int(r)) for k, r in plan]
    caps = [k for k, _ in plan]
    rows = [r for _, r in plan]
    if caps != sorted(set(caps)) or rows[0] != ncells:
        raise ValueError(f"plan {plan}: caps must ascend and rows_0 be "
                         f"{ncells}")
    T = len(plan)
    offs = [0]
    for k, r in plan:
        offs.append(offs[-1] + r * k)
    total = offs[-1]
    # Constant tables, made once here: a host-to-device copy inside the run
    # loop would synchronise the stream.
    dev = torch.device(device)
    caps_a = torch.tensor(caps, dtype=torch.int64, device=dev)
    rows_a = torch.tensor(rows, dtype=torch.int64, device=dev)
    offs_a = torch.tensor(offs[:-1], dtype=torch.int64, device=dev)
    cell_ids = torch.arange(ncells, dtype=torch.int64, device=dev)
    row_ids = [torch.arange(r, dtype=torch.int64, device=dev) for r in rows]

    def scatter(idx, a):
        flat = a.new_zeros(total + 1)  # the last slot takes dropped entries
        flat[idx] = a
        return flat[:total]

    def build_tiles(state: SimState):
        """Classed tiles (one flat slot buffer) and index maps."""
        key, valid = binning.cell_keys(state.x, state.y, side, nc)
        key = key.to(torch.int64)
        pos, _ = binning.segment_positions(key)
        occ = torch.zeros(ncells + 1, dtype=torch.int64, device=dev)
        occ = occ.index_add_(0, key, torch.ones_like(key))[:ncells]
        kmax = torch.max(occ)
        # Class of each cell: first cap >= occ (the top class for over-cap
        # cells too: they overflow, flagged below).
        cls = torch.clamp(torch.searchsorted(caps_a, occ), max=T - 1)
        # Row of each cell within its class: class 0 is identity; higher
        # classes are compact rank lists.
        row_of_cell = cell_ids
        ids, ncls = [], []
        deficit = torch.zeros((), dtype=torch.int64, device=dev)
        for t in range(1, T):
            sel = cls == t
            n_t = torch.sum(sel)
            rank = torch.cumsum(sel, dim=0) - 1
            row_of_cell = torch.where(sel, rank, row_of_cell)
            ids_t = torch.zeros(rows[t] + 1, dtype=torch.int64, device=dev)
            ids_t[torch.where(sel & (rank < rows[t]), rank, rows[t])] = cell_ids
            ids.append(ids_t[:rows[t]])
            ncls.append(n_t)
            deficit = torch.maximum(deficit, n_t - rows[t])
        # Overflow telemetry: positive = occupancy needs a top cap of at
        # least that; negative = the worst class row deficit.
        ovf = torch.where(kmax > caps[-1], kmax, 0)
        ovf = torch.where((ovf == 0) & (deficit > 0), -deficit, ovf)

        kc = torch.clamp(key, max=ncells - 1)
        cls_p = cls[kc]
        k_p = caps_a[cls_p]
        row_p = row_of_cell[kc]
        ok = valid & (pos < k_p) & (row_p < rows_a[cls_p])
        idx = torch.where(ok, offs_a[cls_p] + row_p * k_p + pos, total)
        return {"xf": scatter(idx, state.x), "yf": scatter(idx, state.y),
                "mf": scatter(idx, state.m), "idx": idx, "ok": ok,
                "ids": ids, "ncls": ncls, "ovf": ovf.to(torch.int32),
                "panic": torch.sum(~valid, dtype=torch.int32)}

    def views(flat):
        return [flat[offs[t]:offs[t + 1]].view(rows[t], caps[t])
                for t in range(T)]

    def slot_of(tiles):
        # Each particle's slot (clamped where it has none: ok is False).
        return torch.clamp(tiles["idx"], max=total - 1)

    def gather(flat, tiles):
        return torch.where(tiles["ok"], flat[slot_of(tiles)], 0.0)

    def step(state: SimState, tiles):
        ovf = tiles["ovf"]
        xs, ys, ms = views(tiles["xf"]), views(tiles["yf"]), views(tiles["mf"])

        # Per-cell COM: class-0 rows are cell-indexed; higher classes merge
        # by adding onto distinct cells, whose class-0 rows are all zero, so
        # the sums are exact. Unused class rows add onto a dump row.
        tgts = [torch.where(row_ids[t] < tiles["ncls"][t - 1],
                            tiles["ids"][t - 1], ncells) for t in range(1, T)]

        def merged(parts):
            out = torch.cat([parts[0], parts[0].new_zeros(1)])
            for tgt, part in zip(tgts, parts[1:]):
                out.index_add_(0, tgt, part)
            return out[:ncells]

        ml, mxl, myl = stencil.tables_from_sums(
            merged([torch.sum(m, dim=1) for m in ms]),
            merged([torch.sum(m * x, dim=1) for m, x in zip(ms, xs)]),
            merged([torch.sum(m * y, dim=1) for m, y in zip(ms, ys)]),
            side, nc)

        fxs, fys = [], []
        for t in range(T):
            if t == 0:
                tables = (ml, mxl, myl)
            else:
                ids = tiles["ids"][t - 1]
                tables = (ml[ids], mxl[ids], myl[ids])
            fx_t, fy_t = cell_pairs.dense_pairwise_forces(
                xs[t], ys[t], ms[t], *tables, caps[t])
            fxs.append(fx_t.reshape(-1))
            fys.append(fy_t.reshape(-1))
        fx = gather(torch.cat(fxs), tiles)
        fy = gather(torch.cat(fys), tiles)

        x, y, vx, vy = integrate.integrate(state.x, state.y, state.vx,
                                           state.vy, state.m, fx, fy, side,
                                           DELTAT)

        # Post-move rebin: one sort per step, fresh tiles (used by the
        # collision pass now and as next step's binning).
        key2, _ = binning.cell_keys(x, y, side, nc)
        _, pid, x, y, vx, vy, m, alive = binning.sort_by_cell(
            key2, state.pid, x, y, vx, vy, state.m, state.alive)
        tiles2 = build_tiles(state._replace(x=x, y=y, vx=vx, vy=vy, m=m,
                                            alive=alive, pid=pid))
        ovf = _merge_ovf(ovf, tiles2["ovf"])

        # Collisions per class. Slot order is (key, pid)-sorted in every
        # class, so slot order is bucket order (no pid tiles needed).
        xs2, ys2, ms2 = (views(tiles2["xf"]), views(tiles2["yf"]),
                         views(tiles2["mf"]))
        counts, fts = [], []
        for t in range(T):
            alive_t = (ms2[t] > 0).to(torch.int32)
            cnt_t, ft_t = cell_pairs.dense_collisions(
                xs2[t], ys2[t], alive_t, caps[t], EPSILON)
            counts.append(cnt_t)
            fts.append(ft_t.reshape(-1))
        dead_slot = torch.cat(fts) != INF
        died = tiles2["ok"] & dead_slot[slot_of(tiles2)]
        m, alive = collisions.apply_deaths(m, alive, died)
        # Deaths in tile space keep the carried mass tiles consistent.
        tiles2["mf"] = torch.where(dead_slot, 0.0, tiles2["mf"])
        tiles2["ovf"] = ovf

        out = state._replace(
            x=x, y=y, vx=vx, vy=vy, m=m, alive=alive, pid=pid,
            collisions=state.collisions + torch.sum(torch.stack(counts)),
            panics=state.panics + tiles["panic"],
            overflow=_merge_ovf(state.overflow, ovf))
        return out, tiles2

    run = graphed.loop_run(lambda state: (state, build_tiles(state)), step,
                           lambda carry, state: carry[0])
    return step, build_tiles, run


def _merge_ovf(a, b):
    """Merge overflow telemetry: positive (occupancy need) dominates,
    otherwise the most negative row deficit."""
    return torch.where((a > 0) | (b > 0), torch.maximum(a, b),
                       torch.minimum(a, b))
