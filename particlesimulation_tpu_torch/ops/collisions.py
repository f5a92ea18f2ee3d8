"""Collision detection and merge with the reference's set-counting rule.

Reference semantics (serial/parsim.cpp:388-420): per cell, scan pairs (j, k)
with j < k in bucket order; a pair closer than EPSILON is a collision; the
counter increments only when *neither* endpoint is already in the cell's
per-step collision set; every set member then dies (alive=false, m=0).

``in_set[p]`` at the time pair (j,k) is visited ⇔ some colliding pair
lexicographically earlier involves p. Hence a pair (j,k) increments the
counter iff it is the lexicographically-first colliding pair for BOTH
endpoints. With ``first_rank[p] = min(rank of colliding pairs involving p)``:

    count = #{ colliding (j,k) : rank(j,k) == first_rank[j] == first_rank[k] }
    dies(p) = first_rank[p] < INF

Pair ranks are int64 ``pos_j*(kmax+1) + pos_k`` (torch lacks uint32
``minimum`` on CUDA in many builds); the JAX package's uint32 ranks limit a
cell to ``RANK_LIMIT - 1`` occupants, and the port keeps that limit and its
error so that both behave alike.

Distances use post-move positions on freshly rebuilt buckets (the
reference's incrementally-repaired buckets are buggy; a clean rebuild
reproduces every golden vector).

:func:`detect_collisions_blocked` is the plain version of the sweep's
collision kernel: the engines reach it through
``ops/cuda/sweep.sweep_collisions``, which runs it for CPU tensors and the
kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from particlesimulation_tpu_torch.ops.binning import occupancy
from particlesimulation_tpu_torch.ops.forces import (
    _doubled, _shift_down, _shift_up, alive_cells, from_plan_order, ieee_sqrt,
    in_plan_order)

# The JAX package's uint32 pair ranks are exact while kmax < RANK_LIMIT.
RANK_LIMIT = 65535
INF = torch.iinfo(torch.int64).max


def rank_overflow(kmax: int) -> bool:
    """Whether a cell of ``kmax`` occupants is beyond the rank domain. The
    engine folds this into its ``overflow`` telemetry, and the detection
    sweeps below run no trips then: their output is unusable either way."""
    return kmax >= RANK_LIMIT


def detect_collisions(x, y, alive, key, pos_in_cell, kmax: int,
                      epsilon: float, ncells: int):
    """Global-sweep detection (every offset below ``kmax`` over all lanes).
    Returns (count int64, died bool)."""
    n = x.shape[0]
    eps = torch.full((), epsilon, dtype=x.dtype, device=x.device)
    base = kmax + 1
    idx = torch.arange(n, device=x.device)
    real = key < ncells
    pos = pos_in_cell.to(torch.int64)
    x2, y2 = _doubled(x), _doubled(y)
    a2, k2, p2 = _doubled(alive), _doubled(key), _doubled(pos)

    def pair_data(o):
        xp = _shift_up(x2, o, n)
        yp = _shift_up(y2, o, n)
        ap = _shift_up(a2, o, n)
        kp = _shift_up(k2, o, n)
        pp = _shift_up(p2, o, n)
        mask = (idx < n - o) & (key == kp) & real & alive & ap
        dx = x - xp   # getDistance from the outer (lower-index) particle
        dy = y - yp
        dist = ieee_sqrt(dx * dx + dy * dy)
        return mask & (dist < eps), pos * base + pp

    nsweep = 0 if rank_overflow(kmax) else max(kmax - 1, 0)
    ft = torch.full((n,), INF, dtype=torch.int64, device=x.device)
    for o in range(1, nsweep + 1):
        mask, rank = pair_data(o)
        cand = torch.where(mask, rank, INF)
        ft = torch.minimum(ft, cand)
        cand_dn = _shift_down(_doubled(cand), o, n)
        ft = torch.minimum(ft, torch.where(idx >= o, cand_dn, INF))

    ft2 = _doubled(ft)
    count = torch.zeros((), dtype=torch.int64, device=x.device)
    for o in range(1, nsweep + 1):
        mask, rank = pair_data(o)
        hit = mask & (ft == rank) & (_shift_up(ft2, o, n) == rank)
        count = count + torch.sum(hit)
    return count, ft != INF


def detect_collisions_blocked(x, y, alive, key, pos_in_cell, epsilon: float,
                              ncells: int, plan=None):
    """Occupancy-sweep :func:`detect_collisions` (exact; the engine's).

    Offset o runs only over the cells holding more than o particles, a
    prefix of the plan's lane order (``ops/forces``). The count needs no
    second sweep: a pair is counted at its lower endpoint j when j's first
    pair starts at j and its partner's first pair is the same one; the
    partner is found from the rank, since a cell's lanes are contiguous in
    position order. ``plan`` is ``binning.occupancy(key, ncells)``, made
    here if not given.
    """
    plan = plan or occupancy(key, ncells)
    n = x.shape[0]
    if rank_overflow(plan.host_kmax):
        return (torch.zeros((), dtype=torch.int64, device=x.device),
                torch.zeros(n, dtype=torch.bool, device=x.device))
    xq, yq, aq, kq, pq = in_plan_order(plan, x, y, alive, key,
                                       pos_in_cell.to(torch.int64))
    ka = alive_cells(kq, aq)
    eps = torch.full((), epsilon, dtype=x.dtype, device=x.device)
    base = plan.host_kmax + 1
    pqb = pq * base
    ft = torch.full((n,), INF, dtype=torch.int64, device=x.device)
    for o in range(1, plan.host_kmax):
        m = plan.lanes[o]
        lo, hi = slice(0, m - o), slice(o, m)
        dx = xq[lo] - xq[hi]
        dy = yq[lo] - yq[hi]
        hit = ((ka[lo] == ka[hi])
               & (ieee_sqrt(dx * dx + dy * dy) < eps))
        cand = torch.where(hit, pqb[lo] + pq[hi], INF)
        for end in (ft[lo], ft[hi]):
            torch.minimum(end, cand, out=end)
    lane = torch.arange(n, device=x.device)
    first = (ft != INF) & (ft // base == pq)
    partner = torch.where(first, lane - pq + ft % base, lane)
    count = torch.sum(first & (ft[partner] == ft))
    (died,) = from_plan_order(plan, ft != INF)
    return count, died


def apply_deaths(m, alive, died):
    """Kill merged particles: alive=false, m=0 (serial/parsim.cpp:414-418)."""
    return torch.where(died, 0.0, m), alive & ~died
