"""Census-weighted shard row boundaries for clustered workloads.

The port's own copy of the JAX package's ``parallel/balance.py`` (pure
NumPy; a test holds the two equal on the same weights).

The row-block decomposition (parallel/sharded.py) mirrors the reference
MPI variant's contiguous row split (mpi/parsim-mpi.cpp:330-465). With
equal-rows blocks, a clustered (normal-mode Gaussian-blob) workload
loads one shard with most of the particles — the reference's report
documents exactly this failure on UNEVEN (CPD_2nd_delivery.pdf p.6:
9.69x of a possible ~22x, "not so consistent results"). The reference
has no answer; this planner is ours: choose the row boundaries from the
initial occupancy census so per-shard PARTICLE counts (the pair-work
proxy) equalize.

Constraint: every shard's local grid has one shape, ``rows_max`` rows
tall — letting a fringe shard own many near-empty
rows inflates every shard's tile allocation. ``max_stretch`` caps
per-shard rows at ``ceil(stretch * ncside / n_shards)``, trading perfect
balance for bounded shapes (stretch 2 recovers most of the balance on a
blob profile at 2x the slot padding).

Boundaries bind per run-start census; the blob drifts slowly, and the
engines' overflow ladders (capacity growth, never silent loss) cover the
drift like every other capacity decision in this framework.
"""

from __future__ import annotations

import numpy as np


def plan_shard_rows(row_weights, n_shards: int,
                    max_stretch: float = 2.0):
    """Choose shard row starts from per-row particle weights.

    ``row_weights``: (ncside,) nonnegative per-grid-row particle counts.
    Returns a ``row_starts`` tuple for ``SimConfig`` (length n_shards,
    starting at 0), or None when the balanced-uneven default is already
    within ~20% of the optimum (uniform loads — keep the simpler scheme).

    Minimizes the max per-shard weight by binary search over the answer
    with a greedy feasibility sweep honoring the row cap.
    """
    w = np.asarray(row_weights, dtype=np.int64)
    nc = len(w)
    d = int(n_shards)
    if d <= 1 or d > nc:
        return None
    cap_rows = max(1, int(np.ceil(max_stretch * nc / d)))

    def feasible(limit):
        """Greedy: pack rows while weight <= limit and rows <= cap_rows,
        keeping enough rows (>= 1 each) for the remaining shards."""
        starts = [0]
        acc = 0
        rows = 0
        for r in range(nc):
            must_leave = d - len(starts)  # shards still needing >= 1 row
            if rows and (acc + w[r] > limit or rows == cap_rows):
                if len(starts) == d:
                    return None  # out of shards
                starts.append(r)
                acc, rows = 0, 0
            # Force a cut when exactly enough rows remain for the others.
            if nc - r == must_leave and rows:
                if len(starts) == d:
                    return None
                starts.append(r)
                acc, rows = 0, 0
            acc += w[r]
            rows += 1
            if acc > limit or rows > cap_rows:
                return None  # a single row exceeds the limit: infeasible
        if len(starts) != d:
            return None
        return tuple(starts)

    lo, hi = int(w.max()), int(w.sum())
    best = None
    while lo <= hi:
        mid = (lo + hi) // 2
        s = feasible(mid)
        if s is not None:
            best = (mid, s)
            hi = mid - 1
        else:
            lo = mid + 1
    if best is None:
        return None
    opt_max, starts = best

    # The balanced-uneven default's max shard weight, for the adoption
    # gate: keep the simple scheme when it is already near-optimal.
    base, rem = nc // d, nc % d
    r0 = 0
    def_max = 0
    for s in range(d):
        rws = base + (1 if s < rem else 0)
        def_max = max(def_max, int(w[r0:r0 + rws].sum()))
        r0 += rws
    if def_max <= 1.2 * opt_max:
        return None
    return starts
