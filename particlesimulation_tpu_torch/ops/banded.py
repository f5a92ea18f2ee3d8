"""Row-band planner of the JAX package's ``ops/banded.py``, for the census.

The banded engine itself (row-banded resident tiles) is not ported; the
census uses ``plan_bands`` to tell where the JAX package would run it (a
clustered load with a band plan) from where it runs the tiered engine (no
band plan).
"""

from __future__ import annotations

import numpy as np

from particlesimulation_tpu_torch.ops.binning import round_cap

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
