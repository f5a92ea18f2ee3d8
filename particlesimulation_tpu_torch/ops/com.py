"""Per-cell center of mass over the sorted-particle representation.

Two formulations:

* :func:`com_parity` — replicates the reference's *incremental running
  weighted mean* (``Cell::addParticle``, reference serial/parsim.cpp:93-106)
  bit for bit, quirks included: a zero-mass cell adopts the position of
  whatever particle is added next (even a dead, massless one), and adding a
  dead particle to a massive cell still computes ``(mx*m + 0*x)/(m + 0)``.
  The JAX package scans the N particles one by one; here the loop runs over
  the position in the cell instead, ``kmax`` iterations, each updating every
  cell that has a particle at that position. Each cell sees the same
  sequence of operations, so the bits are the same.
* :func:`com_fast` — order-free ``Σm·x / Σm``; same math, other rounding.
  The sums run over (ncells, kmax) rows, so their bits do not change from
  one run to the next (an atomic scatter-add would).

Both return flat ``(ncells,)`` tensors indexed by ``cy*ncside + cx``; empty
cells hold zeros (the reference's freshly-assigned ``Cell{}``,
serial/parsim.cpp:263-264).
"""

from __future__ import annotations

import torch

from particlesimulation_tpu_torch.ops.binning import occupancy, segment_positions


def com_parity(key_sorted, x, y, m, ncells: int, plan=None):
    """Exact-order COM. Returns (M, MX, MY) each (ncells,) in x's dtype.

    ``plan`` is ``binning.occupancy(key_sorted, ncells)``, made here if not
    given."""
    plan = plan or occupancy(key_sorted, ncells)
    M, MX, MY = (torch.zeros(ncells, dtype=x.dtype, device=x.device)
                 for _ in range(3))
    if plan.kmax == 0:
        return M, MX, MY
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    # Position-major lanes: position p's lanes, one per cell holding more
    # than p particles, in the plan's cell order, are one contiguous block.
    lanes = plan.order[:plan.lanes[0]]
    pos, _ = segment_positions(key_sorted)
    pm = lanes[torch.sort(pos[lanes], stable=True).indices]
    kp, xp, yp, mp = (a[pm] for a in (key_sorted, x, y, m))
    ncell = plan.cells[0]
    cm, cmx, cmy = (torch.zeros(ncell, dtype=x.dtype, device=x.device)
                    for _ in range(3))
    start = 0
    for c in plan.cells:
        xi, yi, mi = (a[start:start + c] for a in (xp, yp, mp))
        m0, mx0, my0 = cm[:c], cmx[:c], cmy[:c]
        empty = m0 == zero
        # Guard the division when empty (0/0); selected away by where.
        denom = torch.where(empty, one, m0 + mi)
        nmx = torch.where(empty, xi, (mx0 * m0 + mi * xi) / denom)
        nmy = torch.where(empty, yi, (my0 * m0 + mi * yi) / denom)
        mx0.copy_(nmx)
        my0.copy_(nmy)
        m0.add_(mi)
        start += c
    cell = kp[:ncell].to(torch.int64)
    M[cell], MX[cell], MY[cell] = cm, cmx, cmy
    return M, MX, MY


def com_fast(key_sorted, x, y, m, ncells: int, plan=None):
    """Order-free COM (the f32 sweep engine's), summed over (ncells, kmax)
    rows so that its bits do not depend on the run."""
    plan = plan or occupancy(key_sorted, ncells)
    kmax = max(plan.kmax, 1)
    pos, _ = segment_positions(key_sorted)
    slot = torch.where(key_sorted < ncells,
                       key_sorted.to(torch.int64) * kmax + pos, ncells * kmax)

    def row_sums(v):
        flat = v.new_zeros(ncells * kmax + 1)  # the last slot takes sentinels
        flat[slot] = v
        return flat[:-1].view(ncells, kmax).sum(dim=1)

    M, SX, SY = row_sums(m), row_sums(m * x), row_sums(m * y)
    has = M > 0
    safe = torch.where(has, M, 1.0)
    return M, torch.where(has, SX / safe, 0.0), torch.where(has, SY / safe, 0.0)
