"""Gravitational forces over the sorted-particle representation.

The reference's hottest loops (reference serial/parsim.cpp:292-377): exact
pairwise gravity between alive particles sharing a cell, with Newton's-third-
law dual update, plus monopole attraction from the eight stencil temp-cells.

The *sorted neighbor-offset sweep*: with particles sorted by (cell, id), all
same-cell partners of particle i sit at offsets i±o, o < k_max (the largest
cell occupancy). A loop over o does masked shifted-array arithmetic across
the lanes at once, with no gather or scatter inside it.

Parity variant: per particle, the reference accumulates (a) reaction terms
from lower-indexed partners in ascending-partner order, (b) own pair terms in
ascending-partner order, then (c) the 8 stencil terms in stencil order. Two
sweeps (o descending for (a), o ascending for (b)) followed by the ordered
monopole pass reproduce that association order exactly. The force magnitude
keeps the reference's association, computed from the *lower-indexed*
particle's side: ``((G*m_lo)*m_hi)/d2`` (serial/parsim.cpp:139).

Fast variant: one sweep, symmetric accumulation, order-free.

Two sweep layouts:

* the global sweep (:func:`pairwise_forces_parity`) runs every offset below
  ``kmax`` over all N lanes, as the JAX package's does; the reference form;
* the occupancy sweep (:func:`pairwise_forces_parity_blocked`,
  :func:`pairwise_forces_fast`, the engine's) runs offset o only over the
  lanes whose cell holds more than o particles: with the lanes laid out by
  ``binning.occupancy`` (cells by occupancy descending) those are a prefix,
  so each offset is a pair of slices. Cost drops from ``N·kmax`` to
  ``Σ_cells c²`` (the JAX package's blocked sweep gets there with blocks of
  2048 lanes; a Python loop over blocks would multiply the launches).

Bit-exactness of the occupancy sweep: for a lane whose cell holds c
particles, offsets o ≥ c are fully masked and contribute a literal ±0.0 —
``fx - 0.0`` is an exact IEEE no-op, and ``fx + 0.0`` is a no-op unless fx is
-0.0, which cannot arise here (force terms are products of positive
magnitudes with ``dx/dist`` quotients whose zeros are +0.0, sums that cancel
exactly round to +0.0, and the accumulator starts at ``x*0 = +0.0`` for the
in-domain x ≥ 0). Skipping those offsets reproduces the global sweep's bits.

Every divisor is a tensor on the operands' device: torch divides by a CPU
scalar on CUDA as a multiplication by its reciprocal, which can differ from
IEEE division in the last bit. Each operation is its own eager kernel, so
``dx*dx + dy*dy`` has no FMA in it on either device.
"""

from __future__ import annotations

import numpy as np
import torch

from particlesimulation_tpu_torch.config import G
from particlesimulation_tpu_torch.ops.binning import occupancy


def _const(v, like):
    return torch.full((), v, dtype=like.dtype, device=like.device)


def ieee_sqrt(t):
    """Correctly rounded square root. torch's CPU kernel is not (with
    AVX-512 it misses the IEEE result by an ulp on ~1% of float64 inputs),
    so CPU tensors take NumPy's; CUDA's ``sqrt`` is IEEE."""
    if t.device.type == "cpu":
        return torch.from_numpy(np.sqrt(t.numpy()))
    return torch.sqrt(t)


def _doubled(a):
    return torch.cat([a, a])


def _shift_up(a2, o: int, n: int):
    """a2 = doubled tensor; a view s with s[i] = a[i+o] for i+o < n."""
    return a2[o:o + n]


def _shift_down(a2, o: int, n: int):
    """A view s with s[i] = a[i-o] for i >= o."""
    return a2[n - o:2 * n - o]


def in_plan_order(plan, *arrays):
    """The arrays gathered into the plan's lane order."""
    return [a[plan.order] for a in arrays]


def from_plan_order(plan, *arrays):
    """The inverse of :func:`in_plan_order`."""
    return [torch.empty_like(a).index_copy_(0, plan.order, a) for a in arrays]


def alive_cells(key, alive):
    """Per lane, its cell key if alive, else a number of its own below 0:
    two lanes match iff they share a cell and both are alive (one compare
    for the sweeps' three-way mask)."""
    lane = torch.arange(key.shape[0], device=key.device)
    return torch.where(alive, key.to(torch.int64), -1 - lane)


def pairwise_forces_parity(x, y, m, alive, key, kmax: int, ncells: int):
    """Exact-order same-cell pairwise forces, global sweep. Returns (fx, fy)."""
    n = x.shape[0]
    g, zero = _const(G, x), _const(0.0, x)
    idx = torch.arange(n, device=x.device)
    real = key < ncells
    x2, y2, m2 = _doubled(x), _doubled(y), _doubled(m)
    a2, k2 = _doubled(alive), _doubled(key)

    def lower(o, fx, fy):
        # o descends kmax-1 .. 1 → reaction terms arrive in ascending-partner
        # order, matching serial/parsim.cpp:356-366's outer-loop order.
        xp = _shift_up(x2, n - o, n)  # partner i-o via down-shift
        yp = _shift_up(y2, n - o, n)
        mp = _shift_up(m2, n - o, n)
        ap = _shift_up(a2, n - o, n)
        kp = _shift_up(k2, n - o, n)
        mask = (idx >= o) & (key == kp) & real & alive & ap
        # From the lower-indexed partner j' = i-o's perspective
        # (calculateForceBetweenParticles, serial/parsim.cpp:127-148):
        dx = x - xp   # p2->x - x with p2 = self
        dy = y - yp
        d2 = dx * dx + dy * dy
        dist = ieee_sqrt(d2)
        mask = mask & (dist != zero)
        fm = (g * mp) * m / d2
        fxa = fm * (dx / dist)
        fya = fm * (dy / dist)
        # Self is p2: receives the reaction update fx -= fx_add.
        return (fx - torch.where(mask, fxa, zero),
                fy - torch.where(mask, fya, zero))

    def upper(o, fx, fy):
        xp = _shift_up(x2, o, n)
        yp = _shift_up(y2, o, n)
        mp = _shift_up(m2, o, n)
        ap = _shift_up(a2, o, n)
        kp = _shift_up(k2, o, n)
        mask = (idx < n - o) & (key == kp) & real & alive & ap
        dx = xp - x   # p2->x - x with self as j
        dy = yp - y
        d2 = dx * dx + dy * dy
        dist = ieee_sqrt(d2)
        mask = mask & (dist != zero)
        fm = (g * m) * mp / d2
        return (fx + torch.where(mask, fm * (dx / dist), zero),
                fy + torch.where(mask, fm * (dy / dist), zero))

    fx = x * zero
    fy = x * zero
    for o in range(kmax - 1, 0, -1):
        fx, fy = lower(o, fx, fy)
    for o in range(1, kmax):
        fx, fy = upper(o, fx, fy)
    return fx, fy


def cell_occupancy_per_lane(key_sorted):
    """Occupancy of each lane's cell, for sorted keys."""
    first = torch.searchsorted(key_sorted, key_sorted)
    end = torch.searchsorted(key_sorted, key_sorted, right=True)
    return end - first


def pairwise_forces_parity_blocked(x, y, m, alive, key, ncells: int,
                                   plan=None):
    """Occupancy-sweep :func:`pairwise_forces_parity`, bit for bit (module
    docstring); the parity engine's. ``plan`` is
    ``binning.occupancy(key, ncells)``, made here if not given."""
    plan = plan or occupancy(key, ncells)
    xq, yq, mq, aq, kq = in_plan_order(plan, x, y, m, alive, key)
    ka = alive_cells(kq, aq)
    g, zero = _const(G, x), _const(0.0, x)

    def pair_terms(o):
        """The force terms of pairs (i, i+o), i < lanes[o] - o, from the
        lower-indexed particle's side (both sweeps compute the same terms:
        the lower sweep as ``x - xp`` with self the upper particle, the upper
        sweep as ``xp - x`` with self the lower one)."""
        n = plan.lanes[o]
        lo, hi = slice(0, n - o), slice(o, n)
        dx = xq[hi] - xq[lo]
        dy = yq[hi] - yq[lo]
        d2 = dx * dx + dy * dy
        dist = ieee_sqrt(d2)
        mask = (ka[lo] == ka[hi]) & (dist != zero)
        fm = (g * mq[lo]) * mq[hi] / d2
        return (lo, hi, torch.where(mask, fm * (dx / dist), zero),
                torch.where(mask, fm * (dy / dist), zero))

    fxq = xq * zero
    fyq = xq * zero
    for o in range(plan.kmax - 1, 0, -1):
        # Reaction terms, partners ascending (serial/parsim.cpp:356-366).
        _, hi, tx, ty = pair_terms(o)
        fxq[hi].sub_(tx)
        fyq[hi].sub_(ty)
    for o in range(1, plan.kmax):
        lo, _, tx, ty = pair_terms(o)
        fxq[lo].add_(tx)
        fyq[lo].add_(ty)
    return tuple(from_plan_order(plan, fxq, fyq))


def pairwise_forces_fast(x, y, m, alive, key, ncells: int, plan=None):
    """Order-free same-cell pairwise forces: one occupancy sweep, symmetric
    update (the f32 sweep engine's). ``plan`` as in
    :func:`pairwise_forces_parity_blocked`."""
    plan = plan or occupancy(key, ncells)
    xq, yq, mq, aq, kq = in_plan_order(plan, x, y, m, alive, key)
    ka = alive_cells(kq, aq)
    g, zero = _const(G, x), _const(0.0, x)
    gm = g * mq
    fxq = xq * zero
    fyq = xq * zero
    for o in range(1, plan.kmax):
        n = plan.lanes[o]
        lo, hi = slice(0, n - o), slice(o, n)
        dx = xq[hi] - xq[lo]
        dy = yq[hi] - yq[lo]
        d2 = dx * dx + dy * dy
        mask = (ka[lo] == ka[hi]) & (d2 > zero)
        inv = torch.rsqrt(d2)  # inf at d2 = 0, where the mask is off
        # F/d = G*m1*m2/d^3 = G*m1*m2 * inv^3
        s = torch.where(mask, gm[lo] * mq[hi] * (inv * inv * inv), zero)
        tx = s * dx
        ty = s * dy
        fxq[lo].add_(tx)
        fyq[lo].add_(ty)
        # Newton's 3rd law on the partner side.
        fxq[hi].sub_(tx)
        fyq[hi].sub_(ty)
    return tuple(from_plan_order(plan, fxq, fyq))


def monopole_forces(x, y, m, alive, key, fx, fy, ml, mxl, myl, ncells: int):
    """Add the 8 neighbor-COM monopole terms (serial/parsim.cpp:109-125),
    in the reference's per-term association (both precisions).

    ``ml, mxl, myl``: ``ops/stencil.stencil_tables``' (8, ncells + 1) rows.
    """
    g, zero, one = _const(G, x), _const(0.0, x), _const(1.0, x)
    kc = torch.clamp(key, max=ncells).to(torch.int64)  # sentinel column
    real = key < ncells
    for l in range(8):
        cm = ml[l][kc]
        cmx = mxl[l][kc]
        cmy = myl[l][kc]
        dx = cmx - x
        dy = cmy - y
        d2 = dx * dx + dy * dy
        dist = ieee_sqrt(d2)
        mask = alive & real & (dist != zero)
        fm = (g * m) * cm / torch.where(d2 > zero, d2, one)
        safe = torch.where(dist > zero, dist, one)
        fx = fx + torch.where(mask, fm * (dx / safe), zero)
        fy = fy + torch.where(mask, fm * (dy / safe), zero)
    return fx, fy
