"""Slot tiles for the cases the pair kernels' structure risks.

The pair kernels compact the used or alive slots of a row, test the pairs
of neighbouring x buckets and count first pairs from an inverse rank table;
the fused kernel compacts the used slots again after its collision phase.
``adversarial_tiles`` builds one row for each
case that structure can get wrong, and ``plant_direct_cases`` the same
kind of cases among the particles of the direct model's all-pairs passes;
the CPU tests hold the plain versions against the JAX package's kernels on
them, and ``chip_smoke.py`` holds the CUDA kernels against the plain
versions on them. NumPy only, so that both
can use it.
"""

from __future__ import annotations

import numpy as np

from particlesimulation_tpu_torch.config import EPSILON

CLUSTER = 48


def adversarial_tiles(kcap: int, seed: int = 0):
    """(x, y, m, alive, pid): float32 and int32 (9, kcap) tiles, one case
    per row, with coordinates about a unit cell:

    0. only the last two slots (K-2, K-1) alive, within EPSILON;
    1. holes: every third slot dead (m = 0, alive = 0) at the coordinates of
       the slot before it, and a chain of hits over the holes;
    2. no alive slot;
    3. min(48, K) alive particles at random slots, all within EPSILON of
       each other (1,128 hit pairs at 48), among other alive particles;
    4. every slot alive;
    5. the first ~60% of slots alive, with a planted chain of three;
    6. every slot alive on one vertical line, at y = 0.1 + i·EPSILON·(1 ± 1e-6)
       for slot i: all x tie, so every pair is within EPSILON in x, and
       neighbours lie a hair inside or outside EPSILON;
    7. every slot alive, in pairs EPSILON/2 apart (slots paired at random;
       with an odd K the last slot joins a pair), the pairs on a grid far
       apart: every alive slot collides, so no slot keeps its mass;
    8. a single used (and alive) slot.

    Dead slots keep random coordinates. pids are a permutation per row.
    """
    if kcap < 8:
        raise ValueError(f"kcap {kcap} < 8")
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (9, kcap))
    y = rng.uniform(0.0, 1.0, (9, kcap))
    alive = np.zeros((9, kcap), dtype=bool)

    alive[0, -2:] = True
    x[0, -1] = x[0, -2] + EPSILON / 2
    y[0, -1] = y[0, -2]

    x[1, 3] = x[1, 1] + EPSILON / 2  # slot 1 - slot 3 - slot 4 over hole 2
    y[1, 3] = y[1, 1]
    x[1, 4] = x[1, 3] + EPSILON / 2
    y[1, 4] = y[1, 3]
    alive[1] = np.arange(kcap) % 3 != 2
    holes = np.flatnonzero(~alive[1])
    x[1, holes], y[1, holes] = x[1, holes - 1], y[1, holes - 1]

    alive[3] = True
    members = rng.choice(kcap, size=min(CLUSTER, kcap), replace=False)
    r = 0.4 * EPSILON * np.sqrt(rng.uniform(size=members.size))
    phi = rng.uniform(0.0, 2 * np.pi, members.size)
    x[3, members] = 0.5 + r * np.cos(phi)
    y[3, members] = 0.5 + r * np.sin(phi)

    alive[4] = True

    alive[5, :max(3, int(0.6 * kcap))] = True
    x[5, 1] = x[5, 0] + EPSILON / 3
    x[5, 2] = x[5, 1] + EPSILON / 3
    y[5, 1:3] = y[5, 0]

    alive[6] = True
    x[6] = 0.25
    y[6] = 0.1 + np.arange(kcap) * EPSILON * rng.choice(
        [1 - 1e-6, 1.0, 1 + 1e-6], kcap)

    alive[7] = True
    npairs = kcap // 2
    grid = int(np.ceil(np.sqrt(npairs)))
    pair = np.minimum(np.arange(kcap) // 2, npairs - 1)
    member = np.arange(kcap) - 2 * pair  # 0 or 1 (2: the odd K's last)
    slots = rng.permutation(kcap)
    x[7, slots] = (pair % grid + 0.5) / grid + member * EPSILON / 2
    y[7, slots] = (pair // grid + 0.5) / grid

    alive[8, kcap // 2] = True

    m = np.where(alive, rng.uniform(0.5, 2.0, (9, kcap)), 0.0)
    pid = np.argsort(rng.uniform(size=(9, kcap)), axis=1)
    return (x.astype(np.float32), y.astype(np.float32), m.astype(np.float32),
            alive.astype(np.int32), pid.astype(np.int32))


# The slots of plant_direct_cases' groups: a pair, a chain of three, a
# coincident pair, a pair across the periodic edge, an alive slot and a dead
# one within EPSILON of it.
DIRECT_GROUPS = ((0, 1), (2, 3, 4), (5, 6), (7, 8), (9, 10))


def plant_direct_cases(x, y, vx, vy, m, alive, side: float, pairs=()):
    """Plant collision cases, in place, into float64 particle arrays of the
    direct model (x, y, vx, vy, m and a bool ``alive``), each group at rest
    on its own spot of the ``[0, side)²`` box:

    * slots 0-1: a pair EPSILON/3 apart;
    * 2-4: a chain of three 0.6·EPSILON apart (2-3 and 3-4 hit, 2-4 do not:
      all three die, one pair counts);
    * 5-6: a coincident pair (d = 0: a hit, and no force);
    * 7-8: a pair across the periodic edge, at x = 0.001 and side - 0.001;
    * 9-10: slot 10 dead (m = 0) EPSILON/4 from alive slot 9, which no hit
      may reach;

    where the arrays hold enough slots (n >= 11), and a pair EPSILON/3 apart
    at the slots (i, j) of each entry of ``pairs``, each on a spot of its
    own. Returns the slots planted.
    """
    n = x.shape[0]
    offsets = {(0, 1): (0.0, EPSILON / 3), (2, 3, 4): (0.0, 0.6 * EPSILON,
                                                      1.2 * EPSILON),
               (5, 6): (0.0, 0.0), (9, 10): (0.0, EPSILON / 4)}
    groups = [(g, offsets.get(g)) for g in DIRECT_GROUPS] if n >= 11 else []
    groups += [(tuple(p), (0.0, EPSILON / 3)) for p in pairs]
    planted = []
    for k, (slots, offs) in enumerate(groups):
        y0 = side * (0.05 + 0.9 * ((k * 0.37) % 1.0))
        if slots == (7, 8):
            xs = (0.001, side - 0.001)
        else:
            xs = tuple(side * (0.1 + 0.8 * ((k * 0.61) % 1.0)) + o
                       for o in offs)
        for s, xv in zip(slots, xs):
            x[s], y[s], vx[s], vy[s] = xv, y0, 0.0, 0.0
        planted += slots
    if n >= 11:
        m[10], alive[10] = 0.0, False
    return planted


LABEL_LAYOUTS = ("random", "one", "distinct", "gaps", "returning")


def label_layouts(kcap: int, rows: int = 9, seed: int = 0):
    """Same-cell labels for ``rows`` rows of ``kcap`` slots (int32), one
    (rows, kcap) array per layout the labelled pass's grouping by label
    risks:

    * ``random``: labels 0-3 and -1 drawn per slot;
    * ``one``: every label 0 (one run holds the row: the unlabelled pass);
    * ``distinct``: every slot its own label (no pair may interact);
    * ``gaps``: runs of three slots in slot order, each followed by a -1;
    * ``returning``: labels 0, 1, 2 in turn, slot by slot, with every
      seventh slot -1: each run is spread over the whole row, so a grouping
      that does not keep slot order within a run sums in another order.

    On ``adversarial_tiles``' rows the planted near pairs then fall within
    one label, across labels or across runs.
    """
    rng = np.random.default_rng(seed)
    i = np.broadcast_to(np.arange(kcap), (rows, kcap))
    out = {
        "random": rng.integers(-1, 4, (rows, kcap)),
        "one": np.zeros((rows, kcap)),
        "distinct": i,
        "gaps": np.where(i % 4 == 3, -1, i // 4),
        "returning": np.where(i % 7 == 6, -1, i % 3),
    }
    return {k: np.ascontiguousarray(v, dtype=np.int32) for k, v in out.items()}
