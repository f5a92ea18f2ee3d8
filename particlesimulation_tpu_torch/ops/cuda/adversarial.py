"""Slot tiles for the cases the pair kernels' structure risks.

The pair kernels compact the used or alive slots of a row, test the pairs
of neighbouring x buckets and count first pairs from an inverse rank table;
the fused kernel compacts the used slots again after its collision phase.
``adversarial_tiles`` builds one row for each
case that structure can get wrong, ``plant_direct_cases`` the same
kind of cases among the particles of the direct model's all-pairs passes,
``sweep_particles`` (with ``mesh_lane_order``) the lanes the sweep
kernels' per-lane order and cell bounds risk, and ``com_particles`` those
the COM kernel's rounds, groups and parity division risk;
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


def _resident_grid(ncside: int, kcap: int, fill: float, rng):
    """Resident tiles of an ``ncside``² grid of unit cells (side =
    ncside): each slot occupied with probability ``fill``, at a random
    place in its row's cell; empty slots keep stale random x, y, vx, vy and
    pid, with m 0. Returns the fields (numpy, (ncells, kcap))."""
    ncells = ncside * ncside
    shape = (ncells, kcap)
    occ = rng.random(shape) < fill
    cell = np.arange(ncells)[:, None]
    x = np.where(occ, cell % ncside + 0.1 + 0.8 * rng.random(shape),
                 rng.uniform(0.0, ncside, shape))
    y = np.where(occ, cell // ncside + 0.1 + 0.8 * rng.random(shape),
                 rng.uniform(0.0, ncside, shape))
    pid = np.where(occ, rng.permutation(occ.size).reshape(shape),
                   rng.integers(-5, occ.size, shape))
    return {"x": x, "y": y, "vx": rng.normal(size=shape),
            "vy": rng.normal(size=shape),
            "m": np.where(occ, rng.uniform(0.5, 1.0, shape), 0.0),
            "occ": occ, "pid": pid}


def _place(f, rows, slots, cells, ncside, rng):
    """Move the particles at (rows, slots) to random places in ``cells``."""
    n = len(rows)
    f["x"][rows, slots] = cells % ncside + 0.1 + 0.8 * rng.random(n)
    f["y"][rows, slots] = cells // ncside + 0.1 + 0.8 * rng.random(n)


def _typed(f):
    out = {k: np.ascontiguousarray(v, dtype=np.float32)
           for k, v in f.items() if k in ("x", "y", "vx", "vy", "m")}
    out["occ"] = np.ascontiguousarray(f["occ"], dtype=bool)
    out["pid"] = np.ascontiguousarray(f["pid"], dtype=np.int32)
    return out


DELIVER_CASES = ("traffic", "crowd", "vacated", "full", "cycle")


def deliver_cases(kcap: int, seed: int = 0):
    """Resident tiles for the cases the one-pass delivery's structure
    risks: ``{name: (fields, side, ncside)}``, fields numpy (ncells, kcap)
    x, y, vx, vy, m (float32), occ (bool), pid (int32) on a grid of unit
    cells, whose movers are the slots ``ops/resident.rebin`` marks (the
    cell of the position is not the row's):

    * ``traffic``: 6 x 6 cells about 30% full, half the particles hopping
      up to 2 cells in x and y, across the box edges too (the periodic
      wrap), and 5% out of the box (limbo: no mover);
    * ``crowd``: 4 x 4 cells; one empty row receives min(K, max(33, K/2 +
      9)) movers (more than a warp holds, more than half its slots) from
      the other rows, half full, some of whose particles hop as well;
    * ``vacated``: 3 x 3 cells; rows 0 and 1 full, and K/4 particles of
      each move to the other: every arrival lands in a slot a mover left
      in the same step;
    * ``full``: 3 x 3 cells; row 4 full with none leaving and 2 movers
      bound for it, among other movers: nothing moves, 2 undelivered;
    * ``cycle``: 3 x 3 cells; rows 0, 1 and 2 full, and K/4 particles of
      each move on to the next (0 to 1, 1 to 2, 2 to 0): every arrival
      lands in a slot whose mover is itself arriving in another row, so an
      in-place delivery must read every mover before it writes a slot.
    """
    rng = np.random.default_rng(seed)
    out = {}

    f = _resident_grid(6, kcap, 0.3, rng)
    rows, slots = np.nonzero(f["occ"])
    hop = rng.random(rows.size) < 0.5
    dx, dy = rng.integers(-2, 3, (2, rows.size))
    cells = ((rows // 6 + dy) % 6) * 6 + (rows % 6 + dx) % 6
    _place(f, rows[hop], slots[hop], cells[hop], 6, rng)
    limbo = rng.random(rows.size) < 0.05
    f["x"][rows[limbo], slots[limbo]] += 6.0
    out["traffic"] = (_typed(f), 6.0, 6)

    f = _resident_grid(4, kcap, 0.5, rng)
    target = 5
    f["occ"][target] = False
    f["m"][target] = 0.0
    rows, slots = np.nonzero(f["occ"])
    n = min(kcap, max(33, kcap // 2 + 9), rows.size)
    pick = rng.choice(rows.size, n, replace=False)
    _place(f, rows[pick], slots[pick], np.full(n, target), 4, rng)
    rest = np.setdiff1d(np.arange(rows.size), pick)
    hop = rest[rng.random(rest.size) < 0.2]
    cells = rng.choice(np.setdiff1d(np.arange(16), [target]), hop.size)
    _place(f, rows[hop], slots[hop], cells, 4, rng)
    out["crowd"] = (_typed(f), 4.0, 4)

    f = _resident_grid(3, kcap, 0.2, rng)
    for row, other in ((0, 1), (1, 0)):
        f["occ"][row] = True
        f["m"][row] = rng.uniform(0.5, 1.0, kcap)
        f["pid"][row] = 10 * f["occ"].size + row * kcap + np.arange(kcap)
        _place(f, np.full(kcap, row), np.arange(kcap), np.full(kcap, row), 3,
               rng)
        leave = rng.choice(kcap, kcap // 4, replace=False)
        _place(f, np.full(leave.size, row), leave,
               np.full(leave.size, other), 3, rng)
    out["vacated"] = (_typed(f), 3.0, 3)

    f = _resident_grid(3, kcap, 0.3, rng)
    full = 4
    f["occ"][full] = True
    f["m"][full] = rng.uniform(0.5, 1.0, kcap)
    f["pid"][full] = 10 * f["occ"].size + np.arange(kcap)
    _place(f, np.full(kcap, full), np.arange(kcap), np.full(kcap, full), 3,
           rng)
    rows, slots = np.nonzero(f["occ"])
    others = np.flatnonzero(rows != full)
    pick = rng.choice(others, min(12, others.size), replace=False)
    cells = np.where(np.arange(pick.size) < 2, full,
                     rng.choice([0, 2, 6, 8], pick.size))
    _place(f, rows[pick], slots[pick], cells, 3, rng)
    out["full"] = (_typed(f), 3.0, 3)

    f = _resident_grid(3, kcap, 0.2, rng)
    for row in range(3):
        f["occ"][row] = True
        f["m"][row] = rng.uniform(0.5, 1.0, kcap)
        f["pid"][row] = 10 * f["occ"].size + row * kcap + np.arange(kcap)
        _place(f, np.full(kcap, row), np.arange(kcap), np.full(kcap, row), 3,
               rng)
    for row in range(3):
        leave = rng.choice(kcap, max(1, kcap // 4), replace=False)
        _place(f, np.full(leave.size, row), leave,
               np.full(leave.size, (row + 1) % 3), 3, rng)
    out["cycle"] = (_typed(f), 3.0, 3)
    return out


def wrap_case(kcap: int):
    """(fields, fxd, fyd, side, ncside): the wrap's edges. A 3 x 3 grid of
    cells 4 wide (side 12) whose only particles sit at rest in row 4 (the
    centre cell's row) with m = 1 and no pair force, so that no monopole
    term acts (every neighbour is empty) and the integrator gives
    a = x + side exactly: each slot's x (then, with x inside, its y) puts
    a at 2·side less one ulp, 2·side (fmod gives 0), 2·side plus one ulp,
    side (from x = 0, and from x = -0.0), side less one ulp, +0 (x =
    -side: a sum x + side with side > 0 is never -0.0), one ulp below 0,
    below -side, 2·side and beyond; one dead slot (m = 0) at x = -0.0.
    The first ``kcap`` slots of that list are used."""
    nc, side = 3, np.float32(12.0)
    f32 = np.float32
    ulp = f32(2.0 ** -20)  # of [8, 16); [16, 32) has 2 ulp
    edges = np.array([side - 2 * ulp,              # a = 2 side - ulp
                      np.nextafter(side, f32(0)),  # a rounds to 2 side
                      side + 2 * ulp,              # a = 2 side + ulp
                      0.0, -0.0,                   # a = side
                      -ulp,                        # a = side - ulp
                      -side,                       # a = +0
                      np.nextafter(-side, f32(-np.inf)),  # a = -ulp
                      -20.0, -12.5,                # a < 0, below -side
                      13.0, 30.0, 5.0], dtype=f32)
    x = np.concatenate([edges, np.full(edges.size, 6.0, f32), [-0.0]])
    y = np.concatenate([np.full(edges.size, 6.0, f32), edges, [6.0]])
    m = np.concatenate([np.ones(2 * edges.size, f32), [0.0]])
    n = min(kcap, x.size)
    shape = (nc * nc, kcap)
    fields = {k: np.zeros(shape, np.float32)
              for k in ("x", "y", "vx", "vy", "m")}
    fields["occ"] = np.zeros(shape, bool)
    fields["pid"] = np.arange(nc * nc * kcap, dtype=np.int32).reshape(shape)
    fields["x"][4, :n], fields["y"][4, :n] = x[:n], y[:n]
    fields["m"][4, :n] = m[:n]
    fields["occ"][4, :n] = True
    zero = np.zeros(shape, np.float32)
    return fields, zero, zero.copy(), float(side), nc


def advance_case(kcap: int, seed: int = 0):
    """(fields, fxd, fyd, side, ncside): resident tiles of a 5 x 5 grid of
    cells 2 wide (side 10; every cell on an edge but the centre one) for
    the monopole and integrate pass, with

    * row 0: slot 0 exactly at the mirrored COM of the neighbour across the
      left edge (dx = -1, dy = 0), which holds one particle of mass 1 (its
      COM is that particle's position), so one term has d² = 0; slot 1 at
      x = -0.3 (in cell 0 by C truncation: a binned slot just below 0),
      slot 2 at x = -1e-7 at rest, which the wrap takes to side or just
      below;
    * row 9 (cell (4, 1), on the right edge): slots at rest at the float
      just below side in x, and just below 0 in y;
    * occupied slots with m = 0 (dead: frozen), empty slots with stale
      values, slots out of the box (limbo: no monopole force), and an empty
      cell (no mass, COM 0);

    and random pair forces ``fxd``, ``fyd`` (float32 (ncells, kcap)).
    """
    rng = np.random.default_rng(seed)
    nc, side = 5, 10.0
    f = _resident_grid(nc, kcap, 0.4, rng)
    for k in ("x", "y"):
        f[k] = 2.0 * f[k]
    # Row 4 = cell (4, 0): one particle of mass 1 at (9.7, 1.3).
    f["occ"][4] = False
    f["m"][4] = 0.0
    f["occ"][4, 3], f["m"][4, 3] = True, 1.0
    f["x"][4, 3], f["y"][4, 3] = np.float32(9.7), np.float32(1.3)
    mirrored = np.float32(np.float32(-side) + np.float32(9.7))
    f["occ"][0, :3] = True
    f["m"][0, :3] = 1.0
    f["x"][0, :3] = (mirrored, -0.3, -1e-7)
    f["y"][0, :3] = (np.float32(1.3), 1.0, 1.0)
    f["vx"][0, 2] = f["vy"][0, 2] = 0.0
    below = np.nextafter(np.float32(side), np.float32(0.0))
    f["occ"][9, :2] = True
    f["m"][9, :2] = 0.75
    f["x"][9, :2] = (below, 9.0)
    f["y"][9, :2] = (3.0, -1e-7)
    f["vx"][9, :2] = f["vy"][9, :2] = 0.0
    # Row 12 (the centre) empty; dead and limbo slots elsewhere.
    f["occ"][12] = False
    f["m"][12] = 0.0
    rows, slots = np.nonzero(f["occ"] & ~np.isin(np.arange(nc * nc),
                                                 (0, 4, 9))[:, None])
    dead = rng.random(rows.size) < 0.1
    f["m"][rows[dead], slots[dead]] = 0.0
    limbo = rng.random(rows.size) < 0.03
    f["y"][rows[limbo], slots[limbo]] += side
    shape = f["x"].shape
    fxd = (rng.normal(size=shape) * 1e-9).astype(np.float32)
    fyd = (rng.normal(size=shape) * 1e-9).astype(np.float32)
    fields = _typed(f)
    # The planted positions after the float32 cast, as planted.
    fields["x"][0, 0] = mirrored
    fields["x"][9, 0] = below
    return fields, fxd, fyd, side, nc


def settle_case(kcap: int, seed: int = 0):
    """(fields, ft, side, ncside): ``advance_case``'s tiles (dead slots
    with m 0, empty slots with stale values, limbo slots, an empty cell,
    positions just below side and just below 0) as a pair pass leaves them,
    with the first-pair ranks ``ft`` (int32 (ncells, kcap)) of the slots it
    killed: about 1 in 12 of the live ones, and row 0's first slot (the
    row's slots 0-2 live in cell 0, slot 1 just below 0); INF elsewhere.
    """
    fields, _, _, side, nc = advance_case(kcap, seed)
    rng = np.random.default_rng(seed + 1)
    live = fields["occ"] & (fields["m"] > 0)
    dies = live & (rng.random(live.shape) < 1.0 / 12.0)
    dies[0, 0] = True
    ft = np.where(dies, rng.integers(0, kcap * kcap, live.shape),
                  0x7FFFFFFF).astype(np.int32)
    return fields, ft, side, nc


# The sweep cases' box: a 3 x 3 grid of side 4.
SWEEP_SIDE, SWEEP_NCSIDE = 4.0, 3


def sweep_particles(case: str, seed: int = 7):
    """(x, y, m, alive): float64 and bool particles in pid order on the
    ``SWEEP_SIDE`` box of ``SWEEP_NCSIDE``² cells, for the sweep's passes.
    ``case``:

    * "planted" (300 particles): pids 0 and 1 open cell (0, 0), pid 0
      massless and dead, pid 1 live (the parity COM adopts pid 1's
      position); pids 2-4 in cell (2, 0) with the massless pid 3 between
      them; pids 5 and 6 live at one position in cell (0, 1) (a coincident
      pair: it collides, and feels no pair force); pids 7 and 8 live at one
      position out of the box (sentinel keys: no pair term, no collision);
      pids 9-11 in cell (2, 2) on a line, 0.6·EPSILON apart (the chain
      A-B, B-C: one count, three deaths); the rest random, ~10% dead;
    * "hot" (600 particles): 40% of them in cell (1, 1), ~10% dead;
    * "wide" (3000 particles): pids 0-2599 in cell (1, 1), so pid p sits at
      position p there (more lanes than a row or column tile of the
      kernels), ~10% of them dead; planted in it, each in a clear spot
      (no other particle within 0.02): a coincident live pair across a
      tile boundary (positions 31, 32 and 63, 64); a lane (pid 500) whose
      lowest hitting partner (pid 100, 0.004 away in x) is not its nearest
      in x (pid 900, 0.001 away in x, 0.0035 in y); for each float type,
      a pair whose fl(dx²) is the least at or above 4·EPSILON² (the x
      window's edge) and one whose is the largest below it; three lanes
      at one x (two 0.003 apart in y, the third far); and pid 2600, live
      at x = -0.3 (in (-w, 0), column 0) with a hitting partner;
    * "huge" (10600 particles): pids 0-9999 in cell (1, 1), more lanes than
      the kernels stage at once (4096), ~10% dead; coincident live pairs
      at positions 4095, 4096 and 8191, 8192 (across the chunks), and pid
      9000 whose lowest hitting partner (pid 100, another chunk) is not
      its nearest in x (pid 9500).
    """
    rng = np.random.default_rng(seed)
    side, w = SWEEP_SIDE, SWEEP_SIDE / SWEEP_NCSIDE
    n = {"hot": 600, "wide": 3000, "huge": 10600}.get(case, 300)
    x, y = rng.uniform(0, side, n), rng.uniform(0, side, n)
    if case == "wide":
        return _wide_particles(rng, x, y, w)
    if case == "huge":
        return _huge_particles(rng, x, y, w)
    if case == "hot":
        k = int(0.4 * n)
        x[:k] = rng.uniform(w, 2 * w, k)
        y[:k] = rng.uniform(w, 2 * w, k)
    m = rng.uniform(0.5, 2.0, n)
    alive = rng.uniform(size=n) > 0.1
    if case == "planted":
        def put(i, cx, cy, dx=0.0, dy=0.0):
            x[i], y[i] = (cx + 0.5) * w + dx, (cy + 0.5) * w + dy

        put(0, 0, 0)
        put(1, 0, 0, 0.1, 0.05)
        for i, d in zip((2, 3, 4), (-0.2, 0.0, 0.2)):
            put(i, 2, 0, d, d)
        put(5, 0, 1)
        put(6, 0, 1)
        x[7] = x[8] = side + 0.25
        y[7] = y[8] = 0.5
        for i, d in zip((9, 10, 11), (0.0, 0.6, 1.2)):
            put(i, 2, 2, d * EPSILON)
        alive[:12] = True
        alive[[0, 3]] = False
    m[~alive] = 0.0
    return x, y, m, alive


def _window_edge(x0, dtype):
    """(the least x1 > x0 with fl((x1 - x0)²) >= 4·EPSILON², the largest
    with it below), both of ``dtype``, as float64."""
    t = np.dtype(dtype).type
    far2 = t(4) * t(EPSILON) * t(EPSILON)
    x0 = t(x0)
    x1 = t(x0 + t(2) * t(EPSILON))
    while t(t(x1 - x0) * t(x1 - x0)) >= far2:
        x1 = np.nextafter(x1, t(-np.inf))
    while t(t(x1 - x0) * t(x1 - x0)) < far2:
        x1 = np.nextafter(x1, t(np.inf))
    return float(x1), float(np.nextafter(x1, t(-np.inf)))


def _wide_particles(rng, x, y, w):
    """The "wide" case of ``sweep_particles``."""
    k = 2600
    x[:k] = rng.uniform(w, 2 * w, k)
    y[:k] = rng.uniform(w, 2 * w, k)
    n = x.shape[0]
    m = rng.uniform(0.5, 2.0, n)
    alive = rng.uniform(size=n) > 0.1
    c = 1.5 * w
    spots = {31: (c - 0.5, c - 0.4), 32: (c - 0.5, c - 0.4),
             63: (c - 0.5, c - 0.3), 64: (c - 0.5, c - 0.3),
             500: (c, c), 100: (c - 0.004, c), 900: (c + 0.001, c + 0.0035),
             1500: (c - 0.3, c - 0.5), 1501: (c - 0.3, c - 0.497),
             1502: (c - 0.3, c), k: (-0.3, 0.5), k + 1: (-0.298, 0.5)}
    for (lo, hi), dtype, dy, at_edge in (
            ((1200, 1201), np.float64, 0.1, True),
            ((1202, 1203), np.float64, 0.2, False),
            ((1210, 1211), np.float32, 0.3, True),
            ((1212, 1213), np.float32, 0.4, False)):
        x0 = float(np.dtype(dtype).type(c + 0.2))
        edge, inside = _window_edge(x0, dtype)
        spots[lo] = (x0, c - dy)
        spots[hi] = (edge if at_edge else inside, c - dy)
    return _plant(rng, x, y, m, alive, spots, k, w)


def _plant(rng, x, y, m, alive, spots, k, w):
    """Move every other particle at least 0.02 from each spot (pids below
    ``k`` within cell (1, 1)), then put each spot's pid there, alive."""
    pts = np.array(list(spots.values()))
    for i in range(x.shape[0]):
        if i in spots:
            continue
        while (np.hypot(pts[:, 0] - x[i], pts[:, 1] - y[i]) < 0.02).any():
            x[i] = rng.uniform(w, 2 * w) if i < k else rng.uniform(0, 3 * w)
            y[i] = rng.uniform(w, 2 * w) if i < k else rng.uniform(0, 3 * w)
    for pid, (px, py) in spots.items():
        x[pid], y[pid] = px, py
        alive[pid] = True
    m[~alive] = 0.0
    return x, y, m, alive


def _huge_particles(rng, x, y, w):
    """The "huge" case of ``sweep_particles``."""
    k = 10000
    x[:k] = rng.uniform(w, 2 * w, k)
    y[:k] = rng.uniform(w, 2 * w, k)
    n = x.shape[0]
    m = rng.uniform(0.5, 2.0, n)
    alive = rng.uniform(size=n) > 0.1
    c = 1.5 * w
    spots = {4095: (c - 0.5, c - 0.4), 4096: (c - 0.5, c - 0.4),
             8191: (c - 0.5, c - 0.3), 8192: (c - 0.5, c - 0.3),
             9000: (c, c), 100: (c - 0.004, c),
             9500: (c + 0.001, c + 0.0035)}
    return _plant(rng, x, y, m, alive, spots, k, w)


# The COM case's box: 128 x 128 unit cells.
COM_SIDE, COM_NCSIDE = 128.0, 128
# csrc/sweep.cu kComLanes: a column of the COM kernel's staging. A group of
# g cells (up to 32, rounded up to a power of two) takes 32/g columns a
# cell, so a cell's round is 32 to 1024 lanes.
COM_ROUND = 32
# Binary exponents of the masses of the COM case's scale cells: float64's
# ends, and both sides of the edges (-510, 510) of the range in which the
# parity division takes the reciprocal.
COM_SCALES = (-1074, -1060, -1022, -600, -520, -516, -513, -512, -511,
              -510, -509, -505, -500, -201, -200, -199, 199, 200, 201, 500,
              503, 505, 508, 509, 510, 511, 512, 520, 1000, 1020, 1023)


def com_particles(seed: int = 11):
    """(x, y, m, alive): float64 and bool particles on the ``COM_SIDE`` box
    of ``COM_NCSIDE``² cells for the COM pass, alive where m > 0:

    * row 0, adoption (the parity mean adopts a lane's position while the
      cell's mass is 0): cell 0 opens with 5 massless lanes, then massive
      and massless lanes mixed; cell 1 holds 10 massless lanes only; cell 2
      opens with 40 massless lanes (past a round of ``COM_ROUND``); cell 3
      is one massless lane; cell 4 opens with 31 massless lanes, then two
      massive ones across the round's edge;
    * row 1, lengths about the rounds (32 to 1024 lanes): cells of 1, 31,
      32, 33, 63, 64, 65, 96, 97, 1023, 1024 and 1025 lanes, and one of 300
      with 50 massless lanes at 100-149;
    * rows 2-3, scales: a cell of 12 lanes for each exponent s of
      ``COM_SCALES``, masses 2^s·U(1, 2) (row 2 at columns 0-30, x < 31;
      row 3 the same at columns 90-120, x ≥ 90, so that the numerators'
      exponents pass the edges too; 2^±200 bounds the masses the parity
      chain takes without a range test), and two cells whose 60 masses
      step through 2^-540 .. 2^540, one up, one down;
    * signed zeros: cell (0, 4) with two of its six lanes at x = +0, cell
      (0, 5) with two at x = -0, cell (5, 0) with two at y = +0 (a chain
      at +0 divides +0; one at -0 cannot take the reciprocal division);
    * rows 8-127, a checkerboard of one-lane cells between empty ones
      (7680 cells);
    * 20 particles out of the box (sentinel keys).

    Masses are otherwise U(0.5, 2); positions uniform in their cells; each
    cell's lanes in the order listed.
    """
    rng = np.random.default_rng(seed)
    xs, ys, ms = [], [], []

    def cell(cx, cy, masses):
        k = len(masses)
        xs.append(cx + rng.uniform(0.0, 1.0, k))
        ys.append(cy + rng.uniform(0.0, 1.0, k))
        ms.append(np.asarray(masses, dtype=np.float64))

    def mixed(k):
        return rng.uniform(0.5, 2.0, k)

    first = mixed(20)
    first[:5] = 0.0
    first[[7, 8, 12]] = 0.0
    cell(0, 0, first)
    cell(1, 0, np.zeros(10))
    cell(2, 0, np.concatenate([np.zeros(40), mixed(30)]))
    cell(3, 0, np.zeros(1))
    cell(4, 0, np.concatenate([np.zeros(31), mixed(2)]))
    for cx, k in enumerate((1, 31, 32, 33, 63, 64, 65, 96, 97, 1023, 1024,
                            1025)):
        cell(cx, 1, mixed(k))
    long_ = mixed(300)
    long_[100:150] = 0.0
    cell(12, 1, long_)
    for i, e in enumerate(COM_SCALES):
        for cx, cy in ((i, 2), (90 + i, 3)):
            cell(cx, cy, np.ldexp(rng.uniform(1.0, 2.0, 12), e))
    steps = np.ldexp(rng.uniform(1.0, 2.0, 60),
                     np.linspace(-540, 540, 60).astype(int))
    cell(40, 2, steps)
    cell(41, 2, steps[::-1])
    for cx, cy, zero in ((0, 4, 0.0), (0, 5, -0.0), (5, 0, 0.0)):
        cell(cx, cy, mixed(6))
        (ys if cy == 0 else xs)[-1][[1, 3]] = zero
    for cy in range(8, COM_NCSIDE):
        for cx in range(cy % 2, COM_NCSIDE, 2):
            cell(cx, cy, mixed(1))
    xs.append(COM_SIDE + rng.uniform(0.0, 5.0, 20))
    ys.append(rng.uniform(0.0, COM_SIDE, 20))
    ms.append(mixed(20))
    # In pid order each cell's lanes come as listed, which the sort by
    # (key, pid) keeps.
    x, y, m = (np.concatenate(a) for a in (xs, ys, ms))
    return x, y, m, m > 0


def mesh_lane_order(key, ncells: int):
    """A permutation of sorted lanes (cell keys ``key``, NumPy) into the
    layout of the mesh's slabs: each cell's lanes contiguous and in order,
    but the cells out of key order, sentinel lanes (key >= ncells) between
    them: the cells of the upper half of the keys, half the sentinel lanes,
    the lower cells, the other sentinel lanes."""
    key = np.asarray(key)
    half = ncells // 2 + 1
    sent = np.flatnonzero(key >= ncells)
    return np.concatenate([
        np.flatnonzero((key >= half) & (key < ncells)), sent[:len(sent) // 2],
        np.flatnonzero(key < half), sent[len(sent) // 2:]])
