"""NumPy models of the sweep kernels' new schedules (``csrc/sweep.cu``),
held against the wrappers' plain versions on the CPU, on every case of
``adversarial.sweep_particles`` (the 2600-lane cell of "wide" and the
10 000-lane cell of "huge" among them), in sorted lanes and in the mesh's
lane layout.

* The parity force kernel computes each pair's term once in a cell of more
  than 512 lanes. A warp takes a row tile (32 lanes of a cell from a
  position that is a multiple of 32): first the pairs inside it, each lane
  subtracting its lower partners' terms in ascending order then adding
  its upper partners'; then each column tile above it, ascending: the
  column lanes subtract t(u, v) in ascending u, the row lanes add t(u, v)
  in ascending v. A column lane's sum passes from one row tile of its cell
  to the next. ``parity_model`` runs that order in every cell (the kernel
  runs a smaller cell's lanes in the plain order itself), a NumPy
  operation over many lanes at a time, then the plain monopole terms: the
  forces must be the plain version's bit for bit.
* The collision kernel finds each lane's first partner in an x window:
  each chunk of a cell sorted by x; each alive receiver walks up, then
  down, from its own x while fl(dx²) < 4·EPSILON², tests each alive
  partner as the plain version does and keeps the lowest position.
  ``window_model`` runs that search (chunks of 4096 lanes, the kernel's,
  and of 700, which split the wide and huge cells): its first partners
  must equal a brute-force walk over all partners, its dead set and count
  the plain version's.

No JAX here: ``tests/test_torch_sweep_kernels.py`` holds the plain versions
to JAX on the same cases.
"""

import numpy as np
import pytest
import torch

from particlesimulation_tpu_torch.config import EPSILON, G
from particlesimulation_tpu_torch.ops import binning, forces, stencil
from particlesimulation_tpu_torch.ops.cuda import adversarial, sweep

torch.set_num_threads(2)

SIDE, NC = adversarial.SWEEP_SIDE, adversarial.SWEEP_NCSIDE
NCELLS = NC * NC
TILE = 32      # csrc/sweep.cu kTile
CHUNK = 4096   # csrc/sweep.cu kChunk
CASES = ("planted", "hot", "wide", "huge")
_CACHE = {}


def _cached(key, make):
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def _lanes(case, dtype, mesh):
    """x, y, m, alive, key, pos (torch) and the occupancy, in the kernels'
    lane order: sorted by (key, pid), or the mesh's layout of those."""
    def make():
        x, y, m, alive = adversarial.sweep_particles(case)
        x, y, m = (torch.from_numpy(a.astype(dtype)) for a in (x, y, m))
        key, _ = binning.cell_keys(x, y, SIDE, NC)
        key, _, x, y, m, alive = binning.sort_by_cell(
            key, torch.arange(x.shape[0], dtype=torch.int32), x, y, m,
            torch.from_numpy(alive))
        pos, _ = binning.segment_positions(key)
        perm = torch.from_numpy(
            adversarial.mesh_lane_order(key.numpy(), NCELLS) if mesh
            else np.arange(x.shape[0]))
        lanes = [a[perm].contiguous() for a in (x, y, m, alive, key, pos)]
        return lanes + [binning.occupancy(lanes[4], NCELLS)]
    return _cached(("lanes", case, dtype, mesh), make)


def _cells(key, pos, plan):
    """(first lane, end) of each real cell, as the kernels find them."""
    k, p, c = key.numpy(), pos.numpy(), plan.counts.numpy()
    return [(s, s + int(c[k[s]]))
            for s in np.flatnonzero((k < NCELLS) & (p == 0))]


def _parity_terms(xl, yl, ml, al, xh, yh, mh, ah):
    """t(lo, hi) = ((G·m_lo)·m_hi)/d2 · (d/dist), d = hi - lo, broadcast;
    +0 where masked (a dead end, or dist 0)."""
    dx, dy = xh - xl, yh - yl
    d2 = dx * dx + dy * dy
    dist = np.sqrt(d2)
    with np.errstate(divide="ignore", invalid="ignore"):
        fm = np.float64(G) * ml * mh / d2
        tx, ty = fm * (dx / dist), fm * (dy / dist)
    ok = al & ah & (dist != 0)
    return np.where(ok, tx, 0.0), np.where(ok, ty, 0.0)


def parity_model(x, y, m, alive, key, pos, plan, tables):
    """The parity force kernel's order (module docstring), then the plain
    monopole terms."""
    xs, ys, ms, al = (a.numpy() for a in (x, y, m, alive))
    ax, ay = xs * 0.0, xs * 0.0
    for s, e in _cells(key, pos, plan):
        for i0 in range(s, e, TILE):
            tk = min(TILE, e - i0)
            row = slice(i0, i0 + tk)
            # t[u, j - i0] = t(i0 + u, j) for every lane j from i0 on.
            tx, ty = _parity_terms(xs[row, None], ys[row, None],
                                   ms[row, None], al[row, None],
                                   xs[None, i0:e], ys[None, i0:e],
                                   ms[None, i0:e], al[None, i0:e])
            for u in range(tk):  # the triangle: lower partners first
                ax[i0 + u + 1:i0 + tk] -= tx[u, u + 1:tk]
                ay[i0 + u + 1:i0 + tk] -= ty[u, u + 1:tk]
            for w in range(1, tk):  # then upper partners
                ax[i0:i0 + w] += tx[:w, w]
                ay[i0:i0 + w] += ty[:w, w]
            for h0 in range(i0 + TILE, e, TILE):  # the column tiles above
                h1 = min(h0 + TILE, e)
                for u in range(tk):
                    ax[h0:h1] -= tx[u, h0 - i0:h1 - i0]
                    ay[h0:h1] -= ty[u, h0 - i0:h1 - i0]
                for h in range(h0, h1):
                    ax[row] += tx[:, h - i0]
                    ay[row] += ty[:, h - i0]
    return forces.monopole_forces(x, y, m, alive, key, torch.from_numpy(ax),
                                  torch.from_numpy(ay), *tables, NCELLS)


def _hits(xs, ys, r, j, far2, eps):
    """Today's collision test on lanes r and partners j (arrays): dx, dy
    from the lower lane's side, d2 < 4·EPSILON² and sqrt(d2) < EPSILON."""
    dx = np.where(j < r, xs[j] - xs[r], xs[r] - xs[j])
    dy = np.where(j < r, ys[j] - ys[r], ys[r] - ys[j])
    d2 = dx * dx + dy * dy
    with np.errstate(invalid="ignore"):
        return (d2 < far2) & (np.sqrt(d2) < eps)


def _eps(xs):
    t = xs.dtype.type
    return t(EPSILON), t(4) * t(EPSILON) * t(EPSILON)


def window_model(x, y, alive, key, pos, plan, chunk):
    """The collision kernel's search (module docstring): each lane's first
    partner's position in its cell, -1 if none."""
    xs, ys, al = (a.numpy() for a in (x, y, alive))
    eps, far2 = _eps(xs)
    first = np.full(xs.shape[0], -1)
    for s, e in _cells(key, pos, plan):
        for c0 in range(s, e, chunk):
            r = np.arange(c0, min(c0 + chunk, e))
            r = r[al[r] & ~np.isnan(xs[r])]
            best = np.full(r.shape[0], e - s)
            for d0 in range(s, e, chunk):
                part = np.arange(d0, min(d0 + chunk, e))
                part = part[al[part]]
                if not part.size:
                    continue
                part = part[np.argsort(xs[part], kind="stable")]
                p = np.searchsorted(xs[part], xs[r], side="left")
                for step, q in ((1, p), (-1, p - 1)):
                    live = np.ones(r.shape[0], dtype=bool)
                    while True:
                        live &= (q >= 0) & (q < part.size)
                        j = part[np.clip(q, 0, part.size - 1)]
                        w = xs[j] - xs[r]
                        with np.errstate(invalid="ignore"):
                            live &= w * w < far2
                        if not live.any():
                            break
                        hit = live & (j != r) & _hits(xs, ys, r, j, far2,
                                                      eps)
                        best = np.where(hit, np.minimum(best, j - s), best)
                        q = q + step
            first[r] = np.where(best < e - s, best, -1)
    return first


def brute_first(x, y, alive, key, pos, plan):
    """Each alive lane's lowest-position partner that hits, every partner
    tested; -1 if none."""
    xs, ys, al = (a.numpy() for a in (x, y, alive))
    eps, far2 = _eps(xs)
    first = np.full(xs.shape[0], -1)
    for s, e in _cells(key, pos, plan):
        lanes = np.arange(s, e)
        for b in range(s, e, 512):
            r = np.arange(b, min(b + 512, e))
            hit = (_hits(xs, ys, r[:, None], lanes[None, :], far2, eps)
                   & al[r][:, None] & al[None, lanes]
                   & (r[:, None] != lanes[None, :]))
            first[r] = np.where(hit.any(1), hit.argmax(1), -1)
    return first


def _count(first, pos):
    """The pairs first for both ends (the count pass), at their lower end."""
    p = pos.numpy()
    lane = np.arange(first.shape[0])
    low = first > p
    partner = np.where(low, lane - p + first, lane)
    return int((low & (first[partner] == p)).sum())


LAYOUTS = (False, True)
PARITY = [(c, mesh) for c in CASES for mesh in LAYOUTS]


@pytest.mark.parametrize("case,mesh", PARITY, ids=[
    f"{c}-{'mesh' if mesh else 'sorted'}" for c, mesh in PARITY])
def test_parity_model_matches_plain(case, mesh):
    x, y, m, alive, key, pos, plan = _lanes(case, np.float64, mesh)
    tables = stencil.stencil_tables(*sweep.sweep_com_ref(
        x, y, m, key, pos, plan, NCELLS), SIDE, NC)
    got = parity_model(x, y, m, alive, key, pos, plan, tables)
    ref = sweep.sweep_forces_ref(x, y, m, alive, key, pos, plan, tables,
                                 NCELLS)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy().view(np.int64),
                                      b.numpy().view(np.int64))


# Chunks of 4096 lanes (the kernel's most), of 700 (a huge cell's several),
# and far below the largest cell's count: the kernel splits every cell of
# more than 4096 lanes, which holds only if the count and the dead set do
# not depend on the chunk.
WINDOW = [(c, dt, mesh, chunk) for c in CASES
          for dt in (np.float64, np.float32) for mesh in LAYOUTS
          for chunk in ((CHUNK, 700) if c == "huge" else (CHUNK, 700, 256)
                        if c == "wide" else (CHUNK, 8))]


@pytest.mark.parametrize("case,dtype,mesh,chunk", WINDOW, ids=[
    f"{c}-{'f64' if dt == np.float64 else 'f32'}-"
    f"{'mesh' if mesh else 'sorted'}-{chunk}" for c, dt, mesh, chunk in WINDOW])
def test_window_model_matches(case, dtype, mesh, chunk):
    x, y, m, alive, key, pos, plan = _lanes(case, dtype, mesh)
    first = window_model(x, y, alive, key, pos, plan, chunk)
    want = _cached(("brute", case, dtype, mesh),
                   lambda: brute_first(x, y, alive, key, pos, plan))
    np.testing.assert_array_equal(first, want)
    count, died = _cached(("plain", case, dtype, mesh),
                          lambda: sweep.sweep_collisions_ref(
                              x, y, alive, key, pos, plan, EPSILON, NCELLS))
    np.testing.assert_array_equal(first >= 0, died.numpy())
    assert _count(first, pos) == int(count) > 0


def test_wide_plants():
    """The wide cell's plants do what its docstring says: the window edge
    pairs sit at and just inside fl(dx²) = 4·EPSILON² in their type, pid
    500's first partner is pid 100 though pid 900 is nearer in x, the pair
    across a tile boundary and the lane at x < 0 collide."""
    for dtype, (lo, hi), inside in ((np.float64, (1200, 1201), False),
                                    (np.float64, (1202, 1203), True),
                                    (np.float32, (1210, 1211), False),
                                    (np.float32, (1212, 1213), True)):
        x, _, _, _ = adversarial.sweep_particles("wide")
        t = np.dtype(dtype).type
        dx = t(t(x[hi]) - t(x[lo]))
        assert (t(dx * dx) < t(4) * t(EPSILON) * t(EPSILON)) == inside
    x, y, m, alive, key, pos, plan = _lanes("wide", np.float64, False)
    first = brute_first(x, y, alive, key, pos, plan)
    s = int(np.flatnonzero((key.numpy() == 4) & (pos.numpy() == 0))[0])
    assert first[s + 500] == 100 and first[s + 31] == 32
    assert first[s + 63] == 64
    assert abs(x[s + 900] - x[s + 500]) < abs(x[s + 100] - x[s + 500])
    neg = int(np.flatnonzero(x.numpy() < 0)[0])
    assert first[neg] >= 0 and int(key[neg]) == 0
