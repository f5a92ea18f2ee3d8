"""A NumPy model of the sweep's COM kernel's schedule (``csrc/sweep.cu``
``sweep_com_kernel``), held on the CPU against the plain version
(``ops/com``) and the JAX package's ``com_parity`` / ``com_fast``, and a
model of its parity division in exact arithmetic against IEEE division.

The schedule: block b owns the cells whose first lane (pos 0) lies in its
stretch of lanes, found 32 lanes a ballot and handed out 32 cells a group
in lane order (a sentinel lane at pos 0 takes a slot and no lanes); a
group of g cells (rounded up to a power of two) walks them in rounds of
32·(32/g) lanes a cell, staged, the prefix masses (parity) run serially,
m·x and m·y (x and y where the prefix mass is 0) and the divisors'
reciprocals computed apart, then the chain, carried from round to round;
empty cells are zeroed. ``com_schedule`` runs that
order, every cell of a group in lockstep, at several stretches (one cell a
block, cells across stretch boundaries, many groups a block). Parity must
give the plain version's and JAX's bits; fast the sums in position order
bit for bit (the parent kernel's), and JAX's segment sums within the
tolerance ``chip_smoke.py`` states for the f32 COM.

The division: where n and d both have binary exponents in [-510, 510]
the kernel takes q0 = RN(n·r), r = RN(1/d), then two fma corrections;
elsewhere IEEE's. ``div_model`` runs that sequence with each fma rounded
once (``fractions.Fraction``), and must equal NumPy's n / d bit for bit on
random operands, divisors of all-ones mantissas, quotients next to a
rounding midpoint, and operands and quotients at the range's edges.

Inputs: ``adversarial.sweep_particles`` (the 2600-lane "wide" and the
10 000-lane "huge" cells among them) and ``adversarial.com_particles``
(massless runs, lengths about the round, masses across float64's exponent
range, 7680 one-lane cells), sorted and in the mesh's lane layout.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesimulation_tpu.ops import com as jcom
from particlesimulation_tpu_torch.ops import binning, com
from particlesimulation_tpu_torch.ops.cuda import adversarial

torch.set_num_threads(2)

ROUND = adversarial.COM_ROUND   # csrc/sweep.cu kComLanes
SCAN = 4 * 24                   # csrc/sweep.cu kComWarps * kComScan
DIV_LO, DIV_HI = 1023 - 510, 1023 + 510   # kDivLo, kDivHi
_CACHE = {}


def _grid(case):
    if case == "com":
        return adversarial.COM_SIDE, adversarial.COM_NCSIDE
    return adversarial.SWEEP_SIDE, adversarial.SWEEP_NCSIDE


def _lanes(case, dtype, mesh):
    """x, y, m, key, pos (NumPy, the kernel's lane order: sorted by (key,
    pid), or the mesh's layout of those), counts ((ncells + 1,)), ncells;
    and the sorted torch lanes (x, y, m, key, pos)."""
    k = (case, dtype, mesh)
    if k not in _CACHE:
        side, nc = _grid(case)
        make = (adversarial.com_particles if case == "com"
                else lambda: adversarial.sweep_particles(case))
        x, y, m, _ = make()
        x, y, m = (torch.from_numpy(a.astype(dtype)) for a in (x, y, m))
        key, _ = binning.cell_keys(x, y, side, nc)
        key, _, x, y, m = binning.sort_by_cell(
            key, torch.arange(x.shape[0], dtype=torch.int32), x, y, m)
        pos, _ = binning.segment_positions(key)
        ncells = nc * nc
        perm = (adversarial.mesh_lane_order(key.numpy(), ncells) if mesh
                else np.arange(x.shape[0]))
        lanes = [a.numpy()[perm] for a in (x, y, m, key, pos)]
        counts = np.bincount(lanes[3], minlength=ncells + 1)
        _CACHE[k] = (lanes, counts, ncells, (x, y, m, key, pos))
    return _CACHE[k]


# --- The parity division --------------------------------------------------


def div_range(v):
    """csrc/sweep.cu div_range: v's binary exponent in [-510, 510]."""
    e = (np.asarray(v, np.float64).view(np.uint64) >> np.uint64(52)) & \
        np.uint64(0x7FF)
    return (e >= DIV_LO) & (e <= DIV_HI)


def rcp_ok(v):
    """csrc/sweep.cu rcp_ok: a numerator the reciprocal division takes: in
    div_range, or +0."""
    return div_range(v) | (np.asarray(v, np.float64).view(np.uint64) == 0)


def com_plain(v):
    """csrc/sweep.cu com_plain: +0 or in [2^-200, 2^200]."""
    v = np.asarray(v, np.float64)
    return (v.view(np.uint64) == 0) | ((v >= 2.0 ** -200) & (v <= 2.0 ** 200))


def _fma(a, b, c):
    """RN(a·b + c), rounded once."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def div_by_rcp(n, d, r):
    """csrc/sweep.cu div_by_rcp: q0 = RN(n·r), then two corrections."""
    q = float(np.float64(n) * np.float64(r))
    e = _fma(-d, q, n)
    q = _fma(e, r, q)
    e = _fma(-d, q, n)
    return _fma(e, r, q)


def div_model(n, d):
    """The COM chain's quotient: the reciprocal division where d lies in
    div_range and n is rcp_ok, else IEEE's (NumPy's)."""
    if rcp_ok(n) and div_range(d):
        return div_by_rcp(float(n), float(d), float(1.0 / np.float64(d)))
    return float(np.float64(n) / np.float64(d))


def _bits(v):
    return np.asarray(v, np.float64).view(np.uint64)


def _near_midpoints(rng, k, eq, ed):
    """(n, d): d random (or of an all-ones mantissa every third), n =
    RN(d·(q + ulp(q)/2)) for a random q of exponent eq (or, every fourth,
    q - ulp(q)/2): n / d lies next to a rounding midpoint."""
    out = []
    for i in range(k):
        d = float(np.ldexp(rng.uniform(1.0, 2.0) if i % 3 else 2 - 2 ** -52,
                           ed))
        q = float(np.ldexp(rng.uniform(1.0, 2.0), eq))
        half = Fraction(2) ** (eq - 53) * (-1 if i % 4 == 3 else 1)
        out.append((float(Fraction(d) * (Fraction(q) + half)), d))
    return out


def _division_cases():
    rng = np.random.default_rng(3)
    cases = {}
    e = rng.integers(-500, 500, (2000, 2))
    cases["random"] = list(zip(
        np.ldexp(rng.uniform(1.0, 2.0, 2000) * rng.choice([-1, 1], 2000),
                 e[:, 0]).tolist(),
        np.ldexp(rng.uniform(1.0, 2.0, 2000), e[:, 1]).tolist()))
    ones = 2 - 2.0 ** -52
    cases["all-ones divisors"] = [
        (float(np.ldexp(rng.uniform(1.0, 2.0), int(a))),
         float(np.ldexp(ones, int(b))))
        for a, b in rng.integers(-500, 500, (600, 2))]
    cases["near midpoints"] = [
        p for eq, ed in rng.integers(-240, 240, (40, 2))
        for p in _near_midpoints(rng, 40, int(eq), int(ed))]
    # Operands at the range's edges (in: ±510; out: ±511), and quotients
    # at its ends (2^-1020 .. 2^1021).
    edge = []
    for en in (-511, -510, -509, 509, 510, 511):
        for ed in (-511, -510, -509, 509, 510, 511):
            for _ in range(6):
                edge.append((float(np.ldexp(rng.uniform(1.0, 2.0), en)),
                             float(np.ldexp(rng.uniform(1.0, 2.0), ed))))
    edge += [(float(np.ldexp(rng.uniform(1.0, 1.01), -510)),
              float(np.ldexp(2 - 2 ** -52, 510))),
             (float(np.ldexp(2 - 2 ** -52, 510)), float(np.ldexp(1.0, -510))),
             (float(np.ldexp(1.0, -510)), float(np.ldexp(1.0, 510))),
             (float(np.ldexp(1.5, 510)), float(np.ldexp(1.25, -510)))]
    edge += _near_midpoints(rng, 60, -1019, 510 - 1) + _near_midpoints(
        rng, 60, 1019, -510)
    cases["range edges"] = edge
    cases["zero numerators"] = [(0.0, float(np.ldexp(rng.uniform(1, 2), e)))
                                for e in range(-510, 511, 17)]
    cases["outside"] = [(-0.0, 3.0), (1.0, 0.0), (np.inf, 2.0),
                        (2.0, np.inf), (np.nan, 1.0), (5e-324, 1.0),
                        (1.0, 1e-310), (1e308, 1e-300)]
    return cases


DIVISION = _division_cases()


@pytest.mark.parametrize("which", sorted(DIVISION))
def test_division_model_is_ieee(which):
    """The kernel's parity quotient equals IEEE's bit for bit; where both
    operands lie in div_range it came from the reciprocal and the two
    corrections, which must then also equal it on their own."""
    pairs = DIVISION[which]
    n = np.array([p[0] for p in pairs])
    d = np.array([p[1] for p in pairs])
    with np.errstate(all="ignore"):
        want = n / d
    got = np.array([div_model(a, b) for a, b in pairs])
    assert np.array_equal(_bits(got), _bits(want)), which
    inside = rcp_ok(n) & div_range(d)
    if which == "outside":
        assert not inside.any()
    elif which == "range edges":
        assert 0 < inside.sum() < len(pairs)
    else:
        assert inside.all()
    seq = np.array([div_by_rcp(a, b, 1.0 / b)
                    for a, b in zip(n[inside], d[inside])])
    assert np.array_equal(_bits(seq), _bits(want[inside]))


def test_division_cases_see_faults():
    """The cases can see a fault in the sequence: q0 alone (no correction)
    differs from IEEE's quotient on many of them; and the sequence on a
    numerator of -0 gives +0 where IEEE's gives -0, which is why -0 is not
    rcp_ok."""
    pairs = DIVISION["near midpoints"] + DIVISION["random"]
    wrong = sum(a * (1.0 / b) != a / b for a, b in pairs)
    assert wrong > len(pairs) // 10
    assert _bits(div_by_rcp(-0.0, 3.0, 1.0 / 3.0)) != _bits(-0.0 / 3.0)
    assert rcp_ok(0.0) and not rcp_ok(-0.0) and not div_range(0.0)


# --- The schedule -----------------------------------------------------------


def com_schedule(x, y, m, key, pos, counts, ncells, stretch, parity,
                 div=None):
    """(M, MX, MY, written): the COM kernel's schedule at ``stretch`` lanes a
    block; ``div(n, d)`` the parity quotient (default NumPy's, which
    ``div_model`` equals). ``written`` counts each cell's writes."""
    n = x.shape[0]
    dt = x.dtype
    M, MX, MY = (np.full(ncells, np.nan, dt) for _ in range(3))
    written = np.zeros(ncells, np.int64)
    empty = counts[:ncells] == 0
    M[empty] = MX[empty] = MY[empty] = 0
    written += empty
    for s0 in range(0, n, stretch):
        s1 = min(n, s0 + stretch)
        starts = []
        for base in range(s0, s1, 32 * SCAN):
            lanes = np.arange(base, min(base + 32 * SCAN, s1))
            starts.extend(lanes[pos[lanes] == 0].tolist())
        for g in range(0, len(starts), 32):
            _group(np.array(starts[g:g + 32]), x, y, m, key, counts, ncells,
                   parity, div, (M, MX, MY), written)
    return M, MX, MY, written


def _group(s, x, y, m, key, counts, ncells, parity, div, out, written):
    """One group of up to 32 cells (first lanes ``s``), in lockstep."""
    dt = x.dtype
    k = key[s]
    valid = (k >= 0) & (k < ncells)
    ln = np.where(valid, counts[np.where(valid, k, 0)], 0)
    g = s.shape[0]
    span = ROUND * (32 // (1 << (g - 1).bit_length()))
    m0, a, b = (np.zeros(g, dt) for _ in range(3))
    wild = np.zeros(g, bool)
    for o in range(0, int(ln.max()), span):
        cnt = np.clip(ln - o, 0, span)
        t_ = np.arange(span)[:, None]
        live = t_ < cnt[None, :]
        at = np.where(live, s[None, :] + o + t_, 0)
        X, Y, Mr = (np.where(live, v[at], np.nan).astype(dt)
                    for v in (x, y, m))
        with np.errstate(all="ignore"):
            if parity:
                Dp = np.zeros((span + 1, g), dt)
                Dp[0] = m0
                for t in range(int(cnt.max())):
                    m0 = np.where(live[t], m0 + Mr[t], m0)
                    Dp[t + 1] = m0
                steps = int(cnt.max())
                prev, d = Dp[:-1], Dp[1:]
                PX = np.where(prev == 0, X, Mr * X)
                PY = np.where(prev == 0, Y, Mr * Y)
                wild |= (live & ~(com_plain(X) & com_plain(Y)
                                  & com_plain(Mr))).any(axis=0)
                NA, NB = (np.zeros((steps, g), dt) for _ in range(2))
                for t in range(steps):
                    na = NA[t] = a * prev[t] + PX[t]
                    nb = NB[t] = b * prev[t] + PY[t]
                    if div is None:
                        qa, qb = na / d[t], nb / d[t]
                    else:
                        qa = np.array([div(u, v) if w else np.nan
                                       for u, v, w in zip(na, d[t], live[t])])
                        qb = np.array([div(u, v) if w else np.nan
                                       for u, v, w in zip(nb, d[t], live[t])])
                    step = live[t] & (prev[t] != 0)
                    adopt = live[t] & (prev[t] == 0)
                    a = np.where(step, qa, np.where(adopt, PX[t], a))
                    b = np.where(step, qb, np.where(adopt, PY[t], b))
                # A cell in range takes the reciprocal division at every
                # step without a test: its operands must allow it.
                fast = (live & ~wild & (prev != 0))[:steps]
                assert (rcp_ok(NA) & rcp_ok(NB) & div_range(d[:steps]))[
                    fast].all()
            else:
                PX, PY = Mr * X, Mr * Y
                for t in range(int(cnt.max())):
                    m0 = np.where(live[t], m0 + Mr[t], m0)
                    a = np.where(live[t], a + PX[t], a)
                    b = np.where(live[t], b + PY[t], b)
    M, MX, MY = out
    for c in np.flatnonzero(ln > 0):
        kc = k[c]
        M[kc] = m0[c]
        if parity:
            MX[kc], MY[kc] = a[c], b[c]
        else:
            with np.errstate(all="ignore"):
                MX[kc] = a[c] / m0[c] if m0[c] > 0 else 0
                MY[kc] = b[c] / m0[c] if m0[c] > 0 else 0
        written[kc] += 1


def position_sums(x, y, m, key, pos, ncells):
    """The fast COM summed in position order, each cell alone (the parent
    kernel's order): M, Σm·x / M, Σm·y / M."""
    dt = x.dtype
    M, MX, MY = (np.zeros(ncells, dt) for _ in range(3))
    real = (key >= 0) & (key < ncells)
    order = np.lexsort((pos, key))
    order = order[real[order]]
    with np.errstate(all="ignore"):
        for kc in np.unique(key[order]):
            lanes = order[key[order] == kc]
            mm = np.add.accumulate(m[lanes], dtype=dt)[-1]
            sx = np.add.accumulate(m[lanes] * x[lanes], dtype=dt)[-1]
            sy = np.add.accumulate(m[lanes] * y[lanes], dtype=dt)[-1]
            M[kc] = mm
            MX[kc] = sx / mm if mm > 0 else 0
            MY[kc] = sy / mm if mm > 0 else 0
    return M, MX, MY


def _jax_com(case, dtype):
    key_ = ("jax", case, dtype)
    if key_ not in _CACHE:
        _, _, ncells, (x, y, m, key, _) = _lanes(case, dtype, False)
        fn = jcom.com_parity if dtype == np.float64 else jcom.com_fast
        out = fn(jnp.asarray(key.numpy()), jnp.asarray(x.numpy()),
                 jnp.asarray(y.numpy()), jnp.asarray(m.numpy()), ncells)
        _CACHE[key_] = tuple(np.asarray(v) for v in out)
    return _CACHE[key_]


def _f32_tolerance_ok(got, ref, x, y, m, key, ncells):
    """chip_smoke's f32 COM tolerance: each cell's c sums in another order,
    |dM| <= c·u·M + u·M, the quotients (2cu + 2u)·Σ|m·v|/M + u·|q|; the
    non-finite values (overflowing masses) alike in both."""
    u = 2.0 ** -24
    real = (key >= 0) & (key < ncells)
    kc = key[real]
    c = np.bincount(kc, minlength=ncells)[:ncells].astype(np.float64)
    M = np.bincount(kc, m[real].astype(np.float64), ncells)[:ncells]
    ok = True
    for q, v in ((0, None), (1, x), (2, y)):
        g, r = got[q].astype(np.float64), ref[q].astype(np.float64)
        ok &= np.array_equal(np.isfinite(g), np.isfinite(r))
        fin = np.isfinite(g) & np.isfinite(r) & np.isfinite(M)
        if q == 0:
            tol = c * u * M + u * M
        else:
            S = np.bincount(kc, np.abs(m[real].astype(np.float64)
                                       * v[real]), ncells)[:ncells]
            with np.errstate(all="ignore"):
                tol = (2 * c * u + 2 * u) * S / np.where(M > 0, M, 1) + (
                    u * np.abs(r))
        ok &= bool((np.abs(g - r)[fin] <= tol[fin]).all())
    return ok


CASES = ("planted", "hot", "wide", "huge", "com")
STRETCHES = (32, 96, 2528)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", (np.float64, np.float32))
@pytest.mark.parametrize("mesh", (False, True), ids=("sorted", "mesh"))
def test_schedule(case, dtype, mesh):
    """The schedule at three stretches: every cell written once; parity
    the plain version's and JAX's bits; fast the position-order sums' bits
    and JAX's within tolerance."""
    (x, y, m, key, pos), counts, ncells, sorted_ = _lanes(case, dtype, mesh)
    parity = dtype == np.float64
    for stretch in STRETCHES + (32 * ((x.shape[0] + 31) // 32),):
        got = com_schedule(x, y, m, key, pos, counts, ncells, stretch,
                           parity)
        assert (got[3] == 1).all(), (stretch, np.flatnonzero(got[3] != 1))
        if stretch == STRETCHES[0]:
            first = got
        else:
            for a, b in zip(got[:3], first[:3]):
                assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    got = first[:3]
    if parity:
        tx, ty, tm, tk, tp = sorted_
        plain = com.com_parity(tk, tx, ty, tm, ncells, None, tp)
        # XLA's CPU backend flushes subnormals to zero (the port, the card
        # and the reference keep them): in the cells holding a subnormal
        # mass JAX must give the plain version's bits on flushed masses.
        tm_ = tm.numpy()
        tiny = (tm_ != 0) & (np.abs(tm_) < np.finfo(np.float64).tiny)
        sub = np.zeros(ncells, bool)
        sub[tk.numpy()[tiny & (tk.numpy() < ncells)]] = True
        flushed = com.com_parity(tk, tx, ty, torch.where(
            torch.from_numpy(tiny), tm * 0, tm), ncells, None, tp)
        for a, b, f, c in zip(got, plain, flushed, _jax_com(case, dtype)):
            assert np.array_equal(_bits(a), _bits(b.numpy()))
            want = np.where(sub, f.numpy(), a)
            assert np.array_equal(_bits(want), _bits(c))
        assert sub.any() == (case == "com")
    else:
        want = position_sums(x, y, m, key, pos, ncells)
        for a, b in zip(got, want):
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
        ref = _jax_com(case, dtype)
        assert _f32_tolerance_ok(got, ref, x, y, m, key, ncells)


@pytest.mark.parametrize("case", ("planted", "hot", "com"))
@pytest.mark.parametrize("mesh", (False, True), ids=("sorted", "mesh"))
def test_schedule_with_exact_division(case, mesh):
    """Parity with the kernel's division sequence itself (``div_model``,
    each fma rounded once): the plain version's bits, and the COM case
    takes both the reciprocal and __ddiv_rn on each side of the edges."""
    (x, y, m, key, pos), counts, ncells, sorted_ = _lanes(case, np.float64,
                                                          mesh)
    used = {"rcp": 0, "ieee": 0}

    def div(n, d):
        used["rcp" if div_range(n) and div_range(d) else "ieee"] += 1
        return div_model(n, d)

    got = com_schedule(x, y, m, key, pos, counts, ncells, 96, True, div)
    tx, ty, tm, tk, tp = sorted_
    plain = com.com_parity(tk, tx, ty, tm, ncells, None, tp)
    for a, b in zip(got[:3], plain):
        assert np.array_equal(_bits(a), _bits(b.numpy()))
    assert used["rcp"] > 0
    if case == "com":
        assert used["ieee"] > 0


def test_com_case():
    """``adversarial.com_particles`` holds what it promises: massless runs
    at cells' starts (one past a round), cells of a round and of a round
    plus one, thousands of one-lane cells between empty ones, masses on
    both sides of the division's range edges, sentinels."""
    (x, y, m, key, pos), counts, ncells, _ = _lanes("com", np.float64, False)
    real = counts[:ncells]
    assert {31, 32, 33, 64, 65, 300, 1023, 1024, 1025} <= set(real.tolist())
    nc = adversarial.COM_NCSIDE
    ones = np.flatnonzero(real == 1)
    ones = ones[ones >= 8 * nc]
    assert ones.shape[0] == 7680
    # between empty ones: a one-lane cell's row neighbours are empty
    inner = ones[(ones % nc > 0) & (ones % nc < nc - 1)]
    assert (real[inner - 1] == 0).all() and (real[inner + 1] == 0).all()
    first = m[pos == 0]
    assert (first == 0).sum() >= 4
    lead = m[(key == 2) & (pos < 40)]
    assert lead.shape[0] == 40 and (lead == 0).all()
    e = np.frexp(m[m > 0])[1] - 1
    for edge in (-511, -510, 510, 511):
        assert (e == edge).any()
    assert e.min() <= -1074 and e.max() >= 1022
    for edge in (-201, -200, 199, 200):
        assert (e == edge).any()
    nc = adversarial.COM_NCSIDE
    assert (key[x.view(np.uint64) == 0] == 4 * nc).sum() == 2
    assert (key[x.view(np.uint64) == np.uint64(1 << 63)] == 5 * nc).sum() == 2
    assert (key[y.view(np.uint64) == 0] == 5).sum() == 2
    assert counts[ncells] == 20


def test_stretches_split_cells():
    """The stretches the tests use put cell starts in several blocks, a cell
    across stretch boundaries, and more than 32 cells in one block (several
    groups), so each branch of the schedule runs."""
    (x, y, m, key, pos), counts, ncells, _ = _lanes("com", np.float64, True)
    starts = np.flatnonzero(pos == 0)
    ends = starts + np.where(key[starts] < ncells,
                             counts[np.minimum(key[starts], ncells)], 0)
    for stretch in STRETCHES:
        block = starts // stretch
        assert ((ends - 1) // stretch > block).any()
        assert np.bincount(block).max() > 32 or stretch == 32
