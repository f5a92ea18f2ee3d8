"""The port's plain torch ops vs the JAX package's, on the same NumPy inputs.

Integer outputs must be exact. The binning, stencil and integrate ops keep
the JAX package's operation order and hold bit for bit. The monopole pass
holds to rtol 1e-6 with atol 1e-6·max|f|: torch.rsqrt and XLA's rsqrt may
differ by an ulp, and the 8 terms then sum the same way.

``rebin`` delivers movers in one pass where the JAX package uses delivery
rounds, so slot positions differ; it is held on each row's set of pids, on
each particle's moved values and on the undelivered count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesimulation_tpu.ops import binning as jbinning
from particlesimulation_tpu.ops import dense_xla as jdense
from particlesimulation_tpu.ops import integrate as jintegrate
from particlesimulation_tpu.ops import resident as jres
from particlesimulation_tpu.ops import stencil as jstencil
from particlesimulation_tpu_torch.ops import binning, dense, integrate, stencil
from particlesimulation_tpu_torch.ops import resident as res

torch.set_num_threads(2)


def _eq(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_cell_keys_exact():
    rng = np.random.default_rng(0)
    side, nc = 7.5, 6
    # Include out-of-range positions on both sides (PANIC2 sentinel).
    x = rng.uniform(-1.0, side + 1.0, 500).astype(np.float32)
    y = rng.uniform(-1.0, side + 1.0, 500).astype(np.float32)
    key, valid = binning.cell_keys(torch.from_numpy(x), torch.from_numpy(y),
                                   side, nc)
    jkey, jvalid = jbinning.cell_keys(jnp.asarray(x), jnp.asarray(y), side, nc)
    _eq(key, jkey)
    _eq(valid, jvalid)
    assert (~valid).any()


def test_sort_and_segments_exact():
    rng = np.random.default_rng(1)
    n, ncells = 400, 17
    key = rng.integers(0, ncells + 1, n).astype(np.int32)
    pid = rng.permutation(n).astype(np.int32)
    x = rng.uniform(size=n).astype(np.float32)
    got = binning.sort_by_cell(torch.from_numpy(key), torch.from_numpy(pid),
                               torch.from_numpy(x))
    ref = jbinning.sort_by_cell(jnp.asarray(key), jnp.asarray(pid),
                                jnp.asarray(x))
    for a, b in zip(got, ref):
        _eq(a, b)
    pos, first = binning.segment_positions(got[0])
    jpos, jfirst = jbinning.segment_positions(ref[0])
    _eq(pos, jpos)
    _eq(first, jfirst)
    valid = got[0] < ncells
    assert int(binning.max_occupancy(pos, valid)) == int(
        jbinning.max_occupancy(jpos, jnp.asarray(valid.numpy())))


@pytest.mark.parametrize("nc", [1, 2, 3, 5])
def test_stencil_tables_exact(nc):
    rng = np.random.default_rng(nc)
    side = 10.0
    M = rng.uniform(0, 2, nc * nc).astype(np.float32)
    MX = rng.uniform(0, side, nc * nc).astype(np.float32)
    MY = rng.uniform(0, side, nc * nc).astype(np.float32)
    got = stencil.stencil_tables(torch.from_numpy(M), torch.from_numpy(MX),
                                 torch.from_numpy(MY), side, nc)
    ref = jstencil.stencil_tables(jnp.asarray(M), jnp.asarray(MX),
                                  jnp.asarray(MY), side, nc)
    for a, b in zip(got, ref):
        _eq(a, b)


def test_integrate_exact():
    rng = np.random.default_rng(2)
    n, side = 1000, 5.0
    x = rng.uniform(0, side, n).astype(np.float32)
    y = rng.uniform(0, side, n).astype(np.float32)
    vx = rng.normal(0, 2.0, n).astype(np.float32)   # some wrap the box
    vy = rng.normal(0, 2.0, n).astype(np.float32)
    m = rng.uniform(0.1, 1.0, n).astype(np.float32)
    m[::7] = 0.0                                     # frozen slots
    fx = rng.normal(0, 1e-3, n).astype(np.float32)
    fy = rng.normal(0, 1e-3, n).astype(np.float32)
    args = (x, y, vx, vy, m, fx, fy)
    got = integrate.integrate(*map(torch.from_numpy, args), side, 0.1)
    ref = jintegrate.integrate(*map(jnp.asarray, args), side, 0.1)
    for a, b in zip(got, ref):
        _eq(a, b)
    np.testing.assert_array_equal(got[0].numpy()[::7], x[::7])


def test_monopole_tile_forces():
    rng = np.random.default_rng(3)
    ncells, kcap = 9, 32
    xd = rng.uniform(0, 3, (ncells, kcap)).astype(np.float32)
    yd = rng.uniform(0, 3, (ncells, kcap)).astype(np.float32)
    md = rng.uniform(0, 1, (ncells, kcap)).astype(np.float32)
    md[:, 20:] = 0.0
    ml = rng.uniform(0, 5, (ncells, 8)).astype(np.float32)
    mxl = rng.uniform(-3, 6, (ncells, 8)).astype(np.float32)
    myl = rng.uniform(-3, 6, (ncells, 8)).astype(np.float32)
    mxl[0, 0], myl[0, 0] = xd[0, 0], yd[0, 0]        # a d²=0 term
    args = (xd, yd, md, ml, mxl, myl)
    got = dense.monopole_tile_forces(*map(torch.from_numpy, args))
    ref = jdense.monopole_tile_forces(*map(jnp.asarray, args))
    for a, b in zip(got, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(b).max()))


def _tile_state(ncside, kcap, per_row, move_frac, hop, seed, limbo=0.0):
    """Tiles with ``per_row`` residents per row, a share of them positioned
    up to ``hop`` cells away (wrapping the box edges) and a share ``limbo``
    out of the box (they stay where they are)."""
    rng = np.random.default_rng(seed)
    ncells = ncside * ncside
    shape = (ncells, kcap)
    x, y = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    occ = np.zeros(shape, bool)
    pid = np.full(shape, -1, np.int32)
    p = 0
    for c in range(ncells):
        cy0, cx0 = divmod(c, ncside)
        for k in range(per_row):
            dx = dy = 0
            if rng.random() < move_frac:
                dx, dy = rng.integers(-hop, hop + 1, 2)
            occ[c, k] = True
            x[c, k] = (cx0 + dx) % ncside + 0.1 + 0.8 * rng.random()
            y[c, k] = (cy0 + dy) % ncside + 0.1 + 0.8 * rng.random()
            if rng.random() < limbo:
                x[c, k] += ncside
            pid[c, k] = p
            p += 1
    vx = rng.normal(size=shape).astype(np.float32)
    vy = rng.normal(size=shape).astype(np.float32)
    m = np.where(occ, rng.uniform(0.5, 1.0, shape), 0.0).astype(np.float32)
    return dict(x=x, y=y, vx=vx, vy=vy, m=m, occ=occ, pid=pid,
                collisions=np.int64(0), panics=np.int32(0),
                overflow=np.int32(0))


def _run_both(fields, ncside, kcap):
    side = float(ncside)
    ts = res.TileState(**{k: torch.as_tensor(v) for k, v in fields.items()})
    jts = jres.TileState(**{k: jnp.asarray(v) for k, v in fields.items()})
    out, left = res.rebin(ts, side, ncside, kcap)
    jout, jleft = jres.rebin(jts, side, ncside, kcap)
    return out, int(left), jout, int(jleft)


def _rows(occ, pid):
    return [sorted(pid[r][occ[r]].tolist()) for r in range(occ.shape[0])]


@pytest.mark.parametrize("ncside,kcap,per_row,frac,hop,seed,limbo", [
    (8, 12, 3, 0.5, 1, 11, 0.0),     # half the particles cross to a neighbour
    (10, 16, 6, 0.7, 3, 12, 0.0),    # multi-cell hops, heavy traffic
    (8, 12, 4, 0.5, 2, 13, 0.1),     # some particles out of the box
])
def test_rebin_matches_jax(ncside, kcap, per_row, frac, hop, seed, limbo):
    fields = _tile_state(ncside, kcap, per_row, frac, hop, seed, limbo)
    out, left, jout, jleft = _run_both(fields, ncside, kcap)
    assert left == jleft == 0
    occ, pid = out.occ.numpy(), out.pid.numpy()
    assert _rows(occ, pid) == _rows(np.asarray(jout.occ), np.asarray(jout.pid))
    # Every particle's values moved with it, bit for bit.
    src = {int(p): i for i, p in enumerate(fields["pid"].reshape(-1))
           if p >= 0}
    idx = np.array([src[int(p)] for p in pid[occ]])
    for f in ("x", "y", "vx", "vy", "m"):
        np.testing.assert_array_equal(getattr(out, f).numpy()[occ],
                                      fields[f].reshape(-1)[idx])
    assert (out.m.numpy()[~occ] == 0).all()


def test_rebin_full_row_undelivered():
    """Arrivals beyond a full row's free slots count as undelivered, as in
    the JAX package, and no mover moves (the engine replays the run)."""
    ncside, kcap = 4, 8
    fields = _tile_state(ncside, kcap, 0, 0.0, 0, 0)
    x, y, occ, pid, m = (fields[k] for k in ("x", "y", "occ", "pid", "m"))
    # Row 5 = cell (1, 1): full of residents that stay.
    occ[5, :] = True
    x[5, :], y[5, :] = 1.5, 1.2 + 0.05 * np.arange(kcap)
    pid[5, :] = np.arange(kcap)
    # Two movers in row 4 = cell (0, 1), positioned in cell (1, 1).
    occ[4, :2] = True
    x[4, :2], y[4, :2] = 1.3, 1.4
    pid[4, :2] = (50, 51)
    m[...] = np.where(occ, 1.0, 0.0)
    out, left, _, jleft = _run_both(fields, ncside, kcap)
    assert left == jleft == 2
    for f in ("x", "y", "m", "occ", "pid"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), fields[f])
