"""The port's supercell engine on the CPU vs the JAX package's, end to end,
and its two new passes (the cell sums and the rebin's destination hook).

Both engines start from the same host initializer. Collision counts and
dead sets must be exact; positions hold to atol 1e-6·side and velocities to
atol 1e-5·max|v| (``tests/test_torch_engine.py``'s tolerance: the pair and
cell sums run in another order). The port's f32 sweep, which computes the
same function with no tiles, is the second reference, and the JAX
package's general monopole path (``PSIM_SC_HALO=0``) the third.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesimulation_tpu.config import Precision as JPrecision
from particlesimulation_tpu.config import SimConfig as JSimConfig
from particlesimulation_tpu.engine import Engine as JEngine
from particlesimulation_tpu.ops import resident as jres
from particlesimulation_tpu.ops.supercell import (
    choose_supercell_factor as jchoose)
from particlesimulation_tpu_torch.config import SimConfig
from particlesimulation_tpu_torch.engine import Engine
from particlesimulation_tpu_torch.ops import resident as res
from particlesimulation_tpu_torch.ops.cuda import cell_pairs
from particlesimulation_tpu_torch.ops.supercell import (
    choose_supercell_factor, make_supercell_run)
from tests.test_torch_engine import _assert_same_run
from tests.test_torch_ops import _rows, _tile_state

torch.set_num_threads(2)

# The five configs of the JAX package's tests/test_supercell.py: even and
# uneven partitions (S = 3 on 24 and on 25 cells), collisions in a tiny box,
# normal-mode clustering, fast movers across the periodic edge.
CONFIGS = [
    ((1, 3.0, 24, 300), 20),
    ((7, 5.0, 25, 400), 20),
    ((5893, 0.5, 16, 200), 15),
    ((-10, 4.0, 20, 350), 15),
    ((3, 8.0, 16, 200), 30),
]
IDS = ["even", "uneven", "collide", "clustered", "wrap"]


def _jax_supercell(args, steps, kcap=None):
    eng = JEngine(JSimConfig(*args, precision=JPrecision.FAST),
                  impl="supercell", kcap=kcap)
    return eng, eng.run(eng.init_state(), steps)


@pytest.mark.parametrize("args", [
    (50, 10000.0, 1300, 500_000),   # SMALL
    (1, 5000.0, 20, 1_000_000),     # MEDIUM: dense, declined
    (1, 100.0, 1300, 500_000),      # the JAX test's sparse grid
    (1, 100.0, 10, 10_000),         # ... its dense grid
    (1, 1.0, 8, 10),                # ... its tiny grid
    (1, 3.0, 24, 300), (7, 5.0, 25, 400), (5893, 0.5, 16, 200),
    (-10, 4.0, 20, 350), (1, 100.0, 64, 500), (1, 100.0, 15, 200),
    (1, 100.0, 97, 2000),           # prime ncside: no divisor, rounded S
])
def test_choose_supercell_factor_matches_jax(args):
    assert (choose_supercell_factor(SimConfig(*args))
            == jchoose(JSimConfig(*args)))


def test_small_routes_to_supercell():
    """SMALL through the census: supercell with S = 10 (130² rows)."""
    eng = Engine(SimConfig(50, 10000.0, 1300, 500_000), device="cpu")
    assert eng.impl == "supercell" and eng._supercell_factor() == 10
    assert eng._sc_rows() == 130 * 130


@pytest.mark.parametrize("args,steps", CONFIGS, ids=IDS)
def test_supercell_matches_jax(args, steps):
    jeng, ref = _jax_supercell(args, steps)
    eng = Engine(SimConfig(*args), device="cpu")
    got = eng.run(eng.init_state(), steps)
    assert eng.impl == "supercell"
    assert eng._supercell_factor() == jeng._sc_factor
    assert eng.kcap == jeng.kcap
    _assert_same_run(got, ref, args[1])


@pytest.mark.parametrize("args,steps", CONFIGS, ids=IDS)
def test_supercell_matches_sweep(args, steps):
    sweep = Engine(SimConfig(*args), impl="sweep", device="cpu")
    ref = sweep.run(sweep.init_state(), steps)
    eng = Engine(SimConfig(*args), impl="supercell", device="cpu")
    got = eng.run(eng.init_state(), steps)
    _assert_same_run(got, type(ref)(*(t.numpy() for t in ref)), args[1])


def test_supercell_collides():
    """The tiny-box config collides (the count is not trivially 0)."""
    eng = Engine(SimConfig(5893, 0.5, 16, 200), device="cpu")
    assert int(eng.run(eng.init_state(), 15).collisions) > 0


def test_supercell_capacity_retry_lossless():
    """From kcap 32 (a row holds more) the run replays at a larger kcap on
    supercell, losing no particle; the same result as the JAX engine's run
    from kcap 32."""
    args = (-7, 4.0, 24, 600)
    eng = Engine(SimConfig(*args), kcap=32, device="cpu")
    state = eng.init_state()
    assert eng.impl == "supercell" and eng.kcap == 32
    out = eng.run(state, 10)
    assert eng.impl == "supercell" and eng.kcap > 32
    assert torch.equal(torch.sort(out.pid).values,
                       torch.arange(args[3], dtype=torch.int32))
    _, ref = _jax_supercell(args, 10, kcap=32)
    _assert_same_run(out, ref, args[1])


def test_supercell_run_composition():
    """run(8) then run(7) against run(15): the epilogue/prologue round trip
    loses nothing (the prologue puts slots in (row, pid) order, where the
    run keeps rebin order, so the sums run in another order)."""
    args = (1, 3.0, 24, 300)
    eng = Engine(SimConfig(*args), device="cpu")
    state = eng.init_state()
    a = eng.run(eng.run(state, 8), 7)
    b = eng.run(state, 15)
    assert torch.equal(a.pid, b.pid) and torch.equal(a.alive, b.alive)
    assert int(a.collisions) == int(b.collisions)
    for f in ("x", "y"):
        np.testing.assert_allclose(getattr(a, f).numpy(),
                                   getattr(b, f).numpy(), rtol=0,
                                   atol=1e-6 * args[1])


def test_supercell_matches_jax_general_path(monkeypatch):
    """S = 3 divides 24, so the JAX engine takes its halo-table monopole by
    default; PSIM_SC_HALO=0 makes it take the general path, the other
    reference (the port reads no PSIM_* variable)."""
    args, steps = CONFIGS[0]
    monkeypatch.setenv("PSIM_SC_HALO", "0")
    _, ref = _jax_supercell(args, steps)
    eng = Engine(SimConfig(*args), device="cpu")
    _assert_same_run(eng.run(eng.init_state(), steps), ref, args[1])


def test_supercell_pair_tiles_hold_every_particle():
    """``pair_tiles`` (the tiles the chip check holds the labelled kernel
    on): every live particle in one alive slot, labels in [0, S²) on the
    binned slots and -1 elsewhere."""
    cfg = SimConfig(5893, 0.5, 16, 200)
    eng = Engine(cfg, device="cpu")
    state = eng.init_state()
    s = eng._supercell_factor()
    _, pair_tiles, run = make_supercell_run(cfg, eng.kcap, s)
    x, y, mf, alive, pid, sub = pair_tiles(state, 3)
    live = run(state, 2).alive
    assert x.shape == (eng._sc_rows(), eng.kcap)
    assert int(alive.sum()) == int(live.sum()) < cfg.n_particles
    assert bool(((sub >= 0) & (sub < s * s))[mf > 0].all())
    unbinned = sub == -1
    assert bool((mf[unbinned] == 0).all() and (alive[unbinned] == 0).all())


def test_supercell_run_debug_and_facade():
    """``run_debug`` steps supercell one run at a time, and the facade's
    census takes it on a sparse grid; both keep the run's particles,
    deaths and count."""
    from particlesimulation_tpu_torch.models import Simulation

    args = (5893, 0.5, 16, 200)
    out = Simulation(*args, device="cpu").run(6)
    assert out.engine.impl == "supercell"
    eng = Engine(SimConfig(*args), device="cpu")
    dbg = eng.run_debug(eng.init_state(), 6)
    assert int(dbg.collisions) == out.collisions > 0
    assert torch.equal(dbg.pid, out.state.pid)
    assert torch.equal(dbg.alive, out.state.alive)
    np.testing.assert_allclose(dbg.x.numpy(), out.state.x.numpy(), rtol=0,
                               atol=1e-6 * args[1])


def test_supercell_rejects_v1():
    """The ungated v1 kernel has no labelled form: the build refuses it."""
    eng = Engine(SimConfig(1, 3.0, 24, 300), device="cpu", pair_impl="v1")
    assert eng.impl == "supercell"
    with pytest.raises(ValueError, match="v1"):
        eng.run(eng.init_state(), 1)


def test_explicit_supercell_on_declined_grid():
    """An explicit supercell on a grid the chooser declines (ncside < 16)
    coarsens by max(2, ncside // 8), as the JAX engine does: S = 2, uneven
    on 13 cells, held to JAX's supercell and to the sweep."""
    args, steps = (3, 8.0, 13, 150), 12
    assert choose_supercell_factor(SimConfig(*args)) is None
    jeng, ref = _jax_supercell(args, steps)
    eng = Engine(SimConfig(*args), impl="supercell", device="cpu")
    got = eng.run(eng.init_state(), steps)
    assert eng._supercell_factor() == jeng._sc_factor == 2
    assert eng.impl == "supercell" and eng._sc_rows() == 49
    _assert_same_run(got, ref, args[1])
    sweep = Engine(SimConfig(*args), impl="sweep", device="cpu")
    swept = sweep.run(sweep.init_state(), steps)
    _assert_same_run(got, type(swept)(*(t.numpy() for t in swept)), args[1])


# -- the cell sums ----------------------------------------------------------

def _sums_inputs(seed, nc, S, kcap):
    """Super-cell tiles of an nc² grid coarsened by S (uneven where S does
    not divide nc): labels drawn per slot, -1 for a quarter of them."""
    rng = np.random.default_rng(seed)
    nsc = -(-nc // S)
    rows = nsc * nsc
    sy, sx = rng.integers(0, S, (2, rows, kcap))
    scy, scx = np.divmod(np.arange(rows), nsc)
    cy, cx = scy[:, None] * S + sy, scx[:, None] * S + sx
    valid = (cy < nc) & (cx < nc) & (rng.uniform(size=(rows, kcap)) > 0.25)
    cell = np.where(valid, cy * nc + cx, -1).astype(np.int32)
    sub = np.where(valid, sy * S + sx, -1)
    mf = np.where(valid, rng.uniform(0.5, 2.0, (rows, kcap)), 0.0)
    x = rng.uniform(0, nc, (rows, kcap))
    y = rng.uniform(0, nc, (rows, kcap))
    mf, x, y = (a.astype(np.float32) for a in (mf, x, y))
    return mf, mf * x, mf * y, cell, sub


@pytest.mark.parametrize("nc,S,kcap", [(12, 3, 32), (10, 3, 64), (16, 4, 96)])
def test_cell_sums_match_jax_einsum(nc, S, kcap):
    """Against the JAX one-hot contraction einsum("rk,rks->rs") (the JAX
    package's supercell COM), unpacked onto the true grid; empty cells 0."""
    mf, mx, my, cell, sub = _sums_inputs(nc + S + kcap, nc, S, kcap)
    got = cell_pairs.supercell_cell_sums(*map(torch.from_numpy,
                                              (mf, mx, my, cell)), nc * nc)
    onehot = ((jnp.asarray(sub)[:, :, None] == jnp.arange(S * S))
              & jnp.asarray(cell >= 0)[:, :, None]).astype(jnp.float32)
    nsc = -(-nc // S)
    for g, v in zip(got, (mf, mx, my)):
        per = np.asarray(jnp.einsum("rk,rks->rs", jnp.asarray(v), onehot))
        grid = per.reshape(nsc, nsc, S, S).transpose(0, 2, 1, 3).reshape(
            nsc * S, nsc * S)[:nc, :nc].reshape(-1)
        np.testing.assert_allclose(g.numpy(), grid, rtol=1e-6, atol=0)
        assert (g.numpy()[grid == 0] == 0).all()


def test_cell_sums_in_slot_order():
    """The twin on the CPU (and the kernel, by design) adds each cell's
    slots in slot order from 0: a sequential f32 sum, bit for bit."""
    mf, mx, my, cell, _ = _sums_inputs(5, 10, 3, 64)
    got = cell_pairs.supercell_cell_sums(*map(torch.from_numpy,
                                              (mf, mx, my, cell)), 100)
    for g, v in zip(got, (mf, mx, my)):
        want = np.zeros(100, np.float32)
        for c, a in zip(cell.reshape(-1), v.reshape(-1)):
            if c >= 0:
                want[c] = np.float32(want[c] + a)
        np.testing.assert_array_equal(g.numpy(), want)


def test_cell_sums_reject_bad_input():
    mf, mx, my, cell, _ = (torch.from_numpy(a) for a in
                           _sums_inputs(1, 10, 3, 32))
    with pytest.raises(TypeError):
        cell_pairs.supercell_cell_sums(mf, mx, my, cell.to(torch.int64), 100)
    with pytest.raises(ValueError):
        cell_pairs.supercell_cell_sums(mf, mx[:, :16].contiguous(), my, cell,
                                       100)


# -- the rebin's destination hook -------------------------------------------

def _sc_dest(S, nsc):
    """(port dest_fn, JAX mover_fn, JAX dest_fn) of a super-cell grid of
    nsc² rows over S-wide super-cells of unit cells (as ops/supercell.py)."""
    rowid = np.arange(nsc * nsc)[:, None]

    def port(ts):
        scx = (ts.x / S).to(torch.int32)
        scy = (ts.y / S).to(torch.int32)
        valid = (scx >= 0) & (scx < nsc) & (scy >= 0) & (scy < nsc)
        rowk = scy * nsc + scx
        return ts.occ & valid & (rowk != torch.from_numpy(rowid)), rowk

    def geom(st):
        scx = (st.x / S).astype(jnp.int32)
        scy = (st.y / S).astype(jnp.int32)
        valid = (scx >= 0) & (scx < nsc) & (scy >= 0) & (scy < nsc)
        return scx, scy, valid

    def jmover(st):
        scx, scy, valid = geom(st)
        moving = st.occ & valid & (scy * nsc + scx != rowid)
        sx = jnp.sign(jres._wrap_delta(scx - rowid % nsc, nsc))
        sy = jnp.sign(jres._wrap_delta(scy - rowid // nsc, nsc))
        return moving, sx, sy

    def jdest(st):
        scx, scy, valid = geom(st)
        rowk = scy * nsc + scx
        return st.occ & valid & (rowk != rowid), rowk

    return port, jmover, jdest


@pytest.mark.parametrize("nsc,S,kcap,per_row,frac,hop,seed,limbo", [
    (6, 3, 16, 5, 0.5, 1, 21, 0.0),
    (8, 2, 20, 8, 0.7, 3, 22, 0.0),
    (6, 3, 16, 5, 0.5, 2, 23, 0.1),
])
def test_rebin_dest_hook_matches_jax(nsc, S, kcap, per_row, frac, hop, seed,
                                     limbo):
    """Movers between super-cell rows: each row's pid set and the
    undelivered count as JAX ``rebin(..., mover_fn=, dest_fn=)`` gives them,
    and every particle's values moved with it."""
    fields = _tile_state(nsc, kcap, per_row, frac, hop, seed, limbo)
    fields["x"] = fields["x"] * S
    fields["y"] = fields["y"] * S
    side = float(nsc * S)
    port, jmover, jdest = _sc_dest(S, nsc)
    # New tensors: rebin writes the tiles in place, and the test compares
    # the result with ``fields``.
    ts = res.TileState(**{k: torch.tensor(v) for k, v in fields.items()})
    jts = jres.TileState(**{k: jnp.asarray(v) for k, v in fields.items()})
    out, left = res.rebin(ts, side, nsc, kcap, dest_fn=port)
    jout, jleft = jres.rebin(jts, side, nsc, kcap, mover_fn=jmover,
                             dest_fn=jdest)
    assert int(left) == int(jleft) == 0
    occ, pid = out.occ.numpy(), out.pid.numpy()
    assert _rows(occ, pid) == _rows(np.asarray(jout.occ),
                                    np.asarray(jout.pid))
    assert _rows(occ, pid) != _rows(fields["occ"], fields["pid"])
    src = {int(p): i for i, p in enumerate(fields["pid"].reshape(-1))
           if p >= 0}
    idx = np.array([src[int(p)] for p in pid[occ]])
    for f in ("x", "y", "vx", "vy", "m"):
        np.testing.assert_array_equal(getattr(out, f).numpy()[occ],
                                      fields[f].reshape(-1)[idx])


def test_rebin_default_dest_unchanged():
    """Without a hook the rebin is the cell grid's, as before."""
    fields = _tile_state(6, 12, 3, 0.5, 1, 31)

    def tiles():  # rebin writes the tiles in place: each call its own
        return res.TileState(**{k: torch.tensor(v)
                                for k, v in fields.items()})

    out, left = res.rebin(tiles(), 6.0, 6, 12)

    def cells(t):
        cx, cy, valid = res.cell_of(t.x, t.y, 6.0, 6)
        return t.occ & valid & (cy * 6 + cx != torch.arange(36)[:, None]), \
            cy * 6 + cx

    hooked, hleft = res.rebin(tiles(), 6.0, 6, 12, dest_fn=cells)
    assert int(left) == int(hleft) == 0
    for a, b in zip(out, hooked):
        assert torch.equal(a, b)
