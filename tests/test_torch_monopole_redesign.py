"""The two monopole + integrate kernels of ``csrc/advance.cu`` as the
card runs them, modelled on the CPU:

* ``monopole_supercell_kernel`` (``advance.supercell_monopole_integrate``,
  the super-cell routes on one device and on the mesh): a block a
  super-cell row stages its (h + 2) x (w + 2) neighbourhood of temp cells
  from the cell sums (each position as the temp cell of the box's one cell
  and direction that reads it) and each live slot reads its 8 terms there
  by its cell's place, or builds them from the sums where its cell lies
  outside its row's box, or takes the sentinel's zeros. A torch model of
  that addressing (``_model_super``) is held bit for bit to the plain
  chain's tables (``ops/cuda/stencil.grid_tables_ref`` /
  ``halo_tables_ref`` from the sums) at every live slot's index, its terms
  through the plain physics to the wrapper's result, and both to the JAX
  package's ``stencil_tables`` / ``stencil_tables_halo`` (the physics
  within rtol 1e-6: torch's and XLA's rsqrt round apart on the CPU);
* ``monopole_pool_kernel`` (a thread a slot, its row found from the runs
  of rows of one width, a launch for each 32 runs): the slot-to-row map
  modelled and held to the plain version's and to ``row_starts``, each
  slot's table index to the plain version's; the runs the one description
  of the rows that the wrapper and its plain version read.

On ``ops/cuda/adversarial``'s ``supercell_monopole_cases`` and
``row_monopole_cases`` and on the super-cell engines' own first-step
inputs. The kernels run only on the card (``chip_smoke.py --mesh-kernels``
holds them to these plain versions there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from particlesimulation_tpu.ops import dense_xla as jdense
from particlesimulation_tpu.ops import integrate as jintegrate
from particlesimulation_tpu.ops import stencil as jstencil
from particlesimulation_tpu.parallel import sharded as jsharded
from particlesimulation_tpu_torch.config import DELTAT, SimConfig
from particlesimulation_tpu_torch.engine import Engine
from particlesimulation_tpu_torch.ops import dense, integrate
from particlesimulation_tpu_torch.ops.cuda import adversarial, advance
from particlesimulation_tpu_torch.ops.cuda import stencil as stencil_ops
from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine

torch.set_num_threads(2)

FIELDS = ("x", "y", "vx", "vy", "m", "mf", "fxd", "fyd")
# (dx, dy) of the 8 directions in the kernels' order (advance.cu kStencil).
STENCIL = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
           (1, 1))
SUPER = adversarial.supercell_monopole_cases()
ROWS = adversarial.row_monopole_cases()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _bits(t):
    return t.detach().contiguous().numpy().tobytes()


def _same(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert _bits(a) == _bits(b), what


# --- the super-cell pass ----------------------------------------------------

def _layout(case):
    """The case's (layout, lines) on the mesh, (None, None) on one
    device."""
    mesh = case["mesh"]
    if mesh is None:
        return None, None
    layout = stencil_ops.HaloLayout(
        (mesh["R"],), case["nc"], row0=(_t(mesh["row0"]),),
        rows_mine=(_t(mesh["rows_mine"]),))
    return layout, (_t(mesh["top"]), _t(mesh["bot"]), None, None)


def _inputs(case, cell_dtype=torch.int64):
    f = {k: _t(case[k]) for k in FIELDS}
    return f, _t(case["cell"]).to(cell_dtype), tuple(_t(s)
                                                     for s in case["sums"])


def _plain_tables(case, sums):
    layout, lines = _layout(case)
    nc = case["nc"]
    if layout is None:
        return stencil_ops.grid_tables_ref(*sums, case["side"], nc,
                                           from_sums=True)
    L, R = case["mesh"]["L"], case["mesh"]["R"]
    return stencil_ops.halo_tables_ref(
        [tuple(a.view(L, R, nc) for a in sums)], layout, lines,
        case["side"], nc, from_sums=True)


def _mirror(d, hi, lo, side):
    """halo.cuh's mirror: +side past the high edge, -side past the low one,
    else a +0.0."""
    d = torch.as_tensor(d)
    s = torch.tensor(side, dtype=torch.float32)
    z = torch.zeros((), dtype=torch.float32)
    return torch.where(d == 1, torch.where(hi, s, z),
                       torch.where(d == -1, torch.where(lo, -s, z), z))


def _super_term(case, sums, l, r, c, dx, dy):
    """advance.cu's super_term, elementwise: temp cell (dx, dy) of cell
    (l, r, c) from the sums (wrapped on one device; the mesh's padded rows
    by halo.cuh's halo_row: the bottom line at rows_mine + 1, the top at
    0, grid rows to R, else 0), its COM, the mirrors of the cell's edges
    (the mesh's the 1D form of its global row)."""
    nc, side, mesh = case["nc"], case["side"], case["mesh"]
    l, r, c, dx, dy = (torch.as_tensor(v, dtype=torch.int64)
                       for v in (l, r, c, dx, dy))
    nx = c + dx
    nx = torch.where(nx < 0, nc - 1, torch.where(nx >= nc, 0, nx))
    if mesh is None:
        ny = r + dy
        ny = torch.where(ny < 0, nc - 1, torch.where(ny >= nc, 0, ny))
        v = [s[ny * nc + nx] for s in sums]
        offy = _mirror(dy, r == nc - 1, r == 0, side)
    else:
        R = mesh["R"]
        rows, row0 = _t(mesh["rows_mine"])[l], _t(mesh["row0"])[l]
        pr = r + 1 + dy
        bot, top = pr == rows + 1, pr == 0
        grid = ~bot & ~top & (pr <= R)
        at = torch.where(grid, (l * R + pr - 1) * nc + nx, 0)
        lt, lb = _t(mesh["top"]), _t(mesh["bot"])
        v = [torch.where(bot, lb[l, 0, k, nx],
                         torch.where(top, lt[l, 0, k, nx],
                                     torch.where(grid, sums[k][at], 0.0)))
             for k in range(3)]
        gy = row0 + r
        offy = _mirror(dy, gy + 1 >= nc, gy - 1 < 0, side)
    has = v[0] > 0
    safe = torch.where(has, v[0], 1.0)
    mx = torch.where(has, v[1] / safe, 0.0)
    my = torch.where(has, v[2] / safe, 0.0)
    offx = _mirror(dx, c == nc - 1, c == 0, side)
    return v[0], offx + mx, offy + my


def _fits(S):
    """A full super-cell's box fits advance.cu's kStageBytes (S <= 62)."""
    return 12 * (S + 2) ** 2 <= 48 * 1024


def _box(case, t):
    """advance.cu's super_box: pool row t's (shard, y0, x0, h, w, staged)
    at the kernel's stage limit."""
    nc, S, mesh = case["nc"], case["S"], case["mesh"]
    fits = _fits(S)
    if mesh is None:
        nsc = -(-nc // S)
        scy, scx = divmod(t, nsc)
        y0, x0 = scy * S, scx * S
        h, w = min(S, nc - y0), min(S, nc - x0)
        return 0, y0, x0, h, w, fits and h > 0 and w > 0
    nsc = nc // S
    l, u = divmod(t, mesh["rows_t"])
    q, scx = divmod(u, nsc)
    q -= 1
    w = min(S, nc - scx * S)
    return (l, q * S, scx * S, S, w, bool(
        fits and q >= 0 and w > 0 and (q + 1) * S <= mesh["rows_mine"][l]))


def _model_super(case, sums, cell):
    """The kernel's terms of every live slot, as its addressing finds them:
    (cm, mx, my), each (8, rows, kcap) float32, 0 at frozen slots. Also
    returns how many live slots read the box, built their terms from the
    sums, took the sentinel."""
    rows, kcap = cell.shape
    nc, mesh = case["nc"], case["mesh"]
    R = nc if mesh is None else mesh["R"]
    ncells = sums[0].numel()
    m = _t(case["m"])
    out = torch.zeros(3, 8, rows, kcap)
    reads = {"box": 0, "sums": 0, "sentinel": 0}
    for t in range(rows):
        l, y0, x0, h, w, staged = _box(case, t)
        if staged:
            bw = w + 2
            k = torch.arange((h + 2) * bw)
            bi, bj = k // bw, k % bw
            dy = torch.where(bi == 0, -1, torch.where(bi == h + 1, 1, 0))
            dx = torch.where(bj == 0, -1, torch.where(bj == w + 1, 1, 0))
            box = _super_term(case, sums, l, y0 + bi - 1 - dy,
                              x0 + bj - 1 - dx, dx, dy)
        live = torch.nonzero(m[t] != 0)[:, 0]
        i = cell[t, live].to(torch.int64)
        ok = (i >= 0) & (i < ncells)
        li = torch.where(ok, i // (R * nc), 0)
        rem = torch.where(ok, i - li * R * nc, 0)
        r, c = rem // nc, rem % nc
        inbox = (ok & (li == l) & (r >= y0) & (r < y0 + h) & (c >= x0)
                 & (c < x0 + w) & staged)
        reads["box"] += int(inbox.sum())
        reads["sums"] += int((ok & ~inbox).sum())
        reads["sentinel"] += int((~ok).sum())
        for d, (dx, dy) in enumerate(STENCIL):
            direct = _super_term(case, sums, li, r, c, dx, dy)
            for k in range(3):
                v = direct[k]
                if staged:
                    at = ((r - y0 + 1 + dy) * (w + 2) + c - x0 + 1 + dx)
                    at = torch.where(inbox, at, 0)
                    v = torch.where(inbox, box[k][at], v)
                out[k, d, t, live] = torch.where(ok, v, 0.0)
    return out, reads


def _terms_of(tables, idx, live):
    """The plain tables' columns at each slot's index, 0 at frozen
    slots: (3, 8, rows, kcap)."""
    got = torch.stack([t[:, idx.reshape(-1)].view(8, *idx.shape)
                       for t in tables])
    return torch.where(live, got, 0.0)


@pytest.mark.parametrize("case", SUPER, ids=[c["name"] for c in SUPER])
def test_supercell_model_equals_plain_tables(case):
    """The model's terms at every live slot bit for bit the plain chain's
    tables at its index (the sentinel past the sums or below 0); each of
    the three ways a slot finds its terms is taken where the case plants
    it."""
    _, cell, sums = _inputs(case)
    tables = _plain_tables(case, sums)
    nidx = tables[0].shape[1]
    idx = torch.where((cell >= 0) & (cell < nidx - 1), cell, nidx - 1)
    live = _t(case["m"]) != 0
    model, reads = _model_super(case, sums, cell)
    _same(model, _terms_of(tables, idx, live), "terms")
    staged = _fits(case["S"])
    stray = "strays" in case["name"] or case["name"].startswith("mesh")
    if stray or not staged:
        assert reads["sums"] > 0, reads
    if staged:
        assert reads["box"] > 0, reads
    else:
        assert reads["box"] == 0, reads
    if "limbo" in case["name"] or case["name"].startswith("5 x 5"):
        assert reads["sentinel"] > 0, reads


@pytest.mark.parametrize("cell_dtype", (torch.int64, torch.int32),
                         ids=("int64", "int32"))
@pytest.mark.parametrize("case", SUPER, ids=[c["name"] for c in SUPER])
def test_supercell_wrapper_is_the_plain_chain(case, cell_dtype):
    """``supercell_monopole_integrate`` on CPU tensors, in place (the same
    tensors back, frozen slots untouched, the other inputs unchanged): the
    plain chain's bits (tables, then ``gathered_monopole_integrate_ref``),
    which are also the model's terms through ``dense.monopole_gathered``
    and ``integrate``."""
    f, cell, sums = _inputs(case, cell_dtype)
    layout, lines = _layout(case)
    tables = _plain_tables(case, sums)
    want = tuple(t.clone() for t in (f["x"], f["y"], f["vx"], f["vy"]))
    advance.gathered_monopole_integrate_ref(
        *want, *(f[k] for k in FIELDS[4:]), tables, cell, case["side"],
        DELTAT)
    model, _ = _model_super(case, sums, cell)
    rows, kcap = cell.shape
    n = rows * kcap
    per_slot = tuple(torch.cat([v.reshape(8, n), torch.zeros(8, 1)], 1)
                     for v in model)
    fxm, fym = dense.monopole_gathered(f["x"].reshape(n), f["y"].reshape(n),
                                       f["mf"].reshape(n), *per_slot,
                                       torch.arange(n))
    via_model = integrate.integrate(
        *(f[k].reshape(n) for k in ("x", "y", "vx", "vy", "m")),
        f["fxd"].reshape(n) + fxm, f["fyd"].reshape(n) + fym, case["side"],
        DELTAT)
    before = {k: v.clone() for k, v in f.items()}
    launches = dict(advance.LAUNCHES)
    got = advance.supercell_monopole_integrate(
        *(f[k] for k in FIELDS), sums, cell, case["side"], case["nc"],
        DELTAT, case["S"], layout=layout, lines=lines)
    assert advance.LAUNCHES == launches
    assert all(a is f[k] for a, k in zip(got, ("x", "y", "vx", "vy")))
    live = before["m"] != 0
    for k, a, b, c in zip(("x", "y", "vx", "vy"), got, want, via_model):
        _same(a, b, k)
        _same(a[live], c.view(rows, kcap)[live], k)
        _same(a[~live], before[k][~live], k)
    for k in FIELDS[4:]:
        _same(f[k], before[k], k)


def _jax_com(m, sx, sy):
    """The COM as the JAX package's super-cell monopole takes it
    (ops/supercell.py monopole_forces_general)."""
    safe = jnp.where(m > 0, m, jnp.float32(1.0))
    return (m, jnp.where(m > 0, sx / safe, jnp.float32(0.0)),
            jnp.where(m > 0, sy / safe, jnp.float32(0.0)))


def _flushed(case):
    """The case with subnormal sums and lines flushed to a signed zero:
    XLA on the CPU flushes them in its arithmetic."""
    case = dict(case)

    def flush(a):
        return np.where(np.abs(a) < np.finfo(np.float32).tiny, 0.0 * a,
                        a).astype(np.float32)

    case["sums"] = tuple(flush(s) for s in case["sums"])
    if case["mesh"] is not None:
        case["mesh"] = dict(case["mesh"], top=flush(case["mesh"]["top"]),
                            bot=flush(case["mesh"]["bot"]))
    return case


JAX_CASES = [c for c in SUPER if c["name"].startswith(
    ("nc 7", "nc 3", "mesh of 4", "mesh of 1"))]


@pytest.mark.parametrize("case", JAX_CASES, ids=[c["name"]
                                                  for c in JAX_CASES])
def test_supercell_pass_equals_jax(case):
    """The pass against the JAX package on the same inputs: the plain
    tables bit for bit JAX's ``stencil_tables`` (one device) or, shard by
    shard, ``stencil_tables_halo`` on JAX's pad of the COM grids and lines;
    then the port's pass against JAX's ``monopole_tile_forces`` on each
    slot's gathered terms and ``integrate`` (rtol 1e-6: the two rsqrts)."""
    case = _flushed(case)
    f, cell, sums = _inputs(case)
    nc, side = case["nc"], case["side"]
    tables = _plain_tables(case, sums)
    jsums = [jnp.asarray(s) for s in case["sums"]]
    if case["mesh"] is None:
        want = jstencil.stencil_tables(*_jax_com(*jsums), side, nc)
    else:
        mesh = case["mesh"]
        L, R = mesh["L"], mesh["R"]
        parts = []
        for s in range(L):
            grid = _jax_com(*(a.reshape(L, R, nc)[s] for a in jsums))
            top = _jax_com(*(jnp.asarray(mesh["top"][s, 0, k])
                             for k in range(3)))
            bot = _jax_com(*(jnp.asarray(mesh["bot"][s, 0, k])
                             for k in range(3)))
            rows = int(mesh["rows_mine"][s])
            padded = []
            for a, tp, bt in zip(grid, top, bot):
                ap = jnp.concatenate([tp[None], a, jnp.zeros((1, nc),
                                                             a.dtype)])
                padded.append(lax.dynamic_update_slice_in_dim(
                    ap, bt[None], rows + 1, axis=0))
            parts.append(jsharded.stencil_tables_halo(
                *padded, side, nc, R, int(mesh["row0"][s])))
        want = tuple(jnp.concatenate([p[i][:, :-1] for p in parts]
                                     + [parts[0][i][:, -1:]], axis=1)
                     for i in range(3))
    for g, w in zip(tables, want):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32))
    nidx = tables[0].shape[1]
    idx = np.where((case["cell"] >= 0) & (case["cell"] < nidx - 1),
                   case["cell"], nidx - 1).reshape(-1)
    jt = [np.asarray(w)[:, idx].T for w in want]
    xs = {k: jnp.asarray(case[k].reshape(-1, 1)) for k in FIELDS}
    fxm, fym = jdense.monopole_tile_forces(xs["x"], xs["y"], xs["mf"], *jt)
    jnew = jintegrate.integrate(xs["x"], xs["y"], xs["vx"], xs["vy"],
                                xs["m"], xs["fxd"] + fxm, xs["fyd"] + fym,
                                side, DELTAT)
    layout, lines = _layout(case)
    got = advance.supercell_monopole_integrate(
        *(f[k] for k in FIELDS), sums, cell, side, nc, DELTAT, case["S"],
        layout=layout, lines=lines)
    for a, b in zip(got, jnew):
        np.testing.assert_allclose(a.numpy().reshape(-1),
                                   np.asarray(b).reshape(-1), rtol=1e-6,
                                   atol=1e-6)


def _spied_call(eng, state):
    """The super-cell pass's first call of ``eng.run(state, 1)``: its
    arguments, copied before the call."""
    calls = []
    real = advance.supercell_monopole_integrate

    def spy(*a, **kw):
        if not calls:
            calls.append(([t.clone() if isinstance(t, torch.Tensor) else
                           tuple(u.clone() if isinstance(u, torch.Tensor)
                                 else u for u in t)
                           if isinstance(t, tuple) else t for t in a],
                          dict(kw)))
        return real(*a, **kw)

    advance.supercell_monopole_integrate = spy
    try:
        eng.run(state, 1)
    finally:
        advance.supercell_monopole_integrate = real
    assert len(calls) == 1
    return calls[0]


@pytest.mark.parametrize("kind", ("supercell", "mesh supercell D=3"))
def test_supercell_model_on_the_engines_inputs(kind):
    """The engines' own first-step call (SMALL's shape, cut to 48 x 48
    cells; the mesh at D = 3 with a short shard): the model's terms at
    every live slot bit for bit the plain tables', and the stencil tables
    built by no other call."""
    if kind == "supercell":
        eng = Engine(SimConfig(50, 10000.0 * 48 / 1300, 48, 700),
                     impl="supercell", device="cpu")
    else:
        eng = ShardedEngine(SimConfig(1, 3.0, 24, 300, n_shards=3),
                            impl="supercell", device="cpu")
    state = eng.init_state()
    before = dict(stencil_ops.LAUNCHES)
    args, kw = _spied_call(eng, state)
    assert eng.impl == "supercell"
    x, y, vx, vy, m, mf, fxd, fyd, sums, cell, side, nc, dt, S = args
    layout, lines = kw.get("layout"), kw.get("lines")
    case = {"nc": nc, "S": S, "side": side, "m": m.numpy(), "mesh": None}
    if layout is not None:
        L = layout.row0[0].shape[0]
        case["mesh"] = {
            "L": L, "R": layout.rows[0], "rows_t": x.shape[0] // L,
            "row0": layout.row0[0].numpy(),
            "rows_mine": layout.rows_mine[0].numpy(),
            "top": lines[0].numpy(), "bot": lines[1].numpy()}
    tables = _plain_tables(case, sums)
    nidx = tables[0].shape[1]
    idx = torch.where((cell >= 0) & (cell < nidx - 1), cell, nidx - 1)
    model, reads = _model_super(case, sums, cell)
    _same(model, _terms_of(tables, idx, m != 0), "terms")
    assert reads["box"] > 0
    assert stencil_ops.LAUNCHES == before


def test_supercell_wrapper_checks_its_inputs():
    """The wrapper raises on what the kernel does not take, before any
    launch: rows that are not the super-cells', a cell of float, sums of
    another grid, a layout of column halos, lines of another shape, a
    device that is neither the CPU nor a card."""
    case = SUPER[6]                      # nc 16, S 4
    f, cell, sums = _inputs(case)
    args = [f[k] for k in FIELDS]
    side, nc, S = case["side"], case["nc"], case["S"]
    before = dict(advance.LAUNCHES)
    with pytest.raises(ValueError, match="super-cells"):
        advance.supercell_monopole_integrate(
            *(a[:-1] for a in args), sums, cell[:-1], side, nc, DELTAT, S)
    with pytest.raises(TypeError):
        advance.supercell_monopole_integrate(*args, sums, cell.float(), side,
                                             nc, DELTAT, S)
    with pytest.raises(ValueError):
        advance.supercell_monopole_integrate(
            *args, tuple(s[:-1] for s in sums), cell, side, nc, DELTAT, S)
    with pytest.raises(ValueError):
        advance.supercell_monopole_integrate(*args, sums, cell, side, nc,
                                             DELTAT, 0)
    meta = [torch.empty(a.shape, device="meta") for a in args]
    with pytest.raises(ValueError, match="device"):
        advance.supercell_monopole_integrate(
            *meta, tuple(torch.empty(s.shape, device="meta") for s in sums),
            torch.empty(cell.shape, dtype=torch.int64, device="meta"), side,
            nc, DELTAT, S)
    mcase = next(c for c in SUPER if c["name"].startswith("mesh of 4"))
    f, cell, sums = _inputs(mcase)
    args = [f[k] for k in FIELDS]
    layout, lines = _layout(mcase)
    margs = (sums, cell, mcase["side"], mcase["nc"], DELTAT, mcase["S"])
    with pytest.raises(ValueError):  # lines of another width
        advance.supercell_monopole_integrate(
            *args, *margs, layout=layout,
            lines=(lines[0][..., :-1].contiguous(), lines[1], None, None))
    cols = stencil_ops.HaloLayout(
        (mcase["mesh"]["R"],), mcase["nc"], row0=layout.row0,
        rows_mine=layout.rows_mine, col0=torch.zeros(4, dtype=torch.int64),
        cols_mine=torch.full((4,), mcase["nc"], dtype=torch.int64))
    with pytest.raises(ValueError, match="wrapping"):
        advance.supercell_monopole_integrate(*args, *margs, layout=cols,
                                             lines=lines)
    with pytest.raises(ValueError):  # rows that are not the shards' rows
        advance.supercell_monopole_integrate(
            *(a[:-6] for a in args), sums, cell[:-6], *margs[2:],
            layout=layout, lines=lines)
    assert advance.LAUNCHES == before


# --- the mesh rows' pass ----------------------------------------------------

def _pool_rows(runs, n):
    """monopole_pool_kernel's map: each slot's row from the runs (slot0,
    row0, K a run), launch by launch of at most 32 runs."""
    row = torch.empty(n, dtype=torch.int64)
    slot = r0 = 0
    starts = []
    for rows, k in runs:
        starts.append((slot, r0, k))
        slot += rows * k
        r0 += rows
    ends = [s for s, _, _ in starts[1:]] + [slot]
    for j0 in range(0, len(starts), 32):
        group = starts[j0:j0 + 32]
        lo, hi = group[0][0], ends[min(j0 + 32, len(starts)) - 1]
        s = torch.arange(lo, hi)
        j = torch.zeros_like(s)
        for q in range(1, len(group)):
            j += (s >= group[q][0]).long()
        s0 = torch.tensor([g[0] for g in group])[j]
        rr = torch.tensor([g[1] for g in group])[j]
        kk = torch.tensor([g[2] for g in group])[j]
        row[lo:hi] = rr + (s - s0) // kk
    return row


@pytest.mark.parametrize("case", ROWS, ids=[c["name"] for c in ROWS])
def test_row_kernels_find_each_slots_row(case):
    """A thread a slot finds each slot's row from the runs as ``row_start``
    places it (past 32 runs too); each live slot's table index (its row's,
    the sentinel where unbinned or off the tables) is the plain
    version's."""
    rs, m = _t(case["row_start"]), _t(case["m"])
    n = m.numel()
    want = torch.repeat_interleave(torch.arange(rs.numel() - 1),
                                   rs[1:] - rs[:-1])
    _same(_pool_rows(case["runs"], n), want, "rows")
    live = torch.nonzero(m != 0)[:, 0]
    if "one live slot" in case["name"] or "896" in case["name"]:
        r = [i for i, (a, b) in enumerate(zip(rs[:-1], rs[1:]))
             if b - a == 896 and int((m[a:b] != 0).sum()) == 1]
        assert r, "no row of one live slot in 896"
    nidx = case["gathered"][0].shape[1]
    ri, binned = _t(case["row_index"]), _t(case["binned"])
    row = _pool_rows(case["runs"], n)
    kernel_idx = torch.where(binned, torch.where(
        (ri[row] >= 0) & (ri[row] < nidx), ri[row], nidx - 1), nidx - 1)
    at = ri[want]
    plain_idx = torch.where((at >= 0) & (at < nidx), at, nidx - 1)
    plain_idx = torch.where(binned, plain_idx, nidx - 1)
    _same(kernel_idx[live], plain_idx[live], "index")


@pytest.mark.parametrize("case", ROWS, ids=[c["name"] for c in ROWS])
def test_row_wrappers_are_the_plain_chain(case):
    """``gathered_monopole_integrate`` with the rows (and their runs) and,
    on a pool of one width, ``tile_monopole_integrate``, on CPU tensors:
    the plain chain's bits (``dense.monopole_gathered`` /
    ``monopole_tile_forces``, then ``integrate``), in place."""
    f = {k: _t(case[k]) for k in FIELDS}
    rs, ri, binned = (_t(case[k]) for k in ("row_start", "row_index",
                                            "binned"))
    _same(advance.row_starts(case["runs"]), rs, "row starts")
    tables = tuple(_t(t) for t in case["gathered"])
    nidx = tables[0].shape[1]
    row = torch.repeat_interleave(torch.arange(rs.numel() - 1),
                                  rs[1:] - rs[:-1])
    idx = torch.where((ri[row] >= 0) & (ri[row] < nidx), ri[row], nidx - 1)
    idx = torch.where(binned, idx, nidx - 1)
    fxm, fym = dense.monopole_gathered(f["x"], f["y"], f["mf"], *tables, idx)
    want = integrate.integrate(f["x"], f["y"], f["vx"], f["vy"], f["m"],
                               f["fxd"] + fxm, f["fyd"] + fym, case["side"],
                               DELTAT)
    got = advance.gathered_monopole_integrate(
        *(f[k].clone() for k in FIELDS[:4]), *(f[k] for k in FIELDS[4:]),
        tables, ri, case["side"], DELTAT, case["runs"], binned=binned)
    for k, a, b in zip(FIELDS, got, want):
        _same(a, b, k)
    if case["tile"] is not None:
        (nrows, K), = case["runs"]
        tile = tuple(_t(t) for t in case["tile"])
        tf = {k: v.view(nrows, K) for k, v in f.items()}
        fxm, fym = dense.monopole_tile_forces(tf["x"], tf["y"], tf["mf"],
                                              *tile)
        want = integrate.integrate(tf["x"], tf["y"], tf["vx"], tf["vy"],
                                   tf["m"], tf["fxd"] + fxm, tf["fyd"] + fym,
                                   case["side"], DELTAT)
        got = advance.tile_monopole_integrate(
            *(tf[k].clone() for k in FIELDS[:4]),
            *(tf[k] for k in FIELDS[4:]), tile, rs, case["side"], DELTAT)
        for k, a, b in zip(FIELDS, got, want):
            _same(a, b, k)


def test_row_wrappers_check_the_runs():
    """Runs that do not cover the rows, or their slots, raise before any
    launch, and so does an index a slot (the plain version's form alone:
    no kernel takes it)."""
    case = ROWS[0]
    f = {k: _t(case[k]) for k in FIELDS}
    ri = _t(case["row_index"])
    tables = tuple(_t(t) for t in case["gathered"])
    args = [f[k] for k in FIELDS]
    before = dict(advance.LAUNCHES)
    runs = list(case["runs"])
    for bad in (runs[:-1], [(r, k + 1) for r, k in runs],
                [(runs[0][0] + 1, runs[0][1])] + runs[1:],
                [(r, 0) for r, _ in runs], []):
        with pytest.raises(ValueError, match="runs"):
            advance.gathered_monopole_integrate(
                *args, tables, ri, case["side"], DELTAT, bad)
    row = torch.repeat_interleave(ri, _t(case["row_start"]).diff())
    with pytest.raises(ValueError, match="each row's"):
        advance.gathered_monopole_integrate(
            *args, tables, row, case["side"], DELTAT, runs)
    assert advance.LAUNCHES == before


def test_the_runs_alone_place_the_rows():
    """The wrapper reads its rows from the runs alone: the bands' runs in
    another order (the same rows and slots in all) place each slot in the
    row the kernel's map finds from them, on the CPU as on the card, and
    that moves the result (the neighbour masses scaled up, so that the
    terms show in the positions)."""
    case = ROWS[0]
    runs = case["runs"][::-1]
    f = {k: _t(case[k]) for k in FIELDS}
    ri, binned = _t(case["row_index"]), _t(case["binned"])
    tables = tuple(_t(t) for t in case["gathered"])
    tables = (tables[0] * 1e12, *tables[1:])
    n = f["x"].numel()
    assert sum(r * k for r, k in runs) == n and runs != case["runs"]
    outs = []
    for rr in (runs, case["runs"]):
        outs.append(advance.gathered_monopole_integrate(
            *(f[k].clone() for k in FIELDS[:4]), *(f[k] for k in FIELDS[4:]),
            tables, ri, case["side"], DELTAT, rr, binned=binned))
    want = tuple(f[k].clone() for k in FIELDS[:4])
    advance.gathered_monopole_integrate_ref(
        *want, *(f[k] for k in FIELDS[4:]), tables, ri[_pool_rows(runs, n)],
        case["side"], DELTAT, binned=binned)
    for k, a, b in zip(FIELDS, outs[0], want):
        _same(a, b, k)
    assert _bits(outs[0][0]) != _bits(outs[1][0])
