"""The stencil tables' kernels (``ops/cuda/stencil``, ``csrc/stencil.cu``)
on the CPU: a model of their addressing against the plain versions, the
plain versions against the JAX package's.

* ``_model_grid`` and ``_model_halo`` are torch models of the kernels'
  addressing, written as ``csrc/stencil.cu`` computes it: for each output
  cell and term, which grid or received line and which entry it reads,
  and which mirror it takes. They are held bit for bit against the plain
  versions (``grid_tables_ref``, ``halo_tables_ref`` on the lines the
  mesh's ``ppermute`` delivered) in f32 and f64, from the COM and from the
  sums, on ``adversarial.stencil_cases``: one device at nc = 1, 2, 3, 5,
  100; the 1D row mesh at D = 1, 2, 4 (short and one-row shards), 2 on two
  rows, aligned; column bands with cnt < cmaxc; the 2D mesh (2, 3) uneven
  on both axes, aligned, (2, 2) on 3 and (1, 1); block-cyclic bands of
  one-row chunks and a ragged band at D = 3 and 1, and 37 bands (more than
  a launch takes) at D = 2. The grids hold empty cells, -0.0 entries, and
  subnormal and zero masses. The exchange's plain payload (``row_lines``,
  ``column_lines``) is held against ``_model_lines``.
* the plain forms (``ops/stencil``'s ``stencil_tables``,
  ``stencil_tables_halo`` on JAX's pad, ``stencil_tables_halo_cols``,
  ``stencil_tables_halo2d``) against JAX's on the same NumPy inputs;
* the wrappers on a CPU tensor return the plain versions' bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from particlesimulation_tpu.ops import stencil as jstencil
from particlesimulation_tpu.parallel import sharded as jsharded
from particlesimulation_tpu.parallel import sharded2d as jsharded2d
from particlesimulation_tpu.parallel import sharded_banded_cols as jcols
from particlesimulation_tpu_torch.ops import stencil
from particlesimulation_tpu_torch.ops.cuda import adversarial
from particlesimulation_tpu_torch.ops.cuda import stencil as kernels

torch.set_num_threads(2)
CASES = adversarial.stencil_cases()
GRID_CASES = [c for c in CASES if c["kind"] == "grid"]
MESH_CASES = [c for c in CASES if c["kind"] == "mesh"]
DTYPES = (torch.float32, torch.float64)


def _bits(a, b):
    """Two tensors' values bit for bit."""
    assert a.shape == b.shape and a.dtype == b.dtype
    ints = {4: torch.int32, 8: torch.int64}[a.element_size()]
    assert torch.equal(a.contiguous().view(ints), b.contiguous().view(ints))


def _mirror(d, hi, lo, side):
    """A term's offset as the kernel picks it: +side, -side or a 0."""
    zero = torch.zeros((), dtype=side.dtype)
    if d == 1:
        return torch.where(hi, side, zero)
    if d == -1:
        return torch.where(lo, -side, zero)
    return torch.where(torch.zeros_like(hi, dtype=torch.bool), side, zero)


def _values(v, idx, from_sums):
    """The (3, ...) values at ``idx`` of the flat sources ``v``, as the
    COM (the kernel's M > 0 ? S / M : 0 of what it read)."""
    raw = v[:, idx]
    return stencil.com_from_sums(*raw) if from_sums else tuple(raw)


def _write(vals, offx, offy):
    """A term's three table entries: the mass, and the offsets added."""
    return vals[0], offx + vals[1], offy + vals[2]


def _model_grid(a, b, c, side, nc, from_sums, aligned):
    """stencil_grid_kernel: cell (cy, cx)'s term (dx, dy) reads cell
    (cy + dy) % nc * nc + (cx + dx) % nc, mirrors where cx (cy) is at the
    grid's edge; rows (8, ncells + 1) with a zero sentinel, or (ncells,
    8)."""
    v = torch.stack([a, b, c])
    s = torch.full((), side, dtype=a.dtype)
    cell = torch.arange(nc * nc)
    cy, cx = cell // nc, cell % nc
    cols = [[], [], []]
    for dx, dy in stencil.STENCIL:
        src = (cy + dy) % nc * nc + (cx + dx) % nc
        vals = _values(v, src, from_sums)
        for f, t in enumerate(_write(vals,
                                     _mirror(dx, cx == nc - 1, cx == 0, s),
                                     _mirror(dy, cy == nc - 1, cy == 0, s))):
            cols[f].append(t)
    out = [torch.stack(t) for t in cols]
    if aligned:
        return tuple(t.T.contiguous() for t in out)
    return tuple(torch.cat([t, t.new_zeros(8, 1)], dim=1) for t in out)


def _model_halo(grids, layout, lines, side, nc, from_sums):
    """stencil_halo_kernel: every source (a 0, each band's grids, the
    received lines) in one flat vector a field, each output cell's term an
    index into it, as the kernel's ``neighbour`` and ``padded_row`` pick
    it."""
    top, bot, left, right = lines
    L, C, B = grids[0][0].shape[0], layout.C, len(grids)
    parts, base = [torch.zeros(3, 1, dtype=grids[0][0].dtype)], 1
    gbase = []
    for gb in grids:
        gbase.append(base)
        parts.append(torch.stack(gb).reshape(3, -1))
        base += parts[-1].shape[1]
    lbase = {}
    for name, t in (("top", top), ("bot", bot), ("left", left),
                    ("right", right)):
        if t is not None:
            lbase[name] = base
            parts.append(t.transpose(0, 2).transpose(1, 2).reshape(3, -1))
            base += parts[-1].shape[1]
    v = torch.cat(parts, dim=1)
    s = torch.full((), side, dtype=v.dtype)
    nside = 0 if left is None else left.shape[3]

    def line(name, l, bi, x, n):
        # (L, B, 3, n) lines: field-major in v, then (l, band, x)
        return lbase[name] + (l * (B if name in ("top", "bot") else 1)
                              + bi) * n + x

    tables = []
    for b, gb in enumerate(grids):
        R = gb[0].shape[1]
        l, r, c = torch.meshgrid(torch.arange(L), torch.arange(R),
                                 torch.arange(C), indexing="ij")
        rows_mine = layout.rows_mine[b][l] if layout.rows_halo else None
        cols_mine = layout.cols_mine[l] if layout.cols_halo else None

        def grid(rr, cc):
            return (gbase[b] + (l * R + rr.clamp(0, R - 1)) * C
                    + cc.clamp(0, C - 1))

        def padded_row(pr, x):
            bt = torch.full_like(l, b)
            bb = torch.full_like(l, b)
            if layout.top_shift is not None:
                bt = torch.where(layout.top_shift[l], (b - 1) % B, bt)
            if layout.bot_shift is not None:
                bb = torch.where(layout.bot_shift[l], (b + 1) % B, bb)
            return torch.where(
                pr == rows_mine + 1, line("bot", l, bb, x, C),
                torch.where(pr == 0, line("top", l, bt, x, C),
                            torch.where(pr <= R, grid(pr - 1, x), 0)))

        gx = layout.col0[l] + c if layout.cols_halo else c
        gy = layout.row0[b][l] + r if layout.rows_halo else r
        cols = [[], [], []]
        for dx, dy in stencil.STENCIL:
            if not layout.cols_halo:
                idx = padded_row(r + 1 + dy, (c + dx) % C)
            else:
                pc = c + 1 + dx
                y = r + 1 + dy if layout.rows_halo else (r + dy) % R
                inner = (padded_row(y, (pc - 1).clamp(0, C - 1))
                         if layout.rows_halo else grid(y, pc - 1))
                zero = torch.zeros_like(l)
                idx = torch.where(
                    pc == cols_mine + 1, line("right", l, zero, y, nside),
                    torch.where(pc == 0, line("left", l, zero, y, nside),
                                torch.where(pc <= C, inner, 0)))
            offx = _mirror(dx, gx == nc - 1, gx == 0, s)
            if layout.y_ge:
                offy = _mirror(dy, gy + 1 >= nc, gy - 1 < 0, s)
            else:
                offy = _mirror(dy, gy == nc - 1, gy == 0, s)
            for f, t in enumerate(_write(_values(v, idx, from_sums), offx,
                                         offy)):
                cols[f].append(t)
        tables.append([torch.stack(t) for t in cols])   # (8, L, R, C)
    if layout.aligned is not None:
        pr, pc = layout.aligned
        return tuple(torch.nn.functional.pad(
            t.permute(1, 2, 3, 0), (0, 0, pc, pc, pr, pr)).reshape(-1, 8)
            for t in tables[0])
    return tuple(torch.cat([t[f].reshape(8, -1) for t in tables]
                           + [tables[0][f].new_zeros(8, 1)], dim=1)
                 for f in range(3))


def _model_lines(grids, layout, rows_mode, top, bot):
    """The exchange's payload, shard by shard: (the last owned line, the
    first), each (L, B, 3, n); rows of every band, or columns of the one
    band (of the row-padded block where the rows take halos too)."""
    out = []
    for dr in (0, 1):
        per_band = []
        for b, gb in enumerate(grids):
            L = gb[0].shape[0]
            rows = []
            for l in range(L):
                if rows_mode:
                    at = int(layout.rows_mine[b][l]) - 1 if dr == 0 else 0
                    rows.append(torch.stack([g[l, at] for g in gb]))
                    continue
                at = int(layout.cols_mine[l]) - 1 if dr == 0 else 0
                col = torch.stack([g[l, :, at] for g in gb])
                if layout.rows_halo:
                    R = col.shape[1]
                    zero = col.new_zeros(3, 1)
                    col = torch.cat([top[l, 0, :, at, None], col, zero], 1)
                    rm = int(layout.rows_mine[0][l])
                    col[:, rm + 1] = bot[l, 0, :, at]
                    assert col.shape[1] == R + 2
                rows.append(col)
            per_band.append(torch.stack(rows))
        out.append(torch.stack(per_band, 1))
    return tuple(out)


def _typed(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("from_sums", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", GRID_CASES, ids=lambda c: c["name"])
def test_grid_model_equals_plain(case, dtype, from_sums, aligned):
    """One device: the model of stencil_grid_kernel bit for bit the plain
    version (the gather of ``stencil_tables_ref``, the COM first where
    from the sums), the wrapper on the CPU too."""
    a, b, c = (_typed(x, dtype) for x in case["grid"])
    args = (a, b, c, case["side"], case["nc"], from_sums, aligned)
    ref = kernels.grid_tables_ref(*args)
    for got in (_model_grid(*args), kernels.grid_tables(*args)):
        for g, r in zip(got, ref):
            _bits(g, r)
    if not aligned:
        want = stencil.stencil_tables(
            *(stencil.com_from_sums(a, b, c) if from_sums else (a, b, c)),
            case["side"], case["nc"])
        for g, r in zip(ref, want):
            _bits(g, r)
    elif from_sums:
        for g, r in zip(ref, stencil.tables_from_sums(a, b, c, case["side"],
                                                      case["nc"])):
            _bits(g, r)


@pytest.mark.parametrize("from_sums", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", MESH_CASES, ids=lambda c: c["name"])
def test_halo_model_equals_plain(case, dtype, from_sums):
    """A mesh layout: the lines the exchange sends (``row_lines``,
    ``column_lines``) against their model; the tables, the model of
    stencil_halo_kernel against ``halo_tables_ref`` on the lines the mesh's
    ppermute delivered, bit for bit; ``mesh_tables`` on the CPU the same
    bits."""
    mesh, layout, grids = adversarial.stencil_inputs(case, dtype, "cpu")
    side, nc = case["side"], case["nc"]
    lines = kernels.exchange(mesh, layout, grids)
    top, bot = lines[:2]
    if layout.rows_halo:
        for g, m in zip(kernels.row_lines(grids, layout),
                        _model_lines(grids, layout, True, None, None)):
            _bits(g, m)
    if layout.cols_halo:
        for g, m in zip(kernels.column_lines(grids, layout, top, bot),
                        _model_lines(grids, layout, False, top, bot)):
            _bits(g, m)
    ref = kernels.halo_tables_ref(grids, layout, lines, side, nc, from_sums)
    got = _model_halo(grids, layout, lines, side, nc, from_sums)
    for g, r in zip(got, ref):
        _bits(g, r)
    for g, r in zip(kernels.mesh_tables(mesh, layout, grids, side, nc,
                                        from_sums), ref):
        _bits(g, r)


def test_halo_lines_land_where_the_tables_read_them():
    """The 2D exchange's corners: on (2, 2) over nc = 3 the padded grid of
    every shard is the global grid around its rectangle, the corner cells
    (from the diagonal shard, over two phases) included."""
    case = next(c for c in MESH_CASES if c["name"] == "2D (2, 2) nc=3")
    mesh, layout, grids = adversarial.stencil_inputs(case, torch.float64,
                                                     "cpu")
    nc = case["nc"]
    g = torch.zeros(3, nc, nc, dtype=torch.float64)
    for s in range(4):
        r0, rm = int(layout.row0[0][s]), int(layout.rows_mine[0][s])
        c0, cm = int(layout.col0[s]), int(layout.cols_mine[s])
        g[:, r0:r0 + rm, c0:c0 + cm] = torch.stack(grids[0])[:, s, :rm, :cm]
    (padded,) = kernels.padded_grids(grids, layout,
                                     kernels.exchange(mesh, layout, grids))
    for s in range(4):
        r0, rm = int(layout.row0[0][s]), int(layout.rows_mine[0][s])
        c0, cm = int(layout.col0[s]), int(layout.cols_mine[s])
        rows = torch.arange(r0 - 1, r0 + rm + 1) % nc
        cols = torch.arange(c0 - 1, c0 + cm + 1) % nc
        want = g[:, rows][:, :, cols]
        got = torch.stack(padded)[:, s]
        rr = torch.tensor([0, *range(1, rm + 1), rm + 1])
        cc = torch.tensor([0, *range(1, cm + 1), cm + 1])
        _bits(got[:, rr][:, :, cc], want)


# --- the plain forms against JAX's ----------------------------------------

def _jax_pad(A, top, bot, rows_mine):
    """JAX's halo pad (parallel/sharded.py local_step's ``padded``)."""
    zrow = jnp.zeros((1, A.shape[1]), A.dtype)
    Ap = jnp.concatenate([top[None], A, zrow], axis=0)
    return lax.dynamic_update_slice_in_dim(Ap, bot[None], rows_mine + 1,
                                           axis=0)


def _np(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_plain_forms_equal_jax(dtype):
    """On the same NumPy inputs from a seed: ``stencil_tables`` at nc = 3,
    ``stencil_tables_halo`` on JAX's pad (a shard of 2 owned rows of 3 at
    the grid's foot, its tail row past the grid), ``stencil_tables_halo2d``
    and ``stencil_tables_halo_cols`` (a shard of 2 owned columns of 3)
    against the JAX package's, bit for bit."""
    rng = np.random.default_rng(5)
    nd = _np(dtype)
    side = 10.0 / 3.0

    def vals(*shape):
        # No subnormals: XLA on the CPU flushes them in an addition.
        v = adversarial._stencil_values(rng, shape)
        v = np.where(np.abs(v) < 1e-30, 0.0 * v, v).astype(nd)
        return [np.ascontiguousarray(a) for a in v]

    def same(got, want):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(
                g.numpy().view(np.int32 if nd == np.float32 else np.int64),
                np.asarray(w).view(np.int32 if nd == np.float32
                                   else np.int64))

    M = vals(9)
    same(stencil.stencil_tables(*(torch.from_numpy(a) for a in M), side, 3),
         jstencil.stencil_tables(*(jnp.asarray(a) for a in M), side, 3))

    nc, R, rows_mine, row0 = 7, 3, 2, 5
    A, top, bot = vals(R, nc), vals(nc), vals(nc)
    padded = [_jax_pad(jnp.asarray(a), jnp.asarray(t), jnp.asarray(b),
                       rows_mine) for a, t, b in zip(A, top, bot)]
    want = jsharded.stencil_tables_halo(*padded, side, nc, R, row0)
    got = stencil.stencil_tables_halo(
        *(torch.from_numpy(np.array(p))[None] for p in padded), side, nc,
        torch.tensor([row0]))
    same(got, want)

    Rm, Cm, row0, col0 = 3, 4, 4, 3
    P = vals(Rm + 2, Cm + 2)
    want = jsharded2d.stencil_tables_halo2d(*(jnp.asarray(p) for p in P),
                                            side, nc, Rm, Cm, row0, col0)
    got = stencil.stencil_tables_halo2d(
        *(torch.from_numpy(p)[None] for p in P), side, nc,
        torch.tensor([row0]), torch.tensor([col0]))
    same(got, want)

    cols_local, cnt, col0 = 3, 2, 5
    P = vals(nc, cols_local + 2)
    want = jcols.stencil_tables_halo_cols(*(jnp.asarray(p) for p in P), side,
                                          nc, cols_local, col0, cnt)
    got = stencil.stencil_tables_halo_cols(
        *(torch.from_numpy(p)[None] for p in P), side, nc,
        torch.tensor([col0]))
    same([t[:, :-1] for t in got], want)


def test_wrappers_on_the_cpu_take_the_plain_versions():
    """``grid_tables`` and ``halo_tables`` on CPU tensors: the plain
    versions' bits, with no library built."""
    case = next(c for c in MESH_CASES if c["name"].startswith("cyclic D=3"))
    mesh, layout, grids = adversarial.stencil_inputs(case, torch.float32,
                                                     "cpu")
    lines = kernels.exchange(mesh, layout, grids)
    for g, r in zip(
            kernels.halo_tables(grids, layout, lines, 2.5, case["nc"], True),
            kernels.halo_tables_ref(grids, layout, lines, 2.5, case["nc"],
                                    True)):
        _bits(g, r)
    grid = GRID_CASES[2]
    a, b, c = (_typed(x, torch.float32) for x in grid["grid"])
    for g, r in zip(kernels.grid_tables(a, b, c, 2.5, grid["nc"], True),
                    kernels.grid_tables_ref(a, b, c, 2.5, grid["nc"], True)):
        _bits(g, r)
    assert kernels._lib is None
