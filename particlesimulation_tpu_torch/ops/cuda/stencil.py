"""The monopole stencil tables, from the per-cell grids (the COM, or the
mass sums it comes from) to the tables, on every route that builds them.

Counterpart of XLA code of the JAX package: ``ops/stencil.py``'s
``stencil_tables`` (eight rolls), and the meshes' halo forms,
``parallel/sharded.py``'s ``stencil_tables_halo`` with its halo pad,
``sharded2d.py``'s ``stencil_tables_halo2d`` with ``two_phase_com_halo``,
``sharded_banded_cols.py``'s ``stencil_tables_halo_cols`` and the cyclic
bands' chunk halos (``sharded_banded.py``), each with the COM from the
sums. The port ran them as chains of plain torch launches. Each wrapper
below launches a hand-written CUDA kernel of ``csrc/stencil.cu``; the
``*_ref`` function beside it is the plain torch version of the same
function:

* ``grid_tables`` / ``grid_tables_ref``: one device's tables, the (8,
  ncells + 1) rows with a zero sentinel column (``ops/stencil``'s
  ``stencil_tables`` on a CUDA tensor), or (ncells, 8) rows a cell
  (``tables_from_sums``), from the COM or from the sums;
* ``halo_tables`` / ``halo_tables_ref``: a mesh's tables from its local
  grids and the received lines; the plain version pads the grids with the
  lines as the meshes did (``cat`` and ``where``) and runs
  ``ops/stencil``'s halo forms.

``mesh_tables`` is the tables phase of every mesh route: the exchange
(``exchange``: the plain slices of the lines each shard sends, and
``mesh.ppermute``), then ``halo_tables``. A route describes its grids
once, as a ``HaloLayout``.

A tensor on the CPU goes to the plain version; a tensor on a CUDA device
goes to the kernel, or the wrapper raises. The library is compiled with
``nvcc`` at first use (``cell_pairs.build``) with ``-fmad=false``, and the
COM's division is IEEE (no fast math). Bits: the kernels give the plain
versions' tables in every column, the tail rows of a short shard, the
columns past a shard's owned ones and the sentinel included. No wrapper
reads anything back to the host, so that every route replays them in its
CUDA graph.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import threading

import torch

from particlesimulation_tpu_torch.ops import stencil
from particlesimulation_tpu_torch.ops.cuda import cell_pairs

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc", "stencil.cu")
FLAGS = ("-fmad=false",)

# Kernel launches per wrapper since the last reset_launches(): one a
# grid_tables call, one a halo_tables call for each 32 bands (the library
# reports them).
LAUNCHES = {"stencil_grid": 0, "stencil_halo": 0}

_DTYPES = {torch.float32: 0, torch.float64: 1}
_lock = threading.Lock()
_lib = None


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def load(path):
    """The kernel library at ``path`` (a build of ``SOURCE``), bound."""
    lib = ctypes.CDLL(path)
    vp, ci, cd, i64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                       ctypes.c_int64)
    lib.psim_stencil_grid.argtypes = (
        [ci] + [vp] * 3 + [ci] * 3 + [cd, cd] + [vp] * 3 + [i64, vp])
    lib.psim_stencil_halo.argtypes = (
        [ci] * 3 + [vp] * 7 + [ci] * 6 + [vp] * 6 + [ci] + [vp] * 2
        + [ci] * 3 + [cd, cd] + [vp] * 3 + [i64, vp, vp])
    for fn in (lib.psim_stencil_grid, lib.psim_stencil_halo):
        fn.restype = ci
    return lib


def build():
    """Build the library (if it is not built yet); returns its path."""
    return cell_pairs.build(SOURCE, FLAGS)


def _library():
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


# --- one device -----------------------------------------------------------

def stencil_tables_ref(M, MX, MY, side: float, ncside: int):
    """Plain version of ``grid_tables``' rows: (ml, mxl, myl), each (8,
    ncells + 1), row l the l-th temp cell of every cell (the neighbour's
    COM with its mirror offset added), the last column a zero sentinel.

    Four launches: the three grids and a 0 in one vector, one gather of
    every neighbour, one addition of the mirror offsets (``ops/stencil``'s
    plan, made once per grid). ``temp.mx = offset; temp.mx += neighbor.mx``
    (serial/parsim.cpp:316-347): the offset is added to the neighbour's
    value, 0 where no mirror applies, as the reference adds it.
    """
    idx, off = stencil._stencil_plan(float(side), ncside, MX.dtype, MX.device)
    z = MX.new_zeros(1)
    v = torch.cat([M, z, MX, z, MY, z]).view(3, -1)
    g = v[:, idx]
    mxy = off + g[1:]
    return g[0], mxy[0], mxy[1]


def grid_tables_ref(a, b, c, side: float, ncside: int,
                    from_sums: bool = False, aligned: bool = False):
    """Plain version of ``grid_tables``."""
    if from_sums:
        a, b, c = stencil.com_from_sums(a, b, c)
    tables = stencil_tables_ref(a, b, c, side, ncside)
    if aligned:
        return tuple(t[:, :a.shape[0]].T.contiguous() for t in tables)
    return tables


def _check_grids(grids, shapes):
    """(dtype code, device) of ``grids`` (three tensors a shape of
    ``shapes``, one dtype of f32 or f64, one device, one set of strides,
    each row's entries contiguous); raises otherwise."""
    t0 = grids[0]
    if t0.dtype not in _DTYPES:
        raise TypeError(f"stencil grids must be float32 or float64; got "
                        f"{t0.dtype}")
    for t, shape in zip(grids, shapes):
        if t.dtype != t0.dtype or t.device != t0.device:
            raise ValueError(f"stencil grids of {t.dtype} on {t.device} "
                             f"beside {t0.dtype} on {t0.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"stencil grid of shape {tuple(t.shape)}, not "
                             f"{tuple(shape)}")
        if t.stride() != t0.stride() or t.stride(-1) != 1:
            raise ValueError(f"stencil grids of strides {t.stride()} beside "
                             f"{t0.stride()} (the last must be 1)")
    return _DTYPES[t0.dtype], t0.device


def grid_tables(a, b, c, side: float, ncside: int, from_sums: bool = False,
                aligned: bool = False):
    """One device's stencil tables of the flat (ncells,) grids ``a, b, c``:
    the COM (M, MX, MY), or with ``from_sums`` the sums (M, Σm·x, Σm·y), of
    which an empty cell's COM is 0. Returns (ml, mxl, myl), each (8, ncells
    + 1) with a zero sentinel column, or with ``aligned`` (ncells, 8),
    views of one new tensor: one launch."""
    if not cell_pairs._on_card(a, "stencil tables"):
        return grid_tables_ref(a, b, c, side, ncside, from_sums, aligned)
    ncells = ncside * ncside
    if ncside < 1:
        raise ValueError(f"ncside {ncside} < 1")
    dtype, dev = _check_grids((a, b, c), [(ncells,)] * 3)
    shape = (3, ncells, 8) if aligned else (3, 8, ncells + 1)
    out = torch.empty(shape, dtype=a.dtype, device=dev)
    cell_pairs._launch(
        "stencil_grid", _library().psim_stencil_grid, a, dtype, a.data_ptr(),
        b.data_ptr(), c.data_ptr(), ncside, int(from_sums), int(aligned),
        float(side), 0.0, out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), ncells + 1, launches=LAUNCHES)
    return out[0], out[1], out[2]


# --- the meshes -----------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class HaloLayout:
    """Where a mesh's local grids lie and where their halos come from.

    The grids are ``len(rows)`` bands (one but on the block-cyclic bands),
    band b a tuple of three (L, rows[b], C) tensors, shard-major. An axis
    takes halos where its first lines are given, else it wraps locally
    (every shard holds all of it):

    * rows: ``row0[b]``, ``rows_mine[b]``: (L,) int64, each shard's first
      global row of band b and its owned rows (the bottom halo lands at
      padded row ``rows_mine + 1``); ``y_ge``: the 1D form's y mirror
      (gy + 1 >= nc, gy - 1 < 0), else the 2D form's (gy == nc - 1, gy ==
      0); ``top_shift``, ``bot_shift``: (L,) bool, the cyclic bands' edge
      shards, which take the band above's top line and the band below's
      bottom line;
    * columns: ``col0``, ``cols_mine``: (L,) int64; the lines go over the
      mesh axis ``cols_axis``.

    ``aligned``: None for the (8, cells + 1) rows, band after band, a zero
    sentinel column last; (pr, pc) for rows a cell, each shard's block in a
    zero ring of pr rows and pc columns (the resident meshes' tiles).
    """

    rows: tuple
    C: int
    row0: tuple | None = None
    rows_mine: tuple | None = None
    col0: torch.Tensor | None = None
    cols_mine: torch.Tensor | None = None
    y_ge: bool = True
    top_shift: torch.Tensor | None = None
    bot_shift: torch.Tensor | None = None
    aligned: tuple | None = None
    cols_axis: str = "rows"

    def __post_init__(self):
        if (self.row0 is None) != (self.rows_mine is None) or (
                self.col0 is None) != (self.cols_mine is None):
            raise ValueError("give an axis's first lines and owned counts "
                             "together")
        if self.row0 is None and self.col0 is None:
            raise ValueError("a halo layout takes halos on an axis at least")
        if len(self.rows) > 1 and (self.col0 is not None
                                   or self.aligned is not None):
            raise ValueError("bands take row halos and the rows layout only")
        for t in (*(self.row0 or ()), *(self.rows_mine or ()), self.col0,
                  self.cols_mine):
            if t is not None and (t.dtype != torch.int64 or t.dim() != 1
                                  or not t.is_contiguous()):
                raise ValueError("a layout's geometry must be contiguous "
                                 "(L,) int64 tensors")
        for t in (self.top_shift, self.bot_shift):
            if t is not None and t.dtype != torch.bool:
                raise ValueError("band shifts must be (L,) bool tensors")

    @property
    def rows_halo(self) -> bool:
        return self.row0 is not None

    @property
    def cols_halo(self) -> bool:
        return self.col0 is not None

    @property
    def cells(self) -> int:
        """Rows of the tables: the cells of all bands (rows layout), or the
        padded blocks' cells (aligned)."""
        L = (self.row0[0] if self.rows_halo else self.col0).shape[0]
        if self.aligned is not None:
            pr, pc = self.aligned
            return L * (self.rows[0] + 2 * pr) * (self.C + 2 * pc)
        return sum(L * r * self.C for r in self.rows)


def _split(t, from_sums):
    """The three fields of (..., 3, n) lines, as COM."""
    f = t.unbind(-2)
    return stencil.com_from_sums(*f) if from_sums else f


def _pad_rows(grids, top, bot, rows_mine):
    """Each (L, R, C) grid with its halo rows: row 0 ``top``'s (L, C) line,
    the owned rows, a zero row, the bottom line at row ``rows_mine + 1``
    (over a tail row of a shard that owns fewer than R rows)."""
    L, R, C = grids[0].shape
    at_bot = (torch.arange(R + 2, device=rows_mine.device)[None, :, None]
              == (rows_mine + 1)[:, None, None])
    return tuple(torch.where(at_bot, b[:, None],
                             torch.cat([t[:, None], g, g.new_zeros(L, 1, C)],
                                       dim=1))
                 for g, t, b in zip(grids, top, bot))


def _pad_cols(grids, left, right, cols_mine):
    """Each (L, R, C) grid with its halo columns, as ``_pad_rows`` along
    the columns: the (L, R) lines at column 0 and ``cols_mine + 1``."""
    L, R, C = grids[0].shape
    at_right = (torch.arange(C + 2, device=cols_mine.device)[None, None, :]
                == (cols_mine + 1)[:, None, None])
    return tuple(torch.where(at_right, r[..., None],
                             torch.cat([lf[..., None], g,
                                        g.new_zeros(L, R, 1)], dim=2))
                 for g, lf, r in zip(grids, left, right))


def row_lines(grids, layout: HaloLayout):
    """The rows a row exchange sends, (last, first), each (L, B, F, C):
    each shard's last owned row of every band (for the next shard) and its
    first (for the previous one), copied from ``grids`` (a list of bands,
    each F (L, R, C) tensors; F = 3 for the tables) as they are. Plain on
    every device: the exchange's payload slices."""
    last, first = [], []
    for gb, rows_mine in zip(grids, layout.rows_mine):
        L, _, C = gb[0].shape
        at = (rows_mine - 1).view(L, 1, 1).expand(L, 1, C)
        last += [torch.gather(g, 1, at)[:, 0] for g in gb]
        first += [g[:, 0] for g in gb]
    return tuple(torch.stack(t, 1).view(L, len(grids), len(gb), C)
                 for t in (last, first))


def column_lines(grids, layout: HaloLayout, top=None, bot=None):
    """The columns a column exchange sends, (last, first), each (L, 1, 3,
    n): each shard's last owned column of its one band and its first, n = R;
    where the rows take halos too (the 2D mesh's second phase), columns of
    the block padded with the received ``top`` and ``bot`` rows as
    ``halo_tables`` pads it, n = R + 2, so that the corners ride along.
    Plain on every device, as ``row_lines``."""
    if len(grids) != 1:
        raise ValueError("column lines take one band")
    gb = grids[0]
    if layout.rows_halo:
        gb = _pad_rows(gb, top[:, 0].unbind(1), bot[:, 0].unbind(1),
                       layout.rows_mine[0])
    L, n, _ = gb[0].shape
    at = (layout.cols_mine - 1).view(L, 1, 1).expand(L, n, 1)
    return (torch.stack([torch.gather(g, 2, at)[..., 0] for g in gb],
                        1)[:, None],
            torch.stack([g[..., 0] for g in gb], 1)[:, None])


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_lines(t, shape, like):
    if (t is None or tuple(t.shape) != tuple(shape) or t.dtype != like.dtype
            or t.device != like.device or not t.is_contiguous()):
        raise ValueError(f"halo lines must be contiguous {tuple(shape)} "
                         f"{like.dtype} on {like.device}; got "
                         f"{None if t is None else (tuple(t.shape), t.dtype)}")


def _band_arrays(grids, layout):
    """The bands' pointers, strides, rows and geometry as ctypes arrays."""
    B = len(grids)
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    L, C = grids[0][0].shape[0], layout.C
    base = [0]
    for R in layout.rows[:-1]:
        base.append(base[-1] + L * R * C)
    return {
        "g": (vp * (3 * B))(*(g.data_ptr() for gb in grids for g in gb)),
        "sL": (i64 * B)(*(gb[0].stride(0) for gb in grids)),
        "sR": (i64 * B)(*(gb[0].stride(1) for gb in grids)),
        "R": (ctypes.c_int * B)(*layout.rows),
        "row0": (vp * B)(*(t.data_ptr() for t in layout.row0)
                         if layout.rows_halo else [None] * B),
        "rows": (vp * B)(*(t.data_ptr() for t in layout.rows_mine)
                         if layout.rows_halo else [None] * B),
        "base": (i64 * B)(*base),
    }


def padded_grids(grids, layout: HaloLayout, lines, from_sums: bool = False):
    """Plain: each band's grids (a tuple of (L, R, C) tensors, any number
    of fields) padded with the received ``lines`` as the meshes padded
    them: the COM of the grids and lines where ``from_sums``
    (``ops/stencil.com_from_sums``), the halo rows (the cyclic bands' edge
    shards' lines rolled a band), then the halo columns (of the row-padded
    grids on the 2D mesh). A list of tuples, a band each."""
    top, bot, left, right = lines
    conv = stencil.com_from_sums if from_sums else (lambda *f: f)
    if layout.rows_halo:
        tops, bots = _split(top, from_sums), _split(bot, from_sums)
        if layout.top_shift is not None:
            tops = tuple(torch.where(layout.top_shift[:, None, None],
                                     torch.roll(t, 1, dims=1), t)
                         for t in tops)
        if layout.bot_shift is not None:
            bots = tuple(torch.where(layout.bot_shift[:, None, None],
                                     torch.roll(t, -1, dims=1), t)
                         for t in bots)
    if layout.cols_halo:
        lefts, rights = (_split(t[:, 0], from_sums) for t in (left, right))
    out = []
    for b, gb in enumerate(grids):
        g = conv(*gb)
        if layout.rows_halo:
            g = _pad_rows(g, [t[:, b] for t in tops], [t[:, b] for t in bots],
                          layout.rows_mine[b])
        if layout.cols_halo:
            g = _pad_cols(g, lefts, rights, layout.cols_mine)
        out.append(tuple(g))
    return out


def halo_tables_ref(grids, layout: HaloLayout, lines, side: float,
                    ncside: int, from_sums: bool = False):
    """Plain version of ``halo_tables``: the padded COM grids
    (``padded_grids``: ``cat`` and ``where``), ``ops/stencil``'s halo form
    of the layout (``stencil_tables_halo``, ``stencil_tables_halo_cols`` or
    ``stencil_tables_halo2d``), and the output's layout (the bands' tables
    in a ``cat``; the aligned rows' transpose and zero ring)."""
    tables = []
    for b, g in enumerate(padded_grids(grids, layout, lines, from_sums)):
        if not layout.cols_halo:
            t = stencil.stencil_tables_halo(*g, side, ncside, layout.row0[b])
        elif layout.rows_halo:
            t = stencil.stencil_tables_halo2d(*g, side, ncside,
                                              layout.row0[b], layout.col0)
        else:
            t = stencil.stencil_tables_halo_cols(*g, side, ncside,
                                                 layout.col0)
        tables.append(t)
    if layout.aligned is not None:
        pr, pc = layout.aligned
        L, R = grids[0][0].shape[:2]
        return tuple(torch.nn.functional.pad(
            t[:, :-1].T.reshape(L, R, layout.C, 8),
            (0, 0, pc, pc, pr, pr)).reshape(-1, 8) for t in tables[0])
    if len(tables) == 1:
        return tables[0]
    return tuple(torch.cat([t[i][:, :-1] for t in tables]
                           + [tables[0][i][:, -1:]], dim=1)
                 for i in range(3))


def halo_tables(grids, layout: HaloLayout, lines, side: float, ncside: int,
                from_sums: bool = False):
    """A mesh's stencil tables from its local grids (a list of bands, each
    three (L, R, C) tensors of ``layout``: the COM, or with ``from_sums``
    the sums) and ``lines``, the received (top, bot, left, right) lines of
    ``exchange`` (None on an axis that wraps). Returns (ml, mxl, myl): each
    (8, cells + 1) with a zero sentinel column, or (cells, 8) where
    ``layout.aligned``; views of one new tensor. One launch (a launch a 32
    bands)."""
    L, C = grids[0][0].shape[0], layout.C
    if len(grids) != len(layout.rows):
        raise ValueError(f"{len(grids)} bands of grids, {len(layout.rows)} "
                         f"in the layout")
    for gb, R in zip(grids, layout.rows):
        dtype, dev = _check_grids(gb, [(L, R, C)] * 3)
    top, bot, left, right = lines
    like = grids[0][0]
    nside = None
    if layout.rows_halo:
        for t in (top, bot):
            _check_lines(t, (L, len(grids), 3, C), like)
    if layout.cols_halo:
        nside = layout.rows[0] + (2 if layout.rows_halo else 0)
        for t in (left, right):
            _check_lines(t, (L, 1, 3, nside), like)
    if not cell_pairs._on_card(like, "stencil tables"):
        return halo_tables_ref(grids, layout, lines, side, ncside, from_sums)
    cells = layout.cells
    aligned = layout.aligned is not None
    shape = (3, cells, 8) if aligned else (3, 8, cells + 1)
    out = torch.empty(shape, dtype=like.dtype, device=dev)
    arrays = _band_arrays(grids, layout)
    pr, pc = layout.aligned or (0, 0)
    made = ctypes.c_int(0)
    cell_pairs._launch(
        "stencil_halo", _library().psim_stencil_halo, like, dtype,
        int(from_sums), len(grids), arrays["g"], arrays["sL"], arrays["sR"],
        arrays["R"], arrays["row0"], arrays["rows"], arrays["base"], L, C,
        ncside, int(layout.rows_halo), int(layout.cols_halo),
        int(layout.y_ge), _ptr(layout.col0), _ptr(layout.cols_mine),
        _ptr(top), _ptr(bot), _ptr(left), _ptr(right), nside or 0,
        _ptr(layout.top_shift), _ptr(layout.bot_shift), int(aligned), pr, pc,
        float(side), 0.0, out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), cells + 1, ctypes.byref(made), launches=LAUNCHES,
        made=made)
    return out[0], out[1], out[2]


def exchange(mesh, layout: HaloLayout, grids):
    """The halo exchange, plain: each axis that takes halos sends its
    lines (``row_lines``, ``column_lines``) one shard along the ring each
    way (``mesh.ppermute``; the 2D mesh's columns after its rows, so the
    corners ride along). Returns the received (top, bot, left, right), None
    on an axis that wraps."""
    top = bot = left = right = None
    if layout.rows_halo:
        send = row_lines(grids, layout)
        top, bot = mesh.ppermute(send[0], 1), mesh.ppermute(send[1], -1)
    if layout.cols_halo:
        send = column_lines(grids, layout, top, bot)
        left = mesh.ppermute(send[0], 1, layout.cols_axis)
        right = mesh.ppermute(send[1], -1, layout.cols_axis)
    return top, bot, left, right


def mesh_tables(mesh, layout: HaloLayout, grids, side: float, ncside: int,
                from_sums: bool = False):
    """The tables phase of a mesh route: the exchange, then ``halo_tables``
    (on the card the tables kernel, once for each 32 bands)."""
    return halo_tables(grids, layout, exchange(mesh, layout, grids), side,
                       ncside, from_sums)
