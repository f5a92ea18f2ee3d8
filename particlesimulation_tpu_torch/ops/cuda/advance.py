"""The tile step's kernels around its pair pass: masks, monopole +
integrate, delivery, the tail with the next step's sums.

A slot-resident step (the resident engine's ``engine.make_resident_run``,
the banded engine's ``ops/banded``) applies the 8 stencil monopole terms of
each cell's neighbours and the pair force carried from the last pass,
integrates, delivers the particles that changed cell, masks the slots for
the fused pair pass, runs it, and then settles: the slots the pass killed
lose their mass, the counters move, and each cell's mass and moments are
summed for the next step. The JAX package runs all of this but the pair
pass as XLA code (``engine.py``'s ``physics_mass``, the row sums of its
``mono_tables`` and its step's tail, ``ops/stencil.stencil_tables``,
``ops/dense_xla.monopole_tile_forces``, ``ops/integrate.integrate`` and
``ops/resident.rebin``), which eager torch ran as hundreds of launches a
step. Each wrapper below launches a hand-written CUDA kernel of
``csrc/advance.cu``; the ``*_ref`` function beside it is the plain torch
version of the same function:

* ``monopole_integrate`` / ``monopole_integrate_ref``: the monopole terms,
  the integrator (x, y, vx, vy updated in place) and each slot's
  destination row and moving flag;
* ``tile_monopole_integrate`` / ``tile_monopole_integrate_ref`` and
  ``gathered_monopole_integrate`` / ``gathered_monopole_integrate_ref``:
  the resident and band meshes' monopole and integrator (x, y, vx, vy in
  place) from the stencil tables of their halo exchange, each slot's 8
  terms at its row's table index; the engines find the destinations (the
  plain version also takes an index a slot, which no kernel does);
* ``supercell_monopole_integrate`` / ``supercell_monopole_integrate_ref``:
  the super-cell engines' (one device and the mesh), from the per-cell
  sums themselves: the kernel builds each slot's 8 terms at its own cell
  in place (each super-cell row's neighbourhood staged once), where the
  plain version builds the tables (``ops/cuda/stencil``'s plain forms) and
  gathers;
* ``deliver`` / ``deliver_ref``: every mover to its destination row in one
  pass, in place (``ops/resident.rebin`` and the engines' advance phases
  call it);
* ``pair_masks`` / ``pair_masks_ref``: each slot's ``mf`` and ``alive``
  for the pair pass;
* ``settle_sums`` / ``settle_sums_ref``: after the pair pass, the deaths
  (m 0 in place) and the collision, panic and overflow counters (in
  place), and each row's M, Σm·x and Σm·y over its binned slots for the
  next step (``cell_sums_rows_ref`` is the plain sums).

The tiles are a pool of slots in which row r holds the flat slots
``row_start[r]`` to ``row_start[r + 1]`` (int64, on the tiles' device):
rows of one width in the resident engine, of each band's width in the
banded pool. Row r is cell r of the ``ncside × ncside`` grid for the sums
and the monopole pass; the delivery takes any rows; the masks take no rows.

In place: ``monopole_integrate``, ``deliver`` and ``settle_sums`` write
into the tensors they are given (the plain versions too, so that a CPU run
sees the same aliasing). No caller reads a step's tiles after handing them
on: each engine's prologue lays a run's tiles out in fresh tensors, and
``ops/resident.make_tile_run`` gives a run counters of its own, so a
replay of a run (the retry ladder) starts from its untouched input state.

A tensor on the CPU goes to the plain version; a tensor on a CUDA device
goes to the kernel, or the wrapper raises. The library is compiled with
``nvcc`` at first use (``cell_pairs.build``) with ``-fmad=false``, so that
every f32 operation of the monopole pass rounds as eager torch rounds it.

Bits: ``monopole_integrate`` gives the plain version's bits from the same
sums, ``deliver`` the plain version's tiles in every field and slot, and
``pair_masks`` and ``settle_sums`` their masks, deaths and counters.
``settle_sums`` adds the sums in a fixed order of its own (a warp a row,
see ``csrc/advance.cu``): the same bits in every run, within
(K·2⁻²⁴)·Σ|terms| of ``torch.sum``'s.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading

import numpy as np
import torch

from particlesimulation_tpu_torch.config import G
from particlesimulation_tpu_torch.ops import dense, integrate, stencil
from particlesimulation_tpu_torch.ops.binning import cell_of, segment_positions
from particlesimulation_tpu_torch.ops.cuda import cell_pairs
from particlesimulation_tpu_torch.ops.cuda import stencil as stencil_ops

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc", "advance.cu")
# Every f32 multiply and add rounds on its own, as eager torch's do.
FLAGS = ("-fmad=false",)
# Rows (warps) a block of the monopole pass and the delivery: a warp a row.
ROW_WARPS = 8
# Rows (warps) a block of the settle pass, from ``chip_smoke.py
# --settle-sweep``.
SETTLE_WARPS = 2

# Kernel launches per wrapper since the last reset_launches() (one a call:
# the delivery's call runs its three passes).
LAUNCHES = {"pair_masks": 0, "monopole_integrate": 0, "deliver": 0,
            "settle_sums": 0, "monopole_gathered": 0,
            "monopole_supercell": 0}

_lock = threading.Lock()
_lib = None


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def load(path):
    """The kernel library at ``path`` (a build of ``SOURCE``), bound."""
    lib = ctypes.CDLL(path)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.psim_pair_masks.argtypes = [vp] * 4 + [ctypes.c_int64, cf, ci] + (
        [vp] * 3)
    lib.psim_settle_sums.argtypes = (
        [vp] * 6 + [ci, cf, cf] + [vp] * 6 + [ci] * 2 + [vp])
    lib.psim_monopole_integrate.argtypes = (
        [vp] * 10 + [ci, cf, ci, cf, cf, cf] + [vp] * 2 + [ci, vp])
    lib.psim_deliver.argtypes = (
        [vp] * 10 + [ci, ctypes.c_int64, vp, ci] + [vp] * 5 + [ci, vp])
    i64 = ctypes.c_int64
    lib.psim_monopole_rows.argtypes = (
        [vp] * 11 + [i64] * 4 + [vp, vp, ci, vp, vp, ci, cf, cf, cf, vp, vp])
    lib.psim_monopole_supercell.argtypes = (
        [vp] * 9 + [ci] * 3 + [vp] * 3 + [i64] + [ci] * 5 + [vp] * 4
        + [cf] * 4 + [vp])
    for fn in (lib.psim_pair_masks, lib.psim_settle_sums,
               lib.psim_monopole_integrate, lib.psim_deliver,
               lib.psim_monopole_rows, lib.psim_monopole_supercell):
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


def cell_width(side: float, ncside: int) -> float:
    """The cell width ``ops/binning.cell_of`` divides by, in float32."""
    return float(np.float32(side / ncside))


@functools.lru_cache(maxsize=None)
def box_edges(side: float, ncside: int):
    """(lo, hi), float32: ``binning.cell_of`` puts a finite float32
    coordinate x in the grid's range [0, ncside) exactly where lo < x < hi.
    Its cell coordinate is trunc(RN(x / w)), in range exactly where RN(x /
    w) > -1 and < ncside, and RN(x / w) grows with x: lo is the largest x
    with RN(x / w) <= -1, hi the smallest with RN(x / w) >= ncside."""
    w = np.float32(cell_width(side, ncside))
    nc = np.float32(ncside)
    # RN(x / w) is within an ulp or two of the exact quotient: start at
    # nc·w and -w and step to the edges.
    up, down = np.float32(np.inf), np.float32(-np.inf)

    def q(x):
        return np.float32(x) / w

    hi = np.float32(nc * w)
    while q(hi) >= nc:
        hi = np.nextafter(hi, down)
    while q(hi) < nc:
        hi = np.nextafter(hi, up)
    lo = -w
    while q(lo) <= -1:
        lo = np.nextafter(lo, up)
    while q(lo) > -1:
        lo = np.nextafter(lo, down)
    return float(lo), float(hi)


def _flat(name, t, dtype, n, dev):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}; got {t.dtype}")
    if t.numel() != n:
        raise ValueError(f"{name} holds {t.numel()} values, not {n}")
    if t.device != dev:
        raise ValueError(f"{name} on device {t.device}, x on {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.reshape(-1)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_rows(row_start, dev):
    if row_start.dtype != torch.int64 or row_start.dim() != 1 or (
            row_start.numel() < 2):
        raise ValueError("row_start must be (nrows + 1,) int64, nrows >= 1")
    if row_start.device != dev:
        raise ValueError(f"row_start on device {row_start.device}, x on "
                         f"{dev}")
    return row_start.numel() - 1


def _check_grid(nrows, ncside):
    if nrows != ncside * ncside:
        raise ValueError(f"{nrows} rows for a {ncside} x {ncside} grid: row "
                         f"r must be cell r")


def _segments(row_start):
    """Runs of rows of one width: [(first slot, rows, width)], host ints."""
    rs = row_start.cpu()
    widths, counts = torch.unique_consecutive(rs[1:] - rs[:-1],
                                              return_counts=True)
    out, r = [], 0
    for w, c in zip(widths.tolist(), counts.tolist()):
        out.append((int(rs[r]), c, w))
        r += c
    return out


def _row_of(row_start):
    """Each slot's row (int64)."""
    rs = row_start
    nrows = rs.numel() - 1
    return torch.repeat_interleave(torch.arange(nrows, device=rs.device),
                                   rs[1:] - rs[:-1])


def row_starts(runs, device=None):
    """The (nrows + 1,) int64 row starts of a pool laid out as ``runs``
    ((rows, K) pairs of host ints, in order: ``rows`` rows of K slots
    each), on ``device``."""
    parts, s0 = [], 0
    for rows, k in runs:
        rows, k = int(rows), int(k)
        parts.append(s0 + k * torch.arange(rows, device=device))
        s0 += rows * k
    return torch.cat(parts + [torch.full((1,), s0, device=device)])


def _rows_of_runs(runs, device):
    """Each slot's row (int64) of a pool laid out as ``runs``."""
    parts, r0 = [], 0
    for rows, k in runs:
        rows, k = int(rows), int(k)
        parts.append(r0 + torch.arange(rows * k, device=device) // k)
        r0 += rows
    return torch.cat(parts)


def cell_sums_rows_ref(x, y, m, occ, row_start, side: float, ncside: int):
    """Each row's sums over its binned slots (occupied, in the box by
    ``binning.cell_of``): ``sums`` (3, nrows) float32 — M, Σm·x, Σm·y —
    and ``limbo`` (0-d int32), the count of occupied slots out of the box;
    ``torch.sum`` over each run of rows of one width, as a (rows, width)
    view. The plain sums of ``settle_sums_ref``."""
    dev = x.device
    _check_rows(row_start, dev)
    xf, yf, mf, of = (t.reshape(-1) for t in (x, y, m, occ))
    _, _, valid = cell_of(xf, yf, side, ncside)
    limbo = torch.sum(of & ~valid, dtype=torch.int32)
    mf = torch.where(of & valid, mf, 0.0)
    terms = (mf, mf * xf, mf * yf)
    parts = [torch.stack([torch.sum(t[s0:s0 + rows * w].view(rows, w), dim=1)
                          for t in terms])
             for s0, rows, w in _segments(row_start)]
    return torch.cat(parts, dim=1), limbo


def monopole_integrate(x, y, vx, vy, m, occ, fxd, fyd, sums, row_start,
                       side: float, ncside: int, deltat: float):
    """One step's monopole, integration and destination over the pool.

    Each slot of row r (cell r) takes the 8 stencil monopole terms of its
    neighbours' COM (``sums``: (3, nrows) M, Σm·x, Σm·y, as
    ``settle_sums`` gives them; a slot out of the box feels none), plus
    the pair force ``fxd``, ``fyd``; then the explicit step with the
    periodic wrap (``m == 0`` slots frozen). x, y, vx, vy are updated in
    place. Returns (x, y, vx, vy, dest, moving), each the shape of x: the
    same x, y, vx, vy tensors, each slot's destination row (int32 cell of
    its new position) and whether it moves (occupied, in the box, dest !=
    r), new tensors.
    """
    dev = x.device
    nrows = _check_rows(row_start, dev)
    _check_grid(nrows, ncside)
    n = x.numel()
    flat = [_flat(k, t, torch.float32, n, dev) for k, t in (
        ("x", x), ("y", y), ("vx", vx), ("vy", vy), ("m", m), ("fxd", fxd),
        ("fyd", fyd))]
    of = _flat("occ", occ, torch.bool, n, dev)
    _flat("sums", sums, torch.float32, 3 * nrows, dev)
    if not cell_pairs._on_card(x, "monopole and integrate pass"):
        return monopole_integrate_ref(x, y, vx, vy, m, occ, fxd, fyd, sums,
                                      row_start, side, ncside, deltat)
    dest = torch.empty(x.shape, dtype=torch.int32, device=dev)
    moving = torch.empty(x.shape, dtype=torch.bool, device=dev)
    cell_pairs._launch(
        "monopole_integrate", _library().psim_monopole_integrate, x,
        *(f.data_ptr() for f in flat[:5]), of.data_ptr(),
        *(f.data_ptr() for f in flat[5:]), sums.data_ptr(),
        row_start.data_ptr(), nrows, cell_width(side, ncside), ncside,
        float(np.float32(side)), float(np.float32(deltat)),
        float(np.float32(G)), dest.data_ptr(), moving.data_ptr(), ROW_WARPS,
        launches=LAUNCHES)
    return x, y, vx, vy, dest, moving


def monopole_integrate_ref(x, y, vx, vy, m, occ, fxd, fyd, sums, row_start,
                           side: float, ncside: int, deltat: float):
    """Plain torch version of ``monopole_integrate``: the composition
    ``stencil.tables_from_sums`` -> ``dense.monopole_tile_forces`` (each
    slot's cell row gathered) -> ``fxd + fxm`` -> ``integrate.integrate``
    -> ``binning.cell_of``, copied into x, y, vx, vy."""
    dev = x.device
    nrows = _check_rows(row_start, dev)
    _check_grid(nrows, ncside)
    shape = x.shape
    xf, yf, vxf, vyf, mf, of, fxf, fyf = (t.reshape(-1) for t in (
        x, y, vx, vy, m, occ, fxd, fyd))
    row = _row_of(row_start)
    _, _, valid = cell_of(xf, yf, side, ncside)
    tables = stencil.tables_from_sums(sums[0], sums[1], sums[2], side, ncside)
    fxm, fym = dense.monopole_tile_forces(
        xf[:, None], yf[:, None], torch.where(of & valid, mf, 0.0)[:, None],
        *(t[row] for t in tables))
    new = integrate.integrate(xf, yf, vxf, vyf, mf, fxf + fxm[:, 0],
                              fyf + fym[:, 0], side, deltat)
    cx, cy, valid = cell_of(new[0], new[1], side, ncside)
    dest = cy * ncside + cx
    moving = of & valid & (dest != row)
    for t, v in zip((x, y, vx, vy), new):
        t.copy_(v.view(shape))
    return x, y, vx, vy, dest.view(shape), moving.view(shape)


def _check_tables(tables, shape, dev):
    """The three stencil tables: float32, ``shape`` each, on ``dev``, with
    one layout (their strides)."""
    if len(tables) != 3:
        raise ValueError(f"{len(tables)} tables, not 3 (ml, mxl, myl)")
    for name, t in zip(("ml", "mxl", "myl"), tables):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}; got "
                             f"{t.dtype}{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} on device {t.device}, x on {dev}")
        if t.stride() != tables[0].stride():
            raise ValueError("the tables' layouts differ")


def _mesh_fields(x, y, vx, vy, m, mf, fxd, fyd):
    dev, n = x.device, x.numel()
    return [_flat(k, t, torch.float32, n, dev) for k, t in (
        ("x", x), ("y", y), ("vx", vx), ("vy", vy), ("m", m), ("mf", mf),
        ("fxd", fxd), ("fyd", fyd))]


def _launch_mesh(flat, tables, sidx, sdir, nidx, sentinel, runs, row_idx,
                 binned, gathered, side, deltat):
    """The rows' kernel, a thread a slot (``runs``: the pool's runs of rows
    of one width, (rows, K) host ints, which it reads by value)."""
    x = flat[0]
    nruns = len(runs)
    run_rows = (ctypes.c_int64 * nruns)(*(r for r, _ in runs))
    run_k = (ctypes.c_int * nruns)(*(k for _, k in runs))
    made = ctypes.c_int(0)
    cell_pairs._launch(
        "monopole_gathered", _library().psim_monopole_rows, x,
        *(f.data_ptr() for f in flat), *(t.data_ptr() for t in tables),
        sidx, sdir, nidx, sentinel, _ptr(row_idx), _ptr(binned), nruns,
        run_rows, run_k, int(gathered), float(np.float32(side)),
        float(np.float32(deltat)), float(np.float32(G)), ctypes.byref(made),
        launches=LAUNCHES, made=made)


def _check_runs(runs, nslots):
    """``runs`` ((rows, K) pairs of host ints) as a tuple, and their rows,
    if they cover ``nslots`` slots; raises otherwise."""
    runs = tuple((int(r), int(k)) for r, k in runs)
    if (not runs or any(r < 0 or k < 1 for r, k in runs)
            or sum(r * k for r, k in runs) != nslots):
        raise ValueError(f"row runs {runs} do not cover the pool's {nslots} "
                         f"slots")
    return runs, sum(r for r, _ in runs)


def tile_monopole_integrate(x, y, vx, vy, m, mf, fxd, fyd, tables,
                            row_start, side: float, deltat: float):
    """The resident meshes' monopole and integration over (nrows, K) tiles,
    in place.

    Each slot of row r takes the 8 stencil terms of row r of ``tables``
    ((ml, mxl, myl), (nrows, 8) float32 each: the row-aligned tables of a
    halo exchange) in ``dense.monopole_tile_forces``' form under its
    monopole mass ``mf``, plus the pair force ``fxd``, ``fyd``; then the
    explicit step with the periodic wrap, ``m == 0`` slots frozen. x, y,
    vx, vy ((nrows, K) float32, like every field) are updated in place and
    returned. ``row_start``: the tiles' (nrows + 1,) int64 row starts, r·K.
    """
    dev = x.device
    if x.dim() != 2:
        raise ValueError(f"tiles must be (nrows, K); got {tuple(x.shape)}")
    nrows = _check_rows(row_start, dev)
    if nrows != x.shape[0]:
        raise ValueError(f"{nrows} row starts for {x.shape[0]} rows")
    flat = _mesh_fields(x, y, vx, vy, m, mf, fxd, fyd)
    _check_tables(tables, (nrows, 8), dev)
    if not cell_pairs._on_card(x, "monopole and integrate pass"):
        return tile_monopole_integrate_ref(x, y, vx, vy, m, mf, fxd, fyd,
                                           tables, row_start, side, deltat)
    _launch_mesh(flat, tables, tables[0].stride(0), tables[0].stride(1),
                 nrows, 0, ((nrows, x.shape[1]),), None, None, False, side,
                 deltat)
    return x, y, vx, vy


def tile_monopole_integrate_ref(x, y, vx, vy, m, mf, fxd, fyd, tables,
                                row_start, side: float, deltat: float):
    """Plain torch version of ``tile_monopole_integrate``:
    ``dense.monopole_tile_forces`` -> ``fxd + fxm`` ->
    ``integrate.integrate``, copied into x, y, vx, vy."""
    fxm, fym = dense.monopole_tile_forces(x, y, mf, *tables)
    new = integrate.integrate(x, y, vx, vy, m, fxd + fxm, fyd + fym, side,
                              deltat)
    for t, v in zip((x, y, vx, vy), new):
        t.copy_(v)
    return x, y, vx, vy


def gathered_monopole_integrate(x, y, vx, vy, m, mf, fxd, fyd, tables, at,
                                side: float, deltat: float, runs,
                                binned=None):
    """The band meshes' monopole and integration over a pool of rows, in
    place.

    The pool is laid out as ``runs`` ((rows, K) pairs of host ints, in
    order: ``rows`` rows of K slots each; ``row_starts(runs)`` are its row
    starts), the only description of its rows either version reads: a
    thread a slot of the kernel finds its row from them by value. ``at``
    gives each row's table index ((nrows,) int64), shared by its slots;
    ``tables`` ((ml, mxl, myl), (8, ncells + 1) float32 each, the last
    column the zero sentinel: a mesh's halo tables). Each slot takes the 8
    terms of its row's index in ``dense.monopole_gathered``'s form under
    its monopole mass ``mf``, plus the pair force ``fxd``, ``fyd``; then
    the explicit step with the periodic wrap, ``m == 0`` slots frozen. An
    index off the tables (a negative one), or a slot where ``binned``
    (bool, the shape of x, optional) is false, takes the sentinel. x, y,
    vx, vy (float32, any shape, like every field) are updated in place and
    returned.
    """
    dev = x.device
    flat = _mesh_fields(x, y, vx, vy, m, mf, fxd, fyd)
    if len(tables) != 3 or tables[0].dim() != 2 or tables[0].shape[0] != 8:
        raise ValueError("tables must be three (8, ncells + 1) tensors")
    nidx = tables[0].shape[1]
    _check_tables(tables, (8, nidx), dev)
    runs, nrows = _check_runs(runs, x.numel())
    if at.dtype != torch.int64:
        raise TypeError(f"at must be int64; got {at.dtype}")
    if at.dim() != 1 or at.numel() != nrows:
        raise ValueError(f"at must be each row's index, ({nrows},) for the "
                         f"runs' rows; got {tuple(at.shape)}")
    _flat("at", at, torch.int64, nrows, dev)
    if binned is not None:
        _flat("binned", binned, torch.bool, x.numel(), dev)
    if not cell_pairs._on_card(x, "monopole and integrate pass"):
        return gathered_monopole_integrate_ref(
            x, y, vx, vy, m, mf, fxd, fyd, tables, at, side, deltat, runs,
            binned)
    _launch_mesh(flat, tables, tables[0].stride(1), tables[0].stride(0),
                 nidx, nidx - 1, runs, at, binned, True, side, deltat)
    return x, y, vx, vy


def gathered_monopole_integrate_ref(x, y, vx, vy, m, mf, fxd, fyd, tables,
                                    at, side: float, deltat: float,
                                    runs=None, binned=None):
    """Plain torch version of ``gathered_monopole_integrate``: each slot's
    index (with ``runs``, its row's by the runs' slot-to-row map; without,
    ``at`` gives each slot's, int32 or int64 the shape of x: the super-cell
    routes' plain chain), the sentinel by ``where``,
    ``dense.monopole_gathered`` -> ``fxd + fxm`` -> ``integrate.integrate``,
    copied into x, y, vx, vy."""
    sentinel = tables[0].shape[1] - 1
    if runs is not None:
        at = at[_rows_of_runs(runs, x.device)].view(x.shape)
    idx = torch.where((at >= 0) & (at < sentinel + 1), at, sentinel)
    if binned is not None:
        idx = torch.where(binned, idx, sentinel)
    fxm, fym = dense.monopole_gathered(x, y, mf, *tables, idx)
    new = integrate.integrate(x, y, vx, vy, m, fxd + fxm, fyd + fym, side,
                              deltat)
    for t, v in zip((x, y, vx, vy), new):
        t.copy_(v)
    return x, y, vx, vy


def _check_super(x, sums, cell, ncside, S, layout, lines):
    """The super-cell pass's inputs (``supercell_monopole_integrate``);
    returns the kernel's geometry (ncells, L, R, rows a shard, row0, rows,
    top, bot), raising on what it does not take."""
    dev = x.device
    if x.dim() != 2:
        raise ValueError(f"tiles must be (rows, kcap); got {tuple(x.shape)}")
    if ncside < 1 or S < 1:
        raise ValueError(f"ncside {ncside}, S {S}: both must be >= 1")
    nrows = x.shape[0]
    if cell.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"cell must be int32 or int64; got {cell.dtype}")
    _flat("cell", cell, cell.dtype, x.numel(), dev)
    if layout is None:
        nsc = -(-ncside // S)
        if nrows != nsc * nsc:
            raise ValueError(f"{nrows} rows for {nsc} x {nsc} super-cells")
        ncells, geom = ncside * ncside, (1, ncside, nrows, None, None, None,
                                         None)
    else:
        if (len(layout.rows) != 1 or not layout.rows_halo
                or layout.cols_halo or not layout.y_ge
                or layout.aligned is not None or layout.C != ncside
                or layout.top_shift is not None
                or layout.bot_shift is not None):
            raise ValueError("the mesh's super-cells take one band of row "
                             "halos, columns wrapping, the 1D y mirror")
        row0, rows = layout.row0[0], layout.rows_mine[0]
        L, R = row0.shape[0], layout.rows[0]
        if ncside % S or nrows % L or (nrows // L) % (ncside // S):
            raise ValueError(f"{nrows} rows of {L} shards are not rows of "
                             f"{ncside // S} super-cells (S {S} | "
                             f"{ncside})")
        for t in (row0, rows):
            if t.device != dev:
                raise ValueError(f"the layout on {t.device}, x on {dev}")
        top, bot = lines[0], lines[1]
        for t in (top, bot):
            stencil_ops._check_lines(t, (L, 1, 3, ncside), x)
        ncells = L * R * ncside
        geom = (L, R, nrows // L, row0, rows, top, bot)
    if ncells >= 2 ** 31:
        raise ValueError(f"{ncells} cells: the pass indexes them in 32 bits")
    for name, t in zip(("M", "SX", "SY"), sums):
        _flat(name, t, torch.float32, ncells, dev)
    return (ncells, *geom)


def supercell_monopole_integrate(x, y, vx, vy, m, mf, fxd, fyd, sums, cell,
                                 side: float, ncside: int, deltat: float,
                                 S: int, layout=None, lines=None):
    """The super-cell engines' monopole and integration from the per-cell
    sums, in place.

    The (rows, kcap) float32 tiles x, y, vx, vy, m, mf, fxd, fyd; ``sums``
    (M, Σm·x, Σm·y), each (ncells,) float32
    (``cell_pairs.supercell_cell_sums``); ``cell`` each slot's cell (int32
    or int64, the tiles' shape; negative or past the sums: the zero
    sentinel). Each slot takes the 8 stencil terms of its cell (the
    neighbours' COM from the sums, M > 0 ? S / M : 0, and the mirror
    offsets) in ``dense.monopole_gathered``'s form under its monopole mass
    ``mf``, plus the pair force ``fxd``, ``fyd``; then the explicit step
    with the periodic wrap, ``m == 0`` slots frozen. x, y, vx, vy are
    updated in place and returned.

    One device (``layout`` None): the (ncside, ncside) grid, cell cy ·
    ncside + cx, row scy · nsc + scx the super-cell of S x S cells (nsc =
    ceil(ncside / S)). The mesh: ``layout`` (``ops/cuda/stencil.HaloLayout``
    of one band of R cell rows a shard, row halos, columns wrapping) and
    ``lines`` (``stencil.exchange``'s received (top, bot, None, None)); the
    sums the shards' (L, R, ncside) grids, cell l·R·ncside + r·ncside + c;
    each shard's rows of the pool in turn, its halo super-row, its owned
    ones, a halo super-row and spares (``parallel/sharded_supercell``).
    The bits of the plain chain: the tables (``stencil.grid_tables_ref`` or
    ``halo_tables_ref``), then ``gathered_monopole_integrate_ref``.
    """
    flat = _mesh_fields(x, y, vx, vy, m, mf, fxd, fyd)
    geom = _check_super(x, sums, cell, ncside, S, layout, lines)
    if not cell_pairs._on_card(x, "monopole and integrate pass"):
        return supercell_monopole_integrate_ref(
            x, y, vx, vy, m, mf, fxd, fyd, sums, cell, side, ncside, deltat,
            S, layout, lines)
    ncells, L, R, rows_t, row0, rows, top, bot = geom
    cell_pairs._launch(
        "monopole_supercell", _library().psim_monopole_supercell, x,
        *(f.data_ptr() for f in flat), cell.data_ptr(),
        int(cell.dtype == torch.int64), x.shape[0], x.shape[1],
        *(t.data_ptr() for t in sums), ncells, ncside, S, L, R, rows_t,
        _ptr(row0), _ptr(rows), _ptr(top), _ptr(bot),
        float(np.float32(side)), 0.0, float(np.float32(deltat)),
        float(np.float32(G)), launches=LAUNCHES)
    return x, y, vx, vy


def supercell_monopole_integrate_ref(x, y, vx, vy, m, mf, fxd, fyd, sums,
                                     cell, side: float, ncside: int,
                                     deltat: float, S: int, layout=None,
                                     lines=None):
    """Plain torch version of ``supercell_monopole_integrate``: the stencil
    tables from the sums (``ops/cuda/stencil.grid_tables_ref`` on one
    device; on the mesh ``halo_tables_ref`` of the shards' grids and the
    received lines), then ``gathered_monopole_integrate_ref`` at each
    slot's cell."""
    if layout is None:
        tables = stencil_ops.grid_tables_ref(*sums, side, ncside,
                                             from_sums=True)
    else:
        L, R = layout.row0[0].shape[0], layout.rows[0]
        grids = [tuple(a.view(L, R, ncside) for a in sums)]
        tables = stencil_ops.halo_tables_ref(grids, layout, lines, side,
                                             ncside, from_sums=True)
    return gathered_monopole_integrate_ref(x, y, vx, vy, m, mf, fxd, fyd,
                                           tables, cell, side, deltat)


def deliver(ts, moving, dest, row_start, at=None):
    """Move the ``moving`` slots to rows ``dest``, in one pass, in place.

    The tiles are a pool of slots in which row r holds the contiguous slots
    ``row_start[r]`` to ``row_start[r + 1]`` (flat indices; rows may differ
    in width, as the banded engine's do). A mover lands in its destination
    row's rank-th free slot, free slots counted after this step's departures
    in slot order, its rank being its place among the row's movers sorted by
    source slot. ``ts``' x, y, vx, vy, m, pid and occ are updated in place;
    returns (ts, undelivered), ``ts`` holding the same tensors:
    ``undelivered`` (int32, 0-d) counts the movers beyond their destination
    rows' free slots. When it is nonzero no mover moves: no byte of the
    tiles changes, nothing is lost, and the engine flags overflow and
    replays the run with larger tiles. A mover's ``dest`` (int32 or int64)
    must be a row of the pool.

    ``at`` (int64 flat slot indices, ascending) limits the movers to those
    slots: ``moving`` and ``dest`` are then given for them alone, and the
    sort and the moves cover them alone (the mesh engines' halo slots after
    a ship round). The result is the whole pool's delivery with no mover
    outside ``at``.

    Only the movers' slots change: an arrival's slot takes its fields (occ
    true), a vacated slot that takes no arrival gets occ false and m 0 and
    keeps its stale x, y, vx, vy and pid. Every other slot keeps its
    values, so an empty slot's m stays 0 where it was 0 (each engine's
    prologue lays empty slots out with m 0, deaths keep occ, and a ship
    round copies whole slots). The kernel (on a CUDA tensor) and
    ``deliver_ref`` (on a CPU tensor) give the same tiles in every field
    and slot.
    """
    dev = ts.x.device
    nrows = _check_rows(row_start, dev)
    n = ts.x.numel()
    fields = [_flat(k, getattr(ts, k), torch.float32, n, dev)
              for k in ("x", "y", "vx", "vy", "m")]
    pid = _flat("pid", ts.pid, torch.int32, n, dev)
    occ = _flat("occ", ts.occ, torch.bool, n, dev)
    k = n if at is None else at.numel()
    if at is not None:
        at = _flat("at", at, torch.int64, k, dev)
    mv = _flat("moving", moving.contiguous(), torch.bool, k, dev)
    if dest.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"dest must be int32 or int64; got {dest.dtype}")
    _flat("dest", dest.contiguous(), dest.dtype, k, dev)
    if not cell_pairs._on_card(ts.x, "delivery"):
        return deliver_ref(ts, moving, dest, row_start, at)
    # The kernel reads int32 rows: exact for a mover's row of the pool.
    dst = dest.to(torch.int32).contiguous().reshape(-1)
    scratch = torch.empty(3 * nrows + 1, dtype=torch.int32, device=dev)
    stage = torch.empty(8 * n, dtype=torch.int32, device=dev)
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    if at is None:
        pool = (None, None)
    else:
        pool = (torch.empty(n, dtype=torch.uint8, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev))
    cell_pairs._launch(
        "deliver", _library().psim_deliver, ts.x,
        *(f.data_ptr() for f in fields), pid.data_ptr(), occ.data_ptr(),
        mv.data_ptr(), dst.data_ptr(), row_start.data_ptr(), nrows, n,
        _ptr(at), 0 if at is None else k, *(_ptr(p) for p in pool),
        scratch.data_ptr(), stage.data_ptr(), perm.data_ptr(), ROW_WARPS,
        launches=LAUNCHES)
    return ts, scratch[3 * nrows]


def deliver_ref(ts, moving, dest, row_start, at=None):
    """Plain torch version of ``deliver``: movers sorted stably by
    (destination row, source slot), ranked in their row, landed in the
    row's rank-th free slot by a scatter of every field, copied into the
    tiles."""
    nslots = ts.x.numel()
    nrows = row_start.shape[0] - 1
    dev = ts.x.device
    occf = ts.occ.reshape(-1)
    moving = moving.reshape(-1)
    if at is None:
        leaving = moving
    else:
        leaving = torch.zeros_like(occf).index_put_((at,), moving)

    # Free slots after departures: the free slots before each row (a row's
    # k-th free slot is the pool's (before[r] + k)-th), and the slot of the
    # q-th free slot of the pool.
    free = ~occf | leaving
    cum = torch.cumsum(free, dim=0)                      # 1-based free rank
    before = torch.cat([cum.new_zeros(1), cum])[row_start]
    n_free = before[1:] - before[:-1]

    # Movers sorted by (destination row, source slot); rank within the row.
    mkey = torch.where(moving, dest.reshape(-1).to(torch.int64), nrows)
    mkey, src = torch.sort(mkey, stable=True)
    if at is not None:
        src = at[src]
    rank, _ = segment_positions(mkey)
    is_mover = mkey < nrows
    drow = torch.clamp(mkey, max=nrows - 1)
    fits = is_mover & (rank < n_free[drow])
    undelivered = torch.sum(is_mover & ~fits, dtype=torch.int32)
    act = fits & (undelivered == 0)
    q = torch.clamp(before[drow] + rank, max=nslots)
    if at is None:
        slot_of_free = torch.full((nslots + 1,), nslots, dtype=torch.int64,
                                  device=dev)
        slot_of_free[torch.where(free, cum - 1, nslots)] = torch.arange(
            nslots, device=dev)
        slot = slot_of_free[q]
    else:
        # A few movers: a binary search of the free ranks.
        slot = torch.searchsorted(cum, q + 1)
    # Inactive entries write to a dump slot past the end.
    tgt = torch.where(act, slot, nslots)
    src_act = torch.where(act, src, nslots)

    def move(a, vacated=None):
        # The movers' values first, then (occ, m) the vacated slots
        # cleared, then the arrivals written.
        flat = torch.cat([a.reshape(-1), a.new_zeros(1)])
        vals = flat[src]
        if vacated is not None:
            flat[src_act] = vacated
        flat[tgt] = vals
        a.view(-1).copy_(flat[:nslots])

    for k in ("x", "y", "vx", "vy", "pid"):
        move(getattr(ts, k))
    move(ts.m, 0.0)
    ts.occ.view(-1).index_fill_(0, src_act[src_act < nslots], False)
    ts.occ.view(-1).index_fill_(0, tgt[tgt < nslots], True)
    return ts, undelivered


def pair_masks(x, y, m, occ, side: float, ncside: int):
    """The pair pass's masks of every slot: ``mf`` (float32: m where the
    slot is binned — occupied, and in the box by ``binning.cell_of`` — else
    0) and ``alive`` (int32: 1 where binned with m > 0, else 0), each the
    shape of x, new tensors.

    x, y, m: float32 and occ bool, the pool's fields (any shape,
    contiguous). Zero mf silences limbo slots in the pair pass: they exert
    and receive no force and never collide.
    """
    dev = x.device
    n = x.numel()
    flat = [_flat(k, t, torch.float32, n, dev)
            for k, t in (("x", x), ("y", y), ("m", m))]
    of = _flat("occ", occ, torch.bool, n, dev)
    if not cell_pairs._on_card(x, "pair masks"):
        return pair_masks_ref(x, y, m, occ, side, ncside)
    mf = torch.empty(x.shape, dtype=torch.float32, device=dev)
    alive = torch.empty(x.shape, dtype=torch.int32, device=dev)
    cell_pairs._launch("pair_masks", _library().psim_pair_masks, x,
                       *(f.data_ptr() for f in flat), of.data_ptr(), n,
                       cell_width(side, ncside), ncside, mf.data_ptr(),
                       alive.data_ptr(), launches=LAUNCHES)
    return mf, alive


def pair_masks_ref(x, y, m, occ, side: float, ncside: int):
    """Plain torch version of ``pair_masks``: ``binning.cell_of``'s in-box
    test, ``where`` and a cast."""
    _, _, valid = cell_of(x, y, side, ncside)
    binned = occ & valid
    return torch.where(binned, m, 0.0), (binned & (m > 0)).to(torch.int32)


def settle_sums(ts, ft, count, undelivered, row_start, side: float,
                ncside: int, kcap: int, sums: bool = True, out=None):
    """A step's tail after its pair pass, and the next step's row sums, over
    the pool, in place.

    ``ft`` (int32, the pair pass's first-pair ranks of the pool's slots, or
    None: no deaths): a slot with ``ft != INF`` died, and ``ts.m`` there
    becomes 0. ``count`` (0-d int32, or None) adds to ``ts.collisions``
    (int64); ``undelivered`` (0-d int32, or None) raises ``ts.overflow``
    (int32) to ``kcap + 1`` where it is nonzero. With ``sums``, returns
    each row's M, Σm·x, Σm·y over its binned slots after the deaths ((3,
    nrows) float32, as ``cell_sums_rows_ref`` gives them) and adds the
    count of occupied slots out of the box (limbo) to ``ts.panics``
    (int32); without, returns None and counts no limbo. The counters are
    updated in place, so a run must own them (``make_tile_run`` clones
    them); the rows must cover the pool. The kernel reads ``count`` and
    ``undelivered`` on the device: no host synchronisation. ``out``: a
    (3, nrows) float32 tensor the sums are written into (a tile run's
    carried sums, read before this pass), else a new one.
    """
    dev = ts.x.device
    nrows = _check_rows(row_start, dev)
    n = ts.x.numel()
    flat = [_flat(k, getattr(ts, k), torch.float32, n, dev)
            for k in ("x", "y", "m")]
    of = _flat("occ", ts.occ, torch.bool, n, dev)
    if ft is not None:
        _flat("ft", ft, torch.int32, n, dev)
    for name, t in (("count", count), ("undelivered", undelivered)):
        if t is not None:
            _flat(name, t, torch.int32, 1, dev)
    for name, dtype in (("collisions", torch.int64), ("panics", torch.int32),
                        ("overflow", torch.int32)):
        _flat(name, getattr(ts, name), dtype, 1, dev)
    if sums and out is not None:
        _flat("out", out, torch.float32, 3 * nrows, dev)
        if out.shape != (3, nrows):
            raise ValueError(f"out shape {tuple(out.shape)} != {(3, nrows)}")
    if not cell_pairs._on_card(ts.x, "settle pass"):
        got = settle_sums_ref(ts, ft, count, undelivered, row_start, side,
                              ncside, kcap, sums)
        return got if got is None or out is None else out.copy_(got)
    if not sums:
        out = None
    elif out is None:
        out = torch.empty((3, nrows), dtype=torch.float32, device=dev)
    cell_pairs._launch(
        "settle_sums", _library().psim_settle_sums, ts.x,
        *(f.data_ptr() for f in flat), of.data_ptr(), _ptr(ft),
        row_start.data_ptr(), nrows, *box_edges(side, ncside), _ptr(out),
        ts.panics.data_ptr(), ts.collisions.data_ptr(), _ptr(count),
        ts.overflow.data_ptr(), _ptr(undelivered), kcap + 1, SETTLE_WARPS,
        launches=LAUNCHES)
    return out


def settle_sums_ref(ts, ft, count, undelivered, row_start, side: float,
                    ncside: int, kcap: int, sums: bool = True):
    """Plain torch version of ``settle_sums``: the deaths' ``where`` (as a
    ``masked_fill_``), the three counter updates, ``cell_sums_rows_ref``."""
    if ft is not None:
        ts.m.masked_fill_((ft != cell_pairs.INF).reshape(ts.m.shape), 0.0)
    if count is not None:
        ts.collisions.add_(count)
    if undelivered is not None:
        ovf = torch.where(undelivered > 0, kcap + 1, 0).to(torch.int32)
        ts.overflow.copy_(torch.maximum(ts.overflow, ovf))
    if not sums:
        return None
    out, limbo = cell_sums_rows_ref(ts.x, ts.y, ts.m, ts.occ, row_start,
                                    side, ncside)
    ts.panics.add_(limbo)
    return out
