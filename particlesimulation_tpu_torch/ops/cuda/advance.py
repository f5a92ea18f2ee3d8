"""The tile step's advance phase: cell sums, monopole + integrate, delivery.

Between two fused pair passes a slot-resident step (the resident engine's
``engine.make_resident_run``, the banded engine's ``ops/banded``) sums each
cell's mass and moments, applies the 8 stencil monopole terms and the pair
force carried from the last pass, integrates, and delivers the particles
that changed cell. The JAX package runs this phase as XLA code (the row sums
of ``engine.py``'s ``mono_tables``, ``ops/stencil.stencil_tables``,
``ops/dense_xla.monopole_tile_forces``, ``ops/integrate.integrate`` and
``ops/resident.rebin``), which eager torch ran as 320-430 launches a
step. Each wrapper below launches a hand-written CUDA kernel of
``csrc/advance.cu``; the ``*_ref`` function beside it is the plain torch
version of the same function:

* ``cell_sums_rows`` / ``cell_sums_rows_ref``: each row's M, Σm·x and Σm·y
  over its binned slots, and the count of limbo slots;
* ``monopole_integrate`` / ``monopole_integrate_ref``: the monopole terms,
  the integrator and each slot's destination row and moving flag;
* ``deliver`` / ``deliver_ref``: every mover to its destination row in one
  pass (``ops/resident.rebin`` and the engines' advance phases call it).

The tiles are a pool of slots in which row r holds the flat slots
``row_start[r]`` to ``row_start[r + 1]`` (int64, on the tiles' device):
rows of one width in the resident engine, of each band's width in the
banded pool. Row r is cell r of the ``ncside × ncside`` grid for the sums
and the monopole pass; the delivery takes any rows.

A tensor on the CPU goes to the plain version; a tensor on a CUDA device
goes to the kernel, or the wrapper raises. The library is compiled with
``nvcc`` at first use (``cell_pairs.build``) with ``-fmad=false``, so that
every f32 operation of the monopole pass rounds as eager torch rounds it.

Bits: ``monopole_integrate`` gives the plain version's bits from the same
sums, and ``deliver`` the plain version's tiles in every field and slot.
``cell_sums_rows`` adds in a fixed order of its own (a warp a row, see
``csrc/advance.cu``): the same bits in every run, within (K·2⁻²⁴)·Σ|terms|
of ``torch.sum``'s.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from particlesimulation_tpu_torch.config import G
from particlesimulation_tpu_torch.ops import dense, integrate, stencil
from particlesimulation_tpu_torch.ops.binning import cell_of, segment_positions
from particlesimulation_tpu_torch.ops.cuda import cell_pairs

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc", "advance.cu")
# Every f32 multiply and add rounds on its own, as eager torch's do.
FLAGS = ("-fmad=false",)
# Rows (warps) a block of every kernel: a warp a row.
ROW_WARPS = 8

# Kernel launches per wrapper since the last reset_launches() (one a call:
# the delivery's call runs its three passes).
LAUNCHES = {"cell_sums_rows": 0, "monopole_integrate": 0, "deliver": 0}

_lock = threading.Lock()
_lib = None


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def load(path):
    """The kernel library at ``path`` (a build of ``SOURCE``), bound."""
    lib = ctypes.CDLL(path)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.psim_cell_sums_rows.argtypes = [vp] * 5 + [ci, cf, ci, vp, vp, ci, vp]
    lib.psim_monopole_integrate.argtypes = (
        [vp] * 10 + [ci, cf, ci, cf, cf, cf] + [vp] * 6 + [ci, vp])
    lib.psim_deliver.argtypes = (
        [vp] * 10 + [ci, ctypes.c_int64, vp, ci] + [vp] * 12 + [ci, vp])
    for fn in (lib.psim_cell_sums_rows, lib.psim_monopole_integrate,
               lib.psim_deliver):
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


def cell_sums_rows(x, y, m, occ, row_start, side: float, ncside: int):
    """Each row's sums over its binned slots (occupied, in the box by
    ``binning.cell_of``): ``sums`` (3, nrows) float32 — M, Σm·x, Σm·y —
    and ``limbo`` (0-d int32), the count of occupied slots out of the box.

    x, y, m: float32 and occ bool, the pool's fields (any shape,
    contiguous); ``row_start``: the pool's rows. The kernel adds each row's
    terms in a fixed order (a warp a row): the same bits in every run.
    """
    dev = x.device
    nrows = _check_rows(row_start, dev)
    n = x.numel()
    xf, yf, mf = (_flat(k, t, torch.float32, n, dev)
                  for k, t in (("x", x), ("y", y), ("m", m)))
    of = _flat("occ", occ, torch.bool, n, dev)
    if not cell_pairs._on_card(x, "cell sums"):
        return cell_sums_rows_ref(x, y, m, occ, row_start, side, ncside)
    sums = torch.empty((3, nrows), dtype=torch.float32, device=dev)
    limbo = torch.empty((), dtype=torch.int32, device=dev)
    cell_pairs._launch("cell_sums_rows", _library().psim_cell_sums_rows, x,
                       xf.data_ptr(), yf.data_ptr(), mf.data_ptr(),
                       of.data_ptr(), row_start.data_ptr(), nrows,
                       cell_width(side, ncside), ncside, sums.data_ptr(),
                       limbo.data_ptr(), ROW_WARPS, launches=LAUNCHES)
    return sums, limbo


def cell_sums_rows_ref(x, y, m, occ, row_start, side: float, ncside: int):
    """Plain torch version of ``cell_sums_rows``: ``torch.sum`` over each
    run of rows of one width, as a (rows, width) view."""
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
    ``cell_sums_rows`` gives them; a slot out of the box feels none), plus
    the pair force ``fxd``, ``fyd``; then the explicit step with the
    periodic wrap (``m == 0`` slots frozen). Returns (x, y, vx, vy, dest,
    moving), each the shape of x: the new state, each slot's destination
    row (int32 cell of its new position) and whether it moves (occupied,
    in the box, dest != r).
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
    outs = [torch.empty_like(x) for _ in range(4)]
    dest = torch.empty(x.shape, dtype=torch.int32, device=dev)
    moving = torch.empty(x.shape, dtype=torch.bool, device=dev)
    xf, yf, vxf, vyf, mf, fxf, fyf = flat
    cell_pairs._launch(
        "monopole_integrate", _library().psim_monopole_integrate, x,
        xf.data_ptr(), yf.data_ptr(), vxf.data_ptr(), vyf.data_ptr(),
        mf.data_ptr(), of.data_ptr(), fxf.data_ptr(), fyf.data_ptr(),
        sums.data_ptr(), row_start.data_ptr(), nrows,
        cell_width(side, ncside), ncside, float(np.float32(side)),
        float(np.float32(deltat)), float(np.float32(G)),
        *(o.data_ptr() for o in outs), dest.data_ptr(), moving.data_ptr(),
        ROW_WARPS, launches=LAUNCHES)
    return (*outs, dest, moving)


def monopole_integrate_ref(x, y, vx, vy, m, occ, fxd, fyd, sums, row_start,
                           side: float, ncside: int, deltat: float):
    """Plain torch version of ``monopole_integrate``: the composition
    ``stencil.tables_from_sums`` -> ``dense.monopole_tile_forces`` (each
    slot's cell row gathered) -> ``fxd + fxm`` -> ``integrate.integrate``
    -> ``binning.cell_of``."""
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
    nx, ny, nvx, nvy = integrate.integrate(xf, yf, vxf, vyf, mf,
                                           fxf + fxm[:, 0], fyf + fym[:, 0],
                                           side, deltat)
    cx, cy, valid = cell_of(nx, ny, side, ncside)
    dest = cy * ncside + cx
    moving = of & valid & (dest != row)
    return tuple(t.reshape(shape) for t in (nx, ny, nvx, nvy, dest, moving))


def deliver(ts, moving, dest, row_start, at=None):
    """Move the ``moving`` slots to rows ``dest``, in one pass.

    The tiles are a pool of slots in which row r holds the contiguous slots
    ``row_start[r]`` to ``row_start[r + 1]`` (flat indices; rows may differ
    in width, as the banded engine's do). A mover lands in its destination
    row's rank-th free slot, free slots counted after this step's departures
    in slot order, its rank being its place among the row's movers sorted by
    source slot. Returns (ts', undelivered), new tiles: ``undelivered``
    (int32, 0-d) counts the movers beyond their destination rows' free
    slots. When it is nonzero no mover moves: the tiles come back unchanged,
    nothing is lost, and the engine flags overflow and replays the run with
    larger tiles. A mover's ``dest`` (int32 or int64) must be a row of the
    pool.

    ``at`` (int64 flat slot indices, ascending) limits the movers to those
    slots: ``moving`` and ``dest`` are then given for them alone, and the
    sort and the moves cover them alone (the mesh engines' halo slots after
    a ship round). The result is the whole pool's delivery with no mover
    outside ``at``.

    The kernel (on a CUDA tensor) and ``deliver_ref`` (on a CPU tensor) give
    the same tiles in every field and slot: a vacated slot keeps its stale
    x, y, vx, vy and pid with ``occ`` false and ``m`` 0.
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
    shape = ts.x.shape
    outs = [torch.empty_like(a) for a in (*fields, pid, occ)]
    scratch = torch.empty(3 * nrows + 1, dtype=torch.int32, device=dev)
    bucket = torch.empty(n, dtype=torch.int32, device=dev)
    ranked = torch.empty(n, dtype=torch.int32, device=dev)
    if at is None:
        pool = (None, None)
    else:
        pool = (torch.empty(n, dtype=torch.uint8, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev))
    cell_pairs._launch(
        "deliver", _library().psim_deliver, ts.x,
        *(f.data_ptr() for f in fields), pid.data_ptr(), occ.data_ptr(),
        mv.data_ptr(), dst.data_ptr(), row_start.data_ptr(), nrows, n, _ptr(at), k if at is not None else 0,
        *(_ptr(p) for p in pool), scratch.data_ptr(), bucket.data_ptr(),
        ranked.data_ptr(), *(o.data_ptr() for o in outs), ROW_WARPS,
        launches=LAUNCHES)
    x, y, vx, vy, m, pid, occ = (o.view(shape) for o in outs)
    return (ts._replace(x=x, y=y, vx=vx, vy=vy, m=m, occ=occ, pid=pid),
            scratch[2 * nrows])


def deliver_ref(ts, moving, dest, row_start, at=None):
    """Plain torch version of ``deliver``: movers sorted stably by
    (destination row, source slot), ranked in their row, landed in the
    row's rank-th free slot by a scatter of every field."""
    shape = ts.x.shape
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

    def move(a):
        flat = torch.cat([a.reshape(-1), a.new_zeros(1)])
        vals = flat[src]
        flat[tgt] = vals
        return flat[:nslots].reshape(shape)

    occ = torch.cat([occf, occf.new_zeros(1)])
    occ = occ.index_fill_(0, src_act, False).index_fill_(0, tgt, True)
    occ = occ[:nslots].reshape(shape)
    m = torch.where(occ, move(ts.m), 0.0)
    out = ts._replace(x=move(ts.x), y=move(ts.y), vx=move(ts.vx),
                      vy=move(ts.vy), m=m, occ=occ, pid=move(ts.pid))
    return out, undelivered
