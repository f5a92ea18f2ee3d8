"""3x3 neighbor-cell monopole stencil with periodic minimum image.

The reference builds, per cell, eight "temp cells" holding each neighbor's COM
offset by ±side per wrapped axis (reference serial/parsim.cpp:301-354). Here
the same data is built for *all* cells at once, a gather of each cell's
neighbours (periodic indices) plus edge-masked mirror offsets, which
degenerates correctly for ``ncside < 3`` where neighbors alias.

``stencil_tables`` and ``tables_from_sums`` go through
``ops/cuda/stencil.grid_tables``: one kernel on a CUDA tensor, the gather
by ``_stencil_plan`` on the CPU. The meshes' halo forms below
(``stencil_tables_halo``, ``stencil_tables_halo2d``,
``stencil_tables_halo_cols``) are the plain versions that
``ops/cuda/stencil.halo_tables_ref`` runs on the halo-padded grids.

Stencil order is the reference's loop order — dx outer, dy inner, skipping
(0,0) (serial/parsim.cpp:301-305).
"""

from __future__ import annotations

import functools

import torch

# (dx, dy) in reference iteration order.
STENCIL = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1),
           (1, -1), (1, 0), (1, 1))


@functools.lru_cache(maxsize=8)
def _stencil_plan(side: float, ncside: int, dtype, device):
    """The stencil as a gather: ``idx`` (8, ncells + 1) int64, row l column
    c the index of cell c's l-th neighbour, (cy + dy) % nc * nc + (cx + dx)
    % nc, in a (ncells + 1,) vector whose last entry is the sentinel's 0
    (the last column points there); ``off`` (2, 8, ncells + 1), its mirror
    offsets in x and in y (±side at the wrapped edges, else 0;
    reference serial/parsim.cpp:314-329). Built once per grid and device
    from device operations."""
    nc = ncside
    side_a = torch.full((), side, dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    cx = torch.arange(nc, device=device)[None, :]  # column index = cell x
    cy = torch.arange(nc, device=device)[:, None]  # row index = cell y

    def mirror(d, c):
        if d == 1:
            return torch.where(c == nc - 1, side_a, zero)
        if d == -1:
            return torch.where(c == 0, -side_a, zero)
        return zero

    idx, offx, offy = [], [], []
    for dx, dy in STENCIL:
        idx.append((((cy + dy) % nc) * nc + (cx + dx) % nc).reshape(-1))
        offx.append(mirror(dx, cx).expand(nc, nc).reshape(-1))
        offy.append(mirror(dy, cy).expand(nc, nc).reshape(-1))
    last = torch.full((8, 1), nc * nc, dtype=torch.int64, device=device)
    pad = torch.zeros((8, 1), dtype=dtype, device=device)
    return (torch.cat([torch.stack(idx), last], dim=1),
            torch.stack([torch.cat([torch.stack(o), pad], dim=1)
                         for o in (offx, offy)]))


def stencil_tables(M, MX, MY, side: float, ncside: int):
    """Neighbor monopole tables.

    Args:
      M, MX, MY: flat (ncells,) per-cell mass / COM tensors.
    Returns:
      (ml, mxl, myl): each (8, ncells + 1); row l holds, for every cell, the
      l-th temp-cell of the reference (neighbor COM with mirror offset
      pre-added). The final column is a zero sentinel.

    On a CUDA tensor one kernel (``ops/cuda/stencil.grid_tables``); on the
    CPU its plain version, a gather by the plan above
    (``ops/cuda/stencil.stencil_tables_ref``).
    """
    from particlesimulation_tpu_torch.ops.cuda import stencil as kernels

    return kernels.grid_tables(M, MX, MY, side, ncside)


def com_from_sums(M, SX, SY):
    """Per-cell (M, MX, MY) from the mass sums M, Σm·x, Σm·y; an empty cell's
    COM is 0."""
    has = M > 0
    safe = torch.where(has, M, 1.0)
    return (M, torch.where(has, SX / safe, 0.0),
            torch.where(has, SY / safe, 0.0))


def tables_from_sums(M, SX, SY, side: float, ncside: int):
    """Per-cell COM from the mass sums M, Σm·x, Σm·y (flat, (ncells,)), then
    the stencil tables row-aligned for the tile kernels: each (ncells, 8).
    On a CUDA tensor one kernel, on the CPU ``ops/cuda/stencil``'s
    ``grid_tables_ref``."""
    from particlesimulation_tpu_torch.ops.cuda import stencil as kernels

    return kernels.grid_tables(M, SX, SY, side, ncside, from_sums=True,
                               aligned=True)


# --- the meshes' halo forms (plain; ops/cuda/stencil.halo_tables_ref pads
# the grids and runs the layout's) ---------------------------------------

def stencil_tables_halo(Mp, MXp, MYp, side: float, ncside: int, row0):
    """Monopole stencil tables of halo-padded local COM grids.

    Mp/MXp/MYp: (L, rows_local + 2, ncside) from ``halo_pad``; row0: (L,)
    first global row of each shard. Mirror offsets are applied here, by the
    consumer, from global coordinates, so halo payloads are raw COM data (as
    in the reference, where ghosts carry plain COM and the mirror is
    resolved at force time, mpi/parsim-mpi.cpp:874-935); the values and
    their rounding are ``ops/stencil.stencil_tables``'. Returns (ml, mxl,
    myl): each (8, L * rows_local * ncside + 1), shard-major, with a zero
    sentinel column.
    """
    dt, dev = MXp.dtype, MXp.device
    nc = ncside
    rows_local = Mp.shape[1] - 2
    side_a = torch.full((), side, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    cx = torch.arange(nc, device=dev)[None, None, :]
    gy = row0[:, None, None] + torch.arange(rows_local, device=dev)[:, None]

    ml, mxl, myl = [], [], []
    for dx, dy in STENCIL:
        sl = slice(1 + dy, 1 + dy + rows_local)
        rm, rmx, rmy = (torch.roll(a[:, sl], -dx, dims=2)
                        for a in (Mp, MXp, MYp))
        if dx == 1:
            offx = torch.where(cx == nc - 1, side_a, zero)
        elif dx == -1:
            offx = torch.where(cx == 0, -side_a, zero)
        else:
            offx = zero
        # Mirror in y only where the *global* neighbour row wraps.
        if dy == 1:
            offy = torch.where(gy + 1 >= nc, side_a, zero)
        elif dy == -1:
            offy = torch.where(gy - 1 < 0, -side_a, zero)
        else:
            offy = zero
        ml.append(rm.reshape(-1))
        mxl.append((offx + rmx).reshape(-1))
        myl.append((offy + rmy).reshape(-1))

    pad = torch.zeros((8, 1), dtype=dt, device=dev)
    return (torch.cat([torch.stack(ml), pad], dim=1),
            torch.cat([torch.stack(mxl), pad], dim=1),
            torch.cat([torch.stack(myl), pad], dim=1))


def stencil_tables_halo2d(Mp, MXp, MYp, side: float, ncside: int, row0,
                          col0):
    """Monopole stencil tables of double-halo-padded local COM grids.

    Mp/MXp/MYp: (L, rows_max + 2, cols_max + 2) from
    ``two_phase_com_halo``; row0, col0: (L,) first global row and column of
    each shard. Mirror offsets are applied here from global coordinates, so
    halo payloads are raw COM data (reference mpi/parsim-mpi.cpp:874-935);
    the values and their rounding are ``ops/stencil.stencil_tables``'.
    Returns (ml, mxl, myl): each (8, L * rows_max * cols_max + 1),
    shard-major, then row-major, with a zero sentinel column."""
    dt, dev = MXp.dtype, MXp.device
    nc = ncside
    rows_max, cols_max = Mp.shape[1] - 2, Mp.shape[2] - 2
    side_a = torch.full((), side, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    gx = col0[:, None, None] + torch.arange(cols_max, device=dev)
    gy = row0[:, None, None] + torch.arange(rows_max, device=dev)[:, None]

    ml, mxl, myl = [], [], []
    for dx, dy in STENCIL:
        blk = (slice(None), slice(1 + dy, 1 + dy + rows_max),
               slice(1 + dx, 1 + dx + cols_max))
        # Mirror where the *global* neighbour coordinate wraps.
        if dx == 1:
            offx = torch.where(gx == nc - 1, side_a, zero)
        elif dx == -1:
            offx = torch.where(gx == 0, -side_a, zero)
        else:
            offx = zero
        if dy == 1:
            offy = torch.where(gy == nc - 1, side_a, zero)
        elif dy == -1:
            offy = torch.where(gy == 0, -side_a, zero)
        else:
            offy = zero
        ml.append(Mp[blk].reshape(-1))
        mxl.append((offx + MXp[blk]).reshape(-1))
        myl.append((offy + MYp[blk]).reshape(-1))

    pad = torch.zeros((8, 1), dtype=dt, device=dev)
    return (torch.cat([torch.stack(ml), pad], dim=1),
            torch.cat([torch.stack(mxl), pad], dim=1),
            torch.cat([torch.stack(myl), pad], dim=1))


def stencil_tables_halo_cols(Mp, MXp, MYp, side: float, ncside: int, col0):
    """Monopole stencil tables of column-halo-padded local COM grids.

    Mp/MXp/MYp: (L, ncside, cols_local + 2); column 0 is global column
    ``col0 - 1`` (wrapped), column j + 1 owned column ``col0 + j``, and the
    caller put the right halo (global column ``col0 + CNT``, wrapped) at
    column CNT + 1. Rows wrap locally (every shard holds every row). Mirror
    offsets are applied here from global coordinates, so the halo carries
    raw COM data (reference mpi/parsim-mpi.cpp:874-935); the values and
    their rounding are ``ops/stencil.stencil_tables``'. Columns beyond CNT
    feed no slot. Returns (ml, mxl, myl): each (8, L * ncside * cols_local
    + 1), shard-major, then row-major, with a zero sentinel column."""
    dt, dev = MXp.dtype, MXp.device
    nc = ncside
    cols_local = Mp.shape[2] - 2
    side_a = torch.full((), side, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    cy = torch.arange(nc, device=dev)[None, :, None]
    gx = col0[:, None, None] + torch.arange(cols_local, device=dev)

    ml, mxl, myl = [], [], []
    for dx, dy in STENCIL:
        sl = slice(1 + dx, 1 + dx + cols_local)
        rm, rmx, rmy = (torch.roll(a[:, :, sl], -dy, dims=1)
                        for a in (Mp, MXp, MYp))
        # Mirror in x only where the *global* neighbour column wraps.
        if dx == 1:
            offx = torch.where(gx == nc - 1, side_a, zero)
        elif dx == -1:
            offx = torch.where(gx == 0, -side_a, zero)
        else:
            offx = zero
        if dy == 1:
            offy = torch.where(cy == nc - 1, side_a, zero)
        elif dy == -1:
            offy = torch.where(cy == 0, -side_a, zero)
        else:
            offy = zero
        ml.append(rm.reshape(-1))
        mxl.append((offx + rmx).reshape(-1))
        myl.append((offy + rmy).reshape(-1))

    pad = torch.zeros((8, 1), dtype=dt, device=dev)
    return (torch.cat([torch.stack(ml), pad], dim=1),
            torch.cat([torch.stack(mxl), pad], dim=1),
            torch.cat([torch.stack(myl), pad], dim=1))
