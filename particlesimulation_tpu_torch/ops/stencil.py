"""3x3 neighbor-cell monopole stencil with periodic minimum image.

The reference builds, per cell, eight "temp cells" holding each neighbor's COM
offset by ±side per wrapped axis (reference serial/parsim.cpp:301-354). Here
the same data is built for *all* cells at once, a gather of each cell's
neighbours (periodic indices) plus edge-masked mirror offsets, which
degenerates correctly for ``ncside < 3`` where neighbors alias.

Stencil order is the reference's loop order — dx outer, dy inner, skipping
(0,0) (serial/parsim.cpp:301-305).
"""

from __future__ import annotations

import contextlib
import functools

import torch

# (dx, dy) in reference iteration order.
STENCIL = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1),
           (1, -1), (1, 0), (1, 1))


# The lists that the captures in progress add each plan they read to
# (``holding``).
_HOLDERS = []


@contextlib.contextmanager
def holding(into: list):
    """Inside the block, every plan the stencil reads is also appended to
    ``into``. A CUDA graph (``ops/graphed``) keeps a plan's device
    addresses, not its tensors: its capture runs in this block, and the
    graph holds the list, so that a plan the bounded cache evicts stays
    allocated as long as a graph reads it."""
    _HOLDERS.append(into)
    try:
        yield into
    finally:
        _HOLDERS.remove(into)


def _plan(side: float, ncside: int, dtype, device):
    plan = _stencil_plan(side, ncside, dtype, device)
    for into in _HOLDERS:
        into.append(plan)
    return plan


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

    Four launches: the three grids and a 0 in one vector, one gather of
    every neighbour, one addition of the mirror offsets (``_stencil_plan``,
    made once per grid). ``temp.mx = offset; temp.mx += neighbor.mx``
    (serial/parsim.cpp:316-347): the offset is added to the neighbour's
    value, 0 where no mirror applies, as the reference adds it.
    """
    idx, off = _plan(float(side), ncside, MX.dtype, MX.device)
    z = MX.new_zeros(1)
    v = torch.cat([M, z, MX, z, MY, z]).view(3, -1)
    g = v[:, idx]
    mxy = off + g[1:]
    return g[0], mxy[0], mxy[1]


def com_from_sums(M, SX, SY):
    """Per-cell (M, MX, MY) from the mass sums M, Σm·x, Σm·y; an empty cell's
    COM is 0."""
    has = M > 0
    safe = torch.where(has, M, 1.0)
    return (M, torch.where(has, SX / safe, 0.0),
            torch.where(has, SY / safe, 0.0))


def tables_from_sums(M, SX, SY, side: float, ncside: int):
    """Per-cell COM from the mass sums M, Σm·x, Σm·y (flat, (ncells,)), then
    the stencil tables row-aligned for the tile kernels: each (ncells, 8)."""
    ncells = M.shape[0]
    return tuple(t[:, :ncells].T.contiguous() for t in stencil_tables(
        *com_from_sums(M, SX, SY), side, ncside))
