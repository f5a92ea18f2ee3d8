"""3x3 neighbor-cell monopole stencil with periodic minimum image.

The reference builds, per cell, eight "temp cells" holding each neighbor's COM
offset by ±side per wrapped axis (reference serial/parsim.cpp:301-354). Here
the same data is built for *all* cells at once with ``torch.roll`` on the
``(ncside, ncside)`` COM grids plus edge-masked mirror offsets, which
degenerates correctly for ``ncside < 3`` where neighbors alias.

Stencil order is the reference's loop order — dx outer, dy inner, skipping
(0,0) (serial/parsim.cpp:301-305).
"""

from __future__ import annotations

import torch

# (dx, dy) in reference iteration order.
STENCIL = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1),
           (1, -1), (1, 0), (1, 1))


def stencil_tables(M, MX, MY, side: float, ncside: int):
    """Neighbor monopole tables.

    Args:
      M, MX, MY: flat (ncells,) per-cell mass / COM tensors.
    Returns:
      (ml, mxl, myl): each (8, ncells + 1); row l holds, for every cell, the
      l-th temp-cell of the reference (neighbor COM with mirror offset
      pre-added). The final column is a zero sentinel.
    """
    nc = ncside
    dev, dt = MX.device, MX.dtype
    side_a = torch.full((), side, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    M2 = M.reshape(nc, nc)    # [cy, cx]
    MX2 = MX.reshape(nc, nc)
    MY2 = MY.reshape(nc, nc)
    cx = torch.arange(nc, device=dev)[None, :]  # column index = cell x
    cy = torch.arange(nc, device=dev)[:, None]  # row index = cell y

    ml, mxl, myl = [], [], []
    for dx, dy in STENCIL:
        # rolled[cy, cx] = A[(cy+dy) % nc, (cx+dx) % nc]
        rm = torch.roll(M2, (-dy, -dx), dims=(0, 1))
        rmx = torch.roll(MX2, (-dy, -dx), dims=(0, 1))
        rmy = torch.roll(MY2, (-dy, -dx), dims=(0, 1))
        # Mirror offsets: cx+dx >= nc → +side; cx+dx < 0 → -side
        # (reference serial/parsim.cpp:314-329). Only reachable at the edges.
        if dx == 1:
            offx = torch.where(cx == nc - 1, side_a, zero)
        elif dx == -1:
            offx = torch.where(cx == 0, -side_a, zero)
        else:
            offx = zero
        if dy == 1:
            offy = torch.where(cy == nc - 1, side_a, zero)
        elif dy == -1:
            offy = torch.where(cy == 0, -side_a, zero)
        else:
            offy = zero
        # temp.mx = offset, then temp.mx += neighbor.mx → offset + mx
        # (serial/parsim.cpp:316-347); the add order is preserved.
        ml.append(rm.reshape(-1))
        mxl.append((offx + rmx).reshape(-1))
        myl.append((offy + rmy).reshape(-1))

    pad = torch.zeros((8, 1), dtype=dt, device=dev)
    return (torch.cat([torch.stack(ml), pad], dim=1),
            torch.cat([torch.stack(mxl), pad], dim=1),
            torch.cat([torch.stack(myl), pad], dim=1))


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
