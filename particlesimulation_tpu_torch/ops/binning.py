"""Cell binning: particle -> cell keys, (key, pid) sort, segment geometry.

The reference rebuilds pointer buckets every step in ascending particle-index
order (reference serial/parsim.cpp:261-290). Here binning is a sort by
(cell key, particle id): within a cell, particles appear in ascending original
index — the same in-bucket order.

Out-of-range cells (the reference's ``[PANIC2]`` skip-and-continue,
serial/parsim.cpp:276-280) map to a sentinel key ``ncells`` that sorts last.

The sweep engine's ``fori_loop`` trip counts are traced scalars in the JAX
package; in torch they are host integers, which ``occupancy`` reads back.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


class Occupancy:
    """Cell occupancy of a (key, pid)-sorted particle array, as the sweeps
    (``ops/com``, ``ops/forces``, ``ops/collisions``) take it: trip counts on
    the host, a lane order and the per-key counts on the device.

    ``order`` lists the lanes cell by cell, the cells by occupancy descending
    (ties by key), each cell's lanes in their sorted order, then the
    out-of-range (sentinel) lanes. So the cells holding more than ``o``
    particles are the first ``lanes[o]`` lanes of that order, and a partner
    at ``pos ± o`` in the same cell sits at ``± o`` there too. Only the plain
    sweeps read it, so it is sorted at first use: the sweep kernels
    (``ops/cuda/sweep``) take each lane's cell from its key, its position
    and ``counts``.
    """

    def __init__(self, kmax: int, lanes: list, cells: list,
                 counts: torch.Tensor, key: torch.Tensor):
        self.kmax = kmax      # the most particles in one real cell
        self.lanes = lanes    # lanes[o], o < kmax: lanes of cells holding > o
        self.cells = cells    # cells[p], p < kmax: cells holding > p
        self.counts = counts  # (ncells + 1,) int64: lanes a key, sentinel last
        self._key = key

    @functools.cached_property
    def order(self) -> torch.Tensor:
        """(N,) int64 lane permutation (the class docstring)."""
        k, counts = self._key, self.counts
        ncells = counts.shape[0] - 1
        # Sentinel lanes sort last.
        return torch.sort(torch.where(k < ncells, -counts[k], 0),
                          stable=True).indices


def occupancy(key_sorted, ncells: int) -> Occupancy:
    """The occupancy of sorted cell keys (or of keys whose cells are
    contiguous); sentinel keys (``ncells``) count in no cell. Reads the
    per-cell counts back to the host: one synchronising copy of ``ncells``
    integers."""
    k = key_sorted.to(torch.int64)
    counts = torch.zeros(ncells + 1, dtype=torch.int64, device=k.device)
    counts.index_add_(0, k, torch.ones_like(k))
    host = counts[:ncells].cpu().numpy()
    kmax = int(host.max())
    hist = np.bincount(host, minlength=kmax + 1)  # cells by occupancy
    cells_ge = np.cumsum(hist[::-1])[::-1]
    lanes_ge = np.cumsum((hist * np.arange(kmax + 1))[::-1])[::-1]
    return Occupancy(kmax, lanes_ge[1:].tolist(), cells_ge[1:].tolist(),
                     counts, k)


def cell_of(x, y, side: float, ncside: int):
    """Cell coordinates (int32) and validity of each position.

    Matches ``int(coord / (side/ncside))`` with C truncation-toward-zero
    (reference serial/parsim.cpp:268-272).
    """
    w = torch.full((), side / ncside, dtype=x.dtype, device=x.device)
    cx = (x / w).to(torch.int32)
    cy = (y / w).to(torch.int32)
    valid = (cx >= 0) & (cx < ncside) & (cy >= 0) & (cy < ncside)
    return cx, cy, valid


def cell_keys(x, y, side: float, ncside: int):
    """Cell key per particle (int32); sentinel ``ncside**2`` for out-of-range
    (``cell_of``'s cells)."""
    cx, cy, valid = cell_of(x, y, side, ncside)
    key = torch.where(valid, cy * ncside + cx,
                      torch.full_like(cx, ncside * ncside))
    return key, valid


def sort_by_cell(key, pid, *arrays):
    """Sort by (key, pid); returns (key, pid, *arrays) sorted.

    Torch has no multi-key sort: the pair becomes one int64 composite key
    (key in the high 32 bits; pid >= 0 fits the low 31), unique per particle.
    """
    composite = key.to(torch.int64) * (1 << 32) + pid.to(torch.int64)
    order = torch.argsort(composite)
    return (key[order], pid[order]) + tuple(a[order] for a in arrays)


def segment_positions(key_sorted):
    """Per-element position within its run of equal keys, for sorted keys.

    Returns (pos_in_cell, is_segment_start). pos_in_cell matches the
    reference's in-bucket index j (serial/parsim.cpp:265-289).
    """
    idx = torch.arange(key_sorted.shape[0], device=key_sorted.device)
    # First index of each element's key. (The JAX package takes a running
    # max of segment starts; torch's CUDA cummax took 4.3 ms per call on
    # 1.6M slots on an H100, far more than a binary search per element.)
    seg_start = torch.searchsorted(key_sorted, key_sorted)
    return idx - seg_start, seg_start == idx


def max_occupancy(pos_in_cell, valid):
    """Max particles in any real (non-sentinel) cell; 0-d tensor."""
    return torch.max(torch.where(valid, pos_in_cell, -1)) + 1


def round_cap(x: float) -> int:
    """Tile capacity for an occupancy of ``x``: the next multiple of 32, at
    least 32 (pair-pass cost scales with kcap², so tiles are sized snugly)."""
    return max(32, (int(x) + 31) // 32 * 32)
