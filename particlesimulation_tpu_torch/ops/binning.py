"""Cell binning: particle -> cell keys, (key, pid) sort, segment geometry.

The reference rebuilds pointer buckets every step in ascending particle-index
order (reference serial/parsim.cpp:261-290). Here binning is a sort by
(cell key, particle id): within a cell, particles appear in ascending original
index — the same in-bucket order.

Out-of-range cells (the reference's ``[PANIC2]`` skip-and-continue,
serial/parsim.cpp:276-280) map to a sentinel key ``ncells`` that sorts last.

The sweep engine's ``fori_loop`` trip counts are traced scalars in the JAX
package. In the port the sweep kernels read the occupancy on the card, and
only the plain sweeps read it on the host (``Occupancy``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


class Occupancy:
    """Cell occupancy of lanes whose cells are contiguous, each cell's lanes
    in position order, as the sweeps take it.

    The device part, which the sweep kernels (``ops/cuda/sweep``) read and
    a run carries from step to step: ``counts`` ((ncells + 1,) int64, each
    key's lanes, the sentinel keys' last), ``kmax`` (0-d int64, the most
    lanes of one real cell) and ``large`` (0-d int64, the real cells of
    more than ``sweep.SMALL_CELL`` lanes).

    The host part, which only the plain sweeps (``ops/com``, ``ops/forces``,
    ``ops/collisions``) read, is derived from ``counts`` at first use:
    ``host_kmax`` (``kmax`` as an int, their trip count), ``lanes``,
    ``cells`` and ``order``. ``order`` lists the lanes cell by cell, the
    cells by occupancy descending (ties by key), each cell's lanes in their
    sorted order, then the out-of-range (sentinel) lanes. So the cells
    holding more than ``o`` particles are the first ``lanes[o]`` lanes of
    that order, and a partner at ``pos ± o`` in the same cell sits at ``±
    o`` there too. Reading the host part of a plan on the card raises,
    unless ``read()`` has copied the counts back: a step of a run never
    does, so that a CUDA graph captures it.
    """

    def __init__(self, counts: torch.Tensor, kmax: torch.Tensor,
                 large: torch.Tensor, key: torch.Tensor):
        self.counts = counts  # (ncells + 1,) int64: lanes a key, sentinel last
        self.kmax = kmax      # 0-d int64: the most particles in one real cell
        self.large = large    # 0-d int64: real cells of > SMALL_CELL lanes
        self._key = key
        self._read = counts.device.type == "cpu"

    def read(self) -> "Occupancy":
        """This plan, with its host part read back now: one synchronising
        copy of the counts (for the plain sweeps on the card)."""
        self._read = True
        self._host  # noqa: B018 (the copy, made here)
        return self

    @functools.cached_property
    def _host(self):
        if not self._read:
            raise RuntimeError(
                "the occupancy's host part (lanes, cells, order) of a plan on "
                f"{self.counts.device}: call read() first (a readback)")
        host = self.counts[:-1].cpu().numpy()
        kmax = int(host.max())
        hist = np.bincount(host, minlength=kmax + 1)  # cells by occupancy
        cells_ge = np.cumsum(hist[::-1])[::-1]
        lanes_ge = np.cumsum((hist * np.arange(kmax + 1))[::-1])[::-1]
        return kmax, lanes_ge[1:].tolist(), cells_ge[1:].tolist()

    @property
    def host_kmax(self) -> int:
        """``kmax`` on the host."""
        return self._host[0]

    @property
    def lanes(self) -> list:
        """lanes[o], o < kmax: the lanes of cells holding more than o."""
        return self._host[1]

    @property
    def cells(self) -> list:
        """cells[p], p < kmax: the cells holding more than p."""
        return self._host[2]

    @functools.cached_property
    def order(self) -> torch.Tensor:
        """(N,) int64 lane permutation (the class docstring)."""
        self._host  # noqa: B018 (raises for an unread plan on the card)
        k, counts = self._key, self.counts
        ncells = counts.shape[0] - 1
        # Sentinel lanes sort last.
        return torch.sort(torch.where(k < ncells, -counts[k], 0),
                          stable=True).indices


def occupancy(key, ncells: int, pos=None) -> Occupancy:
    """The occupancy of cell keys whose cells are contiguous, each cell's
    lanes in position order (sorted keys, or the mesh's batched keys);
    sentinel keys (``ncells`` or more) count in no cell. ``pos`` is each
    lane's position in its cell (``segment_positions`` of sorted keys where
    not given). Its device part comes from ``ops/cuda/sweep.
    sweep_occupancy``: on a CUDA tensor the kernel, which reads nothing back;
    on a CPU tensor its plain version."""
    from particlesimulation_tpu_torch.ops.cuda import sweep

    k = key.to(torch.int32)
    if pos is None:
        pos, _ = segment_positions(k)
    return Occupancy(*sweep.sweep_occupancy(k, pos.to(torch.int64), ncells),
                     k.to(torch.int64))


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
