"""Simulation configuration (counterpart of ``particlesimulation_tpu/config.py``).

The reference drives everything from five positional CLI args and four
``#define`` physics constants (reference ``serial/parsim.cpp:13-16,461-469``).
The mesh fields read the same in both packages: ``n_shards`` and
``row_starts`` drive the 1D row mesh (``parallel/sharded.py``); ``mesh_shape``
lays the ``n_shards`` shards out as the 2D mesh (``parallel/sharded2d.py``).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

# Physics constants — identical across all reference variants
# (reference serial/parsim.cpp:13-16).
G = 6.67408e-11
EPSILON = 0.005
EPSILON2 = 0.005 * 0.005
DELTAT = 0.1


class Precision(enum.Enum):
    """Compute precision policy.

    PARITY: float64 with the exact operation order of the serial oracle
        (the sweep engine, plain torch).
    FAST: float32, order-free reductions, hand-written CUDA kernels on the
        GPU.
    """

    PARITY = "parity"
    FAST = "fast"


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static parameters of one simulation.

    Mirrors the reference CLI contract
    ``parsim <seed> <side_length> <grid_size> <n_particles> <n_timesteps>``
    (reference serial/parsim.cpp:461-469); ``n_timesteps`` is a run-time
    argument, not part of the config.
    """

    seed: int
    side: float
    ncside: int
    n_particles: int
    precision: Precision = Precision.FAST

    # Sharded-engine parameters (single-device engines refuse n_shards > 1).
    n_shards: int = 1
    # Per-shard particle-slot capacity; 0 = auto (ceil(n/n_shards) * slack).
    shard_capacity: int = 0
    # Per-step migration buffer entries per shard; 0 = auto.
    migration_capacity: int = 0
    # 2D mesh layout (d_rows, d_cols); empty = the 1D row decomposition.
    # Its product is n_shards, and each side is <= ncside.
    mesh_shape: tuple = ()
    # Census-planned shard row boundaries (first owned global row per shard,
    # ascending, starting at 0; ``parallel/balance.py``). Empty = the
    # balanced uneven split below.
    row_starts: tuple = ()

    def __post_init__(self):
        if self.row_starts:
            rs = tuple(int(r) for r in self.row_starts)
            if (len(rs) != self.n_shards or rs[0] != 0
                    or any(b <= a for a, b in zip(rs, rs[1:]))
                    or rs[-1] >= self.ncside):
                raise ValueError(
                    f"row_starts {rs} must be {self.n_shards} strictly "
                    f"increasing rows starting at 0, below ncside="
                    f"{self.ncside}")
        if self.ncside < 1:
            raise ValueError("ncside must be >= 1")
        if self.n_particles < 1:
            raise ValueError("n_particles must be >= 1")
        if self.side <= 0:
            raise ValueError("side must be > 0")
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if self.mesh_shape:
            ms = tuple(int(v) for v in self.mesh_shape)
            if len(ms) != 2 or ms[0] < 1 or ms[1] < 1:
                raise ValueError(f"mesh_shape {ms} must be (d_rows, d_cols)")
            if ms[0] * ms[1] != self.n_shards:
                raise ValueError(
                    f"mesh_shape {ms} has {ms[0] * ms[1]} shards but "
                    f"n_shards is {self.n_shards}")
            if ms[0] > self.ncside or ms[1] > self.ncside:
                raise ValueError(
                    f"mesh_shape {ms} needs at least one grid row and "
                    f"column per shard (ncside={self.ncside})")
            object.__setattr__(self, "mesh_shape", ms)
        elif self.n_shards > self.ncside:
            raise ValueError(
                f"n_shards ({self.n_shards}) must be <= ncside "
                f"({self.ncside}): the row-block decomposition needs at "
                f"least one grid row per shard")
        object.__setattr__(self, "row_starts",
                           tuple(int(r) for r in self.row_starts))

    @property
    def ncells(self) -> int:
        return self.ncside * self.ncside

    @property
    def cell_width(self) -> float:
        # The reference computes side_length / grid_size as an f64 division
        # at every use site (serial/parsim.cpp:268); keep it a single f64.
        return self.side / self.ncside

    # Balanced uneven row decomposition: the first ``rows_rem`` shards own
    # ``rows_base + 1`` rows, the rest ``rows_base``. The reference instead
    # floors rows_per_proc and lets the LAST rank absorb the whole remainder
    # (mpi/parsim-mpi.cpp:338-342).

    @property
    def rows_base(self) -> int:
        return self.ncside // self.n_shards

    @property
    def rows_rem(self) -> int:
        return self.ncside % self.n_shards

    def _row_counts(self) -> tuple:
        """Rows owned per shard under explicit ``row_starts``."""
        ends = self.row_starts[1:] + (self.ncside,)
        return tuple(e - s for s, e in zip(self.row_starts, ends))

    @property
    def rows_max(self) -> int:
        """Per-shard row-grid height: every shard's local grid has one
        shape."""
        if self.row_starts:
            return max(self._row_counts())
        return self.rows_base + (1 if self.rows_rem else 0)

    def shard_of_row(self, row):
        """Owning shard of a global grid row (a Python int or NumPy array)."""
        if self.row_starts:
            return np.searchsorted(np.asarray(self.row_starts), row,
                                   side="right") - 1
        split = self.rows_rem * (self.rows_base + 1)
        big = np.asarray(row) // (self.rows_base + 1)
        small = (self.rows_rem
                 + (np.asarray(row) - split) // max(1, self.rows_base))
        return np.where(np.asarray(row) < split, big, small)

    def row0_of_shard(self, s: int) -> int:
        """First global row owned by shard ``s``."""
        if self.row_starts:
            return self.row_starts[s]
        return s * self.rows_base + min(s, self.rows_rem)

    def rows_of_shard(self, s: int) -> int:
        """Rows owned by shard ``s``."""
        if self.row_starts:
            return self._row_counts()[s]
        return self.rows_base + (1 if s < self.rows_rem else 0)

    def resolved_shard_capacity(self) -> int:
        if self.shard_capacity:
            return self.shard_capacity
        per = -(-self.n_particles // self.n_shards)  # ceil
        cap = int(per * 1.5) + 16
        return min(cap, self.n_particles) if self.n_shards == 1 else cap

    def resolved_migration_capacity(self) -> int:
        if self.migration_capacity:
            return self.migration_capacity
        return max(64, self.resolved_shard_capacity() // 4)
