"""Simulation configuration (counterpart of ``particlesimulation_tpu/config.py``).

The reference drives everything from five positional CLI args and four
``#define`` physics constants (reference ``serial/parsim.cpp:13-16,461-469``).
The mesh fields are kept so that a configuration reads the same in both
packages; the port's engines run on one device and refuse ``n_shards > 1``.
"""

from __future__ import annotations

import dataclasses
import enum

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

    # Sharded-engine parameters (not ported yet; single-device engines
    # refuse n_shards > 1).
    n_shards: int = 1
    shard_capacity: int = 0
    migration_capacity: int = 0
    mesh_shape: tuple = ()
    row_starts: tuple = ()

    def __post_init__(self):
        if self.ncside < 1:
            raise ValueError("ncside must be >= 1")
        if self.n_particles < 1:
            raise ValueError("n_particles must be >= 1")
        if self.side <= 0:
            raise ValueError("side must be > 0")
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        object.__setattr__(self, "mesh_shape",
                           tuple(int(v) for v in self.mesh_shape))
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
