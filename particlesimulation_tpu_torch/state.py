"""Simulation state as tensors (counterpart of ``particlesimulation_tpu/state.py``).

The reference's ``Particle``/``Cell`` classes (serial/parsim.cpp:52-107) become
structure-of-arrays tuples of tensors with static shapes. Particles never
disappear: collisions mark them dead (``alive=False, m=0``) exactly as the
serial variant does (serial/parsim.cpp:414-418), so N is static for the whole
run. Particle arrays are kept sorted by (current cell key, particle id), the
reference's in-bucket order (serial/parsim.cpp:265-289).

``state_from_numpy`` / ``state_to_numpy`` carry a state across packages: a
JAX ``SimState``, ``TileState`` or ``ShardedState`` converted field by field
with ``np.asarray`` becomes the port's state on any device, and back.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from particlesimulation_tpu_torch.ops.resident import TileState


class SimState(NamedTuple):
    """Per-particle state plus run counters. All arrays length N.

    ``pid`` is the original particle index (what the reference calls
    particle ``i``; output reports particle pid==0, serial/parsim.cpp:450-453).
    """

    x: torch.Tensor    # (N,) position: float32, float64 in parity precision
    y: torch.Tensor
    vx: torch.Tensor   # (N,) velocity, as x
    vy: torch.Tensor
    m: torch.Tensor    # (N,) mass, as x; 0 for dead particles
    alive: torch.Tensor  # (N,) bool — cleared on collision, never set again
    pid: torch.Tensor  # (N,) int32 original index
    collisions: torch.Tensor  # () int64 — cumulative merged-cluster count
    panics: torch.Tensor      # () int32 — out-of-range binning events
    overflow: torch.Tensor    # () int32 — tile capacity overflow; nonzero
                              # invalidates the run (the engine retries)


class ShardedState(NamedTuple):
    """Per-shard particle slabs of the mesh engine (``parallel/sharded``).

    Each field is the flat ``(D*C,)`` concatenation of the D shards' slabs
    of C slots, shard 0 first, as the JAX package's mesh-sharded arrays
    read on the host; ``valid`` marks the occupied slots (dead particles
    keep theirs). Each shard's slab is sorted by (cell key, pid), its empty
    slots last. The counters are the mesh's totals.
    """

    x: torch.Tensor
    y: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    m: torch.Tensor
    alive: torch.Tensor
    valid: torch.Tensor   # (D*C,) bool — slot occupancy
    pid: torch.Tensor     # int32; meaningful only where valid
    collisions: torch.Tensor
    panics: torch.Tensor
    overflow: torch.Tensor


# Field dtypes shared by the states (TileState has occ, not alive).
_DTYPES = {
    "x": torch.float32, "y": torch.float32, "vx": torch.float32,
    "vy": torch.float32, "m": torch.float32, "alive": torch.bool,
    "occ": torch.bool, "valid": torch.bool, "pid": torch.int32,
    "collisions": torch.int64, "panics": torch.int32,
    "overflow": torch.int32,
}


def state_from_numpy(fields: dict, device, dtype=None):
    """A state from NumPy arrays keyed by field name, on ``device``.

    The dict holds every field of ``SimState``, of ``TileState`` when it has
    ``occ``, or of ``ShardedState`` when it has ``valid``. Values are cast
    to the port's dtypes; ``dtype`` (float32 by default) is the float
    fields'.
    """
    cls = (TileState if "occ" in fields else
           ShardedState if "valid" in fields else SimState)
    floats = dict.fromkeys(("x", "y", "vx", "vy", "m"),
                           dtype or torch.float32)
    return cls(**{f: torch.tensor(np.asarray(fields[f]),
                                  dtype=floats.get(f, _DTYPES[f]),
                                  device=device) for f in cls._fields})


def state_to_numpy(state) -> dict:
    """Every field of ``state`` as a NumPy array, keyed by field name."""
    return {f: getattr(state, f).cpu().numpy() for f in state._fields}


def result_of(state: SimState) -> tuple[float, float, int]:
    """Final output contract: particle 0's position and the collision count.

    Reference serial/parsim.cpp:450-453. Particle 0 may be dead — its frozen
    position is reported, as in the serial variant.
    """
    idx = int(torch.argmin(state.pid))  # pid 0's slot
    return (float(state.x[idx]), float(state.y[idx]),
            int(state.collisions))
