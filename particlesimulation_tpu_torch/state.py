"""Simulation state as tensors (counterpart of ``particlesimulation_tpu/state.py``).

The reference's ``Particle``/``Cell`` classes (serial/parsim.cpp:52-107) become
structure-of-arrays tuples of tensors with static shapes. Particles never
disappear: collisions mark them dead (``alive=False, m=0``) exactly as the
serial variant does (serial/parsim.cpp:414-418), so N is static for the whole
run. Particle arrays are kept sorted by (current cell key, particle id), the
reference's in-bucket order (serial/parsim.cpp:265-289).

``state_from_numpy`` / ``state_to_numpy`` carry a state across packages: a
JAX ``SimState`` or ``TileState`` converted field by field with
``np.asarray`` becomes the port's state on any device, and back.
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

    x: torch.Tensor    # (N,) float32 position
    y: torch.Tensor
    vx: torch.Tensor   # (N,) float32 velocity
    vy: torch.Tensor
    m: torch.Tensor    # (N,) float32 mass; 0 for dead particles
    alive: torch.Tensor  # (N,) bool — cleared on collision, never set again
    pid: torch.Tensor  # (N,) int32 original index
    collisions: torch.Tensor  # () int64 — cumulative merged-cluster count
    panics: torch.Tensor      # () int32 — out-of-range binning events
    overflow: torch.Tensor    # () int32 — tile capacity overflow; nonzero
                              # invalidates the run (the engine retries)


# Field dtypes shared by SimState and TileState (TileState has occ, not alive).
_DTYPES = {
    "x": torch.float32, "y": torch.float32, "vx": torch.float32,
    "vy": torch.float32, "m": torch.float32, "alive": torch.bool,
    "occ": torch.bool, "pid": torch.int32, "collisions": torch.int64,
    "panics": torch.int32, "overflow": torch.int32,
}


def state_from_numpy(fields: dict, device) -> SimState | TileState:
    """A state from NumPy arrays keyed by field name, on ``device``.

    The dict holds every field of ``SimState`` or, when it has ``occ``, of
    ``TileState``. Values are cast to the port's dtypes.
    """
    cls = TileState if "occ" in fields else SimState
    return cls(**{f: torch.tensor(np.asarray(fields[f]), dtype=_DTYPES[f],
                                  device=device) for f in cls._fields})


def state_to_numpy(state: SimState | TileState) -> dict:
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
