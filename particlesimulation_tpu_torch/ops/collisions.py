"""Collision merging (the part of the JAX package's ``ops/collisions.py`` that
the tile engines need; the sweep's collision passes come with the sweep).
"""

from __future__ import annotations

import torch


def apply_deaths(m, alive, died):
    """Kill merged particles: alive=false, m=0 (serial/parsim.cpp:414-418)."""
    return torch.where(died, 0.0, m), alive & ~died
