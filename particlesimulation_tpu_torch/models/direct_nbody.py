"""Direct (exact all-pairs) N-body model (counterpart of the JAX package's
``models/direct_nbody.py``).

A second model family: exact O(N²) gravity with no particle-in-cell
approximation. Every pair interacts, with the periodic minimum-image
displacement; nothing is approximated by cell monopoles. It is a validation
instrument: run it and the PIC model (``models.Simulation``) on the same
initial conditions, and the difference measures the PIC approximation
error.

The step: the all-pairs force pass, the explicit integrate (massless slots
frozen), the global EPSILON first-pair search on the new positions, deaths
and the count of pairs first for both ends. On the card both pair passes
are hand-written kernels (``ops/cuda/direct_nbody``), which hold O(N)
memory, so N = 1e5 runs where the JAX package's N×N matrices could not.

    sim = DirectSimulation(seed=-1, side=1000.0, n_particles=100_000)
    st = sim.run(10)          # on cuda; device="cpu" for the CPU
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from particlesimulation_tpu_torch.config import DELTAT, SimConfig
from particlesimulation_tpu_torch.initializer import init_particles_host
from particlesimulation_tpu_torch.ops.cuda.direct_nbody import (
    direct_collisions, direct_forces, first_pair_outcome)
from particlesimulation_tpu_torch.state import state_to_numpy

__all__ = ["DirectState", "DirectSimulation", "make_step", "pair_forces",
           "state_from_numpy", "state_to_numpy"]


class DirectState(NamedTuple):
    x: torch.Tensor      # (N,) position, float32 or float64
    y: torch.Tensor
    vx: torch.Tensor     # (N,) velocity, as x
    vy: torch.Tensor
    m: torch.Tensor      # (N,) mass, as x; 0 once dead
    alive: torch.Tensor  # (N,) bool
    collisions: torch.Tensor  # () int64, cumulative count


def _device(device):
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


def pair_forces(x, y, m, side: float):
    """Exact all-pairs gravity with the periodic minimum image: the kernel
    on a CUDA tensor, the plain version (receiver chunks of 512) on the
    CPU."""
    return direct_forces(x, y, m, side)


def make_step(side: float, n: int, device=None):
    """One step of the direct model on ``DirectState``s of ``n`` particles
    on ``device`` (cuda by default). It reads nothing back to the host."""
    device = _device(device)
    consts = {}

    def const(dt):
        # side, DELTAT and 1 in the state's type, made once on the device.
        if dt not in consts:
            consts[dt] = tuple(torch.full((), v, dtype=dt, device=device)
                               for v in (side, DELTAT, 1.0))
        return consts[dt]

    def step(st: DirectState) -> DirectState:
        if st.x.shape != (n,):
            raise ValueError(f"state of shape {tuple(st.x.shape)}; the step "
                             f"takes ({n},)")
        sidet, dtt, one = const(st.x.dtype)
        fx, fy = pair_forces(st.x, st.y, st.m, side)
        frozen = st.m == 0
        sm = torch.where(frozen, one, st.m)
        ax, ay = fx / sm, fy / sm
        nx = st.x + (st.vx * dtt + ((0.5 * ax) * dtt) * dtt)
        ny = st.y + (st.vy * dtt + ((0.5 * ay) * dtt) * dtt)
        nvx, nvy = st.vx + ax * dtt, st.vy + ay * dtt
        nx = torch.fmod(nx + sidet, sidet)
        ny = torch.fmod(ny + sidet, sidet)
        x = torch.where(frozen, st.x, nx)
        y = torch.where(frozen, st.y, ny)
        vx = torch.where(frozen, st.vx, nvx)
        vy = torch.where(frozen, st.vy, nvy)

        # Global EPSILON merging: pairs anywhere, minimum-image distance.
        died, count = first_pair_outcome(direct_collisions(x, y, st.alive,
                                                           side))
        return DirectState(
            x=x, y=y, vx=vx, vy=vy,
            m=torch.where(died, 0.0, st.m),
            alive=st.alive & ~died,
            collisions=st.collisions + count)

    return step


def state_from_numpy(fields: dict, device, dtype=None) -> DirectState:
    """A ``DirectState`` from NumPy arrays keyed by field name (a JAX
    ``DirectState`` converted with ``np.asarray``), on ``device``; ``dtype``
    (float32 by default) is the float fields'."""
    dtypes = dict.fromkeys(("x", "y", "vx", "vy", "m"),
                           dtype or torch.float32)
    dtypes.update(alive=torch.bool, collisions=torch.int64)
    return DirectState(**{f: torch.tensor(np.asarray(fields[f]),
                                          dtype=dtypes[f], device=device)
                          for f in DirectState._fields})


class DirectSimulation:
    """Exact-gravity counterpart of ``models.Simulation``.

    Initial conditions are the PIC model's with ncside = 1 (ncside only
    scales the initial velocities), so both models can start from the same
    state. ``device`` defaults to ``cuda`` (and raises if CUDA is absent).
    """

    def __init__(self, seed: int, side: float, n_particles: int,
                 dtype=torch.float32, device="cuda"):
        self.side = side
        self.n = n_particles
        self.device = _device(device)
        xs, ys, vxs, vys, ms = init_particles_host(
            SimConfig(seed=seed, side=side, ncside=1,
                      n_particles=n_particles))
        self.state = state_from_numpy(
            {"x": xs, "y": ys, "vx": vxs, "vy": vys, "m": ms,
             "alive": np.ones(n_particles, bool),
             "collisions": np.zeros((), np.int64)}, self.device, dtype)
        self._step = make_step(side, n_particles, self.device)

    def advance(self, state: DirectState, steps: int) -> DirectState:
        """``steps`` steps from ``state``, with no host read."""
        for _ in range(steps):
            state = self._step(state)
        return state

    def run(self, steps: int) -> DirectState:
        """Advance the simulation's state ``steps`` steps; one readback of
        the count at the end."""
        self.state = self.advance(self.state, steps)
        self.collisions = int(self.state.collisions)
        return self.state
