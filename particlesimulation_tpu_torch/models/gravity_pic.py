"""The PIC-gravity model: the reference simulation as a high-level API.

Physics (reference serial/parsim.cpp): N particles in a periodic
``[0, side)²`` box on an ``ncside × ncside`` cell grid; exact pairwise
gravity within a cell, monopole COM attraction from the 8 neighbor cells
with minimum-image mirroring, explicit integration with ``Δt = 0.1``, and
EPSILON-distance collision merging (merged particles freeze with zero mass).

    sim = Simulation(seed=1, side=1000, ncside=10, n_particles=10_000)
    out = sim.run(500)
    out.particle0      # (x, y) — the reference's printed result
    out.collisions     # cumulative merged-cluster count
"""

from __future__ import annotations

import dataclasses

import torch

from particlesimulation_tpu_torch.config import Precision, SimConfig
from particlesimulation_tpu_torch.engine import Engine


@dataclasses.dataclass
class RunResult:
    particle0: tuple
    collisions: int
    state: object
    engine: object

    def gather(self):
        """Full particle arrays in original-id order, as NumPy arrays."""
        st = self.state
        order = torch.argsort(st.pid)
        return {f: getattr(st, f)[order].cpu().numpy()
                for f in ("x", "y", "vx", "vy", "m", "alive", "pid")}


class Simulation:
    """High-level entry point to the single-device engine.

    ``precision="fast"`` (the default) runs the f32 engine the census picks;
    ``precision="parity"`` runs the f64 sweep, bit for bit the reference's
    arithmetic. ``device`` defaults to ``cuda`` (and raises if CUDA is
    absent); pass ``device="cpu"`` to run the plain torch versions on the
    CPU.
    """

    def __init__(self, seed: int, side: float, ncside: int, n_particles: int,
                 precision: str = "fast", n_shards: int = 1, device=None,
                 **kw):
        self.config = SimConfig(
            seed=seed, side=side, ncside=ncside, n_particles=n_particles,
            precision=Precision(precision), n_shards=n_shards, **kw)
        self.engine = Engine(self.config, device=device)
        self._state = None

    @property
    def state(self):
        if self._state is None:
            self._state = self.engine.init_state()
        return self._state

    def run(self, n_steps: int) -> RunResult:
        self._state = self.engine.run(self.state, n_steps)
        x, y, c = self.engine.result(self._state)
        return RunResult(particle0=(x, y), collisions=c, state=self._state,
                         engine=self.engine)

    def reset(self):
        self._state = None
        return self
