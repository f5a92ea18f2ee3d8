"""particlesimulation_tpu_torch — the PyTorch/CUDA port of particlesimulation_tpu.

A 2D gravitational N-body simulation with a particle-in-cell force
approximation, periodic boundaries and EPSILON-distance collision merging
(reference ``serial/parsim.cpp``), ported from the JAX package beside it to
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper. Module names follow
the JAX package's, so each module's counterpart is easy to find; the JAX
package is the reference the port is tested against, and the port never
imports it (nor jax).

The port runs on one device (``engine.Engine``, behind ``models.Simulation``
and the CLI, ``python -m particlesimulation_tpu_torch``): the f32 fast
engines (slot-resident, supercell, banded, dense, occupancy-classed tiered
tiles, and the sweep), with every Pallas kernel of the JAX package rewritten
in CUDA (``csrc/cell_pairs.cu``), and the f64 parity engine, which
reproduces the reference's arithmetic bit for bit; and on the 1D mesh
(``parallel.sharded.ShardedEngine``, ``--mesh N``) and the 2D rectangle
mesh (``parallel.sharded2d.Sharded2DEngine``, ``--mesh RxC``), whose shards
a local mesh holds on one device.
"""

__version__ = "0.1.0"

from particlesimulation_tpu_torch.config import Precision, SimConfig
from particlesimulation_tpu_torch.state import SimState

__all__ = ["SimConfig", "Precision", "SimState", "__version__"]
