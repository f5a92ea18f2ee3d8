"""Initial-condition generation (host-side, bit-exact vs the reference).

Reference semantics (serial/parsim.cpp:220-232): per particle, five sequential
RNG draws in x, y, vx, vy, m order. The stream is strictly sequential (and in
normal mode consumes a data-dependent number of uniforms per draw), so initial
conditions are generated on the host — the native C++ path when available,
NumPy otherwise — and then transferred once.
"""

from __future__ import annotations

import numpy as np

from particlesimulation_tpu_torch import native, rng
from particlesimulation_tpu_torch.config import EPSILON2, G, SimConfig


def init_particles_host(config: SimConfig):
    """Return (x, y, vx, vy, m) float64 NumPy arrays, bit-exact vs reference."""
    n = config.n_particles
    res = native.init_particles(config.seed, config.side, config.ncside, n)
    if res is not None:
        return res

    # NumPy fallback — same draw order and expression shapes.
    if config.seed < 0:
        draws = rng.normal_stream_np(config.seed, 5 * n)
    else:
        draws = rng.uniform_stream_np(config.seed, 5 * n)
    d = draws.reshape(n, 5)
    side, g = config.side, config.ncside
    x = d[:, 0] * side
    y = d[:, 1] * side
    vx = (d[:, 2] - 0.5) * side / g / 5.0
    vy = (d[:, 3] - 0.5) * side / g / 5.0
    m = d[:, 4] * 0.01 * (g * g) / float(n) / G * EPSILON2
    return (np.ascontiguousarray(x), np.ascontiguousarray(y),
            np.ascontiguousarray(vx), np.ascontiguousarray(vy),
            np.ascontiguousarray(m))
