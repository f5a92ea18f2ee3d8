"""The port's dense engine on the CPU vs the JAX package's, end to end.

The JAX side runs its Pallas kernels in interpret mode. Both start from the
same host initializer; collision counts and dead sets must be exact,
positions hold to atol 1e-6·side and velocities to atol 1e-5·max|v|
(``_assert_same_run``).
"""

import pytest
import torch

from particlesimulation_tpu.config import Precision as JPrecision
from particlesimulation_tpu.config import SimConfig as JSimConfig
from particlesimulation_tpu.engine import Engine as JEngine
from particlesimulation_tpu_torch.config import SimConfig
from particlesimulation_tpu_torch.engine import Engine
from tests.test_golden import FAST_VECTORS
from tests.test_torch_engine import _assert_same_run, _numpy_state

torch.set_num_threads(2)


@pytest.mark.parametrize("seed,side,nc,n,steps", [
    (5893, 0.08, 4, 200, 8),     # collisions
    (1, 50.0, 8, 3000, 3),
])
def test_dense_engine_matches_jax(seed, side, nc, n, steps):
    jeng = JEngine(JSimConfig(seed, side, nc, n, precision=JPrecision.FAST),
                   impl="dense", dense_backend="pallas")
    ref = jeng.run(jeng.init_state(), steps)
    eng = Engine(SimConfig(seed, side, nc, n), impl="dense", device="cpu")
    got = eng.run(eng.init_state(), steps)
    assert eng.impl == jeng.impl == "dense"
    assert eng.kcap == jeng.kcap
    if seed == 5893:
        assert int(ref.collisions) > 0
    _assert_same_run(got, ref, side)


@pytest.mark.parametrize("vec", FAST_VECTORS,
                         ids=[f"v{i}" for i in range(len(FAST_VECTORS))])
def test_fast_golden_dense(vec):
    """The reference harness tolerance: coordinates ±0.001, exact count."""
    seed, side, nc, n, steps, ex, ey, ec = vec
    eng = Engine(SimConfig(seed, side, nc, n), impl="dense", device="cpu")
    out = eng.run(eng.init_state(), steps)
    x, y, c = eng.result(out)
    assert abs(x - ex) <= 0.001, f"x: {x:.4f} vs {ex:.3f}"
    assert abs(y - ey) <= 0.001, f"y: {y:.4f} vs {ey:.3f}"
    assert c == ec
    assert int(out.overflow) == 0


def test_dense_capacity_retry_is_lossless():
    """Tiles far too small at the start are replayed at a larger kcap; the
    result equals a run started at the census kcap."""
    cfg = SimConfig(seed=1, side=10.0, ncside=2, n_particles=500)
    base = Engine(cfg, impl="dense", device="cpu")
    state = base.init_state()
    ref = base.run(state, 4)
    eng = Engine(cfg, kcap=8, impl="dense", device="cpu")
    out = eng.run(state, 4)
    assert eng.impl == "dense" and eng.kcap > 8
    _assert_same_run(out, _numpy_state(ref), cfg.side)


@pytest.mark.parametrize("impl", ["resident", "dense"])
def test_ladder_escalates_to_sweep(impl):
    """1200 particles in one cell: the tiles cannot hold them, and the
    ladder escalates resident -> dense -> sweep, as the JAX engine's does.
    The run equals the JAX sweep engine's (``_assert_same_run``)."""
    cfg = (1, 10.0, 1, 1200)
    eng = Engine(SimConfig(*cfg), impl=impl, device="cpu")
    state = eng.init_state()
    assert eng.kcap == 1024
    out = eng.run(state, 1)
    assert eng.impl == "sweep"
    jeng = JEngine(JSimConfig(*cfg, precision=JPrecision.FAST), impl="sweep")
    _assert_same_run(out, jeng.run(jeng.init_state(), 1), cfg[1])
