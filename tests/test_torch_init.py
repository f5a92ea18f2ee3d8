"""The port's host initializer, RNG streams and state conversion vs the JAX
package: all exact."""

import numpy as np
import pytest
import torch

from particlesimulation_tpu import rng as jrng
from particlesimulation_tpu.config import SimConfig as JSimConfig
from particlesimulation_tpu.engine import Engine as JEngine
from particlesimulation_tpu.engine import make_resident_run as jmake_resident_run
from particlesimulation_tpu.initializer import init_particles_host as jinit
from particlesimulation_tpu_torch import native, rng
from particlesimulation_tpu_torch.config import SimConfig
from particlesimulation_tpu_torch.initializer import init_particles_host
from particlesimulation_tpu_torch.ops.resident import TileState
from particlesimulation_tpu_torch.state import (SimState, state_from_numpy,
                                                state_to_numpy)
from tests.test_golden import FAST_VECTORS
from tests.test_rng import PROBE_SEED1

torch.set_num_threads(2)


@pytest.mark.parametrize("vec", FAST_VECTORS,
                         ids=[f"v{i}" for i in range(len(FAST_VECTORS))])
def test_init_bitwise_equal(vec):
    seed, side, nc, n = vec[:4]
    got = init_particles_host(SimConfig(seed, side, nc, n))
    ref = jinit(JSimConfig(seed, side, nc, n))
    for a, b in zip(got, ref):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b)


def test_probe_values():
    assert rng.uniform_stream_np(1, 3).tolist() == PROBE_SEED1


@pytest.mark.parametrize("seed", [-17, 123])
def test_streams_match_jax_package(seed):
    np.testing.assert_array_equal(rng.uniform_stream_np(seed, 2000),
                                  jrng.uniform_stream_np(seed, 2000))
    np.testing.assert_array_equal(rng.normal_stream_np(seed, 300),
                                  jrng.normal_stream_np(seed, 300))


def test_native_matches_numpy_fallback():
    n, side, nc = 257, 2.5, 7
    res = native.init_particles(-5, side, nc, n)
    assert res is not None, "native build failed"
    d = rng.normal_stream_np(-5, 5 * n).reshape(n, 5)
    np.testing.assert_array_equal(res[0], d[:, 0] * side)
    np.testing.assert_array_equal(res[3], (d[:, 3] - 0.5) * side / nc / 5.0)


def _fields(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def _assert_round_trip(jax_state, cls):
    fields = _fields(jax_state)
    st = state_from_numpy(fields, "cpu")
    assert isinstance(st, cls)
    back = state_to_numpy(st)
    assert set(back) == set(fields)
    for f, a in fields.items():
        np.testing.assert_array_equal(back[f], a, err_msg=f)


def test_state_round_trip():
    cfg = JSimConfig(seed=3, side=8.0, ncside=4, n_particles=300)
    eng = JEngine(cfg, impl="resident", dense_backend="xla")
    state = eng.init_state()
    _assert_round_trip(state, SimState)
    _, prologue, _ = jmake_resident_run(cfg, 64)
    _assert_round_trip(prologue(state), TileState)
