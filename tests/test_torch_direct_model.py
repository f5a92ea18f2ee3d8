"""The port's direct (exact all-pairs) model against the JAX package's.

Inputs come from the shared initializer or from NumPy, and go through both
packages as NumPy arrays. Tolerances:

* forces in float32: JAX's own (``tests/test_direct_model.py``), rtol 1e-4
  and atol 1e-5·max|f| (another summation order, and ``rsqrt`` by ulps); in
  float64: rtol 1e-12 and atol 1e-12·max|f| (the same, 2⁻²⁹ finer);
* collisions: exact. Given JAX's post-integrate positions, the deaths are
  JAX's ``ft != INF`` set and the count JAX's count;
* runs: the count and the dead set exact; positions within POS_TOL·side
  and velocities within POS_TOL·max|v|. Measured on these configs: the
  positions bit for bit JAX's, the velocities within 2.4e-8·max|v| (the
  forces move positions by far less than an f32 ulp at the reference's
  mass scale, except in close pairs); the tolerance leaves room for
  another CPU's rounding of the force sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesimulation_tpu.models import direct_nbody as jdirect
from particlesimulation_tpu_torch.config import EPSILON
from particlesimulation_tpu_torch.models import Simulation
from particlesimulation_tpu_torch.models import direct_nbody
from particlesimulation_tpu_torch.models.direct_nbody import (
    DirectSimulation, make_step, pair_forces, state_from_numpy)
from particlesimulation_tpu_torch.ops.cuda import direct_nbody as kernels
from particlesimulation_tpu_torch.ops.cuda.adversarial import (
    DIRECT_GROUPS, plant_direct_cases)

POS_TOL = 1e-6
FIELDS = ("x", "y", "vx", "vy", "m", "alive", "collisions")
_JAX = {}


def _jax_run(seed, side, n, steps, dtype=jnp.float32):
    key = (seed, side, n, steps, dtype)
    if key not in _JAX:
        sim = jdirect.DirectSimulation(seed=seed, side=side, n_particles=n,
                                       dtype=dtype)
        st = sim.run(steps)
        _JAX[key] = {f: np.asarray(getattr(st, f)) for f in FIELDS}
    return _JAX[key]


def _forces_close(got, ref, rtol, atol_frac):
    scale = float(np.abs(ref[0]).max())
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=rtol,
                                   atol=atol_frac * scale)


@pytest.mark.parametrize("n", [128, 600])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pair_forces_match_jax(n, dtype):
    """(a) at N = 128 (one chunk) and 600 (JAX's padded tail chunk)."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    sim = jdirect.DirectSimulation(seed=1, side=100.0, n_particles=n,
                                   dtype=jd)
    ref = [np.asarray(a) for a in jdirect._pair_forces(
        sim.state.x, sim.state.y, sim.state.m, 100.0,
        jchunk=512 if n >= 512 else n)]
    x, y, m = (torch.from_numpy(np.array(a)) for a in
               (sim.state.x, sim.state.y, sim.state.m))
    assert x.dtype == td
    got = pair_forces(x, y, m, 100.0)
    if dtype == "float32":
        _forces_close(got, ref, 1e-4, 1e-5)
    else:
        _forces_close(got, ref, 1e-12, 1e-12)


def test_tail_gets_forces():
    """(b) the tail regression: N = 600 > 512, particles [512:] move."""
    sim = DirectSimulation(seed=1, side=100.0, n_particles=600, device="cpu")
    fx, fy = pair_forces(sim.state.x, sim.state.y, sim.state.m, 100.0)
    assert ((fx[512:].abs() + fy[512:].abs()) > 0).all()


def _planted(n, side, seed, dtype):
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(0.0, side, (2, n))
    vx, vy = rng.uniform(-0.5, 0.5, (2, n)) * side / 50
    m = rng.uniform(0.5, 1.5, n) * 0.01 / n / 6.67408e-11 * EPSILON ** 2
    alive = np.ones(n, bool)
    pairs = [(n - 3, n - 1)] if n > 20 else []
    plant_direct_cases(x, y, vx, vy, m, alive, side, pairs)
    return {"x": x.astype(dtype), "y": y.astype(dtype),
            "vx": vx.astype(dtype), "vy": vy.astype(dtype),
            "m": m.astype(dtype), "alive": alive,
            "collisions": np.zeros((), np.int32)}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n,side", [(600, 100.0), (11, 1.0), (64, 0.05)])
def test_collisions_match_jax(n, side, dtype):
    """(c) the collision pass on JAX's post-integrate positions of one
    make_step from planted states: JAX's deaths and count exactly."""
    fields = _planted(n, side, 3, dtype)
    jst = jdirect.DirectState(**{f: jnp.asarray(v) for f, v in
                                 fields.items()})
    out = jax.jit(jdirect.make_step(side, n))(jst)
    died_ref = fields["alive"] & ~np.asarray(out.alive)
    count_ref = int(out.collisions)
    x, y = (torch.from_numpy(np.array(a)) for a in (out.x, out.y))
    first = kernels.direct_collisions(x, y, torch.from_numpy(
        fields["alive"]), side)
    died, count = kernels.first_pair_outcome(first)
    np.testing.assert_array_equal(died.numpy(), died_ref)
    assert int(count) == count_ref
    if side == 100.0:
        # Sparse enough that only the planted cases collide: the pair, the
        # chain (all three die, one pair counts), the coincident pair, the
        # edge pair and the pair at the tail die; the alive slot beside the
        # dead one lives.
        want = set().union(*DIRECT_GROUPS[:4], {n - 3, n - 1})
        assert set(np.flatnonzero(died_ref).tolist()) == want
        assert count_ref == 5


def test_collision_partners():
    """The first partner is the smallest hitting index: a chain 2-3-4
    gives 3, 2, 3; coincident particles collide and exert no force."""
    fields = _planted(11, 1.0, 0, np.float64)
    x, y, m = (torch.from_numpy(fields[f]) for f in ("x", "y", "m"))
    alive = torch.from_numpy(fields["alive"])
    first = kernels.direct_collisions(x, y, alive, 1.0)
    assert first.tolist() == [1, 0, 3, 2, 3, 6, 5, 8, 7, -1, -1]
    fx, fy = kernels.direct_forces(x, y, m, 1.0)
    assert torch.isfinite(fx).all() and torch.isfinite(fy).all()
    # Slots 5 and 6 coincide: each feels only the others' pull.
    rest = torch.ones(11, dtype=torch.bool)
    rest[6] = False
    fx5, _ = kernels.direct_forces(x[rest].contiguous(),
                                   y[rest].contiguous(),
                                   m[rest].contiguous(), 1.0)
    assert float(fx[5]) == pytest.approx(float(fx5[5]), rel=1e-12)


@pytest.mark.parametrize("cfg", [(1, 100.0, 256, 20), (8555, 0.05, 30, 20),
                                 (1, 0.5, 600, 10)])
def test_run_matches_jax(cfg):
    """(d) DirectSimulation(1, 100.0, 256) for 20 steps, and two configs
    dense enough to collide (7 and 156 collisions): mass conserved, the
    count and the dead set exact, the masses JAX's (a death zeroes a mass,
    nothing else changes one), positions and velocities within
    POS_TOL."""
    seed, side, n, steps = cfg
    ref = _jax_run(seed, side, n, steps)
    sim = DirectSimulation(seed, side, n, device="cpu")
    st = sim.run(steps)
    np.testing.assert_array_equal(st.m.numpy(), ref["m"])
    assert float(st.m.sum()) == pytest.approx(float(ref["m"].sum()),
                                              rel=n * 2.0 ** -24)
    assert sim.collisions == int(ref["collisions"])
    np.testing.assert_array_equal(st.alive.numpy(), ref["alive"])
    for f in ("x", "y"):
        assert np.abs(getattr(st, f).numpy() - ref[f]).max() < POS_TOL * side
    vmax = max(np.abs(ref[f]).max() for f in ("vx", "vy"))
    for f in ("vx", "vy"):
        assert np.abs(getattr(st, f).numpy() - ref[f]).max() < POS_TOL * vmax


def test_run_float64_matches_jax():
    ref = _jax_run(2, 10.0, 200, 5, jnp.float64)
    sim = DirectSimulation(2, 10.0, 200, dtype=torch.float64, device="cpu")
    st = sim.run(5)
    assert sim.collisions == int(ref["collisions"])
    for f in ("x", "y", "vx", "vy"):
        np.testing.assert_allclose(getattr(st, f).numpy(), ref[f],
                                   rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("n", [600, 128])
def test_direct_vs_pic(n):
    """(e) the JAX package's direct-vs-PIC checks on the port: the same
    initial conditions (ncside = 1), 3 steps, within 0.05·side."""
    side = 1.0
    d = DirectSimulation(seed=2, side=side, n_particles=n, device="cpu")
    p = Simulation(seed=2, side=side, ncside=1, n_particles=n,
                   precision="fast", device="cpu")
    ds = d.run(3)
    g = p.run(3).gather()
    assert np.abs(ds.x.numpy() - g["x"]).max() < side * 0.05


@pytest.mark.parametrize("which", ["DIRECT_2048", "DIRECT_2048_DENSE"])
def test_recorded_jax_result(which):
    """(f) chip_smoke's recorded JAX results (seed 1, N 2048, 10 steps, at
    side 100 and, dense enough for 597 collisions, side 1) are the JAX
    package's live values, and the port on the CPU holds them as the card
    run must."""
    import chip_smoke

    seed, side, n, steps, x0, y0, count = getattr(chip_smoke, which)
    ref = _jax_run(seed, side, n, steps)
    assert int(ref["collisions"]) == count
    assert float(ref["x"][0]) == pytest.approx(x0, rel=1e-7)
    assert float(ref["y"][0]) == pytest.approx(y0, rel=1e-7)
    sim = DirectSimulation(seed, side, n, device="cpu")
    st = sim.run(steps)
    assert sim.collisions == count
    assert abs(float(st.x[0]) - x0) < chip_smoke.DIRECT_TOL * side
    assert abs(float(st.y[0]) - y0) < chip_smoke.DIRECT_TOL * side


def test_state_round_trip_from_jax():
    """A JAX DirectState crosses as NumPy arrays, runs a step in the port,
    and crosses back."""
    ref = _jax_run(1, 100.0, 256, 20)
    st = state_from_numpy(ref, "cpu")
    assert st.x.dtype == torch.float32 and st.alive.dtype == torch.bool
    back = direct_nbody.state_to_numpy(st)
    for f in FIELDS:
        np.testing.assert_array_equal(back[f], ref[f])
    out = make_step(100.0, 256, "cpu")(st)
    assert out.x.shape == (256,) and int(out.collisions) >= int(
        ref["collisions"])


def test_cuda_by_default_and_wrappers_refuse_other_devices(monkeypatch):
    """The entry points run on cuda unless asked for the CPU, and raise
    without CUDA; a wrapper takes a CPU or a CUDA tensor only."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DirectSimulation(1, 10.0, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_step(10.0, 8)
    meta = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="device"):
        kernels.direct_forces(meta, meta, meta, 10.0)
    with pytest.raises(ValueError, match="device"):
        kernels.direct_collisions(meta, meta,
                                  torch.empty(8, dtype=torch.bool,
                                              device="meta"), 10.0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "alive", "rank",
                                 "strided"])
def test_wrappers_reject_bad_input(bad):
    x = torch.rand(16)
    y, m = torch.rand(16), torch.rand(16)
    alive = torch.ones(16, dtype=torch.bool)
    if bad == "strided":
        with pytest.raises(ValueError, match="contiguous"):
            kernels.direct_forces(x, torch.rand(32)[::2], m, 1.0)
        with pytest.raises(ValueError, match="contiguous"):
            kernels.direct_collisions(x, y, torch.ones(32, dtype=torch.bool)
                                      [::2], 1.0)
        return
    if bad == "dtype":
        x = x.to(torch.float16)
    elif bad == "shape":
        y = y[:8]
    elif bad == "alive":
        alive = alive.to(torch.int32)
    else:
        x, y, m = (a.reshape(4, 4) for a in (x, y, m))
    with pytest.raises((TypeError, ValueError)):
        if bad == "alive":
            kernels.direct_collisions(x, y, alive, 1.0)
        else:
            kernels.direct_forces(x, y, m, 1.0)

