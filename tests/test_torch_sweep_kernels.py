"""The sweep's three wrappers (``ops/cuda/sweep``) on the CPU against the
JAX package's sweep functions, on inputs made to break a kernel's per-lane
order.

On a CPU tensor each wrapper runs its plain version (``ops/com``,
``ops/forces``, ``ops/collisions``), so this holds the path the card's
kernels are held to (``chip_smoke.py --sweep``) against JAX on the same
NumPy inputs:

* float64 (parity): COM, forces (pairs then the 8 stencil terms) bit for
  bit; collision count and dead set exact;
* float32 (fast): the count and dead set exact; COM within rtol 1e-6 plus
  1e-7·side and forces within rtol 1e-5 plus 1e-6·max|f| of JAX's (the
  plain versions sum in other orders, and torch.rsqrt and XLA's may differ
  by an ulp), the tolerances of ``tests/test_torch_sweep.py``.

The inputs (``ops/cuda/adversarial.sweep_particles``, which chip_smoke
gives the kernels too): a cell whose first lane has zero mass followed by
a live one (the parity COM adopts its position) and a massless lane inside
a massive cell; two coincident live particles; two live particles out of
the box (sentinel keys: no pair term, no collision) at one position; a
collision chain A-B, B-C (one count, three deaths); one hot cell; one
wide cell of 2600 lanes (more than a tile of the kernels: coincident pairs
across tile boundaries, a first partner that is not the nearest in x,
pairs at the x window's edge, a live lane at x < 0); and the mesh's lanes
(``adversarial.mesh_lane_order``), each cell contiguous but
the cells out of key order, sentinel lanes between them, with each lane's
position given.

Also: the wrappers' argument checks, the library's ``-fmad=false``, and
that the sweep engine and the mesh's slab sweep go through the three
wrappers (so the card runs the kernels on the same path). JAX results are
cached for the module.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from particlesimulation_tpu.ops import collisions as jcollisions
from particlesimulation_tpu.ops import com as jcom
from particlesimulation_tpu.ops import forces as jforces
from particlesimulation_tpu.ops import stencil as jstencil
from particlesimulation_tpu_torch import engine as engine_mod
from particlesimulation_tpu_torch.config import (EPSILON, Precision,
                                                 SimConfig)
from particlesimulation_tpu_torch.engine import Engine
from particlesimulation_tpu_torch.ops import binning, stencil
from particlesimulation_tpu_torch.ops.cuda import (adversarial, advance,
                                                   cell_pairs, sweep)
from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine
from particlesimulation_tpu_torch.parallel.sharded2d import Sharded2DEngine

torch.set_num_threads(2)

SIDE, NC = adversarial.SWEEP_SIDE, adversarial.SWEEP_NCSIDE
NCELLS = NC * NC
_JAX = {}


def _lanes(case, dtype, seed=7, with_pid=False):
    """Sorted lanes (key, pid order) as torch tensors: x, y, m, alive, key
    (int32), pos (int64), and with ``with_pid`` each lane's pid."""
    x, y, m, alive = adversarial.sweep_particles(case, seed)
    x, y, m = (torch.from_numpy(a.astype(dtype)) for a in (x, y, m))
    key, _ = binning.cell_keys(x, y, SIDE, NC)
    key, pid, x, y, m, alive = binning.sort_by_cell(
        key, torch.arange(x.shape[0], dtype=torch.int32), x, y, m,
        torch.from_numpy(alive))
    pos, _ = binning.segment_positions(key)
    return (x, y, m, alive, key, pos) + ((pid,) if with_pid else ())


def _port(case, dtype, mesh):
    """The three wrappers on the CPU: (M, MX, MY), (fx, fy), (count, died),
    the per-lane outputs in sorted lane order."""
    x, y, m, alive, key, pos = _lanes(case, dtype)
    perm = torch.from_numpy(adversarial.mesh_lane_order(key.numpy(), NCELLS)
                           if mesh else np.arange(x.shape[0]))
    xs, ys, ms, alives, keys, poss = (a[perm].contiguous() for a in (
        x, y, m, alive, key, pos))
    plan = binning.occupancy(keys, NCELLS)
    M, MX, MY = sweep.sweep_com(xs, ys, ms, keys, poss, plan, NCELLS)
    tables = stencil.stencil_tables(M, MX, MY, SIDE, NC)
    fx, fy = sweep.sweep_forces(xs, ys, ms, alives, keys, poss, plan, tables,
                                NCELLS)
    count, died = sweep.sweep_collisions(xs, ys, alives, keys, poss, plan,
                                         EPSILON, NCELLS)
    back = torch.empty_like(perm).index_copy_(0, perm,
                                              torch.arange(perm.shape[0]))
    return (M, MX, MY), (fx[back], fy[back]), (count, died[back])


def _jax(case, dtype):
    """JAX's COM, forces (the blocked or fast sweep, then the monopole
    terms) and collisions on the same sorted lanes, as NumPy."""
    key_ = (case, dtype)
    if key_ not in _JAX:
        x, y, m, alive, key, pos = (jnp.asarray(a.numpy())
                                    for a in _lanes(case, dtype))
        parity = dtype == np.float64
        kmax = jnp.int32(int(jnp.max(jnp.where(key < NCELLS, pos, -1))) + 1)
        com_fn = jcom.com_parity if parity else jcom.com_fast
        M, MX, MY = com_fn(key, x, y, m, NCELLS)
        pair = (jforces.pairwise_forces_parity_blocked if parity
                else jforces.pairwise_forces_fast)
        fx, fy = pair(x, y, m, alive, key, kmax, NCELLS)
        tables = jstencil.stencil_tables(M, MX, MY, SIDE, NC)
        fx, fy = jforces.monopole_forces(x, y, m, alive, key, fx, fy, *tables,
                                         NCELLS, parity)
        count, died = jcollisions.detect_collisions_blocked(
            x, y, alive, key, pos, kmax, EPSILON, NCELLS)
        _JAX[key_] = tuple(tuple(np.asarray(a) for a in t) for t in (
            (M, MX, MY), (fx, fy), (count, died)))
    return _JAX[key_]


CASES = [(case, dt, mesh) for case in ("planted", "hot", "wide")
         for dt in (np.float64, np.float32) for mesh in (False, True)]
IDS = [f"{c}-{'f64' if dt == np.float64 else 'f32'}-{'mesh' if mesh else 'sorted'}"
       for c, dt, mesh in CASES]


@pytest.mark.parametrize("case,dtype,mesh", CASES, ids=IDS)
def test_wrappers_match_jax(case, dtype, mesh):
    (M, MX, MY), (fx, fy), (count, died) = _port(case, dtype, mesh)
    (jM, jMX, jMY), (jfx, jfy), (jcount, jdied) = _jax(case, dtype)
    assert int(count) == int(jcount) > 0
    np.testing.assert_array_equal(died.numpy(), jdied)
    if dtype == np.float64:
        for got, ref in ((M, jM), (MX, jMX), (MY, jMY), (fx, jfx), (fy, jfy)):
            np.testing.assert_array_equal(got.numpy().view(np.int64),
                                          ref.view(np.int64))
        return
    for got, ref in ((M, jM), (MX, jMX), (MY, jMY)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                                   atol=1e-7 * SIDE)
    for got, ref in ((fx, jfx), (fy, jfy)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max())


def test_planted_outcomes():
    """What the planted layouts must give, on their own terms: the chain
    A-B, B-C kills all three; the coincident pair collides; the sentinel
    pair neither collides nor feels a force; the zero-mass first lane of
    cell (0, 0) hands its cell's running mean to the next lane."""
    x, y, m, alive, key, pos, pid = _lanes("planted", np.float64,
                                           with_pid=True)
    (M, MX, MY), (fx, fy), (count, died) = _port("planted", np.float64,
                                                 False)
    lane = {int(p): i for i, p in enumerate(pid)}  # pid -> sorted lane
    assert all(bool(died[lane[p]]) for p in (9, 10, 11, 5, 6))
    assert not died[lane[7]] and not died[lane[8]]
    assert int(key[lane[7]]) == int(key[lane[8]]) == NCELLS
    assert float(fx[lane[7]]) == 0 and float(fy[lane[7]]) == 0
    assert int(pos[lane[0]]) == 0 and int(pos[lane[1]]) == 1
    assert float(m[lane[0]]) == 0.0 and int(count) >= 2
    # The cell's COM through pid 1 alone is pid 1's position; the mean of
    # the whole cell from there on is the one JAX computes (test above).
    one = sweep.sweep_com(x[:2], y[:2], m[:2], key[:2].contiguous(),
                          pos[:2].contiguous(),
                          binning.occupancy(key[:2], NCELLS), NCELLS)
    assert float(one[1][0]) == float(x[1]) and float(one[2][0]) == float(
        y[1])


BAD = {
    "x int": lambda a: {**a, "x": a["x"].to(torch.int32)},
    "y float32": lambda a: {**a, "y": a["y"].float()},
    "m short": lambda a: {**a, "m": a["m"][:-1]},
    "alive int": lambda a: {**a, "alive": a["alive"].to(torch.int32)},
    "key int64": lambda a: {**a, "key": a["key"].long()},
    "pos int32": lambda a: {**a, "pos": a["pos"].int()},
    "x strided": lambda a: {**a, "x": torch.stack([a["x"], a["x"]], 1)[:, 0]},
    "counts short": lambda a: {**a, "plan": binning.Occupancy(
        a["plan"].counts[:-1], a["plan"].kmax, a["plan"].large, a["key"])},
    "2-D x": lambda a: {**a, "x": a["x"][None]},
}


# The arguments each wrapper takes: the COM no alive, the collisions no m.
CHECKS = [(which, bad) for which in ("com", "forces", "collisions")
          for bad in BAD
          if not (which == "com" and bad == "alive int")
          and not (which == "collisions" and bad in ("m short", "y float32"))]


@pytest.mark.parametrize("which,bad", CHECKS,
                         ids=[f"{w}-{b}" for w, b in CHECKS])
def test_wrappers_check_their_arguments(which, bad):
    x, y, m, alive, key, pos = _lanes("planted", np.float64)
    plan = binning.occupancy(key, NCELLS)
    a = BAD[bad](dict(x=x, y=y, m=m, alive=alive, key=key, pos=pos,
                      plan=plan))
    tables = stencil.stencil_tables(*sweep.sweep_com_ref(
        x, y, m, key, pos, plan, NCELLS), SIDE, NC)
    call = {
        "com": lambda: sweep.sweep_com(a["x"], a["y"], a["m"], a["key"],
                                       a["pos"], a["plan"], NCELLS),
        "forces": lambda: sweep.sweep_forces(
            a["x"], a["y"], a["m"], a["alive"], a["key"], a["pos"],
            a["plan"], tables, NCELLS),
        "collisions": lambda: sweep.sweep_collisions(
            a["x"], a["y"], a["alive"], a["key"], a["pos"], a["plan"],
            EPSILON, NCELLS)}[which]
    with pytest.raises((TypeError, ValueError)):
        call()


def test_collisions_take_one_float_type():
    x, y, m, alive, key, pos = _lanes("planted", np.float64)
    plan = binning.occupancy(key, NCELLS)
    for xx, yy in ((x, y.float()), (x.half(), y.half())):
        with pytest.raises(TypeError):
            sweep.sweep_collisions(xx, yy, alive, key, pos, plan, EPSILON,
                                   NCELLS)


def test_forces_check_their_tables():
    x, y, m, alive, key, pos = _lanes("planted", np.float64)
    plan = binning.occupancy(key, NCELLS)
    tables = stencil.stencil_tables(*sweep.sweep_com(
        x, y, m, key, pos, plan, NCELLS), SIDE, NC)
    for bad in ((tables[0][:, :-1].contiguous(),) + tables[1:],
                (tables[0].float(),) + tables[1:]):
        with pytest.raises(ValueError, match="ml"):
            sweep.sweep_forces(x, y, m, alive, key, pos, plan, bad, NCELLS)
    with pytest.raises(ValueError, match="ml"):  # f32 lanes, f64 tables
        sweep.sweep_forces(x.float(), y.float(), m.float(), alive, key, pos,
                           plan, tables, NCELLS)
    with pytest.raises(TypeError):  # lanes of neither float32 nor float64
        sweep.sweep_forces(x.half(), y.half(), m.half(), alive, key, pos,
                           plan, tables, NCELLS)


def test_library_is_built_without_fma(monkeypatch, tmp_path):
    """The nvcc command that builds csrc/sweep.cu carries -fmad=false (the
    parity paths' products and sums must round on their own)."""
    assert "-fmad=false" in sweep.FLAGS and sweep.FLAGS == advance.FLAGS
    seen = []

    def fake_run(cmd, **kw):
        seen.append(cmd)
        open(cmd[cmd.index("-o") + 1], "w").close()
        return type("R", (), {"returncode": 0, "stderr": ""})()

    monkeypatch.setattr(cell_pairs, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cell_pairs.subprocess, "run", fake_run)
    path = sweep.build()
    (cmd,) = seen
    assert "-fmad=false" in cmd and cmd[-1] == sweep.SOURCE
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert path.startswith(str(tmp_path)) and "libsweep_" in path


@pytest.fixture
def calls(monkeypatch):
    """Counts of the three wrappers' calls, through to the real ones."""
    seen = {"sweep_com": 0, "sweep_forces": 0, "sweep_collisions": 0}
    for name in seen:
        real = getattr(sweep, name)

        def counted(*a, _name=name, _real=real, **kw):
            seen[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(sweep, name, counted)
    return seen


@pytest.mark.parametrize("precision", list(Precision))
def test_make_step_calls_the_wrappers(calls, precision):
    cfg = SimConfig(8555, 0.05, 3, 30, precision=precision)
    eng = Engine(cfg, impl="sweep", device="cpu")
    out = eng.run(eng.init_state(), 3)
    assert eng.impl == "sweep" and int(out.overflow) == 0
    assert calls == {"sweep_com": 3, "sweep_forces": 3,
                     "sweep_collisions": 3}


@pytest.mark.parametrize("mesh", ["1d", "2d"])
def test_slab_sweep_calls_the_wrappers(calls, mesh):
    if mesh == "1d":
        eng = ShardedEngine(SimConfig(1, 100.0, 8, 2000, n_shards=2,
                                      precision=Precision.PARITY),
                            device="cpu")
    else:
        eng = Sharded2DEngine(SimConfig(1, 100.0, 8, 2000, n_shards=4,
                                        mesh_shape=(2, 2),
                                        precision=Precision.PARITY),
                              device="cpu")
    out = eng.run(eng.init_state(), 2)
    assert int(out.overflow) == 0
    assert calls == {"sweep_com": 2, "sweep_forces": 2,
                     "sweep_collisions": 2}


def test_sweep_panics_count_the_sentinel_lanes():
    """The step's panics come from the occupancy's sentinel count: the lanes
    out of the box at the step's start (three planted, the state sorted)."""
    cfg = SimConfig(5893, 0.05, 3, 10, precision=Precision.PARITY)
    eng = Engine(cfg, device="cpu")
    s0 = eng.init_state()
    x = s0.x.clone()
    x[:3] = cfg.side + 1.0
    key, _ = binning.cell_keys(x, s0.y, cfg.side, cfg.ncside)
    _, pid, x, y, vx, vy, m, alive = binning.sort_by_cell(
        key, s0.pid, x, s0.y, s0.vx, s0.vy, s0.m, s0.alive)
    state = s0._replace(x=x, y=y, vx=vx, vy=vy, m=m, alive=alive, pid=pid)
    _, run = engine_mod.make_step(cfg)
    assert int(run(state, 1).panics) == 3
