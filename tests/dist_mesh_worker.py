"""The ranks of ``tests/test_torch_dist_mesh.py``: each case below run on
a ``DistMesh`` of gloo ranks on the CPU, and, in the test process, on a
``LocalMesh`` of the same shard count by the same function (``mesh``
None).

A group of ``world`` ranks is spawned once (``launch``); its ranks meet
through a ``file://`` store (no port, so that concurrent test processes
cannot collide), run every case of their world size and each write their
records, a pickle a rank, to the run's directory. This module imports the
port only, never JAX.
"""

from __future__ import annotations

import datetime
import os
import pickle

import numpy as np
import torch

from particlesimulation_tpu_torch.config import Precision, SimConfig
from particlesimulation_tpu_torch.models.gravity_pic import Simulation
from particlesimulation_tpu_torch.parallel.mesh import DistMesh
from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine

PARITY = "parity"
RESIDENT = "resident"
# (kind, seed, side, ncside, N, steps, D): the parity sweep and the
# resident tiles; tests/test_sharded.py's and tests/test_sharded_resident.py's
# configs at D = 2 and 4.
RUNS = (
    (PARITY, 1, 2.0, 8, 200, 10, 2),
    (PARITY, 1, 2.0, 8, 200, 10, 4),
    (PARITY, 5893, 0.05, 8, 64, 12, 4),
    (RESIDENT, -10, 3.0, 16, 300, 10, 4),
    (RESIDENT, 1, 2.0, 9, 200, 10, 4),
)
# The collectives' cases: (mesh shape, axis, shift).
PERMUTES = {2: (((2, 1), "rows", 1),),
            4: (((4, 1), "rows", 1), ((4, 1), "rows", -1),
                ((2, 2), "rows", 1), ((2, 2), "cols", 1),
                ((2, 2), "cols", -1))}
# Forced retries (case, run): a resident slab 3 slots short of the fullest
# shard's count (CAP_OVF: the slab grows), and the parity sweep of fast
# movers (tests/test_sharded.py:102) with emigrant buffers of 1 entry (the
# buffers grow).
RETRIES = (("slab", RUNS[4]), ("buffer", (PARITY, 3, 8.0, 8, 400, 10, 4)))
EMPTY = (1, 2.0, 8, 20, 3, 4)   # 20 particles all in grid row 0, D = 4


def _config(run, **kw):
    kind, *args, steps, d = run
    if kind == PARITY:
        n = args[3]
        kw = {"precision": Precision.PARITY, "shard_capacity": n,
              "migration_capacity": n, **kw}
    return SimConfig(*args, n_shards=d, **kw), steps


def _engine(run, mesh, **kw):
    config, steps = _config(run, **kw)
    impl = "resident" if run[0] == RESIDENT else None
    return ShardedEngine(config, impl=impl, device="cpu", mesh=mesh), steps


def route(eng) -> dict:
    """What every rank must agree on: the route, the plan, the capacities."""
    return {"impl": eng.impl, "kcap": eng.kcap, "capacity": eng.capacity,
            "bcap": eng.bcap, "ship_rounds": eng.ship_rounds,
            "row_starts": tuple(eng.config.row_starts)}


def record(eng, out) -> dict:
    return {"gather": eng.gather(out), "result": eng.result(out),
            "collisions": int(out.collisions), "overflow": int(out.overflow),
            "route": route(eng)}


def run_case(run, mesh):
    """``run`` graphed (the CPU twin) and eager on ``mesh`` (None: a
    LocalMesh of its D shards)."""
    eng, steps = _engine(run, mesh)
    state = eng.init_state()
    rec = record(eng, eng.run(state, steps))
    rec["eager"] = eng.gather(eng.run_eager(state, steps))
    return rec


def retry_case(case, mesh):
    """A run whose first attempt overflows for certain; the rung it ends on
    and its result."""
    name, run = case
    if name == "buffer":
        eng, steps = _engine(run, mesh, migration_capacity=1)
        state = eng.init_state()
    else:
        eng, steps = _engine(run, mesh)
        state = eng.init_state()
        L = len(eng.mesh.local_shards)
        fullest = eng.mesh.pmax(torch.sum(state.valid.view(L, -1), dim=1))
        eng.capacity = int(fullest) - 3
    start = route(eng)
    rec = record(eng, eng.run(state, steps))
    rec["start"] = start
    return rec


def empty_case(mesh):
    """Every particle in grid row 0 (shard 0's): the packed state's and a
    short run's gather and result, with shards that hold no particle."""
    seed, side, nc, n, steps, d = EMPTY
    eng = ShardedEngine(SimConfig(seed, side, nc, n, n_shards=d,
                                  precision=Precision.PARITY),
                        device="cpu", mesh=mesh)
    g = np.random.default_rng(seed)
    w = side / nc
    particles = {"x": g.uniform(0, side, n),
                 "y": g.uniform(0.1 * w, 0.2 * w, n), "vx": g.normal(0, 1e-3, n), "vy": np.zeros(n),
                 "m": g.uniform(1e-3, 1e-2, n), "alive": np.ones(n, bool),
                 "pid": np.arange(n, dtype=np.int32)}
    state = eng.pack_particles(particles)
    L = len(eng.mesh.local_shards)
    held = eng.mesh.all_gather(torch.sum(state.valid.view(L, -1), dim=1))
    return {"held": held.tolist(), "packed": eng.gather(state),
            "packed_result": eng.result(state),
            **record(eng, eng.run(state, steps))}


def simulation_case(mesh, d):
    """``Simulation`` with ``mesh`` passed through (None: its LocalMesh)."""
    sim = Simulation(1, 2.0, 8, 200, precision="parity", n_shards=d,
                     device="cpu", mesh=mesh)
    out = sim.run(10)
    return {"gather": out.gather(), "particle0": out.particle0,
            "collisions": out.collisions}


def _raises(fn):
    """The (type name, message) of what ``fn()`` raises; None if nothing."""
    try:
        fn()
    except ValueError as err:
        return type(err).__name__, str(err)
    return None


def refusals(mesh):
    """A mesh that cannot capture: what ``run`` raises (as ``_raises``
    gives it), and ``run_eager``'s gathered state before and after."""
    eng, steps = _engine(RUNS[1], mesh)
    state = eng.init_state()
    eager = eng.gather(eng.run_eager(state, steps))
    mesh.capturable = False   # as a gloo mesh on a CUDA device is
    try:
        graphed = _raises(lambda: eng.run(state, steps))
        eager_after = eng.gather(eng.run_eager(state, steps))
    finally:
        mesh.capturable = True
    return {"run, not capturable": graphed, "eager": eager,
            "eager, not capturable": eager_after}


def collectives(mesh, d, seed=7):
    """Each collective on this rank's row of stacked inputs made from
    ``seed``: {case: output}. ``stacked(d, seed)`` gives the inputs."""
    out = {}
    tree = {k: v[mesh.rank:mesh.rank + 1] for k, v in stacked(d, seed).items()}
    for shape, axis, shift in PERMUTES[d]:
        m = DistMesh("cpu", shape)
        out[(shape, axis, shift)] = m.ppermute(
            {"f": tree["f"], "t": (tree["i"], tree["b"])}, shift, axis)
    out["psum"] = (mesh.psum(tree["i"]), mesh.psum(tree["l"]))
    out["pmax"] = mesh.pmax(tree["i"])
    out["all_gather"] = {k: mesh.all_gather(v) for k, v in tree.items()}
    return out


def stacked(d, seed):
    """Per-shard inputs with a leading shard axis of ``d``: floats, int32,
    int64 and bools."""
    g = np.random.default_rng(seed)
    return {"f": torch.tensor(g.normal(size=(d, 3, 2))),
            "i": torch.tensor(g.integers(-1000, 1000, (d, 5)),
                              dtype=torch.int32),
            "l": torch.tensor(g.integers(0, 1 << 40, (d,))),
            "b": torch.tensor(g.random((d, 4)) < 0.5)}


def rank_main(rank, world, tmp):
    """One rank: every case of its world size, its records pickled."""
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, f'store_{world}')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=120))
    try:
        mesh = DistMesh("cpu")
        recs = {"collectives": collectives(mesh, world),
                "simulation": simulation_case(mesh, world)}
        for run in RUNS:
            if run[-1] == world:
                recs[run] = run_case(run, mesh)
        if world == 4:
            for case in RETRIES:
                recs[case[0]] = retry_case(case, mesh)
            recs["empty"] = empty_case(mesh)
            recs["refusals"] = refusals(mesh)
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(tmp, f"rank_{world}_{rank}.pkl"), "wb") as f:
        pickle.dump(recs, f)


def start(worlds, tmp, main=None):
    """Spawn a group of ranks of ``main`` (``rank_main`` by default; called
    as ``main(rank, world, tmp)``) for each world size, all at once, and
    return their contexts without waiting."""
    import torch.multiprocessing as mp

    return [mp.start_processes(main or rank_main, args=(w, tmp), nprocs=w,
                               join=False, start_method="spawn")
            for w in worlds]


def collect(contexts, worlds, tmp, timeout):
    """Wait for the groups ``start`` spawned (a rank that raises, or
    ``timeout`` seconds, ends every rank and raises); return {world: [each
    rank's records]}."""
    import time

    deadline = time.monotonic() + timeout
    try:
        for ctx in contexts:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after "
                                       f"{timeout} s")
    finally:
        for ctx in contexts:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
    out = {}
    for w in worlds:
        out[w] = []
        for r in range(w):
            with open(os.path.join(tmp, f"rank_{w}_{r}.pkl"), "rb") as f:
                out[w].append(pickle.load(f))
    return out


def launch(worlds, tmp, timeout=240.0):
    """Spawn a group of ranks for each world size, all at once; wait for
    them (a rank that raises, or ``timeout`` seconds, ends every rank and
    raises); return {world: [each rank's records]}."""
    return collect(start(worlds, tmp), worlds, tmp, timeout)
