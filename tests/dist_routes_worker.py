"""The ranks of ``tests/test_torch_dist_routes.py``: every route of both
mesh engines on a ``DistMesh`` of gloo ranks on the CPU, and, in the test
process, on a ``LocalMesh`` of the same shape by the same function (``dist``
False).

The groups are spawned by ``tests/dist_mesh_worker.start`` (D = 2 and 4 at
once, each through a ``file://`` store); each rank runs every case of its
world size and writes its records, a pickle a rank. This module imports the
port only, never JAX.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle

import torch

from particlesimulation_tpu_torch import engine as single
from particlesimulation_tpu_torch.config import Precision, SimConfig
from particlesimulation_tpu_torch.models.gravity_pic import Simulation
from particlesimulation_tpu_torch.parallel.mesh import DistMesh
from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine
from particlesimulation_tpu_torch.parallel.sharded2d import Sharded2DEngine
from particlesimulation_tpu_torch.utils import checkpointing

# engine._STREAM_BYTES and _STREAM_BAND_BYTES lowered so that a uniform
# load of 2048 particles on 16 x 16 cells takes the streaming route.
STREAM = (1, 4000)
# Band plans of tests/test_torch_sharded_banded.PLANS and the cyclic file's
# cases.
PLAN_9 = ((0, 4, 96), (4, 5, 96))
PLAN_16 = ((0, 8, 96), (8, 8, 96))


def _spec(args, steps, shape, impl=None, mesh2d=False, **kw):
    """A case: (seed, side, ncside, N), steps, the mesh's shape, the impl;
    ``mesh2d`` the 2D engine (else the 1D one on a (D, 1) mesh); ``kw``:
    ``parity`` (the f64 sweep on full slabs), ``plan`` (a band plan),
    ``kcap``, ``stream`` (STREAM's thresholds), ``max_kcap`` (the engines'
    K cap lowered), ``cfg`` (more SimConfig keywords), ``fresh_eager``
    (the eager run on a fresh engine: the graphed run's ladder re-packed
    the state)."""
    return dict(args=args, steps=steps, shape=shape, impl=impl,
                mesh2d=mesh2d, **kw)


# Every route of both engines; the ``jax`` ones are the configs that the
# route's test file holds against JAX's mesh (its cached runs).
RUNS = {
    # Super-cells: the census's (sparse loads) and impl="supercell", on
    # test_torch_sharded_supercell.CONFIGS' configs at D <= 4.
    "supercell census D=4": _spec((1, 3.0, 24, 300), 20, (4, 1)),
    "supercell census D=2": _spec((5893, 0.5, 16, 200), 15, (2, 1)),
    "supercell D=2 (jax)": _spec((5893, 0.5, 16, 200), 15, (2, 1),
                                 "supercell"),
    "supercell D=4": _spec((7, 6.0, 32, 400), 15, (4, 1), "supercell"),
    # Column bands: test_torch_sharded_banded.PLANS' D = 4 case, and a
    # two-band plan at D = 2.
    "column bands D=4 (jax)": _spec((3, 8.0, 9, 400), 30, (4, 1), "banded",
                                    plan=PLAN_9),
    "column bands D=2": _spec((5893, 0.05, 16, 256), 12, (2, 1), "banded",
                              plan=PLAN_16),
    # Block-cyclic bands on the same two.
    "cyclic D=4 (jax)": _spec((3, 8.0, 9, 400), 30, (4, 1), "banded-cyclic",
                              plan=PLAN_9),
    "cyclic D=2": _spec((5893, 0.05, 16, 256), 12, (2, 1), "banded-cyclic",
                        plan=PLAN_16),
    # The census's streaming route (column bands of equal rows).
    "streaming census D=4": _spec((1, 8.0, 16, 2048), 5, (4, 1),
                                  stream=True),
    "streaming census D=2": _spec((1, 8.0, 16, 2048), 5, (2, 1),
                                  stream=True),
    # The 2D mesh: parity (its sweep) and rectangle tiles at (2, 1), (1, 2)
    # and (2, 2); tests/test_torch_sharded2d.py's PARITY_CASES and
    # RESIDENT_CASES hold the (2, 2) ones against JAX.
    "2D parity (2, 2) (jax)": _spec((-10, 3.0, 16, 300), 10, (2, 2),
                                    mesh2d=True, parity=True),
    "2D parity (2, 1)": _spec((-10, 3.0, 16, 300), 10, (2, 1), mesh2d=True,
                              parity=True),
    "2D parity (1, 2)": _spec((-10, 3.0, 16, 300), 10, (1, 2), mesh2d=True,
                              parity=True),
    "2D resident (2, 2) (jax)": _spec((1, 2.0, 9, 200), 10, (2, 2),
                                      "resident", mesh2d=True),
    "2D resident (2, 1)": _spec((1, 2.0, 9, 200), 10, (2, 1), "resident",
                                mesh2d=True),
    "2D resident (1, 2)": _spec((1, 2.0, 9, 200), 10, (1, 2), "resident",
                                mesh2d=True),
    # The 2D census's delegation to the 1D mesh of the same ranks: a
    # sparse load to super-cells, a streaming one to column bands.
    "2D delegates to super-cells (2, 2)": _spec((1, 3.0, 24, 300), 8,
                                                (2, 2), mesh2d=True),
    "2D delegates to super-cells (1, 2)": _spec((1, 3.0, 24, 300), 8,
                                                (1, 2), mesh2d=True),
    "2D delegates to bands (2, 2)": _spec((1, 8.0, 16, 2048), 5, (2, 2),
                                          mesh2d=True, stream=True),
}
# Forced retries, one a route: tiles of 4 slots (super-cells, rectangle
# tiles), band plans of K = 8 (grown by grow_plan, then the sweep with its
# re-pack), 1-entry emigrant buffers (the 2D sweep), and super-cells past a
# K cap lowered to 8 (the sweep at once, re-packed by row block).
RETRIES = {
    "supercell kcap 4": _spec((1, 3.0, 24, 300), 20, (4, 1), "supercell",
                              kcap=4),
    "column bands K 8": _spec((-10, 3.0, 16, 600), 10, (4, 1), "banded",
                              plan=((0, 8, 8), (8, 8, 8)), fresh_eager=True),
    "cyclic K 8": _spec((-10, 3.0, 16, 600), 10, (4, 1), "banded-cyclic",
                        plan=((0, 8, 8), (8, 8, 8)), fresh_eager=True),
    "2D resident kcap 4": _spec((1, 2.0, 9, 200), 10, (2, 2), "resident",
                                mesh2d=True, kcap=4),
    "2D sweep buffers of 1": _spec((3, 8.0, 8, 400), 10, (2, 2),
                                   mesh2d=True, parity=True,
                                   cfg={"migration_capacity": 1}),
    "supercell to the sweep": _spec((1, 3.0, 24, 300), 10, (4, 1),
                                    "supercell", kcap=4, max_kcap=8,
                                    fresh_eager=True),
}
# Checkpoints: saved after ``steps``, restored and run ``steps`` more.
CKPTS = {
    "supercell D=4": _spec((1, 3.0, 24, 300), 8, (4, 1), "supercell"),
    "2D parity (2, 2)": _spec((-10, 3.0, 16, 300), 5, (2, 2), mesh2d=True,
                              parity=True),
}
# The D = 4 super-cell checkpoint (LocalMesh's file, written before the
# ranks start) restored onto D = 2.
ACROSS = ("supercell D=4", (2, 1))


def world_of(spec) -> int:
    return spec["shape"][0] * spec["shape"][1]


@contextlib.contextmanager
def patched(spec):
    """The module constants a case lowers, restored after it."""
    saved = (single._STREAM_BYTES, single._STREAM_BAND_BYTES,
             single.MAX_XLA_KCAP)
    if spec.get("stream"):
        single._STREAM_BYTES, single._STREAM_BAND_BYTES = STREAM
    if spec.get("max_kcap"):
        single.MAX_XLA_KCAP = spec["max_kcap"]
    try:
        yield
    finally:
        (single._STREAM_BYTES, single._STREAM_BAND_BYTES,
         single.MAX_XLA_KCAP) = saved


def build(spec, dist: bool, shape=None):
    """The case's engine on a DistMesh of its shape (``dist``) or on its
    LocalMesh; ``shape`` overrides the case's."""
    shape = tuple(shape or spec["shape"])
    d = shape[0] * shape[1]
    kw = dict(spec.get("cfg", {}))
    if spec.get("parity"):
        n = spec["args"][3]
        kw = {"precision": Precision.PARITY, "shard_capacity": n,
              "migration_capacity": n, **kw}
    if spec["mesh2d"]:
        kw["mesh_shape"] = shape
    mesh = DistMesh("cpu", shape) if dist else None
    cls = Sharded2DEngine if spec["mesh2d"] else ShardedEngine
    eng = cls(SimConfig(*spec["args"], n_shards=d, **kw), impl=spec["impl"],
              kcap=spec.get("kcap"), device="cpu", mesh=mesh)
    if spec.get("plan"):
        eng._band_plan = spec["plan"]
    return eng


def route(eng) -> dict:
    """What every rank must agree on: the route (a 2D engine's delegate's
    where it has one), its plan and capacities."""
    t = eng.target() if isinstance(eng, Sharded2DEngine) else eng
    return {"impl": eng.impl, "delegated": t is not eng, "kcap": t.kcap,
            "capacity": t.capacity, "bcap": t.bcap,
            "ship_rounds": t.ship_rounds,
            "band_plan": getattr(t, "_band_plan", None),
            "variant": getattr(t, "banded_variant", None),
            "sc_factor": getattr(t, "_sc_factor", None),
            "row_starts": tuple(t.config.row_starts)}


def record(eng, out) -> dict:
    return {"gather": eng.gather(out), "result": eng.result(out),
            "collisions": int(out.collisions), "overflow": int(out.overflow),
            "route": route(eng)}


def run_case(spec, dist: bool) -> dict:
    """The case graphed (the CPU twin) from init_state, and eager: its
    record, the route it started on and the eager run's gathered state."""
    with patched(spec):
        eng = build(spec, dist)
        state = eng.init_state()
        start = route(eng)
        rec = record(eng, eng.run(state, spec["steps"]))
        if spec.get("fresh_eager"):
            eng = build(spec, dist)
            state = eng.init_state()
        rec["eager"] = eng.gather(eng.run_eager(state, spec["steps"]))
    rec["start"] = start
    return rec


def ckpt_path(tmp, name, dist: bool) -> str:
    return os.path.join(tmp, f"ckpt_{list(CKPTS).index(name)}_"
                             f"{'dist' if dist else 'local'}.npz")


def _state_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in a._fields)


def ckpt_case(name, dist: bool, tmp) -> dict:
    """``steps`` steps, saved (every rank calls the save; rank 0 writes),
    restored onto the same engine (as saved: each rank its own slab) and
    run ``steps`` more: the record of that run, the file's path and
    whether the restored state was the saved one."""
    spec = CKPTS[name]
    eng = build(spec, dist)
    mid = eng.run(eng.init_state(), spec["steps"])
    path = ckpt_path(tmp, name, dist)
    checkpointing.save_sharded_state(path, mid, engine=eng)
    restored = checkpointing.restore_sharded(path, eng)
    rec = record(eng, eng.run(restored, spec["steps"]))
    rec.update(path=path, as_saved=_state_equal(restored, mid),
               mid=eng.gather(mid))
    return rec


def across_case(dist: bool, tmp) -> dict:
    """LocalMesh's D = 4 checkpoint of ``ACROSS`` restored onto a fresh
    engine of ACROSS's shape (a re-pack) and run its steps."""
    name, shape = ACROSS
    spec = CKPTS[name]
    eng = build(spec, dist, shape)
    state = checkpointing.restore_sharded(ckpt_path(tmp, name, False), eng)
    return record(eng, eng.run(state, spec["steps"]))


def simulation_case(dist: bool) -> dict:
    """``Simulation(..., mesh_shape=(2, 2), mesh=)``: the 2D engine on the
    mesh passed (None: its LocalMesh)."""
    sim = Simulation(1, 2.0, 8, 200, precision="parity", n_shards=4,
                     mesh_shape=(2, 2), device="cpu",
                     mesh=DistMesh("cpu", (2, 2)) if dist else None)
    out = sim.run(10)
    return {"engine": type(sim.engine).__name__, "gather": out.gather(),
            "particle0": out.particle0, "collisions": out.collisions}


def local_checkpoints(tmp) -> dict:
    """The checkpoint cases on their LocalMesh, their files written to
    ``tmp`` (``ACROSS``'s ranks read one): run before the ranks start."""
    return {("ckpt", name): ckpt_case(name, False, tmp) for name in CKPTS}


def local_records(tmp) -> dict:
    """The other cases on their LocalMesh, keyed as ``rank_main``'s
    records."""
    recs = {name: run_case(spec, False)
            for name, spec in {**RUNS, **RETRIES}.items()}
    recs["across"] = across_case(False, tmp)
    recs["simulation"] = simulation_case(False)
    return recs


def local_main(_, tmp):
    """The LocalMesh records in a process of their own (spawned by
    ``start_local``), pickled to ``tmp``."""
    torch.set_num_threads(2)
    with open(os.path.join(tmp, "local.pkl"), "wb") as f:
        pickle.dump(local_records(tmp), f)


def start_local(tmp):
    """Spawn ``local_main`` without waiting; its context (for
    ``dist_mesh_worker.collect``)."""
    import torch.multiprocessing as mp

    return mp.start_processes(local_main, args=(tmp,), nprocs=1, join=False,
                              start_method="spawn")


def load_local(tmp) -> dict:
    with open(os.path.join(tmp, "local.pkl"), "rb") as f:
        return pickle.load(f)


def rank_main(rank, world, tmp):
    """One rank: every case of its world size, its records pickled."""
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, f'store_{world}')}",
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    recs = {}
    try:
        for name, spec in {**RUNS, **RETRIES}.items():
            if world_of(spec) == world:
                recs[name] = run_case(spec, True)
        for name, spec in CKPTS.items():
            if world_of(spec) == world:
                recs[("ckpt", name)] = ckpt_case(name, True, tmp)
        if world == ACROSS[1][0] * ACROSS[1][1]:
            recs["across"] = across_case(True, tmp)
        if world == 4:
            recs["simulation"] = simulation_case(True)
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(tmp, f"rank_{world}_{rank}.pkl"), "wb") as f:
        pickle.dump(recs, f)
