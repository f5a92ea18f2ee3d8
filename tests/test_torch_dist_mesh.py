"""The ``torch.distributed`` mesh (``parallel/mesh.DistMesh``: one shard per
rank) under the 1D row mesh, on the CPU over gloo, against the port's
``LocalMesh`` (every shard in one process) and the JAX package's
``ShardedEngine`` on the bootstrap's 8 virtual CPU devices.

The ranks (``tests/dist_mesh_worker.py``, which imports the port only) are
spawned once a module, D = 2 and D = 4 at once; each group runs every case
of its size and hands back its records. Held here:

* the collectives (``ppermute`` along each axis, ``psum``, ``pmax``,
  ``all_gather``) against ``LocalMesh``'s on the same stacked inputs, bit
  for bit;
* parity (the f64 sweep) bit for bit against ``LocalMesh`` and JAX's mesh
  (on 5893 0.05 8 64, against the NumPy oracle, as in
  ``test_torch_sharded.test_parity_mesh_bitwise``); resident tiles bit for
  bit against ``LocalMesh`` and within the f32 tolerance of JAX's
  (``test_torch_sharded._assert_close``), the counts exact; graphed (the
  CPU twin) = eager on every rank;
* every rank on the same route, plan and capacities, the same gathered
  state, the same rung of a forced retry;
* gather and result with shards that hold no particle;
* the CLI under torchrun, and what it refuses; ``run`` on a mesh that
  cannot capture.

The other routes on a DistMesh are ``test_torch_dist_routes.py``'s.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from particlesimulation_tpu_torch import cli
from particlesimulation_tpu_torch.config import SimConfig
from particlesimulation_tpu_torch.initializer import init_particles_host
from particlesimulation_tpu_torch.parallel.mesh import DistMesh, LocalMesh
from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine
from tests import dist_mesh_worker as worker
from tests.oracle_np import NpOracle
from tests.test_torch_sharded import FIELDS, _assert_close, _jax_mesh

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LOCAL = {}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{D: [rank 0's records, rank 1's, ...]} for D = 2 and 4."""
    return worker.launch((2, 4), str(tmp_path_factory.mktemp("dist_mesh")))


def _local(key, fn):
    """A LocalMesh record, once per key."""
    if key not in _LOCAL:
        _LOCAL[key] = fn()
    return _LOCAL[key]


def _same(got, want, label):
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{label} {f}")


def _each_rank(recs, key, want, label):
    """Every rank's record ``key``: the same gathered state as ``want``'s
    (a record of ``worker.record``), the same count, result and route."""
    for r, rec in enumerate(recs):
        got = rec[key]
        _same(got["gather"], want["gather"], f"{label}, rank {r}")
        assert got["collisions"] == want["collisions"]
        assert got["result"] == want["result"]
        assert got["route"] == want["route"], f"{label}, rank {r}"
        assert got["overflow"] == 0


def _run_id(run):
    return "_".join(map(str, run))


def _bits_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("world,case", [(w, c) for w in (2, 4)
                                        for c in worker.PERMUTES[w]],
                         ids=lambda v: str(v).replace(" ", ""))
def test_ppermute_matches_local_mesh(ranks, world, case):
    """Each rank's ``ppermute`` of its row (a dict holding a tuple; f64,
    int32 and bool leaves) is the row of that rank in ``LocalMesh``'s
    ``ppermute`` of the stacked rows."""
    shape, axis, shift = case
    x = worker.stacked(world, 7)
    want = LocalMesh(world, "cpu", shape).ppermute(
        {"f": x["f"], "t": (x["i"], x["b"])}, shift, axis)
    for r, rec in enumerate(ranks[world]):
        got = rec["collectives"][case]
        assert _bits_equal(got["f"], want["f"][r:r + 1])
        for g, w in zip(got["t"], want["t"]):
            assert _bits_equal(g, w[r:r + 1]), (r, case)


@pytest.mark.parametrize("world", [2, 4])
def test_reductions_match_local_mesh(ranks, world):
    """``psum`` (int32, int64), ``pmax`` and ``all_gather`` on every rank
    equal ``LocalMesh``'s on the stacked rows."""
    x = worker.stacked(world, 7)
    mesh = LocalMesh(world, "cpu")
    for rec in ranks[world]:
        got = rec["collectives"]
        assert _bits_equal(got["psum"][0], mesh.psum(x["i"]))
        assert _bits_equal(got["psum"][1], mesh.psum(x["l"]))
        assert _bits_equal(got["pmax"], mesh.pmax(x["i"]))
        for k, v in x.items():
            assert _bits_equal(got["all_gather"][k], mesh.all_gather(v))


@pytest.mark.parametrize("run", [r for r in worker.RUNS
                                 if r[0] == worker.PARITY], ids=_run_id)
def test_parity_bitwise(ranks, run):
    """Parity on the DistMesh: every rank's gathered state bit for bit
    ``LocalMesh``'s and JAX's mesh run's (5893 0.05 8 64: the oracle's, as
    in test_torch_sharded), graphed = eager."""
    _, seed, side, nc, n, steps, d = run
    want = _local(run, lambda: worker.run_case(run, None))
    _each_rank(ranks[d], run, want, f"parity D={d}")
    for rec in ranks[d]:
        _same(rec[run]["eager"], want["gather"], "eager")
    got = want["gather"]
    if (seed, side, nc, n) == (5893, 0.05, 8, 64):
        oracle = NpOracle(side, nc, *init_particles_host(
            SimConfig(seed, side, nc, n)))
        for _ in range(steps):
            oracle.step()
        for f in FIELDS[1:]:
            np.testing.assert_array_equal(got[f], getattr(oracle, f),
                                          err_msg=f)
        assert want["collisions"] == oracle.collisions
        return
    ref, ref_count = _jax_mesh(run[1:], "parity")
    _same(got, ref, "JAX")
    assert want["collisions"] == ref_count


@pytest.mark.parametrize("run", [r for r in worker.RUNS
                                 if r[0] == worker.RESIDENT], ids=_run_id)
def test_resident_bitwise_local_close_to_jax(ranks, run):
    """Resident tiles on the DistMesh: bit for bit ``LocalMesh``'s, graphed
    = eager; JAX's sharded resident run to the f32 tolerance, the count
    exact."""
    d = run[-1]
    want = _local(run, lambda: worker.run_case(run, None))
    assert want["route"]["impl"] == "resident"
    _each_rank(ranks[d], run, want, f"resident D={d}")
    for rec in ranks[d]:
        _same(rec[run]["eager"], want["gather"], "eager")
    ref, ref_count = _jax_mesh(run[1:], "fast")
    assert want["collisions"] == ref_count
    _assert_close(want["gather"], ref, run[2])


def test_every_rank_same_route_plan_capacity(ranks):
    """Every rank of every run and retry reached the same impl, kcap, slab
    and buffer capacities, ship rounds and row plan as ``LocalMesh`` (host
    computations on the same seed; no broadcast)."""
    for run in worker.RUNS:
        want = _local(run, lambda: worker.run_case(run, None))["route"]
        for rec in ranks[run[-1]]:
            assert rec[run]["route"] == want, run
    for case in worker.RETRIES:
        want = _local(case, lambda: worker.retry_case(case, None))
        for rec in ranks[4]:
            assert rec[case[0]]["start"] == want["start"], case
            assert rec[case[0]]["route"] == want["route"], case
    assert any(ranks[4][0][run]["route"]["row_starts"]
               for run in worker.RUNS if run[-1] == 4)


@pytest.mark.parametrize("case", worker.RETRIES, ids=lambda c: c[0])
def test_forced_retry_same_rung(ranks, case):
    """A first attempt that overflows for certain (a slab 3 slots short; a
    1-entry emigrant buffer): the ladder's readback is mesh-wide, so every
    rank grows the same capacity and ends on LocalMesh's bits."""
    name, run = case
    want = _local(case, lambda: worker.retry_case(case, None))
    grown = "capacity" if name == "slab" else "bcap"
    assert want["route"][grown] > want["start"][grown]
    _each_rank(ranks[4], name, want, f"retry {name}")


def test_empty_shards_gather_and_result(ranks):
    """Every particle in shard 0's rows: shards 1-3 hold none, and gather
    and result (the smallest pid over the mesh) work on every rank, before
    and after a run, as on LocalMesh."""
    want = _local("empty", lambda: worker.empty_case(None))
    for rec in ranks[4]:
        got = rec["empty"]
        assert got["held"] == want["held"] == [worker.EMPTY[3], 0, 0, 0]
        _same(got["packed"], want["packed"], "packed")
        assert got["packed_result"] == want["packed_result"]
    _each_rank(ranks[4], "empty", want, "empty shards")


@pytest.mark.parametrize("world", [2, 4])
def test_simulation_takes_a_mesh(ranks, world):
    """``Simulation(..., mesh=)`` runs the mesh engine on it: LocalMesh's
    result and particles."""
    want = _local(("sim", world), lambda: worker.simulation_case(None, world))
    for rec in ranks[world]:
        got = rec["simulation"]
        _same(got["gather"], want["gather"], "Simulation")
        assert got["particle0"] == want["particle0"]
        assert got["collisions"] == want["collisions"]


def test_run_refuses_a_mesh_that_cannot_capture(ranks):
    """A mesh whose collectives cannot be captured: ``run`` raises a
    ValueError naming ``run_eager``, and ``run_eager`` gives the same bits
    as before."""
    for rec in ranks[4]:
        ref = rec["refusals"]
        assert ref["run, not capturable"][0] == "ValueError"
        assert "run_eager" in ref["run, not capturable"][1]
        _same(ref["eager, not capturable"], ref["eager"], "run_eager")


def test_a_dist_mesh_needs_a_process_group():
    """No process group in this process: DistMesh raises; a mesh of another
    size than n_shards raises."""
    with pytest.raises(RuntimeError, match="process group"):
        DistMesh("cpu")
    with pytest.raises(ValueError, match="n_shards"):
        ShardedEngine(SimConfig(1, 2.0, 8, 200, n_shards=4), device="cpu",
                      mesh=LocalMesh(2, "cpu"))


@pytest.mark.parametrize("engine", ["parity", "fast"])
def test_cli_under_torchrun(engine, capsys):
    """``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
    particlesimulation_tpu_torch ... --mesh 2 --device cpu``: rank 0 prints
    the JAX CLI's two lines once, rc 0 on every rank."""
    from particlesimulation_tpu import cli as jcli

    args = ["5893", "0.05", "8", "64", "12", "--mesh", "2", "--engine",
            engine]
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "particlesimulation_tpu_torch",
         *args, "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stderr
    assert jcli.main(args) == 0
    want = capsys.readouterr().out.splitlines()
    assert r.stdout.splitlines() == want and len(want) == 2
    assert len(re.findall(r"^\d+\.\ds$", r.stderr, re.M)) == 1


@pytest.mark.parametrize("env,args,says", [
    ("2", ["--mesh", "4", "--device", "cpu"], "give --mesh 2"),
    ("2", ["--mesh", "2x2", "--device", "cpu"],
     "give --mesh 2 (or RxC with R·C = 2)"),
    ("2", ["--mesh", "2"], "2 ranks need 2 CUDA devices")],
    ids=["world-not-D", "world-not-RxC", "cuda-fewer-cards"])
def test_cli_refusals_under_torchrun(env, args, says, capsys, monkeypatch):
    """Under torchrun (WORLD_SIZE set): a mesh of another shard count than
    the world size (D or RxC), or --device cuda with fewer cards than
    ranks print a message and return 1, before any process group is
    made."""
    monkeypatch.setenv("WORLD_SIZE", env)
    if "CUDA" in says:
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = cli.main(["1", "2.0", "8", "200", "10", *args])
    out, err = capsys.readouterr()
    assert rc == 1 and out == "" and says in err
    assert not torch.distributed.is_initialized()
