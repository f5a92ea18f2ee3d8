"""Every route of both mesh engines on the ``torch.distributed`` mesh
(``parallel/mesh.DistMesh``: one shard per rank), on the CPU over gloo,
against the port's ``LocalMesh`` of the same shape and the JAX package's
mesh engines on the bootstrap's 8 virtual CPU devices.

The ranks (``tests/dist_routes_worker.py``, which imports the port only)
are spawned once a module, D = 2 and D = 4 at once, while this process runs
every case on its ``LocalMesh``; each group runs every case of its size and
hands back its records. Held here:

* super-cells (the census's and ``impl="supercell"``), column bands,
  block-cyclic bands, the census's streaming route, the 2D mesh at (2, 1),
  (1, 2) and (2, 2) in parity and on rectangle tiles, and the 2D census's
  delegation to super-cells and to bands: every rank's gathered state bit
  for bit ``LocalMesh``'s, graphed (the CPU twin) = eager, the counts, the
  route, plan and capacities the same;
* one config a route against JAX's mesh engine (those files' cached runs):
  parity bit for bit, fast within ``test_torch_sharded._assert_close``'s
  tolerance, counts and dead sets exact;
* a forced retry a route (tiles, band plans, buffers, the escalation to
  the sweep with its re-pack): every rank on ``LocalMesh``'s rung;
* checkpoints saved on a DistMesh equal to ``LocalMesh``'s files array for
  array, restored bit for bit on both meshes and across D = 4 -> 2;
* ``Simulation`` on a 2D DistMesh; the CLI under torchrun at ``--mesh
  2x2`` and on a census-routed sparse load at ``--mesh 2``.

Every group has a deadline (its process group's timeout, and the join's):
a rank that hangs fails the module's tests, not the suite.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from particlesimulation_tpu.config import Precision as JPrecision
from particlesimulation_tpu.config import SimConfig as JSimConfig
from particlesimulation_tpu.parallel.sharded2d import (
    Sharded2DEngine as JSharded2DEngine)
from particlesimulation_tpu_torch.config import Precision, SimConfig
from particlesimulation_tpu_torch.engine import Engine
from particlesimulation_tpu_torch.utils import checkpointing
from tests import dist_mesh_worker
from tests import dist_routes_worker as worker
from tests import (test_torch_sharded2d, test_torch_sharded_banded,
                   test_torch_sharded_banded_cyclic,
                   test_torch_sharded_supercell)
from tests.test_torch_sharded import FIELDS, _assert_close, _single

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
JAX_CASES = ["supercell D=2 (jax)", "column bands D=4 (jax)",
             "cyclic D=4 (jax)", "2D parity (2, 2) (jax)",
             "2D resident (2, 2) (jax)",
             "2D delegates to super-cells (2, 2)"]
# Each case's route: (impl, banded variant or None, delegated).
ROUTE_OF = {
    "supercell": ("supercell", "cols", False),
    "column bands": ("banded", "cols", False),
    "cyclic": ("banded", "cyclic", False),
    "streaming": ("banded", "cols", False),
    "2D parity": ("sweep", None, False),
    "2D resident": ("resident", None, False),
    "2D delegates to super-cells": ("supercell", "cols", True),
    "2D delegates to bands": ("banded", "cols", True),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(LocalMesh's records, {D: [rank 0's records, ...]}, the JAX
    references): the ranks and the LocalMesh records run in processes of
    their own while this one runs JAX's."""
    tmp = str(tmp_path_factory.mktemp("dist_routes"))
    local = worker.local_checkpoints(tmp)
    groups = dist_mesh_worker.start(WORLDS, tmp, worker.rank_main)
    groups.append(worker.start_local(tmp))
    try:
        refs = {name: _jax_ref(name) for name in JAX_CASES}
    finally:
        ranks = dist_mesh_worker.collect(groups, WORLDS, tmp, 240.0)
    local.update(worker.load_local(tmp))
    return local, ranks, refs


def _same(got, want, label):
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{label} {f}")


def _each_rank(runs, key, world):
    """Every rank's record ``key``: LocalMesh's gathered state bit for bit,
    its count, result and route; no overflow left. Returns LocalMesh's."""
    local, ranks, _ = runs
    want = local[key]
    assert want["overflow"] == 0
    for r, rec in enumerate(ranks[world]):
        got = rec[key]
        label = f"{key}, rank {r} of {world}"
        _same(got["gather"], want["gather"], label)
        assert got["collisions"] == want["collisions"], label
        assert got["result"] == want["result"], label
        assert got["route"] == want["route"], label
        assert got["overflow"] == 0, label
        if "eager" in want:
            _same(got["eager"], want["gather"], f"{label}, eager")
            assert got["start"] == want["start"], label
    return want


def _route_kind(name):
    return next(k for k in sorted(ROUTE_OF, key=len, reverse=True)
                if name.startswith(k))


@pytest.mark.parametrize("name", list(worker.RUNS))
def test_route_bitwise_local_mesh(runs, name):
    """The route on the DistMesh: every rank's gathered state, count,
    result, route, plan and capacities are ``LocalMesh``'s, graphed (the
    CPU twin) and eager; no pid lost."""
    spec = worker.RUNS[name]
    want = _each_rank(runs, name, worker.world_of(spec))
    impl, variant, delegated = ROUTE_OF[_route_kind(name)]
    route = want["route"]
    assert (route["impl"], route["delegated"]) == (impl, delegated)
    if impl == "banded":
        assert route["variant"] == variant
    _same(want["eager"], want["gather"], "LocalMesh eager")
    np.testing.assert_array_equal(want["gather"]["pid"],
                                  np.arange(spec["args"][3]))


def _close_or_one_device(got, ref, one_device, side):
    """JAX's banded mesh runs to the f32 tolerance, or to the distance
    between the two packages' one-device runs where that is larger
    (test_torch_sharded_banded's rule)."""
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    for f, scale in (("x", side), ("y", side),
                     ("vx", float(np.abs(ref["vx"]).max()) * 10)):
        tol = max(1e-6 * scale, float(np.abs(one_device[f] - ref[f]).max()))
        np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=tol,
                                   err_msg=f)


def _jax_ref(name):
    """JAX's mesh run of a JAX_CASES config (the route's test file's cached
    run where it has one): (gathered, count, what else the check reads)."""
    spec = worker.RUNS[name]
    args, steps, shape = spec["args"], spec["steps"], spec["shape"]
    d = worker.world_of(spec)
    if name.startswith("supercell"):
        ref, count, S, kcap = test_torch_sharded_supercell._jax(args, steps,
                                                                d)
        return ref, count, (S, kcap)
    if name.startswith(("column", "cyclic")):
        plan = spec["plan"]
        if name.startswith("column"):
            ref, count = test_torch_sharded_banded._jax(args, steps, d, plan)
        else:
            *_, ref, count = test_torch_sharded_banded_cyclic._jax(
                args, steps, d, plan)
        return ref, count, _one_device_banded(
            args, steps, plan,
            "resident" if name.startswith("column") else "banded")
    if name.startswith("2D delegates"):
        jeng = JSharded2DEngine(JSimConfig(*args, precision=JPrecision.FAST,
                                           n_shards=d, mesh_shape=shape),
                                shape)
        out = jeng.run(jeng.init_state(), steps)
        assert jeng.impl == "supercell" and jeng._delegate is not None
        return (jeng.gather(out), int(np.asarray(out.collisions)),
                jeng._delegate._sc_factor)
    ref, count = test_torch_sharded2d._jax(
        (*args, steps, shape),
        Precision.PARITY if spec.get("parity") else Precision.FAST)
    return ref, count, None


@pytest.mark.parametrize("name", JAX_CASES)
def test_route_matches_jax(runs, name):
    """One config a route against JAX's mesh engine: parity bit for bit,
    fast within ``_assert_close``'s tolerance (the banded files' rule for
    the bands), counts and dead sets exact; rank 0's record (every rank's
    is LocalMesh's)."""
    spec = worker.RUNS[name]
    got = runs[1][worker.world_of(spec)][0][name]
    ref, count, extra = runs[2][name]
    side = spec["args"][1]
    if name.startswith("supercell"):
        assert (got["route"]["sc_factor"], got["route"]["kcap"]) == extra
        _assert_close(got["gather"], ref, side)
    elif name.startswith(("column", "cyclic")):
        _close_or_one_device(got["gather"], ref, extra, side)
    elif name.startswith("2D delegates"):
        assert got["route"]["sc_factor"] == extra
        _assert_close(got["gather"], ref, side)
    elif spec.get("parity"):
        _same(got["gather"], ref, "JAX 2D parity")
    else:
        _assert_close(got["gather"], ref, side)
    assert got["collisions"] == count


def _one_device_banded(args, steps, plan, impl):
    """The port's one-device run the banded files hold JAX's against: the
    resident tiles for column bands, the banded engine on the plan for
    block-cyclic ones."""
    eng = Engine(SimConfig(*args), impl=impl, device="cpu")
    state = eng.init_state()
    if impl == "banded":
        eng._band_plan = plan
    return _single(eng.run(state, steps))


@pytest.mark.parametrize("name", list(worker.RETRIES))
def test_forced_retry_same_rung(runs, name):
    """A first attempt that overflows for certain: every rank reads the
    mesh's overflow, takes LocalMesh's rung (larger tiles, grown bands,
    larger buffers, the sweep with its re-pack) and ends on its bits."""
    spec = worker.RETRIES[name]
    want = _each_rank(runs, name, worker.world_of(spec))
    start, end = want["start"], want["route"]
    if name == "supercell to the sweep":
        assert (start["impl"], end["impl"]) == ("supercell", "sweep")
    elif "buffers" in name:
        assert end["bcap"] > start["bcap"]
    elif start["band_plan"]:
        assert all(k > 8 for _, _, k in end["band_plan"])
    else:
        assert end["kcap"] > start["kcap"] == 4
    _same(want["eager"], want["gather"], "LocalMesh eager")


def _load(path):
    with np.load(path) as z:
        return {f: z[f] for f in z.files}


@pytest.mark.parametrize("name", list(worker.CKPTS))
def test_checkpoint_file_equals_local_mesh(runs, name):
    """Every rank saved (rank 0 wrote): the file equals LocalMesh's, array
    for array (the slabs in shard order, the geometry and ownership); each
    rank restored its own slab as saved and ran on to LocalMesh's bits."""
    local, ranks, _ = runs
    spec = worker.CKPTS[name]
    key = ("ckpt", name)
    want = _each_rank(runs, key, worker.world_of(spec))
    got_file = _load(ranks[worker.world_of(spec)][0][key]["path"])
    want_file = _load(want["path"])
    assert sorted(got_file) == sorted(want_file)
    for f, a in want_file.items():
        assert got_file[f].dtype == a.dtype, f
        np.testing.assert_array_equal(got_file[f], a, err_msg=f)
    for rec in ranks[worker.world_of(spec)]:
        assert rec[key]["as_saved"] and rec[key]["path"] != want["path"]
        _same(rec[key]["mid"], want["mid"], "saved state")
    assert want["as_saved"]


@pytest.mark.parametrize("name", list(worker.CKPTS))
def test_dist_checkpoint_restores_on_a_local_mesh(runs, name):
    """The DistMesh's file restored onto a LocalMesh engine of the same
    shape: placed as saved, bit for bit the LocalMesh's own file's state,
    and the resumed run LocalMesh's."""
    local, ranks, _ = runs
    spec = worker.CKPTS[name]
    key = ("ckpt", name)
    dist_path = ranks[worker.world_of(spec)][0][key]["path"]
    eng = worker.build(spec, False)
    eng.init_state()
    from_dist = checkpointing.restore_sharded(dist_path, eng)
    from_local = checkpointing.restore_sharded(local[key]["path"], eng)
    for f in from_local._fields:
        a, b = getattr(from_dist, f), getattr(from_local, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    out = eng.run(from_dist, spec["steps"])
    _same(eng.gather(out), local[key]["gather"], "resumed on LocalMesh")
    assert int(out.collisions) == local[key]["collisions"]


def test_checkpoint_restores_across_widths(runs):
    """LocalMesh's D = 4 super-cell checkpoint (the DistMesh's is the same
    file) restored onto D = 2 ranks: re-packed (every rank packing its own
    shard's particles), and run on to LocalMesh D = 2's bits."""
    name, shape = worker.ACROSS
    want = _each_rank(runs, "across", shape[0] * shape[1])
    assert want["route"]["impl"] == "supercell"
    np.testing.assert_array_equal(
        want["gather"]["pid"], np.arange(worker.CKPTS[name]["args"][3]))


def test_simulation_takes_a_2d_mesh(runs):
    """``Simulation(..., mesh_shape=(2, 2), mesh=DistMesh)`` runs the 2D
    engine on it: LocalMesh's particles, particle 0 and count."""
    local, ranks, _ = runs
    want = local["simulation"]
    assert want["engine"] == "Sharded2DEngine"
    for rec in ranks[4]:
        got = rec["simulation"]
        assert got["engine"] == "Sharded2DEngine"
        _same(got["gather"], want["gather"], "Simulation")
        assert got["particle0"] == want["particle0"]
        assert got["collisions"] == want["collisions"]


@pytest.mark.parametrize("nproc,args", [
    (4, ["1", "2.0", "8", "200", "10", "--mesh", "2x2"]),
    (2, ["5893", "0.5", "16", "200", "15", "--mesh", "2", "--engine",
         "fast"])], ids=["2x2-parity", "sparse-D2-census"])
def test_cli_under_torchrun(nproc, args, capsys):
    """``python -m torch.distributed.run --standalone --nproc-per-node N -m
    particlesimulation_tpu_torch ... --device cpu``: the 2D mesh at
    ``--mesh 2x2`` on 4 gloo ranks, and a sparse load the census routes to
    super-cells at ``--mesh 2``: rank 0 prints the JAX CLI's two lines
    once, rc 0 on every rank."""
    from particlesimulation_tpu import cli as jcli

    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", "particlesimulation_tpu_torch",
         *args, "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr
    assert jcli.main(args) == 0
    want = capsys.readouterr().out.splitlines()
    assert r.stdout.splitlines() == want and len(want) == 2
    assert len(re.findall(r"^\d+\.\ds$", r.stderr, re.M)) == 1


@pytest.mark.parametrize("args", [(1, 2.0, 9, 200), (1, 3.0, 24, 300)],
                         ids=["rectangles", "delegated"])
def test_2d_run_refuses_a_mesh_that_cannot_capture(args):
    """A 2D mesh whose collectives cannot be captured (as a gloo mesh on a
    CUDA device): ``run`` raises a ValueError naming ``run_eager``, on
    rectangle tiles and where the census delegated (the delegate's flat
    mesh aside), and ``run_eager`` runs."""
    spec = worker._spec(args, 2, (2, 2), mesh2d=True)
    eng = worker.build(spec, False)
    state = eng.init_state()
    eng.mesh.capturable = False
    with pytest.raises(ValueError, match="run_eager"):
        eng.run(state, 2)
    assert int(eng.run_eager(state, 2).overflow) == 0
