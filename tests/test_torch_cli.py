"""The port's CLI keeps the JAX CLI's contract: two stdout lines (particle
0 at three decimals, the collision count), ``%.1fs`` on stderr, parity by
default, a usage error returning 1. On the CPU here (``--device cpu``)."""

import os
import re
import subprocess
import sys

import pytest
import torch

from particlesimulation_tpu_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _main(args, capsys):
    rc = cli.main(args)
    out, err = capsys.readouterr()
    return rc, out.splitlines(), err


@pytest.mark.parametrize("engine,want", [
    ([], ["0.002 0.035", "2"]),                       # parity by default
    (["--engine", "fast"], ["0.002 0.035", "2"]),     # census: the sweep
    (["--engine", "fast", "--impl", "dense"], ["0.002 0.035", "2"]),
    (["--engine", "fast", "--impl", "banded"], ["0.002 0.035", "2"]),
])
def test_cli_contract_in_process(engine, want, capsys):
    rc, out, err = _main(["5893", "0.05", "3", "10", "10", "--device", "cpu"]
                         + engine, capsys)
    assert rc == 0 and out == want
    assert re.fullmatch(r"\d+\.\ds", err.strip())


def test_cli_fast_sparse_matches_jax_cli(capsys, monkeypatch):
    """A sparse grid through ``--engine fast``: the census takes supercell;
    the two lines equal the JAX CLI's (whose census takes supercell where
    tiles are the default, PSIM_DENSE=1 on a CPU) at three decimals."""
    from particlesimulation_tpu import cli as jcli

    args = ["5893", "0.5", "16", "200", "15", "--engine", "fast"]
    rc, out, _ = _main(args + ["--device", "cpu"], capsys)
    monkeypatch.setenv("PSIM_DENSE", "1")
    jrc = jcli.main(args)
    jout = capsys.readouterr().out.splitlines()
    assert rc == jrc == 0 and out == jout
    assert len(out) == 2 and int(out[1]) > 0


def test_cli_subprocess():
    r = subprocess.run(
        [sys.executable, "-m", "particlesimulation_tpu_torch", "1", "2", "3",
         "10", "1", "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines() == ["1.570 0.056", "0"]
    assert re.fullmatch(r"\d+\.\ds", r.stderr.strip())


@pytest.mark.parametrize("args", [
    ["1", "2", "3"],
    ["1", "2", "3", "10", "1", "extra"],
    ["1", "2", "3", "10", "x"],
    ["1", "2", "3", "10", "1", "--engine", "double"],
])
def test_cli_usage_error(args, capsys):
    rc, out, err = _main(args, capsys)
    assert rc == 1 and out == [] and "Usage" in err


@pytest.mark.parametrize("args", [
    ["--engine", "parity", "--mesh", "2x4"],
    ["--engine", "fast", "--mesh", "2x4"],
    ["--engine", "fast", "--mesh", "3", "--impl", "banded-cyclic"]],
    ids=["2x4-parity", "2x4-fast", "3-banded-cyclic"])
def test_cli_mesh_matches_jax_cli(args, capsys):
    """``--mesh RxC`` (the 2D mesh) and ``--impl banded-cyclic`` on a small
    config with collisions and migration: the JAX CLI's two lines, run
    in-process on the bootstrap's virtual devices."""
    from particlesimulation_tpu import cli as jcli

    base = ["5893", "0.05", "8", "64", "12"]
    rc, out, err = _main(base + args + ["--device", "cpu"], capsys)
    assert re.fullmatch(r"\d+\.\ds", err.strip())
    jrc = jcli.main(base + args)
    jout = capsys.readouterr().out.splitlines()
    assert rc == jrc == 0 and out == jout == ["0.001 0.035", "24"]


@pytest.mark.parametrize("args", [
    ["--mesh", "2x4"],                          # 4 columns of shards > 3
    ["--mesh", "2x2", "--engine", "fast", "--impl", "banded"]])
def test_cli_mesh_refuses_bad_arguments(args, capsys):
    rc, out, err = _main(["5893", "0.05", "3", "10", "10", "--device", "cpu",
                          *args], capsys)
    assert rc == 1 and out == [] and "Usage" in err


@pytest.mark.parametrize("impl,args,runs", [
    ("supercell", (5893, 0.5, 16, 200), "supercell"),
    # A load this small has no band plan: JAX's decline to resident tiles.
    ("banded", (-10, 3.0, 16, 600), "resident"),
    ("banded-cols", (-10, 3.0, 16, 600), "resident")])
def test_cli_mesh_impls(impl, args, runs, capsys):
    """``--mesh 4 --impl supercell|banded|banded-cols`` runs the mesh engine
    of that impl and prints its result."""
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine

    rc, out, _ = _main([str(a) for a in args] + [
        "10", "--device", "cpu", "--engine", "fast", "--mesh", "4",
        "--impl", impl], capsys)
    eng = ShardedEngine(SimConfig(*args, n_shards=4), impl=impl,
                        device="cpu")
    x, y, c = eng.result(eng.run(eng.init_state(), 10))
    assert eng.impl == runs
    assert rc == 0 and out == [f"{x:.3f} {y:.3f}", str(c)]


@pytest.mark.parametrize("engine", ["parity", "fast"])
def test_cli_mesh_golden_n1(engine, capsys):
    """``--mesh 3`` on golden N1 (3 rows on 3 shards): the golden lines, in
    parity (the sweep) and in fast precision (resident tiles), as the JAX
    CLI's tests/test_cli.py:32-48 print them."""
    rc, out, err = _main(["5893", "0.05", "3", "10", "10", "--device", "cpu",
                          "--engine", engine, "--mesh", "3"], capsys)
    assert rc == 0 and out == ["0.002 0.035", "2"]
    assert re.fullmatch(r"\d+\.\ds", err.strip())


def test_cli_runs_on_cuda_unless_asked_for_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["1", "2", "3", "10", "1"])
