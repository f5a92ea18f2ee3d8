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


@pytest.mark.parametrize("mesh", ["2", "2x4"])
def test_cli_refuses_a_mesh(mesh, capsys):
    rc, out, err = _main(["5893", "0.05", "3", "10", "10", "--device", "cpu",
                          "--mesh", mesh], capsys)
    assert rc != 0 and out == [] and "sharded engines are not ported" in err
    assert _main(["5893", "0.05", "3", "10", "10", "--device", "cpu",
                  "--mesh", "1"], capsys)[0] == 0


def test_cli_runs_on_cuda_unless_asked_for_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["1", "2", "3", "10", "1"])
