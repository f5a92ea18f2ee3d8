"""The port imports neither jax nor the JAX package.

An AST scan of every module of ``particlesimulation_tpu_torch`` (and of
``chip_smoke.py``, which drives the port on the GPU machine, where JAX is
not installed). A ``sys.modules`` check would not do here: the test process
imports jax itself.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "particlesimulation_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "particlesimulation_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_scan_sees_the_package():
    assert len(_sources()) >= 15
