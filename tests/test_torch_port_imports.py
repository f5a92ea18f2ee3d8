"""The port imports neither jax nor the JAX package, and names no path in it.

An AST scan of every module of ``particlesimulation_tpu_torch`` (and of
``chip_smoke.py``, which drives the port on the GPU machine, where JAX is
not installed). A ``sys.modules`` check would not do here: the test process
imports jax itself.
"""

import ast
import os
import re

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


# A string that names a path inside the JAX package, as a whole path or as
# a path component ("particlesimulation_tpu/native/x.cpp", or the pieces of
# os.path.join(root, "particlesimulation_tpu", ...)). A "file.py:line" or
# "file.py:first-last" reference, as chip_smoke.py's "replaces" labels are,
# opens no file.
_JAX_PATH = re.compile(r"(^|/)particlesimulation_tpu(/|$)")
_LINE_REF = re.compile(r"\.py:\d+(-\d+)?$")


def _jax_paths(source):
    tree = ast.parse(source)
    docstrings = {id(node.body[0].value) for node in ast.walk(tree)
                  if isinstance(node, (ast.Module, ast.ClassDef,
                                       ast.FunctionDef, ast.AsyncFunctionDef))
                  and node.body and isinstance(node.body[0], ast.Expr)
                  and isinstance(node.body[0].value, ast.Constant)}
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docstrings and _JAX_PATH.search(node.value)
            and not _LINE_REF.search(node.value)]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_path_into_jax_package(path):
    with open(path) as f:
        bad = _jax_paths(f.read())
    assert not bad, f"{os.path.relpath(path, ROOT)} names {bad}"


def test_path_scan_catches_a_jax_path():
    assert _jax_paths('os.path.join(root, "particlesimulation_tpu", "a.cpp")')
    assert _jax_paths('SRC = "particlesimulation_tpu/native/initgen.cpp"')
    assert not _jax_paths('REF = "particlesimulation_tpu/ops/x.py:248"')
    assert not _jax_paths('REF = "particlesimulation_tpu/models/x.py:36-80"')
    assert _jax_paths('SRC = "particlesimulation_tpu/models/x.py"')
    assert not _jax_paths('SRC = "particlesimulation_tpu_torch/csrc/a.cu"')


def test_initgen_source_is_the_jax_packages():
    """The port builds its own copy of the initializer source; it must stay
    byte-identical to the JAX package's (the initial conditions are held
    bit-exact against it)."""
    copies = []
    for pkg in ("particlesimulation_tpu", "particlesimulation_tpu_torch"):
        with open(os.path.join(ROOT, pkg, "native", "initgen.cpp"), "rb") as f:
            copies.append(f.read())
    assert copies[0] == copies[1]
