"""ctypes loader for the native initial-condition generator.

The C++ source ``initgen.cpp`` beside this file is a byte-for-byte copy of
the JAX package's (a test holds the two identical), so the port depends on
no file of the JAX package. The library builds on first use with
``g++ -O2``, matching the reference Makefile's optimization level (reference
serial/Makefile:1-10), into the port's build directory under a name keyed on
the source's content. Without a compiler the callers fall back to the NumPy
streams in :mod:`..rng`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "initgen.cpp")
BUILD_DIR = os.path.join(_PKG, "build")

_lock = threading.Lock()
_lib = None
_build_failed = False


def _build() -> str | None:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libpsim_init_{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Per-pid temp name: concurrent processes may race to build; each
    # compiles privately and the atomic rename makes last-writer-wins safe.
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return None
    os.replace(tmp, so)
    return so


def get_lib():
    """Load (building if needed) the native library, or None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _build()
        if path is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(path)
        dp = ctypes.POINTER(ctypes.c_double)
        lib.psim_init_particles.argtypes = [
            ctypes.c_int32, ctypes.c_double, ctypes.c_long, ctypes.c_longlong,
            dp, dp, dp, dp, dp,
        ]
        lib.psim_init_particles.restype = None
        _lib = lib
        return _lib


def init_particles(seed: int, side: float, ncside: int, n: int):
    """Native initial conditions; returns (x, y, vx, vy, m) f64 or None."""
    lib = get_lib()
    if lib is None:
        return None
    arrs = [np.empty(n, dtype=np.float64) for _ in range(5)]
    ptrs = [a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)) for a in arrs]
    lib.psim_init_particles(seed, float(side), ncside, n, *ptrs)
    return tuple(arrs)
