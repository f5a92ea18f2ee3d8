"""Step-diff debugging against a reference.

Parity work lives or dies on localizing the *first* diverging step fast.
Tools here:

* :func:`first_divergence` — run two engines step by step and report the
  first step and field where they differ (bitwise or by tolerance);
* :func:`state_digest` — compact per-step fingerprint (sums of positions and
  masses, alive count, collision counter) for cheap trajectory comparison;
* :func:`run_reference_binary` — build (once) and run the C++ serial oracle
  from a reference checkout, returning its two output lines.

States are the port's (tensors on any device); ``first_divergence`` also
takes any state whose fields convert with ``numpy.asarray``.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np
import torch

FIELDS = ("x", "y", "vx", "vy", "m", "alive")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "build", "oracle")


def _numpy(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def state_digest(state) -> dict:
    return {
        "sx": float(state.x.double().sum()),
        "sy": float(state.y.double().sum()),
        "sm": float(state.m.double().sum()),
        "alive": int(state.alive.sum()),
        "collisions": int(state.collisions),
    }


def _by_pid(state):
    order = np.argsort(_numpy(state.pid))
    return {f: _numpy(getattr(state, f))[order] for f in FIELDS}


def first_divergence(eng_a, state_a, eng_b, state_b, max_steps: int,
                     atol: float = 0.0):
    """Step both engines (``run(state, 1)``); return (step, field,
    max_abs_diff) at the first difference beyond ``atol``, or None."""
    for t in range(max_steps):
        state_a = eng_a.run(state_a, 1)
        state_b = eng_b.run(state_b, 1)
        va, vb = _by_pid(state_a), _by_pid(state_b)
        for f in FIELDS:
            a, b = va[f], vb[f]
            if a.dtype == bool:
                if (a != b).any():
                    return (t, f, float((a != b).sum()))
            else:
                d = np.abs(a.astype(np.float64) - b.astype(np.float64)).max()
                if d > atol:
                    return (t, f, float(d))
        ca, cb = int(_numpy(state_a.collisions)), int(_numpy(state_b.collisions))
        if ca != cb:
            return (t, "collisions", float(ca - cb))
    return None


def run_reference_binary(reference_dir: str, args: list,
                         build_dir: str = _BUILD):
    """Compile (cached) and run the serial C++ oracle of a reference
    checkout (``<reference_dir>/serial/parsim.cpp``); returns (x, y, cols).
    The binary is built into ``build_dir``, by default the port's build
    directory."""
    os.makedirs(build_dir, exist_ok=True)
    exe = os.path.join(build_dir, "parsim")
    src = os.path.join(reference_dir, "serial", "parsim.cpp")
    if not os.path.exists(exe) or os.path.getmtime(exe) < os.path.getmtime(src):
        subprocess.run(["g++", "-O2", "-fopenmp", "-o", exe, src], check=True)
    out = subprocess.run([exe] + [str(a) for a in args],
                         capture_output=True, text=True, check=True)
    lines = out.stdout.strip().splitlines()
    xy = lines[0].split()
    return float(xy[0]), float(xy[1]), int(lines[1])
