"""Physical observables for validation and monitoring.

The reference exposes no diagnostics beyond its two output lines; these
observables back the cross-engine validation story: total momentum/energy
and center-of-mass drift quantify f32-vs-f64 divergence without bit-level
comparisons. They take a state of the port's tensors on any device and sum
in float64.

Periodic-domain note: the center of mass uses the circular mean (positions
live on a torus; an arithmetic mean is discontinuous at the wrap).
"""

from __future__ import annotations

import math

import torch


def _fields(state):
    return {f: getattr(state, f).to(torch.float64)
            for f in ("x", "y", "vx", "vy", "m")}


def total_momentum(state):
    a = _fields(state)
    return (float(torch.sum(a["m"] * a["vx"])),
            float(torch.sum(a["m"] * a["vy"])))


def total_mass(state):
    return float(torch.sum(_fields(state)["m"]))


def kinetic_energy(state):
    a = _fields(state)
    return float(0.5 * torch.sum(a["m"] * (a["vx"] ** 2 + a["vy"] ** 2)))


def circular_center_of_mass(state, side: float):
    """Mass-weighted circular mean of positions on the periodic domain."""
    a = _fields(state)
    m = a["m"]
    M = float(m.sum())
    if M == 0:
        return (0.0, 0.0)
    out = []
    for coord in (a["x"], a["y"]):
        theta = coord * (2 * math.pi / side)
        c = float(torch.sum(m * torch.cos(theta))) / M
        s = float(torch.sum(m * torch.sin(theta))) / M
        ang = math.atan2(s, c) % (2 * math.pi)
        out.append(ang * side / (2 * math.pi))
    return tuple(out)


def summary(state, side: float) -> dict:
    px, py = total_momentum(state)
    cx, cy = circular_center_of_mass(state, side)
    return {
        "mass": total_mass(state),
        "momentum": (px, py),
        "kinetic_energy": kinetic_energy(state),
        "com": (cx, cy),
        "alive": int(state.alive.sum()),
        "collisions": int(state.collisions),
    }
