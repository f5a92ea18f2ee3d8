"""Explicit integrator with periodic wrap.

Replicates ``Particle::applyForce`` (reference serial/parsim.cpp:150-195):
``a = F/m``; ``x += v*dt + 0.5*a*dt*dt`` (with the reference's left-to-right
association); ``v += a*dt``; wrap ``x = fmod(x + side, side)``. Dead or empty
slots (``m == 0``) are frozen in place (serial/parsim.cpp:151-155).
"""

from __future__ import annotations

import torch


def integrate(x, y, vx, vy, m, fx, fy, side: float, deltat: float):
    """One explicit step. Returns (x, y, vx, vy)."""
    def const(v):
        return torch.full((), v, dtype=x.dtype, device=x.device)

    dtt, half, side_a = const(deltat), const(0.5), const(side)
    frozen = m == 0
    safe_m = torch.where(frozen, const(1.0), m)
    ax = fx / safe_m
    ay = fy / safe_m
    # x += vx*dt + 0.5*ax*dt*dt  — association ((vx*dt) + (((0.5*ax)*dt)*dt))
    nx = x + (vx * dtt + ((half * ax) * dtt) * dtt)
    ny = y + (vy * dtt + ((half * ay) * dtt) * dtt)
    nvx = vx + ax * dtt
    nvy = vy + ay * dtt
    nx = torch.fmod(nx + side_a, side_a)
    ny = torch.fmod(ny + side_a, side_a)
    return (torch.where(frozen, x, nx), torch.where(frozen, y, ny),
            torch.where(frozen, vx, nvx), torch.where(frozen, vy, nvy))
