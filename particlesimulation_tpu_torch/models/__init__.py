"""Simulation models — user-facing facades over the engines."""

from particlesimulation_tpu_torch.models.gravity_pic import RunResult, Simulation

__all__ = ["RunResult", "Simulation"]
