"""Comparison instruments (physical observables, step-diff debugging),
checkpoints and profiling."""
