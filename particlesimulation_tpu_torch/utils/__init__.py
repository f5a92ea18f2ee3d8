"""Comparison instruments: physical observables and step-diff debugging."""
