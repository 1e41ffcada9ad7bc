"""Canonical problem definitions (the framework's workload zoo)."""
from .problems import StepFlow2D, LidDrivenCavity

__all__ = ["StepFlow2D", "LidDrivenCavity"]
