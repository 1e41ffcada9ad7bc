"""Canonical problem definitions (the framework's workload zoo)."""
from .problems import (StepFlow2D, LidDrivenCavity, Channel2D,
                       ObstacleChannel2D, CylinderChannel2D, StepFlow3D,
                       Duct3D)

__all__ = ["StepFlow2D", "LidDrivenCavity", "Channel2D",
           "ObstacleChannel2D", "CylinderChannel2D", "StepFlow3D", "Duct3D"]
