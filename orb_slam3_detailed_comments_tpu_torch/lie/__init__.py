"""Lie groups for SLAM: SO(3), SE(3), Sim(3)."""
from . import se3, sim3, so3
from .se3 import SE3
from .sim3 import Sim3

__all__ = ["so3", "se3", "sim3", "SE3", "Sim3"]
