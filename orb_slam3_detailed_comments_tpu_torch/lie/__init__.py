"""Lie groups for SLAM: SO(3) and SE(3) (the tracking path's subset)."""
from . import se3, so3
from .se3 import SE3

__all__ = ["so3", "se3", "SE3"]
