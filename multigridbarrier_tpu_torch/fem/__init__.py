from .fem2d import fem2d
from .geometry import Discretization, Geometry

__all__ = ["fem2d", "Discretization", "Geometry"]
