from .fem1d import fem1d
from .fem2d import fem2d
from .fem3d import fem3d
from .geometry import Discretization, Geometry

__all__ = ["fem1d", "fem2d", "fem3d", "Discretization", "Geometry"]
