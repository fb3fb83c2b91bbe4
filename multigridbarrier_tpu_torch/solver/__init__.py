from .amgb import AMGBConvergenceFailure, AMGBSOL, PhaseLog, amgb
from .convex import Convex, convex_Euclidian_power, convex_intersect, convex_linear

__all__ = [
    "amgb",
    "AMGBSOL",
    "AMGBConvergenceFailure",
    "PhaseLog",
    "Convex",
    "convex_Euclidian_power",
    "convex_intersect",
    "convex_linear",
]
