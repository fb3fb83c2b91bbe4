from .amgb import AMGBConvergenceFailure, AMGBSOL, PhaseLog, amgb
from .convex import Convex, convex_Euclidian_power, convex_intersect, convex_linear
from .parabolic import ParabolicSOL, parabolic_solve

__all__ = [
    "amgb",
    "AMGBSOL",
    "AMGBConvergenceFailure",
    "PhaseLog",
    "Convex",
    "convex_Euclidian_power",
    "convex_intersect",
    "convex_linear",
    "ParabolicSOL",
    "parabolic_solve",
]
