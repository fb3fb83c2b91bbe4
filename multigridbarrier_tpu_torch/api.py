"""Convenience entry points (port of api.py).

Like the reference, fem2d_solve splats the same kwargs into the geometry
builder and amgb; amgb tolerates unknown keys.
"""

from __future__ import annotations

from typing import Optional

from .backend import Backend, backend_cpu
from .fem import fem2d
from .solver import amgb


def fem2d_solve(L: int = 2, K=None, backend: Optional[Backend] = None, **kwargs):
    """2D solve (reference fem2d_mpi_solve).  The default backend is the
    CPU; pass backend_cuda() to solve on the GPU."""
    g = fem2d(L=L, K=K, backend=backend or backend_cpu())
    return amgb(g, **kwargs)
