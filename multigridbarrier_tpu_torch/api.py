"""Convenience entry points (port of api.py).

Like the reference, fem2d_solve splats the same kwargs into the geometry
builder and amgb; amgb tolerates unknown keys.
"""

from __future__ import annotations

from typing import Optional

from .backend import Backend, backend_cuda
from .fem import fem2d
from .solver import amgb


def fem2d_solve(L: int = 2, K=None, backend: Optional[Backend] = None, **kwargs):
    """2D solve (reference fem2d_mpi_solve).  The default backend is
    backend_cuda(), which raises when there is no GPU; pass backend_cpu()
    to solve on the CPU."""
    g = fem2d(L=L, K=K, backend=backend or backend_cuda())
    return amgb(g, **kwargs)
