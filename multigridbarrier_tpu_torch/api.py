"""Convenience entry points (port of api.py).

Like the reference, each *_solve splats the same kwargs into the geometry
function and amgb; amgb tolerates unknown keys.  The default backend of
every entry point is backend_cuda(), which raises when there is no GPU;
pass backend_cpu() to solve on the CPU.
"""

from __future__ import annotations

from typing import Optional

from .backend import Backend, backend_cuda
from .fem import fem1d, fem2d, fem3d
from .solver import amgb


def fem1d_solve(L: int = 4, backend: Optional[Backend] = None, **kwargs):
    """1D solve (reference fem1d_mpi_solve)."""
    g = fem1d(L=L, backend=backend or backend_cuda())
    return amgb(g, **kwargs)


def fem2d_solve(L: int = 2, K=None, backend: Optional[Backend] = None, **kwargs):
    """2D solve (reference fem2d_mpi_solve)."""
    g = fem2d(L=L, K=K, backend=backend or backend_cuda())
    return amgb(g, **kwargs)


def fem3d_solve(
    L: int = 2, k: int = 3, K=None, backend: Optional[Backend] = None, **kwargs
):
    """3D solve with the reference's 3D defaults
    (D = [u:id, u:dx, u:dy, u:dz, s:id])."""
    g = fem3d(L=L, k=k, K=K, backend=backend or backend_cuda())
    return amgb(g, **kwargs)
