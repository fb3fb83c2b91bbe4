"""multigridbarrier_tpu_torch — the PyTorch + CUDA port of multigridbarrier_tpu.

The multigrid interior-point (barrier) solver for convex variational
problems, on PyTorch tensors, with the JAX package's Pallas kernels
replaced by kernels written by hand for NVIDIA Hopper (sm_90a):
element-Hessian assembly, the element-local matvec, the gather-table and
segment sums, and the row gather (runtime/cuda_kernels.py, csrc/).  The
JAX package multigridbarrier_tpu stays the reference; module names match
it.

Ported so far: the fem1d, fem2d and fem3d geometries; amgb with its
feasibility phase (an infeasible start), aux= data columns, a dense direct
Newton solve on coarse levels and the nested-dissection multifrontal
Cholesky on fine levels above dense_threshold; the implicit time stepper
parabolic_solve; fem1d_solve, fem2d_solve and fem3d_solve.  Not ported yet:
the linear_solver= hook and the host sparse solver, the multigrid-
preconditioned CG, mixed precision, I/O and plotting, multi-device runs.
The entry points run on the GPU unless they are given backend_cpu().  This
package never imports jax.
"""

from .backend import Backend, backend_cpu, backend_cuda
from .fem import Geometry, fem1d, fem2d, fem3d
from .solver import (
    AMGBConvergenceFailure,
    AMGBSOL,
    Convex,
    ParabolicSOL,
    amgb,
    convex_Euclidian_power,
    convex_intersect,
    convex_linear,
    parabolic_solve,
)
from .api import fem1d_solve, fem2d_solve, fem3d_solve

__all__ = [
    "Backend",
    "backend_cpu",
    "backend_cuda",
    "fem1d",
    "fem2d",
    "fem3d",
    "Geometry",
    "amgb",
    "parabolic_solve",
    "fem1d_solve",
    "fem2d_solve",
    "fem3d_solve",
    "AMGBSOL",
    "ParabolicSOL",
    "AMGBConvergenceFailure",
    "Convex",
    "convex_Euclidian_power",
    "convex_intersect",
    "convex_linear",
]

__version__ = "0.1.0"
