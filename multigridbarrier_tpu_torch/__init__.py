"""multigridbarrier_tpu_torch — the PyTorch + CUDA port of multigridbarrier_tpu.

The multigrid interior-point (barrier) solver for convex variational
problems, on PyTorch tensors, with the JAX package's Pallas kernels
replaced by kernels written by hand for NVIDIA Hopper (sm_90a):
element-Hessian assembly, the element-local matvec and the gather-table
node sum (runtime/cuda_kernels.py, csrc/).  The JAX package
multigridbarrier_tpu stays the reference; module names match it.

Ported so far: fem2d geometry, and amgb's phase 2 with a dense direct
Newton solve on every level (fem2d_solve(L<=5, p=1.0) by default, any L
with backend_cuda(dense_threshold=1<<30)).  This package never imports jax.
"""

from .backend import Backend, backend_cpu, backend_cuda
from .fem import Geometry, fem2d
from .solver import AMGBConvergenceFailure, AMGBSOL, amgb
from .api import fem2d_solve

__all__ = [
    "Backend",
    "backend_cpu",
    "backend_cuda",
    "fem2d",
    "Geometry",
    "amgb",
    "fem2d_solve",
    "AMGBSOL",
    "AMGBConvergenceFailure",
]

__version__ = "0.1.0"
