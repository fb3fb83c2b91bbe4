"""Runtime layer: element-local operators, sparse containers, host helpers
and the hand-written CUDA kernels."""

from .blockdiag import BlockDiagOp
from .ell import Ell, ell_from_coo, ell_from_scipy
from .elements import (
    LevelBasis,
    level_basis_from_arrays,
    level_basis_from_csr,
    node_pair_table,
    scatter_table,
)

__all__ = [
    "BlockDiagOp",
    "Ell",
    "ell_from_coo",
    "ell_from_scipy",
    "LevelBasis",
    "level_basis_from_arrays",
    "level_basis_from_csr",
    "node_pair_table",
    "scatter_table",
]
