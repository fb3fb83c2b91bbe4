"""Geometry — the multigrid FEM hierarchy container (port of
fem/geometry.py).

- ``x``: (n, dim) quadrature-node coordinates
- ``w``: (n,) quadrature weights
- ``operators``: differential operators on the broken space ('id', 'dx',
  'dy', 'dz'), each an n x n block-diagonal operator
- ``subspaces``: name -> per-level inclusion matrices R_l (n x m_l)
- ``refine``/``coarsen``: level transfers between broken spaces
- ``embed``: per-subspace inter-level embeddings E_l with R_{l+1} E_l = R_l
- ``bases``: element-local views of ``subspaces``, the solver's form
- ``discretization``: static metadata
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..backend import Backend
from ..runtime import BlockDiagOp, Ell, LevelBasis


@dataclasses.dataclass(frozen=True)
class Discretization:
    """Static mesh metadata. `payload` holds builder-specific host arrays."""

    name: str  # 'fem1d' | 'fem2d' | 'fem3d'
    dim: int
    L: int
    nelem: int
    nq: int  # quadrature/broken points per element
    payload: dict = dataclasses.field(default_factory=dict, repr=False)


@dataclasses.dataclass(frozen=True, eq=False)
class Geometry:
    discretization: Discretization
    x: torch.Tensor  # (n, dim)
    w: torch.Tensor  # (n,)
    operators: Dict[str, BlockDiagOp]
    subspaces: Dict[str, Tuple[Ell, ...]]
    refine: Tuple[Ell, ...]
    coarsen: Tuple[Ell, ...]
    embed: Dict[str, Tuple[Ell, ...]]
    backend: Backend
    bases: Dict[str, Tuple[LevelBasis, ...]]
    # solver contexts built for this geometry (amgb._get_ctx)
    ctx_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[1]

    @property
    def levels(self) -> int:
        return len(self.subspaces["dirichlet"])

    def subspace_dims(self, key: str = "dirichlet") -> Tuple[int, ...]:
        return tuple(R.ncols for R in self.subspaces[key])
