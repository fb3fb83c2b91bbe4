"""Per-element block-diagonal operators (port of runtime/blockdiag.py).

Every differential operator of the broken quadrature-point space is
block-diagonal over elements, so applying it is a batched (nq x nq)
matmul over elements.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class BlockDiagOp:
    """Operator on broken-space vectors of length n = nelem * nq.

    blocks: (nelem, nq, nq); row-block e maps the nq values of element e.
    is_identity short-circuits the :id operator to a no-op.
    """

    blocks: torch.Tensor  # (nelem, nq, nq)
    is_identity: bool
    n: int  # = nelem * nq

    @property
    def nelem(self) -> int:
        return self.blocks.shape[0]

    @property
    def nq(self) -> int:
        return self.blocks.shape[1]

    @staticmethod
    def identity(nelem: int, nq: int, dtype, device) -> "BlockDiagOp":
        eye = torch.eye(nq, dtype=dtype, device=device).expand(nelem, nq, nq)
        return BlockDiagOp(blocks=eye, is_identity=True, n=nelem * nq)

    @staticmethod
    def from_blocks(blocks: torch.Tensor) -> "BlockDiagOp":
        nelem, nq, _ = blocks.shape
        return BlockDiagOp(blocks=blocks, is_identity=False, n=nelem * nq)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """Apply to (n,) or (n, f) tensors."""
        if self.is_identity:
            return v
        if v.ndim == 1:
            ve = v.reshape(self.nelem, self.nq)
            return torch.einsum("eij,ej->ei", self.blocks, ve).reshape(self.n)
        ve = v.reshape(self.nelem, self.nq, v.shape[1])
        return torch.einsum("eij,ejm->eim", self.blocks, ve).reshape(
            self.n, v.shape[1]
        )

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        """Apply the transpose."""
        if self.is_identity:
            return y
        if y.ndim == 1:
            ye = y.reshape(self.nelem, self.nq)
            return torch.einsum("eji,ej->ei", self.blocks, ye).reshape(self.n)
        ye = y.reshape(self.nelem, self.nq, y.shape[1])
        return torch.einsum("eji,ejm->eim", self.blocks, ye).reshape(
            self.n, y.shape[1]
        )
