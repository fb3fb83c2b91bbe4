"""Padded-ELL sparse matrices (port of runtime/ell.py).

Sparsity is padded once per geometry to a fixed row width K.  In the port
Ell only carries the subspaces, embeddings and level transfers for
construction and interop; the Newton solve runs on the element-local
LevelBasis, and the mgcg transfers that apply Ell are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import native


@dataclasses.dataclass(frozen=True, eq=False)
class Ell:
    """Fixed-width sparse matrix: row i holds entries vals[i, k] at columns
    cols[i, k].  Padding entries have vals == 0 and cols == 0."""

    cols: torch.Tensor  # (nrows, K) int
    vals: torch.Tensor  # (nrows, K) float
    shape: tuple  # (nrows, ncols)

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    @property
    def width(self) -> int:
        return self.cols.shape[1]


def ell_from_coo(rows, cols, vals, shape, width=None, dtype=torch.float64,
                 itype=torch.int32, device="cpu") -> Ell:
    """Build an Ell from host COO triplets (duplicates are summed)."""
    import scipy.sparse as sp

    A = sp.csr_matrix((vals, (rows, cols)), shape=shape)
    return ell_from_scipy(A, width=width, dtype=dtype, itype=itype, device=device)


def ell_from_scipy(A, width=None, dtype=torch.float64, itype=torch.int32,
                   device="cpu") -> Ell:
    """Pad a scipy sparse matrix to fixed row width."""
    A = A.tocsr()
    A.sum_duplicates()
    nrows, ncols = A.shape
    counts = np.diff(A.indptr)
    K = int(counts.max()) if counts.size and counts.max() > 0 else 1
    if width is not None:
        if width < K:
            raise ValueError(f"width {width} < max row nnz {K}")
        K = width
    res = native.csr_to_ell(A.indptr, A.indices, A.data, nrows, K)
    if res is not None:
        cols, vals = res
    else:
        cols = np.zeros((nrows, K), dtype=np.int32)
        vals = np.zeros((nrows, K), dtype=np.float64)
        if A.nnz:
            rowids = np.repeat(np.arange(nrows), counts)
            offsets = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
            cols[rowids, offsets] = A.indices
            vals[rowids, offsets] = A.data
    return Ell(
        cols=torch.as_tensor(cols, device=device).to(itype),
        vals=torch.as_tensor(vals, device=device).to(dtype),
        shape=(nrows, ncols),
    )
