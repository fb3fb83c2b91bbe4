"""Element-local subspace bases (port of runtime/elements.py).

Every broken point of finest element `e` interacts only with the subspace
nodes of the level-l ancestor of `e`, so each inclusion matrix R_l is a
dense (nq, nl) block per element plus an (nl,) global-node index list:

    R v   = einsum('eqa,efa->eqf', rloc, v[idx])            (gather + matmul)
    R' y  = table_sum(einsum('eqa,eqf->eaf', rloc, y))       (matmul + gather-sum)

Boundary (Dirichlet-eliminated) nodes are padded to slot `m`, whose basis
value is 0; gathers read a zero pad row and sums drop the pad slot.  The
node sum goes through the gather table `scatter_idx` (kernel C of
runtime/cuda_kernels.py on the GPU), so it needs no atomics; the table and
idx are bound once per level to a launch plan (LevelBasis.table_plan).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from . import native
from .cuda_kernels import TablePlan


@dataclasses.dataclass(frozen=True, eq=False)
class LevelBasis:
    """Element-local view of one inclusion matrix R: (nelem*nq, m).

    idx:  (nelem, nl) int32 — global subspace-node id of each local basis
          function; padded entries hold `m`.
    rloc: (nelem, nq, nl) — value of local basis function a at broken point
          q of element e.  Padded columns are 0.
    m:    number of real subspace dofs.
    scatter_idx: (m+1, width) int32 — row a lists the flat positions
          e*nl + slot with idx[e, slot] == a, padded with nelem*nl.
    pair_idx: (nelem, nl, nl) int32 — inverse-unique ids of the global node
          pairs (idx[e,a], idx[e,b]); see node_pair_table.
    """

    idx: torch.Tensor
    rloc: torch.Tensor
    m: int
    scatter_idx: torch.Tensor
    pair_idx: torch.Tensor
    _plans: dict = dataclasses.field(default_factory=dict, init=False, repr=False)

    @property
    def nelem(self) -> int:
        return self.idx.shape[0]

    @property
    def nl(self) -> int:
        return self.idx.shape[1]

    @property
    def nq(self) -> int:
        return self.rloc.shape[1]

    @property
    def n(self) -> int:
        return self.nelem * self.nq

    def pad_coeffs(self, v: torch.Tensor) -> torch.Tensor:
        """Append the zero pad row: (m, ...) -> (m+1, ...)."""
        return torch.cat([v, v.new_zeros((1,) + tuple(v.shape[1:]))], dim=0)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """R @ v for v: (m,) or (m, f) -> (n,) or (n, f)."""
        single = v.ndim == 1
        if single:
            v = v[:, None]
        ve = self.pad_coeffs(v)[self.idx]  # (nelem, nl, f)
        out = torch.einsum("eqa,eaf->eqf", self.rloc, ve).reshape(self.n, v.shape[1])
        return out[:, 0] if single else out

    @property
    def table_plan(self) -> TablePlan:
        """scatter_idx and idx bound to kernel C's launch plan, built at
        first use."""
        plan = self._plans.get("table")
        if plan is None:
            plan = self._plans["table"] = TablePlan(
                self.scatter_idx, self.m, self.nelem, self.nl, idx=self.idx)
        return plan

    def scatter_add(self, flat: torch.Tensor) -> torch.Tensor:
        """Sum per-(element, slot) contributions into nodes: (nelem*nl, f)
        -> (m+1, f) with a zeroed pad row."""
        return self.table_plan(flat.contiguous())

    def scatter_add_em(self, contrib: torch.Tensor) -> torch.Tensor:
        """The same sum from the element-major layout (nelem, f*nl), slot a
        of field f at column f*nl + a, into the field-major (f, m+1) with a
        zeroed pad column: the transpose of scatter_add on the
        (nelem*nl, f) permutation of contrib, without the copy."""
        return self.table_plan.em(contrib.contiguous())

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        """R.T @ y for y: (n,) or (n, f) -> (m,) or (m, f)."""
        single = y.ndim == 1
        if single:
            y = y[:, None]
        ye = y.reshape(self.nelem, self.nq, y.shape[1])
        contrib = torch.einsum("eqa,eqf->eaf", self.rloc, ye)
        out = self.scatter_add(contrib.reshape(self.nelem * self.nl, y.shape[1]))
        out = out[: self.m]
        return out[:, 0] if single else out


def node_pair_table(idx: np.ndarray, m: int) -> np.ndarray:
    """(nelem, nl, nl) int64 inverse-unique ids of the node pairs
    (idx[e, a], idx[e, b]): two slots share an id iff they address the same
    global (i, j) node pair."""
    idx = np.asarray(idx).astype(np.int64)
    nelem, nl = idx.shape
    keys = (idx[:, :, None] * (m + 1) + idx[:, None, :]).reshape(-1)
    _, inv = np.unique(keys, return_inverse=True)
    return inv.reshape(nelem, nl, nl)


def scatter_table(idx: np.ndarray, m: int) -> np.ndarray:
    """Node-major gather table for scatter_add: row a lists the flat
    positions e*nl + slot with idx[e, slot] == a, padded with nelem*nl
    (one past the last real row, read as zero).  Pad slots (node id m) are
    dropped, so their count does not set the table width."""
    idx = np.asarray(idx)
    nelem, nl = idx.shape
    flat = idx.reshape(-1)
    order = np.argsort(flat, kind="stable")
    sorted_ids = flat[order]
    nreal = int(np.searchsorted(sorted_ids, m))
    order = order[:nreal]
    sorted_ids = sorted_ids[:nreal]
    counts = np.bincount(sorted_ids, minlength=m + 1)
    width = int(counts[:m].max()) if m and nreal else 1
    table = np.full((m + 1, width), nelem * nl, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(nreal) - starts[sorted_ids]
    table[sorted_ids, within] = order
    return table


def level_basis_from_arrays(idx, rloc, m: int, dtype=torch.float64,
                            itype=torch.int32, device="cpu") -> LevelBasis:
    """LevelBasis from host idx/rloc arrays; builds both index tables."""
    idx = np.asarray(idx)
    as_i = lambda a: torch.as_tensor(a, device=device).to(itype)  # noqa: E731
    return LevelBasis(
        idx=as_i(idx),
        rloc=torch.as_tensor(np.asarray(rloc), device=device).to(dtype),
        m=int(m),
        scatter_idx=as_i(scatter_table(idx, int(m))),
        pair_idx=as_i(node_pair_table(idx, int(m))),
    )


def level_basis_from_csr(R, nq: int, dtype=torch.float64, itype=torch.int32,
                         device="cpu") -> LevelBasis:
    """Extract the element-local structure from a scipy CSR inclusion
    matrix whose element rows (nq consecutive rows each) reference a
    bounded set of columns."""
    R = sp.csr_matrix(R)
    n, m = R.shape
    if n % nq:
        raise ValueError(f"rows {n} not a multiple of nq={nq}")
    nelem = n // nq

    res = native.csr_to_level_basis(R.indptr, R.indices, R.data, nelem, nq, m)
    if res is not None:
        idx, rloc, _ = res
        return level_basis_from_arrays(idx, rloc, m, dtype, itype, device)

    indptr, indices, data = R.indptr, R.indices, R.data
    col_lists = []
    nl = 1
    for e in range(nelem):
        lo, hi = indptr[e * nq], indptr[(e + 1) * nq]
        cols = np.unique(indices[lo:hi])
        col_lists.append(cols)
        nl = max(nl, len(cols))
    idx = np.full((nelem, nl), m, dtype=np.int64)
    rloc = np.zeros((nelem, nq, nl), dtype=np.float64)
    for e, cols in enumerate(col_lists):
        idx[e, : len(cols)] = cols
        pos = {c: a for a, c in enumerate(cols)}
        for q in range(nq):
            r = e * nq + q
            for k in range(indptr[r], indptr[r + 1]):
                rloc[e, q, pos[indices[k]]] += data[k]
    return level_basis_from_arrays(idx, rloc, m, dtype, itype, device)
