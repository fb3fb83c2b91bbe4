"""HostPattern — the static sparsity pattern of one level's Newton matrix
(port of the HostPattern half of solver/hostsolve.py; host numpy).

Both Newton routes of the port read the deduplicated value array `vals`
that this pattern defines: the dense route places each entry once into the
N x N matrix (linsolve.dense_assemble), the nested-dissection route
assembles its fronts from it (ndsolve.NDFactorizer).  The host SuperLU
solver of the JAX module (HostDirectLevel) is not ported.
"""

from __future__ import annotations

import numpy as np


class HostPattern:
    """Static sparsity pattern of one level's global Newton matrix
    H[f1*(m+1)+i, f2*(m+1)+j], plus the segment tables that reduce element
    Hessians to its value array.

    full_ids: (nelem, C, C) int32, C = nf*nl — segment ids such that
        summing He.reshape(-1) by full_ids.reshape(-1) into nseg segments
        yields the deduplicated value array `vals`, layout
        ((f1*nf+f2)*nuniq + pid), one slot per structurally nonzero
        (field-pair, node-pair); built from the same inverse-unique pair
        construction as runtime.elements.node_pair_table.
    seg_src, seg_off: the same sum in CSR-offset form (kernel C's
        segment_sum): the flat He positions sorted stably by segment, so
        each segment sums in element order, and one offset per segment.
    dense_pos: (nseg,) flat position row*N + col of each vals slot in the
        dense N x N matrix, N = nf*(m+1); no two slots share one.
    Pad dofs (node id m per field) have zero He entries by construction;
    the dense route gives them an identity diagonal after placing vals
    (linsolve.dense_assemble), and the nested-dissection route never reads
    them (NDSymbolic keeps only real node pairs).
    """

    def __init__(self, idx: np.ndarray, m: int, nf: int):
        idx = np.asarray(idx)
        nelem, nl = idx.shape
        self.m, self.nf = int(m), int(nf)
        keys = (
            idx[:, :, None].astype(np.int64) * (m + 1) + idx[:, None, :]
        ).reshape(-1)
        uniq, inv = np.unique(keys, return_inverse=True)
        nuniq = len(uniq)
        self.nuniq = nuniq
        self.nseg = nf * nf * nuniq
        fid = (
            np.arange(nf, dtype=np.int64)[:, None] * nf
            + np.arange(nf, dtype=np.int64)[None, :]
        ) * nuniq
        full = (
            fid[None, :, None, :, None]
            + inv.reshape(nelem, nl, nl)[:, None, :, None, :].astype(np.int64)
        )
        C = nf * nl
        # (nelem, nf, nl, nf, nl) -> (nelem, C, C) with c = f*nl + a: the
        # axes are already in slot-major order, a straight reshape
        self.full_ids = full.reshape(nelem, C, C).astype(np.int32)

        flat = self.full_ids.reshape(-1)
        self.seg_src = np.argsort(flat, kind="stable").astype(np.int32)
        self.seg_off = np.concatenate(
            [[0], np.cumsum(np.bincount(flat, minlength=self.nseg))]
        ).astype(np.int32)

        # global position of every segment slot
        g = np.arange(self.nseg, dtype=np.int64)
        f1 = g // (nf * nuniq)
        f2 = (g // nuniq) % nf
        pid = g % nuniq
        i = uniq[pid] // (m + 1)
        j = uniq[pid] % (m + 1)
        N = nf * (m + 1)
        self.N = N
        self.dense_pos = (f1 * (m + 1) + i) * N + f2 * (m + 1) + j

