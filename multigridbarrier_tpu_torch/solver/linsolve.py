"""Dense Newton linear solver (port of the dense part of solver/linsolve.py).

The Newton system of one level

    H = R' (D' diag(w .* F2) D) R      (SPD on the barrier interior)

is held as per-element Hessian blocks He (nelem, nf*nl, nf*nl).  They are
reduced to the deduplicated value array of hostsolve.HostPattern by a
segment sum without atomics (kernel C's segment_sum), each value is placed
once into a global dense matrix, which is factored with Cholesky and
refined with matrix-free residuals H v (the fused hvp kernel of
runtime/cuda_kernels.py on the GPU: gather, element matvec and node sum in
one launch, equal to kernel B then kernel C bit for bit).  So the assembled
matrix is the same bit for bit from one run to the next.

Vectors use the field-major layout (nf, m+1): m real coefficients plus one
zero pad slot per field.  The multigrid-preconditioned CG solver of the
JAX package is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..runtime.cuda_kernels import SegmentPlan, TablePlan
from .hostsolve import HostPattern


class ValsTable(NamedTuple):
    """A HostPattern's segment tables on the device.

    plan: the He -> vals segment sum bound to its tables (kernel C's
        SegmentPlan): plan.lst (nelem*C*C,) int32 flat He positions sorted
        stably by vals slot, plan.off (nseg+1,) int32 offsets, one per slot
    dense_pos: (nseg,) int64 flat position of each slot in the N x N matrix
    """

    plan: SegmentPlan
    dense_pos: torch.Tensor


def vals_table(idx: torch.Tensor, m: int, nf: int) -> ValsTable:
    """Build the HostPattern of a level on the host and move its tables to
    idx's device."""
    pat = HostPattern(idx.cpu().numpy(), m, nf)
    dev = idx.device
    return ValsTable(
        SegmentPlan(
            torch.as_tensor(pat.seg_src, device=dev),
            torch.as_tensor(pat.seg_off, device=dev),
            pat.full_ids.size,
        ),
        torch.as_tensor(pat.dense_pos, device=dev),
    )


def he_to_vals(He: torch.Tensor, table: ValsTable) -> torch.Tensor:
    """Element Hessians -> deduplicated values (HostPattern layout
    ((f1*nf+f2)*nuniq + pid)), each slot summed in element order
    (also the long runs: the pad-node slots' thousands of zeros, and on
    coarse levels real slots fed by hundreds of elements)."""
    return table.plan(He.reshape(-1))


class LevelSystem(NamedTuple):
    """One level's assembled element Hessians.

    He:  (nelem, nf*nl, nf*nl) per-element Hessian blocks
    idx: (nelem, nl) int32 global node ids (pad slot = m)
    m:   subspace size
    scatter_idx: (m+1, width) int32 node-major gather table
    table: the level's ValsTable (built from idx when None)
    plan: scatter_idx and idx bound to kernel C's TablePlan (the level's
        LevelBasis.table_plan; built from them when None)
    """

    He: torch.Tensor
    idx: torch.Tensor
    m: int
    scatter_idx: torch.Tensor
    table: Optional[ValsTable] = None
    plan: Optional[TablePlan] = None


def _table_plan(sys_: LevelSystem) -> TablePlan:
    if sys_.plan is not None:
        return sys_.plan
    nelem, nl = sys_.idx.shape
    return TablePlan(sys_.scatter_idx, sys_.m, nelem, nl, idx=sys_.idx)


def hvp(sys_: LevelSystem, vp: torch.Tensor) -> torch.Tensor:
    """H @ v, matrix-free, in one fused launch: gather, per-element matvec
    and gather-table node sum.  vp: (nf, m+1) -> (nf, m+1) with a zero pad
    slot."""
    return _table_plan(sys_).hvp(sys_.He, vp.contiguous())


def diag_of(sys_: LevelSystem) -> torch.Tensor:
    """diag(H) as (nf, m+1); pad slot set to 1 (harmless inverse)."""
    d = torch.diagonal(sys_.He, dim1=1, dim2=2)  # (nelem, nf*nl), element-major
    out = _table_plan(sys_).em(d.contiguous())
    out[:, sys_.m] = 1.0
    return out


def dense_assemble(sys_: LevelSystem, nf: int) -> torch.Tensor:
    """The global dense matrix of size N = nf*(m+1): element Hessians
    reduced to deduplicated values, each placed once (no atomics), with
    identity on pad rows (their He entries are zero by construction, so
    this keeps the matrix SPD)."""
    m = sys_.m
    table = sys_.table if sys_.table is not None else vals_table(sys_.idx, m, nf)
    N = nf * (m + 1)
    H = sys_.He.new_zeros(N * N)
    H[table.dense_pos] = he_to_vals(sys_.He, table)
    H = H.reshape(N, N)
    pad = torch.arange(nf, device=H.device) * (m + 1) + m
    H[pad, pad] += 1.0
    return H


def dense_solve(sys_: LevelSystem, nf: int, bp: torch.Tensor, shifts=None):
    """Direct solve via dense Cholesky.

    Barrier Hessians reach cond ~ 1e17 near path convergence.  An unshifted
    backward-stable factorization still yields good Newton directions there,
    whereas a regularizing diagonal shift destroys the near-null components
    that carry the remaining Newton decrement.  So: factor unshifted first
    and escalate through `shifts` only while the solution is non-finite
    (a failed factorization, info > 0, counts as non-finite), then two rounds
    of iterative refinement with matrix-free residuals.

    bp: (nf, m+1) -> (nf, m+1).  Returns a NaN direction if every attempt
    fails, which the Newton loop reads as divergence."""
    if shifts is None:
        # dtype-relative ladder: a shift below eps(dtype) does nothing
        eps = torch.finfo(bp.dtype).eps
        shifts = (0.0, 500 * eps, 50000 * eps)
    m = sys_.m
    H0 = dense_assemble(sys_, nf)
    b = bp.reshape(-1, 1)

    def zero_pad(x):
        x = x.reshape(nf, m + 1).clone()
        x[:, m] = 0.0
        return x

    def attempt(shift):
        H = H0
        if shift:
            H = H0.clone()
            H.diagonal().mul_(1.0 + shift)
        L, info = torch.linalg.cholesky_ex(H)
        if int(info) != 0:
            return None
        x = torch.cholesky_solve(b, L)
        # two rounds of iterative refinement with matrix-free residuals
        # (fresh He contraction, independent of the factorization error)
        for _ in range(2):
            r = b - hvp(sys_, zero_pad(x)).reshape(-1, 1)
            x = x + torch.cholesky_solve(r, L)
        return x if bool(torch.isfinite(x).all()) else None

    for s in shifts:
        x = attempt(s)
        if x is not None:
            return zero_pad(x)
    return zero_pad(torch.full_like(b, float("nan")))
