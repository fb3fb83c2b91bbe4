"""Dense and multigrid-preconditioned CG Newton linear solvers (port of
solver/linsolve.py).

The Newton system of one level

    H = R' (D' diag(w .* F2) D) R      (SPD on the barrier interior)

is held as per-element Hessian blocks He (nelem, nf*nl, nf*nl) and solved
in one of two ways:

* dense: the element Hessians are reduced to the deduplicated value array
  of hostsolve.HostPattern by a segment sum without atomics (kernel C's
  segment_sum), each value is placed once into a global dense matrix,
  which is factored with Cholesky and refined with matrix-free residuals
  H v (the fused hvp kernel of runtime/cuda_kernels.py on the GPU: gather,
  element matvec and node sum in one launch, equal to kernel B then kernel
  C bit for bit).  So the assembled matrix is the same bit for bit from
  one run to the next.
* mgcg: matrix-free preconditioned CG where H v is the fused hvp,
  preconditioned by a geometric multigrid V-cycle over the same
  element-local hierarchy.  Every level's inclusion matrix targets the same
  broken space (R_l = R_{l+1} E_l), so the rediscretized coarse Hessian
  equals the Galerkin operator E' H E exactly.  The cycle smooths with
  Chebyshev over an element-block additive Schwarz preconditioner (batched
  small Cholesky factors of principal submatrices), in float32 on a
  Jacobi-prescaled system, and solves its coarsest level exactly (a dense
  Cholesky, or the nested-dissection factor of ndsolve.py above a size
  cap).  Its sums are kernel C's (node sums, the Schwarz pair sums) and
  its gathers kernel D's row_gather, so two solves repeat bit for bit; the
  level transfers are Ell row gathers (kernel D) and a contraction, E' y
  through the transposed Ell, with no index_add_.

The CG loop is a host loop: it reads its exit test once per iteration (one
host sync), and the breakdown and floor-bail exits decide which iterate is
returned, as in the JAX package's while_loop.

On a mesh (LevelSystem.mesh) a system holds this rank's block of the
element Hessians: every element sum (the hvp's node sum, the diagonal, the
assembled values, the Schwarz pair sums and applies) is the rank's local
kernel launch followed by runtime.dist.ordered_sum, and node vectors are
replicated, so dot products, Cholesky factors and the CG recurrences run
on every rank on the same bits with no collective of their own.

Vectors use the field-major layout (nf, m+1): m real coefficients plus one
zero pad slot per field.  Mixed dtypes follow the JAX package's promotion:
an operator and a vector of two float dtypes meet in the wider one (the
scaled float32 cycle meets float64 level transfers, so its coarse
correction and post-smoothing run in float64, as JAX computes them).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..runtime import cuda_kernels, dist, telemetry
from ..runtime.cuda_kernels import GatherPlan, SegmentPlan, TablePlan
from ..runtime.ell import Ell, ell_from_scipy
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


def vals_table(idx: torch.Tensor, m: int, nf: int, pattern: Optional[HostPattern] = None,
               rows: Optional[tuple] = None) -> ValsTable:
    """Move the tables of a level's HostPattern (built on the host from idx
    unless given) to idx's device.  rows=(lo, hi): the segment sum of the
    elements lo..hi-1 alone (a rank's block), into the whole pattern's
    slots: its He positions count from element lo, and each slot sums its
    entries of the block in element order."""
    pat = pattern if pattern is not None else HostPattern(idx.cpu().numpy(), m, nf)
    dev = idx.device
    src, off, nsrc = pat.seg_src, pat.seg_off, pat.full_ids.size
    if rows is not None:
        cc = pat.full_ids.shape[1] * pat.full_ids.shape[2]
        lo, hi = rows[0] * cc, rows[1] * cc
        keep = (src >= lo) & (src < hi)
        seg = np.repeat(np.arange(len(off) - 1), np.diff(off))
        off = np.concatenate([[0], np.cumsum(np.bincount(seg[keep], minlength=len(off) - 1))])
        src, nsrc = (src[keep] - lo).astype(np.int32), hi - lo
        off = off.astype(np.int32)
    return ValsTable(
        SegmentPlan(torch.as_tensor(src, device=dev), torch.as_tensor(off, device=dev), nsrc),
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
    table: the level's ValsTable (built from idx at first use when None)
    plan: scatter_idx and idx bound to kernel C's TablePlan (the level's
        LevelBasis.table_plan; built from them when None)
    pair_idx: (nelem, nl, nl) int32 node-pair ids (elements.node_pair_table);
        enables the principal-submatrix Schwarz smoother
    cache: the level's static launch plans (gathers, pair sums, valence
        weights), built at first use; a caller that builds a LevelSystem
        per Newton step passes the same dict each time
    He_up: He cast to a wider float dtype, for vectors of that dtype (the
        scaled cycle's float64 post-smoothing); cast per call when None
    mesh: the mesh whose ranks hold the other elements (He, idx and
        pair_idx are then this rank's block), or None
    npair: the whole level's node-pair count (pair_idx ids lie below it);
        read off pair_idx when None
    """

    He: torch.Tensor
    idx: torch.Tensor
    m: int
    scatter_idx: torch.Tensor
    table: Optional[ValsTable] = None
    plan: Optional[TablePlan] = None
    pair_idx: Optional[torch.Tensor] = None
    cache: Optional[dict] = None
    He_up: Optional[torch.Tensor] = None
    mesh: object = None
    npair: Optional[int] = None


def _table_plan(sys_: LevelSystem) -> TablePlan:
    if sys_.plan is not None:
        return sys_.plan
    nelem, nl = sys_.idx.shape
    return _cached(sys_, "table_plan",
                   lambda: TablePlan(sys_.scatter_idx, sys_.m, nelem, nl, idx=sys_.idx))


def _cached(sys_: LevelSystem, key, build):
    """sys_.cache[key], built by build() at first use (every call when the
    system carries no cache)."""
    if sys_.cache is None:
        return build()
    if key not in sys_.cache:
        sys_.cache[key] = build()
    return sys_.cache[key]


def _wide(t: torch.Tensor, up: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """t in `dtype` (t itself, its cached cast `up`, or a fresh cast)."""
    if t.dtype == dtype:
        return t
    if up is not None and up.dtype == dtype:
        return up
    return t.to(dtype)


def hvp(sys_: LevelSystem, vp: torch.Tensor) -> torch.Tensor:
    """H @ v, matrix-free, in one fused launch: gather, per-element matvec
    and gather-table node sum.  vp: (nf, m+1) -> (nf, m+1) with a zero pad
    slot, in the wider of the two dtypes."""
    dt = torch.promote_types(sys_.He.dtype, vp.dtype)
    out = _table_plan(sys_).hvp(_wide(sys_.He, sys_.He_up, dt), vp.to(dt).contiguous())
    return dist.ordered_sum(out, sys_.mesh)


def _elem_gather(sys_: LevelSystem, nf: int) -> GatherPlan:
    """Kernel D's gather of a field-major (nf, m+1) vector into the
    element-major layout (nelem, nf*nl): column f*nl + a of element e reads
    v[f, idx[e, a]]."""

    def build():
        idx = sys_.idx.long()
        m1 = sys_.m + 1
        gid = (torch.arange(nf, device=idx.device)[None, :, None] * m1 + idx[:, None, :])
        return GatherPlan(gid.reshape(idx.shape[0], -1).to(torch.int32).contiguous(), nf * m1)

    return _cached(sys_, ("elem_gather", nf), build)


def gather_elements(sys_: LevelSystem, v: torch.Tensor) -> torch.Tensor:
    """v (nf, m+1) -> (nelem, nf*nl) element-major (v[:, idx] laid out per
    element, field by field)."""
    return _elem_gather(sys_, v.shape[0])(v.contiguous().reshape(-1))


def hvp_lane(He_lane: torch.Tensor, sys_: LevelSystem, vp: torch.Tensor) -> torch.Tensor:
    """H @ v with He stored lane-major (C, C, nelem), the JAX package's
    float64 TPU layout; a plain contraction then kernel C's node sum.  The
    solver's operator is the fused hvp, which computes the same product."""
    ve = gather_elements(sys_, vp).T  # (C, nelem)
    hve = torch.einsum("abe,be->ae", He_lane, ve)
    return dist.ordered_sum(_table_plan(sys_).em(hve.T.contiguous()), sys_.mesh)


def diag_of(sys_: LevelSystem) -> torch.Tensor:
    """diag(H) as (nf, m+1); pad slot set to 1 (harmless inverse)."""
    d = torch.diagonal(sys_.He, dim1=1, dim2=2)  # (nelem, nf*nl), element-major
    out = dist.ordered_sum(_table_plan(sys_).em(d.contiguous()), sys_.mesh)
    out[:, sys_.m] = 1.0
    return out


def dense_assemble(sys_: LevelSystem, nf: int) -> torch.Tensor:
    """The global dense matrix of size N = nf*(m+1): element Hessians
    reduced to deduplicated values, each placed once (no atomics), with
    identity on pad rows (their He entries are zero by construction, so
    this keeps the matrix SPD).  On a mesh the system must carry its
    table (the whole level's pattern, vals_table(rows=...))."""
    m = sys_.m
    if sys_.table is None and sys_.mesh is not None:
        raise ValueError("dense_assemble: a sharded system needs its ValsTable")
    table = sys_.table if sys_.table is not None else _cached(
        sys_, ("vals_table", nf), lambda: vals_table(sys_.idx, m, nf))
    N = nf * (m + 1)
    H = sys_.He.new_zeros(N * N)
    H[table.dense_pos] = dist.ordered_sum(he_to_vals(sys_.He, table), sys_.mesh)
    H = H.reshape(N, N)
    pad = torch.arange(nf, device=H.device) * (m + 1) + m
    H[pad, pad] += 1.0
    return H


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of symmetric (batched) A, NaN where A is not
    positive definite (jnp.linalg.cholesky's contract), with no host sync;
    the input is symmetrized as jnp.linalg.cholesky does."""
    L, info = torch.linalg.cholesky_ex((A + A.mT) / 2)
    bad = info > 0
    return L.masked_fill(bad[..., None, None] if bad.ndim else bad, float("nan"))


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
        if telemetry.read(info, "dense.info") != 0:
            return None
        x = torch.cholesky_solve(b, L)
        # two rounds of iterative refinement with matrix-free residuals
        # (fresh He contraction, independent of the factorization error)
        for _ in range(2):
            r = b - hvp(sys_, zero_pad(x)).reshape(-1, 1)
            x = x + torch.cholesky_solve(r, L)
        return x if telemetry.read(torch.isfinite(x).all(), "dense.finite") else None

    for i, s in enumerate(shifts):
        if i:
            telemetry.count("dense_shift_retries")
        x = attempt(s)
        if x is not None:
            return zero_pad(x)
    return zero_pad(torch.full_like(b, float("nan")))


# ----------------------------------------------------------------------------
# Level transfers
# ----------------------------------------------------------------------------


class Transfer:
    """An embedding E (m_f x m_c, an Ell) applied without atomics: E x and
    E' y are each one row gather (kernel D, through a GatherPlan) and a
    contraction over the row width, E' y through the transposed Ell built
    once on the host.  Node-major operands (m, nf), as the V-cycle uses
    Ell.matvec / rmatvec; an operand and the values of two float dtypes
    meet in the wider one (JAX's einsum promotion)."""

    def __init__(self, E: Ell, ET: Optional[Ell] = None, plans=None):
        dev = E.vals.device
        if ET is None:
            ET = ell_from_scipy(E.to_scipy().T, dtype=E.vals.dtype, itype=torch.int32,
                                device=dev)
        self.E, self.ET, self.shape = E, ET, E.shape
        self._plans = plans or (
            GatherPlan(E.cols.to(torch.int32).contiguous(), E.ncols),
            GatherPlan(ET.cols.to(torch.int32).contiguous(), ET.ncols),
        )

    @staticmethod
    def _apply(A: Ell, plan: GatherPlan, v: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(A.vals.dtype, v.dtype)
        vg = plan(v.contiguous()).to(dt)
        if v.ndim == 1:
            return torch.einsum("rk,rk->r", A.vals.to(dt), vg)
        return torch.einsum("rk,rkf->rf", A.vals.to(dt), vg)

    def matvec(self, xc: torch.Tensor) -> torch.Tensor:  # (m_c, nf) -> (m_f, nf)
        return self._apply(self.E, self._plans[0], xc)

    def rmatvec(self, rf: torch.Tensor) -> torch.Tensor:  # (m_f, nf) -> (m_c, nf)
        return self._apply(self.ET, self._plans[1], rf)

    def astype(self, dtype) -> "Transfer":
        """The same transfer with its values in `dtype` (its plans shared)."""
        return Transfer(self.E.astype(dtype), self.ET.astype(dtype), self._plans)


def as_transfer(E) -> Transfer:
    """E as a Transfer (built from an Ell; a Transfer is returned as is)."""
    return E if isinstance(E, Transfer) else Transfer(E)


# ----------------------------------------------------------------------------
# Multigrid V-cycle preconditioner
# ----------------------------------------------------------------------------


def _as_apply(minv):
    """Normalize a smoother preconditioner to a callable: either a diagonal
    tensor ((nf, m+1) Jacobi, or a 0-dim unit scale) or an apply-callable
    (e.g. element Schwarz)."""
    if callable(minv):
        return minv
    return lambda r: minv * r


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def lambda_max_est(sys_: LevelSystem, minv, iters: int = 6) -> torch.Tensor:
    """Estimate lambda_max(M^-1 H) by power iteration (deterministic start),
    where M^-1 is the smoother's preconditioner (Jacobi diagonal or element
    Schwarz), with a 1.05 safety margin.

    Barrier Hessians have unbounded dynamic range along the central path
    (cond ~ t^2), but the preconditioned operator stays O(1); the smoother
    must still track its top eigenvalue each Newton step or the V-cycle
    turns indefinite and CG diverges."""
    apply_m = _as_apply(minv)
    nf, mp1 = sys_.He.shape[1] // sys_.idx.shape[1], sys_.m + 1
    dtype = sys_.He.dtype
    # fixed quasi-random start vector: cheap and deterministic
    i = torch.arange(nf * mp1, dtype=dtype, device=sys_.He.device).reshape(nf, mp1)
    v = torch.cos(i * 7.13) + 0.3
    v[:, sys_.m] = 0.0
    lam = torch.ones((), dtype=dtype, device=v.device)
    for _ in range(iters):
        w = apply_m(hvp(sys_, v))
        ww = _vdot(w, w)
        lam = torch.sqrt(ww / torch.clamp_min(_vdot(v, v), 1e-300))
        v = w / torch.clamp_min(torch.sqrt(ww), 1e-300)
    return lam * 1.05  # safety margin


# ----------------------------------------------------------------------------
# Element-block additive Schwarz smoother
# ----------------------------------------------------------------------------


class SchwarzState(NamedTuple):
    """Factored subdomain blocks for the overlapping additive Schwarz
    smoother.

    The smoother's preconditioner is

        M^-1 = sum_e  A_e' W_e B_e^{-1} W_e A_e

    where A_e gathers element e's local dofs, W_e is a partition of unity
    (1/valence weights) and B_e is the principal submatrix of the assembled
    global (scaled) Newton matrix restricted to e's node set — assembled in
    element-local form with one segment sum over the static node-pair table
    (kernel C) plus one gather (kernel D), never forming a global sparse
    matrix.  Each term is SPD and the cover is complete, so M^-1 is SPD.

    Principal submatrices, not the element blocks He_e: He_e carries only
    the element's own stiffness, so a direction can be He_e-soft yet
    globally stiff; B_e >= He_e holds every neighbour's contribution on e's
    nodes, so block-soft == globally-soft at both ends of the path.  The
    lift is absolute (a block-relative lift amplified such directions by up
    to 1/lift in the JAX package's measurements).

    chol_up / we_up: chol and we cast to a wider dtype for residuals of
    that dtype (the scaled cycle's float64 post-smoothing), or None."""

    chol: torch.Tensor  # (nelem, C, C) lower Cholesky factors
    we: torch.Tensor  # (nelem, C) partition-of-unity weights (pad slots 0)
    chol_up: Optional[torch.Tensor] = None
    we_up: Optional[torch.Tensor] = None


def _schwarz_plans(sys_: LevelSystem, nf: int):
    """The static half of schwarz_setup: the field-pair expansion of the
    node-pair ids, full_id[e, c1, c2] = (f1*nf + f2)*npair + pair_idx[e, a,
    b] with c = f*nl + a, bound to kernel C's segment sum (the pair sums,
    sources sorted stably by pair) and kernel D's gather (B = sums[full_id]),
    and the node valences."""

    def build():
        idx = sys_.idx.cpu().numpy().astype(np.int64)
        pn = sys_.pair_idx.cpu().numpy().astype(np.int64)
        nelem, nl = idx.shape
        npair = sys_.npair or (int(pn.max()) + 1 if pn.size else 1)
        fp = np.arange(nf, dtype=np.int64)
        fpair = (fp[:, None] * nf + fp[None, :]) * npair  # (nf, nf)
        full_id = (fpair[None, :, None, :, None]
                   + pn[:, None, :, None, :]).reshape(-1)  # (nelem*C*C,)
        nseg = nf * nf * npair
        if nseg >= np.iinfo(np.int32).max or full_id.size >= np.iinfo(np.int32).max:
            raise ValueError(f"schwarz_setup: {nseg} pair segments exceed int32")
        order = np.argsort(full_id, kind="stable")
        off = np.concatenate([[0], np.cumsum(np.bincount(full_id, minlength=nseg))])
        dev = sys_.idx.device
        as_i = lambda a: torch.as_tensor(a.astype(np.int32), device=dev)  # noqa: E731
        counts = torch.as_tensor(np.bincount(idx.reshape(-1), minlength=sys_.m + 1), device=dev)
        return (SegmentPlan(as_i(order), as_i(off), full_id.size),
                GatherPlan(as_i(full_id), nseg), dist.ordered_sum(counts, sys_.mesh))

    return _cached(sys_, ("schwarz", nf), build)


def _schwarz_weights(sys_: LevelSystem, nf: int, dtype) -> torch.Tensor:
    """(nelem, nf*nl) 1/valence weights of each element slot, 0 on pad
    slots: integer-exact, so identical on every device."""

    def build():
        counts = _schwarz_plans(sys_, nf)[2].to(dtype)
        winv = torch.where(counts > 0, 1.0 / torch.clamp_min(counts, 1.0),
                           torch.zeros_like(counts))
        winv[sys_.m] = 0.0
        wn = winv[sys_.idx.long()]  # (nelem, nl)
        return wn.repeat(1, nf).contiguous()

    return _cached(sys_, ("schwarz_we", nf, dtype), build)


def schwarz_setup(sys_: LevelSystem, nf: int) -> SchwarzState:
    """Principal submatrices of every element, lifted and factored.

    Callers pass globally Jacobi-scaled systems, so diag(B) = 1 on every
    real dof; constrained and pad slots have all-zero rows and get an
    identity diagonal.  The absolute lift MGB_SCHWARZ_LIFT (3e-3) bounds the
    block condition for the float32 Cholesky."""
    He = sys_.He
    nelem, nl = sys_.idx.shape
    if sys_.pair_idx is None:
        raise ValueError("schwarz_setup requires LevelSystem.pair_idx "
                         "(elements.node_pair_table)")
    C = nf * nl
    pair_sum, pair_get, _ = _schwarz_plans(sys_, nf)
    B = pair_get(dist.ordered_sum(pair_sum(He.reshape(-1)), sys_.mesh)).reshape(nelem, C, C)
    we = _schwarz_weights(sys_, nf, He.dtype)
    d = torch.diagonal(B, dim1=1, dim2=2)
    lift_abs = float(os.environ.get("MGB_SCHWARZ_LIFT", "3e-3"))
    lift = lift_abs + torch.where(d > 0, torch.zeros_like(d), torch.ones_like(d))
    chol = _cholesky(B + torch.diag_embed(lift))
    return SchwarzState(chol=chol, we=we)


def schwarz_apply(sys_: LevelSystem, st: SchwarzState, r: torch.Tensor) -> torch.Tensor:
    """M^-1 r for the weighted additive Schwarz preconditioner.

    r: (nf, m+1) -> same shape.  One gather (kernel D), two batched
    triangular solves and one node sum (kernel C)."""
    dt = torch.promote_types(st.chol.dtype, r.dtype)
    chol = _wide(st.chol, st.chol_up, dt)
    we = _wide(st.we, st.we_up, dt)
    re = gather_elements(sys_, r.to(dt)) * we
    y = torch.linalg.solve_triangular(chol, re[..., None], upper=False)
    xe = torch.linalg.solve_triangular(chol.mT, y, upper=True)[..., 0]
    return dist.ordered_sum(_table_plan(sys_).em((xe * we).contiguous()), sys_.mesh)


_CHEB_RATIO = float(os.environ.get("MGB_CHEB_RATIO", "8.0"))


def host_scalar(x):
    """x (a 0-dim tensor, one host sync; or a numpy scalar) as a numpy
    scalar of its dtype."""
    if isinstance(x, torch.Tensor):
        return np.asarray(x.item(), dtype=str(x.dtype).split(".")[-1])[()]
    return x


def chebyshev(sys_: LevelSystem, minv, lmax, xp, bp, degree: int = 3, ratio: float = None):
    """Chebyshev-accelerated smoothing on [lmax/ratio, lmax] of M^-1 H
    (Saad 3rd ed., Alg. 12.1 adapted to a preconditioned operator), where
    M^-1 is Jacobi (a diagonal tensor) or element Schwarz (a callable).  A
    polynomial in M^-1 H is symmetric in the M inner product, so
    V(cheb,cheb) remains a valid SPD preconditioner for CG.  lmax is a
    0-dim tensor or a numpy scalar: the scalar recurrence runs on the host
    in its dtype (the JAX package's arithmetic, with no device launch), the
    vectors in the wider of their dtypes.  xp=None is the zero start (its
    residual is bp, with no H v)."""
    apply_m = _as_apply(minv)
    if ratio is None:
        ratio = _CHEB_RATIO
    lm = host_scalar(lmax)
    f = lm.dtype.type
    lmin = lm / f(ratio)
    d = f(0.5) * (lm + lmin)
    c = f(0.5) * (lm - lmin)
    if xp is None:
        xp, r = torch.zeros_like(bp), bp
    else:
        r = bp - hvp(sys_, xp)
    p = torch.zeros_like(bp)
    alpha = None
    for i in range(degree):
        z = apply_m(r)
        if i == 0:
            p = z
            alpha = f(1.0) / d
        else:
            h = c * alpha / f(2.0)
            beta = h * h
            alpha = f(1.0) / (d - beta / alpha)
            p = z + float(beta) * p
        xp = xp + float(alpha) * p
        r = r - float(alpha) * hvp(sys_, p)
    return xp


def _pad(v: torch.Tensor) -> torch.Tensor:
    """(nf, m) -> (nf, m+1) with a zero pad column."""
    return torch.cat([v, v.new_zeros((v.shape[0], 1))], dim=1)


def vcycle(systems: Sequence[LevelSystem], minvs: Sequence, lmaxs: Sequence, embeds: Sequence,
           coarse_solve, bp: torch.Tensor, nf: int, degree: int = 3) -> torch.Tensor:
    """One V-cycle with Chebyshev-accelerated smoothing on the finest of
    `systems`; minvs[l] is the level's smoother preconditioner (Jacobi
    diagonal or Schwarz apply-callable, see chebyshev).

    embeds[i]: inclusion of level-i subspace into level-(i+1) (any object
    with matvec/rmatvec on node-major (m, nf) operands).
    coarse_solve(bp_0) -> x_0 solves the coarsest level exactly."""

    def cycle(l, bp_l):
        sys_l, minv_l, lmax_l = systems[l], minvs[l], lmaxs[l]
        if l == 0:
            return coarse_solve(bp_l)
        xp = chebyshev(sys_l, minv_l, lmax_l, None, bp_l, degree)
        r = bp_l - hvp(sys_l, xp)
        E = embeds[l - 1]  # (m_l, m_{l-1})
        r_c = E.rmatvec(r[:, : sys_l.m].T).T  # (nf, m_{l-1})
        e_c = cycle(l - 1, _pad(r_c))
        e_f = E.matvec(e_c[:, : systems[l - 1].m].T).T  # (nf, m_l)
        xp = xp + _pad(e_f)
        return chebyshev(sys_l, minv_l, lmax_l, xp, bp_l, degree)

    return cycle(len(systems) - 1, bp)


class _ScaledTransfer(NamedTuple):
    """Level transfer conjugated by the symmetric Jacobi scalings.

    If Hhat_l = S_l H_l S_l with S_l = diag(d_l^{-1/2}), the prolongation
    that preserves the Galerkin relation Hhat_c = Ehat' Hhat_f Ehat is
    Ehat = S_f^{-1} E S_c (elementwise scale -> E -> scale).  Node-major
    operands (m, nf) to match vcycle's usage of matvec/rmatvec."""

    E: object
    sc: torch.Tensor  # (m_c, nf)  S_c diagonal
    sf_inv: torch.Tensor  # (m_f, nf)  S_f^{-1} diagonal

    def matvec(self, xc):  # (m_c, nf) -> (m_f, nf)
        return self.E.matvec(self.sc * xc) * self.sf_inv

    def rmatvec(self, rf):  # (m_f, nf) -> (m_c, nf)
        return self.E.rmatvec(self.sf_inv * rf) * self.sc


class NDCoarse(NamedTuple):
    """The nested-dissection factor of a cycle's coarse level: fz the
    level's NDFactorizer, table its ValsTable (the He -> vals segment sum
    of the HostPattern layout NDFactorizer.factor reads)."""

    fz: object
    table: ValsTable


# mgcg_solve calls by the CG loop they ran ("graph": replayed from a CUDA
# graph; "eager"), read by the tools beside a solve
CG_LOOPS = {"graph": 0, "eager": 0}


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _graph_loop(state, body, flags, go_on):
    """The CG loop with its body captured once into a CUDA graph and
    replayed per iteration: the state lives in static buffers that the
    graph reads and overwrites, and the exit test's flags of the new state
    are read after each replay (the iteration's one host sync).  The body is
    first run once on copies on a side stream, which sets up the library
    handles and workspaces capture needs; a body that would sync with the
    host cannot be captured and raises."""
    if not go_on(state):
        return state
    x, r, p, rz, it, q, stagq, healthy, rb2 = state
    static = [t.clone() for t in (x, r, p, rz, q, stagq, healthy, rb2)]

    def full(ts):
        return (*ts[:4], 0, *ts[4:])

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body(full([t.clone() for t in static]))
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    before = dict(cuda_kernels.CAPTURED)
    with torch.cuda.graph(g):
        new = body(full(static))
        for buf, val in zip(static, new[:4] + new[5:]):
            buf.copy_(val)
        out = flags(full(static))
    recorded = {k: n - before[k] for k, n in cuda_kernels.CAPTURED.items() if n > before[k]}
    while True:
        cuda_kernels.replay(g, recorded)
        it += 1
        if not go_on((*static[:4], it), f=telemetry.read(out, "mgcg.flags")):
            break
    return (*static[:4], it, *static[4:])


def mgcg_solve(
    systems: Sequence[LevelSystem],
    embeds: Sequence,
    bp: torch.Tensor,
    nf: int,
    rtol: float = 1e-10,
    maxiter: int = 200,
    degree: int = 3,
    shift: float = 0.0,
    stagnation: int = 12,
    lmaxs_in: Optional[torch.Tensor] = None,
    x0_in: Optional[torch.Tensor] = None,
    coarse_nd: Optional[NDCoarse] = None,
    graph: Optional[bool] = None,
):
    """Multigrid-preconditioned CG on the finest level of `systems`.

    Barrier Hessians become numerically singular along the central path;
    three countermeasures make MG-CG a replacement for a direct solve:

    * a Jacobi-prescaled float32 V-cycle (keeps the mixed-precision
      preconditioner positive definite at any path conditioning);
    * quadratic-model progress tracking with breakdown / stagnation / floor
      exits: every healthy iterate is a descent direction carrying the
      captured Newton decrement, and a breakdown returns the last valid
      iterate (the zero vector only at the genuine float64 floor, where a
      zero Newton step is the converged state);
    * an optional Levenberg shift (H + shift*diag(H)), default 0.

    embeds: the level embeddings (Ell or Transfer; an Ell is wrapped in a
    Transfer here, which transposes it on the host: a caller that solves
    repeatedly passes Transfers).  lmaxs_in: carried lambda_max estimates
    (len(systems) - 1; an entry <= 0 is estimated now).  x0_in: the warm
    start (the previous Newton direction), used only where it is a descent
    direction.  coarse_nd: the coarse level's NDCoarse, used above the
    dense coarse cap of the truncated two-grid cycle.

    Environment, as the JAX mgcg_solve reads it: MGB_MGCG_LEVELS (auto),
    MGB_MGCG_COARSE_CAP (4096), MGB_CG_MAXITER_DEEP (1000), MGB_MG_DEGREE,
    MGB_CYCLE_DTYPE (f32), MGB_SCALED_PRECOND (1), MGB_SMOOTHER (schwarz),
    MGB_CG_QEPS, MGB_CG_FLOOR_CAP, MGB_CG_DEFLATE (0), MGB_CG_HARVEST (40),
    MGB_CG_DEFLATE_LO (0); MGB_SCHWARZ_LIFT in schwarz_setup and
    MGB_CHEB_RATIO in chebyshev.  MGB_LANE_AOP picks a TPU layout of the
    same float64 operator, which here is always the fused hvp.

    graph: run the CG iterations as replays of one CUDA graph (the default
    on a CUDA device off a mesh or on an NCCL mesh, whose collectives the
    graph captures; under gloo, which syncs with the host, the loop runs
    eagerly; the deflated restart always runs eagerly): the same kernels in
    the same order, so the same bits, with one launch in place of ~190 per
    iteration.  CG_LOOPS counts the calls by the loop they ran.

    Returns (xp, iterations, relative residual at exit, lmaxs).  One host
    sync per CG iteration (the exit test) and one per call for the carried
    estimates."""
    embeds = [as_transfer(E) for E in embeds]
    # Truncated hierarchy (MGB_MGCG_LEVELS = T >= 2): keep only the top T
    # levels and solve the new coarsest level exactly instead of recursing
    # through smoothed coarser levels: the only approximation left is the
    # fine-level Schwarz smoother.  'auto' takes two-grid where the dense
    # coarse factor fits the cap (nf*(m_c+1) <= MGB_MGCG_COARSE_CAP), or
    # where an ND-factored coarse level is given; the deeper CG budget goes
    # with truncation (only a cycle strong enough to use it gets it).
    use_nd_coarse = False
    cap = _env_int("MGB_MGCG_COARSE_CAP", 4096)
    tg_env = os.environ.get("MGB_MGCG_LEVELS", "auto")
    if tg_env == "auto":
        if len(systems) > 2 and nf * (systems[-2].m + 1) <= cap:
            tg = 2
        elif len(systems) > 2 and coarse_nd is not None:
            tg = 2
            use_nd_coarse = True
        else:
            tg = 0
    else:
        tg = int(tg_env or 0)
        use_nd_coarse = (2 <= tg < len(systems) and coarse_nd is not None
                         and nf * (systems[-2].m + 1) > cap)
    n_drop = len(systems) - tg if 2 <= tg < len(systems) else 0
    if n_drop:
        systems = systems[n_drop:]
        embeds = embeds[n_drop:]
        if lmaxs_in is not None:
            lmaxs_in = lmaxs_in[n_drop:]
        maxiter = max(maxiter, _env_int("MGB_CG_MAXITER_DEEP", 1000))
    # smoother degree override (the fine smoother is the only approximation
    # left in the truncated cycle, so its degree is the accuracy/cost dial)
    degree = _env_int("MGB_MG_DEGREE", degree)
    dtype, dev = bp.dtype, bp.device
    fine = systems[-1]
    diag_fine = diag_of(fine)
    dinvs = [1.0 / diag_of(s) for s in systems]
    m0 = systems[0].m
    if use_nd_coarse:
        # exact multifrontal factor of the coarse operator: the element
        # Hessians reduce to the deduplicated pair-value layout by one
        # segment sum, then the factorization the fine ND route runs
        coarse_L = None
        coarse_fac = coarse_nd.fz.factor(
            dist.ordered_sum(he_to_vals(systems[0].He, coarse_nd.table), systems[0].mesh))
    else:
        coarse_L = _cholesky(dense_assemble(systems[0], nf))
        coarse_fac = None

    def Aop(v):
        hv = hvp(fine, v)
        return hv + shift * diag_fine * v if shift else hv

    # Mixed precision: the preconditioner only steers the Krylov space, so
    # its smoothing sweeps run in float32 while CG residuals and updates
    # stay at solve precision.  Symmetric Jacobi pre-scaling before the
    # float32 cast keeps this sound along the whole central path: scaling
    # each level to unit diagonal, Hhat_l = S_l H_l S_l with S_l =
    # diag(d_l)^{-1/2}, bounds the float32 representation error by
    # eps32*O(1); the cycle on Hhat (with scaling-conjugated transfers) is
    # the similarity transform of the unscaled cycle, and H^{-1} = S_f Vhat
    # S_f turns it back into an SPD preconditioner for H.
    f32c = (torch.float64 if os.environ.get("MGB_CYCLE_DTYPE", "f32") == "f64"
            and dtype == torch.float64 else torch.float32)
    use_scaled = os.environ.get("MGB_SCALED_PRECOND", "1") != "0"
    if use_scaled:
        svecs = [torch.sqrt(d) for d in dinvs]  # (nf, m+1) S_l diagonals
        systems32 = []
        for s_, sv in zip(systems, svecs):
            se = gather_elements(s_, sv)  # (nelem, nf*nl)
            He_hat = (s_.He * se[:, :, None] * se[:, None, :]).to(f32c)
            systems32.append(s_._replace(He=He_hat, He_up=None))
        dinvs32 = [torch.ones((), dtype=f32c, device=dev)] * len(systems)  # unit diag
        sv32 = [sv.to(f32c) for sv in svecs]
        embeds32 = [
            _ScaledTransfer(E=E, sc=sv32[i][:, : systems[i].m].T,
                            sf_inv=(1.0 / sv32[i + 1][:, : systems[i + 1].m]).T)
            for i, E in enumerate(embeds)
        ]
        s0_inv = 1.0 / svecs[0]  # = sqrt(diag_0), (nf, m0+1)
        s_fine = svecs[-1]
    else:  # unscaled cast (kept for A/B diagnosis)
        systems32 = [s._replace(He=s.He.to(f32c), He_up=None) for s in systems]
        dinvs32 = [d.to(f32c) for d in dinvs]
        embeds32 = [E.astype(f32c) for E in embeds]
        s0_inv = s_fine = None
    # The transfers' values keep the solve dtype on the scaled path, so the
    # coarse correction and everything after it in a cycle meet them in the
    # wider dtype: keep the smoothed levels' operators cast once.
    up = torch.promote_types(f32c, embeds[0].E.vals.dtype) if (use_scaled and embeds) else f32c
    if up != f32c:
        systems32 = [systems32[0]] + [s._replace(He_up=s.He.to(up)) for s in systems32[1:]]

    # Smoother preconditioner per level: element-block additive Schwarz by
    # default, Jacobi via MGB_SMOOTHER=jacobi or on the unscaled path.
    use_schwarz = (use_scaled and os.environ.get("MGB_SMOOTHER", "schwarz") == "schwarz"
                   and all(s.pair_idx is not None for s in systems32[1:]))
    if use_schwarz:
        minvs32 = [dinvs32[0]]
        for s in systems32[1:]:
            st = schwarz_setup(s, nf)
            if up != f32c:
                st = st._replace(chol_up=st.chol.to(up), we_up=st.we.to(up))
            minvs32.append((lambda s=s, st=st: lambda r: schwarz_apply(s, st, r))())
    else:
        minvs32 = dinvs32

    # lambda_max estimates of the smoothed float32 operator M^-1 Hhat (level
    # 0 is solved exactly: no smoother, no estimate), carried across a level
    # run via lmaxs_in in solve precision
    def _est(i):
        return lambda_max_est(systems32[i], minvs32[i], iters=6).to(dtype)

    one = torch.ones((), dtype=dtype, device=dev)
    if lmaxs_in is not None:
        carried = telemetry.read(lmaxs_in, "mgcg.lmax")
        lmaxs = [one] + [lmaxs_in[i - 1] * one if carried[i - 1] > 0 else _est(i)
                         for i in range(1, len(systems))]
    else:
        lmaxs = [one] + [_est(i) for i in range(1, len(systems))]
    lmaxs_out = (torch.stack(lmaxs[1:]) if len(lmaxs) > 1
                 else torch.zeros(0, dtype=dtype, device=dev))
    if n_drop:  # keep the caller's carried-lmaxs length contract
        lmaxs_out = torch.cat([torch.ones(n_drop, dtype=dtype, device=dev), lmaxs_out])
    # the cycle's eigenvalue estimates on the host (one sync), so that the
    # Chebyshev recurrences launch nothing
    lmaxs32 = list(telemetry.read(torch.stack(lmaxs).to(f32c), "mgcg.lmax", numpy=True))

    def _coarse_direct(r_pad):
        """Exact solve of the unscaled coarse operator; r_pad and the result
        are (nf, m0+1) field-major padded at factor precision."""
        if use_nd_coarse:
            # the ND solve works in node-major flat dofs (dof = node*nf + f)
            x_nd = coarse_nd.fz.solve(coarse_fac, r_pad[:, :m0].T.reshape(-1))
            return _pad(x_nd.reshape(m0, nf).T)
        # two triangular solves (cuBLAS trsm, which a CUDA graph captures)
        y = torch.linalg.solve_triangular(coarse_L, r_pad.reshape(-1, 1).to(coarse_L.dtype),
                                          upper=False)
        return torch.linalg.solve_triangular(coarse_L.mT, y, upper=True).reshape(nf, m0 + 1)

    def coarse_solve(bp0_hat):
        # Hhat_0^{-1} = S_0^{-1} H_0^{-1} S_0^{-1}: the factor is the
        # unscaled solve-precision factorization, untouched by the scaling
        # (solve at factor precision, return at cycle precision)
        if use_scaled:
            r = bp0_hat.to(s0_inv.dtype) * s0_inv
            x = _coarse_direct(r.to(dtype)).to(s0_inv.dtype)
            x = (x * s0_inv).to(f32c)
        else:
            x = _coarse_direct(bp0_hat.to(dtype)).to(f32c)
        x = x.clone()
        x[:, m0] = 0.0
        return x

    def precond(r):
        rhat = (r * s_fine if use_scaled else r).to(f32c)
        out = vcycle(systems32, minvs32, lmaxs32, embeds32, coarse_solve, rhat, nf,
                     degree=degree).to(dtype)
        return s_fine * out if use_scaled else out

    b2 = _vdot(bp, bp)
    eps = torch.finfo(dtype).tiny

    # Progress is measured by the quadratic model q(x) = x'Hx/2 - b'x, not
    # by the residual norm: healthy PCG decreases q by rz^2/(2 pAp) per step
    # even while ||r|| wanders above ||b||, and -2q is the captured Newton
    # decrement, so the last healthy iterate is the one to return.
    #
    # Exits (they decide which iterate is returned, so each is tested before
    # every iteration):
    # * converged: recursive residual below rtol*||b||;
    # * breakdown (healthy false): pAp or rz not positive; the guarded
    #   update (alpha = 0 on a bad step) keeps x the last valid iterate;
    # * q-stagnation: `stagnation` consecutive steps each capturing less
    #   than q_eps of the accumulated decrement (off with the truncated
    #   cycle, where the last of the decrement arrives slowly);
    # * floor bail: the residual never dropped below ||b|| by floor_cap
    #   iterations (the float64 floor's signature).
    q_eps = float(os.environ.get("MGB_CG_QEPS", "0" if n_drop else "1e-5"))
    floor_cap = _env_int("MGB_CG_FLOOR_CAP", max(2 * stagnation, 96))

    # Warm start from the previous Newton step's direction, accepted only
    # if it is a descent direction with a positive captured decrement
    # (q(x0) < 0); q accumulation starts at q(x0).
    if x0_in is not None:
        Ax0 = Aop(x0_in)
        q_x0 = 0.5 * _vdot(x0_in, Ax0) - _vdot(bp, x0_in)
        ok0 = torch.isfinite(q_x0) & (q_x0 < 0)
        x0 = torch.where(ok0, x0_in, torch.zeros_like(x0_in))
        r0 = torch.where(ok0, bp - Ax0, bp)
        q0 = torch.where(ok0, q_x0, torch.zeros_like(q_x0))
    else:
        x0 = torch.zeros_like(bp)
        r0 = bp
        q0 = torch.zeros((), dtype=dtype, device=dev)
    z0 = precond(r0)
    rz0 = _vdot(r0, z0)
    healthy0 = (rz0 > 0) & torch.isfinite(rz0)
    stag0 = torch.zeros((), dtype=torch.int64, device=dev)
    state0 = (x0, r0, z0, rz0, 0, q0, stag0, healthy0, b2)

    def flags(state):
        """The loop test's device half: [not converged, healthy and not
        stagnated; the residual has dipped below ||b||]."""
        x, r, p, rz, it, q, stagq, healthy, rb2 = state
        go = (_vdot(r, r) > rtol * rtol * b2 + eps) & healthy & (stagq < stagnation)
        return torch.stack([go, rb2 < b2])

    def go_on(state, limit=maxiter, f=None):
        """The loop test: one host sync (f: flags(state) already read)."""
        it = state[4]
        if it >= limit:
            return False
        go, below = f if f is not None else telemetry.read(flags(state), "mgcg.flags")
        return go and (it < floor_cap or below)

    def body(state, proj=None):
        x, r, p, rz, it, q, stagq, healthy, rb2 = state
        Ap = Aop(p) if proj is None else proj(Aop(p))
        pAp = _vdot(p, Ap)
        ok_step = (pAp > 0) & (rz > 0) & torch.isfinite(pAp)
        alpha = torch.where(ok_step, rz / (pAp + eps), torch.zeros_like(rz))
        x = x + alpha * p
        r = r - alpha * Ap
        rb2 = torch.minimum(rb2, _vdot(r, r))
        dq = 0.5 * alpha * rz  # q decrease this step; >= 0 by construction
        q = q - dq
        stagq = torch.where(dq > q_eps * (-q) + eps, torch.zeros_like(stagq), stagq + 1)
        z = precond(r)
        rz_new = _vdot(r, z)
        healthy = ok_step & (rz_new > 0) & torch.isfinite(rz_new)
        beta = rz_new / (rz + eps)
        p = z + beta * p
        return x, r, p, rz_new, it + 1, q, stagq, healthy, rb2

    def finish(x, r, it):
        x = x.clone()
        x[:, fine.m] = 0.0
        return x, it, torch.sqrt(_vdot(r, r) / (b2 + eps)), lmaxs_out

    # Ritz deflation (MGB_CG_DEFLATE = k; 0, the default, disables it): a
    # harvest phase of plain PCG whose iterates double as the preconditioned
    # Lanczos process, then CG restarted on the Vuik/Nicolaides-deflated
    # system with W = the extreme Ritz vectors (P = I - H W E^+ W', E =
    # W' H W; the final x += W E^+ W'(b - H x)).  Measured-rejected as a
    # depth fix in the JAX package; kept for its A/B record.
    deflate_k = _env_int("MGB_CG_DEFLATE", 0)
    K1 = min(_env_int("MGB_CG_HARVEST", 40), maxiter)
    state = state0
    if deflate_k <= 0 or K1 < deflate_k + 4:
        if graph is None:
            # a gloo collective syncs with the host and cannot be captured
            graph = bp.is_cuda and dist.backend_name(fine.mesh) in (None, "nccl")
        CG_LOOPS["graph" if graph else "eager"] += 1
        if graph:
            state = _graph_loop(state, body, flags, go_on)
        else:
            while go_on(state):
                state = body(state)
        return finish(state[0], state[1], state[4])

    Vbuf = [z0 / torch.sqrt(torch.clamp_min(rz0, eps))]
    al = torch.zeros(K1, dtype=dtype, device=dev)
    be = torch.zeros(K1, dtype=dtype, device=dev)
    while go_on(state, min(maxiter, K1)):
        x, r, p, rz, it, q, *_ = state
        state = body(state)
        _, _, p2, rz2, _, q2, *_ = state
        # this step's alpha and beta, recovered from the state transition
        alpha = torch.where(rz > 0, (q - q2) * 2.0 / torch.clamp_min(rz, eps),
                            torch.zeros_like(rz))
        beta = rz2 / (rz + eps)
        al[it] = alpha
        be[it] = beta
        z2 = p2 - beta * p  # z of the next iteration (body: p = z + b p)
        Vbuf.append(z2 / torch.sqrt(torch.clamp_min(rz2, eps)))
    x1, r1, p1, rz1, it1, q1, stagq1, healthy1, rb21 = state
    converged1 = _vdot(r1, r1) <= rtol * rtol * b2 + eps
    if not telemetry.read((~converged1) & healthy1 & (it1 >= deflate_k + 4), "mgcg.flags"):
        return finish(x1, r1, it1)

    # valid Lanczos steps: alphas 0..it1-1 and vectors 0..it1
    V = torch.zeros((K1,) + tuple(bp.shape), dtype=dtype, device=dev)
    V[: min(len(Vbuf), K1)] = torch.stack(Vbuf[:K1])
    jidx = torch.arange(K1, device=dev)
    valid = jidx < it1
    a_safe = torch.where(valid & (al > 0), al, torch.ones_like(al))
    b_prev = torch.cat([al.new_zeros(1), be[:-1]])
    a_prev = torch.cat([al.new_ones(1), a_safe[:-1]])
    diag = 1.0 / a_safe + b_prev / a_prev
    # padding rows get a sentinel above any real eigenvalue, so their
    # eigenpairs are never selected at the smallest end
    diag = torch.where(valid, diag, torch.full_like(diag, 1e8))
    offd = torch.where(jidx[:-1] < it1 - 1, torch.sqrt(torch.clamp_min(be[:-1], 0.0)) / a_safe[:-1],
                       torch.zeros_like(be[:-1]))
    T = torch.diag(diag) + torch.diag(offd, 1) + torch.diag(offd, -1)
    _, Y = torch.linalg.eigh(T)  # ascending
    # deflate the top Ritz pairs by default: they converge first in a short
    # Lanczos run, while half-converged small modes inject error into the
    # near-null directions that carry the remaining Newton decrement
    k_lo = min(_env_int("MGB_CG_DEFLATE_LO", 0), deflate_k)
    k_hi = deflate_k - k_lo
    sel = torch.cat([jidx[:k_lo], jidx[K1 - k_hi:]])
    W = torch.einsum("jk,j...->k...", Y[:, sel], V)  # (k, nf, m+1)
    HW = torch.stack([Aop(w_) for w_ in W])
    E = torch.einsum("k...,l...->kl", W, HW)
    ew, U = torch.linalg.eigh(E)
    ew_floor = torch.clamp_min(ew.abs().max(), eps) * (100.0 * torch.finfo(dtype).eps)
    ew_inv = torch.where(ew > ew_floor, 1.0 / ew, torch.zeros_like(ew))

    def Einv(v):  # (k,) -> (k,) pseudo-inverse apply
        return U @ (ew_inv * (U.T @ v))

    def wdot(arr):  # (k, ...) x (...) -> (k,)
        return torch.einsum("k...,...->k", W, arr)

    def correct(xc):
        """x + W E^+ W'(b - H x): the q-minimizer over x + span W."""
        rc = bp - Aop(xc)
        return xc + torch.einsum("k,k...->...", Einv(wdot(rc)), W), rc

    def proj(v):  # P v = v - H W E^+ W' v
        return v - torch.einsum("k,k...->...", Einv(wdot(v)), HW)

    x20, r20raw = correct(x1)
    r20 = proj(r20raw)
    z20 = precond(r20)
    rz20 = _vdot(r20, z20)
    healthy20 = (rz20 > 0) & torch.isfinite(rz20)
    state = (x20, r20, z20, rz20, it1, q1, torch.zeros_like(stagq1), healthy20, rb21)
    while go_on(state):
        state = body(state, proj)
    x2, r2, it2 = state[0], state[1], state[4]
    # final W-space correction, kept only if finite and the true residual
    # did not grow (floor regimes can make the k x k solve noise-dominated)
    x2c, _ = correct(x2)
    r2c = bp - Aop(x2c)
    ok = torch.isfinite(x2c).all() & (_vdot(r2c, r2c) <= _vdot(r2, r2))
    return finish(torch.where(ok, x2c, x2), torch.where(ok, r2c, r2), it2)
