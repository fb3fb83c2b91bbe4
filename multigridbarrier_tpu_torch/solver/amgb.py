"""amgb — the multigrid interior-point (barrier) solver (port of
solver/amgb.py).

Solves

    min_z  sum_i w_i * c(x_i) . (Dz)_i      (linear cost in Dz)
    s.t.   (Dz)_i in Q  for every quadrature point i
           z - z_g in the conforming (Dirichlet) subspace

by path following over the barrier parameter t with damped Newton steps
on a coarse-to-fine hierarchy of subspaces.  The iterate z lives in the
broken quadrature-point space (n, nfields); a level-l Newton correction is
R_l @ dv.

One Newton step (_SolverCtx.step): barrier rows F0/F1/F2 by torch.func ->
gradient contraction and node sum (kernel C) -> element Hessians
(kernel A) -> deduplicated values (kernel C's segment sum) -> a direct
Newton direction -> damped Armijo line search that rejects non-finite
steps.  The direction comes from one of two routes:

* dense (level 0, and every level with nf*m <= backend.dense_threshold):
  dense Cholesky with a shift ladder and matrix-free refinement (kernels
  B+C), linsolve.dense_solve;
* nested dissection (every other level): the multifrontal Cholesky of
  ndsolve.py (kernels C and D) with a two-trip factor-preconditioned CG
  polish on the exact pair-block matvec and a Jacobi fallback on a
  non-finite direction (_NDLevel, the JAX _get_nd direction).

The Newton loop and the line search are host loops: each Newton step
syncs with the host for the decrement and once per line-search trial, and
the dense route also for the Cholesky status; the nested-dissection
factor and solve do not sync.

Ported so far: phase 2 (the start point must be strictly feasible).
These raise NotImplementedError: an infeasible start (phase 1), mixed
precision, a custom linear solver and aux= columns.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.func import grad, hessian, vmap

from ..fem.geometry import Geometry
from ..runtime.cuda_kernels import he_assemble, row_gather, segment_sum
from .convex import Convex, convex_Euclidian_power
from .linsolve import LevelSystem, dense_solve, he_to_vals, vals_table
from .ndsolve import NDFactorizer, NDSymbolic, narrow_idx, node_coords

# ----------------------------------------------------------------------------
# Problem specification
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DSpec:
    """Operator-selection table: row j of Dz is operators[op_j] applied to
    field f_j (the reference's D matrix, e.g. [:u :id; :u :dx; :u :dy; :s :id])."""

    entries: Tuple[Tuple[int, str], ...]  # (field_index, op_name) per row
    fieldnames: Tuple[str, ...]

    @property
    def k(self) -> int:
        return len(self.entries)

    @property
    def nfields(self) -> int:
        return len(self.fieldnames)


def _normalize_D(D) -> DSpec:
    fieldnames: list = []
    entries = []
    for row in D:
        fname, opname = str(row[0]).lstrip(":"), str(row[1]).lstrip(":")
        if fname not in fieldnames:
            fieldnames.append(fname)
        entries.append((fieldnames.index(fname), opname))
    return DSpec(entries=tuple(entries), fieldnames=tuple(fieldnames))


def default_D(dim: int):
    grads = ["dx", "dy", "dz"][:dim]
    return [("u", "id")] + [("u", g) for g in grads] + [("s", "id")]


def default_f(dim: int, dtype):
    vec = [0.5] + [0.0] * dim + [1.0]

    def f(x):
        return torch.tensor(vec, dtype=dtype, device=x.device)

    return f


def default_g(dim: int, dtype):
    def g(x):
        xs = x[:dim]
        return torch.stack([torch.sum(xs * xs), torch.full_like(xs[0], 100.0)])

    return g


_DEFAULT_Q_CACHE: dict = {}


def default_Q(dim: int, p) -> Convex:
    """Cone over (grad u, s): ||grad u||^p <= s.  Memoized, so repeated amgb
    calls reuse the same barrier callable (the solver contexts are cached by
    barrier identity)."""
    key = (dim, p) if isinstance(p, (int, float)) else None
    if key is not None and key in _DEFAULT_Q_CACHE:
        return _DEFAULT_Q_CACHE[key]
    Q = convex_Euclidian_power(idx=tuple(range(1, dim + 2)), p=p)
    if key is not None:
        _DEFAULT_Q_CACHE[key] = Q
    return Q


# ----------------------------------------------------------------------------
# Solution containers (field names match the reference)
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class PhaseLog:
    t_elapsed: float
    ts: list
    its: np.ndarray  # (levels,) Newton iterations per level
    c_dot_Dz: list
    t_begin: float
    t_end: float
    converged: bool


@dataclasses.dataclass
class AMGBSOL:
    z: torch.Tensor  # (n, nfields) solution in the broken space
    SOL_feasibility: Optional[PhaseLog]
    SOL_main: PhaseLog
    log: list
    geometry: Geometry


class AMGBConvergenceFailure(RuntimeError):
    pass


def _apply_D(ops, spec: DSpec, z):
    return torch.stack([ops[op].matvec(z[:, f]) for (f, op) in spec.entries], dim=1)


def _masked_wsum(w, vals):
    """sum(w * vals) ignoring zero-weight (padding) rows, where vals may be
    NaN on padded rows (0 * NaN = NaN otherwise)."""
    return torch.sum(torch.where(w != 0, w * vals, torch.zeros_like(vals)))


class _NDLevel:
    """Nested-dissection Newton direction of one level: the JAX
    _SolverCtx._get_nd state and make_direction(None, n_cg=2) — factor,
    solve, a factor-preconditioned CG polish of N_CG trips on the exact
    pair-block matvec, kept only where its quadratic model is lower, and a
    Jacobi fallback when the direction is not finite.  Branch-free on the
    device: nothing here syncs with the host."""

    N_CG = 2  # CG trips of the polish (the JAX CPU default MGB_ND_PCG=2)

    def __init__(self, basis, nf: int, x: torch.Tensor):
        m = basis.m
        idx = basis.idx.cpu().numpy()
        t0 = time.perf_counter()
        sym = NDSymbolic(idx, m, nf, node_coords(idx, m, x.cpu().numpy(), basis.nq))
        self.symbolic_s = time.perf_counter() - t0  # host seconds, cached per level
        dev = basis.idx.device
        self.fz = NDFactorizer(sym, dev, x.dtype)
        self.m, self.nf = m, nf
        self.pair_j = narrow_idx(sym.pair_j, dev)
        self.pair_vidx = narrow_idx(sym.pair_vidx, dev)
        self.pair_off = narrow_idx(sym.pair_off, dev)
        # node-major per-dof diagonal ids: vals[(f*nf+f)*nuniq + diag_pid]
        self.diag_ids = narrow_idx(
            (
                (np.arange(nf, dtype=np.int64) * (nf + 1))[None, :] * sym.nuniq
                + sym.diag_pid[:, None]
            ).reshape(-1),
            dev,
        )

    def matvec(self, vpair: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
        """Exact A @ x from the deduplicated pair blocks vpair (npair, nf*nf);
        x and the result are node-major (m*nf,)."""
        nf = self.nf
        xj = row_gather(xv.reshape(self.m, nf), self.pair_j)
        contrib = torch.einsum("pfg,pg->pf", vpair.reshape(-1, nf, nf), xj)
        return segment_sum(contrib.contiguous(), None, self.pair_off).reshape(-1)

    def direction(self, vals: torch.Tensor, gv: torch.Tensor) -> torch.Tensor:
        """vals (HostPattern layout), gv (nf, m+1) -> dvp (nf, m+1), the
        Newton direction for -gv with a zero pad slot."""
        m, nf = self.m, self.nf
        b = -gv[:, :m].T.reshape(-1)
        fac = self.fz.factor(vals)
        vpair = row_gather(vals, self.pair_vidx)

        def apply_fac(r):
            return self.fz.solve(fac, r)

        def matvec(v):
            return self.matvec(vpair, v)

        xv = apply_fac(b)
        zero = b.new_zeros(())
        one = b.new_ones(())
        r = b - matvec(xv)
        p = apply_fac(r)
        rz = torch.dot(r, p)
        xv_cg = xv
        for _ in range(self.N_CG):
            Ap = matvec(p)
            pAp = torch.dot(p, Ap)
            ok = torch.isfinite(pAp) & (pAp > 0) & torch.isfinite(rz) & (rz > 0)
            al = torch.where(ok, rz / torch.where(ok, pAp, one), zero)
            xv_cg = xv_cg + al * p
            r = r - al * Ap
            z2 = apply_fac(r)
            rz2 = torch.dot(r, z2)
            beta = torch.where(ok & (rz2 > 0), rz2 / torch.where(ok, rz, one), zero)
            p = torch.where(ok, z2 + beta * p, p)
            rz = rz2

        def q_of(v):
            return 0.5 * torch.dot(v, matvec(v)) - torch.dot(b, v)

        # keep the polished direction only where its quadratic model is lower
        q_ir, q_cg = q_of(xv), q_of(xv_cg)
        take_cg = torch.isfinite(xv_cg).all() & torch.isfinite(q_cg) & (q_cg <= q_ir)
        xv = torch.where(take_cg, xv_cg, xv)
        dg = row_gather(vals, self.diag_ids).abs().clamp_min(1e-300)
        xv = torch.where(torch.isfinite(xv).all(), xv, b / dg)
        return torch.cat([xv.reshape(m, nf).T, xv.new_zeros((nf, 1))], dim=1)


# ----------------------------------------------------------------------------
# Solver context
# ----------------------------------------------------------------------------


class _SolverCtx:
    """Per-(geometry, problem) solver state: the element-local operator
    tensors of every level and the Newton iteration on them."""

    # Newton-loop stop codes (run_level return)
    RUNNING, CONVERGED, LOCKED, STALLED, DIVERGED, CAPPED = 0, 1, 2, 3, 4, 5

    def __init__(
        self,
        geometry: Geometry,
        spec: DSpec,
        barrier: Callable,
        c: torch.Tensor,
        subspace: str = "dirichlet",
        armijo: float = 0.25,
        max_backtrack: int = 60,
        newton_cap: int = 200,
        newton_patience: Optional[int] = None,
    ):
        self.geometry = geometry
        self.spec = spec
        self.barrier = barrier
        self.c = c
        self.armijo = armijo
        self.max_backtrack = max_backtrack
        self.newton_cap = newton_cap
        # Patience soft-accept, disabled by default (0).
        if newton_patience is None:
            newton_patience = int(os.environ.get("MGB_NEWTON_PATIENCE", "0"))
        self.newton_patience = newton_patience
        # Quadratic-region plateau window W of the stall detector: compare
        # min(lam2 over the last W its) with min(lam2 over the W before).
        self.stall_win = int(os.environ.get("MGB_STALL_WIN", "2"))
        # Line-search start: "full" tries alpha=1; "damped" starts at the
        # self-concordance step 1/(1+lam).
        self.ls_full = os.environ.get("MGB_LS_ALPHA0", "damped") == "full"

        g = geometry
        self.levels = len(g.bases[subspace])
        self.x = g.x
        self.w = g.w
        self.ops = g.operators
        self.backend = g.backend
        self._bases = g.bases[subspace]
        nf = spec.nfields
        # Routing (the JAX _nd_enabled): level 0 and levels with
        # nf*m <= dense_threshold solve densely; every other level through
        # nested dissection, its symbolic phase built at first use.
        self._nd_route = {
            lvl for lvl, basis in enumerate(self._bases)
            if lvl > 0 and nf * basis.m > self.backend.dense_threshold
        }
        self.nd = {}  # level -> _NDLevel
        self._tables = {}  # level -> linsolve.ValsTable

        # Element-local operator tensors per level with the field embedding
        # baked in: P_l[e, q, j, fj*nl + a] = (D_{op_j} R_l) restricted to
        # element e, so gradient, Hessian and direction are each one batched
        # contraction over the (q, j) axis.
        self._P = []
        for basis in self._bases:
            rloc = basis.rloc  # (nelem, nq, nl)
            nelem, nq, nl = rloc.shape
            P = rloc.new_zeros((nelem, nq, spec.k, nf * nl))
            for j, (fj, opname) in enumerate(spec.entries):
                op = self.ops[opname]
                Bj = rloc if op.is_identity else torch.einsum(
                    "eqr,era->eqa", op.blocks, rloc
                )
                P[:, :, j, fj * nl : (fj + 1) * nl] = Bj
            self._P.append(P)

        self._F1 = grad(barrier, argnums=1)
        self._F2 = hessian(barrier, argnums=1)

    def step(self, level: int, z, t: float):
        """One damped Newton step at `level`.

        Returns (z_new, lam2, alpha, phi0, cy, dphi), the scalars as floats.
        alpha == 0 means the line search found no acceptable step; z is then
        returned unchanged."""
        spec, ops, x, w, c = self.spec, self.ops, self.x, self.w, self.c
        nf, k = spec.nfields, spec.k
        basis = self._bases[level]
        Pl, idx, m = self._P[level], basis.idx, basis.m
        nelem, nq, nl = basis.nelem, basis.nq, basis.nl
        barrier = self.barrier

        y = _apply_D(ops, spec, z)
        cy = torch.sum(w * torch.sum(c * y, dim=1))
        fy0 = _masked_wsum(w, vmap(barrier)(x, y))
        phi0 = t * cy + fy0

        # gradient rows -> one fused contraction -> node sum (kernel C)
        F1v = vmap(self._F1)(x, y)  # (n, k)
        gy = (w[:, None] * (t * c + F1v)).reshape(nelem, nq, k)
        gf = torch.einsum("eqj,eqjc->ec", gy, Pl)  # (nelem, nf*nl)
        gv = basis.scatter_add(
            gf.reshape(nelem, nf, nl).permute(0, 2, 1).reshape(-1, nf)
        ).T  # (nf, m+1), pad row zeroed

        # element Hessians (kernel A) and the Newton direction
        Y2w = vmap(self._F2)(x, y) * w[:, None, None]  # (n, k, k)
        He = he_assemble(Pl, Y2w.reshape(nelem, nq, k, k).contiguous())
        if level not in self._tables:
            self._tables[level] = vals_table(idx, m, nf)
        table = self._tables[level]
        if level in self._nd_route:
            if level not in self.nd:
                self.nd[level] = _NDLevel(basis, nf, x)
            dvp = self.nd[level].direction(he_to_vals(He, table), gv)
        else:
            sys_ = LevelSystem(He, idx, m, basis.scatter_idx, table)
            dvp = dense_solve(sys_, nf, -gv)
        lam2_t = -torch.dot(gv.reshape(-1), dvp.reshape(-1))

        # direction in Dz-space (fused contraction)
        dve = dvp[:, idx]  # (nf, nelem, nl)
        dve_flat = dve.permute(1, 0, 2).reshape(nelem, nf * nl)
        dY = torch.einsum("eqjc,ec->eqj", Pl, dve_flat).reshape(-1, k)
        c_dY = torch.sum(w * torch.sum(c * dY, dim=1))

        lam2, phi0, cy_f = float(lam2_t), float(phi0), float(cy)
        if not math.isfinite(lam2):
            # no acceptable step exists: every trial compares against NaN
            return z, lam2, 0.0, phi0, cy_f, 0.0
        lam = math.sqrt(max(lam2, 0.0))
        alpha = 1.0 if (self.ls_full or lam <= 0.25) else 1.0 / (1.0 + lam)
        dz = torch.einsum("eqa,fea->eqf", basis.rloc, dve).reshape(z.shape)

        def trial(alpha):
            # The barrier is evaluated at D(z + alpha dz), the iterate that
            # is accepted, rather than at y + alpha dY: the two differ by
            # round-off, and at t >= 1e6 boundary margins sit at that level,
            # so only this form guarantees a feasible accepted iterate.  The
            # linear part stays in difference form: at large t, |phi| ~ t
            # while the Armijo decrease is O(lam2).
            za = z + alpha * dz
            ya = _apply_D(ops, spec, za)
            dfy = _masked_wsum(w, vmap(barrier)(x, ya)) - fy0
            return za, float(t * alpha * c_dY + dfy)

        def accept(alpha, dphi):
            return math.isfinite(dphi) and dphi <= -self.armijo * alpha * lam2

        za, dphi = trial(alpha)
        bt = 0
        while not accept(alpha, dphi) and bt < self.max_backtrack:
            alpha *= 0.5
            za, dphi = trial(alpha)
            bt += 1
        if not accept(alpha, dphi):
            # rejected step; the direction may carry NaNs from a broken solve
            return z, lam2, 0.0, phi0, cy_f, 0.0
        return za, lam2, alpha, phi0, cy_f, dphi

    def _stop_code(self, tr, kg, lam2, alpha, phi0, theta2, eps):
        """The Newton stop rule (the JAX package's _SolverCtx._stop_code).

        Quadratic region (lam2 <= 0.25): a lam2 plateau over two windows of
        W iterations means the arithmetic floor — accept as centered.
        Damped region: only a phi-progress floor counts.  Returns
        DIVERGED/LOCKED/CONVERGED/STALLED/RUNNING; the caller owns the
        newton_cap bound (CAPPED)."""
        l2 = tr["lam2"]
        W = self.stall_win
        stall_quad = (
            kg >= 2 * W - 1
            and lam2 <= 0.25
            and min(l2[-W:]) >= 0.95 * min(l2[-2 * W:-W])
        )
        floor = 64.0 * eps * (abs(phi0) + 1.0)
        stall_floor = kg >= 2 and max(abs(d) for d in tr["dphi"][-3:]) <= floor
        patience = self.newton_patience
        patient = patience > 0 and kg + 1 >= patience and lam2 <= 25.0
        if not math.isfinite(lam2):
            return self.DIVERGED
        if alpha == 0.0:
            return self.LOCKED
        if lam2 <= theta2:
            return self.CONVERGED
        if stall_quad or stall_floor or patient:
            return self.STALLED
        return self.RUNNING

    def run_level(self, level: int, z, t: float, theta2: float):
        """The Newton iteration at `level` until a stop code; returns
        (z, its, stop_code, traces)."""
        eps = torch.finfo(z.dtype).eps
        tr = {key: [] for key in ("lam2", "alpha", "phi", "dphi", "cy")}
        kg = 0
        while True:
            z, lam2, alpha, phi0, cy, dphi = self.step(level, z, t)
            tr["lam2"].append(lam2)
            tr["alpha"].append(alpha)
            tr["phi"].append(phi0)
            tr["dphi"].append(dphi)
            tr["cy"].append(cy)
            code = self._stop_code(tr, kg, lam2, alpha, phi0, theta2, eps)
            kg += 1
            if code != self.RUNNING:
                break
            if kg >= self.newton_cap:
                code = self.CAPPED
                break
        return z, kg, code, {k_: np.asarray(v, np.float64) for k_, v in tr.items()}


# ----------------------------------------------------------------------------
# Path following
# ----------------------------------------------------------------------------


def _path_follow(
    ctx: _SolverCtx,
    z,
    t0: float,
    t_end: float,
    kappa: float,
    maxit: int,
    theta: float,
    final_lam2: float,
    verbose: bool = False,
    logfile=None,
    phase: str = "main",
):
    L = ctx.levels
    its = np.zeros(L, dtype=np.int64)
    ts, c_dots, log = [], [], []
    total = 0
    t_start = time.perf_counter()
    t = float(t0)
    user_kappa = float(kappa)
    kap = user_kappa

    def emit(msg):
        if verbose:
            print(msg)
        if logfile is not None:
            print(msg, file=logfile)

    # The first t sweeps every level coarse to fine, which brings the start
    # iterate onto the central path cheaply; after the first successful t
    # only the finest level runs, with the full sweep re-enabled as the
    # first escalation if a t-step fails.
    use_coarse = True
    retry_stage = 0
    locked_levels = set()  # levels locked at an earlier t: skip henceforth
    z_conv_cur = None  # converged iterate at the last completed t
    while True:
        ts.append(t)
        z_backup = z if z_conv_cur is None else z_conv_cur
        its_backup = its.copy()
        locked_backup = set(locked_levels)
        ok = True
        for lvl in range(L):
            if lvl < L - 1 and (not use_coarse or lvl in locked_levels):
                continue
            # CONVERGED lam2 <= theta^2; LOCKED = the line search finds no
            # step with measurable progress (the f64 cancellation floor);
            # STALLED = decrement floor; DIVERGED/CAPPED reject the t-step
            z, nits, code, tr = ctx.run_level(lvl, z, t, theta ** 2)
            its[lvl] += nits
            total += nits
            for i in range(nits):
                log.append(
                    dict(
                        phase=phase,
                        t=t,
                        level=lvl,
                        lam2=float(tr["lam2"][i]),
                        alpha=float(tr["alpha"][i]),
                        phi=float(tr["phi"][i]),
                        dphi=float(tr["dphi"][i]),
                    )
                )
            if total > maxit:
                raise AMGBConvergenceFailure(
                    f"amgb: exceeded maxit={maxit} Newton iterations"
                )
            if code == _SolverCtx.LOCKED:
                locked_levels.add(lvl)
            if code in (_SolverCtx.DIVERGED, _SolverCtx.CAPPED):
                ok = False
                break

        if not ok:
            z = z_backup
            its = its_backup
            # locks taken during the rejected sweep belong to the too
            # aggressive t: roll the lock set back too
            locked_levels = locked_backup
            ts.pop()
            t_prev = ts[-1] if ts else t0
            retry_stage += 1
            if retry_stage == 1:
                # escalation 1: flip the sweep strategy for this t
                use_coarse = not use_coarse
                emit(
                    f"[amgb:{phase}] step rejected; retrying t={t:.3e} "
                    f"with {'full sweep' if use_coarse else 'finest level only'}"
                )
                continue
            # escalation 2: halve the barrier step in log space
            if kap <= 1.0 + 1e-9 or t <= t_prev * (1 + 1e-12):
                raise AMGBConvergenceFailure(
                    f"amgb: Newton failed to converge at t={t} "
                    f"(phase={phase}) with minimal step"
                )
            kap = math.sqrt(kap)
            t = min(t_prev * kap, t_end)
            emit(f"[amgb:{phase}] step rejected; kappa -> {kap:.3f}, retry t={t:.3e}")
            continue

        # c.Dz at the last Newton evaluation of this t (run_level always
        # takes at least one step)
        cy_last = float(tr["cy"][nits - 1])
        c_dots.append(cy_last)
        emit(f"[amgb:{phase}] t={t:.4e} its={its.tolist()} c_dot_Dz={cy_last:.10e}")
        use_coarse = False
        retry_stage = 0

        if t >= t_end * (1 - 1e-12):
            break
        t_done = t
        kap = min(user_kappa, kap * kap) if kap < user_kappa else user_kappa
        t = min(t_done * kap, t_end)
        z_conv_cur = z

    # Final polish at the finest level, only after a CONVERGED stage: a
    # stage that ended STALLED or LOCKED is already at the arithmetic floor.
    # c_dot_Dz is recorded per t-stage before the polish, so the cap on the
    # polish changes only how long the floor is ground.
    if code in (_SolverCtx.STALLED, _SolverCtx.LOCKED):
        emit(
            f"[amgb:{phase}] final polish skipped: fine level already "
            f"at the arithmetic floor (code={code})"
        )
    else:
        emit(f"[amgb:{phase}] final polish t={t:.4e} target lam2={final_lam2:.3e}")
        cap_save = ctx.newton_cap
        ctx.newton_cap = min(cap_save, max(4, 2 * ctx.stall_win))
        try:
            z_new, nits, code, tr = ctx.run_level(L - 1, z, t, final_lam2)
        finally:
            ctx.newton_cap = cap_save
        emit(f"[amgb:{phase}] polish done its={nits} code={code}")
        if code != _SolverCtx.DIVERGED:
            z = z_new
            its[L - 1] += nits

    return z, PhaseLog(
        t_elapsed=time.perf_counter() - t_start,
        ts=ts,
        its=its,
        c_dot_Dz=c_dots,
        t_begin=float(t0),
        t_end=float(t),
        converged=True,
    ), log


# ----------------------------------------------------------------------------
# amgb entry point
# ----------------------------------------------------------------------------


def _get_ctx(geometry: Geometry, spec, barrier, c, **kw):
    """Geometry-attached _SolverCtx cache, keyed by everything that shapes
    the context (the environment knobs it reads included); c is refreshed on
    every call."""
    key = (
        spec,
        barrier,
        kw.get("subspace", "dirichlet"),
        kw.get("newton_cap", 200),
        tuple(
            os.environ.get(v)
            for v in ("MGB_STALL_WIN", "MGB_NEWTON_PATIENCE", "MGB_LS_ALPHA0")
        ),
    )
    ctx = geometry.ctx_cache.get(key)
    if ctx is None:
        ctx = _SolverCtx(geometry, spec, barrier, c, **kw)
        geometry.ctx_cache[key] = ctx
    else:
        ctx.c = c
    return ctx


def amgb(
    geometry: Geometry,
    *,
    D=None,
    f: Optional[Callable] = None,
    g: Optional[Callable] = None,
    Q: Optional[Convex] = None,
    p=1.0,
    t: float = 0.1,
    tol: Optional[float] = None,
    kappa: float = 10.0,
    maxit: int = 10000,
    verbose: bool = False,
    logfile=None,
    subspace: str = "dirichlet",
    linear_solver: Optional[Callable] = None,
    newton_cap: int = 200,
    aux=None,
    z0=None,
    mixed: Optional[bool] = None,
    **_ignored,
):
    """Solve the barrier problem on `geometry`.

    Mirrors the reference signature amgb(geometry; p, tol, maxit, verbose,
    logfile, D, f, g); unknown keyword arguments are tolerated and ignored.
    `z0` may be a tensor or a numpy array of shape (n, nfields).
    """
    if linear_solver is not None:
        raise NotImplementedError("amgb: linear_solver= is not ported yet")
    if mixed:
        raise NotImplementedError("amgb: mixed precision is not ported yet")
    if aux is not None:
        raise NotImplementedError("amgb: aux= columns are not ported yet")
    dim = geometry.dim
    dtype, device = geometry.x.dtype, geometry.x.device
    if tol is None:
        tol = float(np.sqrt(torch.finfo(dtype).eps))

    spec = _normalize_D(D if D is not None else default_D(dim))
    ffun = f if f is not None else default_f(dim, dtype)
    gfun = g if g is not None else default_g(dim, dtype)
    Qset = Q if Q is not None else default_Q(dim, p)

    def as_row(v):
        if isinstance(v, torch.Tensor):
            return v.to(dtype)
        return torch.tensor(v, dtype=dtype, device=device)

    x, w = geometry.x, geometry.w
    c = vmap(lambda xi: as_row(ffun(xi)))(x)
    if z0 is None:
        z0 = vmap(lambda xi: as_row(gfun(xi)))(x)
    else:
        z0 = torch.as_tensor(z0, dtype=dtype, device=device)
    if c.shape[1] != spec.k:
        raise ValueError(f"f(x) must return {spec.k} components, got {c.shape[1]}")
    if z0.shape[1] != spec.nfields:
        raise ValueError(
            f"g(x) must return {spec.nfields} components, got {z0.shape[1]}"
        )

    # strict interiority <=> finite barrier at the start point
    y0 = _apply_D(geometry.operators, spec, z0)
    if not bool(torch.isfinite(torch.sum(w * vmap(Qset.barrier)(x, y0)))):
        raise NotImplementedError(
            "amgb: the start point is not strictly feasible, and the "
            "feasibility phase (phase 1) is not ported yet"
        )
    SOL_feasibility = PhaseLog(
        t_elapsed=0.0,
        ts=[],
        its=np.zeros(geometry.levels, dtype=np.int64),
        c_dot_Dz=[],
        t_begin=t,
        t_end=t,
        converged=True,
    )

    ctx = _get_ctx(geometry, spec, Qset.barrier, c, subspace=subspace,
                   newton_cap=newton_cap)
    z, SOL_main, log = _path_follow(
        ctx,
        z0,
        t,
        1.0 / tol,
        kappa,
        maxit,
        theta=0.25,
        final_lam2=tol ** 2 * 100.0,
        verbose=verbose,
        logfile=logfile,
        phase="main",
    )
    return AMGBSOL(
        z=z,
        SOL_feasibility=SOL_feasibility,
        SOL_main=SOL_main,
        log=log,
        geometry=geometry,
    )
