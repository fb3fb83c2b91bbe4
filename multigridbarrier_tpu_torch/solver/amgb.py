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
gradient contraction and node sum (kernel C, read in the contraction's
own layout) -> element Hessians (kernel A, which applies the quadrature
weights to the F2 rows itself) -> deduplicated values (kernel C's segment
sum) -> a direct Newton direction -> damped Armijo line search that
rejects non-finite steps.  The direction comes from one of these routes:

* dense (level 0, and every level with nf*m <= backend.dense_threshold):
  dense Cholesky with a shift ladder and matrix-free refinement (the fused
  hvp kernel), linsolve.dense_solve;
* on every other level ("fine" levels), by MGB_FINE_SOLVER:
  - nd (the default): the multifrontal Cholesky of ndsolve.py (kernels C
    and D) with a two-trip factor-preconditioned CG polish on the exact
    pair-block matvec and a Jacobi fallback on a non-finite direction
    (_NDLevel, the JAX _get_nd direction; with MGB_ND_REUSE=1 a stale
    factor's PCG first, the JAX _run_level_nd_reuse); on a CUDA level off
    a mesh the fresh-factor direction is captured once into a CUDA graph
    and replayed (nd_graph_on);
  - host: host scipy SuperLU with factor reuse (hostsolve.HostDirectLevel,
    _HostLevel); the step's values and gradient go to the host in one copy
    and the direction comes back in one;
  - mgcg: multigrid-preconditioned CG (linsolve.mgcg_solve, _MGCGLevel):
    element Hessians at every sub-level of the level's MGB_MG_DEPTH-level
    cycle from the step's F2 rows (kernel A), the fused hvp as the CG
    operator, a two-grid cycle whose coarse level is solved by a dense
    Cholesky or, above MGB_MGCG_COARSE_CAP, by the nested-dissection
    factor; the smoother's eigenvalue estimates and the previous direction
    (the CG warm start) are carried across a level run;
* linear_solver=custom: every level assembles its dense matrix H
  (linsolve.dense_assemble) and takes the direction custom(H, -g).

The Newton loop and the line search are host loops: each Newton step
reads its scalars (decrement, barrier objective, c.Dz and the ND
direction's finiteness) in one copy and one more value per line-search
trial, and the dense route also the Cholesky status; every host read of
the solve path goes through runtime/telemetry.read, which counts it, and
the step's phases are telemetry spans; the nested-dissection
factor and solve do not sync (the stale-factor PCG of MGB_ND_REUSE=1 does,
once per CG iteration); the mgcg route syncs once per CG iteration
for its exit test.

amgb runs two phases: when the start point is not strictly feasible, a
feasibility phase first follows the path of the problem augmented with one
slack field (barrier = the set's cobarrier, cost = the original cost plus
M times the slack) until the iterate is strictly inside the set; then the
main phase.  aux= appends per-row data columns to the coordinates that the
pointwise callables f, g and the barrier see (the time stepper of
solver/parabolic.py passes the previous snapshot this way); the
nested-dissection ordering reads the geometry's coordinates only.

Mixed precision (mixed=True, or MGB_F32_EARLY=1 where the fine level is
above dense_threshold): the path up to t = MGB_T_SWITCH (1e5) follows in
float32 on a memoised float32 twin of the geometry (dense_threshold=0, so
every level above 0 takes the fine route in float32), and hands its
iterate, blended toward the float64 start where the cast leaves the cone,
to the float64 context, which finishes the path; a failure of either leg
falls back to the float64 path from the start.

On a mesh (Backend.mesh, one process per rank, every rank calling amgb on
the same arguments) the solver context keeps this rank's block of the
padded element axis: P, the bases' idx and rloc, the operator blocks, x, w,
c and the iterate z; node vectors and the Newton direction are replicated.
Every sum over elements goes through runtime.dist.ordered_sum (per Newton
step: cy, fy0 and the gradient in one, the assembled values in one, c . dY
with the first line-search trial, one per further trial), so every rank
branches on the same host floats.  The dense and nested-dissection
directions are computed on every rank from the same values (the ND factor
splits its larger front groups over the ranks); the host route solves on
rank 0 and broadcasts the direction.  AMGBSOL.z is the whole iterate,
gathered on every rank.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.func import grad, hessian, vmap

from ..fem.geometry import Geometry
from ..options import ND_KNOBS, SolverOptions  # noqa: F401  (ND_KNOBS: re-exported for the tests)
from ..runtime import cuda_kernels, dist, telemetry
from ..runtime.blockdiag import BlockDiagOp
from ..runtime.cuda_kernels import GatherPlan, HePlan, SegmentPlan
from .convex import Convex, convex_Euclidian_power
from .hostsolve import HostDirectLevel, HostPattern
from .linsolve import (
    LevelSystem,
    NDCoarse,
    Transfer,
    dense_assemble,
    dense_solve,
    he_to_vals,
    mgcg_solve,
    vals_table,
)
from .ndsolve import NDFactorizer, NDSymbolic, narrow_idx, nd_grouping, node_coords

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
_CO_BARRIER_CACHE: dict = {}


def _co_barrier_for(Qset: Convex, k: int) -> Callable:
    """Memoized phase-1 barrier wrapper for (Qset, k): the solver contexts
    are cached by barrier identity, and a fresh closure per amgb call would
    make every infeasible-start solve build a new context."""
    key = (Qset, k)
    fn = _CO_BARRIER_CACHE.get(key)
    if fn is None:

        def fn(xi, ya, _Q=Qset, _k=k):
            return _Q.cobarrier(xi, ya[:_k], ya[_k])

        _CO_BARRIER_CACHE[key] = fn
    return fn


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


def _pcg_trip(matvec, apply_fac, xv, r, p, rz):
    """One trip of the factor-preconditioned CG of the ND directions (the
    JAX loop body), branch-free: a breakdown (pAp or rz not positive and
    finite) leaves xv and p where they were.  Returns (xv, r, p, rz, ok)."""
    zero, one = rz.new_zeros(()), rz.new_ones(())
    Ap = matvec(p)
    pAp = torch.dot(p, Ap)
    ok = torch.isfinite(pAp) & (pAp > 0) & torch.isfinite(rz) & (rz > 0)
    al = torch.where(ok, rz / torch.where(ok, pAp, one), zero)
    xv = xv + al * p
    r = r - al * Ap
    z = apply_fac(r)
    rz2 = torch.dot(r, z)
    beta = torch.where(ok & (rz2 > 0), rz2 / torch.where(ok, rz, one), zero)
    return xv, r, torch.where(ok, z + beta * p, p), rz2, ok


def nd_graph_on(device, mesh=None) -> bool:
    """Whether an ND level whose tensors live on `device` (factor split
    over `mesh`) replays its fresh-factor direction from a CUDA graph: on
    a CUDA device off a mesh and without MGB_ND_DEBUG_FRONTS.  Everything
    else stays eager: the CPU, a mesh (gloo cannot capture) and the debug
    fronts (not a direction)."""
    return (torch.device(device).type == "cuda" and mesh is None
            and os.environ.get("MGB_ND_DEBUG_FRONTS") != "1")


class _NDLevel:
    """Nested-dissection Newton direction of one level: the JAX
    _SolverCtx._get_nd state and make_direction(None, n_cg) — factor,
    solve, a factor-preconditioned CG polish of MGB_ND_PCG (2) trips on the
    exact pair-block matvec, kept only where its quadratic model is lower,
    and a Jacobi fallback when the direction is not finite.  Branch-free on
    the device: nothing in direction() syncs with the host.

    Where nd_graph_on (a CUDA level off a mesh), the level's first fresh
    direction captures that whole computation into a CUDA graph over
    static copies of vals and gv, and every fresh direction after it
    copies its inputs in and replays the graph: the same kernels and
    library calls in the same order, so the same bits as the eager
    direction, for one launch where the eager one makes ~1,000.

    MGB_ND_REUSE=1 (the JAX _run_level_nd_reuse): the level keeps its last
    factor, and a Newton step first tries a PCG on the exact matvec
    preconditioned by that stale factor (stale()); the direction is taken
    only where its relative residual is at most cg_rtol * 1.0001, else the
    level refactors.  The JAX policy, per level run (begin()): at most
    MGB_ND_STALE_CAP (40) reuses in a row, a PCG trip cap of
    min(MGB_ND_REUSE_CAP (30), 14) and then max(8, 2 * its + 4) after each
    success, and two failed attempts in a row retire reuse for the run.
    The PCG reads its exit test on the host once per iteration (the JAX
    while_loop's condition), and the refactor decision reads the relative
    residual once.  A step's log entry carries its own direction's PCG
    iterations and residual (JAX's trace puts them one step earlier, and
    JAX computes one more direction after a run's last step)."""

    def __init__(self, basis, nf: int, x: torch.Tensor, mesh=None):
        """basis: the whole level's basis; x: the geometry's quadrature-point
        coordinates (n, dim), never the rows with aux columns appended: the
        bisection runs over every column it is given, and the elimination
        order must not change with the data.  mesh: the factor's front
        groups split over its ranks."""
        m = basis.m
        idx = basis.idx.cpu().numpy()
        dev = basis.idx.device
        # the front groups are priced as replayed wherever the level could
        # replay (off a mesh), so that the debug fronts keep the grouping
        # of the run they show
        sym = NDSymbolic(idx, m, nf, node_coords(idx, m, x.cpu().numpy(), basis.nq),
                         leaf=int(os.environ.get("MGB_ND_LEAF", "16")),
                         grouping=nd_grouping(dev, replayed=mesh is None))
        self.m, self.nf = m, nf
        # CG trips of the polish (the JAX CPU default; JAX's accelerator
        # default of 0 is not taken)
        self.n_cg = int(os.environ.get("MGB_ND_PCG", "2"))
        self.reuse = os.environ.get("MGB_ND_REUSE", "0") == "1"
        self.stale_cap = int(os.environ.get("MGB_ND_STALE_CAP", "40"))
        self.cap_max = int(os.environ.get("MGB_ND_REUSE_CAP", "30"))
        self.factors = self.reused = 0  # directions of each kind, over the level's life
        self.finite = None  # whether the last fresh direction was finite (device bool), or None
        nvals = sym.nvals
        with telemetry.span("nd.plans"):
            self.fz = NDFactorizer(sym, dev, x.dtype, mesh=mesh)
            # static index maps, each bound once to a launch plan of kernel D or C
            self.pair_j = GatherPlan(narrow_idx(sym.pair_j, dev), m)
            self.pair_vidx = GatherPlan(narrow_idx(sym.pair_vidx, dev), nvals)
            self.pair_sum = SegmentPlan(None, narrow_idx(sym.pair_off, dev), len(sym.pair_j))
            # node-major per-dof diagonal ids: vals[(f*nf+f)*nuniq + diag_pid]
            self.diag_ids = narrow_idx(
                (
                    (np.arange(nf, dtype=np.int64) * (nf + 1))[None, :] * sym.nuniq
                    + sym.diag_pid[:, None]
                ).reshape(-1),
                dev,
            )
            self.diag = GatherPlan(self.diag_ids, nvals)
        # the captured direction, at the first fresh one: (graph, its
        # recorded launches, static (vals, gv), static (dvp, finite, fac))
        self.use_graph = nd_graph_on(dev, mesh)
        self.graph = None
        self.begin()

    def begin(self):
        """A level run starts: no stale factor, the reuse policy reset."""
        self.fac = None
        self.steps_since = self.fail_streak = 0
        self.cap = min(self.cap_max, 14)
        self.run_factors = self.run_reused = 0

    def matvec(self, vpair: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
        """Exact A @ x from the deduplicated pair blocks vpair (npair, nf*nf);
        x and the result are node-major (m*nf,)."""
        nf = self.nf
        xj = self.pair_j(xv.reshape(self.m, nf))
        contrib = torch.einsum("pfg,pg->pf", vpair.reshape(-1, nf, nf), xj)
        return self.pair_sum(contrib.contiguous()).reshape(-1)

    def step_direction(self, vals: torch.Tensor, gv: torch.Tensor, cg_rtol: float):
        """The Newton direction of one step, with the stale-factor PCG's
        iterations and relative residual (0 and 0.0 where none was tried).
        self.finite is then False on the device where the fresh direction
        was not finite and the Jacobi direction replaced it, None where the
        stale factor's direction was taken."""
        self.finite = None
        if self.reuse and self.fac is not None and self.fail_streak < 2 \
                and self.steps_since < self.stale_cap:
            with telemetry.span("nd.stale"):
                dvp, its, rel = self.stale(vals, gv, cg_rtol)
            if rel <= cg_rtol * 1.0001:  # sqrt-rounding slack on the gate
                self.reused += 1
                self.run_reused += 1
                self.steps_since += 1
                self.fail_streak = 0
                self.cap = min(self.cap_max, max(8, 2 * its + 4))
                return dvp, its, rel
            # the stale factor no longer certifies the direction: discard it
            # (never applied) and refactor
            self.fail_streak += 1
            return self.direction(vals, gv), its, rel
        return self.direction(vals, gv), 0, 0.0

    def _to_dvp(self, xv):
        m, nf = self.m, self.nf
        return torch.cat([xv.reshape(m, nf).T, xv.new_zeros((nf, 1))], dim=1)

    def stale(self, vals: torch.Tensor, gv: torch.Tensor, rtol: float):
        """PCG on the exact current Hessian preconditioned by the kept
        factor (the JAX nd_dir_r), to rtol or self.cap trips.  Returns
        (dvp, its, relres); relres is inf where the PCG broke down or the
        direction is not finite."""
        m = self.m
        b = -gv[:, :m].T.reshape(-1)
        vpair = self.pair_vidx(vals)

        def apply_fac(r):
            return self.fz.solve(self.fac, r).to(r.dtype)

        def matvec(v):
            return self.matvec(vpair, v)

        bb = torch.dot(b, b)
        tol2 = rtol ** 2 * bb
        xv = apply_fac(b)
        r = b - matvec(xv)
        p = apply_fac(r)
        rz, rr = torch.dot(r, p), torch.dot(r, r)
        its = 0
        while its < self.cap and telemetry.read(torch.isfinite(rr) & (rr > tol2), "nd.stale"):
            xv, r, p, rz, ok = _pcg_trip(matvec, apply_fac, xv, r, p, rz)
            # a breakdown (indefinite or NaN) poisons rr: the loop exits and
            # the caller refactors
            rr = torch.where(ok, torch.dot(r, r), torch.full_like(rr, math.inf))
            its += 1
        rel = torch.sqrt(torch.abs(rr) / torch.clamp_min(bb, 1e-300))
        rel = telemetry.read(torch.where(torch.isfinite(xv).all(), rel,
                                         torch.full_like(rel, math.inf)), "nd.stale")
        return self._to_dvp(xv), its, rel

    def direction(self, vals: torch.Tensor, gv: torch.Tensor) -> torch.Tensor:
        """vals (HostPattern layout), gv (nf, m+1) -> dvp (nf, m+1), the
        Newton direction for -gv with a zero pad slot, from a fresh factor:
        replayed from the level's graph where use_graph, else computed
        eagerly.  Under MGB_ND_REUSE=1 the factor is kept as the stale
        factor; after a replay it is the graph's own static factor, valid
        until the next replay, which is the next refactor."""
        if self.use_graph:
            with telemetry.span("nd.replay"):
                dvp, self.finite, fac = self._replay(vals, gv)
        else:
            dvp, self.finite, fac = self._fresh(vals, gv)
        if self.reuse:
            self.fac = fac
            self.factors += 1
            self.run_factors += 1
            self.steps_since = 0
        return dvp

    def _replay(self, vals: torch.Tensor, gv: torch.Tensor):
        """_fresh's (dvp, finite, fac) from the level's graph, captured at
        the first call; dvp and finite are copies, which no later replay
        overwrites."""
        if self.graph is None:
            self._capture(vals, gv)
        graph, recorded, (vals_in, gv_in), (dvp, finite, fac) = self.graph
        vals_in.copy_(vals)
        gv_in.copy_(gv)
        cuda_kernels.replay(graph, recorded)
        telemetry.count("nd.graph_replays")
        return dvp.clone(), finite.clone(), fac

    def _capture(self, vals: torch.Tensor, gv: torch.Tensor):
        """Capture _fresh into a CUDA graph over static copies of vals and
        gv (the pattern of linsolve._graph_loop): a first run on a side
        stream sets up the cuBLAS and cuSOLVER handles and workspaces that
        capture needs.  The graph keeps its intermediates in a memory pool
        of its own."""
        telemetry.build("nd_graph")
        static_in = (vals.clone(), gv.clone())
        side = torch.cuda.Stream(vals.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._fresh(*static_in)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = dict(cuda_kernels.CAPTURED)
        with torch.cuda.graph(graph):
            static_out = self._fresh(*static_in)
        recorded = {k: n - before[k] for k, n in cuda_kernels.CAPTURED.items() if n > before[k]}
        self.graph = (graph, recorded, static_in, static_out)

    def _fresh(self, vals: torch.Tensor, gv: torch.Tensor):
        """The fresh-factor direction computed eagerly: (dvp, finite, fac),
        finite False on the device where the direction was not finite and
        the Jacobi direction replaced it.  Reads and writes no host state,
        so that it can be captured."""
        m = self.m
        b = -gv[:, :m].T.reshape(-1)
        with telemetry.span("nd.factor"):
            fac = self.fz.factor(vals)
        vpair = self.pair_vidx(vals)

        def apply_fac(r):
            return self.fz.solve(fac, r)

        def matvec(v):
            return self.matvec(vpair, v)

        with telemetry.span("nd.solve"):
            xv = apply_fac(b)
            r = b - matvec(xv)
            p = apply_fac(r)
            rz = torch.dot(r, p)

        def q_of(v):
            return 0.5 * torch.dot(v, matvec(v)) - torch.dot(b, v)

        with telemetry.span("nd.polish"):
            xv_cg = xv
            for _ in range(self.n_cg):
                xv_cg, r, p, rz, _ = _pcg_trip(matvec, apply_fac, xv_cg, r, p, rz)
            # keep the polished direction only where its quadratic model is lower
            q_ir, q_cg = q_of(xv), q_of(xv_cg)
            take_cg = torch.isfinite(xv_cg).all() & torch.isfinite(q_cg) & (q_cg <= q_ir)
            xv = torch.where(take_cg, xv_cg, xv)
            # 1e-300 rounds to 0 in float32: its floor is the smallest normal
            dg = self.diag(vals).abs().clamp_min(max(1e-300, torch.finfo(vals.dtype).tiny))
            finite = torch.isfinite(xv).all()
            xv = torch.where(finite, xv, b / dg)
        return self._to_dvp(xv), finite, fac


class _HostLevel:
    """Host sparse direct Newton direction of one level (MGB_FINE_SOLVER=
    host; the JAX _get_host / _run_level_host direction): the level's
    HostPattern, its HostDirectLevel, and the previous direction of the
    current Newton iteration as the stale-CG start.  On a mesh rank 0
    solves and broadcasts the direction (the solver's stale-factor budget
    reads host clocks, so ranks solving on their own could differ)."""

    def __init__(self, basis, nf: int, mesh=None):
        self.m, self.nf, self.mesh = basis.m, nf, mesh
        self.pattern = HostPattern(basis.idx.cpu().numpy(), basis.m, nf)
        self.solver = HostDirectLevel(
            self.pattern, stale_cap=int(os.environ.get("MGB_HOST_STALE_CAP", "40")))
        self.x_prev = None

    def begin(self):
        """A new Newton iteration at this level: the acceptance bar goes
        back to rtol (the attainable accuracy belongs to the current t) and
        the warm start is dropped."""
        self.solver.rel_bar = self.solver.rtol
        self.x_prev = None

    def direction(self, vals: torch.Tensor, gv: torch.Tensor) -> torch.Tensor:
        """vals (HostPattern layout), gv (nf, m+1) -> dvp (nf, m+1), the
        Newton direction for -gv with a zero pad slot: one copy to the host,
        a float64 solve, one copy back."""
        nv = vals.numel()
        if dist.rank(self.mesh) == 0:
            host = telemetry.read(torch.cat([vals, gv.reshape(-1)]), "host.solve",
                                  numpy=True).astype(np.float64, copy=False)
            x, _, _ = self.solver.solve(host[:nv], -host[nv:], x0=self.x_prev)
        else:
            x = np.empty(gv.numel())
        if self.mesh is not None:
            x = telemetry.read(dist.broadcast(torch.from_numpy(x).to(gv.device), self.mesh),
                               "host.solve", numpy=True)
        self.x_prev = x
        dvp = torch.tensor(x.reshape(self.nf, self.m + 1), dtype=gv.dtype, device=gv.device)
        dvp[:, self.m] = 0.0
        return dvp


class _MGCGLevel:
    """Multigrid-preconditioned CG direction of one level
    (MGB_FINE_SOLVER=mgcg; the mgcg branch of the JAX _build_step and the
    state its Newton loop carries across a level run): the sub-levels of
    the level's cycle, their transfers, and the carried smoother
    eigenvalue estimates and previous direction (the CG warm start,
    MGB_CG_WARMSTART), both dropped when a level run begins."""

    def __init__(self, ctx, level: int):
        self.level = level
        self.subs = ctx._sub_levels(level)
        self.transfers = [ctx._transfer(sl) for sl in self.subs[:-1]]
        self.warmstart = os.environ.get("MGB_CG_WARMSTART", "1") != "0"
        self.begin()

    def begin(self):
        self.lmax = None
        self.dv = None

    def direction(self, ctx, F2v: torch.Tensor, gv: torch.Tensor):
        """The Newton direction for -gv (nf, m+1), with the CG iterations
        and relative residual: element Hessians at every sub-level from the
        shared rows F2v, then mgcg_solve."""
        last = len(self.subs) - 1
        systems = [ctx._mg_system(sl, ctx._he_plan(sl).weighted(F2v), coarse=i < last)
                   for i, sl in enumerate(self.subs)]
        dvp, its, rel, self.lmax = mgcg_solve(
            systems, self.transfers, -gv, ctx.spec.nfields, rtol=ctx.cg_rtol,
            maxiter=ctx.cg_maxiter, lmaxs_in=self.lmax,
            x0_in=self.dv if self.warmstart else None,
            coarse_nd=ctx._get_mgcg_ndcoarse(self.level))
        self.dv = dvp
        return dvp, its, telemetry.read(rel, "mgcg")


def _fine_solver() -> str:
    """The fine-level Newton solver MGB_FINE_SOLVER names: 'nd' (the
    default), 'host' or 'mgcg'."""
    name = os.environ.get("MGB_FINE_SOLVER", "nd")
    if name not in ("nd", "host", "mgcg"):
        raise ValueError(f"MGB_FINE_SOLVER={name!r}: expected 'nd', 'host' or 'mgcg'")
    return name


# ----------------------------------------------------------------------------
# Solver context
# ----------------------------------------------------------------------------


class _SolverCtx:
    """Per-(geometry, problem) solver state: the element-local operator
    tensors of every level and the Newton iteration on them.  On a mesh it
    holds this rank's block of the element axis (shard / gather move an
    iterate between the whole and the block); an element axis that does
    not divide the mesh is replicated with a warning and solved whole on
    every rank."""

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
        x: Optional[torch.Tensor] = None,
        linear_solver: Optional[Callable] = None,
        cg_rtol: float = 1e-9,
        cg_maxiter: int = 200,
    ):
        self.geometry = geometry
        self.spec = spec
        self.barrier = barrier
        self.linear_solver = linear_solver
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
        # compare every Newton step's decisions across the ranks of a mesh
        self.check_ranks = os.environ.get("MGB_MESH_CHECK", "0") == "1"
        # the mgcg route's CG forcing term and budget per Newton step (the
        # truncated two-grid cycle raises the budget to MGB_CG_MAXITER_DEEP)
        self.cg_rtol = float(os.environ.get("MGB_CG_RTOL", cg_rtol))
        self.cg_maxiter = int(os.environ.get("MGB_CG_MAXITER", cg_maxiter))

        g = geometry
        self.levels = len(g.bases[subspace])
        self.backend = be = g.backend
        # the mesh the element sums run over: None off a mesh, and on one
        # whose size does not divide the element axis (shard_rows warns and
        # every rank keeps the whole axis)
        self.mesh = be.mesh
        if self.mesh is not None and g.discretization.nelem % be.n_devices:
            be.shard_rows(g.bases[subspace][-1].idx)  # warns: replicated
            self.mesh = None
        self._block = (None if self.mesh is None
                       else dist.row_block(g.discretization.nelem, self.mesh))
        self.w = self.shard(g.w)
        self.ops = {
            k: op if op.is_identity or self.mesh is None
            else BlockDiagOp.from_blocks(be.shard_rows(op.blocks))
            for k, op in g.operators.items()
        }
        if self.mesh is not None and "id" in self.ops:
            self.ops["id"] = BlockDiagOp.identity(
                self._block[1] - self._block[0], g.discretization.nq, g.x.dtype, g.x.device)
        self.set_data(c, x)
        self._gbases = g.bases[subspace]  # the whole bases (host patterns, ND symbolic)
        self._bases = tuple(b.shard(self.mesh) for b in self._gbases)
        self._embeds = g.embed.get(subspace, ())
        nf = spec.nfields
        # Routing (the JAX _nd_enabled / _host_enabled): level 0 and levels
        # with nf*m <= dense_threshold solve densely, and every level does
        # with a custom linear_solver; every other level takes the route
        # MGB_FINE_SOLVER names, its state built at first use.
        fine = set() if linear_solver is not None else {
            lvl for lvl, basis in enumerate(self._bases)
            if lvl > 0 and nf * basis.m > self.backend.dense_threshold
        }
        route = _fine_solver() if fine else None
        self._nd_route = fine if route == "nd" else set()
        self._host_route = fine if route == "host" else set()
        self._mgcg_route = fine if route == "mgcg" else set()
        self.nd = {}  # level -> _NDLevel
        self.host = {}  # level -> _HostLevel
        self.mgcg = {}  # level -> _MGCGLevel
        self._tables = {}  # level -> linsolve.ValsTable
        self._he_plans = {}  # level -> HePlan (kernel A bound to P and w)
        self._mg_cache = {}  # level -> static plans of its LevelSystem in a cycle
        self._transfers = {}  # level -> Transfer of embed[level] (level -> level+1)
        self._ndc = {}  # level -> NDCoarse, the level as an mgcg cycle's coarse
        self.cg_last = (0, 0.0)  # CG iterations and relative residual of the last step

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

    def evaluate(self, z, t: float):
        """(phi, cy) at the iterate z (this rank's rows): the barrier
        objective t * c.Dz + sum(w * F0(Dz)) (padding rows masked) and c.Dz,
        summed over the ranks in rank order, as floats."""
        y = _apply_D(self.ops, self.spec, z)
        cy = torch.sum(self.w * torch.sum(self.c * y, dim=1))
        fy = _masked_wsum(self.w, vmap(self.barrier)(self.x, y))
        if self.mesh is not None:
            cy, fy = dist.ordered_sum(torch.stack([cy, fy]), self.mesh)
        phi, cy = telemetry.read(torch.stack([t * cy + fy, cy]), "predict")
        return phi, cy

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole point tensor (n, ...); t off a mesh."""
        if self.mesh is None:
            return t
        nq = self.geometry.discretization.nq
        return t[self._block[0] * nq:self._block[1] * nq]

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole point tensor from every rank's rows."""
        return dist.gather_rows(t, self.mesh)

    def set_data(self, c: torch.Tensor, x: Optional[torch.Tensor]):
        """The cost rows c and the coordinate rows x (None: the geometry's;
        with aux columns where given), both whole, kept as this rank's rows."""
        self.c = self.shard(c)
        self.x = self.shard(self.geometry.x if x is None else x)

    def step(self, level: int, z, t: float):
        """One damped Newton step at `level`.

        Returns (z_new, lam2, alpha, phi0, cy, dphi), the scalars as floats.
        alpha == 0 means the line search found no acceptable step; z is then
        returned unchanged."""
        telemetry.count("newton_steps")
        with telemetry.span("step"):
            return self._step(level, z, t)

    def _step(self, level: int, z, t: float):
        spec, ops, x, w, c = self.spec, self.ops, self.x, self.w, self.c
        nf, k = spec.nfields, spec.k
        basis = self._bases[level]
        Pl, idx, m = self._P[level], basis.idx, basis.m
        nelem, nq, nl = basis.nelem, basis.nq, basis.nl
        barrier = self.barrier

        with telemetry.span("step.grad"):
            y = _apply_D(ops, spec, z)
            cy = torch.sum(w * torch.sum(c * y, dim=1))
            fy0 = _masked_wsum(w, vmap(barrier)(x, y))

            # gradient rows -> one fused contraction -> node sum (kernel C)
            F1v = vmap(self._F1)(x, y)  # (n, k)
            gy = (w[:, None] * (t * c + F1v)).reshape(nelem, nq, k)
            gf = torch.einsum("eqj,eqjc->ec", gy, Pl)  # (nelem, nf*nl)
            if self.mesh is None:
                gv = basis.scatter_add_em(gf)  # (nf, m+1), pad column zeroed
            else:  # the three sums over the ranks in one collective
                gv = basis.table_plan.em(gf.contiguous())
                tot = dist.ordered_sum(torch.cat([cy[None], fy0[None], gv.reshape(-1)]), self.mesh)
                cy, fy0, gv = tot[0], tot[1], tot[2:].reshape(gv.shape)
            phi0 = t * cy + fy0

        # element Hessians (kernel A forms W = F2 * w), their deduplicated
        # values where the route reads them, and the Newton direction
        mgcg_route = level in self._mgcg_route
        with telemetry.span("step.hessian"):
            F2v = vmap(self._F2)(x, y)  # (n, k, k); its (k, k) blocks may be transposed
            if not (F2v.is_contiguous() or F2v.transpose(1, 2).is_contiguous()):
                F2v = F2v.contiguous()
            if not mgcg_route:
                He = self._he_plan(level).weighted(F2v)
            if level in self._nd_route or level in self._host_route:
                vals = self._vals(level, He)
        self.cg_last = (0, 0.0)
        finite = None  # the ND direction's own finiteness, read with the step's scalars
        if mgcg_route:
            if level not in self.mgcg:
                telemetry.build("mgcg_level")
                self.mgcg[level] = _MGCGLevel(self, level)
            with telemetry.span("mgcg.solve"):
                dvp, *cg = self.mgcg[level].direction(self, F2v, gv)
            self.cg_last = tuple(cg)
        elif level in self._nd_route:
            if level not in self.nd:
                telemetry.build("nd_level")
                self.nd[level] = _NDLevel(self._gbases[level], nf, self.geometry.x, self.mesh)
            nd = self.nd[level]
            with telemetry.span("nd.direction"):
                dvp, *cg = nd.step_direction(vals, gv, self.cg_rtol)
            finite = nd.finite
            self.cg_last = tuple(cg)
        elif level in self._host_route:
            with telemetry.span("host.solve"):
                dvp = self.host[level].direction(vals, gv)
        else:
            sys_ = LevelSystem(He, idx, m, basis.scatter_idx, self._table(level),
                               basis.table_plan, mesh=self.mesh)
            with telemetry.span("dense.solve"):
                if self.linear_solver is None:
                    dvp = dense_solve(sys_, nf, -gv)
                else:
                    out = self.linear_solver(dense_assemble(sys_, nf), -gv.reshape(-1))
                    out = torch.as_tensor(out, dtype=gv.dtype, device=gv.device).reshape(nf, m + 1)
                    dvp = torch.cat([out[:, :m], out.new_zeros((nf, 1))], dim=1)
        lam2_t = -torch.dot(gv.reshape(-1), dvp.reshape(-1))

        # direction in Dz-space (fused contraction)
        dve = dvp[:, idx]  # (nf, nelem, nl)
        dve_flat = dve.permute(1, 0, 2).reshape(nelem, nf * nl)
        dY = torch.einsum("eqjc,ec->eqj", Pl, dve_flat).reshape(-1, k)
        c_dY = torch.sum(w * torch.sum(c * dY, dim=1))
        summed = self.mesh is None  # on a mesh, c_dY is summed with the first trial

        # the step's scalars in one copy, the ND direction's finiteness with them
        with telemetry.span("step.read"):
            scalars = [lam2_t, phi0, cy] + ([finite.to(lam2_t.dtype)] if finite is not None else [])
            host = telemetry.read(torch.stack(scalars), "step")
        lam2, phi0, cy_f = host[:3]
        if finite is not None and not host[3]:
            telemetry.count("nd_fallbacks")
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
            nonlocal c_dY, summed
            telemetry.count("ls_trials")
            with telemetry.span("ls.trial"):
                za = z + alpha * dz
                ya = _apply_D(ops, spec, za)
                fy = _masked_wsum(w, vmap(barrier)(x, ya))
                if not summed:  # c . dY rides with the first trial
                    c_dY, fy = dist.ordered_sum(torch.stack([c_dY, fy]), self.mesh)
                    summed = True
                elif self.mesh is not None:
                    fy = dist.ordered_sum(fy, self.mesh)
                dfy = fy - fy0
                return za, telemetry.read(t * alpha * c_dY + dfy, "ls.trial")

        def accept(alpha, dphi):
            return math.isfinite(dphi) and dphi <= -self.armijo * alpha * lam2

        with telemetry.span("step.line_search"):
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

    def _host_level(self, level: int) -> _HostLevel:
        if level not in self.host:
            telemetry.build("host_level")
            self.host[level] = _HostLevel(self._gbases[level], self.spec.nfields,
                                          self.backend.mesh)
        return self.host[level]

    def _table(self, level: int):
        """The level's ValsTable (the host route's own pattern there): the
        whole level's pattern, summing this rank's elements on a mesh."""
        if level not in self._tables:
            telemetry.build("vals_table")
            basis = self._gbases[level]
            pattern = self._host_level(level).pattern if level in self._host_route else None
            self._tables[level] = vals_table(basis.idx, basis.m, self.spec.nfields, pattern,
                                             rows=self._block)
        return self._tables[level]

    def _vals(self, level: int, He: torch.Tensor) -> torch.Tensor:
        """The level's deduplicated Newton values from this rank's element
        Hessians, summed over the ranks."""
        return dist.ordered_sum(he_to_vals(He, self._table(level)), self.mesh)

    def _he_plan(self, level: int) -> HePlan:
        """Kernel A bound to the level's P and the quadrature weights."""
        if level not in self._he_plans:
            telemetry.build("he_plan")
            self._he_plans[level] = HePlan(self._P[level], self.w)
        return self._he_plans[level]

    def _sub_levels(self, level: int):
        """The mgcg cycle of `level`: MGB_MG_DEPTH (3) levels ending at it
        (Chebyshev smoothing on the upper ones, an exact solve at the
        coarsest)."""
        mg_depth = int(os.environ.get("MGB_MG_DEPTH", "3"))
        return list(range(max(0, level - (mg_depth - 1)), level + 1))

    def _transfer(self, level: int) -> Transfer:
        """The embedding of level `level` into level + 1, bound once."""
        if level not in self._transfers:
            self._transfers[level] = Transfer(self._embeds[level])
        return self._transfers[level]

    def _mg_system(self, level: int, He: torch.Tensor, coarse: bool) -> LevelSystem:
        """The level's LevelSystem in an mgcg cycle: its tables and plans
        kept across Newton steps; a level that can become the cycle's
        coarsest carries its ValsTable."""
        b = self._bases[level]
        return LevelSystem(He, b.idx, b.m, b.scatter_idx,
                           self._table(level) if coarse else None, b.table_plan,
                           b.pair_idx, self._mg_cache.setdefault(level, {}),
                           mesh=self.mesh, npair=b.npair)

    def _get_mgcg_ndcoarse(self, level: int) -> Optional[NDCoarse]:
        """The nested-dissection factor of the coarse level of `level`'s
        truncated two-grid cycle where its dense factor would exceed
        MGB_MGCG_COARSE_CAP unknowns (the JAX _get_mgcg_ndcoarse); None
        where the cycle keeps the dense coarse.  Leaf MGB_ND_LEAF (16), as
        the fine ND route."""
        subs = self._sub_levels(level)
        if len(subs) < 3:
            return None
        lc = subs[-2]
        nf, basis = self.spec.nfields, self._gbases[lc]
        if nf * (basis.m + 1) <= int(os.environ.get("MGB_MGCG_COARSE_CAP", "4096")):
            return None
        if lc not in self._ndc:
            idx = basis.idx.cpu().numpy()
            sym = NDSymbolic(idx, basis.m, nf,
                             node_coords(idx, basis.m, self.geometry.x.cpu().numpy(), basis.nq),
                             leaf=int(os.environ.get("MGB_ND_LEAF", "16")),
                             grouping=nd_grouping(basis.idx.device))
            self._ndc[lc] = NDCoarse(NDFactorizer(sym, basis.idx.device, self.geometry.x.dtype,
                                                  mesh=self.mesh), self._table(lc))
        return self._ndc[lc]

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

    def _check_ranks(self, level, kg, lam2, alpha, code):
        """MGB_MESH_CHECK=1: every rank must have taken this Newton step
        with the same (lam2, alpha, stop code), bit for bit; a rank that
        differs would branch apart and hang the next collective."""
        v = torch.tensor([lam2, alpha, float(code)], dtype=torch.float64)
        got = telemetry.read(dist.gather_rows(v.to(self.geometry.x.device)[None], self.mesh),
                             "mesh_check", numpy=True)
        got = torch.from_numpy(got)
        if not bool((got.view(torch.int64) == v.view(torch.int64)).all()):
            raise RuntimeError(f"amgb: the ranks differ at level {level}, Newton step {kg}: "
                               f"(lam2, alpha, code) = {got.tolist()}")

    def run_level(self, level: int, z, t: float, theta2: float):
        """The Newton iteration at `level` until a stop code; returns
        (z, its, stop_code, traces)."""
        with telemetry.span("level.run"):
            return self._run_level(level, z, t, theta2)

    def _run_level(self, level: int, z, t: float, theta2: float):
        eps = torch.finfo(z.dtype).eps
        if level in self._host_route:
            self._host_level(level).begin()
        if level in self.mgcg:
            self.mgcg[level].begin()
        if level in self.nd:
            self.nd[level].begin()
        t_loop0 = time.perf_counter()
        tr = {key: [] for key in ("lam2", "alpha", "phi", "dphi", "cy", "cgits", "cgrel")}
        heartbeat = (bool(os.environ.get("MGB_ND_HEARTBEAT"))
                     and (level in self._nd_route or level in self._host_route))
        kg = 0
        while True:
            z, lam2, alpha, phi0, cy, dphi = self.step(level, z, t)
            if heartbeat:
                print(f"# newton L{level} it={kg} lam2={lam2:.3e} alpha={alpha:.3f} "
                      f"wall={time.time():.1f}", file=sys.stderr, flush=True)
            tr["lam2"].append(lam2)
            tr["alpha"].append(alpha)
            tr["phi"].append(phi0)
            tr["dphi"].append(dphi)
            tr["cy"].append(cy)
            tr["cgits"].append(self.cg_last[0])
            tr["cgrel"].append(self.cg_last[1])
            code = self._stop_code(tr, kg, lam2, alpha, phi0, theta2, eps)
            if self.mesh is not None and self.check_ranks:
                self._check_ranks(level, kg, lam2, alpha, code)
            kg += 1
            if code != self.RUNNING:
                break
            if kg >= self.newton_cap:
                code = self.CAPPED
                break
        nd = self.nd.get(level)
        if nd is not None and nd.reuse and os.environ.get("MGB_HOST_STATS"):
            print(f"# nd-reuse[level={level}] t={t:.3e} its={kg} factors={nd.run_factors} "
                  f"reused={nd.run_reused} loop={time.perf_counter() - t_loop0:.2f}s",
                  file=sys.stderr)
        if level in self._host_route and os.environ.get("MGB_HOST_STATS"):
            hs = self.host[level].solver  # its counters run over the level's life
            print(f"# host[level={level}] t={t:.3e} its={kg} factors={hs.n_factor} "
                  f"solves={hs.n_solve} t_factor={hs.t_factor:.2f}s t_solve={hs.t_solve:.2f}s "
                  f"| loop={time.perf_counter() - t_loop0:.2f}s", file=sys.stderr)
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
    early_stop: Optional[Callable] = None,
    verbose: bool = False,
    logfile=None,
    phase: str = "main",
    start_fine: bool = False,
):
    """Follow the central path from t0 to t_end at the levels of `ctx`.
    early_stop(z), if given, is asked after every completed t-stage and
    ends the path when it returns true (the feasibility phase stops as soon
    as the iterate is strictly feasible); such a path takes no final
    polish.  start_fine skips the first t's coarse-to-fine sweep (an
    iterate that is already on the central path: the float32 leg's
    hand-off)."""
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
    use_coarse = not start_fine
    retry_stage = 0
    locked_levels = set()  # levels locked at an earlier t: skip henceforth
    # MGB_PREDICT=1 (the JAX predictor, off by default): the central path
    # is z(t) = z* + a/t + O(1/t^2), so the two last converged iterates
    # extrapolate the next stage's start in 1/t (Richardson), guarded by a
    # finite barrier objective at the new t that is not above the plain
    # warm start's.  The JAX package rejected it as a default: the
    # extrapolated start sits near the cone boundary at low-weight
    # quadrature rows and can lock the path short of the objective.
    predict = os.environ.get("MGB_PREDICT", "0") == "1"
    predict_debug = bool(os.environ.get("MGB_PREDICT_DEBUG"))
    z_conv_prev = t_conv_prev = None  # converged pair behind the current t
    z_conv_cur = None  # converged iterate at the last completed t
    stage = None  # the open path.stage span: one t, its retries included
    try:
        while True:
            if stage is None:
                stage = telemetry.span("path.stage")
                stage.__enter__()
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
                            cgits=int(tr["cgits"][i]),
                            cgrel=float(tr["cgrel"][i]),
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
            stage.__exit__(None, None, None)
            stage = None
            cy_last = float(tr["cy"][nits - 1])
            c_dots.append(cy_last)
            emit(f"[amgb:{phase}] t={t:.4e} its={its.tolist()} c_dot_Dz={cy_last:.10e}")
            use_coarse = False
            retry_stage = 0

            if early_stop is not None and early_stop(z):
                break
            if t >= t_end * (1 - 1e-12):
                break
            t_done = t
            kap = min(user_kappa, kap * kap) if kap < user_kappa else user_kappa
            t = min(t_done * kap, t_end)
            z_done = z  # converged iterate at t_done
            if predict and z_conv_prev is not None:
                # 0.8 backs off from the full extrapolation, which aims at
                # z(t) itself, whose margins are ~1/kappa of the current ones;
                # gamma halves toward the plain warm start (gamma = 0)
                gam = 0.8 * (1.0 / t - 1.0 / t_done) / (1.0 / t_done - 1.0 / t_conv_prev)
                dz_path = z_done - z_conv_prev
                phi_base = ctx.evaluate(z_done, t)[0]
                for _ in range(3):
                    z_try = z_done + gam * dz_path
                    phi_try = ctx.evaluate(z_try, t)[0]
                    ok_try = math.isfinite(phi_try) and phi_try <= phi_base
                    if predict_debug:
                        emit(f"[amgb:{phase}] predict t={t:.3e} gam={gam:.4f} "
                             f"phi_base={phi_base:.10e} phi_try={phi_try:.10e} accept={ok_try}")
                    if ok_try:
                        z = z_try
                        break
                    gam *= 0.5
            z_conv_prev, t_conv_prev = z_done, t_done
            z_conv_cur = z_done
    finally:
        if stage is not None:
            stage.__exit__(None, None, None)

    # Final polish at the finest level, only after a CONVERGED stage: a
    # stage that ended STALLED or LOCKED is already at the arithmetic floor.
    # c_dot_Dz is recorded per t-stage before the polish, so the cap on the
    # polish changes only how long the floor is ground.  A path that ends at
    # early_stop (the feasibility phase) takes no polish.
    if early_stop is None:
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


def _f32_twin(geometry: Geometry) -> Geometry:
    """Memoised float32 re-homing of a float64 geometry for the mixed
    path's float32 leg, kept on the geometry (so its solver contexts
    survive across amgb calls).  dense_threshold=0: in float32 the dense
    Cholesky falls apart at the conditioning the leg reaches, so every
    level above 0 takes the fine route (MGB_FINE_SOLVER) in float32."""
    tw = getattr(geometry, "_f32_twin_cache", None)
    if tw is None:
        tw = geometry.with_backend(
            dataclasses.replace(geometry.backend, dtype=torch.float32, dense_threshold=0))
        object.__setattr__(geometry, "_f32_twin_cache", tw)
    return tw


def _merge_phase_logs(a: PhaseLog, b: PhaseLog) -> PhaseLog:
    return PhaseLog(
        t_elapsed=a.t_elapsed + b.t_elapsed,
        ts=list(a.ts) + list(b.ts),
        its=a.its + b.its,
        c_dot_Dz=list(a.c_dot_Dz) + list(b.c_dot_Dz),
        t_begin=a.t_begin,
        t_end=b.t_end,
        converged=a.converged and b.converged,
    )


def _get_ctx(geometry: Geometry, spec, barrier, c, **kw):
    """Geometry-attached _SolverCtx cache, keyed by everything that shapes
    the context (options.SolverOptions: every MGB_* variable but the
    print-only ones; and the linear_solver
    callable itself included; of x, the rows with aux columns, only the
    number of columns); c and x are refreshed on every call, so a time
    stepper that changes its aux data each step keeps one context.  The
    key holds the callable, not its id(): a collected callable's id can be
    reused by another, which would then get its context."""
    x = kw.get("x")
    key = (
        spec,
        barrier,
        kw.get("subspace", "dirichlet"),
        kw.get("newton_cap", 200),
        kw.get("linear_solver"),
        SolverOptions.from_env(),
        None if x is None else x.shape[1],
    )
    ctx = geometry.ctx_cache.get(key)
    if ctx is None:
        telemetry.build("ctx")
        with telemetry.span("ctx.build"):
            ctx = _SolverCtx(geometry, spec, barrier, c, **kw)
        geometry.ctx_cache[key] = ctx
    else:
        ctx.set_data(c, x)
    return ctx


@telemetry.solve
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
    `z0` may be a tensor or a numpy array of shape (n, nfields); `aux`
    (n, na) is appended to the coordinates, so f, g and the barrier of Q
    receive rows [coords, aux].  A start point that is not strictly
    feasible goes through the feasibility phase first (SOL_feasibility).
    `linear_solver(H, b)`, if given, computes every Newton direction of
    both phases: H is the level's dense (N, N) Newton matrix, N = nf*(m+1),
    with an identity diagonal on the pad dofs, and b (N,) the negative
    gradient, both torch tensors on the geometry's device; it returns x
    with H x = b (the pad entries are set to zero after it).
    `mixed=True` follows the path up to t = MGB_T_SWITCH (1e5) in float32
    and finishes it in float64; mixed=None (the default) does so only with
    MGB_F32_EARLY=1 on a float64 solve whose fine level is above
    dense_threshold and that has no linear_solver.
    """
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
    if aux is not None:
        aux = torch.as_tensor(aux, dtype=dtype, device=device)
        x = torch.cat([x, aux.reshape(x.shape[0], -1)], dim=1)
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

    t_end = 1.0 / tol
    log = []
    ctx_kw = dict(subspace=subspace, newton_cap=newton_cap, x=None if aux is None else x,
                  linear_solver=linear_solver)

    # ---- Phase 1: feasibility --------------------------------------------
    ops = geometry.operators
    y0 = _apply_D(ops, spec, z0)
    # strict interiority <=> finite barrier (-log margin); the slack()
    # convention carries a +1 comfort margin that must not gate the skip: a
    # converged (near-boundary) iterate passed back in as z0 is feasible
    if telemetry.read(torch.isfinite(torch.sum(w * vmap(Qset.barrier)(x, y0))), "feasible"):
        z = z0
        SOL_feasibility = PhaseLog(
            t_elapsed=0.0,
            ts=[],
            its=np.zeros(geometry.levels, dtype=np.int64),
            c_dot_Dz=[],
            t_begin=t,
            t_end=t,
            converged=True,
        )
    else:
        # Augmented problem: one more field e with the D row (e, 'id'),
        # objective sum w * (c . Dz + M * e), barrier = the cobarrier.  The
        # original cost stays in: with a cost on e alone the objective is
        # unbounded below (the barrier's -log(s) terms reward sending slack
        # fields to infinity at no cost) and Newton descends for ever.  M
        # makes the reduction of infeasibility dominate.
        spec_aug = DSpec(
            entries=spec.entries + ((spec.nfields, "id"),),
            fieldnames=spec.fieldnames + ("_feas_slack",),
        )
        M = 10.0 * (1.0 + float(torch.max(torch.abs(c))))
        c_aug = torch.cat([c, c.new_full((c.shape[0], 1), M)], dim=1)
        e0 = vmap(Qset.slack)(x, y0)
        z0_aug = torch.cat([z0, e0[:, None]], dim=1)
        ctx1 = _get_ctx(geometry, spec_aug, _co_barrier_for(Qset, spec.k), c_aug, **ctx_kw)

        def feasible_now(z_aug):
            # on this rank's rows; the max and the sum over every rank's
            y = _apply_D(ctx1.ops, spec, z_aug[:, : spec.nfields])
            sl = vmap(Qset.slack)(ctx1.x, y)
            bsum = torch.sum(vmap(Qset.barrier)(ctx1.x, y))
            smax = dist.all_max(torch.max(sl), ctx1.mesh)
            fin = torch.isfinite(dist.ordered_sum(bsum, ctx1.mesh))
            return all(telemetry.read(torch.stack([smax < -1e-8, fin]), "feasible"))

        z_aug, SOL_feasibility, log1 = _path_follow(
            ctx1,
            ctx1.shard(z0_aug),
            t,
            t_end,
            kappa,
            maxit,
            theta=0.25,
            final_lam2=tol,
            early_stop=feasible_now,
            verbose=verbose,
            logfile=logfile,
            phase="feasibility",
        )
        log.extend(log1)
        if not feasible_now(z_aug):
            raise AMGBConvergenceFailure("amgb: feasibility phase failed")
        z = ctx1.gather(z_aug)[:, : spec.nfields].contiguous()

    # ---- Phase 2: main ------------------------------------------------------
    # Mixed precision: the early central path needs no float64 (at t <=
    # t_switch the barrier margins are ~1/t, far above float32 eps), so the
    # leg up to t_switch runs in float32 and hands its iterate to the
    # float64 context, which re-centres and finishes the path to 1/tol: the
    # final accuracy is the float64 endgame's.  Default off (the JAX
    # package measured the hand-off's re-centring to cost more float64
    # iterations than the leg saves); MGB_F32_EARLY=1 or mixed=True opts in.
    if mixed is None:
        m_fine = geometry.bases[subspace][-1].m
        mixed = (dtype == torch.float64 and linear_solver is None
                 and spec.nfields * m_fine > geometry.backend.dense_threshold
                 and os.environ.get("MGB_F32_EARLY", "0") == "1")
    t_switch = float(os.environ.get("MGB_T_SWITCH", "1e5")) if mixed else 0.0
    SOL_early = None
    t_orig, z_orig = t, z
    path_kw = dict(theta=0.25, verbose=verbose, logfile=logfile, phase="main")
    if mixed and t < t_switch and t_end > 10.0 * t_switch:
        g32 = _f32_twin(geometry)
        ctx32 = _get_ctx(g32, spec, Qset.barrier, c.float(), subspace=subspace, x=x.float(),
                         newton_cap=newton_cap)
        z_pre = z  # strictly feasible phase-2 entry iterate (the fallback anchor)
        try:
            z32, SOL_early, log_a = _path_follow(ctx32, ctx32.shard(z.float()), t, t_switch,
                                                 kappa, maxit, final_lam2=0.0625, **path_kw)
            z64 = ctx32.gather(z32).to(dtype)

            # Hand-off feasibility guard: the margins at t_switch are
            # ~1/t_switch, the order of float32 rounding on O(1) cone rows,
            # so the cast iterate can land just outside the cone.  The
            # margin is concave, so blending toward the strictly feasible
            # entry iterate re-enters the interior for small violations.
            def feasible64(zz):
                yy = _apply_D(ops, spec, zz)
                return telemetry.read(torch.isfinite(_masked_wsum(w, vmap(Qset.barrier)(x, yy))),
                                      "feasible")

            for theta_blend in (0.0, 1e-4, 1e-3, 1e-2, 1e-1):
                z_try = z64 if theta_blend == 0.0 else (1.0 - theta_blend) * z64 + theta_blend * z_pre
                if feasible64(z_try):
                    z, t = z_try, t_switch
                    log.extend(log_a)
                    maxit = max(maxit - int(SOL_early.its.sum()), 100)
                    break
            else:
                SOL_early = None  # unrecoverable cast: the full float64 path
        except AMGBConvergenceFailure:
            # the float32 leg hit its precision floor early: restart the
            # float64 path from the original iterate
            SOL_early = None
        if SOL_early is None:
            z = z_pre
    ctx = _get_ctx(geometry, spec, Qset.barrier, c, **ctx_kw)
    try:
        z, SOL_main, log2 = _path_follow(
            ctx, ctx.shard(z), t, t_end, kappa, maxit, final_lam2=tol ** 2 * 100.0,
            # resuming from the float32 leg's centred iterate: the coarse
            # sweep's job (getting onto the central path) is done
            start_fine=SOL_early is not None, **path_kw)
    except AMGBConvergenceFailure:
        if SOL_early is None:
            raise
        # the resumed leg starts at t_switch with no smaller successful t to
        # retreat to: if re-centring the hand-off fails, rerun the whole
        # phase in float64
        SOL_early = None
        z, SOL_main, log2 = _path_follow(ctx, ctx.shard(z_orig), t_orig, t_end, kappa, maxit,
                                         final_lam2=tol ** 2 * 100.0, **path_kw)
    z = ctx.gather(z)
    log.extend(log2)
    if SOL_early is not None:
        SOL_main = _merge_phase_logs(SOL_early, SOL_main)
    return AMGBSOL(
        z=z,
        SOL_feasibility=SOL_feasibility,
        SOL_main=SOL_main,
        log=log,
        geometry=geometry,
    )
