"""The plain judge of a solve: is z a point of the stated problem, on its
central path at t = 1/tol to the float64 floor, and is the objective the
solver reports the objective of z?

The problem (the configuration's): minimise J(z) = sum_i w_i c(x_i).(Dz)_i
over z in z_g + V, with (Dz)_i inside each of the problem's cones
||q||^p <= s at every point, V the continuous nodal space vanishing on the
boundary.  A cone's q are rows of Dz, less the point's aux value where the
cone says so (the time step's (u - u_prev)^2 <= s2).  The solver follows
the central path of t J + sum_i w_i F(Dz_i) to t = 1/tol, F the sum of the
cones' barriers -log(s^(2/p) - |q|^2) - beta log s, beta = max(0, 2 - 2/p)
(at p = 1: -log(s^2 - |q|^2)).

Everything here is worked out again from the mesh of mesh.py and the data
callables' coefficients: the program's iterate z and its reported objective
are read only to be judged.  The numbers (each compared with a limit by the
harness):

  infeasible    points where Dz lies outside a cone by more than twice
                the rounding bound of a D z computation (gamma_nq |D| |z|
                per entry): the solver decides feasibility on its own D z,
                the judge on its own, each within one bound of the exact
                value; at the float64 floor the margin s^2 - |q|^2 of a
                sound answer sits at ~1e-16 and its sign is the rounding's
  subspace_err  how far z - z_g is from V: jumps between elements at shared
                nodes, values on the boundary, centroid values off the P2
                interpolant (2D), over max |z|
  decrement     the Newton decrement g^T H^{-1} g of the barrier problem
                t J + sum_i w_i F(Dz_i) at z and t = 1/tol (the solver's own
                measure of how far an iterate is from the central point):
                a solve that ends on the central path at 1/tol reads it at
                the float64 floor; a start left where it was, a path cut
                short by orders of magnitude in t, a lower precision or a
                solve of another problem read it orders of magnitude
                higher.  It does not bound J(z) - min J to 1/tol: the
                weighted barrier is self-concordant only over its least
                weight
  obj_rel       the program's reported objective against J(z)

The decrement's system is factored densely (torch Cholesky of the matrix
scaled to a unit diagonal) on the device it is given: one factor a judged
iterate.  Where the dense matrix would take more than a quarter of the
card's memory (fem2d L=8: 130,050 dofs, 135 GB), the same matrix is
numbered node by node with the fields interleaved, which makes it a band
(half-bandwidth 1,025 at fem2d L=8), and factored as a block tridiagonal
matrix of blocks wider than the band, block by block, with the same
scaling and the same shifts.  At 1/tol the matrix spans some 1e18 in scale (the cone's
margins in the flat parts of the solution are ~1e-16) and rounds to
indefinite: the factor takes the least shift of the unit diagonal, from
1e-15 up by tens, that it accepts; a shift only lowers the decrement.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .mesh import Mesh


@dataclasses.dataclass(frozen=True)
class Cone:
    """||q||^p <= s at every point: q the rows `q` of Dz (less the point's
    aux value where `aux`), s the row `s`."""

    q: tuple
    s: int
    p: float = 1.0
    aux: bool = False


@dataclasses.dataclass
class Problem:
    """D rows as (field, op) with op 'id' or an axis 0..dim-1; the cones (a
    list of Cone); the published cost rows and the data callables in numpy:
    cost(x) (n, k) and start(x) (n, nfields)."""

    rows: list
    nfields: int
    cones: list
    cost: object
    start: object
    tol: float


def default_problem(dim: int, cost, start, tol: float) -> Problem:
    rows = [(0, "id")] + [(0, a) for a in range(dim)] + [(1, "id")]
    return Problem(rows, 2, [Cone(tuple(range(1, dim + 1)), dim + 1)], cost, start, tol)


def cone_derivs(q, s, m, p: float):
    """The gradient and Hessian of -log(s^(2/p) - |q|^2) - beta log s,
    beta = max(0, 2 - 2/p), over (q, s), in closed form: (gq (n, d), gs
    (n,), Hqq (n, d, d), Hqs (n, d), Hss (n,)); m stands for the margin
    s^(2/p) - |q|^2."""
    if p == 1.0:
        a, da, beta = 2 * s, 2.0, 0.0  # d(s^2)/ds and its derivative
    else:
        e = 2.0 / p
        a, da, beta = e * s ** (e - 1), e * (e - 1) * s ** (e - 2), max(0.0, 2.0 - e)
    m2 = m * m
    eye = torch.eye(q.shape[1], dtype=q.dtype, device=q.device)
    gq = 2 * q / m[:, None]
    gs = -a / m
    Hqq = 2 * eye / m[:, None, None] + 4 * q[:, :, None] * q[:, None, :] / m2[:, None, None]
    Hqs = -2 * a[:, None] * q / m2[:, None]
    Hss = -da / m + a * a / m2
    if beta:
        gs = gs - beta / s
        Hss = Hss + beta / (s * s)
    return gq, gs, Hqq, Hqs, Hss


def dense_fits(n: int, dtype, device) -> bool:
    """Whether the dense n x n Hessian takes at most a quarter of the card's
    memory (on the CPU: always; the CPU judges only test sizes)."""
    device = torch.device(device)
    if device.type != "cuda":
        return True
    card = torch.cuda.get_device_properties(device).total_memory
    return n * n * torch.finfo(dtype).bits // 8 <= card // 4


class Judge:
    """The mesh, the problem and the Newton system's index maps, on one
    device, built once per run and applied to every solve.  band: factor
    the system as a band (True), densely (False), or densely where that
    fits a quarter of the card (None)."""

    def __init__(self, mesh: Mesh, prob: Problem, device="cpu", dtype=torch.float64,
                 band=None):
        self.mesh, self.prob, self.dev = mesh, prob, torch.device(device)
        dt = self.dtype = dtype
        T = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=self.dev)  # noqa: E731
        self.x_np = mesh.x
        self.w = T(mesh.w)
        self.grad = [T(G) for G in mesh.grad]
        self.c = T(prob.cost(mesh.x))
        self.zg = T(prob.start(mesh.x))
        ne, nq, nl, nf, k = mesh.nelem, mesh.nq, mesh.interp.shape[1], prob.nfields, len(prob.rows)
        self.ne, self.nq, self.nl, self.nf, self.k = ne, nq, nl, nf, k
        # P[e, q, j, f*nl + a]: row j of D applied to the nodal basis function a of field f
        interp = T(mesh.interp)
        P = torch.zeros((ne, nq, k, nf * nl), dtype=dt, device=self.dev)
        for j, (f, op) in enumerate(prob.rows):
            B = interp.expand(ne, nq, nl) if op == "id" else self.grad[op] @ interp
            P[:, :, j, f * nl:(f + 1) * nl] = B
        self.P = P
        # dofs: interior nodes, numbered per field
        interior = ~mesh.boundary
        dof = np.full(mesh.boundary.shape[0], -1, np.int64)
        dof[interior] = np.arange(int(interior.sum()))
        self.ndof = int(interior.sum())
        ed = dof[mesh.node_of]  # (ne, nl)
        edf = np.concatenate([np.where(ed >= 0, ed + f * self.ndof, -1) for f in range(nf)], axis=1)
        self.edof = torch.as_tensor(edf, device=self.dev)  # (ne, nf*nl), -1 on the boundary
        self.N = nf * self.ndof
        self.band = not dense_fits(self.N, dt, self.dev) if band is None else bool(band)
        if self.band:
            # the same dofs numbered node by node, the fields interleaved: the
            # nodes are in coordinate order, so an element's dofs lie close
            ebf = np.concatenate([np.where(ed >= 0, ed * nf + f, -1) for f in range(nf)], axis=1)
            keep = ebf >= 0
            hi = np.where(keep, ebf, -1).max(axis=1)
            lo = np.where(keep, ebf, self.N).min(axis=1)
            self.B = int((hi - lo)[keep.any(axis=1)].max()) + 1  # block size > half-bandwidth
            self.nb = -(-self.N // self.B)
            self.ebdof = torch.as_tensor(ebf, device=self.dev)

    # -- pointwise -----------------------------------------------------------

    def apply_D(self, z):
        ze = z.reshape(self.ne, self.nq, self.nf)
        cols = []
        for f, op in self.prob.rows:
            v = ze[:, :, f]
            cols.append(v if op == "id" else torch.einsum("eqr,er->eq", self.grad[op], v))
        return torch.stack(cols, dim=-1).reshape(-1, self.k)

    def cone_values(self, y, aux=None):
        """Each cone's (q (n, d), s (n,), p) at the points' D z values y;
        aux (n,): the points' aux column, for the cones that take it."""
        out = []
        for c in self.prob.cones:
            q = y[:, list(c.q)]
            if c.aux:
                q = q - aux[:, None]
            out.append((q, y[:, c.s], c.p))
        return out

    def margins(self, y, aux=None):
        """Each cone's s^(2/p) - |q|^2."""
        return [(s * s if p == 1.0 else s ** (2.0 / p)) - (q * q).sum(1)
                for q, s, p in self.cone_values(y, aux)]

    def barrier_value(self, y, aux=None):
        """sum over the cones of -log(s^(2/p) - |q|^2) - beta log s per
        point, or None where a point lies outside a cone."""
        F = 0.0
        for (q, s, p), m in zip(self.cone_values(y, aux), self.margins(y, aux)):
            if bool((m <= 0).any() | (s <= 0).any()):
                return None
            F = F - torch.log(m)
            beta = max(0.0, 2.0 - 2.0 / p)
            if beta:
                F = F - beta * torch.log(s)
        return F

    def rounding(self, z):
        """A bound on |fl(D z) - D z| per entry: gamma_nq |D| |z| (the id rows are exact)."""
        g = self.nq * torch.finfo(z.dtype).eps
        g = g / (1 - g)
        za = z.abs().reshape(self.ne, self.nq, self.nf)
        cols = [torch.zeros_like(za[:, :, f]) if op == "id"
                else g * torch.einsum("eqr,er->eq", self.grad[op].abs(), za[:, :, f])
                for f, op in self.prob.rows]
        return torch.stack(cols, dim=-1).reshape(-1, self.k)

    def barrier_derivs(self, y, m=None, aux=None):
        """F' (n, k) and F'' (n, k, k) of the cones' barriers summed, zero
        off the cone rows; m, if given, stands for the cones' margins (a
        list, as margins gives them)."""
        n = y.shape[0]
        if m is None:
            m = self.margins(y, aux)
        F1 = torch.zeros((n, self.k), dtype=y.dtype, device=y.device)
        F2 = torch.zeros((n, self.k, self.k), dtype=y.dtype, device=y.device)
        for c, (q, s, p), mc in zip(self.prob.cones, self.cone_values(y, aux), m):
            nc = len(c.q) + 1
            gq, gs, Hqq, Hqs, Hss = cone_derivs(q, s, mc, p)
            g = torch.zeros((n, nc), dtype=y.dtype, device=y.device)
            g[:, :-1] = gq
            g[:, -1] = gs
            H = torch.zeros((n, nc, nc), dtype=y.dtype, device=y.device)
            H[:, :-1, :-1] = Hqq
            H[:, :-1, -1] = Hqs
            H[:, -1, :-1] = Hqs
            H[:, -1, -1] = Hss
            ci = torch.as_tensor(list(c.q) + [c.s], device=y.device)
            F1[:, ci] += g
            F2[:, ci[:, None], ci[None, :]] += H
        return F1, F2

    # -- the subspace ----------------------------------------------------------

    def subspace_err(self, z, zg=None):
        d = (z - (self.zg if zg is None else zg)).reshape(self.ne, self.nq, self.nf)
        node_pts = torch.as_tensor(self.mesh.node_pts, device=self.dev)
        dn = d[:, node_pts, :]  # (ne, nl, nf) nodal values
        node = torch.as_tensor(self.mesh.node_of, device=self.dev).reshape(-1)
        flat = dn.reshape(-1, self.nf)
        nn = self.mesh.boundary.shape[0]
        hi = torch.full((nn, self.nf), -torch.inf, dtype=z.dtype, device=self.dev)
        lo = torch.full((nn, self.nf), torch.inf, dtype=z.dtype, device=self.dev)
        hi = hi.scatter_reduce(0, node[:, None].expand_as(flat), flat, "amax")
        lo = lo.scatter_reduce(0, node[:, None].expand_as(flat), flat, "amin")
        jump = (hi - lo).abs().max()
        bnd = torch.as_tensor(self.mesh.boundary, device=self.dev)
        edge = hi[bnd].abs().max().clamp_min(lo[bnd].abs().max())
        interp = torch.as_tensor(self.mesh.interp, dtype=z.dtype, device=self.dev)
        off = (torch.einsum("qa,eaf->eqf", interp, dn) - d).abs().max()
        scale = z.abs().max().clamp_min(1e-300)
        return float(torch.stack([jump, edge, off]).max() / scale)

    # -- the Newton system of the barrier problem -----------------------------

    def _scatter(self, ve):
        """(ne, nf*nl) element vectors -> (N,) dof vector, boundary left out."""
        keep = self.edof >= 0
        out = torch.zeros(self.N, dtype=ve.dtype, device=self.dev)
        return out.index_add_(0, self.edof[keep], ve[keep])

    def to_points(self, v):
        """(N,) dof vector -> (n, nfields) point values of the nodal function."""
        keep = self.edof >= 0
        ve = torch.where(keep, v[self.edof.clamp_min(0)], torch.zeros((), dtype=v.dtype, device=self.dev))
        interp = torch.as_tensor(self.mesh.interp, dtype=v.dtype, device=self.dev)
        ve = ve.reshape(self.ne, self.nf, self.nl)
        return torch.einsum("qa,efa->eqf", interp, ve).reshape(-1, self.nf)

    def _elements(self, y, t, m=None, aux=None):
        """The element gradients (ne, nf*nl) and Hessians (ne, nf*nl, nf*nl)
        of t J + sum w F at y (m, aux: as in barrier_derivs)."""
        F1, F2 = self.barrier_derivs(y, m, aux)
        w = self.w
        ge = torch.einsum("eqj,eqjc->ec",
                          (w[:, None] * (t * self.c + F1)).reshape(self.ne, self.nq, self.k), self.P)
        WF = (w[:, None, None] * F2).reshape(self.ne, self.nq, self.k, self.k)
        He = torch.einsum("eqjc,eqjl,eqld->ecd", self.P, WF, self.P)
        return ge, He

    def system(self, y, t, m=None, aux=None):
        """The gradient g (N,) and the dense Hessian H (N, N) of
        t J + sum w F at y, over the dofs of V (m, aux: as in
        barrier_derivs)."""
        ge, He = self._elements(y, t, m, aux)
        g = self._scatter(ge)
        keep = self.edof >= 0
        C = self.edof.shape[1]
        pair = keep[:, :, None] & keep[:, None, :]
        rows = self.edof[:, :, None].expand(-1, C, C)[pair]
        cols = self.edof[:, None, :].expand(-1, C, C)[pair]
        H = torch.zeros(self.N * self.N, dtype=y.dtype, device=self.dev)
        H.index_add_(0, rows * self.N + cols, He[pair])
        return g, H.reshape(self.N, self.N)

    def factor(self, H):
        """H scaled in place to a unit diagonal and its Cholesky factor, with
        the least shift of that diagonal, from five roundings (1e-15 in
        float64) up by tens, that the factor accepts: (factor or None,
        scale, shift)."""
        fi = torch.finfo(H.dtype)
        dsc = H.diagonal().abs().clamp_min(fi.tiny).rsqrt()
        H.mul_(dsc[:, None]).mul_(dsc[None, :])
        first = float(f"{5 * fi.eps:.0e}")
        shift, added = first, 0.0
        while True:
            H.diagonal().add_(shift - added)
            added = shift
            Lc, info = torch.linalg.cholesky_ex(H)
            if int(info) == 0:
                return Lc, dsc, shift
            if shift >= 1e4 * first:
                return None, dsc, shift
            shift *= 10

    def decrement2(self, y, t, m=None, aux=None):
        """(g^T H^{-1} g of t J + sum w F at y over the dofs of V, the
        diagonal shift the factor took)."""
        if self.band:
            return self.band_decrement2(y, t, m, aux)
        g, H = self.system(y, t, m, aux)
        Lc, dsc, shift = self.factor(H)
        del H
        if Lc is None:
            return float("inf"), shift
        u = torch.linalg.solve_triangular(Lc, (g * dsc)[:, None], upper=False)
        return float((u * u).sum()), shift

    # -- the same system as a band, for an N whose dense matrix does not fit --

    def band_system(self, y, t, m=None, aux=None):
        """g (N,) in the interleaved numbering, and H in it as a block
        tridiagonal matrix of nb blocks of B: diagonal blocks D (nb, B, B),
        sub-diagonal blocks E (nb, B, B), E[i] the rows of block i + 1 and
        the columns of block i.  The dofs past N that fill the last block
        take a unit diagonal and nothing else."""
        ge, He = self._elements(y, t, m, aux)
        B, nb, C = self.B, self.nb, self.ebdof.shape[1]
        keep = self.ebdof >= 0
        g = torch.zeros(nb * B, dtype=y.dtype, device=self.dev)
        g.index_add_(0, self.ebdof[keep], ge[keep])
        pair = keep[:, :, None] & keep[:, None, :]
        r = self.ebdof[:, :, None].expand(-1, C, C)[pair]
        c = self.ebdof[:, None, :].expand(-1, C, C)[pair]
        v = He[pair]
        br, bc = r // B, c // B
        at = (r % B) * B + c % B
        D = torch.zeros(nb * B * B, dtype=y.dtype, device=self.dev)
        E = torch.zeros(nb * B * B, dtype=y.dtype, device=self.dev)
        on, low = br == bc, br == bc + 1
        D.index_add_(0, bc[on] * B * B + at[on], v[on])
        E.index_add_(0, bc[low] * B * B + at[low], v[low])
        D, E = D.view(nb, B, B), E.view(nb, B, B)
        pad = torch.arange(self.N, nb * B, device=self.dev)
        D.view(nb * B, B)[pad, pad % B] = 1.0
        return g, D, E

    def band_factor(self, D, E):
        """D and E scaled in place to a unit diagonal and their block
        Cholesky factor (L_i, and M_i = E_i L_i^-T below it), with the least
        shift of that diagonal, from five roundings up by tens, under which
        every diagonal block factors: (factor or None, scale, shift)."""
        fi = torch.finfo(D.dtype)
        nb, B = D.shape[0], D.shape[1]
        dsc = D.diagonal(dim1=1, dim2=2).abs().clamp_min(fi.tiny).rsqrt()  # (nb, B)
        D.mul_(dsc[:, :, None]).mul_(dsc[:, None, :])
        E[:-1].mul_(dsc[1:, :, None]).mul_(dsc[:-1, None, :])
        eye = torch.eye(B, dtype=D.dtype, device=D.device)
        first = float(f"{5 * fi.eps:.0e}")
        shift = first
        while True:
            Ls, Ms = [], []
            S = D[0] + shift * eye
            for i in range(nb):
                Li, info = torch.linalg.cholesky_ex(S)
                if int(info) != 0:
                    break
                Ls.append(Li)
                if i + 1 < nb:
                    Mi = torch.linalg.solve_triangular(Li, E[i].T, upper=False).T
                    Ms.append(Mi)
                    S = D[i + 1] + shift * eye - Mi @ Mi.T
            else:
                return (Ls, Ms), dsc.reshape(-1), shift
            if shift >= 1e4 * first:
                return None, dsc.reshape(-1), shift
            shift *= 10

    def band_decrement2(self, y, t, m=None, aux=None):
        """decrement2 through the block tridiagonal factor."""
        g, D, E = self.band_system(y, t, m, aux)
        fac, dsc, shift = self.band_factor(D, E)
        del D, E
        if fac is None:
            return float("inf"), shift
        Ls, Ms = fac
        b = (g * dsc).view(self.nb, self.B, 1)
        parts, u = [], None
        for i, Li in enumerate(Ls):
            r = b[i] if u is None else b[i] - Ms[i - 1] @ u
            u = torch.linalg.solve_triangular(Li, r, upper=False)
            parts.append((u * u).sum())
        return float(torch.stack(parts).sum()), shift

    # -- the judgement -----------------------------------------------------------

    def judge(self, z, reported_obj: float, start=None, aux=None) -> dict:
        """The numbers of z; start (n, nfields) replaces the problem's start
        data z_g where the solve began elsewhere (a time step's previous
        snapshot), aux (n,) is the points' aux column of the cones that take
        it."""
        z = torch.as_tensor(z, device=self.dev).to(self.dtype)
        if aux is not None:
            aux = torch.as_tensor(aux, device=self.dev).to(self.dtype)
        y = self.apply_D(z)
        J = float((self.w * (self.c * y).sum(1)).sum())
        r = 2 * self.rounding(z)
        eps = torch.finfo(self.dtype).eps
        outside = ~torch.isfinite(y).all(1)
        margins = []
        values = zip(self.prob.cones, self.cone_values(y, aux), self.margins(y, aux))
        for c, (q, s, p), m in values:
            bq, bs = r[:, list(c.q)], r[:, c.s]
            if c.aux:  # q = Dz - aux, one more rounding on each side
                bq = bq + 2 * eps * (y[:, list(c.q)].abs() + aux.abs()[:, None])
            qmin = (q.abs() - bq).clamp_min(0).norm(dim=1)
            if p == 1.0:
                outside |= (s + bs) <= qmin
                mb = 2 * (s.abs() * bs + (q.abs() * bq).sum(1)) + bs * bs
            else:
                e = 2.0 / p
                outside |= ((s + bs) <= 0) | ((s + bs).clamp_min(0) ** (1.0 / p) <= qmin)
                mb = ((s.abs() + bs) ** e - s.abs() ** e
                      + (2 * q.abs() * bq + bq * bq).sum(1))
            # a margin that rounds to <= 0 inside the rounding takes the
            # rounding's bound on it, so the barrier stays defined there
            margins.append(torch.where(m > 0, m, mb))
        infeasible = int(outside.sum())
        if start is not None:
            start = torch.as_tensor(start, device=self.dev).to(self.dtype)
        out = dict(infeasible=infeasible, subspace_err=self.subspace_err(z, start),
                   obj_rel=abs(reported_obj - J) / max(abs(J), 1e-300), objective=J)
        if infeasible:
            out.update(decrement=float("inf"), shift=0.0)
            return out
        out["decrement"], out["shift"] = self.decrement2(y, 1.0 / self.prob.tol, margins, aux)
        return out
