"""A plain barrier solve of the judged problem, for the tests at small
sizes: damped Newton steps on the finest nodal space alone, dense
Cholesky, the central path from t = 0.1 up by tens to 1/tol.  It shares
nothing with the program; the tests hold it to the repository's pinned
objectives, which ties the judge's mesh, operators, data and barrier to
them, and run it in float32 as the control the judge has to fail."""

from __future__ import annotations

import math

import torch

from .check import Judge


def barrier_objective(j: Judge, y, t):
    F = j.barrier_value(y)
    if F is None:
        return math.inf
    return float((j.w * (t * (j.c * y).sum(1) + F)).sum())


def solve(j: Judge, t0=0.1, kappa=10.0, max_newton=200):
    """z (n, nfields) on the central path at t = 1/tol, in j's dtype."""
    z = j.zg.clone()
    t_end = 1.0 / j.prob.tol
    t = t0
    while True:
        for _ in range(max_newton):
            y = j.apply_D(z)
            g, H = j.system(y, t)
            Lc, dsc, _ = j.factor(H)
            if Lc is None:
                raise RuntimeError(f"plain solve: no factor at t={t:.3e}")
            dv = -torch.cholesky_solve((g * dsc)[:, None], Lc)[:, 0] * dsc
            lam2 = float(-(g * dv).sum())
            dz = j.to_points(dv)
            phi0, alpha = barrier_objective(j, y, t), 1.0 / (1.0 + math.sqrt(max(lam2, 0.0)))
            while alpha > 1e-12:
                if barrier_objective(j, j.apply_D(z + alpha * dz), t) <= phi0 - 0.25 * alpha * lam2:
                    break
                alpha /= 2
            else:
                break  # no step lowers the barrier objective: the floor
            z = z + alpha * dz
            if lam2 < 1e-12:
                break
        if t >= t_end:
            return z
        t = min(t * kappa, t_end)
