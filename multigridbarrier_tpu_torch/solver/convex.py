"""Convex-set descriptions and their self-concordant barriers (port of
solver/convex.py).

The solver minimizes a functional linear in Dz; all convexity enters through
a pointwise constraint Dz(x) in Q.  Only the scalar barrier F0 of one row is
written here; the solver takes its per-row gradient (F1) and Hessian (F2)
with torch.func, batched over rows with torch.func.vmap.

A `Convex` carries three per-row callables:

  barrier(x, y)      -> scalar; NaN outside the interior of Q
  cobarrier(x, y, e) -> barrier of the set relaxed by slack e (phase 1)
  slack(x, y)        -> a slack e0 that makes (x, y) comfortably interior
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Convex:
    barrier: Callable
    cobarrier: Callable
    slack: Callable


def convex_Euclidian_power(
    idx: Sequence[int],
    p=2.0,
    A: Callable | None = None,
    b: Callable | None = None,
) -> Convex:
    """Pointwise power-cone constraint ||q||^p <= s.

    idx[:-1] select the q components of y and idx[-1] the slack s.  With an
    affine map (A, b) the constraint applies to A(x) @ y + b(x) instead.

    Barrier: F = -log(s^(2/p) - ||q||^2) - beta * log(s), beta = max(0,
    2 - 2/p).  `p` may be a scalar or a callable p(x).
    """
    idx = tuple(int(i) for i in idx)

    def select(x, y):
        if A is not None:
            ysel = A(x) @ y
            if b is not None:
                ysel = ysel + b(x)
        else:
            ysel = torch.stack([y[i] for i in idx])
        return ysel[:-1], ysel[-1]

    def pval(x):
        return p(x) if callable(p) else p

    def _barrier_qs(x, q, s):
        pv = pval(x)
        if isinstance(pv, torch.Tensor):
            beta = torch.clamp(2.0 - 2.0 / pv, min=0.0)
        else:
            beta = max(0.0, 2.0 - 2.0 / pv)
        margin = s ** (2.0 / pv) - torch.sum(q * q)
        # INVARIANT: the beta * log(s) term must not be short-circuited at
        # beta == 0.  For p = 1 (beta = 0) the wrong cone branch s <= -|q|
        # has margin > 0, and the only thing rejecting it is
        # 0 * log(negative) = 0 * NaN = NaN here — the line search's
        # isfinite guard and the phase-1 skip check rely on that NaN.
        return -torch.log(margin) - beta * torch.log(s)

    def barrier(x, y):
        q, s = select(x, y)
        return _barrier_qs(x, q, s)

    def cobarrier(x, y, e):
        q, s = select(x, y)
        return _barrier_qs(x, q, s + e)

    def slack(x, y):
        q, s = select(x, y)
        need = torch.sum(q * q) ** (pval(x) / 2.0)  # = ||q||^p
        return need + 1.0 - s

    return Convex(barrier=barrier, cobarrier=cobarrier, slack=slack)


def convex_linear(A: Callable | None = None, b: Callable | None = None) -> Convex:
    """Pointwise linear constraints A(x) @ y <= b(x), barrier
    -sum(log(b - A y))."""

    def residual(x, y):
        return b(x) - A(x) @ y

    def barrier(x, y):
        return -torch.sum(torch.log(residual(x, y)))

    def cobarrier(x, y, e):
        return -torch.sum(torch.log(residual(x, y) + e))

    def slack(x, y):
        return torch.max(-residual(x, y)) + 1.0

    return Convex(barrier=barrier, cobarrier=cobarrier, slack=slack)


def convex_intersect(*Qs: Convex) -> Convex:
    """Intersection of convex sets: barriers add, slacks max."""

    def barrier(x, y):
        return sum(Q.barrier(x, y) for Q in Qs)

    def cobarrier(x, y, e):
        return sum(Q.cobarrier(x, y, e) for Q in Qs)

    def slack(x, y):
        return torch.max(torch.stack([Q.slack(x, y) for Q in Qs]))

    return Convex(barrier=barrier, cobarrier=cobarrier, slack=slack)
