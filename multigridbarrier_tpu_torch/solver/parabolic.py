"""parabolic_solve — implicit time stepping for time-dependent problems
(port of solver/parabolic.py).

Time-dependent p-Laplace diffusion is driven by solving one barrier problem
per implicit-Euler step on the same geometry (signature
parabolic_solve(g; h, t1, p, verbose); the result has the fields
`geometry`, `ts`, `u` with len(u) == len(ts)).

Each step solves

    min_u  int f1*u + |grad u|^p + (u - u_prev)^2 / (2h)

formulated in the linear-cost barrier framework with two slack fields:

    fields (u, s1, s2), D = [u:id, u:dx[, u:dy[, u:dz]], s1:id, s2:id]
    cost c = [f1, 0..., 1, 1/(2h)]
    Q = { ||grad u||^p <= s1 }  ∩  { (u - u_prev)^2 <= s2 }

u_prev enters as an aux data column appended to x (see amgb's `aux`), so
every step reuses the solver contexts of the first; and Q is kept on the
geometry per p (amgb keys a context by Q's barrier), so every later call
on that geometry and p reuses them too, with their ND levels and graphs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.func import vmap

from ..fem.geometry import Geometry
from .amgb import amgb, default_g
from .convex import convex_Euclidian_power, convex_intersect


@dataclasses.dataclass
class ParabolicSOL:
    geometry: Geometry
    ts: list  # time values, ts[0] = 0
    u: list  # snapshots, one (n, nfields) tensor per time value
    sols: list  # per-step AMGBSOL (diagnostics)


def _constraint(geometry: Geometry, p):
    """Q = { ||grad u||^p <= s1 } ∩ { (u - u_prev)^2 <= s2 } on the fields
    (u, s1, s2), built once per (geometry, p)."""
    cache = getattr(geometry, "_parabolic_Q", None)
    if cache is None:
        cache = {}
        object.__setattr__(geometry, "_parabolic_Q", cache)
    if p in cache:
        return cache[p]
    dim, k = geometry.dim, geometry.dim + 3

    # Q1: ||grad u||^p <= s1  (components 1..dim and dim+1)
    Q1 = convex_Euclidian_power(idx=tuple(range(1, dim + 2)), p=p)

    # Q2: (u - u_prev)^2 <= s2 ; u_prev is aux column dim of x.
    A2_const = torch.zeros((2, k), dtype=geometry.x.dtype, device=geometry.x.device)
    A2_const[0, 0] = 1.0
    A2_const[1, k - 1] = 1.0

    def A2(x):
        return A2_const

    def b2(x):
        return torch.stack([-x[dim], torch.zeros_like(x[dim])])

    Q2 = convex_Euclidian_power(idx=(0, k - 1), p=2.0, A=A2, b=b2)
    cache[p] = convex_intersect(Q1, Q2)
    return cache[p]


def parabolic_solve(
    geometry: Geometry,
    *,
    h: float = 0.5,
    t1: float = 1.0,
    p=1.0,
    f1: float | Callable = 0.5,
    g: Optional[Callable] = None,
    verbose: bool = False,
    **kwargs,
):
    dim = geometry.dim
    dtype, device = geometry.x.dtype, geometry.x.device
    n = geometry.n

    grads = ["dx", "dy", "dz"][:dim]
    D = (
        [("u", "id")]
        + [("u", g_) for g_ in grads]
        + [("s1", "id"), ("s2", "id")]
    )

    def as_row(v):
        if isinstance(v, torch.Tensor):
            return v.to(dtype)
        return torch.tensor(v, dtype=dtype, device=device)

    cost_rest = as_row([0.0] * dim + [1.0, 1.0 / (2.0 * h)])

    def fcost(x):
        f1v = as_row(f1(x[:dim]) if callable(f1) else f1)
        return torch.cat([f1v.reshape(1), cost_rest])

    Q = _constraint(geometry, p)

    # initial data: u component of g (default: |x|^2 with boundary trace).
    ginit = g if g is not None else default_g(dim, dtype)

    u0 = vmap(lambda xi: as_row(ginit(xi))[0])(geometry.x)

    def with_slacks(u):
        return torch.cat([u[:, None], u.new_full((n, 2), 100.0)], dim=1)

    ts = [0.0]
    snapshots = [with_slacks(u0)]
    sols = []

    t = 0.0
    while t < t1 - 1e-12:
        t = min(t + h, t1)
        u_prev = snapshots[-1][:, 0]
        # initial iterate: previous solution with refreshed slack fields
        # (pointwise feasible by construction, so phase 1 is skipped)
        sol = amgb(
            geometry,
            D=D,
            f=fcost,
            Q=Q,
            p=p,
            aux=u_prev[:, None],
            z0=with_slacks(u_prev),
            verbose=verbose,
            **kwargs,
        )
        ts.append(t)
        snapshots.append(sol.z)
        sols.append(sol)
        if verbose:
            print(f"[parabolic] t={t:.4f} done")

    return ParabolicSOL(geometry=geometry, ts=ts, u=snapshots, sols=sols)
