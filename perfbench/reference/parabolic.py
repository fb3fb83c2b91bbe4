"""The plain judge of a time stepper's solve (parabolic_solve), step by step.

Each implicit-Euler step k of a solve with step h minimises

    int f1 u + |grad u|^p + (u - u_prev)^2 / (2h)

written as a barrier problem in three fields (u, s1, s2): D = [u:id, u:dx,
u:dy (, u:dz), s1:id, s2:id], cost [f1, 0, .., 0, 1, 1/(2h)], and at every
point the two cones ||grad u||^p <= s1 and (u - u_prev)^2 <= s2, whose
barriers are -log(s1^(2/p) - |grad u|^2) - beta_p log s1, beta_p =
max(0, 2 - 2/p), and -log(s2 - (u - u_prev)^2) - log s2.  The step starts
from z0 = (u_prev, 100, 100), which also gives its boundary values, and
follows the central path to t = 1/tol.

The judge follows the program step by step from the program's own state:
step k's u_prev is the program's snapshot k - 1; step 1's is the initial
data, re-derived here from the seed's coefficients.  Each step's iterate
and reported objective are judged by check.Judge's four numbers against
that step's problem; a solve reads the worst of its steps, and
snapshots_off, how far its count of snapshots is from t1/h + 1.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .check import Cone, Problem

NUMBERS = ("infeasible", "subspace_err", "obj_rel", "decrement")
SLACK0 = 100.0  # the slacks' start at every step


def step_problem(dim: int, p: float, h: float, source, u0, tol: float) -> Problem:
    """The problem of every step; source(x) (n,) is f1 and u0(x) (n,) the
    initial u, both numpy functions of the points (n, dim)."""
    rows = [(0, "id")] + [(0, a) for a in range(dim)] + [(1, "id"), (2, "id")]
    cones = [Cone(tuple(range(1, dim + 1)), dim + 1, float(p)),
             Cone((0,), dim + 2, 2.0, aux=True)]

    def cost(x):
        n = x.shape[0]
        return np.concatenate([source(x)[:, None], np.zeros((n, dim)),
                               np.ones((n, 1)), np.full((n, 1), 1.0 / (2.0 * h))], axis=1)

    def start(x):
        return np.stack([u0(x), np.full(x.shape[0], SLACK0), np.full(x.shape[0], SLACK0)], axis=1)

    return Problem(rows, 3, cones, cost, start, tol)


def snapshots_due(t1: float, h: float) -> int:
    """The snapshots of a solve to t1 in steps of h, the initial one included."""
    return math.ceil(t1 / h - 1e-12) + 1


def judge_steps(j, snapshots, objs, due: int):
    """(the worst of each number over the steps with snapshots_off, the
    per-step readings).  snapshots: the program's u list (z of each step,
    the initial one first); objs: each step's reported objective."""
    rows = []
    start = j.zg.clone()  # (u0, 100, 100) re-derived
    for z, obj in zip(snapshots[1:], objs):
        r = j.judge(z, obj, start=start, aux=start[:, 0])
        rows.append(r)
        start = j.zg.clone()
        start[:, 0] = torch.as_tensor(z, device=j.dev).to(j.dtype)[:, 0]
    worst = {n: max((r[n] for r in rows), default=math.inf) for n in NUMBERS}
    worst["snapshots_off"] = abs(len(snapshots) - due)
    return worst, rows
