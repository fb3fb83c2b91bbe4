"""The feasibility phase and aux= columns of the port against the JAX
package (CPU, float64, bit-identical geometry through interop).

Tolerances and why:
- the obstacle problem of tests/test_obstacle.py at fem2d L=2 starts
  infeasible (the start u = |x|^2 lies under the obstacle near the
  centre): both packages run phase 1 then phase 2; the final c_dot_Dz is
  held to 5e-7 rel (the JAX package's own contract for its objective
  pins) and z to tol * 1000 = 1e-4 (the package's distributed-vs-native
  bound); on this problem they agree far tighter, and the phase-1
  iteration counts are equal.
- aux=: the callables see the same rows in both packages, so an aux-driven
  problem follows the same trajectory: its equal, c_dot_Dz to 1e-9 rel
  (the bound tests/test_torch_solver.py holds fem2d L=3 to).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import multigridbarrier_tpu as mgb
from multigridbarrier_tpu.solver import convex as jconvex

import multigridbarrier_tpu_torch as mt
from multigridbarrier_tpu_torch import interop

torch.set_num_threads(1)

tam = importlib.import_module("multigridbarrier_tpu_torch.solver.amgb")

D2 = [("u", "id"), ("u", "dx"), ("u", "dy"), ("s", "id")]
F64 = torch.float64


def _obstacle_Q_jax():
    return jconvex.convex_intersect(
        jconvex.convex_Euclidian_power(idx=(1, 2, 3), p=2.0),
        jconvex.convex_linear(
            A=lambda xx: jnp.array([[-1.0, 0.0, 0.0, 0.0]]),
            b=lambda xx: jnp.array([-(0.5 - 2.0 * (xx[0] ** 2 + xx[1] ** 2))]),
        ),
    )


def _obstacle_Q_torch():
    A = torch.tensor([[-1.0, 0.0, 0.0, 0.0]], dtype=F64)
    return mt.convex_intersect(
        mt.convex_Euclidian_power(idx=(1, 2, 3), p=2.0),
        mt.convex_linear(
            A=lambda xx: A,
            b=lambda xx: (-(0.5 - 2.0 * (xx[0] ** 2 + xx[1] ** 2))).reshape(1),
        ),
    )


def _port_geometry(gj, **backend_kw):
    return interop.geometry_from_arrays(interop.geometry_to_arrays(gj), mt.backend_cpu(**backend_kw))


def test_obstacle_infeasible_start_matches_jax():
    gj = mgb.fem2d(L=2)
    sj = mgb.amgb(
        gj, D=D2, f=lambda xx: jnp.array([3.0, 0.0, 0.0, 1.0]),
        g=lambda xx: jnp.array([xx[0] ** 2 + xx[1] ** 2, 100.0]), Q=_obstacle_Q_jax(), tol=1e-7,
    )
    gt = _port_geometry(gj)
    st = mt.amgb(
        gt, D=D2, f=lambda xx: torch.tensor([3.0, 0.0, 0.0, 1.0], dtype=F64),
        g=lambda xx: torch.stack([xx[0] ** 2 + xx[1] ** 2, torch.full_like(xx[0], 100.0)]),
        Q=_obstacle_Q_torch(), tol=1e-7,
    )
    # phase 1 ran, in the same number of steps, and its log is kept
    assert st.SOL_feasibility.its.sum() > 0
    assert st.SOL_feasibility.its.tolist() == sj.SOL_feasibility.its.tolist()
    assert st.SOL_feasibility.ts == sj.SOL_feasibility.ts
    assert {e["phase"] for e in st.log} == {"feasibility", "main"}
    cj, ct = float(sj.SOL_main.c_dot_Dz[-1]), float(st.SOL_main.c_dot_Dz[-1])
    assert abs(ct - cj) <= 5e-7 * abs(cj)
    z = st.z.numpy()
    assert z.shape == (gt.n, 2)
    assert np.abs(z - np.asarray(sj.z)).max() <= 1e-7 * 1000
    # the obstacle holds and is active at the centre
    x = gt.x.numpy()
    gap = z[:, 0] - (0.5 - 2.0 * (x[:, 0] ** 2 + x[:, 1] ** 2))
    assert -1e-6 < gap.min() < 1e-3


def test_feasible_start_skips_phase_1():
    g = mt.fem2d(L=2, backend=mt.backend_cpu())
    sol = mt.amgb(g, p=1.0)
    f = sol.SOL_feasibility
    assert f.ts == [] and f.c_dot_Dz == [] and f.its.tolist() == [0, 0] and f.t_elapsed == 0.0
    assert {e["phase"] for e in sol.log} == {"main"}
    # a converged iterate passed back in as z0 is near the boundary but
    # strictly inside: it must not be sent through phase 1
    again = mt.amgb(g, p=1.0, z0=sol.z)
    assert again.SOL_feasibility.its.sum() == 0


def test_phase1_contexts_are_cached_and_a_failed_phase_raises():
    """The phase-1 barrier wrapper is memoised by (Q, k), so a second
    infeasible-start solve reuses both contexts and repeats the first; a
    start whose boundary values are infeasible (the Dirichlet subspace
    cannot move them) fails in phase 1 with AMGBConvergenceFailure, as in
    the JAX package."""
    g = mt.fem2d(L=2, backend=mt.backend_cpu())
    Q = _obstacle_Q_torch()
    kw = dict(
        D=D2, f=lambda xx: torch.tensor([3.0, 0.0, 0.0, 1.0], dtype=F64),
        g=lambda xx: torch.stack([xx[0] ** 2 + xx[1] ** 2, torch.full_like(xx[0], 100.0)]),
        Q=Q, tol=1e-5,
    )
    first = mt.amgb(g, **kw)
    assert first.SOL_feasibility.its.sum() > 0 and len(g.ctx_cache) == 2
    second = mt.amgb(g, **kw)
    assert len(g.ctx_cache) == 2
    assert second.SOL_feasibility.its.tolist() == first.SOL_feasibility.its.tolist()
    assert second.SOL_main.c_dot_Dz == first.SOL_main.c_dot_Dz
    assert tam._co_barrier_for(Q, 4) is tam._co_barrier_for(Q, 4)
    z0 = np.zeros((g.n, 2))
    z0[:, 1] = -1.0  # s < 0 on the boundary too
    with pytest.raises(mt.AMGBConvergenceFailure, match="feasibility"):
        mt.amgb(g, p=1.0, z0=z0)


def test_aux_columns_reach_f_g_and_the_barrier():
    """f, g and the barrier read column dim of their x rows (the aux
    column); the run matches the JAX package's on the same data."""
    gj = mgb.fem2d(L=2)
    gt = _port_geometry(gj)
    rng = np.random.default_rng(3)
    aux = rng.uniform(0.5, 1.5, (gt.n, 1))
    seen = []

    # cone ||grad u|| <= s + a with the aux value a shifting the cone, a
    # cost and a start that depend on a
    def bj(xx):
        return jnp.stack([0.0 * xx[2], 0.0 * xx[2], xx[2]])

    def bt(xx):
        seen.append(tuple(xx.shape))
        return torch.stack([0.0 * xx[2], 0.0 * xx[2], xx[2]])

    Aj = jnp.eye(4)[1:]
    At = torch.eye(4, dtype=F64)[1:]
    Qj = jconvex.convex_Euclidian_power(idx=(1, 2, 3), p=1.0, A=lambda xx: Aj, b=bj)
    Qt = mt.convex_Euclidian_power(idx=(1, 2, 3), p=1.0, A=lambda xx: At, b=bt)
    sj = mgb.amgb(
        gj, D=D2, f=lambda xx: jnp.stack([0.5 * xx[2], 0.0 * xx[2], 0.0 * xx[2], 1.0 + 0.0 * xx[2]]),
        g=lambda xx: jnp.stack([xx[0] ** 2 + xx[1] ** 2, 100.0 + xx[2]]), Q=Qj, aux=aux, tol=1e-6,
    )
    st = mt.amgb(
        gt, D=D2, f=lambda xx: torch.stack([0.5 * xx[2], 0.0 * xx[2], 0.0 * xx[2], 1.0 + 0.0 * xx[2]]),
        g=lambda xx: torch.stack([xx[0] ** 2 + xx[1] ** 2, 100.0 + xx[2]]), Q=Qt, aux=aux, tol=1e-6,
    )
    assert seen and set(seen) == {(3,)}
    assert st.SOL_main.its.tolist() == sj.SOL_main.its.tolist()
    cj, ct = float(sj.SOL_main.c_dot_Dz[-1]), float(st.SOL_main.c_dot_Dz[-1])
    assert abs(ct - cj) <= 1e-9 * abs(cj)
    # the aux data changes the answer (it is not ignored) ...
    s2 = mt.amgb(gt, D=D2, f=lambda xx: torch.stack([0.5 * xx[2], 0.0 * xx[2], 0.0 * xx[2], 1.0 + 0.0 * xx[2]]),
                 g=lambda xx: torch.stack([xx[0] ** 2 + xx[1] ** 2, 100.0 + xx[2]]), Q=Qt,
                 aux=2.0 * aux, tol=1e-6)
    assert abs(s2.SOL_main.c_dot_Dz[-1] - ct) > 1e-3 * abs(ct)
    # ... and both solves used one context: keyed by the number of columns
    assert len(gt.ctx_cache) == 1
    with pytest.raises(ValueError, match="components"):
        mt.amgb(gt, D=D2, f=lambda xx: xx, Q=Qt, aux=aux)


def test_nd_ordering_ignores_aux_columns():
    """Forced nested dissection at fem2d L=4: the elimination order comes
    from the geometry's coordinates, with or without an aux column."""
    g = mt.fem2d(L=4, backend=mt.backend_cpu(dense_threshold=256))
    spec = tam._normalize_D(tam.default_D(2))
    Q = tam.default_Q(2, 1.0)
    c = torch.vmap(tam.default_f(2, F64))(g.x)
    z0 = torch.vmap(tam.default_g(2, F64))(g.x)
    rng = np.random.default_rng(5)
    xa = torch.cat([g.x, torch.tensor(rng.standard_normal((g.n, 1)) * 50.0)], dim=1)
    plain = tam._get_ctx(g, spec, Q.barrier, c)
    with_aux = tam._get_ctx(g, spec, Q.barrier, c, x=xa)
    assert plain is not with_aux and with_aux.x.shape[1] == 3
    lvl = g.levels - 1
    assert lvl in plain._nd_route
    outs = [ctx.step(lvl, z0, 0.1) for ctx in (plain, with_aux)]
    a, b = plain.nd[lvl].fz.sym, with_aux.nd[lvl].fz.sym
    np.testing.assert_array_equal(a.owner, b.owner)
    np.testing.assert_array_equal(a.parent, b.parent)
    assert a.ngroups == b.ngroups
    for ga, gb in zip(a.sep_gids, b.sep_gids):
        np.testing.assert_array_equal(ga, gb)
    # the default barrier reads no aux column, so the step is the same
    assert torch.equal(outs[0][0], outs[1][0]) and outs[0][1:] == outs[1][1:]
    # refreshed, not rebuilt, when the aux data changes
    assert tam._get_ctx(g, spec, Q.barrier, c, x=xa * 2.0) is with_aux
    assert torch.equal(with_aux.x, xa * 2.0)
