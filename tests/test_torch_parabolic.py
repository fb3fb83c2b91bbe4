"""parabolic_solve of the port against the JAX package (CPU, float64,
bit-identical geometry through interop).

fem1d L=2, h=0.5, t1=1.0, p=1.0, tol=1e-7: the time values, the shapes and
every snapshot within 1e-4 of the JAX run's, the bound the JAX suite holds
its own 1-device and 8-device runs to (tests/test_parabolic.py); measured
between the packages on the CPU: 2e-14.  The other cases hold the
contract of the result (fields geometry / ts / u / sols, len(u) == len(ts),
finite snapshots of shape (n, 3)) in 1D at p=2, in 2D and in 3D.
"""

import numpy as np
import pytest
import torch

import multigridbarrier_tpu as mgb

import multigridbarrier_tpu_torch as mt
from multigridbarrier_tpu_torch import interop

torch.set_num_threads(1)


def test_parabolic_fem1d_matches_jax():
    gj = mgb.fem1d(L=2)
    sj = mgb.parabolic_solve(gj, h=0.5, t1=1.0, p=1.0, tol=1e-7)
    gt = interop.geometry_from_arrays(interop.geometry_to_arrays(gj), mt.backend_cpu())
    st = mt.parabolic_solve(gt, h=0.5, t1=1.0, p=1.0, tol=1e-7)
    assert isinstance(st, mt.ParabolicSOL) and st.geometry is gt
    assert st.ts == sj.ts == [0.0, 0.5, 1.0]
    assert len(st.u) == len(st.ts) and len(st.sols) == 2
    for ut, uj in zip(st.u, sj.u):
        assert tuple(ut.shape) == (gt.n, 3) == tuple(uj.shape)
        assert bool(torch.isfinite(ut).all())
        assert np.abs(ut.numpy() - np.asarray(uj)).max() < 1e-4
    # every time step starts feasible, and all of them share one context
    assert all(s.SOL_feasibility.its.sum() == 0 for s in st.sols)
    assert len(gt.ctx_cache) == 1


def test_parabolic_fem1d_p2_zero_source_stays_bounded():
    g = mt.fem1d(L=3, backend=mt.backend_cpu())
    sol = mt.parabolic_solve(g, h=0.25, t1=0.75, p=2.0, f1=0.0)
    assert sol.ts == [0.0, 0.25, 0.5, 0.75] and len(sol.u) == 4
    u0 = sol.u[0][:, 0]
    norms = [float(torch.dot(g.w, (u[:, 0] - u0) ** 2)) for u in sol.u]
    assert all(np.isfinite(norms))
    assert float((sol.u[-1][:, 0] - u0).abs().max()) < 10.0


def test_parabolic_callable_source_and_start():
    """f1 and g may be callables of the coordinates; constants written as
    callables give the default run."""
    g = mt.fem1d(L=2, backend=mt.backend_cpu())
    ref = mt.parabolic_solve(g, h=0.5, t1=0.5, p=1.0)
    sol = mt.parabolic_solve(
        g, h=0.5, t1=0.5, p=1.0, f1=lambda x: 0.5 + 0.0 * x[0],
        g=lambda x: torch.stack([x[0] * x[0], torch.full_like(x[0], 100.0)]),
    )
    assert sol.ts == ref.ts == [0.0, 0.5]
    assert torch.equal(sol.u[0], ref.u[0])
    assert float((sol.u[1] - ref.u[1]).abs().max()) < 1e-12


@pytest.mark.parametrize("family", ["fem2d", "fem3d"])
def test_parabolic_runs_in_2d_and_3d(family):
    if family == "fem2d":
        g = mt.fem2d(L=2, backend=mt.backend_cpu())
    else:
        g = mt.fem3d(L=2, k=2, backend=mt.backend_cpu())
    sol = mt.parabolic_solve(g, h=0.5, t1=1.0, p=1.0, tol=1e-6)
    assert sol.ts == [0.0, 0.5, 1.0] and len(sol.u) == 3
    for u in sol.u:
        assert tuple(u.shape) == (g.n, 3) and bool(torch.isfinite(u).all())
    (ctx,) = g.ctx_cache.values()
    # fields (u, s1, s2) and D rows u:id, the gradient, s1:id, s2:id
    assert ctx.spec.nfields == 3 and ctx.spec.k == g.dim + 3
    assert ctx.x.shape[1] == g.dim + 1


@pytest.mark.parametrize("family", ["fem1d", "fem2d"])
def test_parabolic_calls_share_one_context(family):
    """The constraint is kept per (geometry, p), so a second call on the
    geometry builds no solver context, ND level or plan, and repeats the
    first call's snapshots bit for bit; another step length shares it."""
    from multigridbarrier_tpu_torch.runtime import telemetry as tm

    if family == "fem1d":
        g = mt.fem1d(L=3, backend=mt.backend_cpu())
    else:
        g = mt.fem2d(L=2, backend=mt.backend_cpu())
    first = mt.parabolic_solve(g, h=0.5, t1=1.0, p=1.0)
    before = dict(tm.COUNTERS)
    again = mt.parabolic_solve(g, h=0.5, t1=1.0, p=1.0)
    built = {k: v - before.get(k, 0) for k, v in tm.COUNTERS.items() if k.startswith("builds.")}
    assert len(g.ctx_cache) == 1 and not any(built.values()), built
    assert all(torch.equal(a, b) for a, b in zip(first.u, again.u))
    mt.parabolic_solve(g, h=0.25, t1=0.5, p=1.0)
    assert len(g.ctx_cache) == 1


def test_parabolic_context_per_exponent():
    """Each exponent p is a constraint of its own, and so a context of its
    own, which a later call at that p reuses."""
    g = mt.fem1d(L=2, backend=mt.backend_cpu())
    for p, contexts in ((1.0, 1), (2.0, 2), (1.0, 2), (2.0, 2)):
        mt.parabolic_solve(g, h=0.5, t1=0.5, p=p)
        assert len(g.ctx_cache) == contexts
