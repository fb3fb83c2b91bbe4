"""Solver parity of the PyTorch port with the JAX package (CPU, float64).

Tolerances and why:
- barrier rows F0/F1/F2: max|a-b| / max|b| <= 1e-12 — the same closed-form
  expression differentiated by two autodiff systems, which may associate
  the few products differently (a few ulps).
- dense_solve on a real Newton system: 1e-10 — the Cholesky factors come
  from two LAPACK builds; the system's condition number (~1e4 at t=1)
  times a few ulps bounds the difference well below that.
- fem2d L=3 end to end: SOL_main.its identical and c_dot_Dz to 1e-9 rel —
  at L=3 both packages follow the same trajectory to ~1e-8 in every
  Newton decrement, so stop decisions coincide.
- fem2d L=4: c_dot_Dz within 5e-7 rel of the exact-direction pin (the
  JAX package's own ground-truth contract).  Its Newton counts are held
  equal per t-stage only up to t = 1e4: beyond that the barrier Hessians'
  conditioning grows by ~1e3 per stage and amplifies round-off differences
  between any two implementations (measured between the packages: Newton
  decrements agree to 1e-13 at t=1e3, 1e-7 at t=1e5, 1e-2 at t=1e6), so
  the late stages' iteration counts are not comparable.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multigridbarrier_tpu as mgb
from multigridbarrier_tpu.solver import linsolve as jls

import multigridbarrier_tpu_torch as mt
from multigridbarrier_tpu_torch import interop
from multigridbarrier_tpu_torch.solver import linsolve as tls

torch.set_num_threads(1)

jam = importlib.import_module("multigridbarrier_tpu.solver.amgb")
tam = importlib.import_module("multigridbarrier_tpu_torch.solver.amgb")

C_EXACT_L4 = 50.618082533590  # tests/test_ground_truth.py C_EXACT[4]


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _feasible_rows(n, p, seed):
    """(x, y) rows strictly inside the cone s > |q|^p (q = y[1:3], s = y[3])."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 2))
    y = rng.standard_normal((n, 4))
    y[:, 3] = np.linalg.norm(y[:, 1:3], axis=1) ** p + rng.uniform(0.05, 2.0, n)
    return x, y


@pytest.mark.parametrize("p", [1.0, 1.5, 2.0])
def test_barrier_rows_match_jax(p):
    x, y = _feasible_rows(64, p, seed=int(10 * p))
    Qj, Qt = jam.default_Q(2, p), tam.default_Q(2, p)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    F0j = jax.vmap(Qj.barrier)(x, y)
    F1j = jax.vmap(jax.grad(Qj.barrier, argnums=1))(x, y)
    F2j = jax.vmap(jax.hessian(Qj.barrier, argnums=1))(x, y)
    vm = torch.func.vmap
    F0t = vm(Qt.barrier)(xt, yt)
    F1t = vm(torch.func.grad(Qt.barrier, argnums=1))(xt, yt)
    F2t = vm(torch.func.hessian(Qt.barrier, argnums=1))(xt, yt)
    assert np.all(np.isfinite(F0t.numpy()))
    for a, b in ((F0t, F0j), (F1t, F1j), (F2t, F2j)):
        assert _rel(a.numpy(), b) <= 1e-12


def test_barrier_is_nan_off_the_cone_at_p1():
    """At p=1 (beta=0) the wrong cone branch s < -|q| has a positive margin;
    only 0 * log(s) = NaN rejects it, and the line search relies on that."""
    Qt, Qj = tam.default_Q(2, 1.0), jam.default_Q(2, 1.0)
    x = np.zeros(2)
    for y in ([0.0, 0.3, 0.4, -1.0],   # wrong branch: s < -|q|, margin > 0
              [0.0, 0.8, 0.8, 1.0]):   # outside: s < |q|, margin < 0
        y = np.asarray(y)
        assert np.isnan(float(Qj.barrier(x, y)))
        assert torch.isnan(Qt.barrier(torch.from_numpy(x), torch.from_numpy(y)))
    assert torch.isnan(torch.tensor(0.0) * torch.log(torch.tensor(-1.0)))


def _l3_newton_system():
    g = mgb.fem2d(L=3)
    spec = jam._normalize_D(jam.default_D(2))
    Q = jam.default_Q(2, 1.0)
    c = jax.vmap(jam.default_f(2, jnp.float64))(g.x)
    z0 = jax.vmap(jam.default_g(2, jnp.float64))(g.x)
    ctx = jam._SolverCtx(g, spec, Q.barrier, c)
    y = jam._apply_D(g.operators, spec, z0)
    basis = g.bases["dirichlet"][-1]
    nelem, nq, nl = basis.idx.shape[0], basis.nq, basis.idx.shape[1]
    Y2w = jax.vmap(jax.hessian(Q.barrier, argnums=1))(g.x, y) * g.w[:, None, None]
    He = ctx._assemble_He(ctx._P[-1], Y2w.reshape(nelem, nq, 4, 4))
    F1v = jax.vmap(jax.grad(Q.barrier, argnums=1))(g.x, y)
    gy = (g.w[:, None] * (c + F1v)).reshape(nelem, nq, 4)
    gf = jnp.einsum("eqj,eqjc->ec", gy, ctx._P[-1])
    gv = basis.scatter_add(gf.reshape(nelem, 2, nl).transpose(0, 2, 1).reshape(-1, 2)).T
    return He, basis, gv


def test_dense_solve_matches_jax_on_fem2d_L3():
    He, basis, gv = _l3_newton_system()
    m = int(basis.m)
    js = jls.LevelSystem(He, basis.idx, m, basis.scatter_idx)
    ref = np.asarray(jls.dense_solve(js, 2, -gv))
    ts = tls.LevelSystem(
        torch.tensor(np.asarray(He)),
        torch.tensor(np.asarray(basis.idx)),
        m,
        torch.tensor(np.asarray(basis.scatter_idx)),
    )
    out = tls.dense_solve(ts, 2, -torch.tensor(np.asarray(gv)))
    assert tuple(out.shape) == (2, m + 1) and np.all(out[:, m].numpy() == 0.0)
    assert _rel(out.numpy(), ref) <= 1e-10
    # the assembled matrix itself is the same
    assert _rel(tls.dense_assemble(ts, 2).numpy(), np.asarray(jls.dense_assemble(js, 2))) <= 1e-14


def _stage_its(log, t_max):
    """Newton iterations per (t, level) for t <= t_max, from a solve log."""
    out = {}
    for e in log:
        if e["t"] <= t_max:
            key = (float(e["t"]), int(e["level"]))
            out[key] = out.get(key, 0) + 1
    return out


def test_fem2d_L3_solve_matches_jax():
    sj = mgb.amgb(mgb.fem2d(L=3), p=1.0)
    st = mt.amgb(mt.fem2d(L=3, backend=mt.backend_cpu()), p=1.0)
    assert st.SOL_main.its.tolist() == sj.SOL_main.its.tolist()
    cj, ct = float(sj.SOL_main.c_dot_Dz[-1]), float(st.SOL_main.c_dot_Dz[-1])
    assert abs(ct - cj) <= 1e-9 * abs(cj)
    assert st.z.shape == sj.z.shape and torch.isfinite(st.z).all()
    np.testing.assert_allclose(st.SOL_main.ts, sj.SOL_main.ts, rtol=1e-15)


def test_fem2d_L4_solve_matches_exact_objective():
    gj = mgb.fem2d(L=4)
    gt = interop.geometry_from_arrays(interop.geometry_to_arrays(gj), mt.backend_cpu())
    sj = mgb.amgb(gj, p=1.0)
    st = mt.amgb(gt, p=1.0)
    c = float(st.SOL_main.c_dot_Dz[-1])
    assert abs(c - C_EXACT_L4) < 5e-7 * C_EXACT_L4
    assert _stage_its(st.log, 1e4) == _stage_its(sj.log, 1e4)
    assert st.SOL_main.its[:-1].tolist() == sj.SOL_main.its[:-1].tolist()


# fem2d p=1 on the CPU (one thread) at the default routing: SOL_main.its and
# the final c_dot_Dz as the port gave them before the Newton step went through
# HePlan / TablePlan / the fused hvp.  The plain versions behind those do the
# same operations in the same order, so the iteration counts are held equal
# and c_dot_Dz to 1e-12 rel (a last-bit difference of the objective would
# show as ~1e-16; the late stages' iteration counts move with the last bit).
_CPU_PINS = {
    3: ([5, 9, 46], 94.24788561813587),
    4: ([6, 12, 7, 152], 50.61808231764134),
    5: ([7, 7, 8, 5, 116], 27.36070253162774),
}


@pytest.mark.parametrize("L", sorted(_CPU_PINS))
def test_fem2d_cpu_solve_repeats_pinned_its_and_objective(L):
    its, c = _CPU_PINS[L]
    sol = mt.amgb(mt.fem2d(L=L, backend=mt.backend_cpu()), p=1.0)
    assert sol.SOL_main.its.tolist() == its
    assert abs(float(sol.SOL_main.c_dot_Dz[-1]) - c) <= 1e-12 * c


def test_amgb_accepts_numpy_start_point():
    g = mt.fem2d(L=2, backend=mt.backend_cpu())
    s_default = mt.amgb(g, p=1.0)
    x = g.x.numpy()
    z0 = np.stack([np.sum(x * x, axis=1), np.full(len(x), 100.0)], axis=1)
    s_np = mt.amgb(g, p=1.0, z0=z0)
    assert s_np.SOL_main.its.tolist() == s_default.SOL_main.its.tolist()
    assert s_np.SOL_main.c_dot_Dz[-1] == s_default.SOL_main.c_dot_Dz[-1]


def test_unported_routes_raise(monkeypatch):
    g = mt.fem2d(L=3, backend=mt.backend_cpu())
    with pytest.raises(NotImplementedError, match="mixed"):
        mt.amgb(g, p=1.0, mixed=True)
    with pytest.raises(NotImplementedError, match="linear_solver"):
        mt.amgb(g, p=1.0, linear_solver=lambda H, b: b)
    with pytest.raises(NotImplementedError):
        mt.backend_cpu(mesh=object())
    # the entry point's default is the card: without one it raises rather
    # than solve on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.fem2d_solve(L=2, p=1.0)
