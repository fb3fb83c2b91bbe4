"""Solver parity of the port's 1D and 3D families with the JAX package
(CPU, float64, bit-identical geometry through interop).

Tolerances and why:
- fem1d L=2, 3 at p=1, 2: the final c_dot_Dz within 5e-7 rel of the JAX
  run (the JAX package's contract for its objective pins), and the Newton
  iterations per (t, level) equal through t = 1e4.  Beyond that the
  barrier Hessians' conditioning grows by ~1e3 per stage and amplifies
  round-off differences between any two implementations, so the late
  stages' iteration counts are not comparable (tests/test_torch_solver.py
  holds fem2d the same way).
- fem3d L=2 k=2 at tol=1e-6: c_dot_Dz within 1e-5 rel of the JAX run, the
  JAX suite's own cross-platform floor for 3D (tests/test_fem3d.py), the
  iterations equal through t = 1e4, and the cone constraint
  ||grad u|| <= s + 1e-5 at every point.
- fem3d L=2 k=3 with dense_threshold=64 (the fine level, 250 unknowns, on
  the nested-dissection route, as fem3d L=3 k=3 takes it at the default
  threshold): c_dot_Dz within 1e-5 rel of 192.49066199206504, the JAX
  package's exact-dense pin for this problem (tests/test_fem3d.py).
"""

import numpy as np
import pytest
import torch

import multigridbarrier_tpu as mgb

import multigridbarrier_tpu_torch as mt
from multigridbarrier_tpu_torch import interop

torch.set_num_threads(1)

C_FEM3D_L2K3 = 192.49066199206504  # tests/test_fem3d.py, exact-dense direct run


def _stage_its(log, t_max):
    """Newton iterations per (t, level) for t <= t_max, from a solve log."""
    out = {}
    for e in log:
        if e["t"] <= t_max:
            key = (float(e["t"]), int(e["level"]))
            out[key] = out.get(key, 0) + 1
    return out


def _port_geometry(gj, **backend_kw):
    return interop.geometry_from_arrays(interop.geometry_to_arrays(gj), mt.backend_cpu(**backend_kw))


@pytest.mark.parametrize("p", [1.0, 2.0])
@pytest.mark.parametrize("L", [2, 3])
def test_fem1d_solve_matches_jax(L, p):
    gj = mgb.fem1d(L=L)
    sj = mgb.amgb(gj, p=p)
    st = mt.amgb(_port_geometry(gj), p=p)
    cj, ct = float(sj.SOL_main.c_dot_Dz[-1]), float(st.SOL_main.c_dot_Dz[-1])
    assert abs(ct - cj) <= 5e-7 * abs(cj)
    assert _stage_its(st.log, 1e4) == _stage_its(sj.log, 1e4)
    assert st.z.shape == (gj.n, 2) and bool(torch.isfinite(st.z).all())
    assert st.SOL_feasibility.its.sum() == 0
    np.testing.assert_allclose(st.SOL_main.ts[:6], sj.SOL_main.ts[:6], rtol=1e-15)


def test_fem1d_solve_entry_point():
    """fem1d_solve builds the same geometry and solves the same problem."""
    sol = mt.fem1d_solve(L=3, p=1.0, backend=mt.backend_cpu())
    ref = mt.amgb(mt.fem1d(L=3, backend=mt.backend_cpu()), p=1.0)
    assert sol.SOL_main.its.tolist() == ref.SOL_main.its.tolist()
    assert sol.SOL_main.c_dot_Dz[-1] == ref.SOL_main.c_dot_Dz[-1]
    assert sol.geometry.discretization.name == "fem1d"


def test_fem3d_L2_k2_solve_matches_jax():
    gj = mgb.fem3d(L=2, k=2)
    sj = mgb.amgb(gj, p=1.0, tol=1e-6)
    st = mt.amgb(_port_geometry(gj), p=1.0, tol=1e-6)
    cj, ct = float(sj.SOL_main.c_dot_Dz[-1]), float(st.SOL_main.c_dot_Dz[-1])
    assert abs(ct - cj) <= 1e-5 * abs(cj)
    assert _stage_its(st.log, 1e4) == _stage_its(sj.log, 1e4)
    g = st.geometry
    du = torch.stack([g.operators[d].matvec(st.z[:, 0]) for d in ("dx", "dy", "dz")], dim=1)
    assert bool((torch.linalg.norm(du, dim=1) <= st.z[:, 1] + 1e-5).all())
    assert st.SOL_main.its.sum() > 0
    # the entry point with (L, k) gives the same run on its own geometry
    se = mt.fem3d_solve(L=2, k=2, p=1.0, tol=1e-6, backend=mt.backend_cpu())
    assert se.SOL_main.its.tolist() == st.SOL_main.its.tolist()
    assert abs(se.SOL_main.c_dot_Dz[-1] - ct) <= 1e-12 * abs(ct)


def test_fem3d_L2_k3_forced_nd_matches_exact_pin():
    g = mt.fem3d(L=2, k=3, backend=mt.backend_cpu(dense_threshold=64))
    sol = mt.amgb(g, p=1.0)
    (ctx,) = g.ctx_cache.values()
    assert sorted(ctx.nd) == [1]  # the fine level took nested dissection
    c = float(sol.SOL_main.c_dot_Dz[-1])
    assert abs(c - C_FEM3D_L2K3) < 1e-5 * C_FEM3D_L2K3, c
    assert int(sol.SOL_main.its.sum()) < 200
    # element shape: nq = 64, k = 5 rows of Dz, and C = nf * nl = 2 * 27 (at
    # L=2 every hexahedron touches the boundary, so 27 of its 64 nodes are
    # free; from L=3 on interior elements have C = 128): the wide kernel's
    assert tuple(ctx._P[-1].shape) == (8, 64, 5, 54)
    assert ctx._he_plans[1].kernel == "wide"
