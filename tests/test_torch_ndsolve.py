"""The nested-dissection fine-level solver of the port against the JAX
package (CPU, float64).

The JAX side runs in its CPU configuration, which is the one the port
carries (bucketing on, leaf 16, fan-in extend-add, native Cholesky,
substitution, a two-trip CG polish); the tests clear the environment knobs
that would change it.

Tolerances and why:
- HostPattern and NDSymbolic are integer maps built by the same host
  algorithm: equal exactly.
- He -> vals: 1e-13 rel.  Both sum the same few element contributions; the
  port in element order, jax.ops.segment_sum in its own order.
- factor + solve and the full direction on a real forced-ND fem2d L=4
  Newton system: 1e-10 rel, and residual <= 1e-10 rel against the dense
  assembled matrix.  The system's condition (~1e4 at t=1) times the
  round-off of two LAPACK builds' Cholesky and triangular solves bounds
  the difference far below that.
- End to end, the fine level forced onto nested dissection by a low
  dense_threshold: L=3 its equal to the JAX run's and c_dot_Dz to 1e-9
  rel (as the dense route's L=3 test); L=4 c_dot_Dz within 5e-7 rel of
  C_EXACT[4] and its equal per t-stage through t=1e4 (beyond that the
  conditioning amplifies round-off differences, see test_torch_solver).

An ND comparison must route the level through nested dissection at all:
with the default dense_threshold=2048, fem2d L<=5 runs dense on every
level (L=5's fine level has nf*m = 1922), so an ND A/B at L=5 default is
vacuous.  Likewise dense_threshold=256 leaves L=3's fine level (nf*m = 98)
dense; the L=3 test uses 64.  Each end-to-end test asserts that the fine
level took the ND route.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multigridbarrier_tpu as mgb
from multigridbarrier_tpu.backend import Backend
from multigridbarrier_tpu.solver import hostsolve as jhs
from multigridbarrier_tpu.solver import ndsolve as jnd

import multigridbarrier_tpu_torch as mt
from multigridbarrier_tpu_torch import interop
from multigridbarrier_tpu_torch.solver import hostsolve as ths
from multigridbarrier_tpu_torch.solver import linsolve as tls
from multigridbarrier_tpu_torch.solver import ndsolve as tnd

torch.set_num_threads(1)

jam = importlib.import_module("multigridbarrier_tpu.solver.amgb")
tam = importlib.import_module("multigridbarrier_tpu_torch.solver.amgb")

C_EXACT_L4 = 50.618082533590  # tests/test_ground_truth.py C_EXACT[4]
ND_KNOBS = ("MGB_ND_BUCKET", "MGB_ND_INV", "MGB_ND_CHOL", "MGB_ND_EA",
            "MGB_ND_PCG", "MGB_ND_LEAF", "MGB_ND_SPLITSUM", "MGB_FINE_SOLVER",
            "MGB_ND_F32_TMAX", "MGB_ND_REUSE", "MGB_ND_LAZY", "MGB_ND_F32PC",
            "MGB_HOST_TMIN")


@pytest.fixture(autouse=True)
def _cpu_configuration(monkeypatch):
    for key in ND_KNOBS:
        monkeypatch.delenv(key, raising=False)


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _jax_newton_system(L, dense_threshold):
    """A JAX solver context on fem2d(L) and the fine level's deduplicated
    values and gradient at the start point, t = 1."""
    g = mgb.fem2d(L=L, backend=Backend(dtype=jnp.float64, dense_threshold=dense_threshold))
    spec = jam._normalize_D(jam.default_D(2))
    Q = jam.default_Q(2, 1.0)
    c = jax.vmap(jam.default_f(2, jnp.float64))(g.x)
    z0 = jax.vmap(jam.default_g(2, jnp.float64))(g.x)
    ctx = jam._SolverCtx(g, spec, Q.barrier, c)
    level = ctx.levels - 1
    h = ctx._get_host(level)
    vals, gv, *_ = h["pre"](
        ctx._P[level], ctx._bases[level], ctx.x, ctx.w, ctx.c, z0,
        jnp.asarray(1.0, jnp.float64), h["full_ids"],
    )
    return g, ctx, level, np.asarray(vals), np.asarray(gv)


@pytest.fixture(scope="module")
def l4_system():
    g, ctx, level, vals, gv = _jax_newton_system(4, 256)
    gt = interop.geometry_from_arrays(
        interop.geometry_to_arrays(g), mt.backend_cpu(dense_threshold=256)
    )
    return dict(g=g, ctx=ctx, level=level, vals=vals, gv=gv, gt=gt)


def test_vals_reduction_matches_jax_segment_sum():
    """HostPattern's full_ids/nseg and the port's deterministic He -> vals
    sum against the JAX segment_sum (amgb._build_host_pre) on a real fem2d
    L=3 barrier Hessian."""
    g, ctx, level, vals_j, _ = _jax_newton_system(3, 2048)
    basis = ctx._bases[level]
    idx, m = np.asarray(basis.idx), int(basis.m)
    pj, pt = jhs.HostPattern(idx, m, 2), ths.HostPattern(idx, m, 2)
    assert pt.nseg == pj.nseg and pt.N == pj.N
    np.testing.assert_array_equal(pt.full_ids, pj.full_ids)
    # He at the same point, as the JAX pre computes it
    spec = jam._normalize_D(jam.default_D(2))
    z0 = jax.vmap(jam.default_g(2, jnp.float64))(g.x)
    y = jam._apply_D(g.operators, spec, z0)
    Q = jam.default_Q(2, 1.0)
    Y2w = jax.vmap(jax.hessian(Q.barrier, argnums=1))(g.x, y) * g.w[:, None, None]
    He = ctx._assemble_He(ctx._P[level], Y2w.reshape(basis.idx.shape[0], basis.nq, 4, 4))
    He_t = torch.tensor(np.asarray(He))
    vals_t = tls.he_to_vals(He_t, tls.vals_table(torch.tensor(idx, dtype=torch.int32), m, 2))
    assert _rel(vals_t.numpy(), vals_j) <= 1e-13
    # the dense matrix placed from vals equals the JAX dense assembly
    js = importlib.import_module("multigridbarrier_tpu.solver.linsolve")
    Hj = js.dense_assemble(js.LevelSystem(He, basis.idx, m, basis.scatter_idx), 2)
    Ht = tls.dense_assemble(
        tls.LevelSystem(He_t, torch.tensor(idx, dtype=torch.int32), m, None), 2
    )
    assert _rel(Ht.numpy(), np.asarray(Hj)) <= 1e-14


SYM_ARRAYS = ("asm_pid", "asm_dst", "pad_ids", "ea_tsrc", "ea_tdst",
              "sep_gids", "bd_gids", "sep_gids_w", "bd_gids_w")


@pytest.mark.parametrize("L", [4, 5])
def test_nd_symbolic_matches_jax(L):
    g = mgb.fem2d(L=L)
    basis = g.bases["dirichlet"][-1]
    idx, m = np.asarray(basis.idx), int(basis.m)
    cj = jnd.node_coords(idx, m, np.asarray(g.x), basis.nq)
    ct = tnd.node_coords(idx, m, np.asarray(g.x), basis.nq)
    np.testing.assert_array_equal(ct, cj)
    sj = jnd.NDSymbolic(idx, m, 2, cj, leaf=16)
    st = tnd.NDSymbolic(idx, m, 2, ct, leaf=16)
    assert st.by_depth == sj.by_depth and st.ngroups == sj.ngroups
    assert st.s_pad == sj.s_pad and st.b_pad == sj.b_pad
    assert (st.N, st.nuniq) == (sj.N, sj.nuniq)
    for key in ("sb_off", "pair_pid", "pair_i", "pair_j", "diag_pid"):
        np.testing.assert_array_equal(getattr(st, key), getattr(sj, key), err_msg=key)
    for key in SYM_ARRAYS:
        for d, (a, b) in enumerate(zip(getattr(st, key), getattr(sj, key))):
            np.testing.assert_array_equal(a, b, err_msg=f"{key}[{d}]")
    # the port's CSR tables carry every assembly contribution exactly once,
    # and every forward-sweep update to a real dof once, none to the
    # write-only pad sink N+1
    for d in range(st.ngroups):
        n_src = len(st.asm_pid[d]) + len(st.ea_tsrc[d]) + len(st.pad_ids[d])
        assert len(st.asm_src[d]) == n_src == st.asm_off[d][-1]
        n_real = int(np.sum(st.bd_gids_w[d] < st.N))
        assert len(st.bdw_src[d]) == n_real == st.bdw_off[d][-1] == st.bdw_off[d][st.N]


def test_nd_factor_solve_matches_jax(l4_system):
    """Port NDFactorizer against the JAX NDFactorizer (CPU configuration)
    on a forced-ND fem2d L=4 barrier Hessian, in the pattern of
    tests/test_ndsolve.py::test_real_newton_matrix_parity."""
    g, level, vals, gv = (l4_system[k] for k in ("g", "level", "vals", "gv"))
    basis = g.bases["dirichlet"][level]
    idx, m = np.asarray(basis.idx), int(basis.m)
    coords = jnd.node_coords(idx, m, np.asarray(g.x), basis.nq)
    fj = jnd.NDFactorizer(jnd.NDSymbolic(idx, m, 2, coords))
    assert not fj.use_inv and fj.chol == "xla" and fj.ea_mode == "fanin"
    cst = fj.consts()
    b = -gv.reshape(2, m + 1)[:, :m].T.reshape(-1)
    xj = np.asarray(
        jax.jit(lambda v, r, c: fj.solve(fj.factor(v, c), r, c))(
            jnp.asarray(vals), jnp.asarray(b), cst
        )
    )
    ft = tnd.NDFactorizer(tnd.NDSymbolic(idx, m, 2, coords))
    xt = ft.solve(ft.factor(torch.tensor(vals)), torch.tensor(b)).numpy()
    assert np.linalg.norm(xt - xj) / np.linalg.norm(xj) <= 1e-10
    # residual against the dense matrix assembled from the same vals
    pat = ths.HostPattern(idx, m, 2)
    N = pat.N
    H = np.zeros(N * N)
    H[pat.dense_pos] = vals
    H = H.reshape(N, N)
    real = (np.arange(2)[:, None] * (m + 1) + np.arange(m)[None, :]).reshape(-1)
    A = H[np.ix_(real, real)]
    x_fm = xt.reshape(m, 2).T.reshape(-1)
    b_fm = b.reshape(m, 2).T.reshape(-1)
    assert np.linalg.norm(A @ x_fm - b_fm) / np.linalg.norm(b_fm) <= 1e-10


def _jax_direction(ctx, level):
    """The JAX ND direction function (make_direction(None, n_cg=2)) and its
    index maps: the closure of the level's jitted nd_init program."""
    h = ctx._get_nd(level)
    raw = h["nd_init"].__wrapped__
    cells = dict(zip(raw.__code__.co_freevars, (c.cell_contents for c in raw.__closure__)))
    return cells["direction"], h["nd_consts"]


def test_nd_direction_matches_jax(l4_system):
    """The full ND direction (factor, solve, 2-trip CG polish with its
    quadratic-model choice) on the same vals/gv; then a front that is not
    positive definite, which both turn into the Jacobi fallback."""
    ctx, level, vals, gv, gt = (l4_system[k] for k in ("ctx", "level", "vals", "gv", "gt"))
    jdir, cst = _jax_direction(ctx, level)
    basis = gt.bases["dirichlet"][level]
    nd = tam._NDLevel(basis, 2, gt.x)
    m = basis.m
    dj = np.asarray(jdir(jnp.asarray(vals), jnp.asarray(gv), cst))
    dt = nd.direction(torch.tensor(vals), torch.tensor(gv)).numpy()
    assert dt.shape == (2, m + 1) and np.all(dt[:, m] == 0.0)
    assert _rel(dt, dj) <= 1e-10
    # a strongly negative diagonal entry: its front's Cholesky fails (NaN
    # in JAX, info > 0 in torch), the solve is NaN, and both fall back to
    # the Jacobi direction b / |diag|
    diag = nd.diag_ids.numpy()
    bad = vals.copy()
    bad[diag[0]] = -1e3 * abs(bad[diag[0]])
    dj = np.asarray(jdir(jnp.asarray(bad), jnp.asarray(gv), cst))
    dt = nd.direction(torch.tensor(bad), torch.tensor(gv)).numpy()
    b = -gv.reshape(2, m + 1)[:, :m]
    jacobi = b / np.maximum(np.abs(bad[diag]).reshape(m, 2).T, 1e-300)
    assert np.all(np.isfinite(dt))
    np.testing.assert_array_equal(dt[:, :m], jacobi)
    np.testing.assert_array_equal(dt, dj)


def _stage_its(log, t_max):
    """Newton iterations per (t, level) for t <= t_max, from a solve log."""
    out = {}
    for e in log:
        if e["t"] <= t_max:
            key = (float(e["t"]), int(e["level"]))
            out[key] = out.get(key, 0) + 1
    return out


def _nd_levels(geometry):
    (ctx,) = geometry.ctx_cache.values()
    return sorted(ctx.nd)


def test_fem2d_L3_forced_nd_matches_jax():
    b = Backend(dtype=jnp.float64, dense_threshold=64)
    sj = mgb.amgb(mgb.fem2d(L=3, backend=b), p=1.0)
    gt = mt.fem2d(L=3, backend=mt.backend_cpu(dense_threshold=64))
    st = mt.amgb(gt, p=1.0)
    assert _nd_levels(gt) == [2]
    assert st.SOL_main.its.tolist() == sj.SOL_main.its.tolist()
    cj, ct = float(sj.SOL_main.c_dot_Dz[-1]), float(st.SOL_main.c_dot_Dz[-1])
    assert abs(ct - cj) <= 1e-9 * abs(cj)


def test_fem2d_L4_forced_nd_matches_exact_objective(l4_system):
    sj = mgb.amgb(l4_system["g"], p=1.0)
    gt = l4_system["gt"]
    st = mt.amgb(gt, p=1.0)
    assert _nd_levels(gt) == [3]
    c = float(st.SOL_main.c_dot_Dz[-1])
    assert abs(c - C_EXACT_L4) < 5e-7 * C_EXACT_L4
    assert _stage_its(st.log, 1e4) == _stage_its(sj.log, 1e4)
    assert st.SOL_main.its[:-1].tolist() == sj.SOL_main.its[:-1].tolist()
