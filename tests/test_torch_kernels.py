"""Parity of the port's kernel wrappers (multigridbarrier_tpu_torch.runtime.
cuda_kernels) with the JAX package.

On the CPU each wrapper computes its plain PyTorch version; those are held
against the JAX package's einsums, its Pallas kernel (interpret mode) and
its linsolve/LevelBasis functions on a real fem2d L=3 Newton system.  The
kernel-vs-plain cases on the card are in test_torch_cuda.py.

Tolerances: float64 results are compared as max|a-b| / max|b| <= 1e-13.
The two sides sum the same <= 28-term products in different orders, which
moves each entry by a few ulps of the largest term; 1e-13 leaves ~50x
headroom over that.  float32 against the Pallas kernel uses atol 1e-4, as
the JAX package's own Pallas test does.  The newer entries are held to the
JAX functions to 1e-12 (f64) and 1e-5 (f32) relative to the largest entry,
and to each other exactly where they do the same adds in the same order:
hvp_plain = table_sum_plain(element_matvec_plain(...)), the element-major
table sum = the permuted table_sum_plain transposed, the weighted
he_assemble = he_assemble_plain on the product F2 * w.
"""

import importlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multigridbarrier_tpu as mgb
from multigridbarrier_tpu.runtime.pallas_kernels import assemble_he_pallas
from multigridbarrier_tpu.solver import linsolve as jls

from multigridbarrier_tpu_torch.runtime import cuda_kernels as ck
from multigridbarrier_tpu_torch.solver import linsolve as tls
from multigridbarrier_tpu_torch import backend_cpu, interop

torch.set_num_threads(1)

jam = importlib.import_module("multigridbarrier_tpu.solver.amgb")

HE_SHAPES = [(8, 7, 4, 12), (16, 4, 3, 6)]


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _he_inputs(shape, dtype, seed=0):
    nelem, nq, k, C = shape
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((nelem, nq, k, C)).astype(dtype)
    W = rng.standard_normal((nelem, nq, k, k))
    W = (W + W.transpose(0, 1, 3, 2)).astype(dtype)
    return P, W


def _jax_he(P, W):
    T = jnp.einsum("eqjl,eqlc->eqjc", W, P)
    return np.asarray(jnp.einsum("eqjc,eqjd->ecd", P, T))


@pytest.mark.parametrize("shape", HE_SHAPES)
def test_he_assemble_plain_matches_jax_einsum_f64(shape):
    P, W = _he_inputs(shape, np.float64)
    out = ck.he_assemble(torch.from_numpy(P), torch.from_numpy(W))
    assert out.dtype == torch.float64 and tuple(out.shape) == (shape[0], shape[3], shape[3])
    assert _rel(out.numpy(), _jax_he(jnp.asarray(P), jnp.asarray(W))) <= 1e-13


@pytest.mark.parametrize("shape", HE_SHAPES)
def test_he_assemble_plain_matches_pallas_interpret_f32(shape):
    P, W = _he_inputs(shape, np.float32)
    ref = assemble_he_pallas(jnp.asarray(P), jnp.asarray(W), block_e=4, interpret=True)
    out = ck.he_assemble(torch.from_numpy(P), torch.from_numpy(W))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


@pytest.fixture(scope="module")
def l3_system():
    """The fine-level Newton system of fem2d L=3 at the default start point
    and t=1, built by the JAX package: He, idx, m, scatter_idx as numpy."""
    g = mgb.fem2d(L=3)
    spec = jam._normalize_D(jam.default_D(2))
    Q = jam.default_Q(2, 1.0)
    c = jax.vmap(jam.default_f(2, jnp.float64))(g.x)
    z0 = jax.vmap(jam.default_g(2, jnp.float64))(g.x)
    ctx = jam._SolverCtx(g, spec, Q.barrier, c)
    y = jam._apply_D(g.operators, spec, z0)
    Y2w = jax.vmap(jax.hessian(Q.barrier, argnums=1))(g.x, y) * g.w[:, None, None]
    basis = g.bases["dirichlet"][-1]
    nelem = basis.idx.shape[0]
    He = ctx._assemble_He(ctx._P[-1], Y2w.reshape(nelem, basis.nq, 4, 4))
    return dict(
        He=np.array(He),
        idx=np.array(basis.idx),
        m=int(basis.m),
        scatter_idx=np.array(basis.scatter_idx),
        jax_basis=basis,
        jax_geometry=g,
    )


def _systems(s):
    js = jls.LevelSystem(
        jnp.asarray(s["He"]), jnp.asarray(s["idx"]), s["m"], jnp.asarray(s["scatter_idx"])
    )
    ts = tls.LevelSystem(
        torch.tensor(s["He"]), torch.tensor(s["idx"]), s["m"], torch.tensor(s["scatter_idx"])
    )
    return js, ts


def test_hvp_plain_matches_jax_on_fem2d_L3(l3_system):
    js, ts = _systems(l3_system)
    m = l3_system["m"]
    rng = np.random.default_rng(1)
    vp = rng.standard_normal((2, m + 1))
    vp[:, m] = 0.0
    ref = np.asarray(jls.hvp(js, jnp.asarray(vp)))
    out = tls.hvp(ts, torch.from_numpy(vp))
    assert tuple(out.shape) == (2, m + 1)
    assert np.all(out[:, m].numpy() == 0.0)
    assert _rel(out.numpy(), ref) <= 1e-13


def test_diag_of_plain_matches_jax_on_fem2d_L3(l3_system):
    js, ts = _systems(l3_system)
    assert _rel(tls.diag_of(ts).numpy(), np.asarray(jls.diag_of(js))) <= 1e-13


@pytest.mark.parametrize("level", [0, 1, 2])
def test_scatter_add_plain_matches_jax_on_fem2d_L3(l3_system, level):
    gj = l3_system["jax_geometry"]
    gt = interop.geometry_from_arrays(interop.geometry_to_arrays(gj), backend_cpu())
    bj, bt = gj.bases["dirichlet"][level], gt.bases["dirichlet"][level]
    rng = np.random.default_rng(2 + level)
    flat = rng.standard_normal((bj.idx.shape[0] * bj.idx.shape[1], 2))
    ref = np.asarray(bj.scatter_add(jnp.asarray(flat)))
    out = bt.scatter_add(torch.from_numpy(flat))
    assert _rel(out.numpy(), ref) <= 1e-13
    # and the adjoint R' y built on it
    y = rng.standard_normal((bj.n, 2))
    assert _rel(bt.rmatvec(torch.from_numpy(y)).numpy(), np.asarray(bj.rmatvec(jnp.asarray(y)))) <= 1e-13


@pytest.fixture(scope="module")
def l3_bases(l3_system):
    """The dirichlet bases of fem2d L=3 in both packages, same arrays."""
    gj = l3_system["jax_geometry"]
    gt = interop.geometry_from_arrays(interop.geometry_to_arrays(gj), backend_cpu())
    return gj.bases["dirichlet"], gt.bases["dirichlet"]


@pytest.mark.parametrize("nf", [1, 2])
@pytest.mark.parametrize("level", [0, 1, 2])
def test_hvp_plain_is_matvec_then_table_sum_and_matches_jax(l3_bases, level, nf):
    """On every level of fem2d L=3 (table widths 32, 24, 6; nl 1, 4, 6) with
    seeded element blocks: the fused hvp's plain version is kernel B's then
    kernel C's exactly, through the wrapper, the plan and linsolve.hvp, and
    agrees with the JAX linsolve.hvp to 1e-12."""
    bj, bt = l3_bases[0][level], l3_bases[1][level]
    m, nl, nelem = bt.m, bt.nl, bt.nelem
    rng = np.random.default_rng(20 + 3 * level + nf)
    He = rng.standard_normal((nelem, nf * nl, nf * nl))
    vp = rng.standard_normal((nf, m + 1))
    vp[:, m] = 0.0
    He_t, vp_t = torch.from_numpy(He), torch.from_numpy(vp)
    two = ck.table_sum_plain(ck.element_matvec_plain(He_t, bt.idx, vp_t), bt.scatter_idx, m).T
    sys_t = tls.LevelSystem(He_t, bt.idx, m, bt.scatter_idx)
    for out in (ck.hvp_plain(He_t, bt.idx, bt.scatter_idx, vp_t, m),
                ck.hvp(He_t, bt.idx, bt.scatter_idx, vp_t, m),
                bt.table_plan.hvp(He_t, vp_t), tls.hvp(sys_t, vp_t)):
        assert tuple(out.shape) == (nf, m + 1) and out.is_contiguous()
        assert torch.equal(out, two)
        assert torch.all(out[:, m] == 0)
    sys_j = jls.LevelSystem(jnp.asarray(He), bj.idx, m, bj.scatter_idx)
    assert _rel(two.numpy(), np.asarray(jls.hvp(sys_j, jnp.asarray(vp)))) <= 1e-12


@pytest.mark.parametrize("nf", [1, 2, 3])
@pytest.mark.parametrize("level", [0, 1, 2])
def test_table_sum_em_plain_is_permuted_table_sum(l3_bases, level, nf):
    """The element-major / field-major table sum equals the permute copy,
    table_sum_plain and transpose it replaces, exactly: sentinel entries
    (rows shorter than the table is wide), a NaN source and the pad row
    included; through the wrapper, the plan and LevelBasis.scatter_add_em."""
    bt = l3_bases[1][level]
    m, nl, nelem, tbl = bt.m, bt.nl, bt.nelem, bt.scatter_idx
    rng = np.random.default_rng(40 + 3 * level + nf)
    em = rng.standard_normal((nelem, nf * nl))
    em[rng.integers(0, nelem), rng.integers(0, nf * nl)] = np.nan
    em = torch.from_numpy(em)
    flat = em.reshape(nelem, nf, nl).permute(0, 2, 1).reshape(-1, nf).contiguous()
    old = ck.table_sum_plain(flat, tbl, m).T
    assert torch.all(old[:, m] == 0)
    if level == 2:
        assert bool((tbl[:m] == nelem * nl).any())  # rows padded with the sentinel
    for out in (ck.table_sum_em_plain(em, tbl, m, nl), ck.table_sum_em(em, tbl, m, nl),
                bt.table_plan.em(em), bt.scatter_add_em(em)):
        assert tuple(out.shape) == (nf, m + 1) and out.is_contiguous()
        assert torch.equal(out.nan_to_num(nan=7.0), old.nan_to_num(nan=7.0))
    assert torch.equal(bt.table_plan(flat).nan_to_num(nan=7.0), old.T.nan_to_num(nan=7.0))
    assert torch.equal(bt.scatter_add(flat).nan_to_num(nan=7.0), old.T.nan_to_num(nan=7.0))


def _weighted_inputs(shape, dtype, seed=3):
    nelem, nq, k, C = shape
    rng = np.random.default_rng(seed)
    P = rng.standard_normal(shape).astype(dtype)
    F2 = rng.standard_normal((nelem * nq, k, k))
    F2 = (F2 + F2.transpose(0, 2, 1)).astype(dtype)
    w = rng.uniform(0.1, 2.0, nelem * nq).astype(dtype)
    return P, F2, w


@pytest.mark.parametrize("shape", HE_SHAPES)
def test_he_assemble_weighted_plain_matches_product_and_jax_f64(shape):
    """The weighted entry equals he_assemble_plain on F2 * w exactly (from
    F2 in both block orders, through the wrapper and the plan) and the JAX
    _SolverCtx._assemble_He on the same product to 1e-12."""
    nelem, nq, k, C = shape
    P, F2, w = _weighted_inputs(shape, np.float64)
    Pt, F2t, wt = torch.from_numpy(P), torch.from_numpy(F2), torch.from_numpy(w)
    W = (F2t * wt[:, None, None]).reshape(nelem, nq, k, k)
    want = ck.he_assemble_plain(Pt, W)
    blocks_t = F2t.transpose(1, 2).contiguous().transpose(1, 2)  # (l, j) in memory
    assert not blocks_t.is_contiguous() and torch.equal(blocks_t, F2t)
    plan = ck.HePlan(Pt, wt)
    for out in (ck.he_assemble_weighted_plain(Pt, F2t, wt), ck.he_assemble_weighted(Pt, F2t, wt),
                plan.weighted(F2t), plan.weighted(blocks_t), plan(W), ck.he_assemble(Pt, W)):
        assert torch.equal(out, want)
    ctx = types.SimpleNamespace(_use_pallas=False)
    ref = jam._SolverCtx._assemble_He(ctx, jnp.asarray(P), jnp.asarray(W.numpy()))
    assert _rel(want.numpy(), np.asarray(ref)) <= 1e-12


@pytest.mark.parametrize("shape", HE_SHAPES)
def test_he_assemble_weighted_plain_matches_pallas_interpret_f32(shape):
    nelem, nq, k, C = shape
    P, F2, w = _weighted_inputs(shape, np.float32)
    W = (F2 * w[:, None, None]).reshape(nelem, nq, k, k)
    ref = assemble_he_pallas(jnp.asarray(P), jnp.asarray(W), block_e=4, interpret=True)
    out = ck.HePlan(torch.from_numpy(P), torch.from_numpy(w)).weighted(torch.from_numpy(F2))
    assert out.dtype == torch.float32
    assert _rel(out.numpy(), np.asarray(ref)) <= 1e-5


def _plan_operands():
    P, F2, w = _weighted_inputs((4, 7, 4, 12), np.float64)
    W = np.ascontiguousarray((F2 * w[:, None, None]).reshape(4, 7, 4, 4))
    idx = torch.tensor([[0, 1, 2], [1, 2, 3], [2, 3, 3]], dtype=torch.int32)  # m = 3: pad slot 3
    tbl = torch.tensor([[0, 9], [1, 3], [2, 4], [9, 9]], dtype=torch.int32)
    return dict(P=torch.from_numpy(P), F2=torch.from_numpy(F2), w=torch.from_numpy(w),
                W=torch.from_numpy(W), idx=idx, tbl=tbl, m=3, nelem=3, nl=3,
                src=torch.zeros(9, 2, dtype=torch.float64),
                em=torch.zeros(3, 6, dtype=torch.float64),
                He=torch.zeros(3, 6, 6, dtype=torch.float64),
                vp=torch.zeros(2, 4, dtype=torch.float64))


# (case id, the error expected, a call on the operands that must raise it)
_PLAN_REJECTS = [
    ("he-W-dtype", TypeError, lambda o: ck.HePlan(o["P"])(o["W"].float())),
    ("he-W-device", ValueError, lambda o: ck.HePlan(o["P"])(o["W"].to("meta"))),
    ("he-W-shape", ValueError, lambda o: ck.HePlan(o["P"])(o["W"][:3])),
    ("he-W-strided", ValueError, lambda o: ck.HePlan(o["P"])(o["W"].transpose(2, 3))),
    ("he-P-strided", ValueError, lambda o: ck.HePlan(o["P"].transpose(2, 3))),
    ("he-P-dtype", TypeError, lambda o: ck.HePlan(o["P"].to(torch.float16))),
    ("he-w-shape", ValueError, lambda o: ck.HePlan(o["P"], o["w"][:-1])),
    ("he-w-dtype", TypeError, lambda o: ck.HePlan(o["P"], o["w"].float())),
    ("he-no-weights", ValueError, lambda o: ck.HePlan(o["P"]).weighted(o["F2"])),
    ("he-F2-dtype", TypeError, lambda o: ck.HePlan(o["P"], o["w"]).weighted(o["F2"].float())),
    ("he-F2-shape", ValueError, lambda o: ck.HePlan(o["P"], o["w"]).weighted(o["F2"][:-1])),
    ("he-F2-strided", ValueError,
     lambda o: ck.HePlan(o["P"], o["w"]).weighted(o["F2"].repeat(1, 1, 2)[:, :, ::2])),
    ("table-tbl-dtype", TypeError, lambda o: ck.TablePlan(o["tbl"].long(), 3, 3, 3)),
    ("table-tbl-shape", ValueError, lambda o: ck.TablePlan(o["tbl"], 4, 3, 3)),
    ("table-tbl-strided", ValueError, lambda o: ck.TablePlan(o["tbl"].T, 1, 3, 3)),
    ("table-tbl-negative", ValueError, lambda o: ck.TablePlan(o["tbl"] - 1, 3, 3, 3)),
    ("table-idx-range", ValueError,
     lambda o: ck.TablePlan(o["tbl"], 3, 3, 3, idx=o["idx"] + 1)),
    ("table-idx-shape", ValueError, lambda o: ck.TablePlan(o["tbl"], 3, 3, 3, idx=o["idx"][:2])),
    ("table-idx-device", ValueError,
     lambda o: ck.TablePlan(o["tbl"], 3, 3, 3, idx=o["idx"].to("meta"))),
    ("table-src-dtype", TypeError, lambda o: _table_plan(o)(o["src"].to(torch.float16))),
    ("table-src-rows", ValueError, lambda o: _table_plan(o)(o["src"][:8])),
    ("table-src-strided", ValueError, lambda o: _table_plan(o)(o["src"].repeat(1, 2)[:, ::2])),
    ("table-src-device", ValueError, lambda o: _table_plan(o)(o["src"].to("meta"))),
    ("table-em-columns", ValueError, lambda o: _table_plan(o).em(o["em"][:, :5].contiguous())),
    ("table-em-rows", ValueError, lambda o: _table_plan(o).em(o["em"][:2])),
    ("table-em-strided", ValueError, lambda o: _table_plan(o).em(o["em"].T.contiguous().T)),
    ("hvp-no-idx", ValueError,
     lambda o: ck.TablePlan(o["tbl"], 3, 3, 3).hvp(o["He"], o["vp"])),
    ("hvp-He-shape", ValueError, lambda o: _table_plan(o).hvp(o["He"][:, :5, :5].contiguous(), o["vp"])),
    ("hvp-vp-shape", ValueError, lambda o: _table_plan(o).hvp(o["He"], o["vp"][:, :3].contiguous())),
    ("hvp-dtypes", TypeError, lambda o: _table_plan(o).hvp(o["He"], o["vp"].float())),
    ("hvp-He-strided", ValueError, lambda o: _table_plan(o).hvp(o["He"].transpose(1, 2), o["vp"])),
    ("hvp-wrapper-idx-dtype", TypeError,
     lambda o: ck.hvp(o["He"], o["idx"].long(), o["tbl"], o["vp"], 3)),
    ("em-wrapper-tbl-shape", ValueError, lambda o: ck.table_sum_em(o["em"], o["tbl"], 2, 3)),
]


def _table_plan(o):
    return ck.TablePlan(o["tbl"], o["m"], o["nelem"], o["nl"], idx=o["idx"])


@pytest.mark.parametrize("case", _PLAN_REJECTS, ids=[c[0] for c in _PLAN_REJECTS])
def test_plans_reject_bad_operands(case):
    """HePlan and TablePlan raise on a wrong dtype, device, shape or a
    non-contiguous operand, at binding time for the static operands and per
    call for the float operand; the same plans accept the good operands."""
    _, error, call = case
    o = _plan_operands()
    he, tab = ck.HePlan(o["P"], o["w"]), _table_plan(o)
    assert tuple(he(o["W"]).shape) == (4, 12, 12) and torch.equal(he.weighted(o["F2"]), he(o["W"]))
    assert tuple(tab(o["src"]).shape) == (4, 2) and tuple(tab.em(o["em"]).shape) == (2, 4)
    assert tuple(tab.hvp(o["He"], o["vp"]).shape) == (2, 4)
    with pytest.raises(error):
        call(o)


def test_wrappers_reject_bad_inputs():
    P, W = _he_inputs((4, 7, 4, 12), np.float64)
    Pt, Wt = torch.from_numpy(P), torch.from_numpy(W)
    with pytest.raises(ValueError):
        ck.he_assemble(Pt.to("meta"), Wt.to("meta"))  # neither CPU nor CUDA
    with pytest.raises(TypeError):
        ck.he_assemble(Pt, Wt.float())
    with pytest.raises(ValueError):
        ck.he_assemble(Pt.transpose(2, 3), Wt)
    with pytest.raises(TypeError):
        ck.table_sum(torch.zeros(6, 2, dtype=torch.float64), torch.zeros(3, 2, dtype=torch.int64), 2)


# Wide elements (hexahedra): above C = 32 or nq*k = 64 HePlan takes the
# wide kernel on the card; on the CPU both are the plain version.
WIDE_SHAPES = [(4, 27, 5, 54), (2, 64, 5, 128)]


@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_he_assemble_wide_shapes_match_jax_einsum_f64(shape):
    """he_assemble_plain and HePlan (both entries, F2 in both block orders)
    at the 3D element shapes against the JAX _assemble_He einsum to 1e-12;
    HePlan no longer refuses C > 32."""
    nelem, nq, k, C = shape
    P, F2, w = _weighted_inputs(shape, np.float64)
    Pt, F2t, wt = torch.from_numpy(P), torch.from_numpy(F2), torch.from_numpy(w)
    W = (F2t * wt[:, None, None]).reshape(nelem, nq, k, k)
    plan = ck.HePlan(Pt, wt)
    assert plan.kernel == "wide" and (plan.C > 32 or plan.nq * plan.k > 64)
    want = ck.he_assemble_plain(Pt, W)
    assert tuple(want.shape) == (nelem, C, C)
    blocks_t = F2t.transpose(1, 2).contiguous().transpose(1, 2)
    for out in (plan(W), plan.weighted(F2t), plan.weighted(blocks_t), ck.he_assemble(Pt, W),
                ck.he_assemble_weighted(Pt, F2t, wt)):
        assert torch.equal(out, want)
    ctx = types.SimpleNamespace(_use_pallas=False)
    ref = jam._SolverCtx._assemble_He(ctx, jnp.asarray(P), jnp.asarray(W.numpy()))
    assert _rel(want.numpy(), np.asarray(ref)) <= 1e-12


@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_he_assemble_wide_shapes_match_pallas_interpret_f32(shape):
    nelem, nq, k, C = shape
    P, F2, w = _weighted_inputs(shape, np.float32)
    W = (F2 * w[:, None, None]).reshape(nelem, nq, k, k)
    ref = assemble_he_pallas(jnp.asarray(P), jnp.asarray(W), block_e=2, interpret=True)
    plan = ck.HePlan(torch.from_numpy(P), torch.from_numpy(w))
    for out in (plan.weighted(torch.from_numpy(F2)), plan(torch.from_numpy(W))):
        assert out.dtype == torch.float32
        assert _rel(out.numpy(), np.asarray(ref)) <= 1e-5


@pytest.mark.parametrize("shape,kernel", [
    ((8, 7, 4, 12), "narrow"), ((8, 7, 5, 18), "narrow"), ((8, 8, 5, 16), "narrow"),
    ((8, 7, 4, 33), "wide"), ((2, 17, 4, 12), "wide"), ((2, 64, 7, 256), "wide"),
    ((1, 1, 40, 3), "narrow"), ((1, 2, 40, 3), "wide"),
])
def test_he_plan_picks_its_kernel_by_shape(shape, kernel):
    """Narrow where C <= 32 and nq*k <= 64, wide otherwise; the wide kernel
    may be asked for at any shape, the narrow one only inside its limits."""
    P = torch.zeros(shape, dtype=torch.float64)
    assert ck.HePlan(P).kernel == kernel
    assert ck.HePlan(P, kernel="wide").kernel == "wide"
    if kernel == "wide":
        with pytest.raises(ValueError, match="narrow"):
            ck.HePlan(P, kernel="narrow")
    with pytest.raises(ValueError, match="kernel="):
        ck.HePlan(P, kernel="tensor-core")
