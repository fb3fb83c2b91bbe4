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
the JAX package's own Pallas test does.
"""

import importlib

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
