"""Geometry parity of the port's fem1d and fem3d with the JAX package.

Every array of fem1d(L), L=1..4, and of fem3d(L, k) for (1,3), (2,2),
(2,3), (2,1) and a custom coarse mesh K equals the JAX package's: index
arrays (idx, the scatter and pair tables, Ell columns) exactly, floats (x,
w, operator blocks, rloc, Ell values of subspaces, refine, coarsen, embed)
to max|a-b| / max|b| <= 1e-14 — both sides run the same host numpy/scipy
construction, node numbering by np.unique over rounded coordinates
included, so they agree to the round-off of the final casts at most.  The
interop dict carries both families (operator 'dz', the numeric payload
entries) and round-trips.
"""

import numpy as np
import pytest
import torch

import multigridbarrier_tpu as mgb

import multigridbarrier_tpu_torch as mt
from multigridbarrier_tpu_torch import interop

torch.set_num_threads(1)


def _assert_same_arrays(aj: dict, at: dict):
    assert sorted(aj) == sorted(at)
    for key in aj:
        a, b = np.asarray(at[key]), np.asarray(aj[key])
        assert a.shape == b.shape, key
        if np.issubdtype(b.dtype, np.floating):
            assert a.dtype == b.dtype, key
            scale = max(float(np.max(np.abs(b))), 1e-300) if b.size else 1.0
            assert float(np.max(np.abs(a - b), initial=0.0)) <= 1e-14 * scale, key
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)


def _two_boxes():
    """Two stacked unit boxes, 8 corner rows each in binary (i, j, k) order."""
    return np.asarray(
        [[i, j, z0 + kk] for z0 in (0.0, 1.0) for kk in range(2) for j in range(2)
         for i in range(2)], dtype=float)


@pytest.mark.parametrize("L", [1, 2, 3, 4])
def test_fem1d_arrays_match_jax(L):
    gj = mgb.fem1d(L=L)
    gt = mt.fem1d(L=L, backend=mt.backend_cpu())
    _assert_same_arrays(interop.geometry_to_arrays(gj), interop.geometry_to_arrays(gt))
    assert gt.n == 2 ** (L + 1) and gt.levels == L and gt.dim == 1
    assert gt.subspace_dims() == gj.subspace_dims()
    assert gt.discretization.name == "fem1d" and gt.discretization.payload["h"] == 2.0 / 2 ** L
    assert sorted(gt.operators) == ["dx", "id"]


FEM3D_CASES = {
    "L1k3": dict(L=1, k=3),
    "L2k2": dict(L=2, k=2),
    "L2k3": dict(L=2, k=3),
    "L2k1": dict(L=2, k=1),
    "custom-K": dict(L=2, k=2, K=_two_boxes()),
}


@pytest.mark.parametrize("case", sorted(FEM3D_CASES))
def test_fem3d_arrays_match_jax(case):
    kw = FEM3D_CASES[case]
    gj = mgb.fem3d(**kw)
    gt = mt.fem3d(**kw, backend=mt.backend_cpu())
    _assert_same_arrays(interop.geometry_to_arrays(gj), interop.geometry_to_arrays(gt))
    k, L = kw["k"], kw["L"]
    nh = (2 if "K" in kw else 1) * 8 ** (L - 1)
    assert gt.n == nh * (k + 1) ** 3 and gt.levels == L and gt.dim == 3
    assert gt.subspace_dims() == gj.subspace_dims()
    d = gt.discretization
    assert d.name == "fem3d" and d.nq == (k + 1) ** 3 and d.payload["k"] == k
    assert sorted(gt.operators) == ["dx", "dy", "dz", "id"]
    assert abs(float(gt.w.sum()) - (2.0 if "K" in kw else 8.0)) < 1e-12


@pytest.mark.parametrize("family", ["fem1d", "fem3d"])
def test_interop_round_trip_and_from_jax(family):
    """The dict round-trips, and a JAX geometry carried over by interop
    equals the port's own (payload included)."""
    if family == "fem1d":
        gj, gt = mgb.fem1d(L=3), mt.fem1d(L=3, backend=mt.backend_cpu())
        payload = ("h", "nodes")
    else:
        gj, gt = mgb.fem3d(L=2, k=2), mt.fem3d(L=2, k=2, backend=mt.backend_cpu())
        payload = ("hexes", "k", "verts")
    arrays = interop.geometry_to_arrays(gt)
    assert all(f"disc/payload/{key}" in arrays for key in payload)
    g2 = interop.geometry_from_arrays(arrays, mt.backend_cpu())
    _assert_same_arrays(arrays, interop.geometry_to_arrays(g2))
    assert tuple(sorted(g2.discretization.payload)) == payload
    assert g2.discretization.name == family and sorted(g2.operators) == sorted(gt.operators)
    assert g2.x.dtype == torch.float64 and g2.bases["dirichlet"][-1].idx.dtype == torch.int32
    gc = interop.geometry_from_arrays(interop.geometry_to_arrays(gj), mt.backend_cpu())
    _assert_same_arrays(arrays, interop.geometry_to_arrays(gc))


def test_fem3d_operators_and_bases_match_jax():
    """dx, dy, dz and R v of every level agree with the JAX package, and the
    derivative blocks are exact on Q_k."""
    gj, gt = mgb.fem3d(L=2, k=2), mt.fem3d(L=2, k=2, backend=mt.backend_cpu())
    rng = np.random.default_rng(0)
    for bj, bt in zip(gj.bases["dirichlet"], gt.bases["dirichlet"]):
        v = rng.standard_normal((bt.m, 2))
        np.testing.assert_allclose(
            bt.matvec(torch.from_numpy(v)).numpy(), np.asarray(bj.matvec(v)), rtol=1e-13, atol=1e-13)
    for name in ("dx", "dy", "dz"):
        z = rng.standard_normal(gt.n)
        np.testing.assert_allclose(
            gt.operators[name].matvec(torch.from_numpy(z)).numpy(),
            np.asarray(gj.operators[name].matvec(z)), rtol=1e-12, atol=1e-12)
    x = gt.x
    u = x[:, 0] ** 2 * x[:, 1] - x[:, 2] ** 2
    np.testing.assert_allclose(gt.operators["dx"].matvec(u).numpy(),
                               (2 * x[:, 0] * x[:, 1]).numpy(), atol=1e-11)
    np.testing.assert_allclose(gt.operators["dz"].matvec(u).numpy(), (-2 * x[:, 2]).numpy(),
                               atol=1e-11)
