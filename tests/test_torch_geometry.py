"""Geometry parity of the PyTorch port with the JAX package.

Every array of the port's fem2d(L) equals the JAX package's for L=1..4:
index arrays exactly, floats to max|a-b| / max|b| <= 1e-14 (both sides run
the same host numpy/scipy construction, so they agree to round-off of the
final dtype casts at most).  The interop dict format round-trips.
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


@pytest.mark.parametrize("L", [1, 2, 3, 4])
def test_fem2d_arrays_match_jax(L):
    gj = mgb.fem2d(L=L)
    gt = mt.fem2d(L=L, backend=mt.backend_cpu())
    aj = interop.geometry_to_arrays(gj)
    at = interop.geometry_to_arrays(gt)
    _assert_same_arrays(aj, at)
    n = 14 * 4 ** (L - 1)
    assert gt.n == n and gt.levels == L
    assert gt.subspace_dims() == gj.subspace_dims()
    assert all(t.device.type == "cpu" for t in (gt.x, gt.w))


@pytest.mark.parametrize("L", [2, 3])
def test_interop_round_trip(L):
    gt = mt.fem2d(L=L, backend=mt.backend_cpu())
    arrays = interop.geometry_to_arrays(gt)
    g2 = interop.geometry_from_arrays(arrays, mt.backend_cpu())
    _assert_same_arrays(arrays, interop.geometry_to_arrays(g2))
    assert g2.operators["id"].is_identity and not g2.operators["dx"].is_identity
    assert [b.m for b in g2.bases["dirichlet"]] == [b.m for b in gt.bases["dirichlet"]]
    assert g2.x.dtype == torch.float64 and g2.bases["dirichlet"][-1].idx.dtype == torch.int32


def test_interop_from_jax_geometry_matches_port_fem2d():
    """A JAX geometry carried over by interop equals the port's own fem2d."""
    g = interop.geometry_from_arrays(
        interop.geometry_to_arrays(mgb.fem2d(L=3)), mt.backend_cpu()
    )
    _assert_same_arrays(
        interop.geometry_to_arrays(mt.fem2d(L=3, backend=mt.backend_cpu())),
        interop.geometry_to_arrays(g),
    )


def test_level_basis_operators_match_jax():
    """R v and R' y of every level agree with the JAX LevelBasis."""
    gj, gt = mgb.fem2d(L=3), mt.fem2d(L=3, backend=mt.backend_cpu())
    rng = np.random.default_rng(0)
    for bj, bt in zip(gj.bases["dirichlet"], gt.bases["dirichlet"]):
        v = rng.standard_normal((bt.m, 2))
        np.testing.assert_allclose(
            bt.matvec(torch.from_numpy(v)).numpy(), np.asarray(bj.matvec(v)), rtol=1e-13, atol=1e-13
        )
    for name in ("dx", "dy"):
        z = rng.standard_normal(gt.n)
        np.testing.assert_allclose(
            gt.operators[name].matvec(torch.from_numpy(z)).numpy(),
            np.asarray(gj.operators[name].matvec(z)),
            rtol=1e-12,
            atol=1e-12,
        )
