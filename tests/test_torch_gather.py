"""Kernel D (row_gather, take_along_rows) and kernel C's CSR entry
(segment_sum) of the port: their plain PyTorch versions, which are what a
CPU tensor runs, against the functions the TPU kernels compute.

The probe kernels pallas_take and pallas_tala (tools/probe_pallas_gather.py
:83 and :58) compute v[idx] along rows, the second through
take_along_axis(..., mode="clip") with the index broadcast to the output
shape; both are checked against jnp.take / jnp.take_along_axis on the same
numpy inputs.  A gather is a copy, so these agree exactly.  The segment sum
is held exactly against a sequential numpy loop in list order (the order
the kernel sums in, which is what makes two runs repeat bit for bit), and
to 1e-13 rel against jax.ops.segment_sum, which may add in another order.
The CUDA kernels themselves are held against these plain versions in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multigridbarrier_tpu_torch as mt
from multigridbarrier_tpu_torch.runtime import cuda_kernels as ck
from multigridbarrier_tpu_torch.solver.ndsolve import NDSymbolic, node_coords

DTYPES = [np.float64, np.float32]


@functools.lru_cache(maxsize=None)
def _nd_l4_symbolic():
    g = mt.fem2d(L=4, backend=mt.backend_cpu())
    basis = g.bases["dirichlet"][-1]
    idx = basis.idx.numpy()
    coords = node_coords(idx, basis.m, g.x.numpy(), basis.nq)
    return NDSymbolic(idx, basis.m, 2, coords)


def _gather_cases():
    """(name, v shape, idx) — the probe's shape and the ND path's gathers
    at fem2d L=4: the front-assembly source gather (1-D), a sweep gather
    with a 2-D index, and the pair matvec's (m, nf) row gather."""
    rng = np.random.default_rng(0)
    sym = _nd_l4_symbolic()
    nsrc = sym.nvals + int(sym.sb_off[-1]) + 1
    d = sym.ngroups - 1
    return [
        ("probe", (16130, 128), rng.integers(0, 16130, 49152)),
        ("nd_assembly", (nsrc,), sym.asm_src[d]),
        ("nd_sweep", (sym.N + 2,), sym.sep_gids[0]),
        ("nd_pair", (sym.m, 2), sym.pair_j),
    ]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", range(4))
def test_row_gather_plain_matches_take(case, dtype):
    name, shape, idx = _gather_cases()[case]
    rng = np.random.default_rng(case)
    v = rng.standard_normal(shape).astype(dtype)
    idx = np.asarray(idx, np.int32)
    out = ck.row_gather(torch.from_numpy(v), torch.from_numpy(idx))
    ref = np.asarray(jnp.take(jnp.asarray(v), jnp.asarray(idx), axis=0))
    assert out.dtype == torch.from_numpy(v).dtype
    assert tuple(out.shape) == idx.shape + shape[1:] == ref.shape, name
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), v[idx])


@pytest.mark.parametrize("dtype", DTYPES)
def test_gathers_clamp_stray_indices(dtype):
    rng = np.random.default_rng(1)
    v = rng.standard_normal((37, 3)).astype(dtype)
    idx = np.array([-5, 0, 36, 37, 1000, 12], np.int32)
    ref = np.asarray(jnp.take(jnp.asarray(v), jnp.asarray(idx), axis=0, mode="clip"))
    out = ck.row_gather(torch.from_numpy(v), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), v[np.clip(idx, 0, 36)])
    idx2 = rng.integers(0, 50, size=(20, 3)).astype(np.int32)
    ref2 = np.asarray(
        jnp.take_along_axis(jnp.asarray(v), jnp.asarray(idx2), axis=0, mode="clip")
    )
    out2 = ck.take_along_rows(torch.from_numpy(v), torch.from_numpy(idx2))
    np.testing.assert_array_equal(out2.numpy(), ref2)
    # a negative index clamps to row 0 (jnp.take_along_axis would first wrap
    # it Python-style; the kernels never wrap)
    idx2[0] = -3
    out3 = ck.take_along_rows(torch.from_numpy(v), torch.from_numpy(idx2))
    np.testing.assert_array_equal(
        out3.numpy(), np.take_along_axis(v, np.clip(idx2, 0, 36), axis=0)
    )


@pytest.mark.parametrize("dtype", DTYPES)
def test_take_along_rows_plain_matches_probe(dtype):
    """pallas_tala: idx broadcast to the (rows, lanes) output, at the probe's
    shapes; and a per-element index."""
    rng = np.random.default_rng(2)
    v = rng.standard_normal((16130, 128)).astype(dtype)
    idx = rng.integers(0, 16130, 49152).astype(np.int32)
    idx2 = np.ascontiguousarray(np.broadcast_to(idx[:, None], (49152, 128)))
    out = ck.take_along_rows(torch.from_numpy(v), torch.from_numpy(idx2))
    ref = np.asarray(
        jnp.take_along_axis(jnp.asarray(v), jnp.asarray(idx2), axis=0, mode="clip")
    )
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), v[idx])
    idx3 = rng.integers(0, 16130, (500, 128)).astype(np.int32)
    out3 = ck.take_along_rows(torch.from_numpy(v), torch.from_numpy(idx3))
    np.testing.assert_array_equal(out3.numpy(), np.take_along_axis(v, idx3, axis=0))


def test_gather_wrappers_check_inputs():
    v = torch.zeros(4, 2)
    with pytest.raises(TypeError):
        ck.row_gather(v, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        ck.take_along_rows(v, torch.zeros((3, 1), dtype=torch.int32))
    with pytest.raises(ValueError):
        ck.row_gather(torch.zeros((0, 2)), torch.zeros(3, dtype=torch.int32))


def _skewed_segments(nseg, f, seed):
    """A source list with skewed fan-in (most segments 0-3 sources, a few
    up to 34, as the fem2d L=7 front assembly has), sorted stably by
    destination."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 4, nseg)
    counts[rng.integers(0, nseg, 5)] = 34
    dst = np.repeat(np.arange(nseg), counts)
    rng.shuffle(dst)
    rows = len(dst) + 7
    src = rng.standard_normal((rows, f) if f > 1 else rows)
    pos = rng.permutation(rows)[: len(dst)]  # source row of each contribution
    order = np.argsort(dst, kind="stable")
    lst = pos[order].astype(np.int32)
    off = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=nseg))]).astype(np.int32)
    return src, lst, off, dst, pos


@pytest.mark.parametrize("f", [1, 2])
def test_segment_sum_plain_sums_in_list_order(f):
    src, lst, off, dst, pos = _skewed_segments(300, f, seed=f)
    out = ck.segment_sum(torch.from_numpy(src), torch.from_numpy(lst), torch.from_numpy(off))
    ref = np.zeros((300,) + src.shape[1:])
    for a in range(300):
        for j in range(off[a], off[a + 1]):
            ref[a] = ref[a] + src[lst[j]]
    np.testing.assert_array_equal(out.numpy(), ref)
    seg = np.asarray(jax.ops.segment_sum(jnp.asarray(src[pos]), jnp.asarray(dst), num_segments=300))
    assert np.max(np.abs(out.numpy() - seg)) <= 1e-13 * np.max(np.abs(seg))
    # without a list: src already in destination order
    srt = src[lst]
    out2 = ck.segment_sum(torch.from_numpy(np.ascontiguousarray(srt)), None, torch.from_numpy(off))
    np.testing.assert_array_equal(out2.numpy(), ref)
