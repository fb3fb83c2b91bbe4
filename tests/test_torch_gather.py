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
segment_add_ (the forward sweep's in-place update) is held against the same
loop plus one add into the destination, the compact sweep tables of
NDSymbolic against the full-length update they replace, and the launch
plans (GatherPlan, SegmentPlan) against the general wrappers, exactly.
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


def _segment_of(off):
    return np.repeat(np.arange(len(off) - 1), np.diff(off))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", [1, 2])
def test_segment_add_plain_matches_add_at(f, dtype):
    """segment_add_ on CPU tensors: each listed row gains its run's sum,
    taken in list order from zero (np.add.at into zeros adds one entry at a
    time in that order), with one add into dst; exactly.  Rows that are
    not listed keep their bits."""
    src, lst, off, _, _ = _skewed_segments(300, f, seed=10 + f)
    src = src.astype(dtype)
    rng = np.random.default_rng(f)
    ids = np.sort(rng.permutation(1000)[:300]).astype(np.int32)
    dst = rng.standard_normal((1000, f) if f > 1 else 1000).astype(dtype)
    sums = np.zeros((300,) + src.shape[1:], dtype)
    np.add.at(sums, _segment_of(off), src[lst])
    ref = dst.copy()
    ref[ids] = ref[ids] + sums
    out_t = torch.from_numpy(dst.copy())
    ret = ck.segment_add_(out_t, torch.from_numpy(src), torch.from_numpy(lst),
                          torch.from_numpy(off), torch.from_numpy(ids))
    assert ret is out_t and out_t.dtype == torch.from_numpy(src).dtype
    np.testing.assert_array_equal(out_t.numpy(), ref)
    # a sequential scatter-add straight into dst rounds in another order
    seq = dst.copy()
    np.add.at(seq, ids[_segment_of(off)], src[lst])
    tol = 1e-13 if dtype == np.float64 else 1e-5
    assert np.max(np.abs(out_t.numpy() - seq)) <= tol * np.max(np.abs(seq))


@pytest.mark.parametrize("dtype", DTYPES)
def test_sweep_tables_reproduce_full_length_update(dtype):
    """The forward sweep's compact tables (bdw_ids, bdw_src, bdw_off) of a
    forced-ND fem2d L=4 symbolic: the in-place update of the touched dofs
    equals bg + segment_sum over one offset per entry of the (N+2,) sweep
    vector, bit for bit, for every front group."""
    sym = _nd_l4_symbolic()
    rng = np.random.default_rng(4)
    N = sym.N
    touched = 0
    for d in range(sym.ngroups):
        dst = sym.bd_gids_w[d].reshape(-1)
        upd = torch.from_numpy(rng.standard_normal(dst.size).astype(dtype))
        bg = torch.from_numpy(rng.standard_normal(N + 2).astype(dtype))
        keep = np.nonzero(dst < N)[0]
        full_src = keep[np.argsort(dst[keep], kind="stable")].astype(np.int32)
        full_off = np.concatenate(
            [[0], np.cumsum(np.bincount(dst[keep], minlength=N + 2))]
        ).astype(np.int32)
        ref = bg + ck.segment_sum(upd, torch.from_numpy(full_src), torch.from_numpy(full_off))
        np.testing.assert_array_equal(sym.bdw_src[d], full_src)
        i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
        out = ck.segment_add_(bg.clone(), upd, i32(sym.bdw_src[d]), i32(sym.bdw_off[d]),
                              i32(sym.bdw_ids[d]))
        assert torch.equal(out, ref)
        plan = ck.SegmentPlan(i32(sym.bdw_src[d]), i32(sym.bdw_off[d]), dst.size,
                              ids=i32(sym.bdw_ids[d]), ndst=N + 2)
        assert torch.equal(plan.add_(bg.clone(), upd), ref)
        touched += len(sym.bdw_ids[d])
    assert touched > 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", [1, 2])
def test_long_runs_sum_in_list_order(f, dtype):
    """Runs on both sides of the kernel's 64-entry cut (its long runs are
    gathered by a whole block and still added in list order): every run
    equals the sequential sum exactly, a run of zeros gives 0, and a run
    that holds a NaN gives NaN, as jax.ops.segment_sum does."""
    rng = np.random.default_rng(20 + f)
    counts = np.array([3, 2574, 0, 64, 65, 700, 5, 300, 257])
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    rows = int(off[-1])
    lst = rng.permutation(rows).astype(np.int32)
    src = rng.standard_normal((rows, f) if f > 1 else rows).astype(dtype)
    src[lst[off[1]:off[2]]] = 0.0  # the 2,574-entry run: zeros
    src[lst[off[5] + 123]] = np.nan  # inside the 700-entry run
    src[lst[off[7]:off[8]]] = 0.0
    src[lst[off[7] + 299]] = np.nan  # a zero run with one NaN at its end
    out = ck.segment_sum(torch.from_numpy(src), torch.from_numpy(lst), torch.from_numpy(off)).numpy()
    assert np.all(out[1] == 0.0) and np.all(out[2] == 0.0)
    assert np.all(np.isnan(out[5])) and np.all(np.isnan(out[7]))
    seg = np.asarray(jax.ops.segment_sum(
        jnp.asarray(src[lst]), jnp.asarray(_segment_of(off)), num_segments=len(counts)))
    np.testing.assert_array_equal(np.isnan(out), np.isnan(seg))
    tol = 1e-13 if dtype == np.float64 else 1e-5
    for a in range(len(counts)):
        ref = np.zeros(src.shape[1:], dtype)
        for row in src[lst[off[a]:off[a + 1]]]:
            ref = ref + row
        np.testing.assert_array_equal(out[a], ref)
        if not np.any(np.isnan(ref)):
            assert np.max(np.abs(out[a] - seg[a])) <= tol * np.nanmax(np.abs(seg))
    # the same through a plan, and in place
    plan = ck.SegmentPlan(torch.from_numpy(lst), torch.from_numpy(off), rows,
                          ids=torch.arange(len(counts), dtype=torch.int32), ndst=len(counts))
    np.testing.assert_array_equal(plan(torch.from_numpy(src)).numpy(), out)
    zero = torch.zeros(out.shape, dtype=torch.from_numpy(src).dtype)
    np.testing.assert_array_equal(plan.add_(zero, torch.from_numpy(src)).numpy(), out)


def test_coarse_levels_sum_long_real_runs_in_order():
    """He -> vals on every level of fem2d L=4: on the coarse levels a slot
    that the solver reads sums every element touching a coarse node, far
    more than the 64 entries above which the kernel hands a run to a whole
    block, so no run length separates real slots from pad slots and long
    runs, too, must be summed in list order.  Each level's values equal a
    sequential scatter-add in element order exactly."""
    from multigridbarrier_tpu_torch.solver import linsolve

    g = mt.fem2d(L=4, backend=mt.backend_cpu())
    rng = np.random.default_rng(6)
    longest_real = 0
    for basis in g.bases["dirichlet"]:
        table = linsolve.vals_table(basis.idx, basis.m, 2)
        lst, off = table.plan.lst.numpy(), table.plan.off.numpy()
        C = 2 * basis.nl
        He = rng.standard_normal((basis.nelem, C, C))
        ref = np.zeros(len(off) - 1)
        np.add.at(ref, _segment_of(off), He.reshape(-1)[lst])
        np.testing.assert_array_equal(linsolve.he_to_vals(torch.from_numpy(He), table).numpy(), ref)
        N = 2 * (basis.m + 1)
        pos = table.dense_pos.numpy()
        real = ((pos // N) % (basis.m + 1) != basis.m) & ((pos % N) % (basis.m + 1) != basis.m)
        longest_real = max(longest_real, int(np.diff(off)[real].max()))
    assert longest_real > 64


@pytest.mark.parametrize("case", range(4))
def test_gather_plan_matches_wrapper(case):
    name, shape, idx = _gather_cases()[case]
    v = torch.from_numpy(np.random.default_rng(case).standard_normal(shape))
    idx = torch.from_numpy(np.asarray(idx, np.int32))
    plan = ck.GatherPlan(idx, shape[0])
    assert torch.equal(plan(v), ck.row_gather(v, idx)), name
    assert torch.equal(plan(v.float()), ck.row_gather(v.float(), idx)), name


def test_segment_plan_matches_wrapper():
    for f in (1, 2):
        src, lst, off, _, _ = _skewed_segments(300, f, seed=f)
        src_t, lst_t, off_t = (torch.from_numpy(a) for a in (src, lst, off))
        plan = ck.SegmentPlan(lst_t, off_t, src.shape[0])
        assert torch.equal(plan(src_t), ck.segment_sum(src_t, lst_t, off_t))
        srt = torch.from_numpy(np.ascontiguousarray(src[lst]))
        plan2 = ck.SegmentPlan(None, off_t, srt.shape[0])
        assert torch.equal(plan2(srt), ck.segment_sum(srt, None, off_t))


def test_plans_check_their_tables_and_operands():
    idx = torch.tensor([0, 3, 1], dtype=torch.int32)
    off = torch.tensor([0, 2, 3], dtype=torch.int32)
    with pytest.raises(TypeError):
        ck.GatherPlan(idx.long(), 4)
    with pytest.raises(ValueError):
        ck.GatherPlan(torch.zeros((3, 2), dtype=torch.int32)[:, 0], 4)  # not contiguous
    with pytest.raises(ValueError):
        ck.GatherPlan(idx, 0)
    gp = ck.GatherPlan(idx, 4)
    with pytest.raises(TypeError):
        gp(torch.zeros(4, dtype=torch.float16))
    with pytest.raises(ValueError):
        gp(torch.zeros(5))  # leading size
    with pytest.raises(ValueError):
        gp(torch.zeros(4, device="meta"))  # another device than the plan's
    with pytest.raises(ValueError):
        gp(torch.zeros((4, 4))[:, :2])  # not contiguous
    with pytest.raises(TypeError):
        ck.SegmentPlan(idx, off.long(), 4)
    with pytest.raises(ValueError):
        ck.SegmentPlan(idx, torch.tensor([0, 2, 4], dtype=torch.int32), 4)  # past the list
    with pytest.raises(ValueError):
        ck.SegmentPlan(idx, off, 3)  # a list entry outside [0, rows)
    with pytest.raises(ValueError):
        ck.SegmentPlan(idx, off, 4, ids=torch.tensor([1, 1], dtype=torch.int32), ndst=5)
    sp = ck.SegmentPlan(idx, off, 4, ids=torch.tensor([4, 1], dtype=torch.int32), ndst=5)
    with pytest.raises(ValueError):
        sp(torch.zeros(3))
    with pytest.raises(TypeError):
        sp(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        sp.add_(torch.zeros(4), torch.zeros(4))  # dst leading size
    with pytest.raises(TypeError):
        sp.add_(torch.zeros(5, dtype=torch.float64), torch.zeros(4, dtype=torch.float32))
    with pytest.raises(ValueError):
        ck.SegmentPlan(idx, off, 4).add_(torch.zeros(5), torch.zeros(4))  # no ids
    with pytest.raises(ValueError):
        ck.segment_add_(torch.zeros(5), torch.zeros(4), idx, off,
                        torch.tensor([1], dtype=torch.int32))  # ids length
    out = sp.add_(torch.ones(5, dtype=torch.float64), torch.arange(4, dtype=torch.float64))
    assert out.tolist() == [1.0, 2.0, 1.0, 1.0, 4.0]
