"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: max|kernel - plain| / max|plain| <= 1e-12 in float64 and 1e-5
in float32 (TF32 off) for A, B and the fused hvp against their plain
versions: those are einsums, which sum the same short products in other
orders, a few ulps apart.  Among themselves the entries of a kernel are
held to exact equality: HePlan against he_assemble, the weighted entry
against he_assemble on the product F2 * w, the fused hvp against kernel B
followed by kernel C.  Kernel D is a copy, and C's table_sum (both
layouts), segment_sum and segment_add_ add in table or list order like
their plain versions (also the runs of more than 64 entries that a whole
block gathers), so they are held to exact equality, NaN for NaN.  Kernel
A's wide form (he_assemble_wide, hexahedra and three or more fields) is
held like the narrow one: to the plain version within the tolerance,
exactly among its entries and between two calls, and to the narrow kernel
at the shapes both take: exactly in float32 (one summation order), within
1e-13 relative in float64, where the wide kernel sums on the tensor cores
(DMMA), which may add the products of an instruction in another order.  The dense L=3 solve agrees with the CPU run to 1e-9
rel, the tolerance the CPU tests hold the JAX package to.  The forced-ND
L=4 solve is held as the CPU tests hold it against JAX: its and c_dot_Dz
of every t-stage through t=1e4 (c to 1e-9 rel), and the final c_dot_Dz
within 5e-7 rel of C_EXACT[4].  Its last stages sit at the f64 floor,
where the round-off of two LAPACK builds decides how long the endgame
grinds (on an H100 the final c of the two runs differed by 6.9e-9 rel,
both within 6.3e-9 of the pin).
"""

import numpy as np
import pytest
import torch

import multigridbarrier_tpu_torch as mt
from multigridbarrier_tpu_torch.runtime import cuda_kernels as ck
from multigridbarrier_tpu_torch.solver import linsolve

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
C_EXACT_L4 = 50.618082533590  # tests/test_ground_truth.py C_EXACT[4]
# the last four: one element, element counts that are no multiple of the
# elements per CTA, and a C that takes the kernel's generic instantiation
HE_SHAPES = [(8, 7, 4, 12), (16, 4, 3, 6), (2048, 7, 4, 12), (1, 7, 4, 12), (37, 7, 4, 12),
             (2051, 7, 4, 12), (5, 3, 2, 7)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", HE_SHAPES)
def test_he_assemble_kernel_matches_plain(cuda, shape, dtype):
    nelem, nq, k, C = shape
    rng = np.random.default_rng(0)
    W = rng.standard_normal((nelem, nq, k, k))
    P = torch.tensor(rng.standard_normal(shape), dtype=dtype, device=cuda)
    W = torch.tensor(W + W.transpose(0, 1, 3, 2), dtype=dtype, device=cuda)
    n0 = ck.LAUNCHES["he_assemble"]
    out = ck.he_assemble(P, W)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["he_assemble"] == n0 + 1
    assert _rel(out, ck.he_assemble_plain(P, W)) <= TOL[dtype]
    assert torch.equal(ck.HePlan(P)(W), out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", HE_SHAPES)
def test_he_assemble_weighted_kernel_matches_product(cuda, shape, dtype):
    """W = F2 * w formed inside the kernel gives the bits of he_assemble on
    the product formed by PyTorch, from F2 in both block orders."""
    nelem, nq, k, C = shape
    rng = np.random.default_rng(1)
    P = torch.tensor(rng.standard_normal(shape), dtype=dtype, device=cuda)
    F2 = torch.tensor(rng.standard_normal((nelem * nq, k, k)), dtype=dtype, device=cuda)
    w = torch.tensor(rng.uniform(0.1, 2.0, nelem * nq), dtype=dtype, device=cuda)
    plan = ck.HePlan(P, w)
    want = ck.he_assemble(P, (F2 * w[:, None, None]).reshape(nelem, nq, k, k))
    F2t = F2.transpose(1, 2).contiguous().transpose(1, 2)  # same values, (l, j) in memory
    assert not F2t.is_contiguous() or k == 1
    n0 = ck.LAUNCHES["he_assemble"]
    got = (plan.weighted(F2), plan.weighted(F2t), ck.he_assemble_weighted(P, F2, w))
    torch.cuda.synchronize()
    assert ck.LAUNCHES["he_assemble"] == n0 + 3
    assert all(torch.equal(g, want) for g in got)
    assert _rel(want, ck.he_assemble_weighted_plain(P, F2, w)) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_he_assemble_nan_stays_in_its_element(cuda, dtype):
    """A NaN in W reaches every entry of its element's He and no other
    element's, whatever block of elements a CTA stages together."""
    shape = (40, 7, 4, 12)
    rng = np.random.default_rng(2)
    P = torch.tensor(rng.standard_normal(shape), dtype=dtype, device=cuda)
    F2 = torch.tensor(rng.standard_normal((40 * 7, 4, 4)), dtype=dtype, device=cuda)
    w = torch.ones(40 * 7, dtype=dtype, device=cuda)
    clean = ck.HePlan(P, w).weighted(F2)
    for e in (0, 14, 15, 39):
        bad = F2.clone()
        bad[e * 7 + 3, 1, 2] = float("nan")
        for out in (ck.HePlan(P, w).weighted(bad), ck.he_assemble(P, bad.reshape(40, 7, 4, 4))):
            torch.cuda.synchronize()
            assert bool(out[e].isnan().all())
            keep = torch.arange(40, device=cuda) != e
            assert torch.equal(out[keep], clean[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("level", [0, 2, 3])
def test_hvp_kernels_match_plain(cuda, level, dtype):
    """Kernels B then C on the fem2d L=4 bases (table widths 128, 24, 6)."""
    basis = mt.fem2d(L=4, backend=mt.backend_cuda()).bases["dirichlet"][level]
    m, nl = basis.m, basis.nl
    rng = np.random.default_rng(level)
    He = torch.tensor(rng.standard_normal((basis.nelem, 2 * nl, 2 * nl)), dtype=dtype, device=cuda)
    vp = torch.tensor(rng.standard_normal((2, m + 1)), dtype=dtype, device=cuda)
    flat = ck.element_matvec(He, basis.idx, vp)
    flat_ref = ck.element_matvec_plain(He, basis.idx, vp)
    out = ck.table_sum(flat, basis.scatter_idx, m)
    out_ref = ck.table_sum_plain(flat_ref, basis.scatter_idx, m)
    torch.cuda.synchronize()
    assert _rel(flat, flat_ref) <= TOL[dtype]
    assert _rel(out, out_ref) <= TOL[dtype]
    assert torch.all(out[m] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_table_plan_and_fused_hvp_match(cuda, level, dtype):
    """On the fem2d L=4 bases (m = 1, 9, 49, 225; table widths from 6 to
    hundreds): table_sum in both layouts, through the wrappers and the
    plan, equals its plain version exactly (sentinel entries, NaN sources
    and the pad row included), and the fused hvp equals kernel B followed
    by kernel C exactly and its plain version to the tolerance."""
    basis = mt.fem2d(L=4, backend=mt.backend_cuda()).bases["dirichlet"][level]
    m, nl, nelem, tbl = basis.m, basis.nl, basis.nelem, basis.scatter_idx
    plan = basis.table_plan
    rng = np.random.default_rng(10 + level)
    for nf in (1, 2, 3):
        em = torch.tensor(rng.standard_normal((nelem, nf * nl)), dtype=dtype, device=cuda)
        em[rng.integers(0, nelem), rng.integers(0, nf * nl)] = float("nan")
        flat = em.reshape(nelem, nf, nl).permute(0, 2, 1).reshape(-1, nf).contiguous()
        ref = ck.table_sum_plain(flat, tbl, m)
        n0 = ck.LAUNCHES["table_sum"]
        outs = (ck.table_sum(flat, tbl, m), plan(flat))
        outs_em = (ck.table_sum_em(em, tbl, m, nl), plan.em(em))
        torch.cuda.synchronize()
        assert ck.LAUNCHES["table_sum"] == n0 + 4
        for out in outs:
            assert torch.equal(out.nan_to_num(nan=7.0), ref.nan_to_num(nan=7.0))
        for out in outs_em:
            assert out.is_contiguous() and tuple(out.shape) == (nf, m + 1)
            assert torch.equal(out.nan_to_num(nan=7.0), ref.T.nan_to_num(nan=7.0))
        assert torch.equal(ck.table_sum_em_plain(em, tbl, m, nl).nan_to_num(nan=7.0),
                           ref.T.nan_to_num(nan=7.0))
        C = nf * nl
        He = torch.tensor(rng.standard_normal((nelem, C, C)), dtype=dtype, device=cuda)
        vp = torch.tensor(rng.standard_normal((nf, m + 1)), dtype=dtype, device=cuda)
        vp[:, m] = 0.0
        two = ck.table_sum(ck.element_matvec(He, basis.idx, vp), tbl, m).T
        n0 = ck.LAUNCHES["hvp"]
        fused = (ck.hvp(He, basis.idx, tbl, vp, m), plan.hvp(He, vp))
        torch.cuda.synchronize()
        assert ck.LAUNCHES["hvp"] == n0 + 2
        for out in fused:
            assert out.is_contiguous() and torch.equal(out, two)
            assert _rel(out, ck.hvp_plain(He, basis.idx, tbl, vp, m)) <= TOL[dtype]
            assert torch.all(out[:, m] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lanes", [1, 2, 5, 128])
def test_row_gather_kernels_match_plain(cuda, lanes, dtype):
    """Both entries of kernel D, narrow (one thread per row) and wide rows,
    with stray indices that clamp."""
    rng = np.random.default_rng(lanes)
    n, rows = 16130, 49152
    v = torch.tensor(rng.standard_normal((n, lanes)), dtype=dtype, device=cuda)
    idx = rng.integers(-3, n + 3, rows).astype(np.int32)
    idx_t = torch.tensor(idx, device=cuda)
    n0 = ck.LAUNCHES["row_gather"]
    out = ck.row_gather(v, idx_t)
    out1 = ck.row_gather(v[:, 0].contiguous(), idx_t.reshape(-1, 8))
    idx2 = torch.tensor(rng.integers(-3, n + 3, (rows, lanes)).astype(np.int32), device=cuda)
    out2 = ck.take_along_rows(v, idx2)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["row_gather"] == n0 + 2
    assert torch.equal(out, ck.row_gather_plain(v, idx_t))
    assert torch.equal(out1, ck.row_gather_plain(v[:, 0], idx_t.reshape(-1, 8)))
    assert torch.equal(out2, ck.take_along_rows_plain(v, idx2))


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 2])
def test_segment_sum_kernel_matches_plain(cuda, f):
    rng = np.random.default_rng(f)
    nseg = 5000
    counts = rng.integers(0, 4, nseg)
    counts[rng.integers(0, nseg, 20)] = 34
    dst = np.repeat(np.arange(nseg), counts)
    rows = len(dst)
    src = torch.tensor(rng.standard_normal((rows, f) if f > 1 else rows), device=cuda)
    lst = torch.tensor(rng.permutation(rows).astype(np.int32), device=cuda)
    off = torch.tensor(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32), device=cuda)
    for lst_ in (lst, None):
        out = ck.segment_sum(src, lst_, off)
        torch.cuda.synchronize()
        assert torch.equal(out, ck.segment_sum_plain(src, lst_, off))


def _unaligned(t, shape):
    """A contiguous view of `shape` whose base lies one element past t's
    (so not on a 16-byte boundary); t must hold one element more."""
    n = int(np.prod(shape))
    return t.reshape(-1)[1:1 + n].reshape(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lanes", [1, 2, 3, 4, 6, 128, 130])
def test_row_gather_paths_match_plain(cuda, lanes, dtype):
    """row_gather's three paths (four rows per thread for 1-2 lanes,
    16-byte units for aligned rows, the element loop otherwise) with a row
    count that is no multiple of four, stray indices, an index tensor and a
    table off the 16-byte boundary, and the plan beside the wrapper."""
    rng = np.random.default_rng(100 + lanes)
    n, rows = 4099, 30001
    big = torch.tensor(rng.standard_normal(n * lanes + 1), dtype=dtype, device=cuda)
    idx_big = torch.tensor(rng.integers(-3, n + 3, rows + 1).astype(np.int32), device=cuda)
    shape = (n, lanes) if lanes > 1 else (n,)
    for v in (big[:-1].reshape(shape), _unaligned(big, shape)):
        for idx in (idx_big[:-1], idx_big[1:], idx_big[:8].reshape(2, 4), idx_big[:3]):
            n0 = ck.LAUNCHES["row_gather"]
            out = ck.row_gather(v, idx)
            out_p = ck.GatherPlan(idx, n)(v)
            torch.cuda.synchronize()
            assert ck.LAUNCHES["row_gather"] == n0 + 2
            ref = ck.row_gather_plain(v, idx)
            assert torch.equal(out, ref) and torch.equal(out_p, ref)


def _long_segments(rng, f, dtype, device):
    counts = np.concatenate([
        rng.integers(0, 6, 3000), [64, 65, 256, 257, 2574, 700, 300, 0, 34], rng.integers(0, 6, 500),
    ])
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    rows = int(off[-1])
    lst = rng.permutation(rows).astype(np.int32)
    src = rng.standard_normal((rows, f) if f > 1 else rows)
    src[lst[off[3004]:off[3005]]] = 0.0  # the 2,574-entry run: zeros
    src[lst[off[3005] + 77]] = np.nan  # inside the 700-entry run
    src[lst[off[3006]:off[3007]]] = 0.0
    src[lst[off[3007] - 1]] = np.nan  # a zero run ending in NaN
    return (torch.tensor(src, dtype=dtype, device=device), torch.tensor(lst, device=device),
            torch.tensor(off, device=device), len(counts))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("f", [1, 2])
def test_segment_kernels_long_runs_match_plain(cuda, f, dtype):
    """segment_sum and segment_add_ with runs on both sides of the 64-entry
    cut: zeros give 0, NaN gives NaN, every slot equals the plain version
    bit for bit; with and without a list, from an aligned and an unaligned
    list, and through a plan."""
    src, lst, off, nseg = _long_segments(np.random.default_rng(f), f, dtype, cuda)
    ref = ck.segment_sum_plain(src, lst, off)
    assert bool((ref[3004] == 0).all()) and bool(ref[3005].isnan().all())
    assert bool(ref[3006].isnan().all())
    lst_u = _unaligned(torch.cat([lst, lst[:1]]), lst.shape)
    lst_u.copy_(lst)
    for lst_ in (lst, lst_u):
        out = ck.segment_sum(src, lst_, off)
        out_p = ck.SegmentPlan(lst_, off, src.shape[0])(src)
        torch.cuda.synchronize()
        assert torch.equal(out.nan_to_num(nan=7.0), ref.nan_to_num(nan=7.0))
        assert torch.equal(out_p.nan_to_num(nan=7.0), ref.nan_to_num(nan=7.0))
    srt = src[lst.long()].contiguous()
    out = ck.segment_sum(srt, None, off)
    torch.cuda.synchronize()
    assert torch.equal(out.nan_to_num(nan=7.0), ref.nan_to_num(nan=7.0))
    # in place into scattered unique rows; unlisted rows keep their bits
    rng = np.random.default_rng(5)
    ids = torch.tensor(np.sort(rng.permutation(3 * nseg)[:nseg]).astype(np.int32), device=cuda)
    dst = torch.tensor(rng.standard_normal((3 * nseg,) + tuple(src.shape[1:])), dtype=dtype, device=cuda)
    want = ck.segment_add_plain(dst.clone(), src, lst, off, ids)
    n0 = ck.LAUNCHES["segment_add_"]
    got = ck.segment_add_(dst.clone(), src, lst, off, ids)
    got_p = ck.SegmentPlan(lst, off, src.shape[0], ids=ids, ndst=3 * nseg).add_(dst.clone(), src)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["segment_add_"] == n0 + 2
    assert torch.equal(got.nan_to_num(nan=7.0), want.nan_to_num(nan=7.0))
    assert torch.equal(got_p.nan_to_num(nan=7.0), want.nan_to_num(nan=7.0))


@pytest.mark.cuda
def test_plans_replay_from_a_cuda_graph(cuda):
    """A gather, a fused segment sum and an in-place segment add launch on
    the capturing stream without a host sync: replayed on refilled inputs
    they give the eager results bit for bit."""
    rng = np.random.default_rng(9)
    src, lst, off, nseg = _long_segments(rng, 1, torch.float64, cuda)
    ids = torch.tensor(np.sort(rng.permutation(2 * nseg)[:nseg]).astype(np.int32), device=cuda)
    seg = ck.SegmentPlan(lst, off, src.shape[0], ids=ids, ndst=2 * nseg)
    gat = ck.GatherPlan(lst[:5000].reshape(50, 100), src.shape[0])
    dst = torch.zeros(2 * nseg, dtype=torch.float64, device=cuda)
    seg(src), gat(src), seg.add_(dst, src)  # warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_sum, g_gat = seg(src), gat(src)
        seg.add_(dst, src)
    for seed in (1, 2):
        fresh = torch.tensor(np.random.default_rng(seed).standard_normal(src.shape[0]), device=cuda)
        src.copy_(fresh)
        dst.fill_(float(seed))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(g_sum, ck.segment_sum(fresh, lst, off))
        assert torch.equal(g_gat, ck.row_gather(fresh, lst[:5000].reshape(50, 100)))
        assert torch.equal(dst, ck.segment_add_(torch.full_like(dst, float(seed)), fresh, lst, off, ids))


@pytest.mark.cuda
def test_he_table_and_hvp_plans_replay_from_a_cuda_graph(cuda):
    """The weighted he_assemble, the element-major table sum and the fused
    hvp launch on the capturing stream without a host sync: replayed on
    refilled inputs they give the eager results bit for bit."""
    basis = mt.fem2d(L=4, backend=mt.backend_cuda()).bases["dirichlet"][-1]
    nelem, nl, nq, m = basis.nelem, basis.nl, basis.nq, basis.m
    rng = np.random.default_rng(11)
    fill = lambda *shape: torch.tensor(rng.standard_normal(shape), device=cuda)  # noqa: E731
    P, w = fill(nelem, nq, 4, 2 * nl), fill(nelem * nq).abs()
    he, tab = ck.HePlan(P, w), basis.table_plan
    F2, gf, vp = fill(nelem * nq, 4, 4), fill(nelem, 2 * nl), fill(2, m + 1)
    tab.hvp(he.weighted(F2), vp), tab.em(gf)  # warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_he = he.weighted(F2)
        g_gv = tab.em(gf)
        g_hv = tab.hvp(g_he, vp)
    for _ in range(2):
        fresh = fill(nelem * nq, 4, 4), fill(nelem, 2 * nl), fill(2, m + 1)
        for t, new in zip((F2, gf, vp), fresh):
            t.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        want_he = ck.he_assemble_weighted(P, fresh[0], w)
        assert torch.equal(g_he, want_he)
        assert torch.equal(g_gv, ck.table_sum_em(fresh[1], basis.scatter_idx, m, nl))
        assert torch.equal(g_hv, ck.hvp(want_he, basis.idx, basis.scatter_idx, fresh[2], m))


@pytest.mark.cuda
def test_assembly_is_deterministic(cuda):
    """The He -> vals sum and the dense matrix placed from it are the same
    bit for bit in two calls (no atomics)."""
    basis = mt.fem2d(L=4, backend=mt.backend_cuda()).bases["dirichlet"][-1]
    rng = np.random.default_rng(3)
    C = 2 * basis.nl
    He = torch.tensor(rng.standard_normal((basis.nelem, C, C)), device=cuda)
    table = linsolve.vals_table(basis.idx, basis.m, 2)
    v1, v2 = linsolve.he_to_vals(He, table), linsolve.he_to_vals(He, table)
    sys_ = linsolve.LevelSystem(He, basis.idx, basis.m, basis.scatter_idx, table)
    H1, H2 = linsolve.dense_assemble(sys_, 2), linsolve.dense_assemble(sys_, 2)
    torch.cuda.synchronize()
    assert torch.equal(v1, v2) and torch.equal(H1, H2)
    assert torch.equal(v1.cpu(), linsolve.he_to_vals(He.cpu(), linsolve.vals_table(basis.idx.cpu(), basis.m, 2)))


def _stages(sol, t_max):
    """(its per (t, level), c_dot_Dz per t) of the t-stages with t <= t_max."""
    its = {}
    for e in sol.log:
        if e["t"] <= t_max:
            key = (float(e["t"]), int(e["level"]))
            its[key] = its.get(key, 0) + 1
    c = {float(t): c for t, c in zip(sol.SOL_main.ts, sol.SOL_main.c_dot_Dz) if t <= t_max}
    return its, c


@pytest.mark.cuda
def test_fem2d_L4_forced_nd_on_cuda_matches_cpu(cuda):
    s_cpu = mt.fem2d_solve(L=4, p=1.0, backend=mt.backend_cpu(dense_threshold=256))
    ck.reset_launch_counts()
    s_gpu = mt.fem2d_solve(L=4, p=1.0, backend=mt.backend_cuda(dense_threshold=256))
    path = ("he_assemble", "hvp", "table_sum", "segment_sum", "segment_add_", "row_gather")
    assert all(ck.LAUNCHES[k] > 0 for k in path), ck.LAUNCHES
    assert bool(torch.isfinite(s_gpu.z).all())
    its_cpu, c_cpu = _stages(s_cpu, 1e4)
    its_gpu, c_gpu = _stages(s_gpu, 1e4)
    assert its_gpu == its_cpu and c_gpu.keys() == c_cpu.keys()
    for t, c in c_cpu.items():
        assert abs(c_gpu[t] - c) <= 1e-9 * abs(c), t
    c_final = s_gpu.SOL_main.c_dot_Dz[-1]
    assert abs(c_final - C_EXACT_L4) <= 5e-7 * C_EXACT_L4


@pytest.mark.cuda
def test_fem2d_L3_solve_on_cuda_matches_cpu(cuda):
    s_cpu = mt.fem2d_solve(L=3, p=1.0, backend=mt.backend_cpu())
    ck.reset_launch_counts()
    s_gpu = mt.fem2d_solve(L=3, p=1.0)
    path = ("he_assemble", "hvp", "table_sum", "segment_sum")
    assert all(ck.LAUNCHES[k] > 0 for k in path), ck.LAUNCHES
    assert ck.LAUNCHES["element_matvec"] == 0
    assert s_gpu.z.device.type == "cuda" and bool(torch.isfinite(s_gpu.z).all())
    c_cpu, c_gpu = s_cpu.SOL_main.c_dot_Dz[-1], s_gpu.SOL_main.c_dot_Dz[-1]
    assert abs(c_gpu - c_cpu) <= 1e-9 * abs(c_cpu)


# Kernel A for wide elements (csrc/he_assemble_wide.cu): the shapes of the 3D
# solve (Q3 hexahedra, 2 fields), of parabolic_solve on it (3 fields) and of
# its phase 1 (4 fields), Q2 hexahedra, a C that is no multiple of the tile,
# a k that takes the run-time rounds (8 < k), and one element.
WIDE_SHAPES = [(64, 64, 5, 128), (9, 64, 6, 192), (5, 64, 7, 256), (8, 27, 5, 54),
               (3, 10, 9, 70), (1, 64, 5, 128), (7, 4, 17, 5)]
# shapes both kernels take: fem2d's, its phase 1 / parabolic, a generic one
BOTH_SHAPES = [(2051, 7, 4, 12), (64, 8, 5, 16), (33, 7, 5, 18), (16, 4, 3, 6), (5, 3, 2, 7)]


def _he_weighted_inputs(shape, dtype, device, seed):
    nelem, nq, k, C = shape
    rng = np.random.default_rng(seed)
    P = torch.tensor(rng.standard_normal(shape), dtype=dtype, device=device)
    F2 = rng.standard_normal((nelem * nq, k, k))
    F2 = torch.tensor(F2 + F2.transpose(0, 2, 1), dtype=dtype, device=device)
    F2[:, 0, 1] += 0.5  # not symmetric, so the two block orders differ
    w = torch.tensor(rng.uniform(0.1, 2.0, nelem * nq), dtype=dtype, device=device)
    return P, F2, w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_he_assemble_wide_kernel_matches_plain(cuda, shape, dtype):
    """Both entries of the wide kernel against the plain version (einsums)
    to the tolerance, and exactly against each other: W given, W = F2 * w
    formed in the kernel from F2 in both block orders, wrapper and plan."""
    nelem, nq, k, C = shape
    P, F2, w = _he_weighted_inputs(shape, dtype, cuda, 20)
    W = (F2 * w[:, None, None]).reshape(nelem, nq, k, k)
    F2t = F2.transpose(1, 2).contiguous().transpose(1, 2)
    plan = ck.HePlan(P, w)
    assert plan.kernel == "wide"
    n0, n_narrow = ck.LAUNCHES["he_assemble_wide"], ck.LAUNCHES["he_assemble"]
    out = ck.he_assemble(P, W)
    others = (plan(W), plan.weighted(F2), plan.weighted(F2t), ck.he_assemble_weighted(P, F2, w))
    torch.cuda.synchronize()
    assert ck.LAUNCHES["he_assemble_wide"] == n0 + 5
    assert ck.LAUNCHES["he_assemble"] == n_narrow
    assert _rel(out, ck.he_assemble_plain(P, W)) <= TOL[dtype]
    assert all(torch.equal(o, out) for o in others)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", BOTH_SHAPES)
def test_he_assemble_wide_equals_narrow_where_both_apply(cuda, shape, dtype):
    """In float32 the two kernels keep one summation order ((q, j)
    ascending, l ascending from zero, F2 * w one rounded product): bit for
    bit equal.  In float64 the wide kernel sums on the tensor cores: within
    1e-13 of the narrow kernel relative to max|He|; the largest difference
    is printed in ulps of the entry."""
    nelem, nq, k, C = shape
    P, F2, w = _he_weighted_inputs(shape, dtype, cuda, 21)
    W = (F2 * w[:, None, None]).reshape(nelem, nq, k, k)
    narrow, wide = ck.HePlan(P, w), ck.HePlan(P, w, kernel="wide")
    assert narrow.kernel == "narrow" and wide.kernel == "wide"
    a, b = narrow(W), wide(W)
    aw, bw = narrow.weighted(F2), wide.weighted(F2)
    torch.cuda.synchronize()
    assert torch.equal(a, aw) and torch.equal(b, bw)
    if dtype == torch.float32:
        assert torch.equal(a, b)
        return
    ulps = float(((a - b).abs() / torch.finfo(dtype).eps / a.abs().clamp_min(1e-300)).max())
    print(f"wide vs narrow {shape}: max rel {_rel(b, a):.3e}, at most {ulps:.1f} ulps of an entry")
    assert _rel(b, a) <= 1e-13


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_he_assemble_wide_repeats_bit_for_bit(cuda, shape, dtype):
    """No atomics and a fixed round order: two calls on the same inputs
    give the same bits, through both entries."""
    nelem, nq, k, C = shape
    P, F2, w = _he_weighted_inputs(shape, dtype, cuda, 23)
    plan = ck.HePlan(P, w)
    W = (F2 * w[:, None, None]).reshape(nelem, nq, k, k)
    first = (plan.weighted(F2), plan(W))
    second = (plan.weighted(F2), plan(W))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
def test_he_assemble_wide_replays_from_a_cuda_graph(cuda):
    """The weighted wide kernel at the fem3d L=3 fine shape launches on the
    capturing stream: replayed on refilled inputs it gives the eager
    results bit for bit."""
    shape = (64, 64, 5, 128)
    P, F2, w = _he_weighted_inputs(shape, torch.float64, cuda, 24)
    plan = ck.HePlan(P, w)
    plan.weighted(F2)  # warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = plan.weighted(F2)
    for seed in (1, 2):
        fresh = _he_weighted_inputs(shape, torch.float64, cuda, 30 + seed)[1]
        F2.copy_(fresh)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, ck.he_assemble_weighted(P, fresh, w))


@pytest.mark.cuda
def test_he_assemble_wide_nan_stays_in_its_element(cuda):
    shape = (6, 27, 5, 54)
    P, F2, w = _he_weighted_inputs(shape, torch.float64, cuda, 22)
    plan = ck.HePlan(P, w)
    clean = plan.weighted(F2)
    for e in (0, 3, 5):
        bad = F2.clone()
        bad[e * 27 + 11, 1, 2] = float("nan")
        out = plan.weighted(bad)
        torch.cuda.synchronize()
        assert bool(out[e].isnan().all())
        keep = torch.arange(6, device=cuda) != e
        assert torch.equal(out[keep], clean[keep])


@pytest.mark.cuda
def test_fem3d_L2_k3_forced_nd_on_cuda_matches_pin(cuda):
    """The 3D family on the card through the wide kernel, the fine level on
    the nested-dissection route: the JAX package's exact-dense pin for this
    problem (tests/test_fem3d.py) to 1e-5 rel."""
    ck.reset_launch_counts()
    sol = mt.fem3d_solve(L=2, k=3, p=1.0, backend=mt.backend_cuda(dense_threshold=64))
    assert ck.LAUNCHES["he_assemble_wide"] > 0 and ck.LAUNCHES["he_assemble"] == 0
    assert all(ck.LAUNCHES[k] > 0 for k in ("hvp", "table_sum", "segment_sum", "segment_add_",
                                            "row_gather")), ck.LAUNCHES
    c = float(sol.SOL_main.c_dot_Dz[-1])
    assert abs(c - 192.49066199206504) <= 1e-5 * 192.49066199206504
    z, g = sol.z, sol.geometry
    du = torch.stack([g.operators[d].matvec(z[:, 0]) for d in ("dx", "dy", "dz")], dim=1)
    assert bool((torch.linalg.norm(du, dim=1) <= z[:, 1] + 1e-5).all())


@pytest.mark.cuda
def test_parabolic_and_phase1_on_cuda_match_cpu(cuda):
    """parabolic_solve on fem1d and the obstacle problem (infeasible start)
    on the card against the CPU run of the same port."""
    runs = []
    for backend in (mt.backend_cpu(), mt.backend_cuda()):
        sol = mt.parabolic_solve(mt.fem1d(L=3, backend=backend), h=0.5, t1=1.0, p=1.0, tol=1e-7)
        runs.append([u.cpu() for u in sol.u])
        assert sol.ts == [0.0, 0.5, 1.0]
    for a, b in zip(*runs):
        assert float((a - b).abs().max()) < 1e-4
    sols = []
    for backend in (mt.backend_cpu(), mt.backend_cuda()):
        dev = backend.device
        A = torch.tensor([[-1.0, 0.0, 0.0, 0.0]], dtype=torch.float64, device=dev)
        Q = mt.convex_intersect(
            mt.convex_Euclidian_power(idx=(1, 2, 3), p=2.0),
            mt.convex_linear(A=lambda xx, A=A: A,
                             b=lambda xx: (-(0.5 - 2.0 * (xx[0] ** 2 + xx[1] ** 2))).reshape(1)))
        sols.append(mt.amgb(
            mt.fem2d(L=3, backend=backend),
            D=[("u", "id"), ("u", "dx"), ("u", "dy"), ("s", "id")],
            f=lambda xx, dev=dev: torch.tensor([3.0, 0.0, 0.0, 1.0], dtype=torch.float64, device=dev),
            g=lambda xx: torch.stack([xx[0] ** 2 + xx[1] ** 2, torch.full_like(xx[0], 100.0)]),
            Q=Q, tol=1e-7))
    cpu, gpu = sols
    assert gpu.SOL_feasibility.its.sum() > 0
    c_cpu, c_gpu = cpu.SOL_main.c_dot_Dz[-1], gpu.SOL_main.c_dot_Dz[-1]
    assert abs(c_gpu - c_cpu) <= 5e-7 * abs(c_cpu)
    assert float((gpu.z.cpu() - cpu.z).abs().max()) <= 1e-4
