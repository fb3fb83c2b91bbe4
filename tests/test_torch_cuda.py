"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: max|kernel - plain| / max|plain| <= 1e-12 in float64 and 1e-5
in float32 (TF32 off) for A and B: the two sides sum the same short
products in other orders, a few ulps apart.  Kernel D is a copy and C's
segment_sum adds in the same order as its plain version, so both are held
to exact equality.  The dense L=3 solve agrees with the CPU run to 1e-9
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
HE_SHAPES = [(8, 7, 4, 12), (16, 4, 3, 6), (2048, 7, 4, 12)]


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
    path = ("he_assemble", "element_matvec", "table_sum", "segment_sum", "row_gather")
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
    path = ("he_assemble", "element_matvec", "table_sum", "segment_sum")
    assert all(ck.LAUNCHES[k] > 0 for k in path), ck.LAUNCHES
    assert s_gpu.z.device.type == "cuda" and bool(torch.isfinite(s_gpu.z).all())
    c_cpu, c_gpu = s_cpu.SOL_main.c_dot_Dz[-1], s_gpu.SOL_main.c_dot_Dz[-1]
    assert abs(c_gpu - c_cpu) <= 1e-9 * abs(c_cpu)
