"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: max|kernel - plain| / max|plain| <= 1e-12 in float64 and 1e-5
in float32 (TF32 off): the two sides sum the same short products in other
orders, a few ulps apart.  The end-to-end solve at L=3 agrees with the CPU
run to 1e-9 rel, the tolerance the CPU tests hold the JAX package to.
"""

import numpy as np
import pytest
import torch

import multigridbarrier_tpu_torch as mt
from multigridbarrier_tpu_torch.runtime import cuda_kernels as ck

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
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
def test_fem2d_L3_solve_on_cuda_matches_cpu(cuda):
    s_cpu = mt.fem2d_solve(L=3, p=1.0)
    ck.reset_launch_counts()
    s_gpu = mt.fem2d_solve(L=3, p=1.0, backend=mt.backend_cuda())
    assert all(n > 0 for n in ck.LAUNCHES.values()), ck.LAUNCHES
    assert s_gpu.z.device.type == "cuda" and bool(torch.isfinite(s_gpu.z).all())
    c_cpu, c_gpu = s_cpu.SOL_main.c_dot_Dz[-1], s_gpu.SOL_main.c_dot_Dz[-1]
    assert abs(c_gpu - c_cpu) <= 1e-9 * abs(c_cpu)
