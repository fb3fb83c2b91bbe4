"""The PyTorch port imports without JAX and never falls back to the CPU.

The import check runs in a subprocess because this test process has JAX
loaded already (tests/conftest.py imports it).
"""

import os
import subprocess
import sys

import pytest
import torch

import multigridbarrier_tpu_torch as mt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "multigridbarrier_tpu_torch",
    "multigridbarrier_tpu_torch.api",
    "multigridbarrier_tpu_torch.backend",
    "multigridbarrier_tpu_torch.interop",
    "multigridbarrier_tpu_torch.fem.fem2d",
    "multigridbarrier_tpu_torch.fem.geometry",
    "multigridbarrier_tpu_torch.runtime.blockdiag",
    "multigridbarrier_tpu_torch.runtime.cuda_kernels",
    "multigridbarrier_tpu_torch.runtime.elements",
    "multigridbarrier_tpu_torch.runtime.ell",
    "multigridbarrier_tpu_torch.runtime.native",
    "multigridbarrier_tpu_torch.solver.amgb",
    "multigridbarrier_tpu_torch.solver.convex",
    "multigridbarrier_tpu_torch.solver.hostsolve",
    "multigridbarrier_tpu_torch.solver.linsolve",
    "multigridbarrier_tpu_torch.solver.ndsolve",
]


def test_port_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'multigridbarrier_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_backend_cuda_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.backend_cuda()


def test_fem2d_defaults_to_the_card(monkeypatch):
    """fem2d with no backend builds on backend_cuda(): without a GPU it
    raises instead of building on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.fem2d(L=2)


def test_backend_defaults():
    b = mt.backend_cpu()
    assert b.dtype == torch.float64 and b.itype == torch.int32
    assert b.device == torch.device("cpu") and b.dense_threshold == 2048
    assert mt.backend_cpu(dense_threshold=1 << 30).dense_threshold == 1 << 30
    g = mt.fem2d(L=2, backend=mt.backend_cpu(dtype=torch.float32))
    assert g.x.dtype == torch.float32 and g.bases["dirichlet"][-1].rloc.dtype == torch.float32
