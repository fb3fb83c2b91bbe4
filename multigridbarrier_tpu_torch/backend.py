"""Backend: device/precision/solver policy object (PyTorch port).

The entry points (fem1d, fem2d, fem3d and their *_solve forms) use
backend_cuda() when they are
given no backend; the CPU is used only when the caller passes
backend_cpu().

The JAX package collapses the reference's HPCBackend{T,Ti,Device,Comm,
Solver} into a dtype, an index type, an optional device mesh and a dense
size threshold (multigridbarrier_tpu/backend.py).  The port keeps the same
fields minus the mesh, plus an explicit torch device: every tensor the
geometry and the solver create lives on `device`, and no global default
device is set.  Multi-device runs are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Backend:
    """Precision + device + linear-solver policy.

    Attributes:
      dtype: floating dtype of geometry and solver tensors (float64 is the
        reference's correctness contract).
      itype: integer dtype of index tensors (the kernels take int32).
      device: the torch device every tensor is created on; None (the
        default) resolves to the current CUDA device and raises when there
        is none, as backend_cuda() does: the CPU is used only when asked for.
      dense_threshold: levels with nf*m <= this many unknowns (and level
        0) solve their Newton systems with dense Cholesky; the others with
        the nested-dissection multifrontal Cholesky (solver/ndsolve.py).
        dense_threshold=1<<30 gives the dense route at every level.
    """

    dtype: torch.dtype = torch.float64
    itype: torch.dtype = torch.int32
    device: torch.device | None = None
    dense_threshold: int = 2048

    def __post_init__(self):
        if self.device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("Backend: no CUDA device is available; pass device= "
                                   "or use backend_cpu()")
            dev = torch.device("cuda", torch.cuda.current_device())
        else:
            dev = torch.device(self.device)
        object.__setattr__(self, "device", dev)


def _no_mesh(kw):
    for key in ("mesh", "n_devices"):
        if kw.pop(key, None) not in (None, 1):
            raise NotImplementedError(
                "multi-device backends are not ported to PyTorch yet"
            )


def backend_cpu(dtype=torch.float64, itype=torch.int32, **kw) -> Backend:
    """Single-device CPU backend (reference backend_cpu_serial).

    Extra kwargs override Backend fields (e.g. dense_threshold=1<<30)."""
    _no_mesh(kw)
    return Backend(dtype=dtype, itype=itype, device=torch.device("cpu"), **kw)


def backend_cuda(dtype=torch.float64, itype=torch.int32, device="cuda", **kw) -> Backend:
    """Single-GPU backend.  Raises when no CUDA device is present: it never
    returns a CPU backend in its place."""
    _no_mesh(kw)
    if not torch.cuda.is_available():
        raise RuntimeError("backend_cuda: no CUDA device is available")
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"backend_cuda: device {dev} is not a CUDA device")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Backend(dtype=dtype, itype=itype, device=dev, **kw)
