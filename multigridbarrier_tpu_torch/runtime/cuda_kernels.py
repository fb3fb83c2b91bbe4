"""Hand-written Hopper kernels of the Newton step, and their plain versions.

The counterpart of multigridbarrier_tpu/runtime/pallas_kernels.py (and of
the gather kernels probed in tools/probe_pallas_gather.py):

  A. he_assemble     element Hessians He = P^T W P        csrc/he_assemble.cu
  B. element_matvec  per-element He[e] @ v[idx[e]]        csrc/element_matvec.cu
  C. table_sum       gather-table node sum (no atomics)   csrc/table_sum.cu

hvp = B then C; LevelBasis.scatter_add = C.

The CUDA sources are compiled with nvcc for sm_90a into one shared library
with a plain C interface, at first use, under `build/kernels/` of the
checkout, keyed by a hash of the sources and flags; it is loaded with
ctypes.  Each wrapper checks its inputs and then:

* for CPU tensors, computes its plain PyTorch version (the tests use it);
* for CUDA tensors, launches the kernel on the current stream or raises —
  there is no fallback to the plain version on the GPU.

LAUNCHES counts kernel launches per wrapper, so a run can show that the
main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(os.path.dirname(_PKG), "build", "kernels")
_SOURCES = ("he_assemble.cu", "element_matvec.cu", "table_sum.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {"he_assemble": 0, "element_matvec": 0, "table_sum": 0}

_LOCK = threading.Lock()
_LIB = None


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> tuple[str, str]:
    """Compile csrc/*.cu into build/kernels/libmgb_kernels_<hash>.so if it
    is not there yet.  Returns (library path, compiler output; empty when
    the library was already built)."""
    srcs = [os.path.join(_CSRC, s) for s in _SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as fh:
            h.update(fh.read())
    so = os.path.join(_BUILD, f"libmgb_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so, ""
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    try:
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
            capture_output=True, text=True, timeout=900,
        )
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
        os.rename(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so, res.stdout + res.stderr


def load():
    """Build (if needed) and load the kernel library; returns the ctypes
    handle."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build()[0])
            vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            for t in ("f32", "f64"):
                fn = getattr(lib, f"mgb_he_assemble_{t}")
                fn.argtypes = [vp, vp, vp, i64, i32, i32, i32, vp]
                fn.restype = i32
                fn = getattr(lib, f"mgb_element_matvec_{t}")
                fn.argtypes = [vp, vp, vp, vp, i64, i32, i32, i64, vp]
                fn.restype = i32
                fn = getattr(lib, f"mgb_table_sum_{t}")
                fn.argtypes = [vp, vp, vp, i64, i64, i32, i32, vp]
                fn.restype = i32
            _LIB = lib
    return _LIB


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(name, tensors, float_names, index_names=()):
    """Shared input validation: one device (CPU or CUDA), float tensors of
    one dtype in {f32, f64}, int32 index tensors, all contiguous."""
    dev = tensors[float_names[0]].device
    dtype = tensors[float_names[0]].dtype
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {dtype} is not float32/float64")
    for key, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
        want = torch.int32 if key in index_names else dtype
        if t.dtype != want:
            raise TypeError(f"{name}: {key} has dtype {t.dtype}, expected {want}")
    return dev


def _launch(name, dtype, device, *args):
    fn = getattr(load(), f"mgb_{name}_{_SUFFIX[dtype]}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# A. element Hessian assembly
# ---------------------------------------------------------------------------


def he_assemble_plain(P: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """He[e] = sum_{q,j,l} P[e,q,j,:]^T W[e,q,j,l] P[e,q,l,:] — the two
    einsums of the JAX _SolverCtx._assemble_He."""
    T = torch.einsum("eqjl,eqlc->eqjc", W, P)
    return torch.einsum("eqjc,eqjd->ecd", P, T)


def he_assemble(P: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """P (nelem, nq, k, C), W (nelem, nq, k, k) -> He (nelem, C, C)."""
    dev = _check("he_assemble", {"P": P, "W": W}, ("P",))
    if P.ndim != 4 or W.ndim != 4:
        raise ValueError("he_assemble: P and W must be 4-D")
    nelem, nq, k, C = P.shape
    if tuple(W.shape) != (nelem, nq, k, k):
        raise ValueError(f"he_assemble: W shape {tuple(W.shape)} != {(nelem, nq, k, k)}")
    if dev.type == "cpu":
        return he_assemble_plain(P, W)
    per_elem = (2 * nq * k * C + nq * k * k) * P.element_size()
    if C > 32 or nq * k > 64 or per_elem > 48 * 1024:
        raise ValueError(
            f"he_assemble: kernel supports C <= 32 and nq*k <= 64 within 48 KB "
            f"of shared memory per element (got C={C}, nq*k={nq * k})"
        )
    out = torch.empty((nelem, C, C), dtype=P.dtype, device=dev)
    _launch("he_assemble", P.dtype, dev, P.data_ptr(), W.data_ptr(),
            out.data_ptr(), nelem, nq, k, C)
    return out


# ---------------------------------------------------------------------------
# B. element-local matvec (first half of hvp)
# ---------------------------------------------------------------------------


def element_matvec_plain(He: torch.Tensor, idx: torch.Tensor, vp: torch.Tensor):
    """(nelem*nl, nf) per-slot products He[e] @ vp[:, idx[e]] (field-major
    element vector), laid out slot-major like linsolve.hvp's `flat`."""
    nelem, nl = idx.shape
    nf = vp.shape[0]
    ve = vp[:, idx].permute(1, 0, 2).reshape(nelem, nf * nl)
    hve = torch.einsum("eab,eb->ea", He, ve)
    return hve.reshape(nelem, nf, nl).permute(0, 2, 1).reshape(-1, nf)


def element_matvec(He: torch.Tensor, idx: torch.Tensor, vp: torch.Tensor):
    """He (nelem, C, C), idx (nelem, nl) int32, vp (nf, m+1) with C = nf*nl
    -> (nelem*nl, nf)."""
    dev = _check("element_matvec", {"He": He, "idx": idx, "vp": vp},
                 ("He", "vp"), ("idx",))
    if He.ndim != 3 or idx.ndim != 2 or vp.ndim != 2:
        raise ValueError("element_matvec: He 3-D, idx and vp 2-D")
    nelem, nl = idx.shape
    nf = vp.shape[0]
    C = nf * nl
    if tuple(He.shape) != (nelem, C, C):
        raise ValueError(f"element_matvec: He shape {tuple(He.shape)} != {(nelem, C, C)}")
    if dev.type == "cpu":
        return element_matvec_plain(He, idx, vp)
    if (C * C + C) * He.element_size() > 48 * 1024:
        raise ValueError(f"element_matvec: C={C} exceeds the kernel's shared memory")
    out = torch.empty((nelem * nl, nf), dtype=He.dtype, device=dev)
    _launch("element_matvec", He.dtype, dev, He.data_ptr(), idx.data_ptr(),
            vp.data_ptr(), out.data_ptr(), nelem, nl, nf, vp.shape[1])
    return out


# ---------------------------------------------------------------------------
# C. gather-table node sum
# ---------------------------------------------------------------------------


def table_sum_plain(src: torch.Tensor, tbl: torch.Tensor, m: int):
    """out[a] = sum_w src[tbl[a, w]] with the sentinel row (index
    src.shape[0]) read as zero, and out[m] = 0.  Summed in table order,
    as the kernel sums."""
    padded = torch.cat([src, src.new_zeros((1, src.shape[1]))], dim=0)
    out = padded[tbl[:, 0]]
    for w in range(1, tbl.shape[1]):
        out = out + padded[tbl[:, w]]
    out[m] = 0.0
    return out


def table_sum(src: torch.Tensor, tbl: torch.Tensor, m: int) -> torch.Tensor:
    """src (rows, f), tbl (m+1, width) int32 -> (m+1, f), pad row m zero."""
    dev = _check("table_sum", {"src": src, "tbl": tbl}, ("src",), ("tbl",))
    if src.ndim != 2 or tbl.ndim != 2 or tbl.shape[0] != m + 1:
        raise ValueError(
            f"table_sum: src 2-D and tbl (m+1, width) with m={m}, got "
            f"{tuple(src.shape)} and {tuple(tbl.shape)}"
        )
    if dev.type == "cpu":
        return table_sum_plain(src, tbl, m)
    f = src.shape[1]
    out = torch.empty((m + 1, f), dtype=src.dtype, device=dev)
    _launch("table_sum", src.dtype, dev, src.data_ptr(), tbl.data_ptr(),
            out.data_ptr(), src.shape[0], m, tbl.shape[1], f)
    return out
