"""Hand-written Hopper kernels of the Newton step, and their plain versions.

The counterpart of multigridbarrier_tpu/runtime/pallas_kernels.py (and of
the gather kernels probed in tools/probe_pallas_gather.py):

  A. he_assemble      element Hessians He = P^T W P        csrc/he_assemble.cu
     he_assemble_weighted   the same with W = F2 * w formed in the kernel
     he_assemble_wide the same function for wide elements  csrc/he_assemble_wide.cu
                      (C > 32 or nq*k > 64: hexahedra, more than two fields),
                      both entries, on float64 tensor cores (DMMA) in
                      float64; HePlan picks the kernel by shape
  B. element_matvec   per-element He[e] @ v[idx[e]]        csrc/element_matvec.cu
     hvp              gather + element matvec + node sum   csrc/hvp.cu
  C. table_sum        gather-table node sum (no atomics)   csrc/table_sum.cu
     table_sum_em     the same from the element-major layout, field-major out
     segment_sum      its CSR-offset form, for skewed fan-in
     segment_add_     the same sum added in place into listed rows
  D. row_gather       out = v[idx] along rows              csrc/row_gather.cu
     take_along_rows  out[r, l] = v[idx[r, l], l]

The matrix-free H v of the solver is the one fused launch hvp, which equals
B then C bit for bit; LevelBasis.scatter_add = C.  The deterministic sums
of the Newton matrix are C's: element Hessians to deduplicated values and
the nested-dissection front assembly (one segment_sum per front group,
reading its sources through the group's list) and the forward sweep's
boundary updates (segment_add_).  The other gathers of the
nested-dissection fine level are D's row_gather.

The operands that never change after a level is set up are bound to plans
(HePlan: the level's P and quadrature weights; TablePlan: the gather table
and the element index, and the fused hvp's schedule built from them;
GatherPlan, TakeAlongPlan, SegmentPlan: index tensors): the plan validates
and keeps them once, and a call checks only the float operand, allocates
the output and launches.  The general wrappers check everything on every
call; a plan and its wrapper launch the same kernel and count in the same
LAUNCHES entry.

The CUDA sources are compiled with nvcc for sm_90a, one nvcc per source,
all started together, and linked into one shared library with a plain C
interface, at first use, under `build/kernels/` of the checkout, keyed by
a hash of the sources and flags; it is loaded with ctypes.  Each wrapper
checks its inputs and then:

* for CPU tensors, computes its plain PyTorch version (the tests use it);
* for CUDA tensors, launches the kernel on the current stream or raises —
  there is no fallback to the plain version on the GPU.

LAUNCHES counts kernel launches per wrapper, so a run can show that the
main path went through the kernels.  A launch recorded into a CUDA graph
runs nothing then: it counts under CAPTURED, and under LAUNCHES once per
replay of the graph (replay): the count is of kernels run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import NamedTuple

import numpy as np
import torch

from . import telemetry

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(os.path.dirname(_PKG), "build", "kernels")
_SOURCES = ("he_assemble.cu", "he_assemble_wide.cu", "element_matvec.cu", "hvp.cu",
            "table_sum.cu", "row_gather.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES = {
    "he_assemble": 0,
    "he_assemble_wide": 0,
    "element_matvec": 0,
    "hvp": 0,
    "table_sum": 0,
    "segment_sum": 0,
    "segment_add_": 0,
    "row_gather": 0,
    "take_along_rows": 0,
}

# launches recorded into a CUDA graph under capture (nothing ran)
CAPTURED = dict.fromkeys(LAUNCHES, 0)

_LOCK = threading.Lock()
_LIB = None


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
        CAPTURED[key] = 0


def replay(graph, recorded: dict) -> None:
    """Replay a CUDA graph whose capture recorded `recorded` launches
    ({name: count}, the change of CAPTURED over the capture) and count
    them under LAUNCHES."""
    graph.replay()
    for key, n in recorded.items():
        LAUNCHES[key] += n


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
    is not there yet: one nvcc per source, all started together, then one
    link.  Returns (library path, compiler output; empty when the library
    was already built)."""
    srcs = [os.path.join(_CSRC, s) for s in _SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as fh:
            h.update(fh.read())
    so = os.path.join(_BUILD, f"libmgb_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so, ""
    os.makedirs(_BUILD, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [os.path.join(_BUILD, f"{os.path.basename(s)}.{tag}.o") for s in srcs]
    tmp = f"{so}.tmp{os.getpid()}"
    log = []
    try:
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for s, o in zip(srcs, objs)
        ]
        failed = []
        for s, p in zip(srcs, procs):
            out, _ = p.communicate(timeout=900)
            log.append(out)
            if p.returncode != 0:
                failed.append(os.path.basename(s))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        res = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", tmp, *objs],
            capture_output=True, text=True, timeout=300,
        )
        log.append(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}\n{res.stderr}")
        os.rename(tmp, so)
    finally:
        for path in (tmp, *objs):
            if os.path.exists(path):
                os.unlink(path)
    return so, "\n".join(log)


def load():
    """Build (if needed) and load the kernel library; returns the ctypes
    handle."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build()[0])
            vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            for t in ("f32", "f64"):
                for name in ("he_assemble", "he_assemble_wide"):
                    fn = getattr(lib, f"mgb_{name}_{t}")
                    fn.argtypes = [vp, vp, vp, i64, i32, i32, i32, vp]
                    fn.restype = i32
                    fn = getattr(lib, f"mgb_{name}_weighted_{t}")
                    fn.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32, i32, vp]
                    fn.restype = i32
                fn = getattr(lib, f"mgb_element_matvec_{t}")
                fn.argtypes = [vp, vp, vp, vp, i64, i32, i32, i64, vp]
                fn.restype = i32
                fn = getattr(lib, f"mgb_hvp_{t}")
                fn.argtypes = [vp, vp, vp, vp, i32, i64, i32, i32, i64, i32, i32, vp]
                fn.restype = i32
                fn = getattr(lib, f"mgb_table_sum_{t}")
                fn.argtypes = [vp, vp, vp, i64, i64, i32, i32, vp]
                fn.restype = i32
                fn = getattr(lib, f"mgb_table_sum_em_{t}")
                fn.argtypes = [vp, vp, vp, i64, i64, i32, i32, i32, vp]
                fn.restype = i32
                fn = getattr(lib, f"mgb_segment_sum_{t}")
                fn.argtypes = [vp, vp, vp, vp, vp, i64, i64, i32, vp]
                fn.restype = i32
                for name in ("row_gather", "take_along_rows"):
                    fn = getattr(lib, f"mgb_{name}_{t}")
                    fn.argtypes = [vp, vp, vp, i64, i64, i32, vp]
                    fn.restype = i32
            lib.mgb_he_assemble_config.argtypes = [
                i32, i64, i32, i32, i32, i32, ctypes.POINTER(i64)]
            lib.mgb_he_assemble_config.restype = i32
            lib.mgb_he_assemble_wide_config.argtypes = [
                i32, i64, i32, i32, i32, ctypes.POINTER(i64)]
            lib.mgb_he_assemble_wide_config.restype = i32
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


def _kernel(name, dtype):
    """The library's C entry point of a kernel for a dtype."""
    return getattr(load(), f"mgb_{name}_{_SUFFIX[dtype]}")


# the current stream's handle as an int, without building a Stream object
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream
)


def _launch(name, fn, index, *args):
    """Launch fn(*args, stream) on device `index`'s current stream (also a
    stream that is being captured into a CUDA graph) and count it under
    LAUNCHES[name], or under CAPTURED[name] while the stream is being
    captured.  Nothing here waits for the device."""
    if torch.cuda.current_device() == index:
        rc = fn(*args, _raw_stream(index))
        capturing = torch.cuda.is_current_stream_capturing()
    else:
        with torch.cuda.device(index):
            rc = fn(*args, _raw_stream(index))
            capturing = torch.cuda.is_current_stream_capturing()
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    (CAPTURED if capturing else LAUNCHES)[name] += 1


def _plan_index(name, key, t, device=None):
    """Validate one static index tensor of a plan: int32, contiguous, on
    the CPU or a CUDA device (the plan's, if given)."""
    if t.device.type not in ("cpu", "cuda") or (device is not None and t.device != device):
        raise ValueError(f"{name}: {key} on {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: {key} has dtype {t.dtype}, expected torch.int32")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {key} is not contiguous")
    return t


def _plan_operand(name, key, t, device, rows):
    """The per-call check of a plan's float operand: device, dtype,
    contiguity, rank and leading size."""
    if t.device != device:
        raise ValueError(f"{name}: {key} on {t.device}, the plan is on {device}")
    if t.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {t.dtype} is not float32/float64")
    if not t.is_contiguous() or t.ndim not in (1, 2):
        raise ValueError(f"{name}: {key} must be contiguous, 1-D or 2-D")
    if t.shape[0] != rows:
        raise ValueError(f"{name}: {key} has {t.shape[0]} rows, the plan expects {rows}")


# ---------------------------------------------------------------------------
# A. element Hessian assembly
# ---------------------------------------------------------------------------


def he_assemble_plain(P: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """He[e] = sum_{q,j,l} P[e,q,j,:]^T W[e,q,j,l] P[e,q,l,:] — the two
    einsums of the JAX _SolverCtx._assemble_He."""
    T = torch.einsum("eqjl,eqlc->eqjc", W, P)
    return torch.einsum("eqjc,eqjd->ecd", P, T)


def he_assemble_weighted_plain(P: torch.Tensor, F2: torch.Tensor,
                               w: torch.Tensor) -> torch.Tensor:
    """he_assemble_plain(P, W) with W[e,q] = F2[e*nq+q] * w[e*nq+q]: the
    barrier Hessian rows F2 (n, k, k) times the quadrature weights w (n,)."""
    nelem, nq, k, _ = P.shape
    W = (F2 * w[:, None, None]).reshape(nelem, nq, k, k).contiguous()
    return he_assemble_plain(P, W)


class HePlan:
    """he_assemble bound to a level's static operands.

    P (nelem, nq, k, C) and, for the weighted entry, the quadrature weights
    w (nelem*nq,) are validated once (device, dtype, contiguity, shape) and
    kept alive.  Any shape runs: the plan picks the narrow kernel
    (csrc/he_assemble.cu, one He column per thread) where C <= 32 and
    nq*k <= 64, and the wide kernel (csrc/he_assemble_wide.cu, He tiled
    over several CTAs; float64 on the tensor cores, where the card refuses
    k > 40 for want of shared memory) otherwise; `kernel` ("narrow" or
    "wide") overrides the choice, for the checks that hold the two against
    each other where both apply (bit for bit in float32; in float64 the
    tensor cores may order a sum otherwise, so they are held within
    1e-13).  Launches count
    under LAUNCHES["he_assemble"] or LAUNCHES["he_assemble_wide"].
    plan(W) = he_assemble(P, W) and
    plan.weighted(F2) = he_assemble_weighted(P, F2, w), with only W or F2
    checked per call.  F2 (nelem*nq, k, k) may hold its (j, l) blocks in
    either order (contiguous, or the transposed view that torch.func's
    hessian returns): the kernel reads both without a copy.  On a CUDA
    device the kernel library is built and the entry points resolved here."""

    def __init__(self, P: torch.Tensor, w=None, kernel=None):
        name = "he_assemble"
        tensors = {"P": P} if w is None else {"P": P, "w": w}
        self.device = _check(name, tensors, ("P",))
        if P.ndim != 4:
            raise ValueError(f"{name}: P must be 4-D (nelem, nq, k, C)")
        self.P, self.w, self.dtype = P, w, P.dtype
        self.nelem, self.nq, self.k, self.C = P.shape
        if w is not None and tuple(w.shape) != (self.nelem * self.nq,):
            raise ValueError(
                f"{name}: w shape {tuple(w.shape)} != {(self.nelem * self.nq,)}")
        narrow_ok = self.C <= 32 and self.nq * self.k <= 64
        if kernel is None:
            kernel = "narrow" if narrow_ok else "wide"
        if kernel not in ("narrow", "wide") or (kernel == "narrow" and not narrow_ok):
            raise ValueError(
                f"{name}: kernel={kernel!r} does not take C={self.C}, nq*k={self.nq * self.k} "
                "(narrow: C <= 32 and nq*k <= 64; wide: any shape)")
        self.kernel = kernel
        self._name = "he_assemble" if kernel == "narrow" else "he_assemble_wide"
        self._fn = self._fn_w = None
        if self.device.type == "cuda":
            self._fn = _kernel(self._name, P.dtype)
            self._fn_w = _kernel(self._name + "_weighted", P.dtype)

    def _operand(self, key, t, shape):
        if t.device != self.device:
            raise ValueError(f"he_assemble: {key} on {t.device}, expected {self.device}")
        if t.dtype != self.dtype:
            raise TypeError(f"he_assemble: {key} has dtype {t.dtype}, expected {self.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"he_assemble: {key} shape {tuple(t.shape)} != {shape}")

    def _out(self):
        return torch.empty((self.nelem, self.C, self.C), dtype=self.dtype, device=self.device)

    def __call__(self, W: torch.Tensor) -> torch.Tensor:
        """W (nelem, nq, k, k) -> He (nelem, C, C)."""
        self._operand("W", W, (self.nelem, self.nq, self.k, self.k))
        if not W.is_contiguous():
            raise ValueError("he_assemble: W is not contiguous")
        if self.device.type == "cpu":
            return he_assemble_plain(self.P, W)
        out = self._out()
        _launch(self._name, self._fn, self.device.index, self.P.data_ptr(),
                W.data_ptr(), out.data_ptr(), self.nelem, self.nq, self.k, self.C)
        return out

    def weighted(self, F2: torch.Tensor) -> torch.Tensor:
        """F2 (nelem*nq, k, k) -> He (nelem, C, C) with W = F2 * w."""
        if self.w is None:
            raise ValueError("he_assemble: the plan has no weights w")
        self._operand("F2", F2, (self.nelem * self.nq, self.k, self.k))
        if F2.is_contiguous():
            transposed = 0
        elif F2.transpose(1, 2).is_contiguous():
            transposed = 1
        else:
            raise ValueError("he_assemble: F2's (k, k) blocks are not dense")
        if self.device.type == "cpu":
            return he_assemble_weighted_plain(self.P, F2, self.w)
        out = self._out()
        _launch(self._name, self._fn_w, self.device.index, self.P.data_ptr(),
                F2.data_ptr(), self.w.data_ptr(), out.data_ptr(), self.nelem,
                self.nq, self.k, self.C, transposed)
        return out


def he_assemble(P: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """P (nelem, nq, k, C), W (nelem, nq, k, k) -> He (nelem, C, C)."""
    return HePlan(P)(W)


def he_assemble_weighted(P: torch.Tensor, F2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """P (nelem, nq, k, C), F2 (nelem*nq, k, k), w (nelem*nq,) -> He
    (nelem, C, C) with W = F2 * w formed inside the kernel."""
    return HePlan(P, w).weighted(F2)


def he_assemble_config(dtype, nelem: int, nq: int, k: int, C: int, weighted: bool = False):
    """The narrow kernel's launch configuration for a shape on the current
    CUDA device: elements per CTA, threads per CTA, CTAs, shared memory per
    CTA."""
    out = (ctypes.c_int64 * 4)()
    rc = load().mgb_he_assemble_config(
        torch.empty((), dtype=dtype).element_size(), nelem, nq, k, C, int(weighted), out)
    if rc != 0:
        raise ValueError(f"he_assemble: the narrow kernel does not take nq={nq}, k={k}, C={C}")
    return dict(zip(("elements_per_cta", "threads", "ctas", "smem_bytes"), out))


def he_assemble_wide_config(dtype, nelem: int, nq: int, k: int, C: int):
    """The wide kernel's launch configuration (weighted entry) for a shape
    on the current CUDA device: He tile edge, threads per CTA, CTAs, shared
    memory per CTA, rows of the reduction axis per round, quadrature points
    per round (0 where a round cuts across points) and the MMA shape (m, n,
    k), (0, 0, 0) where the design uses no tensor cores (float32)."""
    out = (ctypes.c_int64 * 9)()
    rc = load().mgb_he_assemble_wide_config(
        torch.empty((), dtype=dtype).element_size(), nelem, nq, k, C, out)
    if rc != 0:
        raise ValueError(f"he_assemble_wide: the wide kernel does not take nq={nq}, k={k}, C={C}")
    keys = ("tile", "threads", "ctas", "smem_bytes", "rows_per_round", "points_per_round")
    return {**dict(zip(keys, out[:6])), "mma": tuple(out[6:9])}


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
    if C > 1024:
        raise ValueError(f"element_matvec: C={C} exceeds the kernel's 1024 threads per element")
    out = torch.empty((nelem * nl, nf), dtype=He.dtype, device=dev)
    _launch("element_matvec", _kernel("element_matvec", He.dtype), dev.index,
            He.data_ptr(), idx.data_ptr(),
            vp.data_ptr(), out.data_ptr(), nelem, nl, nf, vp.shape[1])
    return out


def hvp_plain(He: torch.Tensor, idx: torch.Tensor, tbl: torch.Tensor,
              vp: torch.Tensor, m: int) -> torch.Tensor:
    """H @ v as kernel B then kernel C compute it: (nf, m+1), zero pad slot."""
    return table_sum_plain(element_matvec_plain(He, idx, vp), tbl, m).T.contiguous()


def _hvp_shapes(name, He, vp, nelem, nl, m):
    if He.ndim != 3 or vp.ndim != 2 or vp.shape[1] != m + 1:
        raise ValueError(f"{name}: He 3-D and vp (nf, m+1) with m={m}, got "
                         f"{tuple(He.shape)} and {tuple(vp.shape)}")
    C = vp.shape[0] * nl
    if tuple(He.shape) != (nelem, C, C):
        raise ValueError(f"{name}: He shape {tuple(He.shape)} != {(nelem, C, C)}")


# The fused hvp's work schedule (csrc/hvp.cu): the shared memory one chunk
# may take (two CTAs per SM), the most entries a chunk holds, the work
# items a schedule aims at per SM and the fewest entries a chunk is cut to
# for that, and the most shared memory an H100 CTA can opt in to.
HVP_SMEM_BUDGET = 96 * 1024
HVP_MAX_CHUNK = 256
HVP_CTAS_PER_SM = 3
HVP_MIN_CHUNK = 32
_SMEM_LIMIT = 232448


def hvp_chunk_entries(C: int, nf: int) -> int:
    """Entries per chunk of the fused hvp at C = nf*nl: as many as let one
    chunk's shared memory (nf He rows per entry and one element's
    coefficients, each padded by at most 3 values, in float64; nf row
    products in each of two buffers; two indices) fit HVP_SMEM_BUDGET, at
    most HVP_MAX_CHUNK, at least 1.  Raises where one entry does not fit a CTA, or nf > 32 (one
    lane per field adds a long node)."""
    per_entry = 8 + (nf + 1) * (C + 3) * 8 + 2 * nf * 8
    if per_entry > _SMEM_LIMIT or nf > 32:
        raise ValueError(f"hvp: C={C} with nf={nf} does not fit the kernel "
                         "(one entry's rows must fit a CTA's shared memory, nf <= 32)")
    return max(1, min(HVP_MAX_CHUNK, HVP_SMEM_BUDGET // per_entry))


class HvpSchedule(NamedTuple):
    """The fused hvp's work (hvp_schedule), numpy int64 arrays.

    node_off (m+2,): node a's real entries are ent[node_off[a]:node_off[a+1]]
        (node m, the pad, has none)
    ent: the real table entries (flat positions e*nl + slot inside
        [0, nelem*nl)), node by node, each node's in table order
    chunks (n_chunks, 4): entry_lo, entry_hi, element_lo, element_hi; the
        chunks cut ent in order
    el: each chunk's distinct elements, ascending, chunk after chunk
    ent_le: each entry's element as a place in its chunk's list:
        el[chunks[c, 2] + ent_le[i]] == ent[i] // nl
    items (n_items, 4): node_lo, node_hi, chunk_lo, chunk_hi, one CTA each:
        a run of whole nodes of at most `run` entries in one chunk, or one
        node of more than `run` entries over chunks of at most `long`
        entries (these items first)
    run, long: as above
    E: the most entries of a chunk and nodes of an item (the kernel's
        shared-memory capacity)
    """

    node_off: np.ndarray
    ent: np.ndarray
    chunks: np.ndarray
    el: np.ndarray
    ent_le: np.ndarray
    items: np.ndarray
    run: int
    long: int
    E: int


def hvp_schedule(tbl, idx, m: int, nl: int, nf: int, ctas: int) -> HvpSchedule:
    """The fused hvp's schedule over a gather table tbl (m+1, width) of
    flat positions e*nl + slot and the element index idx (nelem, nl), for
    nf fields.  Entries outside [0, nelem*nl) are sentinels and left out;
    so is the pad row m.  Nodes are packed in order into runs of at most
    `run` entries and `run` nodes; a node of more entries is an item alone,
    cut into chunks of hvp_chunk_entries.  `run` is that size too, cut (not
    below HVP_MIN_CHUNK) where the level's entries would give fewer than
    `ctas` runs (the kernel launches on the card: HVP_CTAS_PER_SM per SM):
    a small level then still spreads over the card."""
    tbl, idx = np.asarray(tbl), np.asarray(idx)
    nelem = idx.shape[0]
    long = hvp_chunk_entries(nf * nl, nf)
    body = tbl[:m]
    real = (body >= 0) & (body < nelem * nl)
    run = min(long, max(HVP_MIN_CHUNK, -(-int(real.sum()) // int(ctas))))
    cnt = np.zeros(m + 1, np.int64)
    cnt[:m] = real.sum(axis=1)
    node_off = np.zeros(m + 2, np.int64)
    node_off[1:] = np.cumsum(cnt)
    ent = body[real].astype(np.int64)  # row-major: node by node, table order
    if ent.size >= 2**31:
        raise ValueError("hvp: more than 2**31 table entries")
    parts = []  # node ranges in node order; a long node alone
    lo, filled = 0, 0
    for a, c in enumerate(cnt.tolist()):
        if c > run or filled + c > run or a - lo >= run:
            if lo < a:
                parts.append((lo, a))
            lo, filled = a, 0
        if c > run:
            parts.append((a, a + 1))
            lo = a + 1
        else:
            filled += c
    if lo <= m:
        parts.append((lo, m + 1))
    bounds, items = [], []
    for a0, a1 in parts:
        e0, e1 = int(node_off[a0]), int(node_off[a1])
        cuts = list(range(e0, e1, long)) if e1 - e0 > run else [e0]
        items.append((a0, a1, len(bounds), len(bounds) + len(cuts)))
        bounds += cuts
    bounds = np.asarray(bounds + [ent.size], np.int64)
    n_chunks = bounds.size - 1
    chunk_of = np.repeat(np.arange(n_chunks, dtype=np.int64), np.diff(bounds))
    span = max(nelem, 1)
    uniq, inv = np.unique(chunk_of * span + ent // nl, return_inverse=True)
    el_off = np.searchsorted(uniq // span, np.arange(n_chunks + 1))
    chunks = np.stack([bounds[:-1], bounds[1:], el_off[:-1], el_off[1:]], axis=1)
    items = np.asarray(items, np.int64).reshape(-1, 4)
    is_long = items[:, 3] - items[:, 2] > 1
    E = max(int(np.diff(bounds).max(initial=0)), int((items[:, 1] - items[:, 0]).max()), 1)
    return HvpSchedule(node_off, ent, chunks, uniq % span, inv.reshape(-1) - el_off[chunk_of],
                       np.concatenate([items[is_long], items[~is_long]]), run, long, E)


class _HvpLaunch:
    """A schedule packed into the slabs the kernel reads (csrc/hvp.cu,
    struct Args), one int32 tensor on the device: slab k holds chunk k,
    the items' first chunks first (slab i is item i's), then the long
    items' later chunks, each item's together.  A slab is a header (the
    item's nodes, the chunk's entry and element counts, the slabs of the
    item's later chunks), then E entries, E element places, E+1 node
    offsets relative to the chunk and EL*nl node indices of its elements,
    padded to a multiple of four ints."""

    def __init__(self, s: HvpSchedule, idx: np.ndarray, device):
        idx = np.asarray(idx)
        nl = idx.shape[1]
        E = s.E
        EL = max(int(np.diff(s.chunks[:, 2:], axis=1).max(initial=0)), 1)
        CS = -(-(8 + 3 * E + 1 + EL * nl) // 4) * 4
        n_items = s.items.shape[0]
        later = [c for _, _, c0, c1 in s.items for c in range(c0 + 1, c1)]
        order = np.concatenate([s.items[:, 2], np.asarray(later, np.int64)])
        slabs = np.zeros((order.size, CS), np.int64)
        first = n_items
        for k, c in enumerate(order.tolist()):
            e0, e1, l0, l1 = s.chunks[c]
            slab = slabs[k]
            slab[2:4] = e1 - e0, l1 - l0
            slab[8:8 + e1 - e0] = s.ent[e0:e1]
            slab[8 + E:8 + E + e1 - e0] = s.ent_le[e0:e1]
            slab[8 + 3 * E + 1:8 + 3 * E + 1 + (l1 - l0) * nl] = idx[s.el[l0:l1]].reshape(-1)
            if k < n_items:
                a0, a1, c0, c1 = s.items[k]
                slab[0:2] = a0, a1
                slab[4:6] = first, first + c1 - c0 - 1
                first += c1 - c0 - 1
                if c1 - c0 == 1:
                    slab[8 + 2 * E:8 + 2 * E + a1 - a0 + 1] = s.node_off[a0:a1 + 1] - e0
        self.buf = torch.from_numpy(slabs.astype(np.int32).reshape(-1)).to(device)
        self.args = (n_items, CS, E, EL)


def _hvp_launch(fn, He, vp, launch, m, nl):
    out = torch.empty_like(vp)
    _launch("hvp", fn, He.device.index, He.data_ptr(), vp.data_ptr(), out.data_ptr(),
            launch.buf.data_ptr(), *launch.args, m, nl, vp.shape[0])
    return out


def _build_hvp_launch(tbl, idx, m, nl, nf):
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("hvp: the schedule for this table is built on the host, "
                           "which must not be under CUDA-graph capture")
    idx_np = idx.cpu().numpy()
    sms = torch.cuda.get_device_properties(tbl.device).multi_processor_count
    return _HvpLaunch(hvp_schedule(tbl.cpu().numpy(), idx_np, m, nl, nf,
                                   ctas=HVP_CTAS_PER_SM * sms), idx_np, tbl.device)


def hvp(He: torch.Tensor, idx: torch.Tensor, tbl: torch.Tensor, vp: torch.Tensor,
        m: int) -> torch.Tensor:
    """The fused matrix-free H @ v: He (nelem, C, C), idx (nelem, nl) int32
    with entries in [0, m], tbl (m+1, width) int32 gather table over the
    flat positions e*nl + slot, vp (nf, m+1) with C = nf*nl -> (nf, m+1),
    equal to table_sum(element_matvec(He, idx, vp), tbl, m).T bit for bit.
    On a CUDA device each call builds the kernel's schedule from tbl and
    idx (a host copy and sync, so not under CUDA-graph capture);
    TablePlan.hvp builds it once and is the solver's entry."""
    dev = _check("hvp", {"He": He, "idx": idx, "tbl": tbl, "vp": vp},
                 ("He", "vp"), ("idx", "tbl"))
    if idx.ndim != 2 or tbl.ndim != 2 or tbl.shape[0] != m + 1:
        raise ValueError("hvp: idx (nelem, nl) and tbl (m+1, width)")
    nelem, nl = idx.shape
    _hvp_shapes("hvp", He, vp, nelem, nl, m)
    if dev.type == "cpu":
        return hvp_plain(He, idx, tbl, vp, m)
    return _hvp_launch(_kernel("hvp", He.dtype), He, vp,
                       _build_hvp_launch(tbl, idx, m, nl, vp.shape[0]), m, nl)


# ---------------------------------------------------------------------------
# C. gather-table node sum
# ---------------------------------------------------------------------------


def table_sum_plain(src: torch.Tensor, tbl: torch.Tensor, m: int):
    """out[a] = sum_w src[tbl[a, w]] with the sentinel row (index
    src.shape[0]) read as zero, and out[m] = 0.  Summed in table order,
    as the kernel sums."""
    padded = torch.cat([src, src.new_zeros((1, src.shape[1]))], dim=0)
    g = padded[tbl]  # (m+1, width, f): one gather, then the adds in order
    out = g[:, 0].clone()
    for w in range(1, tbl.shape[1]):
        out += g[:, w]
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
    out = torch.empty((m + 1, src.shape[1]), dtype=src.dtype, device=dev)
    return _table_launch(_kernel("table_sum", src.dtype), src, tbl.data_ptr(), out,
                         src.shape[0], m, tbl.shape[1], src.shape[1])


def table_sum_em_plain(src: torch.Tensor, tbl: torch.Tensor, m: int, nl: int):
    """table_sum from the element-major layout: src (nelem, nf*nl) holds the
    value of table entry j = e*nl + slot and field f at src[e, f*nl + slot];
    returns (nf, m+1) field-major.  The same adds in the same order as
    table_sum_plain on the (nelem*nl, nf) permutation of src."""
    nelem = src.shape[0]
    nf = src.shape[1] // nl
    rows = src.reshape(nelem, nf, nl).permute(1, 0, 2).reshape(nf, nelem * nl)
    padded = torch.cat([rows, rows.new_zeros((nf, 1))], dim=1)
    g = padded[:, tbl]  # (nf, m+1, width)
    out = g[:, :, 0].clone()
    for w in range(1, tbl.shape[1]):
        out += g[:, :, w]
    out[:, m] = 0.0
    return out


def _table_em_shapes(name, src, nelem, nl):
    if src.ndim != 2 or src.shape[0] != nelem or src.shape[1] % nl or not src.shape[1]:
        raise ValueError(f"{name}: src must be ({nelem}, nf*{nl}), got {tuple(src.shape)}")


def _table_launch(fn, src, tbl_ptr, out, rows, m, width, *layout):
    _launch("table_sum", fn, src.device.index, src.data_ptr(), tbl_ptr,
            out.data_ptr(), rows, m, width, *layout)
    return out


def table_sum_em(src: torch.Tensor, tbl: torch.Tensor, m: int, nl: int) -> torch.Tensor:
    """src (nelem, nf*nl) element-major, tbl (m+1, width) int32 over the flat
    positions e*nl + slot -> (nf, m+1) field-major, pad column m zero."""
    dev = _check("table_sum_em", {"src": src, "tbl": tbl}, ("src",), ("tbl",))
    if tbl.ndim != 2 or tbl.shape[0] != m + 1 or src.ndim != 2:
        raise ValueError(f"table_sum_em: src 2-D and tbl (m+1, width) with m={m}")
    _table_em_shapes("table_sum_em", src, src.shape[0], nl)
    if dev.type == "cpu":
        return table_sum_em_plain(src, tbl, m, nl)
    nf = src.shape[1] // nl
    out = torch.empty((nf, m + 1), dtype=src.dtype, device=dev)
    return _table_launch(_kernel("table_sum_em", src.dtype), src, tbl.data_ptr(), out,
                         src.shape[0] * nl, m, tbl.shape[1], nf, nl)


class TablePlan:
    """table_sum, table_sum_em and the fused hvp bound to a level's static
    tables.

    tbl (m+1, width), the gather table over the flat positions e*nl + slot
    of nelem elements, and (for hvp) idx (nelem, nl) are validated once
    (device, int32, contiguity, shapes, table entries not negative, idx
    entries inside [0, m]) and kept alive.  plan(src) = table_sum(src, tbl,
    m), plan.em(src) = table_sum_em(src, tbl, m, nl) and plan.hvp(He, vp) =
    hvp(He, idx, tbl, vp, m), with only the float operands checked per
    call.  On a CUDA device the kernel library is built and its entry
    points resolved here, and the fused hvp's schedule (hvp_schedule) is
    built at its first call for a number of fields and kept: that call
    must not be under CUDA-graph capture."""

    def __init__(self, tbl: torch.Tensor, m: int, nelem: int, nl: int, idx=None):
        name = "TablePlan"
        self.device = _plan_index(name, "tbl", tbl).device
        self.tbl, self.idx = tbl, idx
        self.m, self.nelem, self.nl = int(m), int(nelem), int(nl)
        if tbl.ndim != 2 or tbl.shape[0] != self.m + 1 or self.nl <= 0:
            raise ValueError(f"{name}: tbl must be (m+1, width) with m={m}, nl > 0")
        self.width, self.rows = tbl.shape[1], self.nelem * self.nl
        if tbl.numel() and int(tbl.min()) < 0:
            raise ValueError(f"{name}: negative table entries")
        if idx is not None:
            _plan_index(name, "idx", idx, self.device)
            if tuple(idx.shape) != (self.nelem, self.nl):
                raise ValueError(f"{name}: idx shape {tuple(idx.shape)} != "
                                 f"{(self.nelem, self.nl)}")
            if idx.numel() and not (0 <= int(idx.min()) and int(idx.max()) <= self.m):
                raise ValueError(f"{name}: idx entries outside [0, {self.m}]")
        self._ptr = tbl.data_ptr()
        self._hvp = {}  # nf -> _HvpLaunch
        self._fn = {}
        if self.device.type == "cuda":
            self._fn = {(key, dt): _kernel(key, dt)
                        for key in ("table_sum", "table_sum_em", "hvp") for dt in _SUFFIX}

    def _operand(self, name, key, t):
        if t.device != self.device:
            raise ValueError(f"{name}: {key} on {t.device}, the plan is on {self.device}")
        if t.dtype not in _SUFFIX:
            raise TypeError(f"{name}: dtype {t.dtype} is not float32/float64")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")

    def __call__(self, src: torch.Tensor) -> torch.Tensor:
        """src (nelem*nl, f) -> (m+1, f), pad row m zero."""
        self._operand("TablePlan", "src", src)
        if src.ndim != 2 or src.shape[0] != self.rows:
            raise ValueError(f"TablePlan: src must be ({self.rows}, f), got {tuple(src.shape)}")
        if self.device.type == "cpu":
            return table_sum_plain(src, self.tbl, self.m)
        out = torch.empty((self.m + 1, src.shape[1]), dtype=src.dtype, device=self.device)
        return _table_launch(self._fn["table_sum", src.dtype], src, self._ptr, out,
                             self.rows, self.m, self.width, src.shape[1])

    def em(self, src: torch.Tensor) -> torch.Tensor:
        """src (nelem, nf*nl) element-major -> (nf, m+1) field-major."""
        self._operand("TablePlan.em", "src", src)
        _table_em_shapes("TablePlan.em", src, self.nelem, self.nl)
        if self.device.type == "cpu":
            return table_sum_em_plain(src, self.tbl, self.m, self.nl)
        nf = src.shape[1] // self.nl
        out = torch.empty((nf, self.m + 1), dtype=src.dtype, device=self.device)
        return _table_launch(self._fn["table_sum_em", src.dtype], src, self._ptr, out,
                             self.rows, self.m, self.width, nf, self.nl)

    def hvp(self, He: torch.Tensor, vp: torch.Tensor) -> torch.Tensor:
        """He (nelem, C, C), vp (nf, m+1) -> H @ v (nf, m+1), one launch."""
        if self.idx is None:
            raise ValueError("TablePlan.hvp: the plan has no idx")
        self._operand("TablePlan.hvp", "He", He)
        self._operand("TablePlan.hvp", "vp", vp)
        if He.dtype != vp.dtype:
            raise TypeError("TablePlan.hvp: He and vp differ in dtype")
        _hvp_shapes("TablePlan.hvp", He, vp, self.nelem, self.nl, self.m)
        if self.device.type == "cpu":
            return hvp_plain(He, self.idx, self.tbl, vp, self.m)
        nf = vp.shape[0]
        if nf not in self._hvp:
            telemetry.build("hvp_schedule")
            with telemetry.span("hvp.schedule"):
                self._hvp[nf] = _build_hvp_launch(self.tbl, self.idx, self.m, self.nl, nf)
        return _hvp_launch(self._fn["hvp", He.dtype], He, vp, self._hvp[nf], self.m, self.nl)


def segment_sum_plain(src: torch.Tensor, lst, off: torch.Tensor) -> torch.Tensor:
    """out[a] = sum_{off[a] <= j < off[a+1]} src[lst[j]] (src[j] when lst is
    None), summed in list order from zero, as the kernel sums.  List
    entries must lie in [0, rows)."""
    off = off.long()
    start, cnt = off[:-1], off[1:] - off[:-1]
    out = src.new_zeros((cnt.shape[0],) + tuple(src.shape[1:]))
    for w in range(int(cnt.max()) if cnt.numel() else 0):
        sel = torch.nonzero(cnt > w)[:, 0]
        j = start[sel] + w
        out[sel] += src[lst[j].long() if lst is not None else j]
    return out


def segment_add_plain(dst: torch.Tensor, src: torch.Tensor, lst, off: torch.Tensor,
                      ids: torch.Tensor) -> torch.Tensor:
    """dst[ids[a]] += sum_{off[a] <= j < off[a+1]} src[lst[j]] in place, for
    unique ids; each sum in list order from zero, then one add into dst.
    Returns dst."""
    ids = ids.long()
    dst[ids] = dst[ids] + segment_sum_plain(src, lst, off)
    return dst


def _segment_shapes(name, src, lst, off):
    if src.ndim not in (1, 2) or off.ndim != 1 or off.numel() == 0 or (
            lst is not None and lst.ndim != 1):
        raise ValueError(f"{name}: src 1-D or 2-D, lst and off 1-D, off not empty")


def _segment_launch(name, fn, src, lst_ptr, off_ptr, ids_ptr, out, nseg):
    if nseg:
        _launch(name, fn, src.device.index, src.data_ptr(), lst_ptr, off_ptr,
                ids_ptr, out.data_ptr(), src.shape[0], nseg,
                1 if src.ndim == 1 else src.shape[1])
    return out


def segment_sum(src: torch.Tensor, lst, off: torch.Tensor) -> torch.Tensor:
    """src (rows,) or (rows, f), lst int32 source positions sorted by
    destination (or None: src itself is in destination order), off int32
    (nseg+1,) offsets into lst -> (nseg,) or (nseg, f)."""
    tensors = {"src": src, "off": off}
    if lst is not None:
        tensors["lst"] = lst
    dev = _check("segment_sum", tensors, ("src",), ("lst", "off"))
    _segment_shapes("segment_sum", src, lst, off)
    if dev.type == "cpu":
        return segment_sum_plain(src, lst, off)
    nseg = off.shape[0] - 1
    out = torch.empty((nseg,) + tuple(src.shape[1:]), dtype=src.dtype, device=dev)
    if not out.numel():
        return out
    return _segment_launch(
        "segment_sum", _kernel("segment_sum", src.dtype), src,
        None if lst is None else lst.data_ptr(), off.data_ptr(), None, out, nseg)


def segment_add_(dst: torch.Tensor, src: torch.Tensor, lst, off: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """dst[ids[a]] += sum_{off[a] <= j < off[a+1]} src[lst[j]] in place and
    without atomics: ids (nseg,) int32 must be unique (the solver's are
    sorted).  dst (n,) or (n, f), src (rows,) or (rows, f) with the same f.
    Returns dst."""
    tensors = {"dst": dst, "src": src, "off": off, "ids": ids}
    if lst is not None:
        tensors["lst"] = lst
    dev = _check("segment_add_", tensors, ("dst", "src"), ("lst", "off", "ids"))
    _segment_shapes("segment_add_", src, lst, off)
    if dst.ndim != src.ndim or dst.shape[1:] != src.shape[1:] or ids.ndim != 1 or (
            ids.shape[0] != off.shape[0] - 1):
        raise ValueError("segment_add_: dst and src of one row shape, ids (nseg,)")
    if dev.type == "cpu":
        return segment_add_plain(dst, src, lst, off, ids)
    if not src.numel():
        return dst
    return _segment_launch(
        "segment_add_", _kernel("segment_sum", src.dtype), src,
        None if lst is None else lst.data_ptr(), off.data_ptr(), ids.data_ptr(),
        dst, ids.shape[0])


class SegmentPlan:
    """segment_sum / segment_add_ bound to static tables.

    lst (or None), off and, for the in-place form, ids are validated once
    (device, int32, contiguity, sizes, list entries inside [0, rows), ids
    unique inside [0, ndst)) and kept alive; plan(src) = segment_sum(src,
    lst, off) and plan.add_(dst, src) = segment_add_(dst, src, lst, off,
    ids), with only the float operands checked per call.  On a CUDA device
    the kernel library is built and its entry points resolved here."""

    def __init__(self, lst, off: torch.Tensor, rows: int, ids=None, ndst=None):
        name = "SegmentPlan"
        self.device = _plan_index(name, "off", off).device
        self.lst, self.off, self.ids = lst, off, ids
        for key, t in (("lst", lst), ("ids", ids)):
            if t is not None:
                _plan_index(name, key, t, self.device)
        if off.ndim != 1 or off.numel() == 0 or (lst is not None and lst.ndim != 1):
            raise ValueError(f"{name}: lst and off 1-D, off not empty")
        self.rows, self.nseg = int(rows), off.shape[0] - 1
        n_list = self.rows if lst is None else lst.numel()
        steps = off[1:] - off[:-1]
        if int(off[0]) != 0 or int(off[-1]) > n_list or bool((steps < 0).any()):
            raise ValueError(f"{name}: off must ascend from 0 to at most {n_list}")
        if lst is not None and lst.numel() and not (
                0 <= int(lst.min()) and int(lst.max()) < self.rows):
            raise ValueError(f"{name}: lst entries outside [0, {self.rows})")
        self.ndst = None if ndst is None else int(ndst)
        if ids is not None:
            if ids.ndim != 1 or ids.shape[0] != self.nseg or self.ndst is None:
                raise ValueError(f"{name}: ids (nseg,) and ndst go together")
            if self.nseg and not (0 <= int(ids.min()) and int(ids.max()) < self.ndst
                                  and torch.unique(ids).numel() == self.nseg):
                raise ValueError(f"{name}: ids must be unique inside [0, {self.ndst})")
        self._ptr = tuple(None if t is None else t.data_ptr() for t in (lst, off, ids))
        self._fn = {}
        if self.device.type == "cuda":
            self._fn = {dt: _kernel("segment_sum", dt) for dt in _SUFFIX}

    def __call__(self, src: torch.Tensor) -> torch.Tensor:
        _plan_operand("SegmentPlan", "src", src, self.device, self.rows)
        if self.device.type == "cpu":
            return segment_sum_plain(src, self.lst, self.off)
        out = torch.empty((self.nseg,) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=self.device)
        if not out.numel():
            return out
        return _segment_launch("segment_sum", self._fn[src.dtype], src,
                               self._ptr[0], self._ptr[1], None, out, self.nseg)

    def add_(self, dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        if self.ids is None:
            raise ValueError("SegmentPlan.add_: the plan has no ids")
        _plan_operand("SegmentPlan.add_", "src", src, self.device, self.rows)
        _plan_operand("SegmentPlan.add_", "dst", dst, self.device, self.ndst)
        if dst.dtype != src.dtype or dst.shape[1:] != src.shape[1:]:
            raise TypeError("SegmentPlan.add_: dst and src differ in dtype or row shape")
        if self.device.type == "cpu":
            return segment_add_plain(dst, src, self.lst, self.off, self.ids)
        if not src.numel():
            return dst
        return _segment_launch("segment_add_", self._fn[src.dtype], src,
                               *self._ptr, dst, self.nseg)


# ---------------------------------------------------------------------------
# D. row gather
# ---------------------------------------------------------------------------


def row_gather_plain(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v[idx] along rows with the index clamped to [0, n-1] (the probe's
    take(..., mode="clip"))."""
    return v[idx.long().clamp(0, v.shape[0] - 1)]


def _gather_launch(fn, v, idx_ptr, idx_shape, rows):
    out = torch.empty(idx_shape + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
    if out.numel():
        _launch("row_gather", fn, v.device.index, v.data_ptr(), idx_ptr,
                out.data_ptr(), rows, v.shape[0], 1 if v.ndim == 1 else v.shape[1])
    return out


def row_gather(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v (n,) or (n, lanes), idx int32 of any shape -> (*idx.shape) or
    (*idx.shape, lanes); indices are clamped to [0, n-1]."""
    dev = _check("row_gather", {"v": v, "idx": idx}, ("v",), ("idx",))
    if v.ndim not in (1, 2):
        raise ValueError(f"row_gather: v must be 1-D or 2-D, got {tuple(v.shape)}")
    if v.shape[0] == 0 and idx.numel():
        raise ValueError("row_gather: gather from an empty v")
    if dev.type == "cpu":
        return row_gather_plain(v, idx)
    return _gather_launch(_kernel("row_gather", v.dtype), v, idx.data_ptr(),
                          tuple(idx.shape), idx.numel())


class GatherPlan:
    """row_gather bound to a static index tensor: idx is validated once
    (device, int32, contiguity) and kept alive; plan(v) = row_gather(v,
    idx) for v of n rows, with only v checked per call.  On a CUDA device
    the kernel library is built and its entry points resolved here."""

    def __init__(self, idx: torch.Tensor, n: int):
        self.idx = _plan_index("GatherPlan", "idx", idx)
        self.device, self.n = idx.device, int(n)
        if self.n <= 0 and idx.numel():
            raise ValueError("GatherPlan: gather from an empty v")
        self._shape, self._rows, self._ptr = tuple(idx.shape), idx.numel(), idx.data_ptr()
        self._fn = {}
        if self.device.type == "cuda":
            self._fn = {dt: _kernel("row_gather", dt) for dt in _SUFFIX}

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        _plan_operand("GatherPlan", "v", v, self.device, self.n)
        if self.device.type == "cpu":
            return row_gather_plain(v, self.idx)
        return _gather_launch(self._fn[v.dtype], v, self._ptr, self._shape, self._rows)


def take_along_rows_plain(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[r, l] = v[clamp(idx[r, l]), l] (take_along_axis(v, idx, axis=0,
    mode="clip"))."""
    return torch.gather(v, 0, idx.long().clamp(0, v.shape[0] - 1))


def _along_launch(fn, v, idx_ptr, shape):
    out = torch.empty(shape, dtype=v.dtype, device=v.device)
    if out.numel():
        _launch("take_along_rows", fn, v.device.index, v.data_ptr(), idx_ptr, out.data_ptr(),
                shape[0], v.shape[0], shape[1])
    return out


def take_along_rows(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v (n, lanes), idx (rows, lanes) int32 -> (rows, lanes)."""
    dev = _check("take_along_rows", {"v": v, "idx": idx}, ("v",), ("idx",))
    if v.ndim != 2 or idx.ndim != 2 or idx.shape[1] != v.shape[1]:
        raise ValueError(
            f"take_along_rows: v (n, lanes) and idx (rows, lanes), got "
            f"{tuple(v.shape)} and {tuple(idx.shape)}"
        )
    if v.shape[0] == 0 and idx.numel():
        raise ValueError("take_along_rows: gather from an empty v")
    if dev.type == "cpu":
        return take_along_rows_plain(v, idx)
    return _along_launch(_kernel("take_along_rows", v.dtype), v, idx.data_ptr(),
                         tuple(idx.shape))


class TakeAlongPlan:
    """take_along_rows bound to a static index tensor: idx (rows, lanes) is
    validated once (device, int32, contiguity, rank) and kept alive;
    plan(v) = take_along_rows(v, idx) for v (n, lanes), with only v checked
    per call.  On a CUDA device the kernel library is built and its entry
    points resolved here."""

    def __init__(self, idx: torch.Tensor, n: int):
        self.idx = _plan_index("TakeAlongPlan", "idx", idx)
        if idx.ndim != 2:
            raise ValueError(f"TakeAlongPlan: idx must be (rows, lanes), got {tuple(idx.shape)}")
        self.device, self.n = idx.device, int(n)
        if self.n <= 0 and idx.numel():
            raise ValueError("TakeAlongPlan: gather from an empty v")
        self._shape, self._ptr = tuple(idx.shape), idx.data_ptr()
        self._fn = {}
        if self.device.type == "cuda":
            self._fn = {dt: _kernel("take_along_rows", dt) for dt in _SUFFIX}

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        _plan_operand("TakeAlongPlan", "v", v, self.device, self.n)
        if v.ndim != 2 or v.shape[1] != self._shape[1]:
            raise ValueError(f"TakeAlongPlan: v must be ({self.n}, {self._shape[1]}), "
                             f"got {tuple(v.shape)}")
        if self.device.type == "cpu":
            return take_along_rows_plain(v, self.idx)
        return _along_launch(self._fn[v.dtype], v, self._ptr, self._shape)
