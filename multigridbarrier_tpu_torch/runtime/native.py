"""ctypes bindings for the host geometry helpers (native/mgb_native.cpp).

The same C++ source as the JAX package's binding; the shared library is
built with g++ on first use into the port's own `build/native/` directory
(the JAX package's `native/` directory is left untouched).  Every entry
point has a numpy fallback, so the package works without the library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_SRC = os.path.join(_ROOT, "native", "mgb_native.cpp")
_SO_PATH = os.path.join(_ROOT, "build", "native", "libmgb_native.so")


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("MGB_NO_NATIVE") or not os.path.exists(_SRC):
            return None
        try:
            if not os.path.exists(_SO_PATH) or (
                os.path.getmtime(_SRC) > os.path.getmtime(_SO_PATH)
            ):
                os.makedirs(os.path.dirname(_SO_PATH), exist_ok=True)
                # compile to a pid-unique temp path and rename atomically, so
                # concurrent processes never dlopen a partially written .so
                tmp = f"{_SO_PATH}.tmp{os.getpid()}"
                try:
                    subprocess.run(
                        ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                         "-o", tmp, _SRC],
                        check=True,
                        capture_output=True,
                        timeout=120,
                    )
                    os.rename(tmp, _SO_PATH)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            lib = ctypes.CDLL(_SO_PATH)
        except (OSError, subprocess.SubprocessError):
            return None

        i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C")

        lib.csr_to_ell.restype = ctypes.c_int
        lib.csr_to_ell.argtypes = [
            ctypes.c_int64, i64p, i32p, f64p, ctypes.c_int64, i32p, f64p
        ]
        lib.element_max_cols.restype = ctypes.c_int64
        lib.element_max_cols.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, i32p]
        lib.csr_to_level_basis.restype = ctypes.c_int
        lib.csr_to_level_basis.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64p, i32p, f64p, ctypes.c_int64, i32p, f64p,
        ]
        lib.tri_edge_tables.restype = ctypes.c_int64
        lib.tri_edge_tables.argtypes = [ctypes.c_int64, i64p, i64p, i64p, i32p]
        _LIB = lib
        return _LIB


def csr_to_ell(indptr, indices, data, nrows, K):
    """Native CSR->ELL padding; returns float64/int32 (cols, vals) or None
    if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    cols = np.zeros((nrows, K), dtype=np.int32)
    vals = np.zeros((nrows, K), dtype=np.float64)
    rc = lib.csr_to_ell(
        nrows,
        np.ascontiguousarray(indptr, dtype=np.int64),
        np.ascontiguousarray(indices, dtype=np.int32),
        np.ascontiguousarray(data, dtype=np.float64),
        K,
        cols,
        vals,
    )
    if rc != 0:
        raise ValueError(f"row nnz exceeds width {K}")
    return cols, vals


def csr_to_level_basis(indptr, indices, data, nelem, nq, m):
    """Native element-local extraction; returns (idx int32, rloc float64,
    nl) or None."""
    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    data = np.ascontiguousarray(data, dtype=np.float64)
    nl = int(lib.element_max_cols(nelem, nq, indptr, indices))
    idx = np.full((nelem, nl), m, dtype=np.int32)
    rloc = np.zeros((nelem, nq, nl), dtype=np.float64)
    rc = lib.csr_to_level_basis(nelem, nq, m, indptr, indices, data, nl, idx, rloc)
    if rc != 0:
        raise RuntimeError("csr_to_level_basis: nl overflow")
    return idx, rloc, nl


def tri_edge_tables(tris):
    """Native triangle edge tables; returns (tri_edges, edge_pairs,
    edge_count) or None."""
    lib = _load()
    if lib is None:
        return None
    tris = np.ascontiguousarray(tris, dtype=np.int64)
    nt = len(tris)
    tri_edges = np.zeros((nt, 3), dtype=np.int64)
    edge_pairs = np.zeros((3 * nt, 2), dtype=np.int64)
    edge_count = np.zeros(3 * nt, dtype=np.int32)
    ne = int(lib.tri_edge_tables(nt, tris, tri_edges, edge_pairs, edge_count))
    return tri_edges, edge_pairs[:ne], edge_count[:ne]
