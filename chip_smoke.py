#!/usr/bin/env python3
"""Smoke run of the PyTorch port (multigridbarrier_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, one printed line each (or a few):
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, and
     the nvcc build of the hand-written kernels (csrc/*.cu, sm_90a, one
     nvcc per source, all started together) into build/kernels/, with its
     time and ptxas resource lines, and the narrow kernel A's elements, threads and
     shared memory per CTA at the L=7 fine shape; the wide kernel A's He tile,
     warps, shared memory per CTA, CTAs and MMA shape at (64,64,5,128), and
     the count of float64 tensor-core (DMMA) instructions in its built code
     (cuobjdump -sass; none fails the phase);
  2. each kernel against its plain PyTorch version on the card, float64
     and float32 (TF32 off), at the main-path shapes of fem2d L=6 and L=7
     (the nested-dissection gathers and sums of the L=7 fine level among
     them: the fused front assembly of the largest group, the forward
     sweep's in-place update, He -> vals with its long pad runs) and at
     small or probe shapes (a long-run case with NaN and zero runs, wide
     rows with an odd lane count and an unaligned base), with median times
     over 30 runs of the kernel, its plain version and, where one exists,
     the one PyTorch call that computes the same function (timed as a
     yardstick only).  Beside the general wrapper it also times the planned
     launch (HePlan / TablePlan / GatherPlan / SegmentPlan), and the
     host microseconds per call of both and of the library call (5 rounds of
     200 calls without a synchronize).
     A he_assemble, B element_matvec and the fused hvp agree with their
     plain versions (einsums, which sum in another order) to
     max|k-p|/max|p| <= 1e-12 (f64) and 1e-5 (f32), and exactly with the
     other entries of the same kernel: HePlan and the weighted entry (from
     F2 in both block orders) with he_assemble on the product F2 * w, the
     fused hvp at every level of L=7 with kernel B followed by kernel C.
     C's table_sum (both layouts, wrapper and TablePlan), segment_sum and
     segment_add_ and D's row_gather/take_along_rows agree with their
     plain versions exactly, NaN for NaN;
     then one front group's fused assembly, one sweep gather and one
     in-place sweep update, and after them one weighted he_assemble, one
     element-major table sum and one fused hvp, are recorded into CUDA
     graphs and replayed twice on refilled inputs, and must equal the
     eager results exactly (the kernels launch on the capturing stream
     with no host sync).
     Kernel A's wide form (he_assemble_wide: hexahedra, three or more
     fields) runs both entries at (64,64,5,128) and (512,64,5,128) (the 3D
     problem at L=3 and L=4), (64,64,6,192) and (8,64,7,256)
     (parabolic_solve on it and its phase 1) and (8,27,5,54) (Q2
     hexahedra) against the plain version within the same tolerances, and
     at (8192,7,4,12) and (64,8,5,16), which both kernels take, exactly
     against the narrow kernel in float32 and against the plain version in
     float64 (the wide kernel sums on the tensor cores there); the fused hvp at every level of fem3d L=3
     k=3 (nl = 8, 27, 64) exactly against kernel B followed by kernel C;
  3. fem2d_solve(L=5, p=1.0) on the default backend: every level dense;
     c_dot_Dz within 5e-7 rel of 27.360702531510;
  4. fem2d L=6 with dense_threshold=1<<30, a warm-up run and a timed run:
     dense Cholesky on every level; c_dot_Dz within 5e-7 rel of
     15.4183231432;
  5. fem2d L=6 on the default backend, twice in one process: the fine
     level on the nested-dissection route; c_dot_Dz within 5e-7 rel of
     15.4183231432, and the two runs give identical its and c_dot_Dz;
  6. fem2d_solve(L=7, p=1.0) on the default backend (two ND levels):
     c_dot_Dz inside FLOOR_BAND[7] = (9.415747, 9.415769); prints the
     symbolic-build seconds, the solve wall, its, peak device memory and
     the kernel launches;
  7. fem3d_solve(L=3, k=3, p=1.0) on the default backend, twice in one
     process (64 Q3 hexahedra, 2,662 unknowns on the fine level, which
     takes the nested-dissection route): the two runs give identical its
     and c_dot_Dz, ||grad u|| <= s + 1e-5 at every point, and c_dot_Dz
     within 1e-5 rel of the same problem solved with dense_threshold=1<<30
     in the same run; the wide kernel A must have launched and the narrow
     one must not;
  8. fem3d L=2 k=3 with dense_threshold=64: c_dot_Dz within 1e-5 rel of
     192.49066199206504 (the JAX package's exact-dense pin);
  9. parabolic_solve(h=0.5, t1=1.0, p=1.0) on fem3d L=2 k=3 (three fields:
     the wide kernel at C = 81, every hexahedron touching the boundary), on
     fem3d L=3 k=3 (the wide kernel at (64, 6, 192), nested dissection on
     the fine level) and on fem1d L=6: ts = [0, 0.5, 1], finite snapshots
     of shape (n, 3), the fine element shape as expected;
 10. fem1d_solve(L=8) at p=1.0 and p=2.0: finite, the path followed to t = 1/tol;
 11. the obstacle problem of tests/test_obstacle.py at fem2d L=3, whose
     start is infeasible: the feasibility phase runs
     (SOL_feasibility.its.sum() > 0), then the main phase; the obstacle
     holds to 1e-6 and is active, and c_dot_Dz is within 5e-7 rel of the
     JAX package's CPU run of the same problem, 100.47994191584185.  (L=3
     is the largest L at which the JAX package solves this problem on the
     CPU: at L=4 both packages grind past maxit.)
The solve lines of fem2d, fem3d, parabolic_solve on fem3d and the obstacle
problem print the previous commit's c_dot_Dz and its beside their own, with
the relative change.
In every solve phase the launch counters are reset just before the solve
and each kernel of that route must have launched (he_assemble, hvp,
table_sum and segment_sum on the dense route; also segment_add_ and
row_gather where a level takes nested dissection), and element_matvec,
which the fused hvp absorbed, must not.  Then the card line
again, a JSON line with the per-kernel results (launches from phase 6;
he_assemble_wide's from the first run of phase 7), and last the JSON
status line.  Any failure raises and exits non-zero;
with no CUDA device it exits 1 before printing any result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import multigridbarrier_tpu_torch as mt
from multigridbarrier_tpu_torch.runtime import cuda_kernels as ck
from multigridbarrier_tpu_torch.solver.hostsolve import HostPattern
from multigridbarrier_tpu_torch.solver.ndsolve import NDSymbolic, node_coords

C_EXACT = {5: 27.360702531510, 6: 15.4183231432}
FLOOR_BAND_7 = (9.415747, 9.415769)  # tests/test_ground_truth.py FLOOR_BAND[7]
TOL = {"float64": 1e-12, "float32": 1e-5}
EXACT = ("table_sum", "segment_sum", "segment_add_", "row_gather", "take_along_rows")
C_FEM3D_L2K3 = 192.49066199206504  # tests/test_fem3d.py: exact-dense direct run
C_OBSTACLE_L3 = 100.47994191584185  # the JAX package on the CPU, obstacle problem, fem2d L=3
REPLACES = {
    "he_assemble": "multigridbarrier_tpu/runtime/pallas_kernels.py:56",
    "he_assemble_wide": "multigridbarrier_tpu/runtime/pallas_kernels.py:56",
    "element_matvec": "tools/probe_pallas_gather.py:196",
    "hvp": "tools/probe_pallas_gather.py:196",
    "table_sum": "tools/probe_pallas_gather.py:124",
    "segment_sum": "tools/probe_pallas_gather.py:124",
    "segment_add_": "tools/probe_pallas_gather.py:124",
    "row_gather": "tools/probe_pallas_gather.py:83",
    "take_along_rows": "tools/probe_pallas_gather.py:58",
}
SOURCE = {
    "he_assemble": "he_assemble.cu",
    "he_assemble_wide": "he_assemble_wide.cu",
    "element_matvec": "element_matvec.cu",
    "hvp": "hvp.cu",
    "table_sum": "table_sum.cu",
    "segment_sum": "table_sum.cu",
    "segment_add_": "table_sum.cu",
    "row_gather": "row_gather.cu",
    "take_along_rows": "row_gather.cu",
}
# c_dot_Dz and its of the previous commit's chip run on an NVIDIA H100 80GB
# HBM3 (700 W), printed beside this run's with the relative change; its
# None where that run's record kept c_dot_Dz only
PREVIOUS = {
    "fem2d L=5": (27.360702531696074, None),
    "fem2d L=6 dense": (15.418322518741638, None),
    "fem2d L=6 default": (15.418323143213279, None),
    "fem2d L=7": (9.415747537960051, None),
    "fem3d L=3 k=3": (105.65720339962175, [6, 9, 86]),
    "fem3d L=2 k=3 forced ND": (192.49066199206504, [6, 91]),
    "obstacle L=3": (100.47994191584186, [12, 6, 44]),
    "parabolic fem3d L=2 k=3": ([377.9210985908903, 376.29611482559017], [[8, 113], [8, 118]]),
    "parabolic fem3d L=3 k=3": ([203.60575803814731, 201.7160003677882], [[9, 9, 118], [9, 9, 117]]),
}
DENSE_PATH = ("he_assemble", "hvp", "table_sum", "segment_sum")
ND_PATH = DENSE_PATH + ("segment_add_", "row_gather")
# the same routes for wide elements: the wide kernel A in place of the narrow
WIDE_DENSE_PATH = ("he_assemble_wide",) + DENSE_PATH[1:]
WIDE_ND_PATH = ("he_assemble_wide",) + ND_PATH[1:]
# Roofline of one H100 SXM: 3.35 TB/s HBM3; 67 TFLOP/s for float32 outside
# the tensor cores and for float64 (its tensor-core peak, the higher of the
# data sheet's two float64 rates, so the bound is the least time).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12}


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def beside_previous(label, c, its):
    """This run's c_dot_Dz and its beside the previous commit's (PREVIOUS),
    with the relative change; '' where there is no record."""
    if label not in PREVIOUS:
        return ""
    c0, its0 = PREVIOUS[label]
    same = c == c0 and (its0 is None or its == its0)
    return (f" [previous commit: c_dot_Dz={c0!r}" + (f" its={its0}" if its0 else "")
            + f"; change {abs(c - c0) / abs(c0):.3e} rel{', bit for bit' if same else ''}]")


def dmma_count(so):
    """DMMA (float64 tensor-core) instructions in the wide kernel's
    functions of the built library, from cuobjdump -sass: {opcode: count}."""
    cuobjdump = os.path.join(os.path.dirname(ck._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, fn = {}, ""
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif "he_assemble_wide" in fn and "DMMA" in line:
            op = next(w for w in line.replace(";", " ").split() if w.startswith("DMMA"))
            counts[op] = counts.get(op, 0) + 1
    return counts


def median_ms(fn, reps=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, calls=200, rounds=5):
    """Host microseconds per call: the wall of `calls` calls in a row with
    no synchronize between them (the enqueue cost); the median of `rounds`
    such rounds, after a warm-up."""
    for _ in range(3):
        fn()
    per_call = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Case:
    """One kernel at one shape: kernel, plain version and library call as
    closures over tensors on the card; bytes and flops for the bound.
    `planned` is the same launch through a plan, `timed` and
    `timed_planned` what the timing loops call where the checked call must
    not be repeated (an in-place update), `extra` more yardsticks to time
    {label: closure}, `exact` other entries of the same kernel whose
    results must equal the kernel's bit for bit {label: closure}, `close`
    other kernels of the same function held to the plain version within
    the tolerance {label: closure}."""

    def __init__(self, name, shape, kernel, plain, library, nbytes_, flops, dtype,
                 planned=None, timed=None, timed_planned=None, extra=None, exact=None,
                 host=True, close=None):
        self.name, self.shape, self.dtype, self.host = name, shape, dtype, host
        self.kernel, self.plain, self.library = kernel, plain, library
        self.bytes, self.flops = nbytes_, flops
        self.planned, self.extra, self.exact = planned, extra or {}, exact or {}
        self.close = close or {}  # other kernels held to the plain version, within tol
        self.timed, self.timed_planned = timed or kernel, timed_planned or planned
        self.expect = {}  # output row -> value it must hold (NaN: any NaN)

    def bound(self):
        t_bytes = self.bytes / HBM_BYTES_PER_S * 1e3
        t_ops = self.flops / PEAK_FLOPS[self.dtype] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def he_cases(shape, dtype, dev, rng, both=False):
    """Kernel A at one shape, two cases: the weighted entry (what a Newton
    step launches: W = F2 * w formed in the kernel) and the entry that is
    given W.  Each is held to its plain version (einsums) within the
    tolerance, and exactly to the same kernel's other entries.  HePlan
    picks the narrow or the wide kernel by the shape, and the case carries
    that kernel's name; with `both` (a shape both take) the wide kernel
    runs too: in float32 its results must equal the narrow kernel's bit
    for bit, in float64 (tensor cores, their own order of the products of
    an instruction) they are held to the plain version within the
    tolerance.  The wide cases skip the host-cost loops: they are not
    launch-bound."""
    ne, q, k, c = shape
    P = torch.tensor(rng.standard_normal(shape), dtype=dtype, device=dev)
    F2 = rng.standard_normal((ne * q, k, k))
    F2 = torch.tensor(F2 + F2.transpose(0, 2, 1), dtype=dtype, device=dev)
    F2[:, 0, 1] += 0.5  # not symmetric, so the two block orders differ
    F2t = F2.transpose(1, 2).contiguous().transpose(1, 2)  # (l, j) in memory
    w = torch.tensor(rng.uniform(0.1, 2.0, ne * q), dtype=dtype, device=dev)
    W = (F2 * w[:, None, None]).reshape(ne, q, k, k)
    plan = ck.HePlan(P, w)
    name = "he_assemble" if plan.kernel == "narrow" else "he_assemble_wide"
    wide = ck.HePlan(P, w, kernel="wide") if both else None
    f64 = dtype == torch.float64
    out_bytes = ne * c * c * P.element_size()
    flops = 2 * ne * q * k * c * (k + c)
    given = Case(
        name, shape,
        lambda: ck.he_assemble(P, W), lambda: ck.he_assemble_plain(P, W),
        lambda: torch.einsum("eqjc,eqjl,eqld->ecd", P, W, P),
        nbytes(P, W) + out_bytes, flops, dtype, planned=lambda: plan(W),
        exact={"the wide kernel": lambda: wide(W)} if both and not f64 else None,
        close={"the wide kernel": lambda: wide(W)} if both and f64 else None,
        host=plan.kernel == "narrow",
    )
    wide_w = {"the wide kernel": lambda: wide.weighted(F2),
              "the wide kernel, F2 with transposed blocks": lambda: wide.weighted(F2t)}
    weighted = Case(
        name, f"{shape} weighted",
        lambda: ck.he_assemble_weighted(P, F2, w),
        lambda: ck.he_assemble_weighted_plain(P, F2, w),
        lambda: torch.einsum("eqjc,eqjl,eqld->ecd", P,
                             (F2 * w[:, None, None]).reshape(ne, q, k, k), P),
        nbytes(P, F2, w) + out_bytes, flops + ne * q * k * k, dtype,
        planned=lambda: plan.weighted(F2),
        exact={"he_assemble on the product F2 * w": lambda: ck.he_assemble(P, W),
               "F2 with transposed blocks": lambda: plan.weighted(F2t),
               **(wide_w if both and not f64 else {})},
        close=wide_w if both and f64 else None,
        extra={"F2 * w, contiguous, then he_assemble (three launches)": lambda: plan(
            (F2t * w[:, None, None]).reshape(ne, q, k, k).contiguous())},
        host=plan.kernel == "narrow",
    )
    return [weighted, given]


def matvec_case(basis, dtype, dev, rng):
    m, C = basis.m, 2 * basis.nl
    He = torch.tensor(rng.standard_normal((basis.nelem, C, C)), dtype=dtype, device=dev)
    vp = torch.tensor(rng.standard_normal((2, m + 1)), dtype=dtype, device=dev)
    return Case(
        "element_matvec", (basis.nelem, C, m),
        lambda: ck.element_matvec(He, basis.idx, vp),
        lambda: ck.element_matvec_plain(He, basis.idx, vp), None,
        nbytes(He, basis.idx, vp) + basis.nelem * C * He.element_size(),
        2 * basis.nelem * C * C, dtype,
    )


def hvp_case(level, basis, dtype, dev, rng):
    """The fused hvp on one level: against its plain version within the
    tolerance, and exactly against kernel B followed by kernel C.  Bytes:
    He, idx, the table, v and the result, each once."""
    m, nl, tbl = basis.m, basis.nl, basis.scatter_idx
    C = 2 * nl
    He = torch.tensor(rng.standard_normal((basis.nelem, C, C)), dtype=dtype, device=dev)
    vp = torch.tensor(rng.standard_normal((2, m + 1)), dtype=dtype, device=dev)
    vp[:, m] = 0.0
    plan = basis.table_plan
    n_rows = 2 * int((tbl < basis.nelem * nl).sum())  # He rows the sum reads

    def two_launches():
        return ck.table_sum(ck.element_matvec(He, basis.idx, vp), tbl, m).T

    return Case(
        "hvp", f"level {level}: ({basis.nelem},{C},{C}), m={m}, table width {tbl.shape[1]}",
        lambda: ck.hvp(He, basis.idx, tbl, vp, m),
        lambda: ck.hvp_plain(He, basis.idx, tbl, vp, m), None,
        nbytes(He, basis.idx, tbl, vp) + 2 * (m + 1) * He.element_size(),
        n_rows * (2 * C + 1), dtype, planned=lambda: plan.hvp(He, vp),
        exact={"B then C": two_launches},
        extra={"B then C (two launches)": two_launches},
    )


def table_cases(basis, dtype, dev, rng):
    """Kernel C's table_sum on one level in both layouts: (rows, 2) ->
    (m+1, 2), and element-major (nelem, 2*nl) -> field-major (2, m+1).  The
    library yardstick of both is index_add_ by each source row's node."""
    m, nl, tbl = basis.m, basis.nl, basis.scatter_idx
    rows = basis.nelem * nl
    em = torch.tensor(rng.standard_normal((basis.nelem, 2 * nl)), dtype=dtype, device=dev)
    src = em.reshape(basis.nelem, 2, nl).permute(0, 2, 1).reshape(rows, 2).contiguous()
    node = basis.idx.reshape(-1).long()  # node of each source row; pad = m
    n_add = int((tbl < rows).sum())
    plan = basis.table_plan
    args = (nbytes(src, tbl) + (m + 1) * 2 * src.element_size(), n_add * 2, dtype)
    library = lambda: src.new_zeros((m + 1, 2)).index_add_(0, node, src)  # noqa: E731
    return [
        Case("table_sum", (m + 1, tbl.shape[1]),
             lambda: ck.table_sum(src, tbl, m), lambda: ck.table_sum_plain(src, tbl, m),
             library, *args, planned=lambda: plan(src)),
        Case("table_sum", f"{(m + 1, tbl.shape[1])} element-major in, field-major out",
             lambda: ck.table_sum_em(em, tbl, m, nl),
             lambda: ck.table_sum_em_plain(em, tbl, m, nl), library, *args,
             planned=lambda: plan.em(em),
             exact={"transpose of table_sum": lambda: ck.table_sum(src, tbl, m).T},
             extra={"permute copy, table_sum, transposed view (two launches)": lambda: plan(
                 em.reshape(basis.nelem, 2, nl).permute(0, 2, 1).reshape(rows, 2).contiguous()).T}),
    ]


def segment_case(label, src, lst, off):
    """kernel C's CSR entry.  Library yardsticks: one sparse product, the
    CSR matrix of ones (off, lst) times src; and, as the text line's extra,
    the two calls index_select then index_add_ by each entry's destination
    (atomics, so not what the port could use).  Bytes count each distinct
    source entry once."""
    dev = src.device
    cnt = (off[1:] - off[:-1]).long()
    nseg = cnt.numel()
    dst = torch.repeat_interleave(torch.arange(nseg, device=dev), cnt)
    pos = lst.long() if lst is not None else torch.arange(src.shape[0], device=dev)
    csr = torch.sparse_csr_tensor(
        off, lst if lst is not None else torch.arange(src.shape[0], dtype=torch.int32, device=dev),
        torch.ones(pos.numel(), dtype=src.dtype, device=dev), size=(nseg, src.shape[0]))
    plan = ck.SegmentPlan(lst, off, src.shape[0])
    row = src[0].numel() * src.element_size()
    return Case(
        "segment_sum", label,
        lambda: ck.segment_sum(src, lst, off), lambda: ck.segment_sum_plain(src, lst, off),
        lambda: csr @ src,
        int(torch.unique(pos).numel()) * row + nbytes(off) + (nbytes(lst) if lst is not None else 0)
        + nseg * row,
        int(cnt.sum()) * src[0].numel(), src.dtype,
        planned=lambda: plan(src),
        extra={"index_select+index_add_ (two calls)": lambda: src.new_zeros(
            (nseg,) + tuple(src.shape[1:])).index_add_(0, dst, torch.index_select(src, 0, pos))},
    )


def segment_add_case(label, bg, upd, lst, off, ids):
    """kernel C's in-place entry at a forward-sweep shape; the library call
    is index_add_ of the listed update entries by their destination dof
    (entries and destinations gathered beforehand, so it is one call)."""
    plan = ck.SegmentPlan(lst, off, upd.shape[0], ids=ids, ndst=bg.shape[0])
    work = bg.clone()
    cnt = (off[1:] - off[:-1]).long()
    dst_of_entry = torch.repeat_interleave(ids.long(), cnt)
    entries = upd[lst.long()]
    return Case(
        "segment_add_", label,
        lambda: ck.segment_add_(bg.clone(), upd, lst, off, ids),
        lambda: ck.segment_add_plain(bg.clone(), upd, lst, off, ids),
        lambda: work.index_add_(0, dst_of_entry, entries),
        lst.numel() * upd.element_size() + nbytes(lst, off, ids) + 2 * ids.numel() * bg.element_size(),
        lst.numel() + ids.numel(), bg.dtype,
        planned=lambda: plan.add_(bg.clone(), upd),
        timed=lambda: ck.segment_add_(work, upd, lst, off, ids),
        timed_planned=lambda: plan.add_(work, upd),
    )


def gather_case(label, v, idx):
    """kernel D's row_gather; bytes count each distinct source row once."""
    idx_l = idx.long().reshape(-1).clamp(0, v.shape[0] - 1)
    row = v[0].numel() * v.element_size()
    plan = ck.GatherPlan(idx, v.shape[0])
    return Case(
        "row_gather", label,
        lambda: ck.row_gather(v, idx), lambda: ck.row_gather_plain(v, idx),
        lambda: torch.index_select(v, 0, idx_l).reshape(tuple(idx.shape) + tuple(v.shape[1:])),
        int(torch.unique(idx_l).numel()) * row + nbytes(idx) + idx.numel() * row,
        0, v.dtype, planned=lambda: plan(v),
    )


def along_case(label, v, idx):
    idx_l = idx.long().clamp(0, v.shape[0] - 1)
    lanes = v.shape[1]
    touched = torch.unique(idx_l * lanes + torch.arange(lanes, device=v.device)).numel()
    return Case(
        "take_along_rows", label,
        lambda: ck.take_along_rows(v, idx), lambda: ck.take_along_rows_plain(v, idx),
        lambda: torch.gather(v, 0, idx_l),
        int(touched) * v.element_size() + nbytes(idx) + idx.numel() * v.element_size(),
        0, v.dtype,
    )


def nd_fine_symbolic(geometry):
    basis = geometry.bases["dirichlet"][-1]
    idx = basis.idx.cpu().numpy()
    t0 = time.perf_counter()
    sym = NDSymbolic(idx, basis.m, 2, node_coords(idx, basis.m, geometry.x.cpu().numpy(), basis.nq))
    return sym, time.perf_counter() - t0


def kernel_cases(g6, g7, sym7, g3d, dtype, rng):
    """Every kernel at the shapes the main paths give it; the first case of
    each kernel in float64 is the one the JSON line reports."""
    dev = g7.x.device
    f7 = g7.bases["dirichlet"][-1]
    d4 = g7.bases["dirichlet"][4]  # L=7's largest dense level (nf*m = 1922)
    f6 = g6.bases["dirichlet"][-1]
    nl = f7.nl
    cases = [
        *he_cases((f7.nelem, f7.nq, 4, 2 * nl), dtype, dev, rng, both=True),
        *he_cases((f6.nelem, f6.nq, 4, 2 * nl), dtype, dev, rng),
        *he_cases((8, 7, 4, 12), dtype, dev, rng),
        *he_cases((16, 4, 3, 6), dtype, dev, rng),
        *he_cases((64, 8, 5, 16), dtype, dev, rng, both=True),
        # the wide kernel: the 3D problem at L=3 (first: the main-path shape)
        # and L=4, parabolic_solve on it and its phase 1, Q2 hexahedra
        *he_cases((64, 64, 5, 128), dtype, dev, rng),
        *he_cases((512, 64, 5, 128), dtype, dev, rng),
        *he_cases((64, 64, 6, 192), dtype, dev, rng),
        *he_cases((8, 64, 7, 256), dtype, dev, rng),
        *he_cases((8, 27, 5, 54), dtype, dev, rng),
        matvec_case(d4, dtype, dev, rng),
        matvec_case(f6, dtype, dev, rng),
        # the fused hvp: L=7's largest dense level first (what an L=7 solve
        # launches most), then every other level of L=7
        *(hvp_case(lvl, g7.bases["dirichlet"][lvl], dtype, dev, rng)
          for lvl in (4, 6, 5, 3, 2, 1, 0)),
        # and at every level of fem3d L=3 k=3 (nl = 64, 27, 8), fine level first
        *(hvp_case(f"fem3d {lvl}", g3d.bases["dirichlet"][lvl], dtype, dev, rng)
          for lvl in (2, 1, 0)),
        *table_cases(f7, dtype, dev, rng),
        *table_cases(g6.bases["dirichlet"][2], dtype, dev, rng),
    ]
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
    rnd = lambda *shape: torch.tensor(rng.standard_normal(shape), dtype=dtype, device=dev)  # noqa: E731
    # the largest front group's assembly at L=7: one segment sum that reads
    # [vals | sb_flat | 1.0] through the group's source list
    big = max(range(sym7.ngroups), key=lambda d: len(sym7.asm_src[d]))
    nsrc = sym7.nvals + int(sym7.sb_off[-1]) + 1
    buf = rnd(nsrc)
    asm_src, asm_off = i32(sym7.asm_src[big]), i32(sym7.asm_off[big])
    cases.append(segment_case(f"L7 fused front assembly, group {big}", buf, asm_src, asm_off))
    # He -> vals at the L=7 fine level; the pad-node slots are long runs of
    # zeros, as kernel A leaves them
    pat = HostPattern(f7.idx.cpu().numpy(), f7.m, 2)
    He = rnd(pat.full_ids.size)
    seg_src, seg_off = i32(pat.seg_src), i32(pat.seg_off)
    long_runs = torch.nonzero(seg_off[1:] - seg_off[:-1] > 64)[:, 0].tolist()
    for a in long_runs:
        He[seg_src[int(seg_off[a]):int(seg_off[a + 1])].long()] = 0.0
    cases.append(segment_case(f"L7 He->vals ({len(long_runs)} long runs)", He, seg_src, seg_off))
    # the L=7 pair matvec's node sum (no list, two fields)
    cases.append(segment_case("L7 pair matvec", rnd(len(sym7.pair_j), 2), None, i32(sym7.pair_off)))
    # long runs beside short ones: zeros stay 0, NaN stays NaN
    counts = np.concatenate([rng.integers(0, 6, 4000), [64, 65, 257, 2574, 700, 300]])
    l_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    l_lst = rng.permutation(int(l_off[-1])).astype(np.int32)
    l_src = rnd(int(l_off[-1]))
    at = lambda a, b: torch.as_tensor(l_lst[l_off[a]:l_off[b]].astype(np.int64), device=dev)  # noqa: E731
    l_src[at(4003, 4004)] = 0.0
    l_src[at(4004, 4005)[5]] = float("nan")
    l_src[at(4005, 4006)] = 0.0
    case = segment_case("long runs with NaN and zeros", l_src, i32(l_lst), i32(l_off))
    case.expect = {4003: 0.0, 4004: float("nan"), 4005: 0.0}
    cases.append(case)
    # the forward sweep's in-place boundary update of its largest group
    fwd = max(range(sym7.ngroups), key=lambda d: len(sym7.bdw_src[d]))
    w = sym7.bd_gids_w[fwd].reshape(-1)
    cases.append(segment_add_case(
        f"L7 forward sweep, group {fwd}", rnd(sym7.N + 2), rnd(w.size), i32(sym7.bdw_src[fwd]),
        i32(sym7.bdw_off[fwd]), i32(sym7.bdw_ids[fwd])))
    sweep = max(range(sym7.ngroups), key=lambda d: sym7.sep_gids[d].size)
    cases += [
        gather_case(f"L7 sweep, group {sweep}", rnd(sym7.N + 2), i32(sym7.sep_gids[sweep])),
        gather_case("L7 pair matvec", rnd(sym7.m, 2), i32(sym7.pair_j)),
        gather_case("L7 pair blocks from vals", rnd(sym7.nvals), i32(sym7.pair_vidx)),
        gather_case(f"L7 front-assembly sources, group {big} (the main path of the "
                    "two-launch assembly; now read inside segment_sum)", buf, asm_src),
    ]
    v = torch.tensor(rng.standard_normal((16130, 128)), dtype=dtype, device=dev)
    idx = rng.integers(0, 16130, 49152).astype(np.int32)
    cases.append(gather_case("probe (16130,128)[49152]", v, i32(idx)))
    odd = rnd(16130 * 127 + 1)
    cases.append(gather_case("odd lanes (16130,127)[49152], element loop",
                             odd[:-1].reshape(16130, 127), i32(idx)))
    cases.append(gather_case("unaligned base (16130,127)[49152], element loop",
                             odd[1:].reshape(16130, 127), i32(idx)))
    cases.append(along_case("probe (16130,128)[49152] broadcast", v,
                            i32(np.broadcast_to(idx[:, None], (49152, 128)))))
    stray = rng.integers(-4, 16134, (4096, 128))
    cases.append(along_case("probe rows, stray indices", v, i32(stray)))
    cases.append(gather_case("probe rows, stray indices", v, i32(stray[:, 0])))
    return cases


def same(out, ref, tol, expect):
    """(ok, max abs err, rel err) of out against ref: equal shapes, NaN
    exactly where ref has NaN, other entries finite and within tol of ref
    relative to max|ref|; and the rows of `expect` hold their values."""
    if out.shape != ref.shape:
        return False, float("inf"), float("inf")
    if not out.numel():
        return True, 0.0, 0.0
    nan = ref.isnan()
    o, r = out.masked_fill(nan, 0.0), ref.masked_fill(nan, 0.0)
    err = float((o - r).abs().max())
    rel = err / max(float(r.abs().max()), 1e-300)
    ok = bool((out.isnan() == nan).all()) and bool(torch.isfinite(o).all()) and rel <= tol
    for row, val in expect.items():
        got = out[row]
        ok = ok and bool(got.isnan().all() if val != val else (got == val).all())
    return ok, err, rel


def check_kernels(g6, g7, sym7, g3d):
    """Phase 2: every kernel against its plain version; returns the JSON
    fields of each kernel's first float64 case."""
    results = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        for case in kernel_cases(g6, g7, sym7, g3d, dtype, np.random.default_rng(0)):
            ref = case.plain()
            tol = 0.0 if case.name in EXACT else TOL[dname]
            ok, err, rel = same(case.kernel(), ref, tol, case.expect)
            if case.planned:
                ok = ok and same(case.planned(), ref, tol, case.expect)[0]
            wrong = [label for label, fn in case.exact.items()
                     if not same(fn(), case.kernel(), 0.0, {})[0]]
            wrong += [label for label, fn in case.close.items()
                      if not same(fn(), ref, tol, case.expect)[0]]
            ok = ok and not wrong
            torch.cuda.synchronize()
            ms = median_ms(case.timed)
            plain_ms = median_ms(case.plain)
            library_ms = median_ms(case.library) if case.library else None
            bound_ms, bound_by = case.bound()
            lib = f"{library_ms:.4f}" if library_ms is not None else "none"
            line = (
                f"kernel {case.name} [{case.shape}] {dname}: max_abs_err={err:.3e} "
                f"rel={rel:.3e} (tol {tol:g}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={lib} bound_ms={bound_ms:.4f} ({bound_by})"
            )
            fields = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms)
            if case.planned and not case.host:
                fields.update(planned_ms=median_ms(case.timed_planned))
                line += f" planned_ms={fields['planned_ms']:.4f}"
            elif case.planned:
                fields.update(
                    planned_ms=median_ms(case.timed_planned), host_us=host_us(case.timed),
                    planned_host_us=host_us(case.timed_planned),
                    library_host_us=host_us(case.library) if case.library else None,
                )
                line += (f" planned_ms={fields['planned_ms']:.4f} host_us={fields['host_us']:.2f} "
                         f"planned_host_us={fields['planned_host_us']:.2f}")
                if case.library:
                    line += f" library_host_us={fields['library_host_us']:.2f}"
            for label, fn in case.extra.items():
                line += f" [{label}: ms={median_ms(fn):.4f}"
                line += f" host_us={host_us(fn):.2f}]" if case.host else "]"
            if case.exact:
                line += f" exact: {', '.join(case.exact)}"
            if case.close:
                line += f" within tol of plain: {', '.join(case.close)}"
            print(line + (" ok" if ok else " FAIL"), flush=True)
            if not ok:
                raise RuntimeError(
                    f"{case.name} {case.shape} {dname}: kernel disagrees with plain"
                    + (f"; entries or kernels that differ: {wrong}" if wrong else ""))
            if dtype == torch.float64 and case.name not in results:
                results[case.name] = fields
    return results


def check_capture(sym7, dtype=torch.float64):
    """Capture readiness of kernels C and D: the fused assembly of the
    largest L=7 front group, a sweep gather and the forward sweep's in-place
    update, through their plans, are recorded into one CUDA graph and
    replayed twice on refilled inputs; each replay must equal the eager
    wrappers bit for bit."""
    dev = torch.device("cuda")
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
    big = max(range(sym7.ngroups), key=lambda d: len(sym7.asm_src[d]))
    fwd = max(range(sym7.ngroups), key=lambda d: len(sym7.bdw_src[d]))
    nsrc = sym7.nvals + int(sym7.sb_off[-1]) + 1
    n_upd = sym7.bd_gids_w[fwd].size
    asm = (i32(sym7.asm_src[big]), i32(sym7.asm_off[big]))
    bdw = (i32(sym7.bdw_src[fwd]), i32(sym7.bdw_off[fwd]), i32(sym7.bdw_ids[fwd]))
    gids = i32(sym7.sep_gids[fwd])
    asm_plan = ck.SegmentPlan(*asm, nsrc)
    bdw_plan = ck.SegmentPlan(bdw[0], bdw[1], n_upd, ids=bdw[2], ndst=sym7.N + 2)
    gat_plan = ck.GatherPlan(gids, sym7.N + 2)
    rng = np.random.default_rng(7)
    fill = lambda n: torch.tensor(rng.standard_normal(n), dtype=dtype, device=dev)  # noqa: E731
    src, bg, upd = fill(nsrc), fill(sym7.N + 2), fill(n_upd)
    asm_plan(src), gat_plan(bg), bdw_plan.add_(bg.clone(), upd)  # warm-up outside the capture
    torch.cuda.synchronize()
    before = dict(ck.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fronts = asm_plan(src)
        rhs = gat_plan(bg)
        bdw_plan.add_(bg, upd)
    recorded = {k: ck.LAUNCHES[k] - before[k] for k in ("segment_sum", "row_gather", "segment_add_")}
    if recorded != {"segment_sum": 1, "row_gather": 1, "segment_add_": 1}:
        raise RuntimeError(f"capture: recorded launches {recorded}")
    for replay in (1, 2):
        src_new, bg_new, upd_new = fill(nsrc), fill(sym7.N + 2), fill(n_upd)
        src.copy_(src_new), bg.copy_(bg_new), upd.copy_(upd_new)
        graph.replay()
        torch.cuda.synchronize()
        want = (ck.segment_sum(src_new, *asm), ck.row_gather(bg_new, gids),
                ck.segment_add_(bg_new.clone(), upd_new, *bdw))
        if not all(torch.equal(a, b) for a, b in zip((fronts, rhs, bg), want)):
            raise RuntimeError(f"capture: replay {replay} differs from the eager launches")
    print(f"capture: fused assembly of group {big} ({asm[0].numel()} sources -> "
          f"{asm[1].numel() - 1} front entries), sweep gather and in-place update of group "
          f"{fwd} ({bdw[2].numel()} dofs) recorded into one CUDA graph; 2 replays on refilled "
          "inputs equal the eager launches bit for bit", flush=True)


def check_capture_step(g7, dtype=torch.float64):
    """Capture readiness of the Newton step's planned launches at the L=7
    fine level: one weighted he_assemble (HePlan), one element-major table
    sum (TablePlan) and one fused hvp on the element Hessians just
    assembled are recorded into one CUDA graph and replayed twice on
    refilled inputs; each replay must equal the eager wrappers bit for
    bit."""
    dev = torch.device("cuda")
    basis = g7.bases["dirichlet"][-1]
    nelem, nl, nq, m = basis.nelem, basis.nl, basis.nq, basis.m
    rng = np.random.default_rng(8)
    fill = lambda *shape: torch.tensor(rng.standard_normal(shape), dtype=dtype, device=dev)  # noqa: E731
    P, w = fill(nelem, nq, 4, 2 * nl), fill(nelem * nq).abs()
    he, tab = ck.HePlan(P, w), basis.table_plan
    F2, gf, vp = fill(nelem * nq, 4, 4), fill(nelem, 2 * nl), fill(2, m + 1)
    tab.hvp(he.weighted(F2), vp), tab.em(gf)  # warm-up outside the capture
    torch.cuda.synchronize()
    before = dict(ck.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_he = he.weighted(F2)
        g_gv = tab.em(gf)
        g_hv = tab.hvp(g_he, vp)
    recorded = {k: ck.LAUNCHES[k] - before[k] for k in ("he_assemble", "table_sum", "hvp")}
    if recorded != {"he_assemble": 1, "table_sum": 1, "hvp": 1}:
        raise RuntimeError(f"capture: recorded launches {recorded}")
    for replay in (1, 2):
        fresh = fill(nelem * nq, 4, 4), fill(nelem, 2 * nl), fill(2, m + 1)
        for t, new in zip((F2, gf, vp), fresh):
            t.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        want_he = ck.he_assemble_weighted(P, fresh[0], w)
        want = (want_he, ck.table_sum_em(fresh[1], basis.scatter_idx, m, nl),
                ck.hvp(want_he, basis.idx, basis.scatter_idx, fresh[2], m))
        if not all(torch.equal(a, b) for a, b in zip((g_he, g_gv, g_hv), want)):
            raise RuntimeError(f"capture: replay {replay} of the step's launches differs "
                               "from the eager launches")
    print(f"capture: weighted he_assemble ({nelem} elements), element-major table sum and "
          f"fused hvp (m={m}) of the L=7 fine level recorded into one CUDA graph; 2 replays "
          "on refilled inputs equal the eager launches bit for bit", flush=True)


def solve(geometry, label, **kw):
    """One amgb solve (p=1.0 unless kw says otherwise) with the launch
    counters reset just before it; returns (sol, c_dot_Dz, wall seconds,
    launches)."""
    kw.setdefault("p", 1.0)
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    sol = mt.amgb(geometry, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    if not (sol.z.shape == (geometry.n, 2) and bool(torch.isfinite(sol.z).all())):
        raise RuntimeError(f"{label}: solution is not finite of shape ({geometry.n}, 2)")
    return sol, float(sol.SOL_main.c_dot_Dz[-1]), wall, launches


def rel_to(label, c, ref, tol):
    """|c - ref| / |ref|, which must not exceed tol."""
    rel = abs(c - ref) / abs(ref)
    if not rel <= tol:
        raise RuntimeError(f"{label}: c_dot_Dz={c!r} is {rel:.3e} rel from {ref!r} (tol {tol:g})")
    return rel


def check_pin(label, c, L):
    return rel_to(label, c, C_EXACT[L], 5e-7)


def check_launches(label, launches, path):
    """Every kernel of the path launched; kernel B, which the fused hvp
    absorbed, did not; and of kernel A's two forms only the path's."""
    missing = [k for k in path if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"{label}: kernels {missing} never launched: {launches}")
    if launches["element_matvec"]:
        raise RuntimeError(f"{label}: element_matvec launched on the main path: {launches}")
    other = "he_assemble" if "he_assemble_wide" in path else "he_assemble_wide"
    if other not in path and launches[other]:
        raise RuntimeError(f"{label}: {other} launched on a path of the other kernel A: {launches}")


def nd_levels(geometry):
    """{level: symbolic-build seconds} of the levels that took the
    nested-dissection route, over the geometry's solver contexts."""
    return {lvl: round(nd.symbolic_s, 3) for ctx in geometry.ctx_cache.values()
            for lvl, nd in sorted(ctx.nd.items())}


def check_cone(label, sol):
    """||grad u|| <= s + 1e-5 at every quadrature point (the check of
    tests/test_fem3d.py); returns the largest violation."""
    g, z = sol.geometry, sol.z
    du = torch.stack([g.operators[d].matvec(z[:, 0]) for d in ("dx", "dy", "dz")], dim=1)
    worst = float((torch.linalg.norm(du, dim=1) - z[:, 1]).max())
    if not worst <= 1e-5:
        raise RuntimeError(f"{label}: ||grad u|| - s reaches {worst:.3e} > 1e-5")
    return worst


def phase_fem3d():
    """Phases 7 and 8: the 3D family.  Returns the launches of the first
    default-backend L=3 run."""
    t0 = time.perf_counter()
    g3 = mt.fem3d(L=3, k=3)
    fine = g3.bases["dirichlet"][-1]
    print(f"fem3d L=3 k=3 geometry: {g3.discretization.nelem} hexahedra, n={g3.n}, "
          f"m={[b.m for b in g3.bases['dirichlet']]}, nl={[b.nl for b in g3.bases['dirichlet']]}, "
          f"fine table width {fine.scatter_idx.shape[1]} in {time.perf_counter() - t0:.2f}s",
          flush=True)
    runs, first = [], None
    for i in range(2):
        torch.cuda.reset_peak_memory_stats()
        sol, c, wall, launches = solve(g3, f"fem3d L=3 k=3 run {i + 1}")
        worst = check_cone(f"fem3d L=3 k=3 run {i + 1}", sol)
        print(f"solve fem3d L=3 k=3 default run {i + 1}: c_dot_Dz={c!r} "
              f"its={sol.SOL_main.its.tolist()} wall_s={wall:.3f} nd_levels={nd_levels(g3)} "
              f"max(|grad u| - s)={worst:.3e} "
              f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f} launches={launches}"
              + beside_previous("fem3d L=3 k=3", c, sol.SOL_main.its.tolist()), flush=True)
        check_launches(f"fem3d L=3 k=3 run {i + 1}", launches, WIDE_ND_PATH)
        if sorted(nd_levels(g3)) != [2]:
            raise RuntimeError(f"fem3d L=3 k=3: nested dissection on levels {nd_levels(g3)}, "
                               "expected the fine level only")
        runs.append((sol.SOL_main.its.tolist(), c))
        first = first or launches
    if runs[0] != runs[1]:
        raise RuntimeError(f"fem3d L=3 k=3: the two runs differ: {runs}")
    print("fem3d L=3 k=3 default: the two runs repeat bit for bit (its and c_dot_Dz)", flush=True)
    # the same problem with a dense Cholesky on every level (2,664 unknowns)
    g3d = mt.fem3d(L=3, k=3, backend=mt.backend_cuda(dense_threshold=1 << 30))
    sol, c_dense, wall, launches = solve(g3d, "fem3d L=3 k=3 dense")
    rel = rel_to("fem3d L=3 k=3 default against dense_threshold=1<<30", runs[0][1], c_dense, 1e-5)
    print(f"solve fem3d L=3 k=3 dense_threshold=1<<30: c_dot_Dz={c_dense!r} "
          f"its={sol.SOL_main.its.tolist()} wall_s={wall:.3f} launches={launches}; the default "
          f"(nested-dissection) run is {rel:.3e} rel from it", flush=True)
    check_launches("fem3d L=3 k=3 dense", launches, WIDE_DENSE_PATH)

    # phase 8: L=2 k=3, the fine level (250 unknowns) forced onto nested dissection
    g2 = mt.fem3d(L=2, k=3, backend=mt.backend_cuda(dense_threshold=64))
    sol, c, wall, launches = solve(g2, "fem3d L=2 k=3 forced ND")
    rel = rel_to("fem3d L=2 k=3 forced ND", c, C_FEM3D_L2K3, 1e-5)
    print(f"solve fem3d L=2 k=3 dense_threshold=64: c_dot_Dz={c!r} rel_err={rel:.3e} "
          f"its={sol.SOL_main.its.tolist()} wall_s={wall:.3f} nd_levels={nd_levels(g2)} "
          f"launches={launches}"
          + beside_previous("fem3d L=2 k=3 forced ND", c, sol.SOL_main.its.tolist()), flush=True)
    check_launches("fem3d L=2 k=3 forced ND", launches, WIDE_ND_PATH)
    return first


def phase_obstacle(L=3):
    """Phase 11: the obstacle problem of tests/test_obstacle.py (u above
    0.5 - 2|x|^2, ||grad u||^2 <= s, cost 3u + s) from its infeasible
    start u = |x|^2: phase 1, then phase 2."""
    g = mt.fem2d(L=L)
    dev, dt = g.x.device, g.x.dtype
    A = torch.tensor([[-1.0, 0.0, 0.0, 0.0]], dtype=dt, device=dev)
    cost = torch.tensor([3.0, 0.0, 0.0, 1.0], dtype=dt, device=dev)

    def obstacle(x):
        return 0.5 - 2.0 * (x[..., 0] ** 2 + x[..., 1] ** 2)

    Q = mt.convex_intersect(
        mt.convex_Euclidian_power(idx=(1, 2, 3), p=2.0),
        mt.convex_linear(A=lambda x: A, b=lambda x: (-obstacle(x)).reshape(1)),
    )
    sol, c, wall, launches = solve(
        g, f"obstacle L={L}", D=[("u", "id"), ("u", "dx"), ("u", "dy"), ("s", "id")],
        f=lambda x: cost, g=lambda x: torch.stack([x[0] ** 2 + x[1] ** 2, torch.full_like(x[0], 100.0)]),
        Q=Q, tol=1e-7)
    feas = sol.SOL_feasibility
    gap = sol.z[:, 0] - obstacle(g.x)
    lo = float(gap.min())
    print(f"solve obstacle fem2d L={L} (infeasible start): feasibility its={feas.its.tolist()} "
          f"ts={feas.ts} main its={sol.SOL_main.its.tolist()} c_dot_Dz={c!r} "
          f"min(u - obstacle)={lo:.3e} wall_s={wall:.3f} launches={launches}"
          + beside_previous(f"obstacle L={L}", c, sol.SOL_main.its.tolist()), flush=True)
    if not feas.its.sum() > 0:
        raise RuntimeError(f"obstacle L={L}: the feasibility phase did not run")
    if not -1e-6 < lo < 1e-3:
        raise RuntimeError(f"obstacle L={L}: min(u - obstacle)={lo:.3e}: violated or not active")
    if L == 3:
        rel_to("obstacle L=3 against the JAX package's CPU run", c, C_OBSTACLE_L3, 5e-7)
    check_launches(f"obstacle L={L}", launches, DENSE_PATH)


def phase_parabolic():
    """Phase 9: parabolic_solve on fem3d L=2 and L=3 k=3 and on fem1d L=6.
    At L=2 every hexahedron touches the boundary (C = 81); at L=3 the fine
    level has the interior shape (64, 6, 192) and takes nested dissection."""
    for label, make, path, shape in (
        ("fem3d L=2 k=3", lambda: mt.fem3d(L=2, k=3), WIDE_DENSE_PATH, (64, 6, 81)),
        ("fem3d L=3 k=3", lambda: mt.fem3d(L=3, k=3), WIDE_ND_PATH, (64, 6, 192)),
        ("fem1d L=6", lambda: mt.fem1d(L=6), DENSE_PATH, (2, 4, 6)),
    ):
        g = make()
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        sol = mt.parabolic_solve(g, h=0.5, t1=1.0, p=1.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        ok = sol.ts == [0.0, 0.5, 1.0] and len(sol.u) == 3 and all(
            tuple(u.shape) == (g.n, 3) and bool(torch.isfinite(u).all()) for u in sol.u)
        shapes = sorted({tuple(ctx._P[-1].shape[1:]) for ctx in g.ctx_cache.values()})
        its = [s.SOL_main.its.tolist() for s in sol.sols]
        cs = [float(s.SOL_main.c_dot_Dz[-1]) for s in sol.sols]
        prev = PREVIOUS.get(f"parabolic {label}")
        print(f"parabolic_solve {label} h=0.5 t1=1.0 p=1.0: ts={sol.ts} its={its} c_dot_Dz={cs!r} "
              f"fine (nq, k, C)={shapes} wall_s={wall:.3f} launches={launches}"
              + (f" [previous commit: c_dot_Dz={prev[0]!r} its={prev[1]}; change "
                 f"{max(abs(a - b) / abs(b) for a, b in zip(cs, prev[0])):.3e} rel"
                 f"{', bit for bit' if (cs, its) == prev else ''}]" if prev else ""), flush=True)
        if not ok:
            raise RuntimeError(f"parabolic_solve {label}: ts={sol.ts}, snapshots "
                               f"{[tuple(u.shape) for u in sol.u]} not finite of shape ({g.n}, 3)")
        if shapes != [shape]:
            raise RuntimeError(f"parabolic_solve {label}: fine element shapes {shapes}, "
                               f"expected {shape}")
        check_launches(f"parabolic_solve {label}", launches, path)


def phase_fem1d():
    """Phase 10: fem1d_solve(L=8) at p=1 and p=2."""
    for p in (1.0, 2.0):
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        sol = mt.fem1d_solve(L=8, p=p)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ck.LAUNCHES)
        n = sol.geometry.n
        print(f"solve fem1d L=8 p={p}: c_dot_Dz={sol.SOL_main.c_dot_Dz[-1]!r} "
              f"its={sol.SOL_main.its.tolist()} wall_s={wall:.3f} launches={launches}", flush=True)
        if not (tuple(sol.z.shape) == (n, 2) and bool(torch.isfinite(sol.z).all())
                and sol.SOL_main.t_end >= 1e7):
            raise RuntimeError(f"fem1d L=8 p={p}: not finite of shape ({n}, 2), or the path "
                               "stopped short of t = 1/tol")
        check_launches(f"fem1d L=8 p={p}", launches, DENSE_PATH)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
        flush=True,
    )

    # phase 1: build
    t0 = time.perf_counter()
    so, log = ck.build()
    ck.load()
    print(f"build: {so} in {time.perf_counter() - t0:.2f}s", flush=True)
    for line in log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # phase 2: kernels vs plain at the main-path shapes
    t0 = time.perf_counter()
    g6 = mt.fem2d(L=6)
    g7 = mt.fem2d(L=7)
    print(f"fem2d L=6, L=7 geometries: m={[b.m for b in g7.bases['dirichlet']]} "
          f"in {time.perf_counter() - t0:.2f}s", flush=True)
    sym7, sym_s = nd_fine_symbolic(g7)
    print(f"L=7 fine-level ND symbolic: {sym7.ngroups} groups, N={sym7.N}, "
          f"{sym_s:.2f}s", flush=True)
    f7 = g7.bases["dirichlet"][-1]
    for dtype in (torch.float64, torch.float32):
        cfg = ck.he_assemble_config(dtype, f7.nelem, f7.nq, 4, 2 * f7.nl, weighted=True)
        print(f"he_assemble ({f7.nelem},{f7.nq},4,{2 * f7.nl}) {str(dtype).split('.')[-1]}: "
              f"{cfg['elements_per_cta']} elements per CTA, {cfg['threads']} threads and "
              f"{cfg['smem_bytes']} bytes of shared memory per CTA, {cfg['ctas']} CTAs", flush=True)
    cfg = ck.he_assemble_wide_config(torch.float64, 64, 64, 5, 128)
    m_, n_, k_ = cfg["mma"]
    print(f"he_assemble_wide (64,64,5,128) float64: {cfg['tile']}x{cfg['tile']} He tile per CTA, "
          f"{cfg['threads'] // 32} warps, {cfg['smem_bytes']} bytes of shared memory per CTA, "
          f"{cfg['ctas']} CTAs, MMA m{m_}n{n_}k{k_} float64, {cfg['rows_per_round']} rows "
          f"({cfg['points_per_round']} quadrature points) per round", flush=True)
    dmma = dmma_count(so)
    print(f"he_assemble_wide in {os.path.basename(so)}: {sum(dmma.values())} DMMA instructions "
          f"{dmma}", flush=True)
    if not sum(dmma.values()):
        raise RuntimeError("he_assemble_wide: the built object holds no DMMA instruction")
    t0 = time.perf_counter()
    g3d = mt.fem3d(L=3, k=3)
    print(f"fem3d L=3 k=3 geometry (for the hvp cases): nl="
          f"{[b.nl for b in g3d.bases['dirichlet']]} in {time.perf_counter() - t0:.2f}s", flush=True)
    kernels = check_kernels(g6, g7, sym7, g3d)
    del g3d
    check_capture(sym7)
    check_capture_step(g7)

    # phase 3: L=5, default configuration (every level dense)
    sol, c, wall, launches = solve(mt.fem2d(L=5), "L=5")
    rel = check_pin("L=5", c, 5)
    print(f"solve fem2d L=5 default: c_dot_Dz={c!r} rel_err={rel:.3e} "
          f"its={sol.SOL_main.its.tolist()} wall_s={wall:.3f} launches={launches}"
          + beside_previous("fem2d L=5", c, None), flush=True)
    check_launches("L=5", launches, DENSE_PATH)

    # phase 4: L=6, dense route on every level; warm-up, then the timed run
    g6d = mt.fem2d(L=6, backend=mt.backend_cuda(dense_threshold=1 << 30))
    _, _, wall_warmup, _ = solve(g6d, "L=6 dense")
    torch.cuda.reset_peak_memory_stats()
    sol, c, wall, launches = solve(g6d, "L=6 dense")
    rel = check_pin("L=6 dense", c, 6)
    print(f"solve fem2d L=6 dense_threshold=1<<30: c_dot_Dz={c!r} rel_err={rel:.3e} "
          f"its={sol.SOL_main.its.tolist()} wall_s={wall:.3f} (warm-up {wall_warmup:.3f}) "
          f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f} launches={launches}"
          + beside_previous("fem2d L=6 dense", c, None), flush=True)
    check_launches("L=6 dense", launches, DENSE_PATH)

    # phase 5: L=6 default (nested dissection on the fine level), twice
    runs = []
    for i in range(2):
        torch.cuda.reset_peak_memory_stats()
        sol, c, wall, launches = solve(g6, f"L=6 default run {i + 1}")
        rel = check_pin(f"L=6 default run {i + 1}", c, 6)
        print(f"solve fem2d L=6 default run {i + 1}: c_dot_Dz={c!r} rel_err={rel:.3e} "
              f"its={sol.SOL_main.its.tolist()} wall_s={wall:.3f} nd_levels={nd_levels(g6)} "
              f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f} launches={launches}"
              + beside_previous("fem2d L=6 default", c, None), flush=True)
        check_launches(f"L=6 default run {i + 1}", launches, ND_PATH)
        runs.append((sol.SOL_main.its.tolist(), c))
    if runs[0] != runs[1]:
        raise RuntimeError(f"L=6 default: the two runs differ: {runs}")
    print("L=6 default: the two runs repeat bit for bit (its and c_dot_Dz)", flush=True)

    # phase 6: L=7 default, the reference's headline problem
    torch.cuda.reset_peak_memory_stats()
    sol, c, wall, launches = solve(g7, "L=7")
    lo, hi = FLOOR_BAND_7
    if not lo < c < hi:
        raise RuntimeError(f"L=7: c_dot_Dz={c!r} outside {FLOOR_BAND_7}")
    print(f"solve fem2d L=7 default: c_dot_Dz={c!r} band={FLOOR_BAND_7} "
          f"its={sol.SOL_main.its.tolist()} wall_s={wall:.3f} "
          f"symbolic_s={nd_levels(g7)} "
          f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f} launches={launches}"
          + beside_previous("fem2d L=7", c, None), flush=True)
    check_launches("L=7", launches, ND_PATH)
    del g6, g6d, g7, sym7
    torch.cuda.empty_cache()

    # phases 7-11: the 3D family, the time stepper, 1D, an infeasible start
    launches["he_assemble_wide"] = phase_fem3d()["he_assemble_wide"]
    phase_parabolic()
    phase_fem1d()
    phase_obstacle()

    print(f"card: {card_line()}")
    print(json.dumps({"kernels": [
        dict(
            name=name,
            route="cuda",
            source=f"multigridbarrier_tpu_torch/csrc/{SOURCE[name]}",
            replaces=REPLACES[name],
            launches=launches[name],
            **kernels[name],
        )
        for name in REPLACES
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
