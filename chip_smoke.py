#!/usr/bin/env python3
"""Smoke run of the PyTorch port (multigridbarrier_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, one printed line each (or a few):
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, and
     the nvcc build of the hand-written kernels (csrc/*.cu, sm_90a, one
     nvcc per source, all started together) into build/kernels/, with its
     time and ptxas resource lines;
  2. each kernel against its plain PyTorch version on the card, float64
     and float32 (TF32 off), at the main-path shapes of fem2d L=6 and L=7
     (the nested-dissection gathers and sums of the L=7 fine level among
     them) and at small or probe shapes, with median times over 30 runs of
     the kernel, its plain version and, where one exists, the one PyTorch
     call that computes the same function (timed as a yardstick only).
     A he_assemble, B element_matvec and C table_sum agree to
     max|k-p|/max|p| <= 1e-12 (f64) and 1e-5 (f32); C's segment_sum and
     D's row_gather/take_along_rows exactly;
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
     the kernel launches.
In every solve phase the launch counters are reset just before the solve
and each kernel of that route must have launched.  Then the card line
again, a JSON line with the per-kernel results (launches from phase 6),
and last the JSON status line.  Any failure raises and exits non-zero;
with no CUDA device it exits 1 before printing any result.
"""

import json
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
EXACT = ("segment_sum", "row_gather", "take_along_rows")
REPLACES = {
    "he_assemble": "multigridbarrier_tpu/runtime/pallas_kernels.py:56",
    "element_matvec": "tools/probe_pallas_gather.py:196",
    "table_sum": "tools/probe_pallas_gather.py:124",
    "segment_sum": "tools/probe_pallas_gather.py:124",
    "row_gather": "tools/probe_pallas_gather.py:83",
    "take_along_rows": "tools/probe_pallas_gather.py:58",
}
SOURCE = {
    "he_assemble": "he_assemble.cu",
    "element_matvec": "element_matvec.cu",
    "table_sum": "table_sum.cu",
    "segment_sum": "table_sum.cu",
    "row_gather": "row_gather.cu",
    "take_along_rows": "row_gather.cu",
}
DENSE_PATH = ("he_assemble", "element_matvec", "table_sum", "segment_sum")
ND_PATH = DENSE_PATH + ("row_gather",)
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Case:
    """One kernel at one shape: kernel, plain version and library call as
    closures over tensors on the card; bytes and flops for the bound."""

    def __init__(self, name, shape, kernel, plain, library, nbytes_, flops, dtype):
        self.name, self.shape, self.dtype = name, shape, dtype
        self.kernel, self.plain, self.library = kernel, plain, library
        self.bytes, self.flops = nbytes_, flops

    def bound(self):
        t_bytes = self.bytes / HBM_BYTES_PER_S * 1e3
        t_ops = self.flops / PEAK_FLOPS[self.dtype] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def he_case(shape, dtype, dev, rng):
    ne, q, k, c = shape
    P = torch.tensor(rng.standard_normal(shape), dtype=dtype, device=dev)
    W = rng.standard_normal((ne, q, k, k))
    W = torch.tensor(W + W.transpose(0, 1, 3, 2), dtype=dtype, device=dev)
    return Case(
        "he_assemble", shape,
        lambda: ck.he_assemble(P, W), lambda: ck.he_assemble_plain(P, W),
        lambda: torch.einsum("eqjc,eqjl,eqld->ecd", P, W, P),
        nbytes(P, W) + ne * c * c * P.element_size(),
        2 * ne * q * k * c * (k + c), dtype,
    )


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


def table_case(basis, dtype, dev, rng):
    m, tbl = basis.m, basis.scatter_idx
    rows = basis.nelem * basis.nl
    src = torch.tensor(rng.standard_normal((rows, 2)), dtype=dtype, device=dev)
    node = basis.idx.reshape(-1).long()  # node of each source row; pad = m
    n_add = int((tbl < rows).sum())
    return Case(
        "table_sum", (m + 1, tbl.shape[1]),
        lambda: ck.table_sum(src, tbl, m), lambda: ck.table_sum_plain(src, tbl, m),
        lambda: src.new_zeros((m + 1, 2)).index_add_(0, node, src),
        nbytes(src, tbl) + (m + 1) * 2 * src.element_size(), n_add * 2, dtype,
    )


def segment_case(label, src, lst, off, dst):
    """kernel C's CSR entry; the library yardstick is index_add_ of src by
    the destination id dst of each of its entries."""
    cnt = (off[1:] - off[:-1]).long()
    return Case(
        "segment_sum", label,
        lambda: ck.segment_sum(src, lst, off), lambda: ck.segment_sum_plain(src, lst, off),
        lambda: src.new_zeros(cnt.numel()).index_add_(0, dst, src),
        nbytes(src, off) + (nbytes(lst) if lst is not None else 0) + cnt.numel() * src.element_size(),
        int(cnt.sum()), src.dtype,
    )


def gather_case(label, v, idx):
    """kernel D's row_gather; bytes count each distinct source row once."""
    idx_l = idx.long().reshape(-1).clamp(0, v.shape[0] - 1)
    row = v[0].numel() * v.element_size()
    return Case(
        "row_gather", label,
        lambda: ck.row_gather(v, idx), lambda: ck.row_gather_plain(v, idx),
        lambda: torch.index_select(v, 0, idx_l).reshape(tuple(idx.shape) + tuple(v.shape[1:])),
        int(torch.unique(idx_l).numel()) * row + nbytes(idx) + idx.numel() * row,
        0, v.dtype,
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


def kernel_cases(g6, g7, sym7, dtype, rng):
    """Every kernel at the shapes the main paths give it; the first case of
    each kernel in float64 is the one the JSON line reports."""
    dev = g7.x.device
    f7 = g7.bases["dirichlet"][-1]
    d4 = g7.bases["dirichlet"][4]  # L=7's largest dense level (nf*m = 1922)
    f6 = g6.bases["dirichlet"][-1]
    nl = f7.nl
    cases = [
        he_case((f7.nelem, f7.nq, 4, 2 * nl), dtype, dev, rng),
        he_case((8, 7, 4, 12), dtype, dev, rng),
        he_case((16, 4, 3, 6), dtype, dev, rng),
        matvec_case(d4, dtype, dev, rng),
        matvec_case(f6, dtype, dev, rng),
        table_case(f7, dtype, dev, rng),
        table_case(g6.bases["dirichlet"][2], dtype, dev, rng),
    ]
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
    # the largest front group's assembly at L=7: gather then segment sum
    big = max(range(sym7.ngroups), key=lambda d: len(sym7.asm_src[d]))
    nsrc = sym7.nvals + int(sym7.sb_off[-1]) + 1
    buf = torch.tensor(rng.standard_normal(nsrc), dtype=dtype, device=dev)
    asm_src, asm_off = i32(sym7.asm_src[big]), i32(sym7.asm_off[big])
    gathered = ck.row_gather_plain(buf, asm_src)
    cnt = (asm_off[1:] - asm_off[:-1]).long()
    dst = torch.repeat_interleave(torch.arange(cnt.numel(), device=dev), cnt)
    cases.append(segment_case(f"L7 front assembly, group {big}", gathered, None, asm_off, dst))
    # He -> vals at the L=7 fine level (CSR with a source list)
    pat = HostPattern(f7.idx.cpu().numpy(), f7.m, 2)
    He = torch.tensor(rng.standard_normal(pat.full_ids.size), dtype=dtype, device=dev)
    cases.append(segment_case("L7 He->vals", He, i32(pat.seg_src), i32(pat.seg_off),
                              torch.as_tensor(pat.full_ids.reshape(-1), device=dev).long()))
    sweep = max(range(sym7.ngroups), key=lambda d: sym7.sep_gids[d].size)
    cases += [
        gather_case(f"L7 front assembly, group {big}", buf, asm_src),
        gather_case(f"L7 sweep, group {sweep}",
                    torch.tensor(rng.standard_normal(sym7.N + 2), dtype=dtype, device=dev),
                    i32(sym7.sep_gids[sweep])),
        gather_case("L7 pair matvec",
                    torch.tensor(rng.standard_normal((sym7.m, 2)), dtype=dtype, device=dev),
                    i32(sym7.pair_j)),
    ]
    v = torch.tensor(rng.standard_normal((16130, 128)), dtype=dtype, device=dev)
    idx = rng.integers(0, 16130, 49152).astype(np.int32)
    cases.append(gather_case("probe (16130,128)[49152]", v, i32(idx)))
    cases.append(along_case("probe (16130,128)[49152] broadcast", v,
                            i32(np.broadcast_to(idx[:, None], (49152, 128)))))
    stray = rng.integers(-4, 16134, (4096, 128))
    cases.append(along_case("probe rows, stray indices", v, i32(stray)))
    cases.append(gather_case("probe rows, stray indices", v, i32(stray[:, 0])))
    return cases


def check_kernels(g6, g7, sym7):
    """Phase 2: every kernel against its plain version; returns the JSON
    fields of each kernel's first float64 case."""
    results = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        for case in kernel_cases(g6, g7, sym7, dtype, np.random.default_rng(0)):
            out, ref = case.kernel(), case.plain()
            torch.cuda.synchronize()
            err = float((out - ref).abs().max()) if out.numel() else 0.0
            rel = err / max(float(ref.abs().max()), 1e-300) if out.numel() else 0.0
            tol = 0.0 if case.name in EXACT else TOL[dname]
            ok = out.shape == ref.shape and bool(torch.isfinite(out).all()) and rel <= tol
            ms = median_ms(case.kernel)
            plain_ms = median_ms(case.plain)
            library_ms = median_ms(case.library) if case.library else None
            bound_ms, bound_by = case.bound()
            lib = f"{library_ms:.4f}" if library_ms is not None else "none"
            print(
                f"kernel {case.name} [{case.shape}] {dname}: max_abs_err={err:.3e} "
                f"rel={rel:.3e} (tol {tol:g}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={lib} bound_ms={bound_ms:.4f} ({bound_by}) "
                f"{'ok' if ok else 'FAIL'}",
                flush=True,
            )
            if not ok:
                raise RuntimeError(f"{case.name} {case.shape} {dname}: kernel disagrees with plain")
            if dtype == torch.float64 and case.name not in results:
                results[case.name] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=library_ms,
                )
    return results


def solve(geometry, label):
    """One amgb solve with the launch counters reset just before it;
    returns (sol, c_dot_Dz, wall seconds, launches)."""
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    sol = mt.amgb(geometry, p=1.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    if not (sol.z.shape == (geometry.n, 2) and bool(torch.isfinite(sol.z).all())):
        raise RuntimeError(f"{label}: solution is not finite of shape ({geometry.n}, 2)")
    return sol, float(sol.SOL_main.c_dot_Dz[-1]), wall, launches


def check_pin(label, c, L):
    rel = abs(c - C_EXACT[L]) / C_EXACT[L]
    if rel > 5e-7:
        raise RuntimeError(f"{label}: c_dot_Dz={c!r} is {rel:.3e} rel from {C_EXACT[L]}")
    return rel


def check_launches(label, launches, path):
    missing = [k for k in path if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"{label}: kernels {missing} never launched: {launches}")


def nd_levels(geometry):
    (ctx,) = geometry.ctx_cache.values()
    return {lvl: nd.symbolic_s for lvl, nd in sorted(ctx.nd.items())}


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
    kernels = check_kernels(g6, g7, sym7)

    # phase 3: L=5, default configuration (every level dense)
    sol, c, wall, launches = solve(mt.fem2d(L=5), "L=5")
    rel = check_pin("L=5", c, 5)
    print(f"solve fem2d L=5 default: c_dot_Dz={c!r} rel_err={rel:.3e} "
          f"its={sol.SOL_main.its.tolist()} wall_s={wall:.3f} launches={launches}", flush=True)
    check_launches("L=5", launches, DENSE_PATH)

    # phase 4: L=6, dense route on every level; warm-up, then the timed run
    g6d = mt.fem2d(L=6, backend=mt.backend_cuda(dense_threshold=1 << 30))
    _, _, wall_warmup, _ = solve(g6d, "L=6 dense")
    torch.cuda.reset_peak_memory_stats()
    sol, c, wall, launches = solve(g6d, "L=6 dense")
    rel = check_pin("L=6 dense", c, 6)
    print(f"solve fem2d L=6 dense_threshold=1<<30: c_dot_Dz={c!r} rel_err={rel:.3e} "
          f"its={sol.SOL_main.its.tolist()} wall_s={wall:.3f} (warm-up {wall_warmup:.3f}) "
          f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f} launches={launches}",
          flush=True)
    check_launches("L=6 dense", launches, DENSE_PATH)

    # phase 5: L=6 default (nested dissection on the fine level), twice
    runs = []
    for i in range(2):
        torch.cuda.reset_peak_memory_stats()
        sol, c, wall, launches = solve(g6, f"L=6 default run {i + 1}")
        rel = check_pin(f"L=6 default run {i + 1}", c, 6)
        print(f"solve fem2d L=6 default run {i + 1}: c_dot_Dz={c!r} rel_err={rel:.3e} "
              f"its={sol.SOL_main.its.tolist()} wall_s={wall:.3f} nd_levels={nd_levels(g6)} "
              f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f} launches={launches}",
              flush=True)
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
          f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f} launches={launches}",
          flush=True)
    check_launches("L=7", launches, ND_PATH)

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
