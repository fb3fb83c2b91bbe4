#!/usr/bin/env python3
"""Smoke run of the PyTorch port (multigridbarrier_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, one printed line each (or a few):
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, and
     the nvcc build of the hand-written kernels (csrc/*.cu, sm_90a) into
     build/kernels/, with its time and ptxas resource lines;
  2. each kernel (A he_assemble, B element_matvec, C table_sum) against its
     plain PyTorch version on the card, at the fem2d L=6 main-path shapes
     and small shapes, float64 (max|k-p|/max|p| <= 1e-12) and float32
     (<= 1e-5, TF32 off), with median times of both over 30 runs;
  3. fem2d_solve(L=5, p=1.0) on the default CUDA backend: the final
     c_dot_Dz must be within 5e-7 rel of the exact-direction value
     27.360702531510;
  4. amgb(fem2d(L=6) with dense_threshold=1<<30, p=1.0), a warm-up run and
     a timed run: c_dot_Dz within 5e-7 rel of 15.4183231432; the kernel
     launch counters, reset just before the timed run, must all be > 0.
Then the card line again, a JSON line with the per-kernel results, and
last the JSON status line.  Any failure raises and exits non-zero; with
no CUDA device it exits 1 before printing any result.
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

C_EXACT = {5: 27.360702531510, 6: 15.4183231432}
TOL = {"float64": 1e-12, "float32": 1e-5}
REPLACES = {
    "he_assemble": "multigridbarrier_tpu/runtime/pallas_kernels.py:56",
    "element_matvec": "tools/probe_pallas_gather.py:196",
    "table_sum": "tools/probe_pallas_gather.py:124",
}


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


def check_kernels(geometry):
    """Phase 2: every kernel against its plain version; returns per-kernel
    results at the main-path shape in float64."""
    dev = geometry.x.device
    rng = np.random.default_rng(0)
    fine = geometry.bases["dirichlet"][-1]
    mid = geometry.bases["dirichlet"][2]
    nelem, nq, nl = fine.nelem, fine.nq, fine.nl
    k, C = 4, 2 * nl

    def he_inputs(shape):
        ne, q, kk, cc = shape
        P = rng.standard_normal((ne, q, kk, cc))
        W = rng.standard_normal((ne, q, kk, kk))
        return P, W + W.transpose(0, 1, 3, 2)

    cases = {"he_assemble": [], "element_matvec": [], "table_sum": []}
    for shape in [(nelem, nq, k, C), (8, 7, 4, 12), (16, 4, 3, 6)]:
        cases["he_assemble"].append((shape, he_inputs(shape)))
    for basis in (fine, mid):
        m = basis.m
        He = rng.standard_normal((basis.nelem, C, C))
        vp = rng.standard_normal((2, m + 1))
        flat = rng.standard_normal((basis.nelem * basis.nl, 2))
        cases["element_matvec"].append(((basis.nelem, C, m), (He, basis.idx, vp)))
        cases["table_sum"].append(((m + 1, basis.scatter_idx.shape[1]), (flat, basis.scatter_idx, m)))

    def run(name, args, dtype, plain):
        if name == "he_assemble":
            P, W = (torch.tensor(a, dtype=dtype, device=dev) for a in args)
            return (ck.he_assemble_plain if plain else ck.he_assemble), (P, W)
        if name == "element_matvec":
            He, idx, vp = args
            He, vp = (torch.tensor(a, dtype=dtype, device=dev) for a in (He, vp))
            return (ck.element_matvec_plain if plain else ck.element_matvec), (He, idx, vp)
        flat, tbl, m = args
        flat = torch.tensor(flat, dtype=dtype, device=dev)
        return (ck.table_sum_plain if plain else ck.table_sum), (flat, tbl, m)

    results = {}
    for name, items in cases.items():
        for i, (shape, args) in enumerate(items):
            for dtype in (torch.float64, torch.float32):
                dname = str(dtype).split(".")[-1]
                fk, ak = run(name, args, dtype, plain=False)
                fp, ap = run(name, args, dtype, plain=True)
                out = fk(*ak)
                ref = fp(*ap)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                rel = err / max(float(ref.abs().max()), 1e-300)
                ok = bool(torch.isfinite(out).all()) and rel <= TOL[dname]
                ms = median_ms(lambda: fk(*ak))
                plain_ms = median_ms(lambda: fp(*ap))
                print(
                    f"kernel {name} shape={shape} {dname}: max_abs_err={err:.3e} "
                    f"rel={rel:.3e} (tol {TOL[dname]:g}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
                    f"{'ok' if ok else 'FAIL'}",
                    flush=True,
                )
                if not ok:
                    raise RuntimeError(f"{name} {shape} {dname}: kernel disagrees with plain")
                if i == 0 and dtype == torch.float64:
                    results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return results


def solve(geometry, L):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = mt.amgb(geometry, p=1.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = float(sol.SOL_main.c_dot_Dz[-1])
    rel = abs(c - C_EXACT[L]) / C_EXACT[L]
    if not (sol.z.shape == (geometry.n, 2) and bool(torch.isfinite(sol.z).all())):
        raise RuntimeError(f"L={L}: solution is not finite of shape ({geometry.n}, 2)")
    if rel > 5e-7:
        raise RuntimeError(f"L={L}: c_dot_Dz={c!r} is {rel:.3e} rel from {C_EXACT[L]}")
    return sol, c, rel, wall


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
    g6 = mt.fem2d(L=6, backend=mt.backend_cuda(dense_threshold=1 << 30))
    print(f"fem2d L=6 geometry: n={g6.n} nelem={g6.discretization.nelem} "
          f"m={[b.m for b in g6.bases['dirichlet']]} in {time.perf_counter() - t0:.2f}s")
    kernels = check_kernels(g6)

    # phase 3: L=5, default configuration
    g5 = mt.fem2d(L=5, backend=mt.backend_cuda())
    ck.reset_launch_counts()
    sol5, c5, rel5, wall5 = solve(g5, 5)
    print(
        f"solve fem2d L=5 default: c_dot_Dz={c5!r} rel_err={rel5:.3e} "
        f"its={sol5.SOL_main.its.tolist()} wall_s={wall5:.3f} launches={dict(ck.LAUNCHES)}",
        flush=True,
    )
    if min(ck.LAUNCHES.values()) <= 0:
        raise RuntimeError(f"L=5: a kernel was never launched: {ck.LAUNCHES}")

    # phase 4: L=6, dense route on every level; warm-up, then the timed run
    _, _, _, wall_warmup = solve(g6, 6)
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    sol6, c6, rel6, wall6 = solve(g6, 6)
    launches = dict(ck.LAUNCHES)
    print(
        f"solve fem2d L=6 dense_threshold=1<<30: c_dot_Dz={c6!r} rel_err={rel6:.3e} "
        f"its={sol6.SOL_main.its.tolist()} wall_s={wall6:.3f} (warm-up {wall_warmup:.3f}) "
        f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f} launches={launches}",
        flush=True,
    )
    if min(launches.values()) <= 0:
        raise RuntimeError(f"L=6: a kernel was never launched: {launches}")

    print(f"card: {card_line()}")
    print(json.dumps({"kernels": [
        dict(
            name=name,
            route="cuda",
            source=f"multigridbarrier_tpu_torch/csrc/{name}.cu",
            replaces=REPLACES[name],
            launches=launches[name],
            **kernels[name],
        )
        for name in ("he_assemble", "element_matvec", "table_sum")
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
