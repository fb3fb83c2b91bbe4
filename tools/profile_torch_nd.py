#!/usr/bin/env python3
"""Profile the PyTorch port's nested-dissection fine level on one CUDA GPU.

    python3 tools/profile_torch_nd.py [--root DIR] [--L 7] [--steps 8] [--solve]

Imports multigridbarrier_tpu_torch from the checkout --root (default: the
checkout this script lies in; another checkout, unpacked with `git archive`
into an ignored directory, to hold a parent commit beside a change in one
run).  Builds fem2d(L) on the default backend (the GPU), and runs Newton steps of
the finest level (the nested-dissection route at L >= 6) from the default
start point at t = 0.1, the first barrier parameter of amgb:

  1. one step to build the level's symbolic phase and warm the kernels;
  2. --steps steps timed on the host clock, ending in a synchronize;
  3. the parts of one ND direction on that step's Newton system (factor,
     solve, pair matvec; host wall with a synchronize), each front
     group's fused assembly (one launch of kernel C's segment sum; CUDA
     events) beside its bound, and the host microseconds per call of the
     planned launches of kernels C and D (front assembly, sweep gather,
     in-place sweep update; 5 rounds of 200 calls without a synchronize) beside
     their general wrappers and their library yardsticks;
  4. --steps more steps under torch.profiler (CPU and CUDA activity);
  5. the device time per call of the Newton step's own planned launches
     (kernel A's weighted he_assemble, kernel C's element-major table sum,
     the fused hvp, and kernel B then C for comparison) under
     torch.profiler, at the fine level and at the largest dense level: the
     CUDA-event times of chip_smoke.py include the host's launch cost,
     these do not.  A checkout from before the launch plans HePlan and
     TablePlan runs what its Newton step ran instead: he_assemble on a
     given W, table_sum, and element_matvec + table_sum.

It prints the card line, the seconds per step of (2), the times of (3),
then for (4) the device busy time per step and the idle share of the
profiled wall (1 - summed kernel time / wall; the port runs on one
stream, so kernels do not overlap), the CUDA kernels launched per step
split into the port's own kernels, elementwise kernels, cuBLAS/cuSOLVER
kernels and the rest, the device time by kernel name (top 25, and the
port's own kernels below them) and by the PyTorch operator that launched
it (top 20), and the port's own kernel launches per step (runtime/cuda_kernels.LAUNCHES).  With --solve it first
times one whole fem2d_solve(L) on the same geometry and prints its
c_dot_Dz, its and wall.  Exits 1 without a CUDA device.
"""

import argparse
import importlib
import os
import statistics
import subprocess
import sys
import time

import torch

# the checkout's package, imported in main() once --root is known
mt = ck = amgb_mod = None


def _self_device_us(evt) -> float:
    """Self device time of a key_averages entry in microseconds (the field
    is named self_device_time_total in newer PyTorch, self_cuda_time_total
    in older)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _is_kernel(evt) -> bool:
    dev = getattr(evt, "device_type", None)
    return dev is not None and str(dev).endswith("CUDA")


def _wall_ms(fn, reps=5) -> float:
    """Median host wall of fn() ending in a synchronize (device work and
    launch overhead together), after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _event_ms(fn, reps=10) -> float:
    """Median CUDA-event time of one fn() call, after one warm-up call."""
    fn()
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


def _host_us(fn, calls=200, rounds=5) -> float:
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


LIBRARY_MARKS = ("gemm", "gemv", "trsm", "trsv", "potrf", "getrf", "cublas", "cusolver",
                 "dot_kernel", "trmm", "syrk", "laswp", "cutlass")
PORT_MARKS = ("he_assemble_kernel", "element_matvec_kernel", "hvp_kernel", "table_sum_kernel",
              "segment_sum_kernel", "row_gather_", "take_along_rows_kernel")


def _kind(kernel_name: str) -> str:
    """The launch count's classes: the port's own kernels, cuBLAS/cuSOLVER
    kernels, PyTorch elementwise kernels, the rest (reductions, copies,
    index kernels, fills)."""
    low = kernel_name.lower()
    if any(m in kernel_name for m in PORT_MARKS):
        return "port"
    if any(m in low for m in LIBRARY_MARKS):
        return "cuBLAS/cuSOLVER"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def parts(ctx, level, z, t):
    """The ND direction's parts on this step's Newton system (host wall
    with a synchronize), each front group's fused assembly (one segment sum
    of kernel C) by CUDA events with its bound (bytes over 3.35 TB/s), and
    the host cost per call of the planned C and D launches."""
    nd = ctx.nd[level]
    seen = {}

    def spy(vals, gv):
        seen["vals"], seen["gv"] = vals, gv
        return type(nd).direction(nd, vals, gv)

    nd.direction = spy
    try:
        ctx.step(level, z, t)
    finally:
        del nd.direction
    vals, gv = seen["vals"], seen["gv"]
    fz = nd.fz
    fac = fz.factor(vals)
    b = -gv[:, : nd.m].T.reshape(-1)
    vpair = nd.pair_vidx(vals)
    print("ND direction parts (host wall, median of 5): "
          f"step {_wall_ms(lambda: ctx.step(level, z, t)):.3f} ms, "
          f"direction {_wall_ms(lambda: nd.direction(vals, gv)):.3f} ms, "
          f"factor {_wall_ms(lambda: fz.factor(vals)):.3f} ms, "
          f"solve {_wall_ms(lambda: fz.solve(fac, b)):.3f} ms (4 per direction), "
          f"pair matvec {_wall_ms(lambda: nd.matvec(vpair, b)):.3f} ms (5 per direction)",
          flush=True)

    src = vals.new_zeros(fz._sb[-1] + 1)
    src[: fz.sym.nvals] = vals
    rows = []
    for d, plan in enumerate(fz.asm):
        n_src, n_out = plan.lst.numel(), plan.nseg
        ms = _event_ms(lambda: plan(src))
        bound = (n_src * (4 + 8) + (n_out + 1) * 4 + n_out * 8) / 3.35e12 * 1e3
        rows.append((ms, d, n_out, n_src, bound))
    print(f"front assembly over {len(rows)} groups (one fused segment sum each; CUDA events, "
          f"median of 10): {sum(r[0] for r in rows):.3f} ms, bound {sum(r[4] for r in rows):.4f} ms")
    for ms, d, n_out, n_src, bound in sorted(rows, reverse=True)[:8]:
        print(f"  group {d}: {n_out} front entries, {n_src} sources: {ms:.4f} ms, "
              f"bound {bound:.4f} ms")

    # host cost per call of the planned launches, their wrappers and the
    # library calls that compute the same function
    d = max(range(len(fz.asm)), key=lambda k: fz.asm[k].lst.numel())
    asm = fz.asm[d]
    cnt = (asm.off[1:] - asm.off[:-1]).long()
    dst = torch.repeat_interleave(torch.arange(asm.nseg, device=src.device), cnt)
    lst_l = asm.lst.long()
    f = max(range(len(fz.bdw)), key=lambda k: fz.bdw[k].lst.numel())
    bdw, gat = fz.bdw[f], fz.sep_gather[f]
    bg = torch.cat([b, b.new_zeros(2)])
    upd = torch.randn(bdw.rows, dtype=b.dtype, device=b.device)
    dof = torch.repeat_interleave(bdw.ids.long(), (bdw.off[1:] - bdw.off[:-1]).long())
    entries = upd[bdw.lst.long()]
    gidx_l = gat.idx.long().reshape(-1)
    table = [
        (f"C segment_sum, fused assembly of group {d}", lambda: asm(src),
         lambda: ck.segment_sum(src, asm.lst, asm.off),
         "index_select + index_add_ (two calls)",
         lambda: src.new_zeros(asm.nseg).index_add_(0, dst, torch.index_select(src, 0, lst_l))),
        (f"C segment_add_, forward sweep of group {f}", lambda: bdw.add_(bg, upd),
         lambda: ck.segment_add_(bg, upd, bdw.lst, bdw.off, bdw.ids),
         "index_add_", lambda: bg.index_add_(0, dof, entries)),
        (f"D row_gather, sweep gather of group {f}", lambda: gat(bg),
         lambda: ck.row_gather(bg, gat.idx), "index_select",
         lambda: torch.index_select(bg, 0, gidx_l)),
    ]
    print("host microseconds per call (median of 5 rounds of 200 calls, no synchronize):")
    for label, planned, general, lib_name, lib in table:
        print(f"  {label}: planned {_host_us(planned):.2f}, general wrapper "
              f"{_host_us(general):.2f}, {lib_name} {_host_us(lib):.2f}", flush=True)


def kernel_device_times(ctx, calls=20):
    """Device microseconds per call of the Newton step's own launches, by
    kernel name, from torch.profiler: at the fine level and at the largest
    level on the dense route."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    nf, k = ctx.spec.nfields, ctx.spec.k
    dense = max((lvl for lvl in range(ctx.levels) if lvl not in ctx._nd_route), default=0)
    for level in (ctx.levels - 1, dense):
        basis, P = ctx._bases[level], ctx._P[level]
        nelem, nl, m = basis.nelem, basis.nl, basis.m
        F2 = torch.randn(nelem * basis.nq, k, k, dtype=P.dtype, device=P.device)
        gf = torch.randn(nelem, nf * nl, dtype=P.dtype, device=P.device)
        vp = torch.randn(nf, m + 1, dtype=P.dtype, device=P.device)
        if hasattr(ck, "HePlan"):
            he, tab = ck.HePlan(P, ctx.w), basis.table_plan
            He = he.weighted(F2)
            what = ("he_assemble weighted, table_sum element-major, hvp fused, then "
                    "element_matvec + table_sum")

            def launches():
                he.weighted(F2)
                tab.em(gf)
                tab.hvp(He, vp)
                tab(ck.element_matvec(He, basis.idx, vp))
        else:
            W = (F2 * ctx.w[:, None, None]).reshape(nelem, basis.nq, k, k).contiguous()
            flat = gf.reshape(nelem, nf, nl).permute(0, 2, 1).reshape(-1, nf).contiguous()
            He = ck.he_assemble(P, W)
            what = "he_assemble on a given W, table_sum, then element_matvec + table_sum"

            def launches():
                ck.he_assemble(P, W)
                ck.table_sum(flat, basis.scatter_idx, m)
                ck.table_sum(ck.element_matvec(He, basis.idx, vp), basis.scatter_idx, m)

        launches()
        torch.cuda.synchronize()
        by_kernel = {}
        for _ in range(3):  # a trace can come back without device events: try again
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(calls):
                    launches()
                torch.cuda.synchronize()
            for e in prof.events():
                if _is_kernel(e):
                    us, cnt = by_kernel.get(e.name, (0.0, 0))
                    by_kernel[e.name] = (us + e.time_range.elapsed_us(), cnt + 1)
            if by_kernel:
                break
        print(f"device time per call at level {level} (nelem={nelem}, m={m}, table width "
              f"{basis.scatter_idx.shape[1]}; {what}; {calls} rounds):")
        for name, (us, cnt) in sorted(by_kernel.items()):
            print(f"  {us / cnt:9.3f} us  {cnt:4d} calls  {name[:100]}")
        if not by_kernel:
            print("  not measured: the profiler returned no device events")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--L", type=int, default=7)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--solve", action="store_true")
    args = ap.parse_args()
    global mt, ck, amgb_mod
    sys.path.insert(0, os.path.abspath(args.root))
    mt = importlib.import_module("multigridbarrier_tpu_torch")
    ck = importlib.import_module("multigridbarrier_tpu_torch.runtime.cuda_kernels")
    amgb_mod = importlib.import_module("multigridbarrier_tpu_torch.solver.amgb")
    if not torch.cuda.is_available():
        print("profile_torch_nd: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} package "
          f"{os.path.dirname(mt.__file__)}", flush=True)
    ck.load()

    g = mt.fem2d(L=args.L)
    if args.solve:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = mt.amgb(g, p=1.0)
        torch.cuda.synchronize()
        print(f"solve fem2d L={args.L}: c_dot_Dz={float(sol.SOL_main.c_dot_Dz[-1])!r} "
              f"its={sol.SOL_main.its.tolist()} wall_s={time.perf_counter() - t0:.3f}",
              flush=True)

    # the solver context amgb would build, and its default start point
    spec = amgb_mod._normalize_D(amgb_mod.default_D(2))
    Q = amgb_mod.default_Q(2, 1.0)
    x = g.x
    c = torch.func.vmap(amgb_mod.default_f(2, x.dtype))(x)
    z = torch.func.vmap(amgb_mod.default_g(2, x.dtype))(x)
    ctx = amgb_mod._get_ctx(g, spec, Q.barrier, c)
    level, t = ctx.levels - 1, 0.1
    if level not in ctx._nd_route:
        raise RuntimeError(f"fem2d L={args.L}: the fine level does not take the ND route")

    t0 = time.perf_counter()
    z, *_ = ctx.step(level, z, t)
    torch.cuda.synchronize()
    print(f"first step (symbolic build {ctx.nd[level].symbolic_s:.3f}s included): "
          f"{time.perf_counter() - t0:.3f}s", flush=True)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        z, lam2, alpha, *_ = ctx.step(level, z, t)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / args.steps
    print(f"unprofiled: {per_step * 1e3:.3f} ms per step over {args.steps} steps "
          f"(last lam2={lam2:.3e} alpha={alpha:.3e})", flush=True)
    parts(ctx, level, z, t)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ck.reset_launch_counts()
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            z, *_ = ctx.step(level, z, t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)

    n = args.steps
    by_kernel = {}
    for e in prof.events():
        if _is_kernel(e):
            us, cnt = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (us + e.time_range.elapsed_us(), cnt + 1)
    busy_us = sum(us for us, _ in by_kernel.values())
    n_kernels = sum(cnt for _, cnt in by_kernel.values())
    print(f"profiled: wall {wall * 1e3 / n:.3f} ms per step, device busy "
          f"{busy_us / 1e3 / n:.3f} ms per step, idle share "
          f"{1.0 - busy_us / 1e6 / wall:.4f}, CUDA kernels per step "
          f"{n_kernels / n:.1f}", flush=True)
    kinds = {}
    for name, (_, cnt) in by_kernel.items():
        kinds[_kind(name)] = kinds.get(_kind(name), 0) + cnt
    print("CUDA kernels per step by kind: "
          + ", ".join(f"{k}={v / n:.1f}" for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])),
          flush=True)
    print("port kernel launches per step: "
          + ", ".join(f"{k}={v / n:.1f}" for k, v in launches.items()), flush=True)

    total = busy_us or 1.0
    print(f"device time by kernel (per step; total {busy_us / 1e3 / n:.3f} ms):")
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    shown = ranked[:25] + [kv for kv in ranked[25:] if _kind(kv[0]) == "port"]
    for name, (us, cnt) in shown:  # the top 25, then the port's kernels below them
        print(f"  {100 * us / total:6.2f}%  {us / 1e3 / n:9.4f} ms  {cnt / n:8.1f} calls  {name[:90]}")
    # the same time by the PyTorch operator that launched it (the port's own
    # kernels are launched through ctypes, outside any operator, so they
    # appear only in the list above)
    ops = [e for e in prof.key_averages() if not _is_kernel(e) and _self_device_us(e) > 0]
    ops.sort(key=_self_device_us, reverse=True)
    print("device time by launching operator (per step):")
    for e in ops[:20]:
        us = _self_device_us(e)
        print(f"  {100 * us / total:6.2f}%  {us / 1e3 / n:9.4f} ms  "
              f"{e.count / n:8.1f} calls  {e.key[:90]}")
    kernel_device_times(ctx)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
