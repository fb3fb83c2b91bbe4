#!/usr/bin/env python3
"""Profile the PyTorch port's nested-dissection fine level on one CUDA GPU.

    python3 tools/profile_torch_nd.py [--L 7] [--steps 8] [--solve]

Builds fem2d(L) on the default backend (the GPU), and runs Newton steps of
the finest level (the nested-dissection route at L >= 6) from the default
start point at t = 0.1, the first barrier parameter of amgb:

  1. one step to build the level's symbolic phase and warm the kernels;
  2. --steps steps timed on the host clock, ending in a synchronize;
  3. the parts of one ND direction on that step's Newton system (factor,
     solve, pair matvec; host wall with a synchronize) and each front
     group's assembly, kernel D's gather then kernel C's segment sum
     (CUDA events), beside its bound;
  4. --steps more steps under torch.profiler (CPU and CUDA activity).

It prints the card line, the seconds per step of (2), the times of (3),
then for (4) the device busy time per step and the idle share of the
profiled wall (1 - summed kernel time / wall; the port runs on one
stream, so kernels do not overlap), the device time by kernel name (top
25) and by the PyTorch operator that launched it (top 20), the CUDA
kernels launched per step, and the port's own kernel launches per step
(runtime/cuda_kernels.LAUNCHES).  With --solve it first times one whole fem2d_solve(L) on the same geometry
and prints its c_dot_Dz, its and wall.  Exits 1 without a CUDA device.
"""

import argparse
import importlib
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import multigridbarrier_tpu_torch as mt  # noqa: E402
from multigridbarrier_tpu_torch.runtime import cuda_kernels as ck  # noqa: E402
amgb_mod = importlib.import_module("multigridbarrier_tpu_torch.solver.amgb")


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


def parts(ctx, level, z, t):
    """The ND direction's parts on this step's Newton system (host wall
    with a synchronize), and each front group's assembly (kernel D's
    gather, then kernel C's segment sum) by CUDA events, with its bound
    (bytes over 3.35 TB/s)."""
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
    vpair = ck.row_gather(vals, nd.pair_vidx)
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
    for d in range(fz.sym.ngroups):
        lst, off = fz.asm_src[d], fz.asm_off[d]
        gathered = ck.row_gather(src, lst)
        n_out = off.numel() - 1
        g_ms = _event_ms(lambda: ck.row_gather(src, lst))
        s_ms = _event_ms(lambda: ck.segment_sum(gathered, None, off))
        g_bytes = lst.numel() * (4 + 2 * 8)
        s_bytes = lst.numel() * 8 + (n_out + 1) * 4 + n_out * 8
        rows.append((s_ms + g_ms, d, n_out, lst.numel(), g_ms, s_ms,
                     (g_bytes + s_bytes) / 3.35e12 * 1e3))
    tot = [sum(r[i] for r in rows) for i in (4, 5, 6)]
    print(f"front assembly over {len(rows)} groups (CUDA events, median of 10): "
          f"gather {tot[0]:.3f} ms, segment sum {tot[1]:.3f} ms, bound {tot[2]:.4f} ms")
    for _, d, n_out, n_src, g_ms, s_ms, bound in sorted(rows, reverse=True)[:8]:
        print(f"  group {d}: {n_out} front entries, {n_src} sources: gather "
              f"{g_ms:.4f} ms, segment sum {s_ms:.4f} ms, bound {bound:.4f} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--L", type=int, default=7)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--solve", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_nd: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
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
    print("port kernel launches per step: "
          + ", ".join(f"{k}={v / n:.1f}" for k, v in launches.items()), flush=True)

    total = busy_us or 1.0
    print(f"device time by kernel (per step; total {busy_us / 1e3 / n:.3f} ms):")
    for name, (us, cnt) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:25]:
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
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
