#!/usr/bin/env python3
"""The ND direction replayed from a CUDA graph against the eager one, on a
benchmark cell: where a Newton step's launches go, and what one direction
costs the host and the device either way.

    python3 tools/nd_graph_ab_torch.py --workload fem2d_L7.nd --seed 1234 [--out FILE]
                                       [--reps 20] [--steps 3] [--level L]
                                       [--split-only | --memory-only] [--eager]

Builds the cell of BENCHMARK.json as perfbench/run.py does (its
configuration, traffic and seeded data; the card, float64), runs the
traffic's warm-up solve (which captures each ND level's graph), then:

  1. the split: the window's first data solved once with the port's spans
     on under torch.profiler; the runtime calls that launch device work
     (kernel and graph launches, each once) counted inside the
     mgb.nd.direction ranges and outside them, per Newton step; the Newton
     steps of the solve on the ND levels (one nd.direction range each) and
     on the dense ones (the rest of the port's newton_steps), and each
     level's iterations from sol_main / sol_feasibility; the counter
     nd.graph_replays of that solve;
  2. unless --split-only: the inputs (vals, gv) of the first --steps
     directions of one ND level (--level, default the finest) recorded in
     a solve of the same data, then for each of them --reps fresh
     directions computed eagerly (_NDLevel._fresh) and --reps taken from
     the level's graph (_NDLevel.direction): host microseconds to enqueue
     one (no synchronise inside), the device span of one (CUDA events
     around it: the first to the last of its operations, waits on the host
     included) and, under torch.profiler over the same calls, the device's
     busy time per direction (union of its operations' intervals) and the
     launches per direction; the replay's output against the eager one's,
     bit for bit (dvp and the finiteness flag);
  3. the lazy builds of the warm-up solve (builds.nd_graph: one capture per
     ND level) and the run's peak allocated and reserved device memory.

--memory-only replaces parts 1 and 2 by one unprofiled solve of the same
data and reads the allocated and reserved peaks of the set-up (geometry,
warm-up) and of that solve apart (the graphs' pools count as reserved
memory, not allocated).  --eager builds every level with nd_graph_on
patched off, so that no level replays: part 1 reads the eager split and
part 2 is skipped.  The tool runs against the package of the checkout it
sits in, so a copy in another checkout measures that tree.  Prints one
JSON object (also written to --out).  Not part of the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no nvidia-smi"


def in_ranges(times, ranges):
    """How many of `times` fall inside one of the sorted, disjoint `ranges`
    ((start, end) pairs)."""
    import numpy as np

    if not ranges or not times:
        return 0
    r_s = np.array([r[0] for r in ranges], np.int64)
    r_e = np.array([r[1] for r in ranges], np.int64)
    t = np.array(times, np.int64)
    pos = np.searchsorted(r_s, t, side="right") - 1
    return int(np.sum((pos >= 0) & (t <= r_e[np.maximum(pos, 0)])))


def bits_equal(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        width = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.contiguous().view(width), b.contiguous().view(width))
    return torch.equal(a, b)


def emit(out: dict, path) -> int:
    """Print the result as one JSON line, and write it to path if given."""
    line = json.dumps(out)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        Path(path).write_text(line + "\n")
    print(line, flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--reps", type=int, default=20, help="directions timed per input and side")
    ap.add_argument("--steps", type=int, default=3, help="recorded direction inputs")
    ap.add_argument("--level", type=int, default=None, help="the ND level (default: the finest)")
    ap.add_argument("--split-only", action="store_true")
    ap.add_argument("--memory-only", action="store_true")
    ap.add_argument("--eager", action="store_true", help="no level replays")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench import data, run, spec

    import importlib

    import multigridbarrier_tpu_torch as mt
    from multigridbarrier_tpu_torch.runtime import cuda_kernels as ck
    from multigridbarrier_tpu_torch.runtime import telemetry as tm

    if args.eager:
        tam = importlib.import_module("multigridbarrier_tpu_torch.solver.amgb")
        tam.nd_graph_on = lambda device, mesh=None: False

    if not torch.cuda.is_available():
        print("nd_graph_ab_torch: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(ROOT, args.workload)
    cfg, tr = cell.config, cell.traffic
    for k, v in tr.get("env", {}).items():
        os.environ[k] = str(v)
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    dtype = getattr(torch, cfg["dtype"])
    backend = mt.backend_cuda(dtype=dtype, device=dev, **{**cfg.get("backend", {}),
                                                          **tr.get("route", {})})
    ck.build()
    ck.load()
    out = dict(card=card(), workload=args.workload, seed=args.seed, eager=args.eager)

    t0 = time.perf_counter()
    geometry = run._geometry(mt, cfg, backend)
    coef = data.draw(args.seed, 0, run.ref_mesh.DIM[cfg["family"]], tr["data"], cfg["problem"])
    f, g = data.torch_callables(coef, dtype, backend.device)
    kw = dict(D=[tuple(r) for r in cfg["problem"]["D"]], p=float(cfg["p"]), **tr.get("solve", {}))
    mt.amgb(geometry, f=f, g=g, **dict(kw, tol=float(tr["warmup_tol"])))
    sync()
    out["setup_s"] = time.perf_counter() - t0
    gb = 1e9
    out["setup_peak_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / gb
    out["setup_peak_reserved_gb"] = torch.cuda.max_memory_reserved(dev) / gb
    out["setup_builds"] = {k: v for k, v in tm.SOLVES[-1][2].items() if k.startswith("builds.")}
    (ctx,) = [c for c in geometry.ctx_cache.values() if c.nd]
    nd_levels = sorted(ctx.nd)
    out["nd_levels"] = nd_levels
    out["levels"] = ctx.levels

    if args.memory_only:
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        sol = mt.amgb(geometry, f=f, g=g, **kw)
        sync()
        out["memory"] = dict(
            solve_wall_s=time.perf_counter() - t0, newton_steps=tm.SOLVES[-1][2]["newton_steps"],
            graph_replays=tm.SOLVES[-1][2].get("nd.graph_replays", 0),
            solve_peak_allocated_gb=torch.cuda.max_memory_allocated(dev) / gb,
            solve_peak_reserved_gb=torch.cuda.max_memory_reserved(dev) / gb,
            objective=float(sol.SOL_main.c_dot_Dz[-1]))
        return emit(out, args.out)

    # 1. the split of one solve's launches, spans on, under the profiler
    tm.enable()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        sol = mt.amgb(geometry, f=f, g=g, **kw)
        sync()
        out["profiled_wall_s"] = time.perf_counter() - t0
    tm.disable()
    counts = tm.SOLVES[-1][2]
    tm.SPANS.clear()
    launches, nd_ranges, replay_ranges = [], [], 0
    cuda = torch._C._autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            continue
        if e.is_user_annotation():
            if name == "mgb.nd.direction":
                nd_ranges.append((e.start_ns(), e.start_ns() + e.duration_ns()))
            elif name == "mgb.nd.replay":
                replay_ranges += 1
        elif name in run.trace_mod.LAUNCH_CALLS:
            launches.append(e.start_ns())
    del prof
    nd_ranges.sort()
    inside = in_ranges(launches, nd_ranges)
    steps = counts.get("newton_steps", 0)
    nd_steps = len(nd_ranges)
    main_its = [int(i) for i in np.asarray(sol.SOL_main.its).tolist()]
    feas_its = ([int(i) for i in np.asarray(sol.SOL_feasibility.its).tolist()]
                if sol.SOL_feasibility is not None else None)
    out["split"] = dict(
        newton_steps=steps, nd_steps=nd_steps, dense_steps=steps - nd_steps,
        sol_main_its=main_its, sol_feasibility_its=feas_its,
        launches=len(launches), launches_in_nd=inside, launches_outside=len(launches) - inside,
        launches_per_step=len(launches) / max(steps, 1),
        in_nd_per_step=inside / max(steps, 1),
        outside_per_step=(len(launches) - inside) / max(steps, 1),
        in_nd_per_nd_step=inside / max(nd_steps, 1),
        nd_share_pct=100.0 * inside / max(len(launches), 1),
        replay_ranges=replay_ranges,
        graph_replays=counts.get("nd.graph_replays", 0),
        builds=tm.total(counts, "builds"))
    del sol

    level = args.level if args.level is not None else nd_levels[-1]
    nd = ctx.nd[level]
    if args.split_only or getattr(nd, "graph", None) is None:
        out["ab"] = None
    else:
        # 2. eager against replay on recorded inputs of one level
        inputs = []
        real = nd.step_direction

        def record(vals, gv, cg_rtol):
            if len(inputs) < args.steps:
                inputs.append((vals.clone(), gv.clone()))
            return real(vals, gv, cg_rtol)

        nd.step_direction = record
        try:
            mt.amgb(geometry, f=f, g=g, **kw)
        finally:
            del nd.step_direction
        sync()

        def timed(fn, vals, gv):
            host, span = [], []
            for _ in range(args.reps):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                sync()
                a.record()
                t0 = time.perf_counter_ns()
                fn(vals, gv)
                t1 = time.perf_counter_ns()
                b.record()
                sync()
                host.append((t1 - t0) / 1e3)
                span.append(a.elapsed_time(b) * 1e3)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
                sync()
                for _ in range(args.reps):
                    fn(vals, gv)
                sync()
            d_s, d_e, n_launch = [], [], 0
            for e in p.profiler.kineto_results.events():
                if e.device_type() == cuda:
                    if not e.is_user_annotation():
                        d_s.append(e.start_ns())
                        d_e.append(e.start_ns() + e.duration_ns())
                elif e.name() in run.trace_mod.LAUNCH_CALLS:
                    n_launch += 1
            busy, _, _ = run.trace_mod._union(np.array(d_s, np.int64), np.array(d_e, np.int64))
            return dict(host_us=statistics.median(host), span_us=statistics.median(span),
                        busy_us=busy / 1e3 / args.reps, launches=n_launch / args.reps)

        def eager(vals, gv):
            return nd._fresh(vals, gv)

        def replay(vals, gv):
            return nd.direction(vals, gv)

        rows = []
        for vals, gv in inputs:
            dvp_e, fin_e, _ = eager(vals, gv)
            dvp_r = replay(vals, gv)
            fin_r = nd.finite
            sync()
            rows.append(dict(
                bits_equal=bits_equal(dvp_e, dvp_r) and bool(fin_e) == bool(fin_r),
                finite=bool(fin_e), eager=timed(eager, vals, gv), replay=timed(replay, vals, gv)))
        out["ab"] = dict(level=level, m=nd.m, nf=nd.nf, groups=nd.fz.sym.ngroups,
                         reps=args.reps, inputs=rows)
    # the graphs' pools hold their intermediates as reserved, not allocated, memory
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["peak_reserved_gb"] = torch.cuda.max_memory_reserved(dev) / 1e9
    return emit(out, args.out)


if __name__ == "__main__":
    sys.exit(main())
