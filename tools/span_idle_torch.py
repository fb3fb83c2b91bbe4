#!/usr/bin/env python3
"""The port's spans on a benchmark cell: set-up parts, the cost of spans,
and the device's idle time split over the Newton step's phases.

    python3 tools/span_idle_torch.py --workload fem2d_L7.nd --seed 1234 [--out FILE]
                                     [--cycles 1] [--start-on] [--device cpu --L 3]

Builds the cell of BENCHMARK.json as perfbench/run.py does (its
configuration, traffic and seeded data; the card, float64), then:

  1. with spans on (runtime/telemetry.enable()): the geometry and the
     traffic's warm-up solve; the set-up spans summed by name (ctx.build,
     nd.symbolic and its parts, nd.plans, hvp.schedule);
  2. the window's first data solved without the profiler, --cycles times
     spans off, on, on, off (--start-on: on, off, off, on): each solve's wall (host clock, a device
     synchronise at both ends), Newton steps and counters (telemetry.SOLVES);
     the iterates must agree bit for bit; and the host nanoseconds of one
     span site, off and on, times the spans of a solve over its wall;
  3. the same data once more with spans on under torch.profiler (CPU and
     CUDA activity): the device's idle time between its first and last
     operation split over the mgb.* ranges (perfbench/span_idle.py; the
     innermost range wins, "outside" where none is open, and each name's
     ranges with their children), the ten longest idle gaps with the
     innermost range around each, launches per Newton step and busy time.

Prints one JSON object (also written to --out).  Not part of the
benchmark's runs; --device cpu runs it on the CPU at a small --L (no
device operations: the idle split is empty).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
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


def by_name(spans) -> dict:
    out = collections.defaultdict(float)
    for name, a, b in spans:
        out[name] += (b - a) / 1e9
    return dict(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--L", type=int, default=None, help="override the configuration's L")
    ap.add_argument("--cycles", type=int, default=1, help="rounds of off, on, on, off solves")
    ap.add_argument("--start-on", action="store_true", help="rounds of on, off, off, on")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench import data, run, span_idle, spec

    import multigridbarrier_tpu_torch as mt
    from multigridbarrier_tpu_torch.runtime import cuda_kernels as ck
    from multigridbarrier_tpu_torch.runtime import telemetry as tm

    cell = spec.load_cell(ROOT, args.workload)
    cfg, tr = cell.config, cell.traffic
    if args.L is not None:
        cfg["L"] = args.L
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    dtype = getattr(torch, cfg["dtype"])
    opts = {**cfg.get("backend", {}), **tr.get("route", {})}
    backend = (mt.backend_cuda(dtype=dtype, device=dev, **opts) if on_card
               else mt.backend_cpu(dtype=dtype, **opts))
    if on_card:
        ck.build()
        ck.load()
    out = dict(card=card() if on_card else "cpu", workload=args.workload, seed=args.seed)

    # 1. set-up with spans on
    tm.enable()
    t0 = time.perf_counter()
    geometry = run._geometry(mt, cfg, backend)
    sync()
    coef = data.draw(args.seed, 0, run.ref_mesh.DIM[cfg["family"]], tr["data"], cfg["problem"])
    f, g = data.torch_callables(coef, dtype, backend.device)
    kw = dict(D=[tuple(r) for r in cfg["problem"]["D"]], p=float(cfg["p"]), **tr.get("solve", {}))
    mt.amgb(geometry, f=f, g=g, **dict(kw, tol=float(tr["warmup_tol"])))
    sync()
    tm.disable()
    out["setup_s"] = time.perf_counter() - t0
    out["setup_spans"] = {k: v for k, v in by_name(tm.SPANS).items()
                          if k.startswith(("ctx.", "nd.symbolic", "nd.plans", "hvp."))}
    tm.SPANS.clear()

    # 2. spans off, on, on, off on the same data
    runs, zs = [], []
    first = args.start_on
    for on in (first, not first, not first, first) * args.cycles:
        if on:
            tm.enable()
        sync()
        t0 = time.perf_counter()
        sol = mt.amgb(geometry, f=f, g=g, **kw)
        sync()
        wall = time.perf_counter() - t0
        tm.disable()
        counts = tm.SOLVES[-1][2]
        runs.append(dict(spans=on, wall=wall, steps=counts.get("newton_steps", 0),
                         n_spans=len(tm.SPANS), counters=counts))
        tm.SPANS.clear()
        zs.append(sol.z.detach().cpu())
        del sol
    out["runs"] = runs
    out["bits_equal"] = all(torch.equal(zs[0], z) for z in zs[1:])
    off = [r["wall"] for r in runs if not r["spans"]]
    on = [r["wall"] for r in runs if r["spans"]]
    out["span_cost_pct"] = 100.0 * (sum(on) / len(on) / (sum(off) / len(off)) - 1.0)
    # the host cost of one span site, spans off and on, outside the profiler
    def site_ns(n=200000):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with tm.span("x"):
                pass
        return (time.perf_counter_ns() - t0) / n
    cost = {"off": site_ns()}
    tm.enable()
    cost["on"] = site_ns()
    tm.disable()
    tm.SPANS.clear()
    n_spans = max(r["n_spans"] for r in runs)
    out["span_site_ns"] = cost
    out["span_cost_est_pct"] = 100.0 * n_spans * (cost["on"] - cost["off"]) / 1e9 / (
        sum(off) / len(off))
    c = runs[0]["counters"]
    steps = c.get("newton_steps", 0) or 1
    out["per_step"] = dict(
        host_syncs=tm.total(c, "host_syncs") / steps, ls_trials=c.get("ls_trials", 0) / steps)
    out["per_solve"] = dict(
        factor_retries=c.get("dense_shift_retries", 0) + c.get("nd_fallbacks", 0),
        dense_shift_retries=c.get("dense_shift_retries", 0), nd_fallbacks=c.get("nd_fallbacks", 0),
        builds=tm.total(c, "builds"))

    # 3. the profiled solve, spans on
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    tm.enable()
    with profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        mt.amgb(geometry, f=f, g=g, **kw)
        sync()
        out["profiled_wall"] = time.perf_counter() - t0
    tm.disable()
    steps = tm.SOLVES[-1][2].get("newton_steps", 0)
    tm.SPANS.clear()
    t0 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    devops, ranges = span_idle.from_events(events)
    launches = sum(1 for e in events if e.name() in run.trace_mod.LAUNCH_CALLS)
    del events, prof
    split = span_idle.idle_by_span(devops, ranges)
    out.update(idle=split, profiled_steps=steps, launches_per_step=launches / max(steps, 1),
               reduce_s=time.perf_counter() - t0)
    if devops:
        d_s = np.array([d[0] for d in devops], np.int64)
        d_e = np.array([d[1] for d in devops], np.int64)
        gap_at, gap_len = span_idle.gaps(d_s, d_e)
        out["busy_s"] = int(d_e.max() - d_s.min() - gap_len.sum()) / 1e9
        top = []
        for i in np.argsort(-gap_len, kind="stable")[:10].tolist():
            mid = int(gap_at[i] + gap_len[i] // 2)
            inner = [r for r in ranges if r[0] <= mid <= r[1]]
            name = max(inner, key=lambda r: r[0])[2] if inner else span_idle.OUTSIDE
            top.append([name, int(gap_len[i]) / 1e9])
        out["top_gaps"] = top
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
