"""The benchmark of multigridbarrier_tpu_torch, the PyTorch and CUDA port:
one run of one cell.

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (configs/, its sizes, problem and limits)
and a traffic (traffic/<name>.json: env, the MGB_* variables it sets;
route, backend options; solve, keyword arguments of amgb; data, the seeded
perturbation; warmup_tol).  The geometry is the port's constructor that
the configuration's family names, and the judge is reference/'s.

Set-up: the kernel library (built under build/kernels of the checkout by
its first run, loaded by the others), the geometry of the cell's
configuration on the card, the seeded data (data.py), and one warm-up
solve of that data at the traffic's loose tolerance, which visits every
level and so builds every solver context, ND symbolic factorisation and
launch plan.  Nothing of it is reused but the geometry and its contexts.

Window: whole solves of that data at the published tolerance, back to
back, host clock with a device synchronise at both ends; no solve starts
that the previous one's wall says would end past --seconds, and at least
one runs.  With --trace 1 the first solve runs under torch.profiler and the
wrappers of trace.py, and the second solves the same data again without
the profiler: the host spans are taken there, and its wall is the base of
the device's idle share.  The per-layer metrics come from that run.

Check: every timed solve's iterate and reported objective, judged by the
plain reference (reference/) once the window has closed, the memory peak
has been read and the program's state is freed.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and last the compared
numbers with their limits (checks), which also close standard error.
Exit 2: no card, fewer cards than the cell asks for, no port in the
checkout, or no such cell; exit 3: the JAX package or JAX was loaded.

Not part of the benchmark's runs: --calibrate s1,s2,... runs the set-up
once, then one solve and its check per seed, a JSON line each; with
--control float32 on the float32 route, the control that the check has
to fail; with --cut k1,k2,... each seed once per k with the path ended k
times short (tol times k: t ends at 1/(k tol), the last stage's stop rule
k^2 looser), the fault of a stop rule loosened.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

_T0 = time.perf_counter()


def _started_before() -> float:
    """Seconds between the process's start and _T0 (interpreter start-up)."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK") - (time.perf_counter() - _T0))
    except (OSError, ValueError, IndexError):
        return 0.0


_STARTUP = _started_before()
ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# every build and kernel cache inside the checkout, at fixed paths
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = str(ROOT / "build" / "perfbench-cache" / _sub)

from perfbench import data, spec  # noqa: E402
from perfbench import trace as trace_mod  # noqa: E402
from perfbench.reference import check as ref_check  # noqa: E402
from perfbench.reference import mesh as ref_mesh  # noqa: E402

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "multigridbarrier_tpu"})


def forbidden_loaded() -> list:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (multigridbarrier_tpu_torch is not multigridbarrier_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


GEOMETRY_KEYS = ("L", "k")  # the configuration's keys that the geometry call takes


def _geometry(mt, cfg, backend):
    """The port's geometry constructor named by the family (fem2d, fem3d, ...)."""
    kw = {k: int(cfg[k]) for k in GEOMETRY_KEYS if k in cfg}
    return getattr(mt, cfg["family"])(backend=backend, **kw)


def _judge(cfg, coef, device):
    pr = cfg["problem"]
    ops = {"id": "id", "dx": 0, "dy": 1, "dz": 2}
    fields = []
    rows = []
    for fname, op in pr["D"]:
        if fname not in fields:
            fields.append(fname)
        rows.append((fields.index(fname), ops[op]))
    tol = cfg.get("tol") or math.sqrt(2.0 ** -52)
    prob = ref_check.Problem(rows, len(fields), list(pr["cone"]),
                             lambda x: data.cost_np(coef, x), lambda x: data.start_np(coef, x), tol)
    return ref_check.Judge(ref_mesh.build(cfg), prob, device)


def _phase(log):
    """A solve's phase log as plain host values, for the metric readers."""
    if log is None:
        return None
    return {k: (v.tolist() if hasattr(v, "tolist") else v) for k, v in vars(log).items()}


def measure(cell: spec.Cell, seed: int, seconds: float, trace: bool = False, device: str = "cuda",
            control=None, seeds=None, cuts=(1,)) -> dict:
    """Set-up, window and check of one run; returns the record the metric
    readers take and the check's readings.  Solve i of the window (and the
    warm-up, on solve 0's data) solves data.draw(seed, i), but with trace
    solve 1 solves solve 0's data again and solve i > 1 data i - 1; with
    seeds (a calibration), the window is one solve of data.draw(s, 0) for
    each seed s, once for each k of cuts with tol times k."""
    import torch

    cfg, tr = cell.config, cell.traffic
    for k, v in tr.get("env", {}).items():
        os.environ[k] = str(v)
    import multigridbarrier_tpu_torch as mt
    from multigridbarrier_tpu_torch.runtime import cuda_kernels as ck

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    dtype = getattr(torch, control or cfg["dtype"])
    opts = {**cfg.get("backend", {}), **tr.get("route", {})}
    backend = (mt.backend_cuda(dtype=dtype, device=dev, **opts) if on_card
               else mt.backend_cpu(dtype=dtype, **opts))
    dim = ref_mesh.DIM[cfg["family"]]
    tracer = trace_mod.Tracer() if trace else None
    prof = None
    solves = []
    try:
        if tracer:
            tracer.install()
        if on_card:
            ck.build()
            ck.load()
        t = time.perf_counter()
        geometry = _geometry(mt, cfg, backend)
        sync()
        geometry_s = time.perf_counter() - t
        coefs, fns = [], []

        def instance(i):
            while len(coefs) <= i:
                j = len(coefs)
                c = data.draw(*((seeds[j], 0) if seeds else (seed, j)), dim, tr["data"],
                              cfg["problem"])
                coefs.append(c)
                fns.append(data.torch_callables(c, dtype, backend.device))
            return fns[i]

        kw = dict(D=[tuple(r) for r in cfg["problem"]["D"]], p=float(cfg["p"]),
                  **tr.get("solve", {}))
        if cfg.get("tol") is not None:
            kw["tol"] = float(cfg["tol"])
        warm = dict(kw, tol=float(tr["warmup_tol"]))
        f, g = instance(0)
        mt.amgb(geometry, f=f, g=g, **warm)
        sync()
        plan = ([(j, k) for k in cuts for j in range(len(seeds))] if seeds else None)
        peak_setup = torch.cuda.max_memory_allocated(dev) if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        t_win = time.perf_counter()
        setup_s = _STARTUP + (t_win - _T0)
        while True:
            i = len(solves)
            d, cut = plan[i] if plan else ((max(i - 1, 0), 1) if tracer else (i, 1))
            f, g = instance(d)
            if tracer and i == 1:
                tracer.timing = True
            if tracer and i == 0:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
                prof = profile(activities=acts)
                prof.__enter__()
                tracer.profiling = True
            kwi = kw if cut == 1 else dict(kw, tol=cut * (kw.get("tol") or _default_tol(dtype)))
            t0 = time.perf_counter()
            try:
                sol, err = mt.amgb(geometry, f=f, g=g, **kwi), None
            except mt.AMGBConvergenceFailure as exc:
                sol, err = None, repr(exc)
            sync()
            t1 = time.perf_counter()
            if prof is not None and i == 0:
                tracer.profiling = False
                prof.__exit__(None, None, None)
            if tracer:
                tracer.timing = False
            rec = dict(start=t0, end=t1, wall=t1 - t0, err=err, data=d, cut=cut)
            if sol is not None:
                rec.update(z=sol.z.detach(), obj=float(sol.SOL_main.c_dot_Dz[-1]),
                           its=int(sol.SOL_main.its.sum() + (sol.SOL_feasibility.its.sum()
                                                             if sol.SOL_feasibility else 0)),
                           logs=(sol.SOL_feasibility, sol.SOL_main, sol.log))
            solves.append(rec)
            del sol
            if plan:
                if len(solves) >= len(plan):
                    break
            elif tracer and i == 0:
                continue  # the profiled solve's unprofiled repeat always runs
            elif (t1 - t_win) + (t1 - t0) > seconds:
                break
        peak_window = torch.cuda.max_memory_allocated(dev) if on_card else 0
    finally:
        if tracer:
            tracer.uninstall()
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    profile = None
    if prof is not None:
        profile = trace_mod.reduce(prof.profiler.kineto_results.events(), tracer, kind,
                                   solves[0]["wall"])
        del prof
    del geometry, fns, f, g
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # each solve's log as host values: phase logs and the per-step log
    for s in solves:
        feas, main, steps = s.pop("logs", (None, None, None))
        s.update(sol_feasibility=_phase(feas), sol_main=_phase(main), log=steps)
    # the check, on the card, after the program's state is gone
    limits = cell.limits()
    for s in solves:
        z = s.pop("z", None)
        if s["err"] is not None:
            s["check"], s["ok"] = None, False
            continue
        s["check"] = _judge(cfg, coefs[s["data"]], dev).judge(z, s["obj"])
        s["ok"] = all(s["check"][n] <= lim for n, lim in limits.items())
        del z
    worst = {n: max((s["check"][n] for s in solves if s["check"]), default=math.inf)
             for n in limits}
    if any(s["err"] for s in solves):
        worst = {n: math.inf for n in limits}
    return dict(
        correct=all(s["ok"] for s in solves), attempted=len(solves),
        failed=sum(not s["ok"] for s in solves), limits=limits, worst=worst,
        rec=SimpleNamespace(
            setup_s=setup_s, geometry_s=geometry_s, solves=solves,
            window_s=solves[-1]["end"] - solves[0]["start"],
            symbolic_s=list(tracer.symbolic_s) if tracer else [],
            base_wall_s=(solves[1]["wall"] if tracer and len(solves) > 1
                         and solves[1].get("its") == solves[0].get("its") else None),
            spans={k: list(v) for k, v in tracer.spans.items()} if tracer else {},
            profile=profile, peak_window_bytes=peak_window),
        device=dict(platform="gpu" if on_card else "cpu", kind=kind,
                    count=cell.chips, memory_peak_bytes=int(max(peak_setup, peak_window))),
    )


def _default_tol(dtype):
    import torch

    return math.sqrt(torch.finfo(dtype).eps)


def result_line(cell: spec.Cell, out: dict, trace: bool) -> dict:
    """The result object; checks comes last."""
    rec = out["rec"]
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = dict(out["device"])
    line = dict(correct=out["correct"], attempted=out["attempted"], failed=out["failed"],
                metrics=metrics, device=device)
    if trace and rec.profile is not None:
        device.update(busy_s=rec.profile["busy_s"], window_s=rec.profile["wall_s"])
        line["breakdown"] = dict(device_ops=rec.profile["device_ops"],
                                 idle_gaps=rec.profile["idle_gaps"])
    line["checks"] = {n: {"value": _num(out["worst"][n]), "limit": lim}
                      for n, lim in out["limits"].items()}
    return line


def _num(v):
    """JSON has no infinity: a reading that never came is 1e308."""
    return v if math.isfinite(v) else 1e308


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--calibrate", default="", help="comma-separated seeds, one solve each")
    ap.add_argument("--control", choices=("float32",), default=None)
    ap.add_argument("--cut", default="1", help="with --calibrate: comma-separated path cuts k")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    try:
        cell = spec.load_cell(ROOT, args.workload)
    except (KeyError, OSError, ValueError) as exc:
        print(f"perfbench: {exc}", file=sys.stderr)
        return 2
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s), this process "
              f"sees {n}; the benchmark does not run on the CPU", file=sys.stderr)
        return 2
    try:
        import multigridbarrier_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"perfbench: the port is not in this checkout: {exc}", file=sys.stderr)
        return 2
    if args.calibrate:
        seeds = [int(s) for s in args.calibrate.split(",")]
        cuts = [float(k) for k in args.cut.split(",")]
        out = measure(cell, seeds[0], math.inf, device="cuda", control=args.control, seeds=seeds,
                      cuts=cuts)
        for s in out["rec"].solves:
            print(json.dumps(dict(seed=seeds[s["data"]], cut=s["cut"], wall=s["wall"], its=s.get("its"),
                                  err=s["err"], ok=s["ok"], check=s["check"])), flush=True)
        bad = forbidden_loaded()
        if bad:
            print(f"perfbench: loaded {bad}", file=sys.stderr)
            return 3
        return 0
    out = measure(cell, args.seed, args.seconds, trace=bool(args.trace), control=args.control)
    bad = forbidden_loaded()
    if bad:
        print(f"perfbench: the run loaded {bad}, which the benchmark must not load",
              file=sys.stderr)
        return 3
    line = result_line(cell, out, bool(args.trace))
    for i, s in enumerate(out["rec"].solves):
        print(f"solve {i} wall {s['wall']!r} its {s.get('its')} {s['err'] or ''}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
