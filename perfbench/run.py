"""The benchmark of multigridbarrier_tpu_torch, the PyTorch and CUDA port:
one run of one cell.

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (configs/, its sizes, problem and limits)
and a traffic (traffic/<name>.json: env, the MGB_* variables it sets;
route, backend options; solve, keyword arguments of the entry; data, the
seeded perturbation; warmup_tol).  The geometry is the port's constructor
that the configuration's family names, and the judge is reference/'s.

The entry is amgb, or where the configuration states "entry": "parabolic"
(with h, t1 and p), the time stepper parabolic_solve: one solve is then a
whole time-stepping solve, all of its steps, and the judge takes every
step (reference/parabolic.py).  A parabolic configuration runs on one card.

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

A cell whose configuration states ranks > 1 (and whose chips equal them)
runs as one process a card (ranks.py, run_mesh): every rank runs the
set-up, the window and the solves above on a mesh of them, in step (a
barrier at the window's start and end, rank 0's decision whether the next
solve starts); rank 0 judges, and counts the ranks whose iterate or
objective differs from its own in any bit (ranks_agree).  The launching
process prints.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and last the compared
numbers with their limits (checks), which also close standard error.
Exit 2: no card, fewer cards than the cell asks for, no port in the
checkout, no such cell, a cell whose chips differ from its configuration's
ranks, an entry that is not amgb or parabolic, or a parabolic
configuration over several ranks; exit 1: a rank of a mesh cell failed;
exit 3: the JAX package or JAX was loaded.

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
import hashlib
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

from perfbench import data, port_counters, spec  # noqa: E402
from perfbench import trace as trace_mod  # noqa: E402
from perfbench.reference import check as ref_check  # noqa: E402
from perfbench.reference import mesh as ref_mesh  # noqa: E402
from perfbench.reference import parabolic as ref_parabolic  # noqa: E402

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "multigridbarrier_tpu"})


def forbidden_loaded() -> list:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (multigridbarrier_tpu_torch is not multigridbarrier_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


GEOMETRY_KEYS = ("L", "k")  # the configuration's keys that the geometry call takes
ENTRIES = ("amgb", "parabolic")  # the configuration's "entry"; amgb without one


def entry_of(cfg) -> str:
    entry = cfg.get("entry", "amgb")
    if entry not in ENTRIES:
        raise ValueError(f"no entry {entry!r}: the harness runs {', '.join(ENTRIES)}")
    return entry


def _geometry(mt, cfg, backend):
    """The port's geometry constructor named by the family (fem2d, fem3d, ...)."""
    kw = {k: int(cfg[k]) for k in GEOMETRY_KEYS if k in cfg}
    return getattr(mt, cfg["family"])(backend=backend, **kw)


def _judge(cfg, coef, device):
    tol = cfg.get("tol") or math.sqrt(2.0 ** -52)
    if entry_of(cfg) == "parabolic":
        dim = ref_mesh.DIM[cfg["family"]]
        f, h = cfg["problem"]["f"], float(cfg["h"])
        if list(f[1:]) != [0.0] * dim + [1.0, 1.0 / (2.0 * h)]:
            raise ValueError(f"a time step's cost rows are [f1, 0.., 1, 1/(2h)], not {f}")
        prob = ref_parabolic.step_problem(dim, float(cfg["p"]), h,
                                          lambda x: data.source_np(coef, x),
                                          lambda x: data.start_np(coef, x)[:, 0], tol)
        return ref_check.Judge(ref_mesh.build(cfg), prob, device)
    pr = cfg["problem"]
    ops = {"id": "id", "dx": 0, "dy": 1, "dz": 2}
    fields = []
    rows = []
    for fname, op in pr["D"]:
        if fname not in fields:
            fields.append(fname)
        rows.append((fields.index(fname), ops[op]))
    cone = list(pr["cone"])
    prob = ref_check.Problem(rows, len(fields),
                             [ref_check.Cone(tuple(cone[:-1]), cone[-1], float(cfg["p"]))],
                             lambda x: data.cost_np(coef, x), lambda x: data.start_np(coef, x), tol)
    return ref_check.Judge(ref_mesh.build(cfg), prob, device)


def _phase(log):
    """A solve's phase log as plain host values, for the metric readers."""
    if log is None:
        return None
    return {k: (v.tolist() if hasattr(v, "tolist") else v) for k, v in vars(log).items()}


def _collective_counts():
    """The port's collectives so far and the bytes they brought this rank
    (runtime/dist's counters, handed out by telemetry.snapshot()); (0, 0)
    where the port keeps no such counters."""
    tm = sys.modules.get(port_counters.MODULE)
    if tm is None or not hasattr(tm, "snapshot"):
        return 0, 0
    snap = tm.snapshot()
    return sum(snap["COLLECTIVES"].values()), sum(snap["BYTES"].values())


def _digest(s) -> str:
    """The bits of a solve's iterate and reported objective (or its error)."""
    h = hashlib.sha256(repr((s["err"], s.get("obj"))).encode())
    z = s.get("z")
    if z is not None:
        h.update(repr((tuple(z.shape), str(z.dtype))).encode())
        h.update(z.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def measure(cell: spec.Cell, seed: int, seconds: float, trace: bool = False, device: str = "cuda",
            control=None, seeds=None, cuts=(1,), ranks=None) -> dict:
    """Set-up, window and check of one run; returns the record the metric
    readers take and the check's readings.  Solve i of the window (and the
    warm-up, on solve 0's data) solves data.draw(seed, i), but with trace
    solve 1 solves solve 0's data again and solve i > 1 data i - 1; with
    seeds (a calibration), the window is one solve of data.draw(s, 0) for
    each seed s, once for each k of cuts with tol times k.

    ranks (a ranks.Rank) runs this as one rank of a mesh over every rank of
    the process group: the backend on that mesh, the window's start and end
    at a barrier, rank 0's decision whether the next solve starts on every
    rank, the memory peaks the largest and the device's busy time the mean
    over the ranks, the set-up time on the launching process's clock.  Rank
    0 alone judges, and holds every rank's iterate and objective to its own
    bit for bit (ranks_agree); the other ranks return None once the window
    has closed.

    With the parabolic entry each solve is one parabolic_solve, whose
    record keeps each time step's logs under steps and, over the steps,
    its Newton iterations summed (its), their per-step log joined (log)
    and each phase's iterations per level summed (sol_main,
    sol_feasibility: {"its": ...})."""
    import torch

    cfg, tr = cell.config, cell.traffic
    entry = entry_of(cfg)
    if entry == "parabolic" and ranks is not None:
        raise ValueError("a parabolic configuration runs on one card")
    for k, v in tr.get("env", {}).items():
        os.environ[k] = str(v)
    import multigridbarrier_tpu_torch as mt
    from multigridbarrier_tpu_torch.runtime import cuda_kernels as ck

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    dtype = getattr(torch, control or cfg["dtype"])
    opts = {**cfg.get("backend", {}), **tr.get("route", {})}
    if ranks is None:
        backend = (mt.backend_cuda(dtype=dtype, device=dev, **opts) if on_card
                   else mt.backend_cpu(dtype=dtype, **opts))
    else:
        backend = (mt.backend_cuda(dtype=dtype, n_devices=ranks.world, **opts) if on_card
                   else mt.backend_cpu(dtype=dtype, mesh=mt.make_mesh(ranks.world, "cpu"), **opts))
        dev = backend.device
    dim = ref_mesh.DIM[cfg["family"]]
    tracer = trace_mod.Tracer() if trace else None
    prof = None
    solves = []
    phases = {}  # host seconds of the run's parts after set-up, for the log
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
                f, g = data.torch_callables(c, dtype, backend.device)
                if entry == "parabolic":
                    f = data.torch_source(c, dtype, backend.device)
                fns.append((f, g))
            return fns[i]

        if entry == "parabolic":
            kw = dict(h=float(cfg["h"]), t1=float(cfg["t1"]), p=float(cfg["p"]),
                      **tr.get("solve", {}))

            def call(f, g, **k):
                return mt.parabolic_solve(geometry, f1=f, g=g, **k)
        else:
            kw = dict(D=[tuple(r) for r in cfg["problem"]["D"]], p=float(cfg["p"]),
                      **tr.get("solve", {}))

            def call(f, g, **k):
                return mt.amgb(geometry, f=f, g=g, **k)
        if cfg.get("tol") is not None:
            kw["tol"] = float(cfg["tol"])
        warm = dict(kw, tol=float(tr["warmup_tol"]))
        f, g = instance(0)
        call(f, g, **warm)
        sync()
        plan = ([(j, k) for k in cuts for j in range(len(seeds))] if seeds else None)
        peak_setup = torch.cuda.max_memory_allocated(dev) if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        if ranks is not None:
            ranks.barrier()
        t_win = time.perf_counter()
        setup_s = (_STARTUP + (t_win - _T0) if ranks is None
                   else ranks.startup + (t_win - ranks.t0))
        phases["setup_s"] = setup_s
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
            n0, b0 = _collective_counts()
            t0 = time.perf_counter()
            try:
                sol, err = call(f, g, **kwi), None
            except mt.AMGBConvergenceFailure as exc:
                sol, err = None, repr(exc)
            sync()
            t1 = time.perf_counter()
            if prof is not None and i == 0:
                tracer.profiling = False
                prof.__exit__(None, None, None)
                phases["profiler_exit_s"] = time.perf_counter() - t1
            if tracer:
                tracer.timing = False
            n1, b1 = _collective_counts()
            rec = dict(start=t0, end=t1, wall=t1 - t0, err=err, data=d, cut=cut,
                       collectives=n1 - n0, collective_bytes=b1 - b0)
            if sol is not None and entry == "parabolic":
                steps = [_outcome(st) for st in sol.sols]
                rec.update(z=[u.detach() for u in sol.u], obj=steps[-1]["obj"] if steps else None,
                           its=sum(st["its"] for st in steps), steps=steps)
            elif sol is not None:
                rec.update(_outcome(sol), z=sol.z.detach())
            solves.append(rec)
            del sol
            if plan:
                stop = len(solves) >= len(plan)
            elif tracer and i == 0:
                stop = False  # the profiled solve's unprofiled repeat always runs
            else:
                stop = (t1 - t_win) + (t1 - t0) > seconds
            if ranks is not None:
                stop = ranks.decide(stop)
            if stop:
                break
        if ranks is not None:
            ranks.barrier()
        peak_window = torch.cuda.max_memory_allocated(dev) if on_card else 0
    finally:
        if tracer:
            tracer.uninstall()
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    profile = None
    t = time.perf_counter()
    if prof is not None:
        collecting = gc.isenabled()
        gc.disable()  # millions of event tuples: no collector passes over them
        try:
            profile = trace_mod.reduce(prof.profiler.kineto_results.events(), tracer, kind,
                                       solves[0]["wall"])
        finally:
            if collecting:
                gc.enable()
        del prof
        phases["reduce_s"] = time.perf_counter() - t
    del geometry, fns, f, g
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ranks_busy_s, differ = None, None
    if ranks is not None:
        mine = dict(peaks=(peak_setup, peak_window), digests=[_digest(s) for s in solves],
                    busy_s=profile["busy_s"] if profile else None, forbidden=forbidden_loaded())
        every = ranks.gather(mine)
        if ranks.rank != 0:
            return None
        peak_setup = max(o["peaks"][0] for o in every)
        peak_window = max(o["peaks"][1] for o in every)
        ranks_busy_s = [o["busy_s"] for o in every] if profile else None
        differ = [sum(len(o["digests"]) != len(solves) or o["digests"][j] != mine["digests"][j]
                      for o in every[1:]) for j in range(len(solves))]

    # each solve's log as host values: phase logs and the per-step log
    for s in solves:
        for st in s.get("steps", [s]):
            feas, main, log = st.pop("logs", (None, None, None))
            st.update(sol_feasibility=_phase(feas), sol_main=_phase(main), log=log)
        if "steps" in s:
            s.update({k: _summed([st[k] for st in s["steps"]])
                      for k in ("sol_feasibility", "sol_main")},
                     log=[e for st in s["steps"] for e in (st["log"] or [])])
    # the check, on the card, after the program's state is gone
    limits = cell.limits()
    t = time.perf_counter()
    for j, s in enumerate(solves):
        z = s.pop("z", None)
        if s["err"] is not None:
            s["check"], s["ok"] = None, False
            continue
        judge = _judge(cfg, coefs[s["data"]], dev)
        if entry == "parabolic":
            due = ref_parabolic.snapshots_due(float(cfg["t1"]), float(cfg["h"]))
            s["check"], rows = ref_parabolic.judge_steps(
                judge, z, [st["obj"] for st in s["steps"]], due)
            for st, r in zip(s["steps"], rows):
                st["check"] = r
        else:
            s["check"] = judge.judge(z, s["obj"])
        del judge
        if differ is not None:
            s["check"]["ranks_agree"] = differ[j]
        s["ok"] = all(s["check"][n] <= lim for n, lim in limits.items())
        del z
    phases["judge_s"] = time.perf_counter() - t
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
            profile=profile, peak_window_bytes=peak_window, ranks_busy_s=ranks_busy_s,
            phases=phases),
        device=dict(platform="gpu" if on_card else "cpu", kind=kind,
                    count=cell.chips, memory_peak_bytes=int(max(peak_setup, peak_window))),
        forbidden=sorted({m for o in every for m in o["forbidden"]}) if ranks is not None else [],
    )


def _outcome(sol) -> dict:
    """An amgb solution's reported objective, Newton iterations over the
    levels of both phases, and its logs (feasibility, main, per step)."""
    return dict(obj=float(sol.SOL_main.c_dot_Dz[-1]),
                its=int(sol.SOL_main.its.sum() + (sol.SOL_feasibility.its.sum()
                                                  if sol.SOL_feasibility else 0)),
                logs=(sol.SOL_feasibility, sol.SOL_main, sol.log))


def _summed(phases):
    """The time steps' phase logs as one: their iterations per level summed."""
    its = [p["its"] for p in phases if p is not None]
    return {"its": [sum(v) for v in zip(*its)]} if its else None


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
        busy = rec.ranks_busy_s or [rec.profile["busy_s"]]  # the mean over the ranks
        device.update(busy_s=sum(busy) / len(busy), window_s=rec.profile["wall_s"])
        line["breakdown"] = dict(device_ops=rec.profile["device_ops"],
                                 idle_gaps=rec.profile["idle_gaps"])
    line["checks"] = {n: {"value": _num(out["worst"][n]), "limit": lim}
                      for n, lim in out["limits"].items()}
    return line


def _num(v):
    """JSON has no infinity: a reading that never came is 1e308."""
    return v if math.isfinite(v) else 1e308


def report(cell: spec.Cell, out: dict, trace: bool, seeds=None) -> dict:
    """What the printing process takes from a run: with seeds (a
    calibration), one row per solve; else the result line and each solve's
    wall, Newton iterations and error.  Plain values only."""
    solves, forbidden = out["rec"].solves, out["forbidden"]
    if seeds:
        return dict(rows=[dict(seed=seeds[s["data"]], cut=s["cut"], wall=s["wall"],
                               its=s.get("its"), err=s["err"], ok=s["ok"], check=s["check"],
                               **({"steps": [dict(its=st["its"], check=st.get("check"))
                                             for st in s["steps"]]} if "steps" in s else {}))
                          for s in solves], forbidden=forbidden)
    return dict(line=result_line(cell, out, trace), phases=out["rec"].phases, forbidden=forbidden,
                solves=[(s["wall"], s.get("its"), s["err"]) for s in solves])


def _rank_job(rank, cell, seed, seconds, trace, control, seeds, cuts, device):
    """One rank's run of a mesh cell; rank 0's report, None elsewhere."""
    out = measure(cell, seed, seconds, trace=trace, device=device, control=control, seeds=seeds,
                  cuts=cuts, ranks=rank)
    return None if out is None else report(cell, out, trace, seeds)


def run_mesh(cell: spec.Cell, seed: int, seconds: float, trace: bool = False, device: str = "cuda",
             control=None, seeds=None, cuts=(1,), pg_backend: str = "nccl") -> dict:
    """The run of a cell on cell.chips ranks, one process each (ranks.py),
    launched from this process; rank 0's report."""
    from perfbench import ranks

    if device == "cuda":
        from multigridbarrier_tpu_torch.runtime import cuda_kernels

        cuda_kernels.build()  # once, before the ranks load it
    return ranks.launch(_rank_job, cell.chips, pg_backend, device,
                        args=(cell, seed, seconds, trace, control, seeds, tuple(cuts), device),
                        clock=(_STARTUP, _T0))


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
    ranks = int(cell.config.get("ranks", 1))
    if ranks != cell.chips:
        print(f"perfbench: {args.workload} asks for {cell.chips} chip(s), its configuration "
              f"states {ranks} rank(s), one a card", file=sys.stderr)
        return 2
    try:
        entry = entry_of(cell.config)
    except ValueError as exc:
        print(f"perfbench: {exc}", file=sys.stderr)
        return 2
    if entry == "parabolic" and ranks > 1:
        print(f"perfbench: {args.workload} is a parabolic configuration over {ranks} ranks; "
              "the time stepper runs on one card", file=sys.stderr)
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
    seeds = [int(s) for s in args.calibrate.split(",")] if args.calibrate else None
    cuts = [float(k) for k in args.cut.split(",")] if seeds else [1]
    kw = dict(trace=bool(args.trace) and not seeds, control=args.control, seeds=seeds, cuts=cuts)
    seed, seconds = (seeds[0], math.inf) if seeds else (args.seed, args.seconds)
    if cell.chips == 1:
        rep = report(cell, measure(cell, seed, seconds, device="cuda", **kw), kw["trace"], seeds)
    else:
        pg = cell.config.get("process_group", "nccl")
        try:
            rep = run_mesh(cell, seed, seconds, pg_backend=pg, **kw)
        except Exception as exc:  # a rank raised or died: every rank has ended
            print(f"perfbench: a rank of {args.workload} failed, the run has no result:\n{exc}",
                  file=sys.stderr)
            return 1
        if not seeds:
            rep["line"]["device"]["process_group"] = pg
    bad = sorted(set(forbidden_loaded()) | set(rep["forbidden"]))
    if seeds:
        for row in rep["rows"]:
            print(json.dumps(row), flush=True)
        if bad:
            print(f"perfbench: loaded {bad}", file=sys.stderr)
            return 3
        return 0
    if bad:
        print(f"perfbench: the run loaded {bad}, which the benchmark must not load",
              file=sys.stderr)
        return 3
    line = rep["line"]
    for i, (wall, its, err) in enumerate(rep["solves"]):
        print(f"solve {i} wall {wall!r} its {its} {err or ''}", file=sys.stderr)
    print("phases " + " ".join(f"{k} {v:.2f}" for k, v in rep["phases"].items()), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
