#!/usr/bin/env python3
"""Measure the two constants of the ND front-grouping cost rule on one CUDA
GPU (ndsolve.C_GROUP and ndsolve.R_F64), and what the rule then builds.

    python3 tools/nd_group_cost_torch.py [--reps 10] [--cases fem2d7,fem3d4]
                                         [--c-group MS,MS...]

For each case (fem2d L=7 and fem3d L=4 k=3, the fine level, which takes
the nested-dissection route on the default backend) it takes the fine
level's Newton values at the default problem's start point, t = 1, and a
fixed right-hand side, and then, for the size classes (MGB_ND_BUCKET=1)
and one group per depth (MGB_ND_BUCKET=0):

  1. builds the level as the solver does (_NDLevel), and prints its groups,
     the depths cut into two or more, its padded and unpadded factor flops
     (ndsolve.front_flops), the nd.symbolic seconds and the rule's own
     (nd.symbolic.groups);
  2. times one whole Newton direction (factor, solve, the CG polish) on
     the host clock ending in a synchronize, median of --reps after a
     warm-up, twice: computed eagerly (_NDLevel._fresh: the host issues
     every launch), with the peak device memory of the direction, and
     replayed from the level's CUDA graph (_NDLevel.direction, as the
     solver takes it; the first call captures), with the memory the
     capture reserved for the graph's pool;
  3. times each group of fronts of at least 1,000 dofs: its factor, Lsb
     solve and Schur product on its own assembled fronts (CUDA events,
     median of --reps), with its flops and rate.

R_F64 is the pooled rate of step 3 over the fem3d groups (flops over
milliseconds).  C_GROUP is the fem2d direction's wall under size classes
less that under one group per depth, less the difference of their factor
flops at R_F64, over the difference of their group counts (the padding is
nearly free there, so the launches make the difference), read once from
the eager walls and once from the replayed ones; the same readings at
fem3d are printed beside them.  Then, with the replayed C_GROUP, it prints
the rule's partition of each case (groups, depths split, padded flops)
over a grid of constants around it, and builds the level under the rule
(MGB_ND_BUCKET=auto: a level off a mesh groups by cost_replay) at each
C_GROUP of --c-group (ms; default: ndsolve.C_GROUP, the eager price, and
the replayed reading) with the measured R_F64, and times its direction as
in step 2.

Prints the card line (nvidia-smi name and power limit) first and last.
Exits 1 without a CUDA device.
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
from multigridbarrier_tpu_torch.runtime import cuda_kernels as ck, telemetry  # noqa: E402
from multigridbarrier_tpu_torch.solver import ndsolve as ND  # noqa: E402

AMGB = importlib.import_module("multigridbarrier_tpu_torch.solver.amgb")

CASES = {"fem2d7": ("fem2d L=7", lambda: mt.fem2d(L=7)),
         "fem3d4": ("fem3d L=4 k=3", lambda: mt.fem3d(L=4, k=3))}
BUCKET = {"classes": "1", "depth": "0", "cost": "auto"}
WIDE = 1000  # least front width (dofs) of the groups whose factor rate is read
C_GROUP_SOURCE = ND.C_GROUP  # the constant the rule is built with, eager


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def wall_ms(fn, reps):
    """Median host wall of fn() ending in a synchronize, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def event_ms(fn, reps):
    """Median CUDA-event time of fn(), after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def newton_system(g):
    """The solver context of the default problem on g, its fine level, and
    the level's Newton values at the start point, t = 1."""
    from torch.func import vmap

    spec = AMGB._normalize_D(AMGB.default_D(g.dim))
    c = vmap(AMGB.default_f(g.dim, g.x.dtype))(g.x)
    z0 = vmap(AMGB.default_g(g.dim, g.x.dtype))(g.x)
    ctx = AMGB._SolverCtx(g, spec, AMGB.default_Q(g.dim, 1.0).barrier, c)
    level = ctx.levels - 1
    y = AMGB._apply_D(ctx.ops, spec, z0)
    He = ctx._he_plan(level).weighted(vmap(ctx._F2)(ctx.x, y))
    return ctx, level, spec.nfields, ctx._vals(level, He)


def flops(sym, by_depth=None):
    """Padded factor flops of a grouping of sym's fronts (its own where
    by_depth is None), and the unpadded."""
    nf, fr = sym.nf, sym.fronts
    groups = sym.by_depth if by_depth is None else by_depth
    padded = sum(len(ids) * ND.front_flops(max(len(fr[i].sep) for i in ids) * nf,
                                           max(len(fr[i].bd) for i in ids) * nf)
                 for ids in groups)
    return padded, sum(ND.front_flops(len(f.sep) * nf, len(f.bd) * nf) for f in fr)


def depths_split(sym, groups):
    depth = [int(sym.depth_of[ids[0]]) for ids in groups]
    return sum(depth.count(d) > 1 for d in set(depth))


def measure(label, ctx, level, nf, vals, grouping, reps):
    """Steps 1-3 under one grouping; returns (groups, padded flops,
    eager direction ms, replayed direction ms, [(flops, ms)] of the wide
    groups, the level)."""
    os.environ["MGB_ND_BUCKET"] = BUCKET[grouping]
    try:
        telemetry.SPANS.clear()
        nd = AMGB._NDLevel(ctx._gbases[level], nf, ctx.geometry.x)
    finally:
        os.environ.pop("MGB_ND_BUCKET")
    sym, fz = nd.fz.sym, nd.fz
    sym_s = sum(b - a for _, a, b in telemetry.spans("nd.symbolic")) / 1e9
    rule_ms = sum(b - a for _, a, b in telemetry.spans("nd.symbolic.groups")) / 1e6
    padded, real = flops(sym)
    gv = torch.randn((nf, nd.m + 1), dtype=vals.dtype, device=vals.device,
                     generator=torch.Generator(vals.device).manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = wall_ms(lambda: nd._fresh(vals, gv), reps)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    replay_ms = wall_ms(lambda: nd.direction(vals, gv), reps) if nd.use_graph else float("nan")
    pool = (torch.cuda.memory_reserved() - reserved) / 1e9
    print(f"{label} {grouping} ({sym.grouping}): {sym.ngroups} groups over {sym.maxd + 1} depths, "
          f"{sym.depths_split} depths split; factor GFLOP padded {padded / 1e9:.3f}, "
          f"unpadded {real / 1e9:.3f}; nd.symbolic {sym_s:.2f} s, of it the grouping "
          f"{rule_ms:.2f} ms; direction eager {ms:.3f} ms, replayed {replay_ms:.3f} ms "
          f"(medians of {reps}); the eager direction's peak memory {peak:.3f} GB, the "
          f"graph's reserved {pool:.3f} GB; fronts per group "
          f"{[len(ids) for ids in sym.by_depth]}", flush=True)
    wide = []
    for d, (n_d, F, s) in enumerate(fz._shape):
        if F < WIDE:
            continue
        A = fz._factor(vals, d)

        def trio():
            Ls = ND._cholesky_nan(A[:, :s, :s])
            Lsb = torch.linalg.solve_triangular(Ls, A[:, :s, s:], upper=False)
            return A[:, s:, s:] - Lsb.mT @ Lsb

        t = event_ms(trio, reps)
        fl = n_d * ND.front_flops(s, F - s)
        wide.append((fl, t))
        print(f"  group {d}: {n_d} fronts of F={F}, s={s}: factor + Lsb + Schur {t:.3f} ms, "
              f"{fl / 1e9:.3f} GFLOP, {fl / t / 1e9:.2f} TFLOP/s", flush=True)
        del A
    return sym.ngroups, padded, ms, replay_ms, wide, nd


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cases", default="fem2d7,fem3d4")
    ap.add_argument("--c-group", default=None,
                    help="C_GROUP values (ms, comma-separated) to build the rule at")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("nd_group_cost_torch: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"card: {card_line()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    ck.load()
    telemetry.enable()
    res, syms, systems = {}, {}, {}
    for key in args.cases.split(","):
        label, build = CASES[key]
        g = build()
        ctx, level, nf, vals = newton_system(g)
        systems[key] = (label, ctx, level, nf, vals)
        for grouping in ("classes", "depth"):
            *res[key, grouping], nd = measure(label, ctx, level, nf, vals, grouping, args.reps)
            syms[key] = nd.fz.sym
            del nd
            torch.cuda.empty_cache()
    wide = [w for (key, _), r in res.items() if key == "fem3d4" for w in r[4]]
    if not wide:
        wide = [w for r in res.values() for w in r[4]]
    rate = sum(f for f, _ in wide) / sum(t for _, t in wide) * 1e3 if wide else ND.R_F64
    print(f"R_F64: {rate / 1e12:.3f} TFLOP/s pooled over {len(wide)} groups of at least "
          f"{WIDE} dofs", flush=True)
    c_group = {}
    for key in syms:
        (g1, f1, e1, r1, _), (g0, f0, e0, r0, _) = res[key, "classes"], res[key, "depth"]
        if g1 == g0:
            continue
        for side, t1, t0 in (("eager", e1, e0), ("replayed", r1, r0)):
            c_group[key, side] = ((t1 - t0) / 1e3 - (f1 - f0) / rate) / (g1 - g0)
            print(f"C_GROUP {side} from {systems[key][0]}: {c_group[key, side] * 1e3:.4f} ms per "
                  f"group (direction {t1:.3f} ms at {g1} groups, {t0:.3f} ms at {g0}; padded "
                  f"flops {f1 / 1e9:.3f} and {f0 / 1e9:.3f} GFLOP)", flush=True)
    c = c_group.get(("fem2d7", "replayed"), ND.C_GROUP)
    for key, sym in syms.items():
        sep = [len(f.sep) for f in sym.fronts]
        bd = [len(f.bd) for f in sym.fronts]
        grid = []
        for cg in (0.25 * c, 0.5 * c, c, 2 * c, 4 * c):
            for r in (0.5 * rate, rate, 2 * rate):
                ND.C_GROUP, ND.R_F64 = cg, r
                groups = ND.front_groups(sep, bd, sym.depth_of, sym.nf, "cost")
                grid.append(f"C {cg * 1e3:.3f} ms R {r / 1e12:.2f} TF/s: {len(groups)} groups, "
                            f"{depths_split(sym, groups)} split, "
                            f"{flops(sym, groups)[0] / 1e9:.2f} GFLOP")
        print(f"{systems[key][0]} the rule over constants around the replayed C_GROUP: "
              + "; ".join(grid), flush=True)
    ats = ([float(v) / 1e3 for v in args.c_group.split(",")] if args.c_group
           else [C_GROUP_SOURCE, c])
    for cg in ats:
        ND.C_GROUP = ND.C_GROUP_REPLAY = cg
        ND.R_F64 = rate
        print(f"the rule at C_GROUP {cg * 1e3:.4f} ms, R_F64 {rate / 1e12:.3f} TFLOP/s:", flush=True)
        for key in syms:
            label, ctx, level, nf, vals = systems[key]
            measure(label, ctx, level, nf, vals, "cost", args.reps)
            torch.cuda.empty_cache()
    print(f"card: {card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
