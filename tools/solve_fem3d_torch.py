#!/usr/bin/env python3
"""The PyTorch port's 3D problem on one CUDA GPU: solve walls, the fine
level's Newton step under the profiler, and device time per kernel call.

    python3 tools/solve_fem3d_torch.py [--L 3] [--k 3] [--repeat 1] [--no-solve]
                                       [--steps 4] [--device-us] [--parabolic]

Builds fem3d(L, k) on the default backend (the GPU, float64) and

  1. unless --no-solve, solves fem3d_solve's problem (amgb, p=1) --repeat
     times on one geometry; per solve one line with c_dot_Dz (repr), its, the
     wall (host clock, ending in a synchronize; the first run includes the
     level set-up), the nested-dissection symbolic seconds of the levels it
     built (runtime/telemetry's nd.symbolic spans, on for these solves), peak
     device memory, the largest ||grad u|| - s, and the kernel launches;
  2. with --steps N > 0, runs N Newton steps of the finest level from the
     default start at t = 0.1 on the host clock, then N more under
     torch.profiler, and prints the wall per step, the device busy time per
     step, the idle share of the profiled wall, the CUDA kernels per step,
     the port's own launches per step, and the device time by kernel name
     (top 15 and every kernel of the port);
  3. with --device-us, the device microseconds per call under torch.profiler
     (no host launch cost in them, unlike CUDA-event times) of kernel A's
     wide form at (64,64,5,128), (512,64,5,128), (64,64,6,192), (8,64,7,256)
     and (8,27,5,54), of the fused hvp and of kernel B then C at every level
     of this geometry, and of kernel D's take_along_rows and torch.gather at
     the probe shape (16130,128) by (49152,128), the index broadcast along
     rows (the probe's case) and random;
  4. with --parabolic, runs parabolic_solve(h=0.5, t1=1.0, p=1.0) on a new
     geometry of the same L and k (three fields, so k = 6 rows of Dz and
     C = 3 nl: (64, 6, 192) on interior Q3 hexahedra) and prints the wall,
     its and c_dot_Dz per time step, the fine element shape and the launches.

It starts with the card line and the torch version.  Exits 1 without a
CUDA device.
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PORT_MARKS = ("he_assemble", "element_matvec_kernel", "hvp_kernel", "table_sum", "segment_sum",
              "row_gather", "take_along_rows")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _kernels(prof):
    """[(name, calls, device microseconds)] of the CUDA kernels of a profile."""
    return [(e.key, e.count, _device_us(e)) for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA") and _device_us(e) > 0]


def _profile(fn, reps):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall


def per_call_us(label, fn, marks, reps=20):
    """Device microseconds per call of the kernels whose name holds one of
    `marks`, from `reps` profiled calls of fn."""
    prof, _ = _profile(fn, reps)
    parts = {}
    for name, calls, us in _kernels(prof):
        for mark in marks:
            if mark in name:
                parts[mark] = parts.get(mark, 0.0) + us / reps
    print(f"device us per call, {label}: "
          + ", ".join(f"{mark} {us:.1f}" for mark, us in sorted(parts.items())), flush=True)


def solve_runs(mt, ck, g, repeat):
    from multigridbarrier_tpu_torch.runtime import telemetry

    telemetry.enable()
    for run in range(1, repeat + 1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        sol = mt.amgb(g, p=1.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        z = sol.z
        du = torch.stack([g.operators[d].matvec(z[:, 0]) for d in ("dx", "dy", "dz")], dim=1)
        worst = float((torch.linalg.norm(du, dim=1) - z[:, 1]).max())
        nd = [round((b - a) / 1e9, 3) for _, a, b in telemetry.spans("nd.symbolic")]
        telemetry.SPANS.clear()
        d = g.discretization
        print(f"solve fem3d L={d.L} k={d.payload['k']} run {run}: "
              f"c_dot_Dz={float(sol.SOL_main.c_dot_Dz[-1])!r} its={sol.SOL_main.its.tolist()} "
              f"t_stages={len(sol.SOL_main.ts)} wall_s={wall:.3f} nd_symbolic_s={nd} "
              f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f} "
              f"max(|grad u| - s)={worst:.3e} "
              f"launches={ {k: v for k, v in ck.LAUNCHES.items() if v} }", flush=True)
    telemetry.disable()


def profile_steps(ck, amgb_mod, g, steps):
    spec = amgb_mod._normalize_D(amgb_mod.default_D(3))
    Q = amgb_mod.default_Q(3, 1.0)
    dt = g.x.dtype
    c = torch.vmap(amgb_mod.default_f(3, dt))(g.x)
    z = torch.vmap(amgb_mod.default_g(3, dt))(g.x)
    ctx = amgb_mod._get_ctx(g, spec, Q.barrier, c)
    lvl = ctx.levels - 1
    route = "nested dissection" if lvl in ctx._nd_route else "dense"
    state = {"z": z}

    def step():
        state["z"] = ctx.step(lvl, state["z"], 0.1)[0]

    step()
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    per_step = {k: v / steps for k, v in ck.LAUNCHES.items() if v}
    prof, pwall = _profile(step, steps)
    kernels = _kernels(prof)
    busy = sum(us for _, _, us in kernels)
    n_kernels = sum(calls for _, calls, _ in kernels)
    print(f"fine-level Newton step (level {lvl}, {route}, P {tuple(ctx._P[lvl].shape)}): "
          f"wall {wall * 1e3:.2f} ms per step unprofiled, {pwall / steps * 1e3:.2f} ms profiled; "
          f"device busy {busy / steps / 1e3:.3f} ms per step, idle share of the profiled wall "
          f"{1 - busy / 1e6 / pwall:.3f}; {n_kernels / steps:.0f} CUDA kernels per step; "
          f"port launches per step {per_step}", flush=True)
    kernels.sort(key=lambda r: -r[2])
    shown = kernels[:15] + [r for r in kernels[15:] if any(m in r[0] for m in PORT_MARKS)]
    for name, calls, us in shown:
        print(f"  {us / busy * 100:5.1f}%  {us / steps:10.1f} us/step  {calls / steps:7.1f} calls/step  "
              f"{us / calls:9.1f} us/call  {name[:90]}")


def device_us(mt, ck, g):
    dev = g.x.device
    rng = np.random.default_rng(0)
    rnd = lambda *shape: torch.tensor(rng.standard_normal(shape), device=dev)  # noqa: E731
    for shape in ((64, 64, 5, 128), (512, 64, 5, 128), (64, 64, 6, 192), (8, 64, 7, 256),
                  (8, 27, 5, 54)):
        ne, q, k, _ = shape
        plan = ck.HePlan(rnd(*shape), rnd(ne * q).abs())
        F2 = rnd(ne * q, k, k)
        per_call_us(f"he_assemble_wide weighted {shape}", lambda: plan.weighted(F2),
                    ("he_assemble_wide",))
    for lvl, basis in enumerate(g.bases["dirichlet"]):
        C = 2 * basis.nl
        He, vp = rnd(basis.nelem, C, C), rnd(2, basis.m + 1)
        tbl = basis.scatter_idx
        per_call_us(f"fused hvp, level {lvl} ({basis.nelem},{C},{C}) m={basis.m} "
                    f"table width {tbl.shape[1]}", lambda: basis.table_plan.hvp(He, vp),
                    ("hvp_kernel",))
        per_call_us(f"B then C, level {lvl}",
                    lambda: ck.table_sum(ck.element_matvec(He, basis.idx, vp), tbl, basis.m),
                    ("element_matvec_kernel", "table_sum"))
    v = rnd(16130, 128)
    pick = rng.integers(0, 16130, 49152)
    for label, idx in (("index broadcast along rows (the probe)", np.broadcast_to(pick[:, None], (49152, 128))),
                       ("random index", rng.integers(0, 16130, (49152, 128)))):
        idx = torch.tensor(np.ascontiguousarray(idx).astype(np.int32), device=dev)
        idx_l = idx.long()
        per_call_us(f"take_along_rows (16130,128) by (49152,128), {label}",
                    lambda: ck.take_along_rows(v, idx), ("take_along_rows",))
        per_call_us("torch.gather, the same", lambda: torch.gather(v, 0, idx_l), ("gather",))


def parabolic_run(mt, ck, L, k):
    g = mt.fem3d(L=L, k=k)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    sol = mt.parabolic_solve(g, h=0.5, t1=1.0, p=1.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(u).all()) for u in sol.u)
    shapes = sorted({tuple(ctx._P[-1].shape[1:]) for ctx in g.ctx_cache.values()})
    print(f"parabolic_solve fem3d L={L} k={k} h=0.5 t1=1.0 p=1.0: ts={sol.ts} finite={finite} "
          f"its={[s.SOL_main.its.tolist() for s in sol.sols]} "
          f"c_dot_Dz={[float(s.SOL_main.c_dot_Dz[-1]) for s in sol.sols]!r} "
          f"fine (nq, k, C)={shapes} wall_s={wall:.3f} "
          f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f} "
          f"launches={ {k_: v for k_, v in ck.LAUNCHES.items() if v} }", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--L", type=int, default=3)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--no-solve", action="store_true")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--device-us", action="store_true")
    ap.add_argument("--parabolic", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("solve_fem3d_torch: no CUDA device is available", file=sys.stderr)
        return 1
    import importlib

    import multigridbarrier_tpu_torch as mt
    from multigridbarrier_tpu_torch.runtime import cuda_kernels as ck

    amgb_mod = importlib.import_module("multigridbarrier_tpu_torch.solver.amgb")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    ck.load()
    t0 = time.perf_counter()
    g = mt.fem3d(L=args.L, k=args.k)
    bases = g.bases["dirichlet"]
    print(f"fem3d L={args.L} k={args.k}: {g.discretization.nelem} hexahedra, n={g.n}, "
          f"m={[b.m for b in bases]}, nl={[b.nl for b in bases]}, table widths "
          f"{[b.scatter_idx.shape[1] for b in bases]}, geometry in {time.perf_counter() - t0:.2f}s",
          flush=True)
    if not args.no_solve:
        solve_runs(mt, ck, g, args.repeat)
    if args.steps > 0:
        profile_steps(ck, amgb_mod, g, args.steps)
    if args.device_us:
        device_us(mt, ck, g)
    if args.parabolic:
        del g
        parabolic_run(mt, ck, args.L, args.k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
