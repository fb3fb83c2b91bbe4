#!/usr/bin/env python3
"""Host seconds of the nested-dissection symbolic phase (NDSymbolic), part
by part, in the PyTorch port and in the JAX package, on the same level.

    python3 tools/time_nd_symbolic.py [--fem fem3d --L 4 --k 3] [--repeat 1]

Both classes get the same input: the fine level of the port's geometry
(built on the CPU) and its node coordinates.  The parts: the pattern (the
unique pair keys and the node graph), the tree (_build_tree), the boundary
loop with the grouping and slot tables (everything between the tree and the
maps), the maps (_build_maps), the solve maps (_build_solve_maps), the
port's sum tables (_build_sum_tables) and its relay maps
(NDSymbolic.relay_in, built on first use; the JAX package builds the same
maps inside _build_maps).  The port's parts are its own nd.symbolic.* spans
(runtime/telemetry); the JAX package's are timed by wrapping the functions
that do them, the pattern and the boundary loop being the time between
them.  Runs on the CPU; prints one line per package and repeat.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(module, cls, stamps):
    """Wrap module._build_tree and cls's _build_* methods so that each
    records (name, start, end) into stamps; returns an undo function."""
    saved = [(module, "_build_tree", module._build_tree)]
    saved += [(cls, name, getattr(cls, name))
              for name in ("_build_maps", "_build_solve_maps") if hasattr(cls, name)]

    def wrap(name, fn):
        def inner(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            stamps.append((name, t0, time.perf_counter()))
            return out
        return inner

    for owner, name, fn in saved:
        setattr(owner, name, wrap(name, fn))

    def undo():
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    return undo


def jax_parts(module, idx, m, nf, coords):
    stamps = []
    undo = timed(module, module.NDSymbolic, stamps)
    try:
        t0 = time.perf_counter()
        sym = module.NDSymbolic(idx, m, nf, coords)
        t1 = time.perf_counter()
    finally:
        undo()
    at = {name: (a, b) for name, a, b in stamps}
    out = {"pattern": at["_build_tree"][0] - t0,
           "tree": at["_build_tree"][1] - at["_build_tree"][0],
           "boundary": at["_build_maps"][0] - at["_build_tree"][1],
           "maps": at["_build_maps"][1] - at["_build_maps"][0],
           "solve_maps": at["_build_solve_maps"][1] - at["_build_solve_maps"][0],
           "total": t1 - t0}
    return sym, out


def port_parts(module, idx, m, nf, coords):
    from multigridbarrier_tpu_torch.runtime import telemetry

    telemetry.SPANS.clear()
    telemetry.enable()
    try:
        sym = module.NDSymbolic(idx, m, nf, coords)
    finally:
        telemetry.disable()
    spans = {name: (b - a) / 1e9 for name, a, b in telemetry.spans()}
    telemetry.SPANS.clear()
    out = {k.rpartition(".")[2]: v for k, v in spans.items() if k.startswith("nd.symbolic.")}
    out["total"] = spans["nd.symbolic"]
    t2 = time.perf_counter()
    sym.relay_in
    out["relay_in (on first use)"] = time.perf_counter() - t2
    return sym, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fem", default="fem3d", choices=("fem2d", "fem3d"))
    ap.add_argument("--L", type=int, default=4)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args()
    import torch

    import multigridbarrier_tpu_torch as mt
    from multigridbarrier_tpu_torch.solver import ndsolve as tnd

    torch.set_num_threads(1)
    kw = dict(k=args.k) if args.fem == "fem3d" else {}
    t0 = time.perf_counter()
    g = getattr(mt, args.fem)(L=args.L, backend=mt.backend_cpu(), **kw)
    basis = g.bases["dirichlet"][-1]
    idx, m = basis.idx.numpy(), basis.m
    coords = tnd.node_coords(idx, m, g.x.numpy(), basis.nq)
    print(f"{args.fem} L={args.L}{f' k={args.k}' if kw else ''}: fine level m={m}, "
          f"{idx.shape[0]} elements of {idx.shape[1]} nodes, geometry {time.perf_counter() - t0:.2f}s",
          flush=True)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from multigridbarrier_tpu.solver import ndsolve as jnd

    for rep in range(args.repeat):
        for name, module, parts in (("port", tnd, port_parts), ("jax", jnd, jax_parts)):
            sym, out = parts(module, idx, m, 2, coords)
            print(f"{name} NDSymbolic (repeat {rep + 1}): {sym.ngroups} groups; seconds "
                  + ", ".join(f"{k} {v:.3f}" for k, v in out.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
