#!/usr/bin/env python3
"""Solve walls of the PyTorch port on one CUDA GPU, for comparing two
checkouts inside one process sequence on one card.

    python3 tools/solve_walls_torch.py [--root DIR] [--L 5 6 7] [--repeat 2]

Imports multigridbarrier_tpu_torch from the checkout --root (default: the
checkout this script lies in), builds its kernels, and for each L solves
fem2d_solve's problem (fem2d(L) on the default backend, amgb p=1) --repeat
times on one geometry.  Per solve it prints one line: L, run, c_dot_Dz
(repr, so two checkouts can be compared to the last bit), its, the wall
(host clock, ending in a synchronize; the first run of an L includes the
level set-up: symbolic phases, tables) and the kernel launches.  It starts
with the card line and the torch version.  To compare a parent commit with
a change, unpack the parent with `git archive` into an ignored directory
and run parent, change, change, parent in one command.  Exits 1 without a
CUDA device.
"""

import argparse
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--L", type=int, nargs="+", default=[5, 6, 7])
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("solve_walls_torch: no CUDA device is available", file=sys.stderr)
        return 1
    import multigridbarrier_tpu_torch as mt
    from multigridbarrier_tpu_torch.runtime import cuda_kernels as ck

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} package {os.path.dirname(mt.__file__)}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    ck.load()
    for L in args.L:
        g = mt.fem2d(L=L)
        for run in range(1, args.repeat + 1):
            torch.cuda.synchronize()
            ck.reset_launch_counts()
            t0 = time.perf_counter()
            sol = mt.amgb(g, p=1.0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            print(f"solve L={L} run {run}: c_dot_Dz={float(sol.SOL_main.c_dot_Dz[-1])!r} "
                  f"its={sol.SOL_main.its.tolist()} wall_s={wall:.3f} "
                  f"launches={ {k: v for k, v in ck.LAUNCHES.items() if v} }", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
